"""The official CosyVoice2 flow-matching mel decoder (matcha flow).

The port of the JAX package's ``models/flow_matcha.py``, the model of the
pretrained ``flow.pt`` (``CausalMaskedDiffWithXvec``):

- token embedding + speaker x-vector affine;
- ``UpsampleConformerEncoder``: linear embed → pre-lookahead conv → conformer
  blocks with ESPnet relative-position attention → ×2 nearest upsample
  through a causal conv → more conformer blocks → LayerNorm; a projection to
  the mel width gives the CFM's mu;
- ``CausalConditionalCFM``: Euler steps over a cosine t-schedule with
  classifier-free guidance (conditional and unconditional rows in one
  estimator call); the estimator is a one-level causal 1-D U-Net of resnet
  blocks and transformer blocks.

Activations are [B, T, C]; conv kernels are torch's [out, in, width] with
explicit (left, right) padding; dense kernels [in, out]. The JAX package's
dtype rules carry over where they change the result: an array met by a numpy
scalar (the ``×√d`` of the embeds, the ``/√d_k`` of the scores) is promoted
to f32, a dense layer of bf16 weights on f32 activations runs in f32, and a
conv casts its input to its kernel's dtype, so a bf16 flow keeps its encoder
and its ODE state in f32 as the JAX one does.

:func:`from_flow_state_dict` reads the official torch naming straight into
the port's layouts; :func:`to_flow_state_dict` writes it back.
"""

from __future__ import annotations

import dataclasses
import math
from typing import Any, Callable, Dict, Tuple

import numpy as np
import torch
import torch.nn.functional as F

from ..core.device import resolve_device
from .common import (Init, Params, gelu, layer_norm, linear_from_state, permute_conv_kernels,
                     promoted, state_tensor, tree_from_numpy)


# ============================================================= configuration


@dataclasses.dataclass(frozen=True)
class UpsampleConformerConfig:
    """cosyvoice2.yaml flow.encoder (UpsampleConformerEncoder)."""

    size: int = 512
    heads: int = 8
    linear_units: int = 2048
    blocks: int = 6                 # before the upsample
    up_blocks: int = 4              # after it
    pre_lookahead_len: int = 3
    upsample_stride: int = 2        # token_mel_ratio

    @property
    def head_dim(self) -> int:
        return self.size // self.heads


@dataclasses.dataclass(frozen=True)
class CausalDecoderConfig:
    """cosyvoice2.yaml flow.decoder.estimator (CausalConditionalDecoder)."""

    in_channels: int = 320          # x ⊕ mu ⊕ spk ⊕ cond (4 × 80)
    out_channels: int = 80
    channels: int = 256
    heads: int = 8
    head_dim: int = 64
    n_blocks: int = 4               # transformer blocks a resnet
    num_mid_blocks: int = 12

    @property
    def time_embed_dim(self) -> int:
        return self.channels * 4


@dataclasses.dataclass(frozen=True)
class OfficialFlowConfig:
    """cosyvoice2.yaml flow (CausalMaskedDiffWithXvec)."""

    vocab_size: int = 6561
    input_size: int = 512
    output_size: int = 80           # n_mels
    spk_embed_dim: int = 192
    token_mel_ratio: int = 2
    encoder: UpsampleConformerConfig = UpsampleConformerConfig()
    estimator: CausalDecoderConfig = CausalDecoderConfig()
    n_timesteps: int = 10
    inference_cfg_rate: float = 0.7
    sigma_min: float = 1e-6

    @classmethod
    def tiny(cls) -> "OfficialFlowConfig":
        """Structure-test dims (every ratio kept)."""
        return cls(
            vocab_size=64, input_size=32, output_size=8, spk_embed_dim=16,
            encoder=UpsampleConformerConfig(size=32, heads=4, linear_units=64,
                                            blocks=2, up_blocks=1),
            estimator=CausalDecoderConfig(in_channels=32, out_channels=8, channels=16, heads=2,
                                          head_dim=8, n_blocks=1, num_mid_blocks=2),
            n_timesteps=2,
        )


# ================================================================= primitives


def _f32_at_least(x: torch.Tensor) -> torch.Tensor:
    """x promoted as JAX promotes an array met by a numpy scalar (f32)."""
    return x.to(torch.promote_types(x.dtype, torch.float32))


def _dense(p: Params, x: torch.Tensor) -> torch.Tensor:
    x, k = promoted(x, p["kernel"])
    y = x @ k
    if "bias" in p:
        y = y + p["bias"]
    return y


def _einsum(eq: str, a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    return torch.einsum(eq, *promoted(a, b))


def _conv1d(p: Params, x: torch.Tensor, *, pad: Tuple[int, int]) -> torch.Tensor:
    """Conv over [B, T, C] with explicit (left, right) zero padding; x is cast
    to the kernel's dtype first."""
    k = p["kernel"]
    h = F.pad(x.to(k.dtype).transpose(1, 2), pad)
    return F.conv1d(h, k, p["bias"]).transpose(1, 2)


def _mish(x: torch.Tensor) -> torch.Tensor:
    return x * torch.tanh(F.softplus(x))


def _masked_softmax(scores: torch.Tensor, mask: torch.Tensor) -> torch.Tensor:
    """Softmax in f32 over keys; scores [B, h, Tq, Tk], mask [B, Tk] (True =
    valid); masked weights are zeroed."""
    m = mask[:, None, None, :]
    s = torch.where(m, scores.float(), torch.finfo(torch.float32).min)
    return (torch.softmax(s, dim=-1) * m).to(scores.dtype)


# ================================================== ESPnet rel-pos attention


def _rel_pos_encoding(t: int, dim: int, dtype, device) -> torch.Tensor:
    """EspnetRelPositionalEncoding table for length ``t`` → [2t−1, dim]: row 0
    is the relative distance t−1, the centre row 0, the last row −(t−1).
    Built in float64 and cast, as the JAX package builds it."""
    pos = np.arange(t, dtype=np.float64)
    div = np.exp(np.arange(0, dim, 2, dtype=np.float64) * -(np.log(10000.0) / dim))
    pe_pos = np.zeros((t, dim))
    pe_neg = np.zeros((t, dim))
    pe_pos[:, 0::2] = np.sin(pos[:, None] * div)
    pe_pos[:, 1::2] = np.cos(pos[:, None] * div)
    pe_neg[:, 0::2] = np.sin(-pos[:, None] * div)
    pe_neg[:, 1::2] = np.cos(-pos[:, None] * div)
    pe = np.concatenate([pe_pos[::-1], pe_neg[1:]], axis=0)
    return torch.from_numpy(np.ascontiguousarray(pe)).to(device=device, dtype=dtype)


def _rel_shift(x: torch.Tensor) -> torch.Tensor:
    """wenet RelPositionMultiHeadedAttention.rel_shift: [B,h,T,2T−1] → [B,h,T,T]."""
    b, h, t, _ = x.shape
    padded = torch.cat([x.new_zeros((b, h, t, 1)), x], dim=-1).reshape(b, h, 2 * t, t)
    return padded[:, :, 1:].reshape(b, h, t, 2 * t - 1)[:, :, :, :t]


def rel_attention(p: Params, cfg: UpsampleConformerConfig, x: torch.Tensor,
                  pos_emb: torch.Tensor, mask: torch.Tensor) -> torch.Tensor:
    """Relative-position MHA (wenet RelPositionMultiHeadedAttention).
    x [B, T, d]; pos_emb [2T−1, d]; mask [B, T] (True = valid)."""
    b, t, d = x.shape
    h, dk = cfg.heads, cfg.head_dim
    q = _dense(p["q"], x).reshape(b, t, h, dk)
    k = _dense(p["k"], x).reshape(b, t, h, dk)
    v = _dense(p["v"], x).reshape(b, t, h, dk)
    pe = _dense(p["pos"], pos_emb.to(x.dtype)).reshape(-1, h, dk)
    q_u = q + p["bias_u"].to(x.dtype)[None, None]
    q_v = q + p["bias_v"].to(x.dtype)[None, None]
    ac = _einsum("bqhd,bkhd->bhqk", q_u, k)
    bd = _einsum("bqhd,phd->bhqp", q_v, pe)
    scores = _f32_at_least(ac + _rel_shift(bd)) / math.sqrt(dk)
    w = _masked_softmax(scores, mask)
    return _dense(p["out"], _einsum("bhqk,bkhd->bqhd", w, v).reshape(b, t, -1))


# =========================================================== conformer blocks


def conformer_block(p: Params, cfg: UpsampleConformerConfig, x: torch.Tensor,
                    pos_emb: torch.Tensor, mask: torch.Tensor) -> torch.Tensor:
    """wenet ConformerEncoderLayer without the macaron and conv modules
    (cosyvoice2.yaml), normalize_before=True."""
    x = x + rel_attention(p["attn"], cfg, layer_norm(p["norm_mha"], x), pos_emb, mask)
    h = layer_norm(p["norm_ff"], x)
    return x + _dense(p["ff"]["w2"], F.silu(_dense(p["ff"]["w1"], h)))


def upsample_conformer_encode(p: Params, cfg: UpsampleConformerConfig, x: torch.Tensor,
                              mask: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """x [B, T, size], mask [B, T] → ([B, stride·T, size], [B, stride·T]);
    the offline forward (full attention over the valid frames)."""
    _, t, s = x.shape
    dev = x.device
    h = layer_norm(p["embed"]["ln"], _dense(p["embed"]["linear"], x))
    h = _f32_at_least(h) * math.sqrt(s)
    pos_emb = _rel_pos_encoding(t, s, h.dtype, dev)
    # masked before the lookahead conv: its right padding must read zeros
    # past each row's end, not the embed of a padded position
    h = h * mask[..., None]
    conv1 = p["pre_lookahead"]["conv1"]
    lk = _conv1d(conv1, h, pad=(0, conv1["kernel"].shape[-1] - 1))
    lk = _conv1d(p["pre_lookahead"]["conv2"], F.leaky_relu(lk, 0.01), pad=(2, 0))
    h = (h + lk) * mask[..., None]
    for blk in p["layers"]:
        h = conformer_block(blk, cfg, h, pos_emb, mask)

    r = cfg.upsample_stride
    h = _conv1d(p["up_layer"], torch.repeat_interleave(h, r, dim=1), pad=(2 * r, 0))
    mask_up = torch.repeat_interleave(mask, r, dim=1)
    h = layer_norm(p["up_embed"]["ln"], _dense(p["up_embed"]["linear"], h))
    h = (_f32_at_least(h) * math.sqrt(s)) * mask_up[..., None]
    pos_emb_up = _rel_pos_encoding(r * t, s, h.dtype, dev)
    for blk in p["up_layers"]:
        h = conformer_block(blk, cfg, h, pos_emb_up, mask_up)
    return layer_norm(p["after_norm"], h), mask_up


# ========================================== causal conditional decoder (U-Net)


def _causal_block(p: Params, x: torch.Tensor, mask: torch.Tensor) -> torch.Tensor:
    """matcha CausalBlock1D: causal conv k3 → LayerNorm → Mish."""
    m = mask[..., None]
    h = layer_norm(p["ln"], _conv1d(p["conv"], x * m, pad=(2, 0)))
    return _mish(h) * m


def _resnet(p: Params, x: torch.Tensor, mask: torch.Tensor, temb: torch.Tensor) -> torch.Tensor:
    """matcha CausalResnetBlock1D. x [B, T, C_in], temb [B, t_dim]."""
    h = _causal_block(p["block1"], x, mask)
    h = h + _dense(p["mlp"], _mish(temb))[:, None, :]
    h = _causal_block(p["block2"], h, mask)
    return h + _conv1d(p["res_conv"], x * mask[..., None], pad=(0, 0))


def _tblock(p: Params, cfg: CausalDecoderConfig, x: torch.Tensor,
            mask: torch.Tensor) -> torch.Tensor:
    """matcha BasicTransformerBlock: self-attention over the valid frames,
    LayerNorms, and an exact-erf GELU feed-forward (diffusers' F.gelu)."""
    b, t, _ = x.shape
    h, dk = cfg.heads, cfg.head_dim
    a = layer_norm(p["norm1"], x)
    q = _dense(p["attn"]["q"], a).reshape(b, t, h, dk)
    k = _dense(p["attn"]["k"], a).reshape(b, t, h, dk)
    v = _dense(p["attn"]["v"], a).reshape(b, t, h, dk)
    scores = _f32_at_least(_einsum("bqhd,bkhd->bhqk", q, k)) / math.sqrt(dk)
    w = _masked_softmax(scores, mask)
    attn = _einsum("bhqk,bkhd->bqhd", w, v).reshape(b, t, h * dk)
    x = x + _dense(p["attn"]["out"], attn)
    f = layer_norm(p["norm3"], x)
    return x + _dense(p["ff"]["out"], gelu(_dense(p["ff"]["proj"], f)))


def _sinusoidal_time(t: torch.Tensor, dim: int) -> torch.Tensor:
    """matcha SinusoidalPosEmb (scale 1000): t [B] → [B, dim] in f32."""
    half = dim // 2
    freqs = torch.exp(torch.arange(half, dtype=torch.float32, device=t.device)
                      * -(math.log(10000.0) / (half - 1)))
    ang = 1000.0 * t.float()[:, None] * freqs[None, :]
    return torch.cat([torch.sin(ang), torch.cos(ang)], dim=-1)


def _unit(p: Params, cfg: CausalDecoderConfig, h, mask, temb):
    h = _resnet(p["resnet"], h, mask, temb)
    for tb in p["tblocks"]:
        h = _tblock(tb, cfg, h, mask)
    return h


def causal_decoder_estimator(p: Params, cfg: CausalDecoderConfig, x: torch.Tensor,
                             t: torch.Tensor, mu: torch.Tensor, spk: torch.Tensor,
                             cond: torch.Tensor, mask: torch.Tensor) -> torch.Tensor:
    """v(x_t, t | mu, spk, cond): CausalConditionalDecoder.forward, offline.
    x/mu/cond [B, T, n_mels]; spk [B, n_mels]; t [B]; mask [B, T] →
    [B, T, n_mels]."""
    temb = _sinusoidal_time(t, cfg.in_channels).to(x.dtype)
    temb = _dense(p["time_mlp"]["l2"], F.silu(_dense(p["time_mlp"]["l1"], temb)))
    spk_t = spk[:, None, :].expand(x.shape[0], x.shape[1], spk.shape[-1])
    h = torch.cat(promoted(x, mu, spk_t, cond), dim=-1)
    m = mask[..., None]

    h = _unit(p["down"], cfg, h, mask, temb)
    skip = h
    h = _conv1d(p["down"]["downsample"], h * m, pad=(2, 0))
    for unit in p["mid"]:
        h = _unit(unit, cfg, h, mask, temb)
    h = _unit(p["up"], cfg, torch.cat(promoted(h, skip), dim=-1), mask, temb)
    h = _conv1d(p["up"]["upsample"], h * m, pad=(2, 0))
    h = _causal_block(p["final_block"], h, mask)
    return _conv1d(p["final_proj"], h * m, pad=(0, 0)) * m


# ======================================================== the whole flow


def init_official_flow(r: Init, cfg: OfficialFlowConfig) -> Params:
    """Seeded random parameters in the port's layouts (the JAX init's shapes
    and scales; its numbers differ)."""
    enc, est = cfg.encoder, cfg.estimator

    def conv(width, in_ch, out_ch):
        return {"kernel": r.uniform((out_ch, in_ch, width), 1.0 / math.sqrt(in_ch * width)),
                "bias": r.zeros((out_ch,))}

    def conformer():
        d = enc.size
        return {"norm_mha": r.layer_norm(d),
                "attn": {"q": r.dense(d, d), "k": r.dense(d, d), "v": r.dense(d, d),
                         "out": r.dense(d, d), "pos": r.dense(d, d, bias=False),
                         "bias_u": r.normal((enc.heads, enc.head_dim), 0.02),
                         "bias_v": r.normal((enc.heads, enc.head_dim), 0.02)},
                "norm_ff": r.layer_norm(d),
                "ff": {"w1": r.dense(d, enc.linear_units), "w2": r.dense(enc.linear_units, d)}}

    ch, t_dim, inner = est.channels, est.time_embed_dim, est.heads * est.head_dim

    def unit(in_ch):
        return {"resnet": {"mlp": r.dense(t_dim, ch),
                           "block1": {"conv": conv(3, in_ch, ch), "ln": r.layer_norm(ch)},
                           "block2": {"conv": conv(3, ch, ch), "ln": r.layer_norm(ch)},
                           "res_conv": conv(1, in_ch, ch)},
                "tblocks": [{"norm1": r.layer_norm(ch),
                             "attn": {"q": r.dense(ch, inner, bias=False),
                                      "k": r.dense(ch, inner, bias=False),
                                      "v": r.dense(ch, inner, bias=False),
                                      "out": r.dense(inner, ch)},
                             "norm3": r.layer_norm(ch),
                             "ff": {"proj": r.dense(ch, ch * 4), "out": r.dense(ch * 4, ch)}}
                            for _ in range(est.n_blocks)]}

    s = enc.size
    return {
        "input_embedding": r.normal((cfg.vocab_size, cfg.input_size), 0.02),
        "spk_affine": r.dense(cfg.spk_embed_dim, cfg.output_size),
        "encoder": {
            "embed": {"linear": r.dense(s, s), "ln": r.layer_norm(s)},
            "pre_lookahead": {"conv1": conv(enc.pre_lookahead_len + 1, s, s),
                              "conv2": conv(3, s, s)},
            "layers": [conformer() for _ in range(enc.blocks)],
            "up_layer": conv(enc.upsample_stride * 2 + 1, s, s),
            "up_embed": {"linear": r.dense(s, s), "ln": r.layer_norm(s)},
            "up_layers": [conformer() for _ in range(enc.up_blocks)],
            "after_norm": r.layer_norm(s),
        },
        "encoder_proj": r.dense(enc.size, cfg.output_size),
        "estimator": {
            "time_mlp": {"l1": r.dense(est.in_channels, t_dim), "l2": r.dense(t_dim, t_dim)},
            "down": {**unit(est.in_channels), "downsample": conv(3, ch, ch)},
            "mid": [unit(ch) for _ in range(est.num_mid_blocks)],
            "up": {**unit(ch * 2), "upsample": conv(3, ch, ch)},
            "final_block": {"conv": conv(3, ch, ch), "ln": r.layer_norm(ch)},
            "final_proj": conv(1, ch, est.out_channels),
        },
    }


def from_jax_params(tree, device, dtype=torch.float32) -> Params:
    """The JAX package's flow tree → the port's: conv kernels [width, in, out]
    → [out, in, width]; dense kernels keep [in, out]."""
    return permute_conv_kernels(tree_from_numpy(tree, device, dtype), (2, 1, 0))


def flow_inference(params: Params, cfg: OfficialFlowConfig,
                   draw_x0: Callable[[Tuple[int, ...]], torch.Tensor],
                   speech_tokens: torch.Tensor, token_mask: torch.Tensor,
                   prompt_tokens: torch.Tensor, prompt_token_mask: torch.Tensor,
                   prompt_feat: torch.Tensor, embedding: torch.Tensor):
    """CausalMaskedDiffWithXvec.inference, offline. Tokens [B, T_tok] and
    their mask; prompt tokens [B, T_ptok] and their mask; the prompt mel
    [B, ratio·T_ptok, n_mels]; the x-vector [B, spk_dim]; ``draw_x0(shape)``
    the ODE's start x_0 ~ N(0, I). → (mel [B, ratio·T_tok, n_mels], its frame
    mask): the prompt span stripped per row, the official
    ``feat[:, :, mel_len1:]``."""
    b = speech_tokens.shape[0]
    r = cfg.token_mel_ratio
    dev = speech_tokens.device
    spk = embedding / torch.clamp(torch.linalg.vector_norm(embedding, dim=-1, keepdim=True),
                                  min=1e-12)
    spk = _dense(params["spk_affine"], spk)

    tokens = torch.cat([prompt_tokens, speech_tokens], dim=1)
    tmask = torch.cat([prompt_token_mask, token_mask], dim=1)
    # the valid positions of each row compacted to a contiguous prefix (a
    # stable sort on the mask): a prompt shorter than its padded width would
    # otherwise leave padding mid-sequence, which the convs read as frames
    order = torch.argsort((~tmask).to(torch.int32), dim=1, stable=True)
    tokens = torch.take_along_dim(tokens, order, dim=1)
    tmask = torch.take_along_dim(tmask, order, dim=1)
    n_ptok = prompt_token_mask.to(torch.int64).sum(dim=1)
    n_gtok = token_mask.to(torch.int64).sum(dim=1)
    emb = params["input_embedding"][torch.clamp(tokens.long(), 0, cfg.vocab_size - 1)]
    emb = emb * tmask[..., None]

    h, frame_mask = upsample_conformer_encode(params["encoder"], cfg.encoder, emb, tmask)
    mu = _dense(params["encoder_proj"], h)

    total = mu.shape[1]
    # the prompt mel rides the first r·n_ptok frames of each compacted row
    fidx = torch.arange(total, device=dev)[None, :]
    pf = torch.zeros((b, total, cfg.output_size), dtype=mu.dtype, device=dev)
    n_pf = min(prompt_feat.shape[1], total)
    pf[:, :n_pf] = prompt_feat[:, :n_pf].to(mu.dtype)
    cond = torch.where((fidx < (r * n_ptok)[:, None])[..., None], pf, 0.0)

    x0 = draw_x0((b, total, cfg.output_size)).to(device=dev, dtype=mu.dtype)
    mel = _solve_euler(params["estimator"], cfg, x0, mu, spk, cond, frame_mask)
    # the generated frame i of row b lives at r·n_ptok[b] + i
    t_gen = r * speech_tokens.shape[1]
    gather = torch.clamp((r * n_ptok)[:, None] + torch.arange(t_gen, device=dev)[None, :],
                         0, total - 1)
    mel_gen = torch.take_along_dim(mel, gather[..., None], dim=1)
    gen_mask = torch.arange(t_gen, device=dev)[None, :] < (r * n_gtok)[:, None]
    return mel_gen * gen_mask[..., None], gen_mask


def _solve_euler(est: Params, cfg: OfficialFlowConfig, x: torch.Tensor, mu, spk, cond,
                 mask) -> torch.Tensor:
    """CausalConditionalCFM.solve_euler from x_0: the cosine t-schedule (t and
    dt Python floats of float64 arithmetic), classifier-free guidance over a
    2B batch through one estimator call a step."""
    b = mu.shape[0]
    ts = 1.0 - np.cos(np.linspace(0.0, 1.0, cfg.n_timesteps + 1) * 0.5 * np.pi)
    mu2 = torch.cat([mu, torch.zeros_like(mu)])
    spk2 = torch.cat([spk, torch.zeros_like(spk)])
    cond2 = torch.cat([cond, torch.zeros_like(cond)])
    mask2 = torch.cat([mask, mask])
    rate = cfg.inference_cfg_rate
    for i in range(cfg.n_timesteps):
        t_i, dt = float(ts[i]), float(ts[i + 1] - ts[i])
        t2 = torch.full((2 * b,), t_i, dtype=x.dtype, device=x.device)
        v2 = causal_decoder_estimator(est, cfg.estimator, torch.cat([x, x]), t2, mu2, spk2,
                                      cond2, mask2)
        v = (1.0 + rate) * v2[:b] - rate * v2[b:]
        x = x + dt * v
    return x


# ================================================================ conversion


def _lin(state, name: str, device, *, bias: bool = True) -> Params:
    b = state.get(f"{name}.bias") if bias else None
    return linear_from_state(state[f"{name}.weight"], b, device)


def _conv(state, name: str, device) -> Params:
    return {"kernel": state_tensor(state[f"{name}.weight"], device),
            "bias": state_tensor(state[f"{name}.bias"], device)}


def _ln(state, name: str, device) -> Params:
    return {"scale": state_tensor(state[f"{name}.weight"], device),
            "bias": state_tensor(state[f"{name}.bias"], device)}


def _conformer_from(state, prefix: str, cfg: UpsampleConformerConfig, dev) -> Params:
    a = f"{prefix}.self_attn"
    h, dk = cfg.heads, cfg.head_dim
    return {
        "norm_mha": _ln(state, f"{prefix}.norm_mha", dev),
        "attn": {"q": _lin(state, f"{a}.linear_q", dev), "k": _lin(state, f"{a}.linear_k", dev),
                 "v": _lin(state, f"{a}.linear_v", dev),
                 "out": _lin(state, f"{a}.linear_out", dev),
                 "pos": _lin(state, f"{a}.linear_pos", dev, bias=False),
                 "bias_u": state_tensor(state[f"{a}.pos_bias_u"], dev).reshape(h, dk),
                 "bias_v": state_tensor(state[f"{a}.pos_bias_v"], dev).reshape(h, dk)},
        "norm_ff": _ln(state, f"{prefix}.norm_ff", dev),
        "ff": {"w1": _lin(state, f"{prefix}.feed_forward.w_1", dev),
               "w2": _lin(state, f"{prefix}.feed_forward.w_2", dev)},
    }


def _unit_from(state, prefix: str, n_blocks: int, dev) -> Params:
    return {
        "resnet": {"mlp": _lin(state, f"{prefix}.0.mlp.1", dev),
                   "block1": {"conv": _conv(state, f"{prefix}.0.block1.block.0", dev),
                              "ln": _ln(state, f"{prefix}.0.block1.block.2", dev)},
                   "block2": {"conv": _conv(state, f"{prefix}.0.block2.block.0", dev),
                              "ln": _ln(state, f"{prefix}.0.block2.block.2", dev)},
                   "res_conv": _conv(state, f"{prefix}.0.res_conv", dev)},
        "tblocks": [{"norm1": _ln(state, f"{t}.norm1", dev),
                     "attn": {"q": _lin(state, f"{t}.attn1.to_q", dev, bias=False),
                              "k": _lin(state, f"{t}.attn1.to_k", dev, bias=False),
                              "v": _lin(state, f"{t}.attn1.to_v", dev, bias=False),
                              "out": _lin(state, f"{t}.attn1.to_out.0", dev)},
                     "norm3": _ln(state, f"{t}.norm3", dev),
                     "ff": {"proj": _lin(state, f"{t}.ff.net.0.proj", dev),
                            "out": _lin(state, f"{t}.ff.net.2", dev)}}
                    for t in (f"{prefix}.1.{j}" for j in range(n_blocks))],
    }


def from_flow_state_dict(state: Dict[str, Any], cfg: OfficialFlowConfig,
                         device=None) -> Params:
    """Official CosyVoice2 ``flow.pt`` state dict (torch tensors or numpy
    arrays, official naming) → the port's tree on ``device``, its dtype kept.
    The key map is the JAX package's ``from_flow_state_dict``'s: dense
    weights [out, in] turn into kernels [in, out], conv weights keep torch's
    [out, in, width]."""
    dev = resolve_device(device)
    enc, est = cfg.encoder, cfg.estimator
    e = "decoder.estimator"
    return {
        "input_embedding": state_tensor(state["input_embedding.weight"], dev),
        "spk_affine": _lin(state, "spk_embed_affine_layer", dev),
        "encoder": {
            "embed": {"linear": _lin(state, "encoder.embed.out.0", dev),
                      "ln": _ln(state, "encoder.embed.out.1", dev)},
            "pre_lookahead": {"conv1": _conv(state, "encoder.pre_lookahead_layer.conv1", dev),
                              "conv2": _conv(state, "encoder.pre_lookahead_layer.conv2", dev)},
            "layers": [_conformer_from(state, f"encoder.encoders.{i}", enc, dev)
                       for i in range(enc.blocks)],
            "up_layer": _conv(state, "encoder.up_layer.conv", dev),
            "up_embed": {"linear": _lin(state, "encoder.up_embed.out.0", dev),
                         "ln": _ln(state, "encoder.up_embed.out.1", dev)},
            "up_layers": [_conformer_from(state, f"encoder.up_encoders.{i}", enc, dev)
                          for i in range(enc.up_blocks)],
            "after_norm": _ln(state, "encoder.after_norm", dev),
        },
        "encoder_proj": _lin(state, "encoder_proj", dev),
        "estimator": {
            "time_mlp": {"l1": _lin(state, f"{e}.time_mlp.linear_1", dev),
                         "l2": _lin(state, f"{e}.time_mlp.linear_2", dev)},
            "down": {**_unit_from(state, f"{e}.down_blocks.0", est.n_blocks, dev),
                     "downsample": _conv(state, f"{e}.down_blocks.0.2", dev)},
            "mid": [_unit_from(state, f"{e}.mid_blocks.{i}", est.n_blocks, dev)
                    for i in range(est.num_mid_blocks)],
            "up": {**_unit_from(state, f"{e}.up_blocks.0", est.n_blocks, dev),
                   "upsample": _conv(state, f"{e}.up_blocks.0.2", dev)},
            "final_block": {"conv": _conv(state, f"{e}.final_block.block.0", dev),
                            "ln": _ln(state, f"{e}.final_block.block.2", dev)},
            "final_proj": _conv(state, f"{e}.final_proj", dev),
        },
    }


def _cpu(t: torch.Tensor) -> torch.Tensor:
    return t.detach().cpu().contiguous()


def _emit_lin(out, name, p, *, bias=True):
    out[f"{name}.weight"] = _cpu(p["kernel"].T)
    if bias and "bias" in p:
        out[f"{name}.bias"] = _cpu(p["bias"])


def _emit_conv(out, name, p):
    out[f"{name}.weight"] = _cpu(p["kernel"])
    out[f"{name}.bias"] = _cpu(p["bias"])


def _emit_ln(out, name, p):
    out[f"{name}.weight"] = _cpu(p["scale"])
    out[f"{name}.bias"] = _cpu(p["bias"])


def _emit_conformer(out, prefix, p):
    a, sa = p["attn"], f"{prefix}.self_attn"
    _emit_ln(out, f"{prefix}.norm_mha", p["norm_mha"])
    for name, key in (("linear_q", "q"), ("linear_k", "k"), ("linear_v", "v"),
                      ("linear_out", "out")):
        _emit_lin(out, f"{sa}.{name}", a[key])
    _emit_lin(out, f"{sa}.linear_pos", a["pos"], bias=False)
    out[f"{sa}.pos_bias_u"] = _cpu(a["bias_u"])
    out[f"{sa}.pos_bias_v"] = _cpu(a["bias_v"])
    _emit_ln(out, f"{prefix}.norm_ff", p["norm_ff"])
    _emit_lin(out, f"{prefix}.feed_forward.w_1", p["ff"]["w1"])
    _emit_lin(out, f"{prefix}.feed_forward.w_2", p["ff"]["w2"])


def _emit_unit(out, prefix, p):
    rn = p["resnet"]
    _emit_lin(out, f"{prefix}.0.mlp.1", rn["mlp"])
    for blk in ("block1", "block2"):
        _emit_conv(out, f"{prefix}.0.{blk}.block.0", rn[blk]["conv"])
        _emit_ln(out, f"{prefix}.0.{blk}.block.2", rn[blk]["ln"])
    _emit_conv(out, f"{prefix}.0.res_conv", rn["res_conv"])
    for j, tb in enumerate(p["tblocks"]):
        t = f"{prefix}.1.{j}"
        _emit_ln(out, f"{t}.norm1", tb["norm1"])
        for name, key in (("to_q", "q"), ("to_k", "k"), ("to_v", "v")):
            _emit_lin(out, f"{t}.attn1.{name}", tb["attn"][key], bias=False)
        _emit_lin(out, f"{t}.attn1.to_out.0", tb["attn"]["out"])
        _emit_ln(out, f"{t}.norm3", tb["norm3"])
        _emit_lin(out, f"{t}.ff.net.0.proj", tb["ff"]["proj"])
        _emit_lin(out, f"{t}.ff.net.2", tb["ff"]["out"])


def to_flow_state_dict(params: Params) -> Dict[str, torch.Tensor]:
    """The inverse of :func:`from_flow_state_dict`: the official naming from
    the port's tree, as CPU tensors ready for ``torch.save``."""
    out: Dict[str, torch.Tensor] = {"input_embedding.weight": _cpu(params["input_embedding"])}
    _emit_lin(out, "spk_embed_affine_layer", params["spk_affine"])
    enc = params["encoder"]
    _emit_lin(out, "encoder.embed.out.0", enc["embed"]["linear"])
    _emit_ln(out, "encoder.embed.out.1", enc["embed"]["ln"])
    _emit_conv(out, "encoder.pre_lookahead_layer.conv1", enc["pre_lookahead"]["conv1"])
    _emit_conv(out, "encoder.pre_lookahead_layer.conv2", enc["pre_lookahead"]["conv2"])
    for i, blk in enumerate(enc["layers"]):
        _emit_conformer(out, f"encoder.encoders.{i}", blk)
    _emit_conv(out, "encoder.up_layer.conv", enc["up_layer"])
    _emit_lin(out, "encoder.up_embed.out.0", enc["up_embed"]["linear"])
    _emit_ln(out, "encoder.up_embed.out.1", enc["up_embed"]["ln"])
    for i, blk in enumerate(enc["up_layers"]):
        _emit_conformer(out, f"encoder.up_encoders.{i}", blk)
    _emit_ln(out, "encoder.after_norm", enc["after_norm"])
    _emit_lin(out, "encoder_proj", params["encoder_proj"])

    e, est = "decoder.estimator", params["estimator"]
    _emit_lin(out, f"{e}.time_mlp.linear_1", est["time_mlp"]["l1"])
    _emit_lin(out, f"{e}.time_mlp.linear_2", est["time_mlp"]["l2"])
    _emit_unit(out, f"{e}.down_blocks.0", est["down"])
    _emit_conv(out, f"{e}.down_blocks.0.2", est["down"]["downsample"])
    for i, unit in enumerate(est["mid"]):
        _emit_unit(out, f"{e}.mid_blocks.{i}", unit)
    _emit_unit(out, f"{e}.up_blocks.0", est["up"])
    _emit_conv(out, f"{e}.up_blocks.0.2", est["up"]["upsample"])
    _emit_conv(out, f"{e}.final_block.block.0", est["final_block"]["conv"])
    _emit_ln(out, f"{e}.final_block.block.2", est["final_block"]["ln"])
    _emit_conv(out, f"{e}.final_proj", est["final_proj"])
    return out
