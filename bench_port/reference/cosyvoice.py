"""The native CosyVoice chain in plain PyTorch: a frozen copy of the port's
``models/cosyvoice.py`` (the speech LM's config, init and prompt
embeddings; the DiT flow's ``tokens_to_mel``; the HiFi-GAN ``vocode``, its
resblock stages through ``plain_vocoder``). Draws come from a
:class:`NoiseSource`; layouts: dense kernels [in, out], conv kernels
[out, in, width], conv-transpose kernels [in, out, width]."""

from __future__ import annotations

import dataclasses
from typing import Optional, Protocol, Tuple

import numpy as np
import torch
import torch.nn.functional as F

from . import plain_vocoder as cuda_vocoder
from . import qwen2 as q2
from .common import (AttnConfig, Init, Params, dense, embed_rows, layer_norm, merge_heads, mlp, split_heads)


# ===================================================================== noise


class NoiseSource(Protocol):
    def ras_gumbel(self, step: int, shape: Tuple[int, ...]) -> Tuple[torch.Tensor, torch.Tensor]:
        """Gumbel noise for RAS step ``step``: (nucleus draw, resample draw).
        Equal steps must give equal noise: the speculative decoder draws each
        position twice, for its draft and for its verifier."""

    def mtp_gumbel(self, pass_index: int, head: int,
                   shape: Tuple[int, ...]) -> Tuple[torch.Tensor, torch.Tensor]:
        """Gumbel noise of head ``head`` (0 the main head, j the j-th MTP head)
        in multi-token pass ``pass_index``: (nucleus draw, resample draw)."""

    def flow_x0(self, shape: Tuple[int, ...]) -> torch.Tensor:
        """The flow's starting point x_0 ~ N(0, I)."""

    def chunk(self, index: int, count: int) -> "NoiseSource":
        """The source of chunk ``index`` of a stream of ``count`` chunks: its
        ``ras_gumbel`` takes the step's index inside the chunk, its
        ``flow_x0`` gives that chunk's flow noise."""

    def hift_source(self, phase_shape: Tuple[int, ...],
                    noise_shape: Tuple[int, ...]) -> Tuple[torch.Tensor, torch.Tensor]:
        """The HiFT source's draws (``hift.harmonic_source``): harmonic phases
        uniform in [−π, π) and the additive noise ~ N(0, 1)."""

    def flow_x0_prefix(self, bucket: int, shape: Tuple[int, ...]) -> torch.Tensor:
        """The official stream's flow x_0 for a token prefix padded to
        ``bucket``: chunks whose prefixes share a bucket share it."""


# the kinds of draw, mixed into each draw's seed
_RAS, _MTP, _FLOW, _CHUNK, _HIFT, _FLOW_PREFIX = range(6)


# ======================================================================== LM


@dataclasses.dataclass(frozen=True)
class SpeechLMConfig:
    backbone: q2.Qwen2Config = dataclasses.field(default_factory=q2.Qwen2Config.qwen2_05b)
    text_vocab: int = 151_936
    speech_token_size: int = 6561
    top_p: float = 0.8
    top_k: int = 25
    win_size: int = 10
    tau_r: float = 0.1
    max_tokens: int = 2048
    # multi-token prediction: K tokens a backbone pass, the main head and
    # K - 1 extra heads read off the newest hidden state (1 = single-token)
    mtp: int = 1
    # lossless speculative decoding over the MTP heads (B = 1): the drafts are
    # verified by the single-token sampler, whose stream comes out unchanged
    spec_decode: bool = False

    @property
    def eos_speech(self) -> int:
        return self.speech_token_size

    @property
    def sos_index(self) -> int:
        return self.speech_token_size + 1

    @property
    def task_index(self) -> int:
        return self.speech_token_size + 2


def build_prompt_embeddings(params: Params, cfg: SpeechLMConfig, text_tokens: torch.Tensor,
                            text_mask: torch.Tensor, prompt_speech: torch.Tensor,
                            prompt_speech_mask: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """``[sos] text [task] prompt_speech`` embeddings, right-padded: valid
    entries are compacted to a contiguous prefix per row by a stable sort on
    the mask, so a text shorter than its bucket leaves no hole."""
    b = text_tokens.shape[0]
    emb_table = params["speech_embed"]
    sos = embed_rows(emb_table, cfg.sos_index)[None, None, :].expand(b, 1, -1)
    task = embed_rows(emb_table, cfg.task_index)[None, None, :].expand(b, 1, -1)
    text_e = embed_rows(params["text_embed"], text_tokens) * text_mask[..., None]
    sp_e = embed_rows(emb_table, prompt_speech) * prompt_speech_mask[..., None]
    emb = torch.cat([sos, text_e, task, sp_e], dim=1)
    ones = torch.ones((b, 1), dtype=torch.bool, device=emb.device)
    mask = torch.cat([ones, text_mask, ones, prompt_speech_mask], dim=1)
    order = torch.argsort((~mask).to(torch.int32), dim=1, stable=True)
    emb = torch.take_along_dim(emb, order[..., None], dim=1)
    mask = torch.take_along_dim(mask, order, dim=1)
    return emb, mask


# ============================================================ flow matching


@dataclasses.dataclass(frozen=True)
class FlowConfig:
    token_vocab: int = 6561 + 3
    dim: int = 512
    layers: int = 6
    heads: int = 8
    n_mels: int = 80
    token_mel_ratio: int = 2
    spk_embed_dim: int = 192
    n_steps: int = 10
    cfg_rate: float = 0.7
    sigma_min: float = 1e-6


def _time_embedding(t: torch.Tensor, dim: int) -> torch.Tensor:
    """Sinusoidal flow-time embedding. t [B] in [0, 1] → [B, dim] (f32)."""
    half = dim // 2
    freqs = torch.exp(-np.float32(np.log(10000.0))
                      * torch.arange(half, dtype=torch.float32, device=t.device) / half)
    ang = t.float()[:, None] * freqs[None, :] * 1000.0
    return torch.cat([torch.cos(ang), torch.sin(ang)], dim=-1)


def _flow_rope(t_frames: int, head_dim: int, dtype, device):
    inv = 1.0 / (10_000.0 ** (np.arange(0, head_dim, 2) / head_dim))
    fr = np.outer(np.arange(t_frames), inv)
    emb = np.concatenate([fr, fr], axis=-1)
    return (torch.as_tensor(np.cos(emb).astype(np.float32), device=device).to(dtype),
            torch.as_tensor(np.sin(emb).astype(np.float32), device=device).to(dtype))


def _flow_rope_mha(p: Params, heads: int, x: torch.Tensor, mask: torch.Tensor) -> torch.Tensor:
    """Self-attention with RoPE on q/k: the estimator's only temporal signal."""
    head_dim = x.shape[-1] // heads
    cos, sin = _flow_rope(x.shape[1], head_dim, x.dtype, x.device)
    q = q2.apply_rope(split_heads(dense(p["q"], x), heads), cos, sin)
    k = q2.apply_rope(split_heads(dense(p["k"], x), heads), cos, sin)
    v = split_heads(dense(p["v"], x), heads)
    logits = torch.einsum("bqhd,bkhd->bhqk", q * (head_dim ** -0.5), k)
    logits = torch.where(mask, logits, torch.finfo(logits.dtype).min)
    w = torch.softmax(logits.float(), dim=-1).to(x.dtype)
    return dense(p["o"], merge_heads(torch.einsum("bhqk,bkhd->bqhd", w, v)))


def flow_estimator(params: Params, cfg: FlowConfig, x_t: torch.Tensor, t: torch.Tensor,
                   token_cond: torch.Tensor, spk: torch.Tensor, mel_cond: torch.Tensor,
                   mask: torch.Tensor) -> torch.Tensor:
    """DiT estimator v(x_t, t | tokens, speaker, prompt mel) → [B, T, n_mels]."""
    h = dense(params["in_proj"], torch.cat([x_t, mel_cond], dim=-1))
    h = h + token_cond + dense(params["spk_proj"], spk)[:, None, :]
    temb = mlp(params["time_mlp"], _time_embedding(t, cfg.dim).to(h.dtype))
    attn_mask = mask[:, None, None, :]
    for blk in params["blocks"]:
        mod = dense(blk["ada"], F.silu(temb))[:, None, :]
        s1, b1, g1, s2, b2, g2 = torch.chunk(mod, 6, dim=-1)
        a_in = layer_norm(blk["ln1"], h) * (1 + s1) + b1
        h = h + g1 * _flow_rope_mha(blk["attn"], cfg.heads, a_in, attn_mask)
        m_in = layer_norm(blk["ln2"], h) * (1 + s2) + b2
        h = h + g2 * mlp(blk["mlp"], m_in)
    return dense(params["out_proj"], layer_norm(params["ln_out"], h)) * mask[..., None]


def tokens_to_mel(params: Params, cfg: FlowConfig, noise: NoiseSource,
                  speech_tokens: torch.Tensor, token_mask: torch.Tensor,
                  spk_embedding: torch.Tensor, prompt_mel: torch.Tensor,
                  prompt_mel_mask: torch.Tensor, prompt_tokens: Optional[torch.Tensor] = None,
                  prompt_token_mask: Optional[torch.Tensor] = None):
    """OT-CFM inference: Euler-integrate dx/dt = v(x, t | c) from x_0 ~ N(0, I)
    with batched classifier-free guidance. The prompt mel (and its tokens)
    condition the first frames. Returns (mel [B, T_prompt + r T_tok, n_mels],
    frame_mask)."""
    b, t_tok = speech_tokens.shape
    r = cfg.token_mel_ratio
    tok = params["token_embed"][speech_tokens.long()] * token_mask[..., None]
    up = torch.repeat_interleave(tok, r, dim=1)
    up_mask = torch.repeat_interleave(token_mask, r, dim=1)
    t_prompt = prompt_mel.shape[1]
    if prompt_tokens is not None:
        ptok = params["token_embed"][prompt_tokens.long()] * prompt_token_mask[..., None]
        pup = torch.repeat_interleave(ptok, r, dim=1)
        if pup.shape[1] < t_prompt:
            pup = F.pad(pup, (0, 0, 0, t_prompt - pup.shape[1]))
        else:
            pup = pup[:, :t_prompt]
        prompt_cond = pup * prompt_mel_mask[..., None]
    else:
        prompt_cond = torch.zeros((b, t_prompt, cfg.dim), dtype=up.dtype, device=up.device)
    token_cond = torch.cat([prompt_cond, up], dim=1)
    frame_mask = torch.cat([prompt_mel_mask, up_mask], dim=1)
    total_frames = t_prompt + r * t_tok
    mel_cond = torch.cat([prompt_mel * prompt_mel_mask[..., None],
                          torch.zeros((b, r * t_tok, cfg.n_mels), dtype=prompt_mel.dtype,
                                      device=prompt_mel.device)], dim=1)
    x = noise.flow_x0((b, total_frames, cfg.n_mels)).to(prompt_mel.dtype)
    dt = 1.0 / cfg.n_steps
    if cfg.cfg_rate > 0:
        token_cond2 = torch.cat([token_cond, torch.zeros_like(token_cond)])
        spk2 = torch.cat([spk_embedding, torch.zeros_like(spk_embedding)])
        mel_cond2 = torch.cat([mel_cond, torch.zeros_like(mel_cond)])
        mask2 = torch.cat([frame_mask, frame_mask])
    for i in range(cfg.n_steps):
        t = torch.full((b,), float(np.float32(i) * np.float32(dt)), dtype=x.dtype, device=x.device)
        if cfg.cfg_rate > 0:
            v2 = flow_estimator(params, cfg, torch.cat([x, x]), torch.cat([t, t]),
                                token_cond2, spk2, mel_cond2, mask2)
            v = (1 + cfg.cfg_rate) * v2[:b] - cfg.cfg_rate * v2[b:]
        else:
            v = flow_estimator(params, cfg, x, t, token_cond, spk_embedding, mel_cond, frame_mask)
        x = (x + dt * v).to(x.dtype)
    return x * frame_mask[..., None], frame_mask


# ================================================================== vocoder


@dataclasses.dataclass(frozen=True)
class VocoderConfig:
    n_mels: int = 80
    base_channels: int = 512
    upsample_rates: Tuple[int, ...] = (8, 6, 10)     # 480 = 24 kHz / 50 Hz frames
    upsample_kernels: Tuple[int, ...] = (16, 12, 20)
    resblock_kernels: Tuple[int, ...] = (3, 7, 11)
    resblock_dilations: Tuple[Tuple[int, ...], ...] = ((1, 3, 5),) * 3

    @property
    def hop(self) -> int:
        out = 1
        for r in self.upsample_rates:
            out *= r
        return out


def _lrelu(x: torch.Tensor) -> torch.Tensor:
    return F.leaky_relu(x, 0.1)


def _conv1d(p: Params, x: torch.Tensor, *, dilation: int = 1) -> torch.Tensor:
    """'same' conv on [B, C, T]; x is cast to the kernel's dtype first."""
    width = p["kernel"].shape[-1]
    return F.conv1d(x.to(p["kernel"].dtype), p["kernel"], p["bias"],
                    padding=dilation * (width - 1) // 2, dilation=dilation)


def _conv_transpose1d(p: Params, x: torch.Tensor, stride: int) -> torch.Tensor:
    """torch ConvTranspose1d(stride=s, padding=(k−s)//2) trimmed to
    in_len × s, the JAX package's asymmetric padding (HiFi-GAN's length
    contract)."""
    width = p["kernel"].shape[-1]
    y = F.conv_transpose1d(x, p["kernel"], p["bias"], stride=stride,
                           padding=(width - stride) // 2)
    return y[..., : x.shape[-1] * stride]


def vocode(params: Params, cfg: VocoderConfig, mel: torch.Tensor) -> torch.Tensor:
    """mel [B, T, n_mels] → waveform [B, T * hop] at 24 kHz. Stages with
    C ≤ 128 and C % 8 == 0 run the fused resblock kernel."""
    x = _conv1d(params["conv_pre"], mel.transpose(1, 2))
    for up, stage, rate in zip(params["ups"], params["res"], cfg.upsample_rates):
        x = _conv_transpose1d(up, _lrelu(x), rate)
        ch = x.shape[1]
        if ch <= 128 and ch % 8 == 0:
            weights = cuda_vocoder.stage_weights_flat(stage, cfg.resblock_kernels,
                                                      cfg.resblock_dilations)
            x = cuda_vocoder.fused_resblock_stage(
                x.transpose(1, 2), weights, kernels=tuple(cfg.resblock_kernels),
                dilations=tuple(tuple(d) for d in cfg.resblock_dilations)).transpose(1, 2)
            continue
        acc = None
        for block, dils in zip(stage, cfg.resblock_dilations):
            h = x
            for unit, d in zip(block, dils):
                y = _conv1d(unit["c1"], _lrelu(h), dilation=d)
                y = _conv1d(unit["c2"], _lrelu(y))
                h = h + y
            acc = h if acc is None else acc + h
        x = acc / len(stage)
    x = torch.tanh(_conv1d(params["conv_post"], _lrelu(x)))
    return x[:, 0, :]


# ============================================================== full model


@dataclasses.dataclass(frozen=True)
class CosyVoiceConfig:
    lm: SpeechLMConfig = dataclasses.field(default_factory=SpeechLMConfig)
    flow: FlowConfig = dataclasses.field(default_factory=FlowConfig)
    vocoder: VocoderConfig = dataclasses.field(default_factory=VocoderConfig)
    sample_rate: int = 24_000


def init_speech_lm(r: Init, cfg: SpeechLMConfig) -> Params:
    """Seeded random speech-LM parameters (no MTP heads: see
    :func:`init_mtp_heads`)."""
    h = cfg.backbone.hidden
    return {"backbone": q2.init_qwen2(r, cfg.backbone),
            "text_embed": r.normal((cfg.text_vocab, h), 0.02),
            "speech_embed": r.normal((cfg.speech_token_size + 3, h), 0.02),
            "head": r.dense(h, cfg.speech_token_size + 3)}


def init_mtp_heads(r: Init, cfg: SpeechLMConfig) -> list:
    """The K − 1 MTP heads of ``cfg.mtp`` = K, dense [hidden,
    speech_token_size + 3]. A model's init draws them last, so every other
    tensor is the same at any MTP width."""
    return [r.dense(cfg.backbone.hidden, cfg.speech_token_size + 3) for _ in range(cfg.mtp - 1)]


def init_cosyvoice(seed: int, cfg: CosyVoiceConfig, device) -> Params:
    """Seeded random parameters (f32) on ``device``, the JAX init's shapes and
    scales; adaLN modulation zero-initialised (adaLN-Zero); with
    ``cfg.lm.mtp`` > 1 the LM's ``mtp_heads``, K − 1 dense heads
    [hidden, speech_token_size + 3]."""
    r = Init(seed, device)
    lm, fl, vc = cfg.lm, cfg.flow, cfg.vocoder

    def conv(width, in_ch, out_ch):
        return {"kernel": r.uniform((out_ch, in_ch, width), 1.0 / np.sqrt(in_ch * width)),
                "bias": r.zeros((out_ch,))}

    ch = vc.base_channels
    ups, res = [], []
    for i, (rate, kw) in enumerate(zip(vc.upsample_rates, vc.upsample_kernels)):
        in_ch, out_ch = ch // (2 ** i), ch // (2 ** (i + 1))
        ups.append({"kernel": r.uniform((in_ch, out_ch, kw), 1.0 / np.sqrt(in_ch * kw)),
                    "bias": r.zeros((out_ch,))})
        res.append([[{"c1": conv(k, out_ch, out_ch), "c2": conv(k, out_ch, out_ch)}
                     for _ in dils]
                    for k, dils in zip(vc.resblock_kernels, vc.resblock_dilations)])
    attn = AttnConfig(fl.dim, fl.heads, k_bias=True)
    params = {
        "lm": init_speech_lm(r, lm),
        "flow": {
            "token_embed": r.normal((fl.token_vocab, fl.dim), 0.02),
            "spk_proj": r.dense(fl.spk_embed_dim, fl.dim),
            "in_proj": r.dense(fl.n_mels * 2, fl.dim),
            "time_mlp": r.mlp(fl.dim, fl.dim),
            "blocks": [{"ln1": r.layer_norm(fl.dim), "attn": r.attention(attn),
                        "ln2": r.layer_norm(fl.dim), "mlp": r.mlp(fl.dim, fl.dim * 4),
                        "ada": {"kernel": r.zeros((fl.dim, 6 * fl.dim)),
                                "bias": r.zeros((6 * fl.dim,))}}
                       for _ in range(fl.layers)],
            "ln_out": r.layer_norm(fl.dim),
            "out_proj": r.dense(fl.dim, fl.n_mels),
        },
        "vocoder": {
            "conv_pre": conv(7, vc.n_mels, ch),
            "ups": ups,
            "res": res,
            "conv_post": conv(7, ch // (2 ** len(vc.upsample_rates)), 1),
        },
    }
    if lm.mtp > 1:
        params["lm"]["mtp_heads"] = init_mtp_heads(r, lm)
    return params


# ========================================================= streaming synthesis


