"""MuseTalk lip-sync: SD AutoencoderKL + single-step conditional UNet.

The port of the JAX package's ``models/musetalk.py``: VAE-encode 256×256
face crops to latents, one UNet pass at timestep 0 conditioned on 50 Hz
whisper encoder states, VAE-decode, and the jaw-mode feathered blend back
into the frame. Face detection stays on the host (``pipeline/face.py``);
this module is the device compute.

The architecture is checkpoint-exact, so the published weights load:

- VAE: diffusers ``AutoencoderKL`` at the ``sd-vae-ft-mse`` geometry —
  block_out_channels (128, 256, 512, 512), 2 resnets per block, a mid-block
  with single-head spatial attention, quant / post-quant 1×1 convs, scaling
  factor 0.18215. 256×256×3 → 32×32×4 latents (the posterior mean).
- UNet: diffusers ``UNet2DConditionModel`` at MuseTalk's musetalk.json
  geometry — in_channels 8 (masked ⊕ reference latent), cross-attention on
  the 384-wide audio context (whisper-tiny states), block_out_channels
  (320, 640, 1280, 1280), 3 cross-attention down blocks and a plain one, 2
  layers per block, 8 heads, GEGLU feed-forwards, a sinusoidal + MLP
  timestep embedding.
- PE: MuseTalk's parameter-free sinusoidal encoding over the audio windows.

Models are nested dicts of tensors with plain functions, as in the port's
other models. Activations are NCHW; conv kernels are torch's OIHW and dense
kernels ``[in, out]``. A block without a downsampler, upsampler or
attentions has no such key (the JAX tree holds ``None`` there).
:func:`from_jax_params` carries the JAX package's NHWC/HWIO tree across;
:func:`vae_from_hf_state_dict` / :func:`unet_from_hf_state_dict` read the
published torch state dicts (modern and legacy attention naming). JAX runs
these convolutions and attentions outside any Pallas kernel, and so does the
port: ``F.conv2d``, ``torch.matmul`` and softmax.
"""

from __future__ import annotations

import dataclasses
import functools
import math
from typing import Any, Dict, List, Tuple

import numpy as np
import torch
import torch.nn.functional as F

from ..core.device import resolve_device
from .common import Init, Params, cast_floats, dense, state_tensor, tree_from_numpy

VAE_SCALE = 0.18215


@dataclasses.dataclass(frozen=True)
class MuseTalkConfig:
    image_size: int = 256
    latent_channels: int = 4
    vae_channels: Tuple[int, ...] = (128, 256, 512, 512)
    vae_layers: int = 2            # resnets per encoder block (decoder: +1)
    unet_channels: Tuple[int, ...] = (320, 640, 1280, 1280)
    unet_layers: int = 2           # resnets per down block (up: +1)
    audio_dim: int = 384           # whisper-tiny encoder width
    audio_ctx: int = 50            # feature steps per video-frame window
    heads: int = 8                 # musetalk.json attention_head_dim=8
    norm_groups: int = 32

    @property
    def time_embed_dim(self) -> int:
        return 4 * self.unet_channels[0]


# ------------------------------------------------------------------ parameters


def _init_conv(r: Init, width: int, in_ch: int, out_ch: int) -> Params:
    return {"kernel": r.uniform((out_ch, in_ch, width, width), 1.0 / math.sqrt(in_ch * width * width)),
            "bias": r.zeros((out_ch,))}


def _init_resblock(r: Init, in_ch: int, out_ch: int, temb_dim: int = 0) -> Params:
    p = {"norm1": r.layer_norm(in_ch), "conv1": _init_conv(r, 3, in_ch, out_ch),
         "norm2": r.layer_norm(out_ch), "conv2": _init_conv(r, 3, out_ch, out_ch)}
    if temb_dim:
        p["temb"] = r.dense(temb_dim, out_ch)
    if in_ch != out_ch:
        p["shortcut"] = _init_conv(r, 1, in_ch, out_ch)
    return p


def _init_vae_attn(r: Init, ch: int) -> Params:
    return {"gn": r.layer_norm(ch), "q": r.dense(ch, ch), "k": r.dense(ch, ch),
            "v": r.dense(ch, ch), "o": r.dense(ch, ch)}


def _init_transformer2d(r: Init, ch: int, ctx_dim: int) -> Params:
    def attn(kv_dim):
        return {"q": r.dense(ch, ch, bias=False), "k": r.dense(kv_dim, ch, bias=False),
                "v": r.dense(kv_dim, ch, bias=False), "o": r.dense(ch, ch)}

    return {"gn": r.layer_norm(ch), "proj_in": _init_conv(r, 1, ch, ch),
            "norm1": r.layer_norm(ch), "attn1": attn(ch),
            "norm2": r.layer_norm(ch), "attn2": attn(ctx_dim),
            "norm3": r.layer_norm(ch),
            "ff_proj": r.dense(ch, 8 * ch),      # GEGLU: value ⊕ gate
            "ff_out": r.dense(4 * ch, ch),
            "proj_out": _init_conv(r, 1, ch, ch)}


def _init_vae(r: Init, cfg: MuseTalkConfig) -> Params:
    chans, lat = cfg.vae_channels, cfg.latent_channels
    enc: Dict[str, Any] = {"conv_in": _init_conv(r, 3, 3, chans[0]), "down": []}
    in_ch = chans[0]
    for i, ch in enumerate(chans):
        block: Dict[str, Any] = {"resnets": []}
        for _ in range(cfg.vae_layers):
            block["resnets"].append(_init_resblock(r, in_ch, ch))
            in_ch = ch
        if i < len(chans) - 1:
            block["downsample"] = _init_conv(r, 3, ch, ch)
        enc["down"].append(block)
    enc["mid"] = {"res1": _init_resblock(r, chans[-1], chans[-1]),
                  "attn": _init_vae_attn(r, chans[-1]),
                  "res2": _init_resblock(r, chans[-1], chans[-1])}
    enc["norm_out"] = r.layer_norm(chans[-1])
    enc["conv_out"] = _init_conv(r, 3, chans[-1], 2 * lat)
    dec: Dict[str, Any] = {
        "conv_in": _init_conv(r, 3, lat, chans[-1]),
        "mid": {"res1": _init_resblock(r, chans[-1], chans[-1]),
                "attn": _init_vae_attn(r, chans[-1]),
                "res2": _init_resblock(r, chans[-1], chans[-1])},
        "up": []}
    rev = list(reversed(chans))
    in_ch = rev[0]
    for i, ch in enumerate(rev):
        block = {"resnets": []}
        for _ in range(cfg.vae_layers + 1):
            block["resnets"].append(_init_resblock(r, in_ch, ch))
            in_ch = ch
        if i < len(chans) - 1:
            block["upsample"] = _init_conv(r, 3, ch, ch)
        dec["up"].append(block)
    dec["norm_out"] = r.layer_norm(chans[0])
    dec["conv_out"] = _init_conv(r, 3, chans[0], 3)
    return {"encoder": enc, "decoder": dec,
            "quant_conv": _init_conv(r, 1, 2 * lat, 2 * lat),
            "post_quant_conv": _init_conv(r, 1, lat, lat)}


def _init_unet(r: Init, cfg: MuseTalkConfig) -> Params:
    chans, te, n = cfg.unet_channels, cfg.time_embed_dim, len(cfg.unet_channels)
    p: Dict[str, Any] = {
        "conv_in": _init_conv(r, 3, 2 * cfg.latent_channels, chans[0]),
        "time_mlp": {"lin1": r.dense(chans[0], te), "lin2": r.dense(te, te)},
        "down": [], "up": []}
    in_ch = chans[0]
    for i, ch in enumerate(chans):
        cross = i < n - 1          # the last down block is a plain DownBlock2D
        block: Dict[str, Any] = {"resnets": []}
        if cross:
            block["attns"] = []
        for _ in range(cfg.unet_layers):
            block["resnets"].append(_init_resblock(r, in_ch, ch, te))
            in_ch = ch
            if cross:
                block["attns"].append(_init_transformer2d(r, ch, cfg.audio_dim))
        if i < n - 1:
            block["downsample"] = _init_conv(r, 3, ch, ch)
        p["down"].append(block)
    p["mid"] = {"res1": _init_resblock(r, chans[-1], chans[-1], te),
                "attn": _init_transformer2d(r, chans[-1], cfg.audio_dim),
                "res2": _init_resblock(r, chans[-1], chans[-1], te)}
    rev = list(reversed(chans))
    prev = rev[0]
    for i, ch in enumerate(rev):
        cross = i > 0              # the first up block is a plain UpBlock2D
        skip_in = rev[min(i + 1, n - 1)]
        block = {"resnets": []}
        if cross:
            block["attns"] = []
        for j in range(cfg.unet_layers + 1):
            skip_ch = skip_in if j == cfg.unet_layers else ch
            block["resnets"].append(_init_resblock(r, (prev if j == 0 else ch) + skip_ch, ch, te))
            if cross:
                block["attns"].append(_init_transformer2d(r, ch, cfg.audio_dim))
        prev = ch
        if i < n - 1:
            block["upsample"] = _init_conv(r, 3, ch, ch)
        p["up"].append(block)
    p["norm_out"] = r.layer_norm(chans[0])
    p["conv_out"] = _init_conv(r, 3, chans[0], cfg.latent_channels)
    return p


def init_musetalk(seed: int, cfg: MuseTalkConfig, device) -> Params:
    """Seeded random parameters (f32) on ``device``: {"vae", "unet"}."""
    r = Init(seed, device)
    return {"vae": _init_vae(r, cfg), "unet": _init_unet(r, cfg)}


def from_jax_params(tree, device, dtype=torch.float32) -> Params:
    """The JAX package's MuseTalk tree (nested dicts/lists of numpy arrays,
    ``None`` where a block has no downsampler, upsampler or attentions) → the
    port's: ``None`` entries dropped, conv kernels HWIO ``[kh, kw, in, out]``
    → OIHW ``[out, in, kh, kw]``, dense kernels kept ``[in, out]``."""
    def prune(node):
        if isinstance(node, dict):
            return {k: prune(v) for k, v in node.items() if v is not None}
        if isinstance(node, (list, tuple)):
            return [prune(v) for v in node]
        return node

    def permute(node):
        if isinstance(node, dict):
            for k, v in node.items():
                if k == "kernel" and torch.is_tensor(v) and v.ndim == 4:
                    node[k] = v.permute(3, 2, 0, 1).contiguous()
                else:
                    permute(v)
        elif isinstance(node, list):
            for v in node:
                permute(v)
        return node

    return permute(tree_from_numpy(prune(tree), device, dtype))


# ---------------------------------------------------------------------- layers


def _conv2d(p: Params, x: torch.Tensor, *, stride: int = 1, pad: str = "same") -> torch.Tensor:
    x = x.to(p["kernel"].dtype)
    if pad == "asym":
        # diffusers VAE Downsample2D: F.pad (0,1,0,1), then a stride-2 valid conv
        return F.conv2d(F.pad(x, (0, 1, 0, 1)), p["kernel"], p["bias"], stride=stride)
    return F.conv2d(x, p["kernel"], p["bias"], stride=stride,
                    padding=(p["kernel"].shape[-1] - 1) // 2)


def _group_norm(p: Params, x: torch.Tensor, groups: int, eps: float) -> torch.Tensor:
    return F.group_norm(x, groups, p["scale"], p["bias"], eps)


def _layer_norm(p: Params, x: torch.Tensor) -> torch.Tensor:
    return F.layer_norm(x, x.shape[-1:], p["scale"], p["bias"], 1e-5)


def _upsample2x(x: torch.Tensor) -> torch.Tensor:
    return F.interpolate(x, scale_factor=2.0, mode="nearest")


def _resblock(p: Params, x: torch.Tensor, temb=None, *, groups: int, eps: float) -> torch.Tensor:
    """diffusers ResnetBlock2D (output_scale_factor 1; the time embedding
    added after conv1)."""
    h = _conv2d(p["conv1"], F.silu(_group_norm(p["norm1"], x, groups, eps)))
    if temb is not None and "temb" in p:
        h = h + dense(p["temb"], F.silu(temb))[:, :, None, None].to(h.dtype)
    h = _conv2d(p["conv2"], F.silu(_group_norm(p["norm2"], h, groups, eps)))
    return (_conv2d(p["shortcut"], x) if "shortcut" in p else x) + h


def _attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor) -> torch.Tensor:
    """softmax(q kᵀ / √d) v over [..., T, d], the weights in f32 then cast."""
    logits = (q @ k.transpose(-1, -2)) / math.sqrt(q.shape[-1])
    return torch.softmax(logits.float(), dim=-1).to(v.dtype) @ v


def _vae_attn(p: Params, x: torch.Tensor, *, groups: int) -> torch.Tensor:
    """Single-head spatial self-attention (the VAE mid-block's diffusers
    Attention: group norm → to_q/k/v → softmax(QKᵀ/√C)V → to_out + residual)."""
    b, c, h, w = x.shape
    n = _group_norm(p["gn"], x, groups, 1e-6).reshape(b, c, h * w).transpose(1, 2)
    out = dense(p["o"], _attention(dense(p["q"], n), dense(p["k"], n), dense(p["v"], n)))
    return x + out.transpose(1, 2).reshape(b, c, h, w)


def _xattn(p: Params, x: torch.Tensor, ctx: torch.Tensor, heads: int) -> torch.Tensor:
    """Multi-head attention: queries x [B, N, C], keys and values from ctx."""
    b, n, c = x.shape

    def split(t):
        return t.reshape(b, -1, heads, c // heads).transpose(1, 2)

    out = _attention(split(dense(p["q"], x)), split(dense(p["k"], ctx)), split(dense(p["v"], ctx)))
    return dense(p["o"], out.transpose(1, 2).reshape(b, n, c))


def _transformer2d(p: Params, x: torch.Tensor, ctx: torch.Tensor, heads: int, *,
                   groups: int) -> torch.Tensor:
    """diffusers Transformer2DModel (use_linear_projection=False): GN → conv
    proj_in → one BasicTransformerBlock (self-attention, cross-attention,
    GEGLU feed-forward, pre-LN) → conv proj_out + residual."""
    b, c, hh, ww = x.shape
    h = _conv2d(p["proj_in"], _group_norm(p["gn"], x, groups, 1e-6))
    h = h.reshape(b, c, hh * ww).transpose(1, 2)
    n1 = _layer_norm(p["norm1"], h)
    h = h + _xattn(p["attn1"], n1, n1, heads)
    h = h + _xattn(p["attn2"], _layer_norm(p["norm2"], h), ctx.to(h.dtype), heads)
    val, gate = dense(p["ff_proj"], _layer_norm(p["norm3"], h)).chunk(2, dim=-1)
    h = h + dense(p["ff_out"], val * F.gelu(gate))
    return x + _conv2d(p["proj_out"], h.transpose(1, 2).reshape(b, c, hh, ww))


# ------------------------------------------------------------------------ VAE


def vae_encode(params: Params, cfg: MuseTalkConfig, images: torch.Tensor) -> torch.Tensor:
    """[B, 3, S, S] in [-1, 1] → latents [B, 4, S/8, S/8] × 0.18215 (the
    posterior mean, where the reference samples)."""
    g = cfg.norm_groups
    enc = params["encoder"]
    x = _conv2d(enc["conv_in"], images)
    for down in enc["down"]:
        for res in down["resnets"]:
            x = _resblock(res, x, groups=g, eps=1e-6)
        if "downsample" in down:
            x = _conv2d(down["downsample"], x, stride=2, pad="asym")
    x = _resblock(enc["mid"]["res1"], x, groups=g, eps=1e-6)
    x = _vae_attn(enc["mid"]["attn"], x, groups=g)
    x = _resblock(enc["mid"]["res2"], x, groups=g, eps=1e-6)
    x = _conv2d(enc["conv_out"], F.silu(_group_norm(enc["norm_out"], x, g, 1e-6)))
    mean = _conv2d(params["quant_conv"], x)[:, : cfg.latent_channels]
    return mean * VAE_SCALE


def vae_decode(params: Params, cfg: MuseTalkConfig, latents: torch.Tensor) -> torch.Tensor:
    """Latents [B, 4, s, s] → images [B, 3, 8s, 8s]."""
    g = cfg.norm_groups
    dec = params["decoder"]
    x = _conv2d(params["post_quant_conv"], latents / VAE_SCALE)
    x = _conv2d(dec["conv_in"], x)
    x = _resblock(dec["mid"]["res1"], x, groups=g, eps=1e-6)
    x = _vae_attn(dec["mid"]["attn"], x, groups=g)
    x = _resblock(dec["mid"]["res2"], x, groups=g, eps=1e-6)
    for up in dec["up"]:
        for res in up["resnets"]:
            x = _resblock(res, x, groups=g, eps=1e-6)
        if "upsample" in up:
            x = _conv2d(up["upsample"], _upsample2x(x))
    return _conv2d(dec["conv_out"], F.silu(_group_norm(dec["norm_out"], x, g, 1e-6)))


# ----------------------------------------------------------------------- UNet


def timestep_embedding(t: torch.Tensor, dim: int) -> torch.Tensor:
    """diffusers Timesteps(dim, flip_sin_to_cos=True, freq_shift=0): [cos |
    sin] ordering, denominator ``half``."""
    half = dim // 2
    freqs = torch.exp(-math.log(10_000.0)
                      * torch.arange(half, dtype=torch.float32, device=t.device) / half)
    args = t.float()[:, None] * freqs[None]
    return torch.cat([torch.cos(args), torch.sin(args)], dim=-1)


def unet_apply(params: Params, cfg: MuseTalkConfig, latents8: torch.Tensor,
               audio_ctx: torch.Tensor, timestep: float = 0.0) -> torch.Tensor:
    """UNet2DConditionModel forward: [B, 8, h, w] + audio [B, S, audio_dim]
    (+ a scalar timestep, 0 in MuseTalk) → predicted latents [B, 4, h, w]."""
    g = cfg.norm_groups
    b = latents8.shape[0]
    t = torch.full((b,), float(timestep), dtype=torch.float32, device=latents8.device)
    lin1 = params["time_mlp"]["lin1"]
    temb = timestep_embedding(t, cfg.unet_channels[0]).to(lin1["kernel"].dtype)
    temb = dense(params["time_mlp"]["lin2"], F.silu(dense(lin1, temb)))

    x = _conv2d(params["conv_in"], latents8)
    skips: List[torch.Tensor] = [x]
    for down in params["down"]:
        for j, res in enumerate(down["resnets"]):
            x = _resblock(res, x, temb, groups=g, eps=1e-5)
            if "attns" in down:
                x = _transformer2d(down["attns"][j], x, audio_ctx, cfg.heads, groups=g)
            skips.append(x)
        if "downsample" in down:
            x = _conv2d(down["downsample"], x, stride=2)
            skips.append(x)

    x = _resblock(params["mid"]["res1"], x, temb, groups=g, eps=1e-5)
    x = _transformer2d(params["mid"]["attn"], x, audio_ctx, cfg.heads, groups=g)
    x = _resblock(params["mid"]["res2"], x, temb, groups=g, eps=1e-5)

    for up in params["up"]:
        for j, res in enumerate(up["resnets"]):
            x = _resblock(res, torch.cat([x, skips.pop()], dim=1), temb, groups=g, eps=1e-5)
            if "attns" in up:
                x = _transformer2d(up["attns"][j], x, audio_ctx, cfg.heads, groups=g)
        if "upsample" in up:
            x = _conv2d(up["upsample"], _upsample2x(x))
    return _conv2d(params["conv_out"], F.silu(_group_norm(params["norm_out"], x, g, 1e-5)))


# ------------------------------------------------------------------ converters


def _conv_p(sd, prefix, dev) -> Params:
    return {"kernel": state_tensor(sd[f"{prefix}.weight"], dev),
            "bias": state_tensor(sd[f"{prefix}.bias"], dev)}


def _dense_p(sd, prefix, dev, *, bias=True) -> Params:
    p = {"kernel": state_tensor(sd[f"{prefix}.weight"], dev).T.contiguous()}
    if bias:
        p["bias"] = state_tensor(sd[f"{prefix}.bias"], dev)
    return p


def _gn_p(sd, prefix, dev) -> Params:
    return {"scale": state_tensor(sd[f"{prefix}.weight"], dev),
            "bias": state_tensor(sd[f"{prefix}.bias"], dev)}


def _res_p(sd, prefix, dev, *, temb=False) -> Params:
    p = {"norm1": _gn_p(sd, f"{prefix}.norm1", dev), "conv1": _conv_p(sd, f"{prefix}.conv1", dev),
         "norm2": _gn_p(sd, f"{prefix}.norm2", dev), "conv2": _conv_p(sd, f"{prefix}.conv2", dev)}
    if temb and f"{prefix}.time_emb_proj.weight" in sd:
        p["temb"] = _dense_p(sd, f"{prefix}.time_emb_proj", dev)
    if f"{prefix}.conv_shortcut.weight" in sd:
        p["shortcut"] = _conv_p(sd, f"{prefix}.conv_shortcut", dev)
    return p


def _vae_attn_p(sd, prefix, dev) -> Params:
    """modern: group_norm / to_q / to_k / to_v / to_out.0; legacy: norm /
    query / key / value / proj_attn (1×1 convs stored [out, in] or
    [out, in, 1, 1])."""
    def lin(modern, legacy):
        name = modern if f"{prefix}.{modern}.weight" in sd else legacy
        w = state_tensor(sd[f"{prefix}.{name}.weight"], dev)
        if w.ndim == 4:
            w = w[:, :, 0, 0]
        return {"kernel": w.T.contiguous(), "bias": state_tensor(sd[f"{prefix}.{name}.bias"], dev)}

    gn = "group_norm" if f"{prefix}.group_norm.weight" in sd else "norm"
    return {"gn": _gn_p(sd, f"{prefix}.{gn}", dev),
            "q": lin("to_q", "query"), "k": lin("to_k", "key"),
            "v": lin("to_v", "value"), "o": lin("to_out.0", "proj_attn")}


def _optional(block: Dict[str, Any], key: str, sd, name: str, dev) -> Dict[str, Any]:
    if f"{name}.weight" in sd:
        block[key] = _conv_p(sd, name, dev)
    return block


def vae_from_hf_state_dict(sd: Dict[str, Any], cfg: MuseTalkConfig, device=None,
                           dtype=torch.float32) -> Params:
    """diffusers AutoencoderKL state dict (sd-vae-ft-mse) → the VAE tree on
    ``device``, floating leaves in ``dtype``."""
    dev = resolve_device(device)
    n = len(cfg.vae_channels)
    enc: Dict[str, Any] = {"conv_in": _conv_p(sd, "encoder.conv_in", dev), "down": [
        _optional({"resnets": [_res_p(sd, f"encoder.down_blocks.{i}.resnets.{j}", dev)
                               for j in range(cfg.vae_layers)]},
                  "downsample", sd, f"encoder.down_blocks.{i}.downsamplers.0.conv", dev)
        for i in range(n)]}
    enc["mid"] = {"res1": _res_p(sd, "encoder.mid_block.resnets.0", dev),
                  "attn": _vae_attn_p(sd, "encoder.mid_block.attentions.0", dev),
                  "res2": _res_p(sd, "encoder.mid_block.resnets.1", dev)}
    enc["norm_out"] = _gn_p(sd, "encoder.conv_norm_out", dev)
    enc["conv_out"] = _conv_p(sd, "encoder.conv_out", dev)
    dec: Dict[str, Any] = {
        "conv_in": _conv_p(sd, "decoder.conv_in", dev),
        "mid": {"res1": _res_p(sd, "decoder.mid_block.resnets.0", dev),
                "attn": _vae_attn_p(sd, "decoder.mid_block.attentions.0", dev),
                "res2": _res_p(sd, "decoder.mid_block.resnets.1", dev)},
        "up": [_optional({"resnets": [_res_p(sd, f"decoder.up_blocks.{i}.resnets.{j}", dev)
                                      for j in range(cfg.vae_layers + 1)]},
                         "upsample", sd, f"decoder.up_blocks.{i}.upsamplers.0.conv", dev)
               for i in range(n)],
        "norm_out": _gn_p(sd, "decoder.conv_norm_out", dev),
        "conv_out": _conv_p(sd, "decoder.conv_out", dev)}
    return cast_floats({"encoder": enc, "decoder": dec,
                        "quant_conv": _conv_p(sd, "quant_conv", dev),
                        "post_quant_conv": _conv_p(sd, "post_quant_conv", dev)}, dtype)


def _tfm_p(sd, prefix, dev) -> Params:
    tb = f"{prefix}.transformer_blocks.0"

    def attn(name):
        return {"q": _dense_p(sd, f"{tb}.{name}.to_q", dev, bias=False),
                "k": _dense_p(sd, f"{tb}.{name}.to_k", dev, bias=False),
                "v": _dense_p(sd, f"{tb}.{name}.to_v", dev, bias=False),
                "o": _dense_p(sd, f"{tb}.{name}.to_out.0", dev)}

    return {"gn": _gn_p(sd, f"{prefix}.norm", dev), "proj_in": _conv_p(sd, f"{prefix}.proj_in", dev),
            "norm1": _gn_p(sd, f"{tb}.norm1", dev), "attn1": attn("attn1"),
            "norm2": _gn_p(sd, f"{tb}.norm2", dev), "attn2": attn("attn2"),
            "norm3": _gn_p(sd, f"{tb}.norm3", dev),
            "ff_proj": _dense_p(sd, f"{tb}.ff.net.0.proj", dev),
            "ff_out": _dense_p(sd, f"{tb}.ff.net.2", dev),
            "proj_out": _conv_p(sd, f"{prefix}.proj_out", dev)}


def unet_from_hf_state_dict(sd: Dict[str, Any], cfg: MuseTalkConfig, device=None,
                            dtype=torch.float32) -> Params:
    """diffusers UNet2DConditionModel state dict (MuseTalk's
    pytorch_model.bin, musetalk.json geometry) → the UNet tree on
    ``device``, floating leaves in ``dtype``."""
    dev = resolve_device(device)
    n = len(cfg.unet_channels)
    p: Dict[str, Any] = {
        "conv_in": _conv_p(sd, "conv_in", dev),
        "time_mlp": {"lin1": _dense_p(sd, "time_embedding.linear_1", dev),
                     "lin2": _dense_p(sd, "time_embedding.linear_2", dev)},
        "down": [], "up": []}
    for i in range(n):
        block: Dict[str, Any] = {"resnets": [_res_p(sd, f"down_blocks.{i}.resnets.{j}", dev, temb=True)
                                             for j in range(cfg.unet_layers)]}
        if i < n - 1:
            block["attns"] = [_tfm_p(sd, f"down_blocks.{i}.attentions.{j}", dev)
                              for j in range(cfg.unet_layers)]
        p["down"].append(_optional(block, "downsample", sd, f"down_blocks.{i}.downsamplers.0.conv",
                                   dev))
    p["mid"] = {"res1": _res_p(sd, "mid_block.resnets.0", dev, temb=True),
                "attn": _tfm_p(sd, "mid_block.attentions.0", dev),
                "res2": _res_p(sd, "mid_block.resnets.1", dev, temb=True)}
    for i in range(n):
        block = {"resnets": [_res_p(sd, f"up_blocks.{i}.resnets.{j}", dev, temb=True)
                             for j in range(cfg.unet_layers + 1)]}
        if i > 0:
            block["attns"] = [_tfm_p(sd, f"up_blocks.{i}.attentions.{j}", dev)
                              for j in range(cfg.unet_layers + 1)]
        p["up"].append(_optional(block, "upsample", sd, f"up_blocks.{i}.upsamplers.0.conv", dev))
    p["norm_out"] = _gn_p(sd, "conv_norm_out", dev)
    p["conv_out"] = _conv_p(sd, "conv_out", dev)
    return cast_floats(p, dtype)


def from_hf_state_dict(vae_sd: Dict[str, Any], unet_sd: Dict[str, Any], cfg: MuseTalkConfig,
                       device=None, dtype=torch.float32) -> Params:
    return {"vae": vae_from_hf_state_dict(vae_sd, cfg, device, dtype),
            "unet": unet_from_hf_state_dict(unet_sd, cfg, device, dtype)}


# ------------------------------------------------------------------- pipeline


@functools.lru_cache(maxsize=16)
def _pe_table(s: int, d: int) -> np.ndarray:
    pos = np.arange(s, dtype=np.float32)[:, None]
    div = np.exp(np.arange(0, d, 2, dtype=np.float32) * (-np.log(10_000.0) / d))
    pe = np.zeros((s, d), np.float32)
    pe[:, 0::2] = np.sin(pos * div)
    pe[:, 1::2] = np.cos(pos * div[: d // 2])
    return pe


def positional_encoding(x: torch.Tensor) -> torch.Tensor:
    """MuseTalk's parameter-free sinusoidal PositionalEncoding over the audio
    feature window: x [..., S, D] + PE[S, D]."""
    pe = torch.as_tensor(_pe_table(x.shape[-2], x.shape[-1]), device=x.device)
    return x + pe.to(x.dtype)


def whisper_chunks_for_video(audio_features: torch.Tensor, n_frames: int, fps: float, *,
                             feature_rate: float = 50.0, ctx: int = 50) -> torch.Tensor:
    """Align whisper encoder features [T_feat, D] to video frames: for each
    frame, a window of ``ctx`` feature steps centred at the frame time
    (musetalk's get_whisper_chunk: ±2 video frames of 50 Hz features around
    each frame) → [n_frames, ctx, D]."""
    t_feat = audio_features.shape[0]
    centers = (np.arange(n_frames) / fps * feature_rate).astype(np.int64)
    starts = np.clip(centers - ctx // 2, 0, max(t_feat - ctx, 0))
    idx = np.clip(starts[:, None] + np.arange(ctx)[None, :], 0, t_feat - 1)
    return audio_features[torch.as_tensor(idx, device=audio_features.device)]


def lipsync_frames(params: Params, cfg: MuseTalkConfig, face_crops: torch.Tensor,
                   audio_windows: torch.Tensor, *, batch_size: int = 8) -> torch.Tensor:
    """Re-render mouths: per frame, mask the lower half, UNet-inpaint from the
    reference latent and the PE'd audio window at timestep 0, VAE-decode.
    face_crops [N, 3, S, S] in [-1, 1], audio_windows [N, ctx, audio_dim] →
    [N, 3, S, S]. Frames go through in batches of ``batch_size``. JAX pads
    the last batch with zero frames (a static shape for its fori_loop); every
    op here is per frame, so the port runs the short batch as it is and the
    real frames come out the same."""
    mask = torch.ones((1, 1, cfg.image_size, 1), dtype=face_crops.dtype, device=face_crops.device)
    mask[:, :, cfg.image_size // 2:] = 0.0
    out = []
    for start in range(0, face_crops.shape[0], batch_size):
        crops = face_crops[start:start + batch_size]
        audio = positional_encoding(audio_windows[start:start + batch_size])
        ref = vae_encode(params["vae"], cfg, crops)
        masked = vae_encode(params["vae"], cfg, crops * mask)
        pred = unet_apply(params["unet"], cfg, torch.cat([masked, ref], dim=1), audio)
        out.append(vae_decode(params["vae"], cfg, pred))
    return torch.cat(out, dim=0)


@functools.lru_cache(maxsize=64)
def _linear_weights(in_size: int, out_size: int) -> np.ndarray:
    """``jax.image.resize(..., "linear")``'s weight matrix [in, out] for one
    axis, in f32 as JAX reckons it: a triangle kernel widened by the scale
    when the axis shrinks (antialiasing) and not when it grows, each column
    normalised, samples outside the input zeroed."""
    inv_scale = np.float32(1.0 / (out_size / in_size))
    kernel_scale = max(inv_scale, np.float32(1.0))
    sample_f = (np.arange(out_size, dtype=np.float32) + np.float32(0.5)) * inv_scale - np.float32(0.5)
    x = np.abs(sample_f[None, :] - np.arange(in_size, dtype=np.float32)[:, None]) / kernel_scale
    w = np.maximum(np.float32(0.0), np.float32(1.0) - np.abs(x))
    total = w.sum(axis=0, keepdims=True)
    w = np.where(np.abs(total) > 1000.0 * float(np.finfo(np.float32).eps),
                 w / np.where(total != 0, total, 1), 0).astype(np.float32)
    inside = (sample_f >= -0.5) & (sample_f <= in_size - 0.5)
    return np.where(inside[None, :], w, 0).astype(np.float32)


def resize_linear(img: torch.Tensor, height: int, width: int) -> torch.Tensor:
    """[H, W, C] float → [height, width, C] as ``jax.image.resize(img,
    (height, width, C), "linear")`` gives it: antialiased when an axis
    shrinks, plain bilinear when it grows (``F.interpolate`` differs)."""
    h, w = img.shape[:2]
    out = img
    if h != height:
        wy = torch.as_tensor(_linear_weights(h, height), device=img.device, dtype=img.dtype)
        out = torch.einsum("hwc,ho->owc", out, wy)
    if w != width:
        wx = torch.as_tensor(_linear_weights(w, width), device=img.device, dtype=img.dtype)
        out = torch.einsum("hwc,wp->hpc", out, wx)
    return out


def blend_face(frame: torch.Tensor, face: torch.Tensor, bbox: Tuple[int, int, int, int], *,
               feather: int = 16, jaw_only: bool = True) -> torch.Tensor:
    """Feathered compositing of a re-rendered face [S, S, 3] into a frame
    [H, W, 3] in [-1, 1] at ``bbox`` (y0, x0, y1, x1): jaw-mode blending.
    The pipeline composites on the host (``blend_face_np``)."""
    y0, x0, y1, x1 = bbox
    h, w = y1 - y0, x1 - x0
    face_resized = resize_linear(face, h, w)
    yy = np.arange(h)[:, None].astype(np.float32)
    xx = np.arange(w)[None, :].astype(np.float32)
    edge = np.minimum(np.minimum(yy + 1, h - yy), np.minimum(xx + 1, w - xx)) / max(feather, 1)
    alpha = np.clip(edge, 0.0, 1.0)
    if jaw_only:
        alpha = alpha * np.clip((yy - h * 0.45) / (h * 0.1), 0.0, 1.0)
    a = torch.as_tensor(alpha, device=frame.device, dtype=frame.dtype)[..., None]
    out = frame.clone()
    out[y0:y1, x0:x1] = frame[y0:y1, x0:x1] * (1 - a) + face_resized * a
    return out
