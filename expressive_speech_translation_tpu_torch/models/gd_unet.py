"""guided-diffusion UNet (the TFG talking-face variant) for diff2lip.

The port of the JAX package's ``models/gd_unet.py``: the multi-resolution
UNetModel with scale-shift GroupNorm ResBlocks, spatial self-attention at
the configured downsample factors and conv up/downsampling, wrapped as
TFGModel — a 9-channel input (the masked noisy sample ⊕ the conditioning
crop ⊕ a reference frame) and the audio-as-style encoder, whose pooled
embedding is added to the timestep embedding.

- :func:`_plan` / :func:`_audio_plan` are the static block descriptors that
  the init, the forward and the converter all walk, so they cannot drift.
- Activations are NCHW; conv kernels are torch's OIHW (the audio input conv
  ``[out, in, k]``), dense kernels ``[in, out]``. :func:`from_jax_params`
  carries the JAX package's NHWC/HWIO tree across; :func:`from_tfg_state_dict`
  reads diff2lip's pickled TFGModel checkpoints (``module.``-prefixed or
  not), de-interleaving the legacy head-major qkv into per-head q/k/v.
- GroupNorm keeps f32 statistics (eps 1e-5) and casts back; the attention's
  logits are scaled and soft-maxed in f32 (JAX promotes the bf16 logits met
  by a numpy scalar to f32), then cast back. A bf16 tree runs its
  convolutions and products in bf16; the timestep embedding stays f32.

JAX runs these convolutions, norms and attentions outside any Pallas
kernel, and so does the port: ``F.conv2d``, ``torch.matmul`` and softmax.
"""

from __future__ import annotations

import dataclasses
import math
from typing import Any, Dict, List, Optional, Tuple

import torch
import torch.nn.functional as F

from ..core.device import resolve_device
from .common import Init, Params, cast_floats, dense, state_tensor, tree_from_numpy
from .diffusion import timestep_embedding


@dataclasses.dataclass(frozen=True)
class GDUNetConfig:
    image_size: int = 128
    in_channels: int = 9          # TFG use_ref nrefer=1: 3·(noisy⊕cond⊕ref)
    model_channels: int = 128
    out_channels: int = 3
    num_res_blocks: int = 2
    attention_ds: Tuple[int, ...] = (8, 16)   # attention_resolutions "16,8" @128
    channel_mult: Tuple[int, ...] = (1, 1, 2, 3, 4)   # script_util.py @128
    num_heads: int = 4
    use_scale_shift_norm: bool = True
    norm_groups: int = 32
    # TFG audio-as-style encoder (unet.py:1108-1127)
    use_audio: bool = True
    audio_dim: int = 80
    audio_frames: int = 16
    audio_model_channels: int = 32
    audio_channel_mult: Tuple[int, ...] = (1, 2, 3, 4)
    audio_init_spatial: int = 64

    @property
    def time_embed_dim(self) -> int:
        return 4 * self.model_channels


# ------------------------------------------------------------------ block plan


def _plan(cfg: GDUNetConfig):
    """Static block descriptors mirroring UNetModel's ModuleList construction
    (input blocks, the middle block's channels, output blocks)."""
    mc, mults, nres = cfg.model_channels, cfg.channel_mult, cfg.num_res_blocks
    inputs: List[Dict[str, Any]] = [{"kind": "conv", "in": cfg.in_channels,
                                     "out": mults[0] * mc}]
    ch = mults[0] * mc
    chans = [ch]
    ds = 1
    for level, mult in enumerate(mults):
        for _ in range(nres):
            inputs.append({"kind": "res", "in": ch, "out": mult * mc,
                           "attn": ds in cfg.attention_ds})
            ch = mult * mc
            chans.append(ch)
        if level != len(mults) - 1:
            inputs.append({"kind": "down", "in": ch, "out": ch})
            chans.append(ch)
            ds *= 2
    middle = {"ch": ch}
    outputs: List[Dict[str, Any]] = []
    for level, mult in reversed(list(enumerate(mults))):
        for i in range(nres + 1):
            ich = chans.pop()
            outputs.append({
                "kind": "res", "in": ch + ich, "out": mult * mc,
                "attn": ds in cfg.attention_ds,
                "up": bool(level) and i == nres,
            })
            ch = mult * mc
            if outputs[-1]["up"]:
                ds //= 2
    return inputs, middle, outputs


def _audio_plan(cfg: GDUNetConfig):
    """TFGAudioEncoder's encoder_blocks descriptors: two ResBlocks a level,
    a down conv between levels, stride (2, 1) while the spectral axis is
    taller than the window (it is NCHW's H: [B, 1, 64, T])."""
    mc, mults = cfg.audio_model_channels, cfg.audio_channel_mult
    blocks: List[Dict[str, Any]] = [{"kind": "conv", "in": 1, "out": mults[0] * mc}]
    ch = mults[0] * mc
    ds = 1
    for level, mult in enumerate(mults):
        for _ in range(2):   # num_res_blocks=2 fixed (unet.py:1116)
            blocks.append({"kind": "res", "in": ch, "out": mult * mc})
            ch = mult * mc
        if level != len(mults) - 1:
            stride = (2, 1) if (cfg.audio_init_spatial // ds) > cfg.audio_frames else (2, 2)
            blocks.append({"kind": "down", "in": ch, "out": ch, "stride": stride})
            ds *= 2
    out_ch = mc * mults[-1]
    return blocks, ch, out_ch


# ------------------------------------------------------------------------ init


def _init_conv(r: Init, width: int, in_ch: int, out_ch: int, *, ndim: int = 2) -> Params:
    return {"kernel": r.uniform((out_ch, in_ch) + (width,) * ndim,
                                1.0 / math.sqrt(in_ch * width**ndim)),
            "bias": r.zeros((out_ch,))}


def _init_gn(r: Init, ch: int) -> Params:
    return {"scale": r.ones((ch,)), "bias": r.zeros((ch,))}


def _init_res(r: Init, in_ch: int, out_ch: int, emb_dim: int, *, scale_shift: bool) -> Params:
    p: Params = {"in_norm": _init_gn(r, in_ch), "in_conv": _init_conv(r, 3, in_ch, out_ch),
                 "emb": r.dense(emb_dim, 2 * out_ch if scale_shift else out_ch),
                 "out_norm": _init_gn(r, out_ch), "out_conv": _init_conv(r, 3, out_ch, out_ch)}
    if in_ch != out_ch:
        p["skip"] = _init_conv(r, 1, in_ch, out_ch)
    return p


def _init_attn(r: Init, ch: int) -> Params:
    return {"norm": _init_gn(r, ch), "q": r.dense(ch, ch), "k": r.dense(ch, ch),
            "v": r.dense(ch, ch), "o": r.dense(ch, ch)}


def init_gd_unet(seed: int, cfg: GDUNetConfig, device) -> Params:
    """Seeded random parameters (f32) on ``device``, in JAX's tree layout."""
    r = Init(seed, device)
    te = cfg.time_embed_dim
    inputs, middle, outputs = _plan(cfg)
    sal = cfg.use_scale_shift_norm

    def make(desc):
        if desc["kind"] in ("conv", "down"):
            return {desc["kind"]: _init_conv(r, 3, desc["in"], desc["out"])}
        blk = {"res": _init_res(r, desc["in"], desc["out"], te, scale_shift=sal)}
        if desc.get("attn"):
            blk["attn"] = _init_attn(r, desc["out"])
        if desc.get("up"):
            blk["up"] = _init_conv(r, 3, desc["out"], desc["out"])
        return blk

    ch0 = cfg.channel_mult[0] * cfg.model_channels
    p: Params = {
        "time_embed": {"lin1": r.dense(cfg.model_channels, te), "lin2": r.dense(te, te)},
        "input": [make(d) for d in inputs],
        "middle": {"res1": _init_res(r, middle["ch"], middle["ch"], te, scale_shift=sal),
                   "attn": _init_attn(r, middle["ch"]),
                   "res2": _init_res(r, middle["ch"], middle["ch"], te, scale_shift=sal)},
        "output": [make(d) for d in outputs],
        "out": {"norm": _init_gn(r, ch0), "conv": _init_conv(r, 3, ch0, cfg.out_channels)},
    }
    if cfg.use_audio:
        amc = cfg.audio_model_channels
        blocks, mid_in, out_ch = _audio_plan(cfg)

        def amake(desc):
            if desc["kind"] in ("conv", "down"):
                return {desc["kind"]: _init_conv(r, 3, desc["in"], desc["out"])}
            return {"res": _init_res(r, desc["in"], desc["out"], amc, scale_shift=sal)}

        p["audio"] = {
            "time_embed": {"lin1": r.dense(amc, amc), "lin2": r.dense(amc, amc)},
            "in_conv": _init_conv(r, 3, cfg.audio_dim, cfg.audio_init_spatial, ndim=1),
            "in_norm": _init_gn(r, cfg.audio_init_spatial),
            "blocks": [amake(d) for d in blocks],
            "mid_res": _init_res(r, mid_in, out_ch, amc, scale_shift=sal),
            "style_norm": _init_gn(r, out_ch),
            "style_conv": _init_conv(r, 1, out_ch, te),
        }
    return p


def from_jax_params(tree, device, dtype=torch.float32) -> Params:
    """The JAX package's TFG tree (nested dicts/lists of numpy arrays) → the
    port's: conv kernels HWIO ``[kh, kw, in, out]`` → OIHW, the audio input
    conv's HIO ``[k, in, out]`` → ``[out, in, k]``, dense kernels kept."""
    def permute(node):
        if isinstance(node, dict):
            for k, v in node.items():
                if k == "kernel" and torch.is_tensor(v) and v.ndim in (3, 4):
                    node[k] = v.permute(*((3, 2, 0, 1) if v.ndim == 4 else (2, 1, 0))).contiguous()
                else:
                    permute(v)
        elif isinstance(node, list):
            for v in node:
                permute(v)
        return node

    return permute(tree_from_numpy(tree, device, dtype))


# ---------------------------------------------------------------------- layers


def _conv(p: Params, x: torch.Tensor, *, stride=1) -> torch.Tensor:
    """A 'same' conv in the kernel's dtype, padded symmetrically by (k-1)/2
    on each side, strided or not (guided-diffusion's Downsample: stride 2,
    padding 1 — not the diffusers VAE's asymmetric pad)."""
    k = p["kernel"]
    conv = F.conv1d if k.ndim == 3 else F.conv2d
    return conv(x.to(k.dtype), k, p["bias"], stride=stride, padding=(k.shape[-1] - 1) // 2)


def _gn(p: Params, x: torch.Tensor, groups: int) -> torch.Tensor:
    """GroupNorm32: statistics and the affine in f32 (eps 1e-5), cast back."""
    return F.group_norm(x.float(), groups, p["scale"].float(), p["bias"].float(),
                        1e-5).to(x.dtype)


def _upsample2x(x: torch.Tensor) -> torch.Tensor:
    return F.interpolate(x, scale_factor=2.0, mode="nearest")


def _res(p: Params, x: torch.Tensor, emb: torch.Tensor, groups: int, *,
         scale_shift: bool = True) -> torch.Tensor:
    """guided-diffusion ResBlock, use_scale_shift_norm: emb projects to
    2·ch, out_norm(h)·(1 + scale) + shift."""
    h = _conv(p["in_conv"], F.silu(_gn(p["in_norm"], x, groups)))
    emb_out = _dense32(p["emb"], F.silu(emb)).to(h.dtype)[:, :, None, None]
    if scale_shift:
        scale, shift = emb_out.chunk(2, dim=1)
        h = _gn(p["out_norm"], h, groups) * (1 + scale) + shift
        h = _conv(p["out_conv"], F.silu(h))
    else:
        h = _conv(p["out_conv"], F.silu(_gn(p["out_norm"], h + emb_out, groups)))
    return (_conv(p["skip"], x) if "skip" in p else x) + h


def _attn(p: Params, x: torch.Tensor, heads: int, groups: int) -> torch.Tensor:
    """AttentionBlock: spatial self-attention over the h·w positions plus
    the residual (QKVAttentionLegacy's 1/√√d on q and k is 1/√d on the
    logits)."""
    b, c, hh, ww = x.shape
    hd = c // heads
    n = _gn(p["norm"], x, groups).reshape(b, c, hh * ww).transpose(1, 2)

    def split(proj):
        return dense(p[proj], n).reshape(b, hh * ww, heads, hd).transpose(1, 2)

    q, k, v = split("q"), split("k"), split("v")
    logits = (q @ k.transpose(-1, -2)).float() / math.sqrt(hd)
    out = torch.softmax(logits, dim=-1).to(x.dtype) @ v
    out = dense(p["o"], out.transpose(1, 2).reshape(b, hh * ww, c))
    return x + out.transpose(1, 2).reshape(b, c, hh, ww)


def _dense32(p: Params, x: torch.Tensor) -> torch.Tensor:
    """An f32 activation through a dense layer of any dtype, in f32: JAX
    promotes f32 met by a bf16 kernel to f32."""
    return x.float() @ p["kernel"].float() + p["bias"].float()


def _embed_mlp(p: Params, t: torch.Tensor, dim: int) -> torch.Tensor:
    """The sinusoidal embedding of t through a two-layer SiLU MLP, in f32."""
    return _dense32(p["lin2"], F.silu(_dense32(p["lin1"], timestep_embedding(t.float(), dim))))


# --------------------------------------------------------------------- forward


def audio_style_embed(params: Params, cfg: GDUNetConfig, mel: torch.Tensor) -> torch.Tensor:
    """TFGAudioEncoder + audio_encoder_to_style: mel [B, T=audio_frames,
    n_mels] → the style embedding [B, time_embed_dim]."""
    a = params["audio"]
    g = cfg.norm_groups
    b = mel.shape[0]
    # a fixed t=0 embedding through the encoder's own (trained) MLP
    emb = _embed_mlp(a["time_embed"], torch.zeros((b,), device=mel.device),
                     cfg.audio_model_channels)
    h = F.silu(_gn(a["in_norm"], _conv(a["in_conv"], mel.transpose(1, 2)), g))   # [B, 64, T]
    h = h[:, None]                                  # NCHW [B, 1, 64 (spectral), T]
    blocks, _, _ = _audio_plan(cfg)
    for desc, bp in zip(blocks, a["blocks"]):
        if desc["kind"] == "conv":
            h = _conv(bp["conv"], h)
        elif desc["kind"] == "down":
            h = _conv(bp["down"], h, stride=desc["stride"])
        else:
            h = _res(bp["res"], h, emb, g, scale_shift=cfg.use_scale_shift_norm)
    h = _res(a["mid_res"], h, emb, g, scale_shift=cfg.use_scale_shift_norm)
    # the style head: GN → SiLU → global average pool → 1×1 conv → flatten
    h = F.silu(_gn(a["style_norm"], h, g)).mean(dim=(2, 3), keepdim=True)
    return _conv(a["style_conv"], h)[:, :, 0, 0]


def gd_unet_apply(params: Params, cfg: GDUNetConfig, x: torch.Tensor, t: torch.Tensor, *,
                  cond_img: torch.Tensor, mask: torch.Tensor,
                  ref_img: Optional[torch.Tensor] = None,
                  mel: Optional[torch.Tensor] = None) -> torch.Tensor:
    """TFGModel.forward: merge the noisy sample [B, 3, S, S] with the visible
    conditioning region (``mask`` [1, 1, S, 1], 1 where hidden), concatenate
    the channels (⊕ the reference frame), run the UNet on the timestep (+
    audio-style, when ``mel`` is given) embedding → [B, out_channels, S, S]
    in the tree's dtype."""
    g = cfg.norm_groups
    sal = cfg.use_scale_shift_norm
    x = x * mask + (1.0 - mask) * cond_img
    h = torch.cat([x, cond_img] + ([ref_img] if ref_img is not None else []), dim=1)

    emb = _embed_mlp(params["time_embed"], t, cfg.model_channels)
    if cfg.use_audio and mel is not None:
        emb = emb + audio_style_embed(params, cfg, mel).float()

    inputs, _, outputs = _plan(cfg)
    skips: List[torch.Tensor] = []
    for desc, bp in zip(inputs, params["input"]):
        if desc["kind"] == "conv":
            h = _conv(bp["conv"], h)
        elif desc["kind"] == "down":
            h = _conv(bp["down"], h, stride=2)
        else:
            h = _res(bp["res"], h, emb, g, scale_shift=sal)
            if "attn" in bp:
                h = _attn(bp["attn"], h, cfg.num_heads, g)
        skips.append(h)

    mid = params["middle"]
    h = _res(mid["res1"], h, emb, g, scale_shift=sal)
    h = _attn(mid["attn"], h, cfg.num_heads, g)
    h = _res(mid["res2"], h, emb, g, scale_shift=sal)

    for bp in params["output"]:
        h = _res(bp["res"], torch.cat([h, skips.pop()], dim=1), emb, g, scale_shift=sal)
        if "attn" in bp:
            h = _attn(bp["attn"], h, cfg.num_heads, g)
        if "up" in bp:
            h = _conv(bp["up"], _upsample2x(h))
    return _conv(params["out"]["conv"], F.silu(_gn(params["out"]["norm"], h, g)))


# ------------------------------------------------------------------ converter


def _conv_p(sd, prefix, dev) -> Params:
    return {"kernel": state_tensor(sd[f"{prefix}.weight"], dev),
            "bias": state_tensor(sd[f"{prefix}.bias"], dev)}


def _lin_p(sd, prefix, dev) -> Params:
    return {"kernel": state_tensor(sd[f"{prefix}.weight"], dev).T.contiguous(),
            "bias": state_tensor(sd[f"{prefix}.bias"], dev)}


def _gn_p(sd, prefix, dev) -> Params:
    return {"scale": state_tensor(sd[f"{prefix}.weight"], dev),
            "bias": state_tensor(sd[f"{prefix}.bias"], dev)}


def _res_p(sd, prefix, dev) -> Params:
    p = {"in_norm": _gn_p(sd, f"{prefix}.in_layers.0", dev),
         "in_conv": _conv_p(sd, f"{prefix}.in_layers.2", dev),
         "emb": _lin_p(sd, f"{prefix}.emb_layers.1", dev),
         "out_norm": _gn_p(sd, f"{prefix}.out_layers.0", dev),
         "out_conv": _conv_p(sd, f"{prefix}.out_layers.3", dev)}
    if f"{prefix}.skip_connection.weight" in sd:
        p["skip"] = _conv_p(sd, f"{prefix}.skip_connection", dev)
    return p


def _attn_p(sd, prefix, heads, dev) -> Params:
    """De-interleave the legacy head-major qkv 1×1 conv ([3C, C, 1] ordered
    [h0: q|k|v, h1: q|k|v, …]) into per-head q / k / v dense layers."""
    w = state_tensor(sd[f"{prefix}.qkv.weight"], dev)[:, :, 0]     # [3C, C]
    b = state_tensor(sd[f"{prefix}.qkv.bias"], dev)
    c = w.shape[1]
    w = w.reshape(heads, 3, c // heads, c)
    b = b.reshape(heads, 3, c // heads)

    def part(i):
        return {"kernel": w[:, i].reshape(c, c).T.contiguous(),
                "bias": b[:, i].reshape(c).contiguous()}

    proj = state_tensor(sd[f"{prefix}.proj_out.weight"], dev)[:, :, 0]
    return {"norm": _gn_p(sd, f"{prefix}.norm", dev), "q": part(0), "k": part(1), "v": part(2),
            "o": {"kernel": proj.T.contiguous(),
                  "bias": state_tensor(sd[f"{prefix}.proj_out.bias"], dev)}}


def from_tfg_state_dict(sd: Dict[str, Any], cfg: GDUNetConfig, device=None,
                        dtype=torch.float32) -> Params:
    """diff2lip's TFGModel state dict (torch, ``module.``-prefixed when DDP
    saved it) → the tree on ``device``, floating leaves in ``dtype``; the
    layout follows the same :func:`_plan` the forward walks. A checkpoint
    without an audio encoder gives a tree without ``audio``."""
    dev = resolve_device(device)
    sd = {k.removeprefix("module."): v for k, v in sd.items()}
    inputs, _, outputs = _plan(cfg)

    def block(prefix, desc):
        if desc["kind"] == "conv":
            return {"conv": _conv_p(sd, f"{prefix}.0", dev)}
        if desc["kind"] == "down":
            return {"down": _conv_p(sd, f"{prefix}.0.op", dev)}
        blk = {"res": _res_p(sd, f"{prefix}.0", dev)}
        j = 1
        if desc.get("attn"):
            blk["attn"] = _attn_p(sd, f"{prefix}.{j}", cfg.num_heads, dev)
            j += 1
        if desc.get("up"):
            blk["up"] = _conv_p(sd, f"{prefix}.{j}.conv", dev)
        return blk

    p: Params = {
        "time_embed": {"lin1": _lin_p(sd, "time_embed.0", dev),
                       "lin2": _lin_p(sd, "time_embed.2", dev)},
        "input": [block(f"input_blocks.{i}", d) for i, d in enumerate(inputs)],
        "middle": {"res1": _res_p(sd, "middle_block.0", dev),
                   "attn": _attn_p(sd, "middle_block.1", cfg.num_heads, dev),
                   "res2": _res_p(sd, "middle_block.2", dev)},
        "output": [block(f"output_blocks.{i}", d) for i, d in enumerate(outputs)],
        "out": {"norm": _gn_p(sd, "out.0", dev), "conv": _conv_p(sd, "out.2", dev)},
    }
    if cfg.use_audio and "audio_encoder.input_block.0.weight" in sd:
        blocks, _, _ = _audio_plan(cfg)
        p["audio"] = {
            "time_embed": {"lin1": _lin_p(sd, "audio_encoder.time_embed.0", dev),
                           "lin2": _lin_p(sd, "audio_encoder.time_embed.2", dev)},
            "in_conv": _conv_p(sd, "audio_encoder.input_block.0", dev),
            "in_norm": _gn_p(sd, "audio_encoder.input_block.1", dev),
            "blocks": [block(f"audio_encoder.encoder_blocks.{i}", d) for i, d in enumerate(blocks)],
            "mid_res": _res_p(sd, "audio_encoder.middle_block.0", dev),
            "style_norm": _gn_p(sd, "audio_encoder_to_style.0", dev),
            "style_conv": _conv_p(sd, "audio_encoder_to_style.3", dev),
        }
    return cast_floats(p, dtype)
