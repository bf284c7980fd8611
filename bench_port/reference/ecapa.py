"""ECAPA-TDNN speaker embeddings in plain PyTorch: a frozen copy of the
port's ``models/ecapa.py``, for the voice prompt the reference works out
again."""

from __future__ import annotations

import dataclasses

import torch
import torch.nn.functional as F

from .mel import kaldi_fbank
from .common import Init, Params


@dataclasses.dataclass(frozen=True)
class EcapaConfig:
    n_mels: int = 80
    channels: int = 1024       # spkrec-ecapa-voxceleb: [1024]×4
    mfa_out: int = 3072        # channels[-1]
    bottleneck: int = 128      # SE bottleneck (se_channels)
    scale: int = 8             # Res2Net scale
    embed_dim: int = 192
    attn_channels: int = 128


DILATIONS = (2, 3, 4)


def _init_conv(r: Init, width: int, in_ch: int, out_ch: int) -> Params:
    return {"kernel": r.uniform((out_ch, in_ch, width), 1.0 / (in_ch * width) ** 0.5),
            "bias": r.zeros((out_ch,))}


def _init_bn(r: Init, ch: int) -> Params:
    return {"scale": r.ones((ch,)), "bias": r.zeros((ch,)),
            "mean": r.zeros((ch,)), "var": r.ones((ch,))}


def _init_tdnn(r: Init, width: int, in_ch: int, out_ch: int) -> Params:
    return {"conv": _init_conv(r, width, in_ch, out_ch), "bn": _init_bn(r, out_ch)}


def init_ecapa(seed: int, cfg: EcapaConfig, device) -> Params:
    """Seeded random parameters (f32) on ``device``."""
    r = Init(seed, device)
    c = cfg.channels
    width = c // cfg.scale
    blocks = [{"tdnn1": _init_tdnn(r, 1, c, c),
               "res2": [_init_tdnn(r, 3, width, width) for _ in range(cfg.scale - 1)],
               "tdnn2": _init_tdnn(r, 1, c, c),
               "se_conv1": _init_conv(r, 1, c, cfg.bottleneck),
               "se_conv2": _init_conv(r, 1, cfg.bottleneck, c)} for _ in DILATIONS]
    return {"block0": _init_tdnn(r, 5, cfg.n_mels, c),
            "blocks": blocks,
            "mfa": _init_tdnn(r, 1, 3 * c, cfg.mfa_out),
            "asp_tdnn": _init_tdnn(r, 1, 3 * cfg.mfa_out, cfg.attn_channels),
            "asp_conv": _init_conv(r, 1, cfg.attn_channels, cfg.mfa_out),
            "asp_bn": _init_bn(r, 2 * cfg.mfa_out),
            "fc": _init_conv(r, 1, 2 * cfg.mfa_out, cfg.embed_dim)}


# ---------------------------------------------------------------------- layers


def _conv1d(p: Params, x: torch.Tensor, *, dilation: int = 1) -> torch.Tensor:
    """'same' conv over [B, C, T] in the kernel's dtype."""
    w = p["kernel"]
    pad = dilation * (w.shape[-1] - 1) // 2
    return F.conv1d(x.to(w.dtype), w, p["bias"], padding=pad, dilation=dilation)


def _bn(p: Params, x: torch.Tensor) -> torch.Tensor:
    """BatchNorm1d at inference on [B, C, ...] (running statistics, eps 1e-5)."""
    shape = (-1,) + (1,) * (x.ndim - 2)
    return (((x - p["mean"].view(shape)) * torch.rsqrt(p["var"].view(shape) + 1e-5))
            * p["scale"].view(shape) + p["bias"].view(shape))


def _tdnn(p: Params, x: torch.Tensor, mask: torch.Tensor, *, dilation: int = 1) -> torch.Tensor:
    """TDNNBlock: conv → ReLU → BN, padded frames re-zeroed (mask [B, 1, T])."""
    return _bn(p["bn"], torch.relu(_conv1d(p["conv"], x, dilation=dilation))) * mask


def _masked_time_mean(x: torch.Tensor, mask: torch.Tensor) -> torch.Tensor:
    denom = torch.clamp_min(mask.sum(dim=2, keepdim=True), 1.0)
    return (x * mask).sum(dim=2, keepdim=True) / denom


def _se_res2_block(p: Params, cfg: EcapaConfig, x: torch.Tensor, mask: torch.Tensor,
                   dilation: int) -> torch.Tensor:
    """SERes2NetBlock: tdnn1 → Res2Net → tdnn2 → SE → + residual. Group 0
    passes through, group 1 convolves its split, groups ≥ 2 convolve their
    split plus the previous group's output."""
    h = _tdnn(p["tdnn1"], x, mask)
    splits = torch.chunk(h, cfg.scale, dim=1)
    outs = [splits[0]]
    prev = None
    for i in range(1, cfg.scale):
        inp = splits[i] if prev is None else splits[i] + prev
        prev = _tdnn(p["res2"][i - 1], inp, mask, dilation=dilation)
        outs.append(prev)
    h = _tdnn(p["tdnn2"], torch.cat(outs, dim=1), mask)
    s = _masked_time_mean(h, mask)
    s = torch.sigmoid(_conv1d(p["se_conv2"], torch.relu(_conv1d(p["se_conv1"], s))))
    return h * s + x


def embed(params: Params, cfg: EcapaConfig, feats: torch.Tensor, mask: torch.Tensor, *,
          normalize: bool = True) -> torch.Tensor:
    """feats [B, T, n_mels] + mask [B, T] → embeddings [B, embed_dim]
    (L2-normalised unless ``normalize=False``)."""
    m = mask.to(feats.dtype)[:, None, :]                      # [B, 1, T]
    x = _tdnn(params["block0"], feats.transpose(1, 2) * m, m)
    per_block = []
    for block, dilation in zip(params["blocks"], DILATIONS):
        x = _se_res2_block(block, cfg, x, m, dilation)
        per_block.append(x)
    h = _tdnn(params["mfa"], torch.cat(per_block, dim=1), m)

    # attentive statistics pooling with the global context (x ⊕ μ ⊕ σ)
    w_uniform = m / torch.clamp_min(m.sum(dim=2, keepdim=True), 1.0)
    mu = (h * w_uniform).sum(dim=2, keepdim=True)
    sg = torch.sqrt(torch.clamp_min(((h - mu) ** 2 * w_uniform).sum(dim=2, keepdim=True), 1e-12))
    ctx = torch.cat([h, mu.expand_as(h), sg.expand_as(h)], dim=1)
    attn = _conv1d(params["asp_conv"], torch.tanh(_tdnn(params["asp_tdnn"], ctx, m)))
    attn = torch.where(m > 0, attn, float("-inf"))
    w = torch.softmax(attn, dim=2)
    mean = (w * h).sum(dim=2)
    std = torch.sqrt(torch.clamp_min((w * (h - mean[..., None]) ** 2).sum(dim=2), 1e-12))
    pooled = _bn(params["asp_bn"], torch.cat([mean, std], dim=1))
    e = _conv1d(params["fc"], pooled[..., None])[..., 0]
    if normalize:
        e = e / torch.linalg.vector_norm(e, dim=-1, keepdim=True)
    return e


def cosine_similarity(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """Cosine score in [-1, 1] over the last axis."""
    a = a / torch.linalg.vector_norm(a, dim=-1, keepdim=True)
    b = b / torch.linalg.vector_norm(b, dim=-1, keepdim=True)
    return (a * b).sum(dim=-1)


def embed_audio(params: Params, cfg: EcapaConfig, audio_16k: torch.Tensor) -> torch.Tensor:
    """[T] or [B, T] 16 kHz waveform → embeddings (fbank frontend included)."""
    if audio_16k.ndim == 1:
        audio_16k = audio_16k[None]
    feats = kaldi_fbank(audio_16k, sr=16_000, frame_length_ms=25.0, frame_shift_ms=10.0,
                        n_mels=cfg.n_mels)
    # per-utterance mean normalisation (speechbrain InputNormalization)
    feats = feats - feats.mean(dim=1, keepdim=True)
    mask = torch.ones(feats.shape[:2], dtype=torch.bool, device=feats.device)
    return embed(params, cfg, feats, mask)
