"""The official CosyVoice2 HiFT vocoder (NSF source + HiFi-GAN + iSTFT head).

The port of the JAX package's ``models/hift.py``, the model of the
pretrained ``hift.pt`` (``HiFTGenerator``):

- ``ConvRNNF0Predictor``: five convs with ELU → per-frame |f0|;
- ``SourceModuleHnNSF``: a harmonic sine source at the sample rate, its
  phase integrated by a cumulative sum, merged by a linear layer and tanh;
- a HiFi-GAN trunk with Snake activations, upsample rates (8, 5, 3) and an
  iSTFT head (n_fft 16, hop 4): the last conv gives 9 log-magnitudes and 9
  phases a frame and a small inverse STFT makes the waveform (hop
  8·5·3·4 = 480 samples a mel frame at 24 kHz);
- the source fused in at every scale through strided convs of its STFT.

Its convs run as ``F.conv1d`` / ``F.conv_transpose1d``: the JAX package runs
them as ``lax.conv`` outside any Pallas kernel. The resblocks are
Snake-activated, so the port's resblock kernel (the leaky-ReLU HiFi-GAN
stage) computes another function and is not used here.

One divergence from the JAX package, on purpose: :func:`harmonic_source`
integrates the phase in f32 whatever the serving dtype. The JAX package runs
it in the parameters' dtype, and in bf16 the running sum keeps no fraction
past 128 cycles, which freezes the harmonic excitation after the first
second of speech. In f32 the computation is the JAX package's.

Layouts: the trunk works on [B, C, T]; conv kernels are torch's
[out, in, width], the ``ups`` conv-transpose kernels [in, out, width], dense
kernels [in, out]. :func:`from_hift_state_dict` folds weight-norm pairs.
"""

from __future__ import annotations

import dataclasses
import math
from typing import Any, Dict, Optional, Tuple

import numpy as np
import torch
import torch.nn.functional as F

from ..core.device import resolve_device
from .common import (Init, Params, linear_from_state, permute_conv_kernels, promoted,
                     state_tensor, tree_from_numpy)


@dataclasses.dataclass(frozen=True)
class HiFTConfig:
    in_channels: int = 80
    base_channels: int = 512
    nb_harmonics: int = 8
    sampling_rate: int = 24_000
    nsf_alpha: float = 0.1          # sine amplitude
    nsf_sigma: float = 0.003        # voiced noise std
    nsf_voiced_threshold: float = 10.0
    upsample_rates: Tuple[int, ...] = (8, 5, 3)
    upsample_kernels: Tuple[int, ...] = (16, 11, 7)
    istft_n_fft: int = 16
    istft_hop: int = 4
    resblock_kernels: Tuple[int, ...] = (3, 7, 11)
    resblock_dilations: Tuple[Tuple[int, ...], ...] = ((1, 3, 5),) * 3
    source_resblock_kernels: Tuple[int, ...] = (7, 7, 11)
    source_resblock_dilations: Tuple[Tuple[int, ...], ...] = ((1, 3, 5),) * 3
    lrelu_slope: float = 0.1
    audio_limit: float = 0.99
    f0_cond_channels: int = 512

    @property
    def hop(self) -> int:
        out = self.istft_hop
        for r in self.upsample_rates:
            out *= r
        return out

    @property
    def n_spec(self) -> int:
        return self.istft_n_fft // 2 + 1

    @classmethod
    def tiny(cls) -> "HiFTConfig":
        return cls(in_channels=8, base_channels=32, nb_harmonics=2, f0_cond_channels=16)


# ================================================================ primitives


def _conv1d(p: Params, x: torch.Tensor, *, stride: int = 1, dilation: int = 1,
            pad: Optional[Tuple[int, int]] = None) -> torch.Tensor:
    """Conv over [B, C, T]; ``pad`` (left, right), by default torch's "same"
    dilation·(width − 1)//2 each side; x is cast to the kernel's dtype."""
    k = p["kernel"]
    if pad is None:
        d = dilation * (k.shape[-1] - 1) // 2
        pad = (d, d)
    return F.conv1d(F.pad(x.to(k.dtype), pad), k, p["bias"], stride=stride, dilation=dilation)


def _conv_transpose1d(p: Params, x: torch.Tensor, stride: int) -> torch.Tensor:
    """torch ConvTranspose1d(stride=s, padding=(k−s)//2): out = in × s for an
    even k − s (every official HiFT geometry: (16, 8), (11, 5), (7, 3)). An
    odd k − s would give in × s + 1 samples and shift the waveform against
    the source STFT, so it is refused, as the JAX package refuses it."""
    k = p["kernel"]
    width = k.shape[-1]
    if (width - stride) % 2:
        raise NotImplementedError(f"ConvTranspose1d parity requires even kernel-stride, got "
                                  f"k={width} s={stride}")
    return F.conv_transpose1d(x.to(k.dtype), k, p["bias"], stride=stride,
                              padding=(width - stride) // 2)


def _snake(x: torch.Tensor, alpha: torch.Tensor) -> torch.Tensor:
    """Snake x + sin²(αx)/α, alpha [C] per channel of x [B, C, T]."""
    a = alpha[None, :, None]
    return x + torch.sin(a * x) ** 2 / (a + 1e-9)


# ============================================================ STFT (16-point)


def _hann(n_fft: int) -> np.ndarray:
    return np.hanning(n_fft + 1)[:-1].astype(np.float32)   # periodic


def stft_small(x: torch.Tensor, n_fft: int, hop: int) -> Tuple[torch.Tensor, torch.Tensor]:
    """torch.stft(center=True, pad_mode='reflect', Hann) for a small n_fft as
    framed products with the windowed DFT bases. x [B, T] → (real, imag),
    each [B, frames, n_fft//2 + 1], in f32 (or wider)."""
    window = _hann(n_fft)
    n = np.arange(n_fft)[:, None]
    ang = 2.0 * np.pi * n * np.arange(n_fft // 2 + 1)[None, :] / n_fft
    pad = n_fft // 2
    xp = F.pad(x[:, None, :], (pad, pad), mode="reflect")[:, 0]
    frames = 1 + (xp.shape[1] - n_fft) // hop
    idx = torch.from_numpy(np.arange(frames)[:, None] * hop + np.arange(n_fft)[None, :])
    fr = xp[:, idx.to(x.device)]                            # [B, F, n_fft]

    def basis(b):
        return torch.from_numpy(b.astype(np.float32)).to(x.device)

    fr, cb, sb = promoted(fr, basis(np.cos(ang) * window[:, None]),
                          basis(-np.sin(ang) * window[:, None]))
    return fr @ cb, fr @ sb


def istft_small(real: torch.Tensor, imag: torch.Tensor, n_fft: int, hop: int) -> torch.Tensor:
    """torch.istft(center=True, Hann): [B, F, n_fft//2 + 1] → [B, (F−1)·hop],
    the overlap-add normalised by the summed squared window."""
    window = _hann(n_fft)
    b, f, n_bins = real.shape
    dev = real.device
    k = np.arange(n_bins)
    weight = np.where((k == 0) | (k == n_fft // 2), 1.0, 2.0)     # the hermitian fold
    ang = 2.0 * np.pi * np.arange(n_fft)[:, None] * k[None, :] / n_fft
    icos = torch.from_numpy((np.cos(ang) * weight[None, :] / n_fft).T.astype(np.float32))
    isin = torch.from_numpy((np.sin(ang) * weight[None, :] / n_fft).T.astype(np.float32))
    re, ic = promoted(real, icos.to(dev))
    im, is_ = promoted(imag, isin.to(dev))
    frames = (re @ ic - im @ is_) * torch.from_numpy(window).to(dev)[None, None, :]

    total = (f - 1) * hop + n_fft
    idx = (np.arange(f)[:, None] * hop + np.arange(n_fft)[None, :]).reshape(-1)
    acc = torch.zeros((b, total), dtype=frames.dtype, device=dev)
    acc.index_add_(1, torch.from_numpy(idx).to(dev), frames.reshape(b, -1))
    wsq = np.zeros(total, np.float32)
    np.add.at(wsq, idx, np.tile(window ** 2, f))
    out = acc / torch.from_numpy(np.maximum(wsq, 1e-9)).to(dev)
    pad = n_fft // 2
    return out[:, pad: total - pad]


# ============================================================== init / apply


def _source_down_widths(cfg: HiFTConfig):
    """The source STFT's stride into each stage: the cumulative product of
    the later stages' rates (e.g. 15, 3, 1)."""
    rates = (1,) + tuple(reversed(cfg.upsample_rates))[:-1]
    return [int(u) for u in np.cumprod(rates)[::-1]]


def init_hift(r: Init, cfg: HiFTConfig) -> Params:
    """Seeded random parameters in the port's layouts (the JAX init's shapes
    and scales; its numbers differ)."""
    def conv(width, in_ch, out_ch):
        return {"kernel": r.uniform((out_ch, in_ch, width), 1.0 / math.sqrt(in_ch * width)),
                "bias": r.zeros((out_ch,))}

    def resblock(channels, kernel, dilations):
        return {"convs1": [conv(kernel, channels, channels) for _ in dilations],
                "convs2": [conv(kernel, channels, channels) for _ in dilations],
                "alphas1": [r.ones((channels,)) for _ in dilations],
                "alphas2": [r.ones((channels,)) for _ in dilations]}

    ch, fc = cfg.base_channels, cfg.f0_cond_channels
    n_spec2 = cfg.istft_n_fft + 2
    params: Params = {
        "f0_predictor": {
            "condnet": [conv(3, cfg.in_channels, fc)] + [conv(3, fc, fc) for _ in range(4)],
            "classifier": {"kernel": r.normal((fc, 1), 0.02), "bias": r.zeros((1,))}},
        "m_source": {"l_linear": {"kernel": r.normal((cfg.nb_harmonics + 1, 1), 0.2),
                                  "bias": r.zeros((1,))}},
        "conv_pre": conv(7, cfg.in_channels, ch),
        "ups": [], "source_downs": [], "source_resblocks": [], "resblocks": [],
    }
    for i, (kw, u) in enumerate(zip(cfg.upsample_kernels, _source_down_widths(cfg))):
        in_ch, out_ch = ch // (2 ** i), ch // (2 ** (i + 1))
        params["ups"].append({"kernel": r.uniform((in_ch, out_ch, kw),
                                                  1.0 / math.sqrt(in_ch * kw)),
                              "bias": r.zeros((out_ch,))})
        params["source_downs"].append(conv(1 if u == 1 else u * 2, n_spec2, out_ch))
        params["source_resblocks"].append(resblock(out_ch, cfg.source_resblock_kernels[i],
                                                   cfg.source_resblock_dilations[i]))
        params["resblocks"] += [resblock(out_ch, k, d)
                                for k, d in zip(cfg.resblock_kernels, cfg.resblock_dilations)]
    params["conv_post"] = conv(7, ch // (2 ** len(cfg.upsample_rates)), n_spec2)
    return params


def from_jax_params(tree, device, dtype=torch.float32) -> Params:
    """The JAX package's HiFT tree → the port's: conv kernels [width, in, out]
    → [out, in, width], the ``ups`` kernels → [in, out, width] (the layout
    torch's ConvTranspose1d stores); dense kernels and alphas as they are."""
    p = permute_conv_kernels(tree_from_numpy(tree, device, dtype), (2, 1, 0))
    for up in p["ups"]:
        up["kernel"] = up["kernel"].transpose(0, 1).contiguous()
    return p


def _resblock(p: Params, x: torch.Tensor, dilations) -> torch.Tensor:
    for j, d in enumerate(dilations):
        xt = _conv1d(p["convs1"][j], _snake(x, p["alphas1"][j]), dilation=d)
        xt = _conv1d(p["convs2"][j], _snake(xt, p["alphas2"][j]))
        x = x + xt
    return x


def f0_predict(params: Params, cfg: HiFTConfig, mel: torch.Tensor) -> torch.Tensor:
    """ConvRNNF0Predictor: mel [B, T, n_mels] → |f0| [B, T] in Hz."""
    h = mel.transpose(1, 2)
    for conv in params["f0_predictor"]["condnet"]:
        h = F.elu(_conv1d(conv, h))
    cl = params["f0_predictor"]["classifier"]
    return torch.abs((h.transpose(1, 2) @ cl["kernel"] + cl["bias"])[..., 0])


def harmonic_source(params: Params, cfg: HiFTConfig, noise, f0_frame: torch.Tensor, *,
                    deterministic: bool = False) -> torch.Tensor:
    """SourceModuleHnNSF: per-frame f0 [B, T] → the excitation [B, T·hop, 1]
    at the sample rate, in f0's dtype.

    f0 is repeated ×hop, the harmonics n·f0 are phase-integrated by a
    cumulative sum, gated voiced / unvoiced and merged by linear + tanh. The
    random phases (uniform in [−π, π), the fundamental's set to 0) and the
    additive noise come from ``noise.hift_source``; ``deterministic`` zeroes
    both. The whole source runs in f32 (see the module's note on bf16)."""
    b, _ = f0_frame.shape
    n_h = cfg.nb_harmonics + 1
    f0 = torch.repeat_interleave(f0_frame.float(), cfg.hop, dim=1)          # [B, T·hop]
    mult = torch.arange(1, n_h + 1, dtype=torch.float32, device=f0.device)
    f_mat = f0[:, None, :] * mult[None, :, None] / cfg.sampling_rate
    theta = 2.0 * np.pi * (torch.cumsum(f_mat, dim=-1) % 1.0)
    if deterministic:
        phase = torch.zeros((b, n_h, 1), device=f0.device)
        rnd = torch.zeros_like(theta)
    else:
        phase, rnd = noise.hift_source((b, n_h, 1), tuple(theta.shape))
        phase, rnd = phase.to(f0.device).float().clone(), rnd.to(f0.device).float()
        phase[:, 0, :] = 0.0
    sines = cfg.nsf_alpha * torch.sin(theta + phase)
    uv = (f0 > cfg.nsf_voiced_threshold).float()[:, None, :]
    noise_amp = uv * cfg.nsf_sigma + (1.0 - uv) * cfg.nsf_alpha / 3.0
    sines = sines * uv + noise_amp * rnd                                    # [B, H+1, T·hop]
    lw = params["m_source"]["l_linear"]
    merged = torch.tanh(torch.einsum("bht,ho->bto", sines, lw["kernel"].float())
                        + lw["bias"].float())
    return merged.to(f0_frame.dtype)


def hift_decode(params: Params, cfg: HiFTConfig, mel: torch.Tensor,
                source: torch.Tensor) -> torch.Tensor:
    """HiFTGenerator.decode: mel [B, T, n_mels] and the source [B, T·hop, 1]
    → the waveform [B, T·hop]."""
    sr, si = stft_small(source[..., 0], cfg.istft_n_fft, cfg.istft_hop)
    s_stft = torch.cat([sr, si], dim=-1).transpose(1, 2)                    # [B, 18, F]

    x = _conv1d(params["conv_pre"], mel.transpose(1, 2))
    n_kernels = len(cfg.resblock_kernels)
    n_up = len(cfg.upsample_rates)
    for i, (rate, u) in enumerate(zip(cfg.upsample_rates, _source_down_widths(cfg))):
        x = _conv_transpose1d(params["ups"][i], F.leaky_relu(x, cfg.lrelu_slope), rate)
        if i == n_up - 1:
            x = torch.cat([x[:, :, 1:2], x], dim=2)    # ReflectionPad1d((1, 0))
        if u == 1:
            si_i = _conv1d(params["source_downs"][i], s_stft, pad=(0, 0))
        else:
            si_i = _conv1d(params["source_downs"][i], s_stft, stride=u, pad=(u // 2, u // 2))
        x = x + _resblock(params["source_resblocks"][i], si_i, cfg.source_resblock_dilations[i])
        xs = None
        for j in range(n_kernels):
            y = _resblock(params["resblocks"][i * n_kernels + j], x, cfg.resblock_dilations[j])
            xs = y if xs is None else xs + y
        x = xs / n_kernels
    x = _conv1d(params["conv_post"], F.leaky_relu(x, 0.01)).transpose(1, 2)   # [B, F, 18]
    n_spec = cfg.n_spec
    # the clip's bound is a numpy scalar in the JAX package, which promotes a
    # bf16 trunk's log-magnitudes to f32 here
    log_mag = x[..., :n_spec]
    log_mag = log_mag.to(torch.promote_types(log_mag.dtype, torch.float32))
    magnitude = torch.exp(torch.clamp(log_mag, max=math.log(1e2)))
    phase = torch.sin(x[..., n_spec:])                                       # official: sin(x)
    wave = istft_small(magnitude * torch.cos(phase), magnitude * torch.sin(phase),
                       cfg.istft_n_fft, cfg.istft_hop)
    return torch.clamp(wave, -cfg.audio_limit, cfg.audio_limit)


def hift_inference(params: Params, cfg: HiFTConfig, noise, mel: torch.Tensor, *,
                   deterministic: bool = False,
                   frame_mask: Optional[torch.Tensor] = None) -> torch.Tensor:
    """HiFTGenerator.inference: mel [B, T, n_mels] → waveform [B, T·hop].
    ``frame_mask`` [B, T] marks a padded batch's valid frames: the pad mel,
    its f0 and the pad samples of the waveform are zeroed."""
    if frame_mask is not None:
        mel = mel * frame_mask[..., None].to(mel.dtype)
    f0 = f0_predict(params, cfg, mel)
    if frame_mask is not None:
        f0 = f0 * frame_mask.to(f0.dtype)
    wave = hift_decode(params, cfg, mel,
                       harmonic_source(params, cfg, noise, f0, deterministic=deterministic))
    if frame_mask is not None:
        sample_mask = torch.repeat_interleave(frame_mask, cfg.hop, dim=1)
        wave = wave[:, : sample_mask.shape[1]] * sample_mask.to(wave.dtype)
    return wave


# ================================================================ conversion


def _fold_weight_norm(state, name: str, device) -> torch.Tensor:
    """weight = g · v/‖v‖ (the norm over every axis but 0), as
    ``remove_weight_norm`` folds it; a plain ``weight`` key is taken as it
    is."""
    if f"{name}.weight" in state:
        return state_tensor(state[f"{name}.weight"], device)
    g = state_tensor(state[f"{name}.weight_g"], device)
    v = state_tensor(state[f"{name}.weight_v"], device)
    norm = torch.sqrt((v ** 2).sum(dim=tuple(range(1, v.ndim)), keepdim=True))
    return (g * v / torch.clamp(norm, min=1e-12)).contiguous()


def _conv_from(state, name: str, device) -> Params:
    return {"kernel": _fold_weight_norm(state, name, device),
            "bias": state_tensor(state[f"{name}.bias"], device)}


def _resblock_from(state, prefix: str, n: int, device) -> Params:
    return {
        "convs1": [_conv_from(state, f"{prefix}.convs1.{j}", device) for j in range(n)],
        "convs2": [_conv_from(state, f"{prefix}.convs2.{j}", device) for j in range(n)],
        "alphas1": [state_tensor(state[f"{prefix}.activations1.{j}.alpha"], device).reshape(-1)
                    for j in range(n)],
        "alphas2": [state_tensor(state[f"{prefix}.activations2.{j}.alpha"], device).reshape(-1)
                    for j in range(n)],
    }


def from_hift_state_dict(state: Dict[str, Any], cfg: HiFTConfig, device=None) -> Params:
    """Official ``hift.pt`` state dict (HiFTGenerator naming; torch tensors or
    numpy arrays) → the port's tree on ``device``, its dtype kept. Weight-norm
    g/v pairs are folded; conv weights keep torch's [out, in, width] and the
    ConvTranspose ``ups`` weights torch's [in, out, width]; Snake alphas are
    stored 1-D."""
    dev = resolve_device(device)
    n_dil = len(cfg.resblock_dilations[0])
    n_kernels = len(cfg.resblock_kernels)

    def linear(name):
        return linear_from_state(state[f"{name}.weight"], state[f"{name}.bias"], dev)

    params: Params = {
        "f0_predictor": {
            "condnet": [_conv_from(state, f"f0_predictor.condnet.{i}", dev)
                        for i in (0, 2, 4, 6, 8)],
            "classifier": linear("f0_predictor.classifier")},
        "m_source": {"l_linear": linear("m_source.l_linear")},
        "conv_pre": _conv_from(state, "conv_pre", dev),
        "ups": [], "source_downs": [], "source_resblocks": [], "resblocks": [],
    }
    for i in range(len(cfg.upsample_rates)):
        params["ups"].append({"kernel": _fold_weight_norm(state, f"ups.{i}", dev),
                              "bias": state_tensor(state[f"ups.{i}.bias"], dev)})
        params["source_downs"].append(_conv_from(state, f"source_downs.{i}", dev))
        params["source_resblocks"].append(
            _resblock_from(state, f"source_resblocks.{i}", n_dil, dev))
        params["resblocks"] += [_resblock_from(state, f"resblocks.{i * n_kernels + j}", n_dil, dev)
                                for j in range(n_kernels)]
    params["conv_post"] = _conv_from(state, "conv_post", dev)
    return params


def _cpu(t: torch.Tensor) -> torch.Tensor:
    return t.detach().cpu().contiguous()


def _emit_conv(out, name, p):
    out[f"{name}.weight"] = _cpu(p["kernel"])
    out[f"{name}.bias"] = _cpu(p["bias"])


def _emit_resblock(out, prefix, p):
    for j, (c1, c2) in enumerate(zip(p["convs1"], p["convs2"])):
        _emit_conv(out, f"{prefix}.convs1.{j}", c1)
        _emit_conv(out, f"{prefix}.convs2.{j}", c2)
        # the official Snake stores alpha 1-D, (in_features,)
        out[f"{prefix}.activations1.{j}.alpha"] = _cpu(p["alphas1"][j].reshape(-1))
        out[f"{prefix}.activations2.{j}.alpha"] = _cpu(p["alphas2"][j].reshape(-1))


def to_hift_state_dict(params: Params, cfg: HiFTConfig) -> Dict[str, torch.Tensor]:
    """The inverse of :func:`from_hift_state_dict` (plain ``weight`` keys, the
    layout after ``remove_weight_norm``), as CPU tensors."""
    out: Dict[str, torch.Tensor] = {}
    for slot, i in zip(params["f0_predictor"]["condnet"], (0, 2, 4, 6, 8)):
        _emit_conv(out, f"f0_predictor.condnet.{i}", slot)
    for name, p in (("f0_predictor.classifier", params["f0_predictor"]["classifier"]),
                    ("m_source.l_linear", params["m_source"]["l_linear"])):
        out[f"{name}.weight"] = _cpu(p["kernel"].T)
        out[f"{name}.bias"] = _cpu(p["bias"])
    _emit_conv(out, "conv_pre", params["conv_pre"])
    n_kernels = len(cfg.resblock_kernels)
    for i in range(len(cfg.upsample_rates)):
        _emit_conv(out, f"ups.{i}", params["ups"][i])
        _emit_conv(out, f"source_downs.{i}", params["source_downs"][i])
        _emit_resblock(out, f"source_resblocks.{i}", params["source_resblocks"][i])
        for j in range(n_kernels):
            _emit_resblock(out, f"resblocks.{i * n_kernels + j}",
                           params["resblocks"][i * n_kernels + j])
    _emit_conv(out, "conv_post", params["conv_post"])
    return out
