"""Audio DSP building blocks of the audio front end, in torch.

The port of the JAX package's ``ops/dsp.py``: DC removal, pre-emphasis, peak
normalisation, the silence gate, the correlation-aware downmix, RMS loudness,
the STFT-domain noise gate, multi-resolution band EQ, the phase-vocoder time
stretch and the frame features. Every function takes and returns ``[..., T]``
tensors and runs on the input's device. The STFTs are the matmul
formulation of ``ops/stft.py``, plain products as in the JAX package (which
computes all of this outside any Pallas kernel).
"""

from __future__ import annotations

from typing import Optional, Sequence, Tuple

import numpy as np
import torch
import torch.nn.functional as F

from .stft import frame_signal, istft, stft

SPEECH_BAND_HZ: Tuple[float, float] = (300.0, 3400.0)


def remove_dc(x: torch.Tensor) -> torch.Tensor:
    return x - x.mean(dim=-1, keepdim=True)


def preemphasis(x: torch.Tensor, coeff: float = 0.97) -> torch.Tensor:
    """y[t] = x[t] - coeff * x[t-1]."""
    prev = torch.cat([x[..., :1] * 0, x[..., :-1]], dim=-1)
    return x - coeff * prev


def peak_normalize(x: torch.Tensor, peak: float = 0.95) -> torch.Tensor:
    """Scale so max |x| == peak."""
    m = x.abs().amax(dim=-1, keepdim=True)
    return x * (peak / torch.clamp(m, min=1e-8))


def soft_limit(x: torch.Tensor, drive: float = 1.0) -> torch.Tensor:
    """tanh limiter."""
    return torch.tanh(x * drive)


def silence_gate(x: torch.Tensor, threshold_db: float = -40.0, frame: int = 512) -> torch.Tensor:
    """Zero out frames whose RMS is below the threshold."""
    t = x.shape[-1]
    n_frames = -(-t // frame)
    padded = F.pad(x, (0, n_frames * frame - t))
    framed = padded.reshape(*x.shape[:-1], n_frames, frame)
    rms = torch.sqrt((framed ** 2).mean(dim=-1, keepdim=True) + 1e-12)
    thr = 10.0 ** (threshold_db / 20.0)
    gated = torch.where(rms > thr, framed, 0.0).reshape(*x.shape[:-1], n_frames * frame)
    return gated[..., :t]


def stereo_to_mono(x: torch.Tensor) -> torch.Tensor:
    """Correlation-aware downmix: mid/side when channels are decorrelated,
    else the plain average. [C, T] → [T]."""
    if x.ndim == 1:
        return x
    if x.shape[0] == 1:
        return x[0]
    l, r = x[0], x[1]
    corr = (l * r).sum() / torch.clamp(torch.sqrt((l * l).sum() * (r * r).sum()), min=1e-8)
    mid = 0.5 * (l + r)
    side_boosted = 0.5 * (l + r) + 0.25 * (l - r).abs() * torch.sign(mid)
    return torch.where(corr > 0.5, mid, side_boosted)


def rms_db(x: torch.Tensor) -> torch.Tensor:
    return 20.0 * torch.log10(torch.sqrt((x ** 2).mean(dim=-1) + 1e-12))


def loudness_normalize(x: torch.Tensor, target_lufs: float = -23.0) -> torch.Tensor:
    """RMS-proxy loudness normalisation toward the target LUFS, tanh-limited."""
    gain = 10.0 ** ((target_lufs - rms_db(x)) / 20.0)
    return soft_limit(x * gain[..., None], 1.0) if x.ndim > 1 else soft_limit(x * gain, 1.0)


# --------------------------------------------------------------- noise gating


def spectral_noise_gate(
    x: torch.Tensor,
    *,
    sr: int = 16_000,
    n_fft: int = 1024,
    hop: int = 256,
    noise_percentile_frames: int = 10,
    oversubtract: float = 1.2,
    speech_boost: float = 1.2,
    gate_floor: float = 0.1,
    valid_frames: Optional[int] = None,
) -> torch.Tensor:
    """STFT-domain noise gate with speech-band boost: the noise profile is
    the mean magnitude of the quietest frames, magnitudes below
    ``oversubtract × noise`` are soft-gated, 300–3400 Hz is boosted, and the
    signal is rebuilt with the original phase.

    ``valid_frames``: for bucket-padded inputs, the frames past it are kept
    out of the quietest-frame selection (padded all-zero frames would win it
    and null the profile)."""
    length = x.shape[-1]
    real, imag = stft(x, n_fft, hop)
    mag = torch.sqrt(real * real + imag * imag + 1e-12)

    frame_energy = mag.sum(dim=-1)
    if valid_frames is not None:
        frame_idx = torch.arange(mag.shape[-2], device=x.device)
        frame_energy = torch.where(frame_idx < valid_frames, frame_energy, torch.inf)
    k = min(noise_percentile_frames, mag.shape[-2])
    idx = torch.topk(-frame_energy, k, dim=-1).indices          # the quietest frames
    quiet = torch.gather(mag, -2, idx[..., None].expand(*idx.shape, mag.shape[-1]))
    noise_profile = quiet.mean(dim=-2, keepdim=True)

    gain = torch.clamp((mag - oversubtract * noise_profile) / torch.clamp(mag, min=1e-8),
                       gate_floor, 1.0)
    freqs = np.linspace(0, sr / 2, n_fft // 2 + 1)
    speech_mask = ((freqs >= SPEECH_BAND_HZ[0]) & (freqs <= SPEECH_BAND_HZ[1])).astype(np.float32)
    boost = 1.0 + (speech_boost - 1.0) * torch.as_tensor(speech_mask, device=x.device)
    gain = torch.clamp(gain * boost, max=1.0)
    return istft(real * gain, imag * gain, n_fft, hop, length=length)


# ------------------------------------------------- multi-resolution enhancement


def band_eq_gains(sr: int, n_bins: int, n_fft: int, band_edges_hz: Sequence[float],
                  multipliers: Sequence[float]) -> np.ndarray:
    """Per-bin gain vector from band-edge / multiplier tables (the 7-band
    language EQ)."""
    freqs = np.linspace(0, sr / 2, n_bins)
    gains = np.ones(n_bins, dtype=np.float32)
    for lo, hi, mult in zip(band_edges_hz[:-1], band_edges_hz[1:], multipliers):
        gains[(freqs >= lo) & (freqs < hi)] = mult
    return gains


def spectral_enhance(
    x: torch.Tensor,
    *,
    sr: int = 16_000,
    band_edges_hz: Sequence[float] = (0, 150, 300, 800, 1500, 3000, 5000, 8000),
    band_multipliers: Sequence[float] = (1.0,) * 7,
    compression_threshold: float = 0.5,
    compression_ratio: float = 1.0,
    resolutions: Sequence[int] = (512, 1024, 2048),
    resolution_weights: Sequence[float] = (0.2, 0.4, 0.4),
) -> torch.Tensor:
    """Band EQ and magnitude compression at three STFT resolutions, mixed."""
    length = x.shape[-1]
    out = torch.zeros_like(x)
    for n_fft, weight in zip(resolutions, resolution_weights):
        hop = n_fft // 4
        real, imag = stft(x, n_fft, hop)
        mag = torch.sqrt(real * real + imag * imag + 1e-12)
        phase_r, phase_i = real / mag, imag / mag
        gains = band_eq_gains(sr, n_fft // 2 + 1, n_fft, band_edges_hz, band_multipliers)
        new_mag = mag * torch.as_tensor(gains, device=x.device)
        if compression_ratio != 1.0:
            peak = new_mag.amax(dim=(-2, -1), keepdim=True)
            norm = new_mag / torch.clamp(peak, min=1e-8)
            compressed = torch.where(
                norm > compression_threshold,
                compression_threshold + (norm - compression_threshold) / compression_ratio,
                norm)
            new_mag = compressed * peak
        y = istft(new_mag * phase_r, new_mag * phase_i, n_fft, hop, length=length)
        out = out + weight * y
    return out


# ------------------------------------------------------------- phase vocoder


def phase_vocoder_stretch(x: torch.Tensor, rate: float, *, n_fft: int = 2048,
                          hop: int = 512) -> torch.Tensor:
    """Time-stretch by ``rate`` (> 1 = faster / shorter) with a phase vocoder.
    JAX accumulates the phase advance with ``lax.scan``; here it is a cumsum
    over frames that starts from the first frame's phase, which is kept."""
    real, imag = stft(x, n_fft, hop)
    n_frames = real.shape[-2]
    out_frames = max(2, int(n_frames / rate))
    dev = x.device

    # sample positions in the original frames' index space
    t = np.arange(out_frames) * rate
    t0 = np.clip(np.floor(t).astype(np.int64), 0, n_frames - 2)
    frac = torch.as_tensor((t - t0).astype(np.float32), device=dev)[..., :, None]
    i0 = torch.as_tensor(t0, device=dev)

    mag = torch.sqrt(real * real + imag * imag + 1e-12)
    phase = torch.atan2(imag, real)
    out_mag = (1 - frac) * mag.index_select(-2, i0) + frac * mag.index_select(-2, i0 + 1)

    omega = torch.as_tensor(
        (2.0 * np.pi * hop * np.arange(n_fft // 2 + 1) / n_fft).astype(np.float32), device=dev)
    dphase = phase.index_select(-2, i0 + 1) - phase.index_select(-2, i0) - omega
    dphase = dphase - 2.0 * torch.pi * torch.round(dphase / (2.0 * torch.pi))
    step = dphase + omega

    first_phase = phase.index_select(-2, i0[:1])
    acc = torch.cumsum(torch.cat([first_phase, step], dim=-2), dim=-2)
    # acc[f + 1] = first + step[0] + ... + step[f]; frame 0 keeps its phase
    out_phase = torch.cat([first_phase, acc[..., 2:, :]], dim=-2)
    return istft(out_mag * torch.cos(out_phase), out_mag * torch.sin(out_phase), n_fft, hop)


# ------------------------------------------------------------------ features


def energy_envelope(x: torch.Tensor, frame: int = 512, hop: int = 256) -> torch.Tensor:
    """Frame RMS energy [..., frames] (the VAD's energy feature)."""
    frames = frame_signal(x, frame, hop, center=False)
    return torch.sqrt((frames ** 2).mean(dim=-1) + 1e-12)


def spectral_centroid_rolloff(x: torch.Tensor, *, sr: int = 16_000, n_fft: int = 1024,
                              hop: int = 256, rolloff_pct: float = 0.85
                              ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Per-frame spectral centroid (Hz) and rolloff (Hz)."""
    real, imag = stft(x, n_fft, hop)
    mag = torch.sqrt(real * real + imag * imag + 1e-12)
    freqs = torch.as_tensor(np.linspace(0, sr / 2, n_fft // 2 + 1, dtype=np.float32),
                            device=x.device)
    total = mag.sum(dim=-1)
    centroid = (mag * freqs).sum(dim=-1) / torch.clamp(total, min=1e-8)
    cum = torch.cumsum(mag, dim=-1)
    # the first bin reaching the target (argmax of a bool picks the first True)
    rolloff_idx = (cum >= rolloff_pct * total[..., None]).to(torch.uint8).argmax(dim=-1)
    return centroid, freqs[rolloff_idx]


def spectral_flatness(x: torch.Tensor, *, n_fft: int = 1024, hop: int = 256) -> torch.Tensor:
    """Per-frame flatness (geometric over arithmetic mean of the power)."""
    real, imag = stft(x, n_fft, hop)
    power = real * real + imag * imag + 1e-10
    return torch.exp(torch.log(power).mean(dim=-1)) / power.mean(dim=-1)
