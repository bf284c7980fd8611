"""Mel filterbanks and the Whisper log-mel frontend.

librosa-style slaney-scale, slaney-normed triangular filters; Whisper's
n_fft=400, hop=160, 80 (or 128) mels at 16 kHz, log10 clamped at 1e-10,
floored at (max - 8), then (x + 4) / 4 — the JAX package's ``ops/mel.py``.
"""

from __future__ import annotations

import functools
from typing import Optional

import numpy as np
import torch

from .stft import power_spectrogram

WHISPER_N_FFT = 400
WHISPER_HOP = 160
WHISPER_SR = 16_000
WHISPER_CHUNK_SECONDS = 30
WHISPER_SAMPLES = WHISPER_SR * WHISPER_CHUNK_SECONDS  # 480_000
WHISPER_FRAMES = WHISPER_SAMPLES // WHISPER_HOP       # 3000


def hz_to_mel(freq, *, htk: bool = False):
    freq = np.asarray(freq, dtype=np.float64)
    if htk:
        return 2595.0 * np.log10(1.0 + freq / 700.0)
    f_min, f_sp = 0.0, 200.0 / 3
    mels = (freq - f_min) / f_sp
    min_log_hz = 1000.0
    min_log_mel = (min_log_hz - f_min) / f_sp
    logstep = np.log(6.4) / 27.0
    return np.where(freq >= min_log_hz, min_log_mel + np.log(np.maximum(freq, 1e-10) / min_log_hz) / logstep, mels)


def mel_to_hz(mels, *, htk: bool = False):
    mels = np.asarray(mels, dtype=np.float64)
    if htk:
        return 700.0 * (10.0 ** (mels / 2595.0) - 1.0)
    f_min, f_sp = 0.0, 200.0 / 3
    freqs = f_min + f_sp * mels
    min_log_hz = 1000.0
    min_log_mel = (min_log_hz - f_min) / f_sp
    logstep = np.log(6.4) / 27.0
    return np.where(mels >= min_log_mel, min_log_hz * np.exp(logstep * (mels - min_log_mel)), freqs)


@functools.lru_cache(maxsize=16)
def mel_filterbank(
    sr: int,
    n_fft: int,
    n_mels: int,
    fmin: float = 0.0,
    fmax: Optional[float] = None,
    *,
    htk: bool = False,
    norm: Optional[str] = "slaney",
) -> np.ndarray:
    """librosa.filters.mel-compatible triangular filterbank, [n_bins, n_mels]."""
    fmax = fmax if fmax is not None else sr / 2.0
    n_bins = n_fft // 2 + 1
    fft_freqs = np.linspace(0.0, sr / 2.0, n_bins)
    mel_pts = np.linspace(hz_to_mel(fmin, htk=htk), hz_to_mel(fmax, htk=htk), n_mels + 2)
    hz_pts = mel_to_hz(mel_pts, htk=htk)

    fdiff = np.diff(hz_pts)
    ramps = hz_pts[:, None] - fft_freqs[None, :]
    lower = -ramps[:-2] / fdiff[:-1, None]
    upper = ramps[2:] / fdiff[1:, None]
    weights = np.maximum(0.0, np.minimum(lower, upper))

    if norm == "slaney":
        enorm = 2.0 / (hz_pts[2: n_mels + 2] - hz_pts[:n_mels])
        weights *= enorm[:, None]
    return weights.T.astype(np.float32)  # [n_bins, n_mels]


def fit_to_chunk(audio: torch.Tensor, chunk_samples: int) -> torch.Tensor:
    """Trim or zero-pad the last axis to ``chunk_samples``."""
    deficit = chunk_samples - audio.shape[-1]
    if deficit < 0:
        return audio[..., :chunk_samples]
    if deficit > 0:
        return torch.nn.functional.pad(audio, (0, deficit))
    return audio


def normalize_log_mel(log_spec: torch.Tensor) -> torch.Tensor:
    """Whisper's dynamic-range floor (max - 8) and (x + 4) / 4 over the last
    two axes."""
    peak = torch.amax(log_spec, dim=(-2, -1), keepdim=True)
    log_spec = torch.maximum(log_spec, peak - 8.0)
    return (log_spec + 4.0) / 4.0


def whisper_log_mel(audio: torch.Tensor, *, n_mels: int = 80,
                    chunk_samples: int = WHISPER_SAMPLES) -> torch.Tensor:
    """Whisper-compatible log-mel of the audio padded or trimmed to
    ``chunk_samples``: [..., T] → [..., n_mels, chunk_samples / 160]
    (openai-whisper ``log_mel_spectrogram``: the final frame is dropped)."""
    audio = fit_to_chunk(audio, chunk_samples)
    power = power_spectrogram(audio, WHISPER_N_FFT, WHISPER_HOP, center=True)
    power = power[..., :-1, :]
    fb = torch.as_tensor(mel_filterbank(WHISPER_SR, WHISPER_N_FFT, n_mels), device=audio.device)
    log_spec = torch.log10(torch.clamp_min(power @ fb, 1e-10))
    return normalize_log_mel(log_spec).transpose(-1, -2)
