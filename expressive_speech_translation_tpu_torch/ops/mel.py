"""Mel filterbanks, the Whisper log-mel frontend and Kaldi-style fbank.

- Whisper: librosa-style slaney-scale, slaney-normed triangular filters;
  n_fft=400, hop=160, 80 (or 128) mels at 16 kHz, log10 clamped at 1e-10,
  floored at (max - 8), then (x + 4) / 4.
- Kaldi fbank (the voice-prompt features): povey window, snip-edges framing,
  HTK mel scale without norm, natural log.

The JAX package's ``ops/mel.py``.
"""

from __future__ import annotations

import functools
from typing import Optional

import numpy as np
import torch

from .stft import _dft_bases, frame_signal, power_spectrogram
from .windows import povey

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


# ------------------------------------------------------------- kaldi fbank


@functools.lru_cache(maxsize=16)
def _kaldi_constants(sr: int, frame_len: int, n_fft: int, n_mels: int, fmin: float,
                     fmax: Optional[float], device: torch.device):
    """(povey window [frame_len], the n_fft-point DFT bases' first frame_len
    rows [frame_len, n_bins] ×2 (the zero pad contributes nothing), HTK
    filterbank [n_bins, n_mels]) as f32 tensors on ``device``."""
    cos_b, sin_b = _dft_bases(n_fft)
    fb = mel_filterbank(sr, n_fft, n_mels, fmin=fmin, fmax=fmax, htk=True, norm=None)
    return tuple(torch.as_tensor(np.ascontiguousarray(a), device=device)
                 for a in (povey(frame_len), cos_b[:frame_len], sin_b[:frame_len], fb))


def kaldi_fbank(
    audio: torch.Tensor,
    *,
    sr: int = 24_000,
    n_mels: int = 80,
    frame_length_ms: float = 80.0,   # 1920 samples at 24 kHz
    frame_shift_ms: float = 20.0,    # 480 samples
    dither: float = 0.0,
    preemphasis: float = 0.97,
    remove_dc: bool = True,
    fmin: float = 20.0,
    fmax: Optional[float] = None,
    log_floor: float = 1.1920928955078125e-07,  # kaldi EPSILON
) -> torch.Tensor:
    """Kaldi/torchaudio-compliance-style fbank: [..., T] → [..., frames, n_mels].

    Snip-edges framing, per-frame DC removal, pre-emphasis with edge
    replication, povey window, zero-pad to the next power of two, power
    spectrum, HTK-scale mel (no norm), ln of the floored energies."""
    if dither:
        # dither needs a random source that the JAX reference does not have
        # either; CosyVoice's features use none
        raise NotImplementedError("kaldi_fbank: dither is not implemented; "
                                  "pass dither=0.0 (the CosyVoice setting)")
    frame_len = int(sr * frame_length_ms / 1000.0)
    hop = int(sr * frame_shift_ms / 1000.0)
    n_fft = 1 << (frame_len - 1).bit_length()  # kaldi round_to_power_of_two
    window, cos_b, sin_b, fb = _kaldi_constants(sr, frame_len, n_fft, n_mels, fmin, fmax,
                                                audio.device)

    frames = frame_signal(audio, frame_len, hop, center=False)
    if remove_dc:
        frames = frames - frames.mean(dim=-1, keepdim=True)
    if preemphasis:
        prev = torch.cat([frames[..., :1], frames[..., :-1]], dim=-1)
        frames = frames - preemphasis * prev
    frames = frames * window
    real = frames @ cos_b
    imag = frames @ sin_b
    power = real * real + imag * imag
    return torch.log(torch.clamp_min(power @ fb, log_floor))
