"""Fused Whisper log-mel: the CUDA kernel ``csrc/log_mel.cu``, its plain
PyTorch version, and the wrapper that picks between them by device.

Counterpart of the JAX package's ``ops/pallas_mel.py``. The kernel computes
the log10 mel frames ``[frames, n_mels]`` of one waveform (frame, window,
real FFT, power, banded mel projection, log) without writing the framed
signal or the spectrum to device memory; the global (max - 8) floor, the
affine and the transpose run as torch ops after it, as they run outside the
Pallas kernel. The kernel's tables (window, FFT twiddles, the filterbank's
bands) are made here on the host and cached per device.
"""

from __future__ import annotations

import ctypes
import functools

import numpy as np
import torch

from . import build
from .mel import (WHISPER_HOP, WHISPER_N_FFT, WHISPER_SAMPLES, WHISPER_SR,
                  fit_to_chunk, mel_filterbank, normalize_log_mel)
from .stft import _dft_bases, reflect_pad
from .windows import hann

FRAMES_PER_TILE = 200          # the JAX kernel's tile: windows are whole 2 s steps
MAX_MELS = 128                 # the kernel's limit (Whisper uses 80 or 128)
_N_BINS = WHISPER_N_FFT // 2 + 1


@functools.lru_cache(maxsize=4)
def _constants_np(n_mels: int):
    """Window-folded DFT bases [400, 201] (cos, sin) and the slaney mel
    filterbank [201, n_mels], all f32."""
    window = hann(WHISPER_N_FFT).astype(np.float32)
    cos_b, sin_b = _dft_bases(WHISPER_N_FFT)
    wcos = np.ascontiguousarray(window[:, None] * cos_b, np.float32)
    wsin = np.ascontiguousarray(window[:, None] * sin_b, np.float32)
    fb = np.ascontiguousarray(mel_filterbank(WHISPER_SR, WHISPER_N_FFT, n_mels), np.float32)
    return wcos, wsin, fb


@functools.lru_cache(maxsize=8)
def _constants(n_mels: int, device: torch.device):
    return tuple(torch.as_tensor(a, device=device) for a in _constants_np(n_mels))


def fft_twiddles() -> np.ndarray:
    """The kernel's one table of transform constants: exp(-2 pi i j / 400),
    j = 0 .. 399, computed in float64 and rounded to f32, as [400, 2] (re, im)."""
    angle = 2.0 * np.pi * np.arange(WHISPER_N_FFT, dtype=np.float64) / WHISPER_N_FFT
    return np.stack([np.cos(angle), -np.sin(angle)], axis=-1).astype(np.float32)


def mel_bands(fb: np.ndarray) -> tuple:
    """The nonzero band of each filter of ``fb`` [bins, n_mels]: ``bands``
    [n_mels, 3] int32 of (lo, hi, offset) and the band weights ``fb[lo:hi, m]``
    one band after another, f32; filter m sums bins [lo, hi) against
    ``weights[offset : offset + hi - lo]``. An empty filter has lo = hi = 0."""
    bands = np.zeros((fb.shape[1], 3), np.int32)
    weights = []
    offset = 0
    for m in range(fb.shape[1]):
        nz = np.flatnonzero(fb[:, m])
        lo, hi = (int(nz[0]), int(nz[-1]) + 1) if nz.size else (0, 0)
        if hi - lo != nz.size:
            raise ValueError(f"mel filter {m} has a gap in its band [{lo}, {hi})")
        bands[m] = lo, hi, offset
        weights.append(fb[lo:hi, m])
        offset += hi - lo
    return bands, np.concatenate(weights).astype(np.float32)


@functools.lru_cache(maxsize=4)
def _kernel_tables_np(n_mels: int):
    """(Hann window [400], twiddles [400, 2], bands [n_mels, 3], band weights)."""
    fb = np.asarray(mel_filterbank(WHISPER_SR, WHISPER_N_FFT, n_mels), np.float32)
    return (hann(WHISPER_N_FFT).astype(np.float32), fft_twiddles(), *mel_bands(fb))


_tables: dict = {}   # (n_mels, device) -> the kernel's tables on that device
_entry = None        # the kernel's C entry point, bound once


def _kernel_tables(n_mels: int, device: torch.device) -> tuple:
    key = (n_mels, device)
    tables = _tables.get(key)
    if tables is None:
        tables = _tables[key] = tuple(torch.as_tensor(a, device=device)
                                      for a in _kernel_tables_np(n_mels))
    return tables


def _check_window(audio: torch.Tensor, chunk_samples: int) -> int:
    if audio.ndim != 1:
        raise ValueError(f"log-mel takes a single [T] waveform, got shape {tuple(audio.shape)}")
    n_frames = chunk_samples // WHISPER_HOP
    if chunk_samples % WHISPER_HOP or n_frames % FRAMES_PER_TILE:
        raise ValueError(
            f"chunk_samples must give a multiple of {FRAMES_PER_TILE} frames "
            f"(got {chunk_samples} samples); use an even number of seconds")
    return n_frames


def log_mel_frames_plain(audio: torch.Tensor, n_mels: int, chunk_samples: int) -> torch.Tensor:
    """The kernel's function in plain PyTorch: log10 mel frames
    ``[chunk_samples / 160, n_mels]`` (Whisper's last frame dropped)."""
    n_frames = _check_window(audio, chunk_samples)
    wcos, wsin, fb = _constants(n_mels, audio.device)
    x = reflect_pad(fit_to_chunk(audio.float(), chunk_samples), WHISPER_N_FFT // 2)
    frames = x.unfold(-1, WHISPER_N_FFT, WHISPER_HOP)[:n_frames]
    real = frames @ wcos
    imag = frames @ wsin
    power = real * real + imag * imag
    return torch.log10(torch.clamp_min(power @ fb, 1e-10))


def _bind():
    global _entry
    fn = build.load("log_mel").est_log_mel_frames
    p, i = ctypes.c_void_p, ctypes.c_int
    fn.argtypes = [p, i, i, p, p, p, p, i, p, p]
    fn.restype = ctypes.c_int
    _entry = fn
    return fn


def log_mel_frames(audio: torch.Tensor, n_mels: int, chunk_samples: int) -> torch.Tensor:
    """log10 mel frames ``[chunk_samples / 160, n_mels]`` f32 of one waveform.

    A CPU tensor takes :func:`log_mel_frames_plain`; a CUDA tensor launches
    the kernel (and counts the launch in ``log_mel_frames.launches``) or
    raises."""
    n_frames = _check_window(audio, chunk_samples)
    if audio.device.type == "cpu":
        return log_mel_frames_plain(audio, n_mels, chunk_samples)
    if audio.device.type != "cuda":
        raise ValueError(f"log-mel kernel runs on CUDA or CPU tensors, got {audio.device}")
    if audio.dtype != torch.float32:
        raise TypeError(f"log-mel kernel takes float32 audio, got {audio.dtype}")
    if not 0 < n_mels <= MAX_MELS:
        raise ValueError(f"log-mel kernel takes 1 to {MAX_MELS} mels, got {n_mels}")
    x = audio[:chunk_samples]
    if not x.is_contiguous():
        raise ValueError("log-mel kernel takes a contiguous waveform")
    window, twiddles, bands, band_w = _kernel_tables(n_mels, audio.device)
    out = torch.empty((n_frames, n_mels), dtype=torch.float32, device=audio.device)
    with torch.cuda.device(audio.device):
        status = (_entry or _bind())(
            x.data_ptr(), x.shape[0], chunk_samples, window.data_ptr(), twiddles.data_ptr(),
            bands.data_ptr(), band_w.data_ptr(), n_mels, out.data_ptr(),
            torch.cuda.current_stream(audio.device).cuda_stream)
    build.check(status, "log_mel_frames")
    log_mel_frames.launches += 1
    return out


log_mel_frames.launches = 0


def whisper_log_mel_fused(audio: torch.Tensor, *, n_mels: int = 80,
                          chunk_samples: int = WHISPER_SAMPLES) -> torch.Tensor:
    """Whisper log-mel of one [T] waveform, [n_mels, chunk_samples / 160]
    ([80, 3000] at the default 30 s window) — the port of
    ``whisper_log_mel_pallas``. ``chunk_samples`` is the context window
    (bucketed serving pads or trims the utterance to it)."""
    return normalize_log_mel(log_mel_frames(audio, n_mels, chunk_samples)).T
