"""STFT pieces as framed matmuls against cos/sin DFT bases.

Same formulation as the JAX package's ``ops/stft.py``: framing is
``unfold`` over the (reflect-padded) signal and the DFT is two real matmuls,
which keeps the Whisper frontend's arithmetic identical to the fused log-mel
kernel's (ops/cuda_mel.py).
"""

from __future__ import annotations

import functools
from typing import Optional, Tuple

import numpy as np
import torch
import torch.nn.functional as F

from .windows import hann


@functools.lru_cache(maxsize=32)
def _dft_bases(n_fft: int, dtype_name: str = "float32") -> Tuple[np.ndarray, np.ndarray]:
    """Real-input DFT bases: cos/sin matrices of shape [n_fft, n_bins]."""
    n_bins = n_fft // 2 + 1
    n = np.arange(n_fft)[:, None]
    k = np.arange(n_bins)[None, :]
    angle = -2.0 * np.pi * n * k / n_fft
    dtype = np.dtype(dtype_name)
    return np.cos(angle).astype(dtype), np.sin(angle).astype(dtype)


def reflect_pad(x: torch.Tensor, pad: int) -> torch.Tensor:
    """numpy ``mode="reflect"`` padding of the last axis of any-rank ``x``."""
    lead = x.shape[:-1]
    y = F.pad(x.reshape(-1, 1, x.shape[-1]), (pad, pad), mode="reflect")
    return y.reshape(*lead, y.shape[-1])


def frame_signal(x: torch.Tensor, n_fft: int, hop: int, *, center: bool = True) -> torch.Tensor:
    """[..., T] → [..., frames, n_fft] with reflect padding when centered."""
    if center:
        x = reflect_pad(x, n_fft // 2)
    return x.unfold(-1, n_fft, hop)


def stft(x: torch.Tensor, n_fft: int, hop: int, *,
         window: Optional[np.ndarray] = None, center: bool = True):
    """Real STFT → (real, imag), each [..., frames, n_bins]."""
    if window is None:
        window = hann(n_fft)
    framed = frame_signal(x, n_fft, hop, center=center) * torch.as_tensor(window, device=x.device)
    cos_b, sin_b = _dft_bases(n_fft)
    real = framed @ torch.as_tensor(cos_b, device=x.device)
    imag = framed @ torch.as_tensor(sin_b, device=x.device)
    return real, imag


def power_spectrogram(x: torch.Tensor, n_fft: int, hop: int, *,
                      window: Optional[np.ndarray] = None, center: bool = True) -> torch.Tensor:
    """Power spectrogram |STFT|^2, [..., frames, n_bins]."""
    real, imag = stft(x, n_fft, hop, window=window, center=center)
    return real * real + imag * imag
