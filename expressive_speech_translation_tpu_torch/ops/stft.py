"""STFT and iSTFT as framed matmuls against cos/sin DFT bases.

Same formulation as the JAX package's ``ops/stft.py``: framing is
``unfold`` over the (reflect-padded) signal and the DFT is two real matmuls,
which keeps the Whisper frontend's arithmetic identical to the fused log-mel
kernel's (ops/cuda_mel.py). The inverse is two matmuls against the weighted
bases, the synthesis window, overlap-add and COLA normalisation.
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
    """numpy ``mode="reflect"`` padding of the last axis of any-rank ``x``.
    ``F.pad`` reflects at most ``T - 1`` samples; numpy (and JAX) reflect
    any length, periodically, so a longer pad gathers by that index."""
    n = x.shape[-1]
    if pad >= n:
        j = np.arange(-pad, n + pad)
        period = max(2 * (n - 1), 1)
        m = np.mod(j, period)
        idx = np.where(m >= n, period - m, m)
        return x[..., torch.as_tensor(idx, device=x.device)]
    lead = x.shape[:-1]
    y = F.pad(x.reshape(-1, 1, n), (pad, pad), mode="reflect")
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


def spectrogram(x: torch.Tensor, n_fft: int, hop: int, *, window: Optional[np.ndarray] = None,
                center: bool = True, power: float = 2.0) -> torch.Tensor:
    """Magnitude (power=1) or power (power=2) spectrogram, [..., frames, n_bins]."""
    mag2 = power_spectrogram(x, n_fft, hop, window=window, center=center)
    if power == 2.0:
        return mag2
    if power == 1.0:
        return torch.sqrt(torch.clamp_min(mag2, 1e-20))
    return torch.pow(torch.clamp_min(mag2, 1e-20), power / 2.0)


@functools.lru_cache(maxsize=32)
def _inverse_bases(n_fft: int) -> Tuple[np.ndarray, np.ndarray]:
    """Inverse real DFT as two products: ``irfft(X)[n] = (1/N) Σ_k w_k (Re·cos
    + Im·sin)`` with ``w_k`` = 2 for interior bins, 1 for DC and Nyquist.
    → [n_bins, n_fft] each."""
    cos_b, sin_b = _dft_bases(n_fft)
    weights = np.full((n_fft // 2 + 1,), 2.0, dtype=np.float32)
    weights[0] = 1.0
    if n_fft % 2 == 0:
        weights[-1] = 1.0
    return (cos_b * weights[None, :]).T / n_fft, (sin_b * weights[None, :]).T / n_fft


@functools.lru_cache(maxsize=64)
def _cola_envelope(window: bytes, n_fft: int, hop: int, n_frames: int) -> np.ndarray:
    """max(Σ window², 1e-11) over the overlapped frames, f32 [out_len]."""
    w2 = np.frombuffer(window, np.float32) ** 2
    env = np.zeros(n_fft + hop * (n_frames - 1), dtype=np.float32)
    for i in range(n_frames):
        env[i * hop: i * hop + n_fft] += w2
    return np.maximum(env, 1e-11)


def istft(real: torch.Tensor, imag: torch.Tensor, n_fft: int, hop: int, *,
          window: Optional[np.ndarray] = None, center: bool = True,
          length: Optional[int] = None) -> torch.Tensor:
    """Inverse STFT with windowed overlap-add and COLA normalisation:
    [..., frames, n_bins] (real, imag) → [..., T]."""
    if window is None:
        window = hann(n_fft)
    dev = real.device
    inv_cos, inv_sin = _inverse_bases(n_fft)
    frames_time = (real @ torch.as_tensor(inv_cos, device=dev)
                   + imag @ torch.as_tensor(inv_sin, device=dev))
    frames_time = frames_time * torch.as_tensor(window, device=dev)   # synthesis window

    n_frames = frames_time.shape[-2]
    out_len = n_fft + hop * (n_frames - 1)
    lead = frames_time.shape[:-2]
    if n_fft % hop == 0:
        # with n_fft = k·hop, frame f's j-th hop-chunk lands at (f + j)·hop:
        # overlap-add is k shifted, contiguous adds
        k = n_fft // hop
        chunks = frames_time.reshape(*lead, n_frames, k, hop)
        out = frames_time.new_zeros((*lead, out_len))
        for j in range(k):
            out[..., j * hop: j * hop + n_frames * hop] += (
                chunks[..., :, j, :].reshape(*lead, n_frames * hop))
    else:
        # the general overlap-add: fold sums each output sample's frames
        cols = frames_time.reshape(-1, n_frames, n_fft).transpose(1, 2)
        out = F.fold(cols, (1, out_len), (1, n_fft), stride=(1, hop)).reshape(*lead, out_len)

    env = _cola_envelope(np.asarray(window, np.float32).tobytes(), n_fft, hop, n_frames)
    out = out / torch.as_tensor(env, device=dev)
    if center:
        pad = n_fft // 2
        out = out[..., pad: out_len - pad]
    if length is not None:
        out = out[..., :length]
        deficit = length - out.shape[-1]
        if deficit > 0:
            out = F.pad(out, (0, deficit))
    return out
