"""Window functions and Kaiser-sinc filter design (numpy constants)."""

from __future__ import annotations

import numpy as np


def hann(n: int, *, periodic: bool = True, dtype=np.float32) -> np.ndarray:
    """Hann window. ``periodic=True`` matches torch.hann_window's default."""
    m = n + 1 if periodic else n
    w = 0.5 - 0.5 * np.cos(2.0 * np.pi * np.arange(m) / max(m - 1, 1))
    return w[:n].astype(dtype)


def povey(n: int, dtype=np.float32) -> np.ndarray:
    """Kaldi's 'povey' window (hann ** 0.85), used by kaldi-style fbank."""
    w = 0.5 - 0.5 * np.cos(2.0 * np.pi * np.arange(n) / max(n - 1, 1))
    return (w ** 0.85).astype(dtype)


def kaiser_sinc_filter(
    orig_freq: int,
    new_freq: int,
    *,
    lowpass_filter_width: int = 6,
    rolloff: float = 0.99,
    beta: float | None = None,
    dtype=np.float64,
) -> tuple[np.ndarray, int]:
    """Kaiser-windowed sinc kernels for polyphase resampling (torchaudio
    ``_get_sinc_resample_kernel`` construction). Returns ``(kernels, width)``:
    kernels ``[new_freq_g, kernel_len]`` (one FIR phase per output offset,
    gcd-reduced) and ``width``, the per-side support in input samples."""
    gcd = int(np.gcd(int(orig_freq), int(new_freq)))
    orig_g, new_g = orig_freq // gcd, new_freq // gcd

    if beta is None:
        beta = 14.769656459379492
    base_freq = min(orig_g, new_g) * rolloff

    width = int(np.ceil(lowpass_filter_width * orig_g / base_freq))
    idx = np.arange(-width, width + orig_g, dtype=dtype)[None, :] / orig_g
    t = (-np.arange(new_g, dtype=dtype)[:, None] / new_g + idx) * base_freq
    t = np.clip(t, -lowpass_filter_width, lowpass_filter_width)

    window = np.i0(beta * np.sqrt(np.maximum(0.0, 1.0 - (t / lowpass_filter_width) ** 2))) / np.i0(beta)
    t *= np.pi
    scale = base_freq / orig_g
    kernels = np.where(t == 0, 1.0, np.sin(t) / np.where(t == 0, 1.0, t)) * window * scale
    return kernels.astype(np.float32), width
