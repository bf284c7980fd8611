"""Host-side (numpy) DSP for the per-request serving glue: temporal stretch,
loudness normalisation and resampling touch a few hundred KB of audio per
request. Copies of the JAX package's ops/host_dsp.py, with the FFT
convolution written over numpy instead of scipy."""

from __future__ import annotations

import numpy as np

from .windows import hann, kaiser_sinc_filter


def stft_np(x: np.ndarray, n_fft: int, hop: int, *, center: bool = True):
    """Hann-windowed, reflect-centred STFT via rfft → [frames, n_bins] complex."""
    x = np.asarray(x, np.float32)
    if center:
        pad = n_fft // 2
        x = np.pad(x, (pad, pad), mode="reflect")
    frames = 1 + (len(x) - n_fft) // hop
    idx = np.arange(frames)[:, None] * hop + np.arange(n_fft)[None, :]
    framed = x[idx] * hann(n_fft)
    return np.fft.rfft(framed, axis=-1)


def istft_np(spec: np.ndarray, n_fft: int, hop: int, *,
             center: bool = True, length: int | None = None) -> np.ndarray:
    """Windowed overlap-add with COLA normalisation."""
    win = hann(n_fft).astype(np.float32)
    frames_time = np.fft.irfft(spec, n=n_fft, axis=-1).astype(np.float32) * win
    n_frames = frames_time.shape[0]
    out_len = n_fft + hop * (n_frames - 1)
    out = np.zeros(out_len, np.float32)
    env = np.zeros(out_len, np.float32)
    w2 = win * win
    for i in range(n_frames):
        out[i * hop: i * hop + n_fft] += frames_time[i]
        env[i * hop: i * hop + n_fft] += w2
    out /= np.maximum(env, 1e-11)
    if center:
        pad = n_fft // 2
        out = out[pad: out_len - pad]
    if length is not None:
        out = out[:length]
        if len(out) < length:
            out = np.pad(out, (0, length - len(out)))
    return out


def phase_vocoder_stretch_np(x: np.ndarray, rate: float, *, n_fft: int = 2048,
                             hop: int = 512) -> np.ndarray:
    """Phase-vocoder time stretch by ``rate`` (>1 shortens)."""
    spec = stft_np(x, n_fft, hop)
    n_frames = spec.shape[0]
    out_frames = max(2, int(n_frames / rate))

    t = np.arange(out_frames) * rate
    t0 = np.clip(np.floor(t).astype(np.int64), 0, n_frames - 2)
    frac = (t - t0).astype(np.float32)[:, None]

    mag = np.sqrt(spec.real**2 + spec.imag**2 + 1e-12)
    phase = np.angle(spec)

    out_mag = (1 - frac) * mag[t0] + frac * mag[t0 + 1]

    omega = (2.0 * np.pi * hop * np.arange(n_fft // 2 + 1) / n_fft).astype(np.float32)
    dphase = phase[t0 + 1] - phase[t0] - omega
    dphase -= 2.0 * np.pi * np.round(dphase / (2.0 * np.pi))
    step = dphase + omega

    # accumulated phase; frame 0 keeps its original phase
    out_phase = phase[t0[0]][None, :] + np.cumsum(step, axis=0)
    out_phase[0] = phase[t0[0]]

    return istft_np(out_mag * np.exp(1j * out_phase), n_fft, hop)


def loudness_normalize_np(x: np.ndarray, target_lufs: float = -23.0) -> np.ndarray:
    """RMS-proxy loudness gain toward ``target_lufs`` plus a tanh limiter."""
    x = np.asarray(x, np.float32)
    rms_db = 20.0 * np.log10(np.sqrt(np.mean(x**2, axis=-1) + 1e-12))
    gain = 10.0 ** ((target_lufs - rms_db) / 20.0)
    y = x * (gain[..., None] if x.ndim > 1 else gain)
    return np.tanh(y)


def _correlate_valid(x: np.ndarray, k: np.ndarray) -> np.ndarray:
    """``y[n] = sum_j x[n + j] k[j]`` for every full overlap, by FFT."""
    n_out = len(x) - len(k) + 1
    size = 1 << (len(x) + len(k) - 2).bit_length()
    spec = np.fft.rfft(x, size) * np.fft.rfft(k[::-1], size)
    full = np.fft.irfft(spec, size)
    return full[len(k) - 1: len(k) - 1 + n_out]


def resample_np(
    x: np.ndarray,
    orig_freq: int,
    new_freq: int,
    *,
    lowpass_filter_width: int = 128,
    rolloff: float = 0.9475937167399596,
    beta: float | None = 14.769656459379492,
) -> np.ndarray:
    """Kaiser polyphase resampling with torchaudio's output length
    (ceil(T * new / orig))."""
    x = np.asarray(x, np.float32).reshape(-1)
    if orig_freq == new_freq:
        return x
    kernels, width = kaiser_sinc_filter(
        orig_freq, new_freq,
        lowpass_filter_width=lowpass_filter_width, rolloff=rolloff, beta=beta)
    gcd = int(np.gcd(orig_freq, new_freq))
    orig_g, new_g = orig_freq // gcd, new_freq // gcd

    t_in = len(x)
    num_blocks = -(-t_in // orig_g)
    target_len = -(-t_in * new_g // orig_g)
    xpad = np.pad(x, (width, width + orig_g))

    # y[p, b] = sum_k xpad[b * orig_g + k] * w[p, k]
    out = np.empty((new_g, num_blocks), np.float32)
    for p in range(new_g):
        out[p] = _correlate_valid(xpad, kernels[p])[::orig_g][:num_blocks]
    return out.T.reshape(-1)[:target_len].astype(np.float32)
