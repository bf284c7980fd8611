"""Shared phonetic measurement primitives for the per-language analyzers.

Host-side numpy: diagnostics are offline per-clip analysis (the reference
computes them with torch on CPU inside Flask handlers —
services/audio_diagnostics.py). Every function returns plain floats/arrays.
"""

from __future__ import annotations

from typing import List, Tuple

import numpy as np


def frame_spectra(
    audio: np.ndarray, sr: int = 16_000, n_fft: int = 1024, hop: int = 256,
) -> Tuple[np.ndarray, np.ndarray]:
    """Magnitude spectrogram [frames, bins] + bin frequencies."""
    x = np.asarray(audio, np.float32).reshape(-1)
    if len(x) < n_fft:
        x = np.pad(x, (0, n_fft - len(x)))
    n = 1 + (len(x) - n_fft) // hop
    idx = np.arange(n)[:, None] * hop + np.arange(n_fft)[None, :]
    win = np.hanning(n_fft).astype(np.float32)
    mag = np.abs(np.fft.rfft(x[idx] * win, axis=-1)).astype(np.float32)
    freqs = np.linspace(0, sr / 2, mag.shape[-1])
    return mag, freqs


def band_energy(mag: np.ndarray, freqs: np.ndarray, lo: float, hi: float) -> np.ndarray:
    """Per-frame power in [lo, hi) Hz."""
    sel = (freqs >= lo) & (freqs < hi)
    return (mag[:, sel] ** 2).sum(axis=-1)


def frame_energy(audio: np.ndarray, frame: int = 256, hop: int = 128) -> np.ndarray:
    x = np.asarray(audio, np.float32).reshape(-1)
    n = max((len(x) - frame) // hop + 1, 0)
    if n == 0:
        return np.zeros(0, np.float32)
    idx = np.arange(n)[:, None] * hop + np.arange(frame)[None, :]
    return np.sqrt((x[idx] ** 2).mean(axis=-1))


def voiced_mask(audio: np.ndarray, sr: int = 16_000) -> np.ndarray:
    """Per-frame voicing decision (f0 trackable)."""
    from ...evals.acoustic_metrics import track_f0

    return ~np.isnan(track_f0(audio, sr))


def voiced_run_durations(audio: np.ndarray, sr: int = 16_000,
                         hop: int = 256) -> np.ndarray:
    """Durations (s) of contiguous voiced runs — vowel-length proxy."""
    v = voiced_mask(audio, sr)
    runs: List[int] = []
    cur = 0
    for on in v:
        if on:
            cur += 1
        elif cur:
            runs.append(cur)
            cur = 0
    if cur:
        runs.append(cur)
    return np.asarray(runs, np.float32) * hop / sr


def modulation_strength(
    audio: np.ndarray, sr: int, mod_lo: float, mod_hi: float,
    *, env_rate: float = 200.0,
) -> float:
    """Amplitude-modulation energy in [mod_lo, mod_hi] Hz relative to total
    modulation energy (trills ≈ 20-35 Hz, gemination closures ≈ 2-8 Hz)."""
    x = np.asarray(audio, np.float32).reshape(-1)
    hop = max(int(sr / env_rate), 1)
    n = len(x) // hop
    if n < 16:
        return 0.0
    env = np.sqrt((x[: n * hop].reshape(n, hop) ** 2).mean(axis=-1))
    env = env - env.mean()
    spec = np.abs(np.fft.rfft(env * np.hanning(len(env))))
    f = np.linspace(0, env_rate / 2, len(spec))
    band = (spec[(f >= mod_lo) & (f < mod_hi)] ** 2).sum()
    total = (spec[f >= 1.0] ** 2).sum() + 1e-12
    return float(band / total)


def syllable_peaks(audio: np.ndarray, sr: int = 16_000) -> np.ndarray:
    """Syllable-nucleus times (s) from smoothed energy peaks."""
    env = frame_energy(audio)
    if env.size < 8:
        return np.zeros(0)
    k = 5
    smooth = np.convolve(env, np.ones(k) / k, mode="same")
    thr = smooth.max() * 0.25
    peaks = []
    for i in range(1, len(smooth) - 1):
        if smooth[i] > thr and smooth[i] >= smooth[i - 1] and smooth[i] > smooth[i + 1]:
            if not peaks or i - peaks[-1] > 6:  # ≥ ~50 ms apart
                peaks.append(i)
    return np.asarray(peaks, np.float32) * 128 / sr


def spectral_peaks(frame_mag: np.ndarray, freqs: np.ndarray,
                   *, min_prominence: float = 3.0) -> np.ndarray:
    """Peak frequencies of one (averaged) magnitude spectrum, in Hz.
    Prominence is measured in dB against the local median."""
    db = 20.0 * np.log10(frame_mag + 1e-9)
    k = 15
    med = np.convolve(db, np.ones(k) / k, mode="same")
    prom = db - med
    out = []
    for i in range(2, len(db) - 2):
        if (db[i] > db[i - 1] and db[i] >= db[i + 1]
                and prom[i] > min_prominence):
            out.append(freqs[i])
    return np.asarray(out)
