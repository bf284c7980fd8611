"""Acoustic/expressivity metrics: F0 statistics, intensity, HNR, AV-sync and
speaker similarity (the JAX package's ``evals/acoustic_metrics.py``).

Working re-implementation of the reference's evaluation template metrics
(Evaluation/analyze_outputs.py — a WIP with syntax/name errors; SURVEY.md repo-
health notes): librosa.pyin F0 mean/std → autocorrelation F0 tracker; RMS
intensity (:141-173); HNR via harmonic/percussive split → autocorrelation
harmonicity; AV-sync = Pearson correlation of mouth activity vs audio envelope
(:277-370, the MediaPipe mouth-opening metric, using our visual detector).
The signal metrics are numpy, as in the JAX package; speaker similarity runs
the port's ECAPA on the card unless ``device="cpu"``.
"""

from __future__ import annotations

import functools
from typing import Dict, List, Sequence

import numpy as np
import torch

from ..core.device import resolve_device
from ..models import ecapa


def track_f0(
    audio: np.ndarray, sr: int = 16_000, *, fmin: float = 65.0, fmax: float = 400.0,
    frame: int = 1024, hop: int = 256, voicing_threshold: float = 0.3,
) -> np.ndarray:
    """Autocorrelation F0 per frame; unvoiced frames are NaN. [T] → [frames]."""
    x = np.asarray(audio, np.float32).reshape(-1)
    n_frames = max((len(x) - frame) // hop + 1, 0)
    lag_min = int(sr / fmax)
    lag_max = min(int(sr / fmin), frame - 1)
    out = np.full(n_frames, np.nan, np.float32)
    for i in range(n_frames):
        seg = x[i * hop: i * hop + frame]
        seg = seg - seg.mean()
        energy = float(np.sum(seg**2))
        if energy < 1e-6:
            continue
        ac = np.correlate(seg, seg, mode="full")[frame - 1:]
        ac = ac / (ac[0] + 1e-12)
        window = ac[lag_min:lag_max]
        if window.size == 0:
            continue
        peak = int(np.argmax(window)) + lag_min
        if ac[peak] >= voicing_threshold:
            out[i] = sr / peak
    return out


def f0_statistics(audio: np.ndarray, sr: int = 16_000) -> Dict[str, float]:
    f0 = track_f0(audio, sr)
    voiced = f0[~np.isnan(f0)]
    if voiced.size == 0:
        return {"f0_mean": float("nan"), "f0_std": float("nan"), "voiced_ratio": 0.0}
    return {
        "f0_mean": float(voiced.mean()),
        "f0_std": float(voiced.std()),
        "voiced_ratio": float(voiced.size / max(f0.size, 1)),
    }


def rms_intensity(audio: np.ndarray) -> Dict[str, float]:
    x = np.asarray(audio, np.float32).reshape(-1)
    frame = 512
    n = len(x) // frame
    if n == 0:
        return {"rms_mean_db": float("-inf"), "rms_std_db": 0.0}
    rms = np.sqrt((x[: n * frame].reshape(n, frame) ** 2).mean(axis=1) + 1e-12)
    db = 20 * np.log10(rms)
    return {"rms_mean_db": float(db.mean()), "rms_std_db": float(db.std())}


def harmonics_to_noise_ratio(audio: np.ndarray, sr: int = 16_000) -> float:
    """HNR (dB) from the voiced-frame autocorrelation peak:
    HNR = 10·log10(r / (1 − r)) averaged over voiced frames."""
    x = np.asarray(audio, np.float32).reshape(-1)
    frame, hop = 1024, 256
    lag_min, lag_max = sr // 400, min(sr // 65, frame - 1)
    ratios: List[float] = []
    for i in range(max((len(x) - frame) // hop + 1, 0)):
        seg = x[i * hop: i * hop + frame]
        seg = seg - seg.mean()
        if float(np.sum(seg**2)) < 1e-6:
            continue
        ac = np.correlate(seg, seg, mode="full")[frame - 1:]
        ac = ac / (ac[0] + 1e-12)
        r = float(np.max(ac[lag_min:lag_max])) if lag_max > lag_min else 0.0
        if r > 0.3:
            ratios.append(min(max(r, 1e-6), 1 - 1e-6))
    if not ratios:
        return float("nan")
    r = float(np.mean(ratios))
    return 10.0 * np.log10(r / (1.0 - r))


def audio_envelope(audio: np.ndarray, sr: int, target_rate: float) -> np.ndarray:
    """RMS envelope resampled to ``target_rate`` points/second."""
    x = np.asarray(audio, np.float32).reshape(-1)
    hop = max(int(sr / target_rate), 1)
    n = len(x) // hop
    if n == 0:
        return np.zeros(0, np.float32)
    return np.sqrt((x[: n * hop].reshape(n, hop) ** 2).mean(axis=1))


def av_sync_correlation(
    audio: np.ndarray, sr: int, mouth_activity: Sequence[float], activity_rate: float
) -> float:
    """Pearson correlation between mouth-opening activity and the audio
    envelope (analyze_outputs.py:277-370 parity, via our visual detector)."""
    env = audio_envelope(audio, sr, activity_rate)
    act = np.asarray(mouth_activity, np.float32)
    n = min(len(env), len(act))
    if n < 4:
        return float("nan")
    a, b = env[:n], act[:n]
    if a.std() < 1e-9 or b.std() < 1e-9:
        return 0.0
    return float(np.corrcoef(a, b)[0, 1])


DEFAULT_ECAPA_SEED = 0


@functools.lru_cache(maxsize=4)
def _default_ecapa(cfg: ecapa.EcapaConfig, device: torch.device):
    return ecapa.init_ecapa(DEFAULT_ECAPA_SEED, cfg, device)


def speaker_similarity(audio_a: np.ndarray, audio_b: np.ndarray, *, params=None, cfg=None,
                       device=None) -> float:
    """ECAPA cosine similarity of two 16 kHz waveforms, each cut to the
    shorter one and to 20 s (analyze_outputs.py:113-121 parity via
    models/ecapa), on ``device`` (the card unless ``device="cpu"``; ``params``
    must lie there).

    With no ``params``, random weights are used: fine for relative
    comparisons, not for absolute scores. The JAX package draws them from
    ``PRNGKey(0)`` on every call; torch cannot reproduce those numbers, so the
    port draws a seeded torch tree (``init_ecapa(DEFAULT_ECAPA_SEED)``) once
    per configuration and device and keeps it. Parity with the JAX package
    holds for a shared tree passed as ``params=``."""
    cfg = cfg or ecapa.EcapaConfig()
    dev = resolve_device(device)
    if params is None:
        params = _default_ecapa(cfg, dev)
    n = min(len(audio_a), len(audio_b), 16_000 * 20)
    batch = np.stack([np.asarray(audio_a, np.float32)[:n], np.asarray(audio_b, np.float32)[:n]])
    with torch.no_grad():
        e = ecapa.embed_audio(params, cfg, torch.from_numpy(batch).to(dev))
        return float(ecapa.cosine_similarity(e[0], e[1]))
