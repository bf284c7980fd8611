"""Evaluation metrics: the acoustic battery of the JAX package's
``evals/acoustic_metrics.py`` (F0, intensity, HNR, AV-sync, speaker
similarity over the port's ECAPA)."""

from .acoustic_metrics import (
    av_sync_correlation,
    f0_statistics,
    harmonics_to_noise_ratio,
    rms_intensity,
    speaker_similarity,
    track_f0,
)

__all__ = [
    "av_sync_correlation",
    "f0_statistics",
    "harmonics_to_noise_ratio",
    "rms_intensity",
    "speaker_similarity",
    "track_f0",
]
