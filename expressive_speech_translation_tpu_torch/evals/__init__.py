"""Evaluation metric battery of the JAX package's ``evals/``: the acoustic
metrics (F0, intensity, HNR, AV-sync, speaker similarity over the port's
ECAPA), the text metrics and the per-job analysis; ``ser``, ``semantic``,
``visual_metrics``, ``visual_models`` and ``verify_quality`` are modules of
their own."""

from .acoustic_metrics import (
    av_sync_correlation,
    f0_statistics,
    harmonics_to_noise_ratio,
    rms_intensity,
    speaker_similarity,
    track_f0,
)
from .analyze import analyze_outputs, analyze_single_job
from .text_metrics import chrf, corpus_bleu, sentence_bleu, token_f1

__all__ = [
    "analyze_outputs",
    "analyze_single_job",
    "av_sync_correlation",
    "chrf",
    "corpus_bleu",
    "f0_statistics",
    "harmonics_to_noise_ratio",
    "rms_intensity",
    "sentence_bleu",
    "speaker_similarity",
    "token_f1",
    "track_f0",
]
