"""Speech-emotion classification (the port's copy of the JAX package's
``evals/ser.py``, over the port's acoustic metrics).

The reference classifies emotion with a pre-trained HF audio-classification
pipeline (Evaluation/analyze_outputs.py:125-138, ``superb/wav2vec2``-style
SER). Two paths here:

1. **Label-compatible HF path** — when ``EST_SER_MODEL`` points to a LOCAL
   HF audio-classification checkpoint dir (transformers is baked into this
   image; weights are mounted, never downloaded), the exact reference
   pipeline runs and emits the model's own labels.
2. **Acoustic proxy** — otherwise, the classic dimensional-SER recipe maps
   prosodic features to arousal/valence quadrants (high F0 + high energy →
   angry/happy split by F0 variability; low F0 + low energy → sad; mid →
   neutral). Documented stand-in, good for *relative* comparisons between a
   system's outputs (the MCF-vs-Seamless study's use), not absolute accuracy.
"""

from __future__ import annotations

import logging
import os
from typing import Dict, Optional

import numpy as np

from .acoustic_metrics import f0_statistics, rms_intensity

log = logging.getLogger(__name__)

LABELS = ("neutral", "happy", "sad", "angry")

_hf_pipeline = None
_hf_tried = False


def hf_ser_pipeline():
    """Lazy HF audio-classification pipeline from a local checkpoint
    (analyze_outputs.py:125-138 parity) — None when no model is mounted."""
    global _hf_pipeline, _hf_tried
    if _hf_tried:
        return _hf_pipeline
    _hf_tried = True
    model_dir = os.environ.get("EST_SER_MODEL")
    if not model_dir or not os.path.isdir(model_dir):
        return None
    try:
        from transformers import pipeline

        _hf_pipeline = pipeline("audio-classification", model=model_dir)
        log.info("SER: HF audio-classification pipeline from %s", model_dir)
    except Exception as e:  # noqa: BLE001 — fall back to the proxy
        log.warning("SER: HF pipeline load failed (%s); using acoustic proxy", e)
    return _hf_pipeline


def emotion_features(audio: np.ndarray, sr: int = 16_000) -> Dict[str, float]:
    """Arousal/valence coordinates from prosody (each roughly in [0, 1])."""
    audio = np.asarray(audio, np.float32).reshape(-1)
    f0 = f0_statistics(audio, sr)
    # arousal: energy + pitch height; valence: pitch variability (melodic
    # speech reads positive, monotone high-energy reads negative)
    f0_mean = float(np.nan_to_num(f0.get("f0_mean", 0.0)))
    f0_std = float(np.nan_to_num(f0.get("f0_std", 0.0)))
    energy = float(np.sqrt(np.mean(audio**2))) if audio.size else 0.0
    arousal = float(np.clip(0.5 * np.tanh((energy - 0.05) * 15.0) + 0.5
                            * np.tanh((f0_mean - 160.0) / 80.0), -1, 1)) * 0.5 + 0.5
    valence = float(np.tanh((f0_std - 15.0) / 25.0)) * 0.5 + 0.5
    return {"arousal": arousal, "valence": valence,
            "f0_mean": f0_mean, "f0_std": f0_std, "energy": energy}


def classify_audio_emotion(audio: np.ndarray, sr: int = 16_000) -> str:
    """Emotion label: the mounted HF pipeline's top label when available
    (reference-exact), the prosody-quadrant stand-in otherwise."""
    pipe = hf_ser_pipeline()
    if pipe is not None:
        try:
            preds = pipe({"array": np.asarray(audio, np.float32).reshape(-1),
                          "sampling_rate": sr})
            if preds:
                return str(preds[0]["label"])
        except Exception:  # noqa: BLE001 — fall back to the proxy
            log.exception("HF SER pipeline failed; using acoustic proxy")
    feats = emotion_features(audio, sr)
    if feats["energy"] < 1e-4:
        return "no_prediction"
    high_arousal = feats["arousal"] > 0.55
    positive = feats["valence"] > 0.5
    if high_arousal:
        return "happy" if positive else "angry"
    return "neutral" if positive or feats["arousal"] > 0.35 else "sad"
