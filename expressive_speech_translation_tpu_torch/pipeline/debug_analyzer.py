"""AudioDebugAnalyzer: content-span / silence / chunk analysis for temporal
mapping debugging.

Parity with services/audio_debug_analyzer.py (260 LoC): content-span detection,
silence accounting, chunk analysis, before/after comparison used inside the
cascaded backend's temporal mapping (:22-79; cascaded_backend.py:243-265).
"""

from __future__ import annotations

import logging
from typing import Any, Dict

import numpy as np

log = logging.getLogger(__name__)


class AudioDebugAnalyzer:
    def __init__(self, sr: int = 16_000, frame: int = 512, silence_db: float = -40.0):
        self.sr, self.frame, self.silence_db = sr, frame, silence_db

    def analyze(self, audio: np.ndarray, label: str = "") -> Dict[str, Any]:
        x = np.asarray(audio, np.float32).reshape(-1)
        n = len(x) // self.frame
        if n == 0:
            return {"label": label, "duration_s": 0.0, "content_spans": [],
                    "silence_ratio": 1.0, "n_chunks": 0}
        rms = np.sqrt((x[: n * self.frame].reshape(n, self.frame) ** 2).mean(axis=1) + 1e-12)
        db = 20 * np.log10(rms)
        active = db > self.silence_db
        dt = self.frame / self.sr

        spans, start = [], None
        for i, on in enumerate(active):
            if on and start is None:
                start = i
            elif not on and start is not None:
                spans.append({"start": round(start * dt, 3), "end": round(i * dt, 3)})
                start = None
        if start is not None:
            spans.append({"start": round(start * dt, 3), "end": round(n * dt, 3)})

        report = {
            "label": label,
            "duration_s": round(len(x) / self.sr, 3),
            "content_spans": spans,
            "n_chunks": len(spans),
            "content_s": round(sum(s["end"] - s["start"] for s in spans), 3),
            "silence_ratio": round(float(1.0 - active.mean()), 3),
            "peak": round(float(np.abs(x).max()), 4),
            "rms_db": round(float(20 * np.log10(np.sqrt((x**2).mean()) + 1e-12)), 1),
        }
        log.debug("audio debug [%s]: %s", label, report)
        return report

    def compare(self, before: np.ndarray, after: np.ndarray) -> Dict[str, Any]:
        """Before/after temporal-mapping comparison (audio_debug_analyzer.py:22-79)."""
        a = self.analyze(before, "before")
        b = self.analyze(after, "after")
        return {
            "before": a,
            "after": b,
            "duration_delta_s": round(b["duration_s"] - a["duration_s"], 3),
            "chunk_delta": b["n_chunks"] - a["n_chunks"],
            "silence_delta": round(b["silence_ratio"] - a["silence_ratio"], 3),
        }
