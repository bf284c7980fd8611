"""TemporalAnalyzer: segments, attacks/decays, sustain, pause structure.

Parity with services/diagnostics/temporal_analysis.py (:11).
"""

from __future__ import annotations

from typing import Any, Dict, List

import numpy as np


class TemporalAnalyzer:
    def __init__(self, sr: int = 16_000, frame: int = 512):
        self.sr, self.frame = sr, frame

    def _envelope(self, audio: np.ndarray) -> np.ndarray:
        x = np.asarray(audio, np.float32).reshape(-1)
        n = len(x) // self.frame
        if n == 0:
            return np.zeros(0, np.float32)
        return np.sqrt((x[: n * self.frame].reshape(n, self.frame) ** 2).mean(axis=1))

    def analyze(self, audio: np.ndarray) -> Dict[str, Any]:
        env = self._envelope(audio)
        dt = self.frame / self.sr
        if env.size == 0:
            return {"segments": [], "n_segments": 0, "speech_ratio": 0.0,
                    "mean_attack_s": float("nan"), "mean_decay_s": float("nan"),
                    "sustain_stability": float("nan"), "pause_count": 0}
        thr = max(env.max() * 0.1, 1e-5)
        active = env > thr

        segments: List[Dict[str, float]] = []
        start = None
        for i, on in enumerate(active):
            if on and start is None:
                start = i
            elif not on and start is not None:
                segments.append({"start": start * dt, "end": i * dt})
                start = None
        if start is not None:
            segments.append({"start": start * dt, "end": len(active) * dt})

        attacks, decays, sustains = [], [], []
        for seg in segments:
            i0, i1 = int(seg["start"] / dt), int(seg["end"] / dt)
            seg_env = env[i0:i1]
            if seg_env.size < 3:
                continue
            peak = int(np.argmax(seg_env))
            attacks.append(peak * dt)
            decays.append((seg_env.size - peak) * dt)
            sustains.append(float(seg_env.std() / (seg_env.mean() + 1e-9)))

        pauses = 0
        for a, b in zip(segments, segments[1:]):
            if b["start"] - a["end"] > 0.25:
                pauses += 1
        return {
            "segments": segments,
            "n_segments": len(segments),
            "speech_ratio": float(active.mean()),
            "mean_attack_s": float(np.mean(attacks)) if attacks else float("nan"),
            "mean_decay_s": float(np.mean(decays)) if decays else float("nan"),
            "sustain_stability": float(1.0 / (1.0 + np.mean(sustains))) if sustains else float("nan"),
            "pause_count": pauses,
        }
