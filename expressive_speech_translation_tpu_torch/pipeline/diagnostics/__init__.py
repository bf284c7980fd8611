"""AudioDiagnostics: post-hoc translation quality analysis.

Parity with services/diagnostics/ (modular package) + the AudioDiagnostics
monolith (services/audio_diagnostics.py, 1885 LoC): orchestration
(``analyze_translation``), quality scores, spectral/temporal analysis, language
analyzers, narrative reporting with JSON export to timestamped directories
(audio_diagnostics.py:101-106). The spectral passes run on the card unless
``device="cpu"``; the rest is numpy, as in the JAX package.
"""

from __future__ import annotations

import json
import logging
import time
from pathlib import Path
from typing import Any, Dict, Optional

import numpy as np

from .languages import LANGUAGE_ANALYZERS, analyze_language, detail_language
from .neural import analyze_neural_synthesis_artifacts, measure_metallic_resonance
from .quality import QualityMetrics
from .spectral import SpectralAnalyzer
from .temporal import TemporalAnalyzer

log = logging.getLogger(__name__)

__all__ = [
    "AudioDiagnostics",
    "LANGUAGE_ANALYZERS",
    "QualityMetrics",
    "SpectralAnalyzer",
    "TemporalAnalyzer",
    "analyze_language",
    "analyze_neural_synthesis_artifacts",
    "detail_language",
    "measure_metallic_resonance",
]


class AudioDiagnostics:
    def __init__(self, sr: int = 16_000, output_dir: Optional[str | Path] = None, *,
                 device=None):
        self.sr = sr
        self.output_dir = Path(output_dir) if output_dir else None
        self.quality = QualityMetrics(sr, device=device)
        self.spectral = SpectralAnalyzer(sr, device=self.quality.device)
        self.temporal = TemporalAnalyzer(sr)

    def analyze_translation(
        self,
        translated: np.ndarray,
        source: Optional[np.ndarray] = None,
        *,
        language: str = "default",
        save: bool = False,
    ) -> Dict[str, Any]:
        """Full analysis (diagnostics/base.py:31 orchestration)."""
        report: Dict[str, Any] = {
            "quality": self.quality.score(translated),
            "spectral": self.spectral.analyze(translated),
            "temporal": {
                k: v for k, v in self.temporal.analyze(translated).items() if k != "segments"
            },
            "artifacts": self.quality.analyze_neural_synthesis_artifacts(translated),
            # deep specialist pass (audio_diagnostics.py:1567/:1372)
            "neural": analyze_neural_synthesis_artifacts(translated, self.sr),
            "language": analyze_language(translated, language, self.sr),
            # nested per-phenomenon report with the reference's key trees
            # (language_analysis/{language}.py analyze() structures)
            "language_detail": detail_language(translated, language, self.sr),
        }
        if source is not None:
            src_t = self.temporal.analyze(source)
            report["comparison"] = {
                "duration_ratio": round(len(translated) / max(len(source), 1), 3),
                "speech_ratio_delta": round(
                    report["temporal"]["speech_ratio"] - src_t["speech_ratio"], 3
                ),
                "segment_count_delta": report["temporal"]["n_segments"] - src_t["n_segments"],
            }
        report["narrative"] = self.narrative(report)
        if save and self.output_dir:
            ts = time.strftime("%Y%m%d_%H%M%S")
            out = self.output_dir / ts
            out.mkdir(parents=True, exist_ok=True)
            (out / "diagnostics.json").write_text(json.dumps(report, indent=2, default=float))
            if source is not None:
                # diagnostic figure (audio_diagnostics.py:1515 visualization pass)
                from .visualize import render_report_png

                try:
                    render_report_png(source, translated, out / "diagnostics.png",
                                      sr=self.sr, report=report)
                except Exception:  # noqa: BLE001 — plots must not kill reports
                    log.exception("diagnostic figure rendering failed")
            log.info("diagnostics saved to %s", out)
        return report

    @staticmethod
    def narrative(report: Dict[str, Any]) -> str:
        """Human-readable summary (reporting.py:12 ReportGenerator parity)."""
        q = report["quality"]
        lines = []
        worst = min(q, key=q.get)
        best = max(q, key=q.get)
        lines.append(
            f"Overall quality {np.mean(list(q.values())):.1f}/5 "
            f"(strongest: {best.replace('_score', '')} {q[best]:.1f}, "
            f"weakest: {worst.replace('_score', '')} {q[worst]:.1f})."
        )
        a = report["artifacts"]
        if a["metallic_resonance"] > 0.5:
            lines.append("Metallic resonance detected — possible vocoder artifacts.")
        if a["f0_discontinuity"] > 0.3:
            lines.append("Pitch track is discontinuous — prosody may sound unnatural.")
        t = report["temporal"]
        lines.append(
            f"{t['n_segments']} speech segment(s), {t['pause_count']} pause(s), "
            f"speech ratio {t['speech_ratio']:.2f}."
        )
        if report.get("comparison"):
            c = report["comparison"]
            lines.append(
                f"Duration ratio vs source: {c['duration_ratio']:.2f}; "
                f"speech-ratio delta {c['speech_ratio_delta']:+.2f}."
            )
        if report.get("language"):
            top = max(report["language"], key=report["language"].get)
            lines.append(f"Language analysis: strongest trait '{top}' "
                         f"({report['language'][top]:.2f}).")
        return " ".join(lines)

    def diagnose_translation_quality(self, translated: np.ndarray, **kw) -> str:
        """Narrative-only entry point (audio_diagnostics.py:1421 parity)."""
        return self.analyze_translation(translated, **kw)["narrative"]
