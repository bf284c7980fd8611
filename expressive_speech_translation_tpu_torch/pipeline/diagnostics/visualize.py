"""Diagnostic visualizations (audio_diagnostics.py:1515-1566
``_prepare_diagnostic_visualizations``): waveform comparison with problem-area
marks, spectrograms with difference panel, pitch/energy prosody contours, and
a quality-score bar panel — rendered to one PNG per report via matplotlib
(Agg backend; import is lazy so headless serving never pays for it).

The data-preparation half (:1520-1560) is also exposed standalone
(:func:`visualization_data`) so UIs can render their own plots from the same
numbers.
"""

from __future__ import annotations

import logging
from pathlib import Path
from typing import Any, Dict, Optional

import numpy as np

from . import phonetics as ph

log = logging.getLogger(__name__)


def _pitch_contour(audio: np.ndarray, sr: int) -> np.ndarray:
    from ...evals.acoustic_metrics import track_f0

    return track_f0(np.asarray(audio, np.float32).reshape(-1), sr)


def _spectrogram_db(audio: np.ndarray, sr: int) -> np.ndarray:
    mag, _ = ph.frame_spectra(audio, sr, n_fft=1024, hop=256)
    return 20.0 * np.log10(mag.T + 1e-9)  # [bins, frames]


def visualization_data(
    source: np.ndarray, translated: np.ndarray, *, sr: int = 16_000,
    report: Optional[Dict[str, Any]] = None,
) -> Dict[str, Any]:
    """The reference's visualization payload (:1523-1560): waveforms,
    spectrograms + difference, pitch/energy contours, quality metrics."""
    source = np.asarray(source, np.float32).reshape(-1)
    translated = np.asarray(translated, np.float32).reshape(-1)
    spec_s = _spectrogram_db(source, sr)
    spec_t = _spectrogram_db(translated, sr)
    n = min(spec_s.shape[1], spec_t.shape[1])
    energy_s = ph.frame_energy(source)
    energy_t = ph.frame_energy(translated)
    # problem areas: frames that deviate hard from the ACTIVE-speech envelope
    # statistics (dropouts inside speech / blowups) — silence-dominated clips
    # must not flag their own speech as anomalous
    active = energy_t > 0.1 * (energy_t.max() + 1e-12)
    med = np.median(energy_t[active]) + 1e-9 if active.any() else 1e-9
    blowup = energy_t > 6.0 * med
    dropout = active.copy()
    # dropouts: near-zero frames sandwiched inside active speech
    if active.any():
        first, last = np.argmax(active), len(active) - np.argmax(active[::-1]) - 1
        inside = np.zeros_like(active)
        inside[first:last + 1] = True
        dropout = inside & (energy_t < 0.02 * med)
    problems = np.nonzero(blowup | dropout)[0]
    return {
        "waveform_comparison": {
            "source": source, "translated": translated,
            "problem_frames": problems, "frame_hop": 128,
        },
        "spectral_analysis": {
            "source_db": spec_s, "translated_db": spec_t,
            "difference_db": spec_t[:, :n] - spec_s[:, :n],
        },
        "prosody_visualization": {
            "pitch_source": _pitch_contour(source, sr),
            "pitch_translated": _pitch_contour(translated, sr),
            "energy_source": energy_s, "energy_translated": energy_t,
        },
        "quality_metrics": (report or {}).get("quality", {}),
    }


def render_report_png(
    source: np.ndarray, translated: np.ndarray, out_path: str | Path,
    *, sr: int = 16_000, report: Optional[Dict[str, Any]] = None,
) -> Path:
    """Render the full diagnostic figure to ``out_path``; returns the path."""
    import matplotlib

    matplotlib.use("Agg")
    import matplotlib.pyplot as plt

    data = visualization_data(source, translated, sr=sr, report=report)
    fig, axes = plt.subplots(3, 2, figsize=(12, 9), constrained_layout=True)

    wf = data["waveform_comparison"]
    t_s = np.arange(len(wf["source"])) / sr
    t_t = np.arange(len(wf["translated"])) / sr
    axes[0, 0].plot(t_s, wf["source"], lw=0.4)
    axes[0, 0].set_title("source waveform")
    axes[0, 1].plot(t_t, wf["translated"], lw=0.4, color="tab:orange")
    for f in wf["problem_frames"][:200]:
        axes[0, 1].axvspan(f * wf["frame_hop"] / sr,
                           (f + 1) * wf["frame_hop"] / sr,
                           color="red", alpha=0.25, lw=0)
    axes[0, 1].set_title("translated waveform (problem areas marked)")

    sp = data["spectral_analysis"]
    axes[1, 0].imshow(sp["source_db"], origin="lower", aspect="auto", cmap="magma")
    axes[1, 0].set_title("source spectrogram (dB)")
    axes[1, 1].imshow(sp["translated_db"], origin="lower", aspect="auto", cmap="magma")
    axes[1, 1].set_title("translated spectrogram (dB)")

    pr = data["prosody_visualization"]
    axes[2, 0].plot(pr["pitch_source"], label="source")
    axes[2, 0].plot(pr["pitch_translated"], label="translated")
    axes[2, 0].set_title("pitch contours (Hz)")
    axes[2, 0].legend(fontsize=8)

    q = data["quality_metrics"]
    if q:
        names = list(q)
        axes[2, 1].barh(range(len(names)), [q[k] for k in names], color="tab:blue")
        axes[2, 1].set_yticks(range(len(names)),
                              [n.replace("_score", "") for n in names], fontsize=8)
        axes[2, 1].set_xlim(0, 5)
        axes[2, 1].set_title("quality scores (1-5)")
    else:
        axes[2, 1].plot(pr["energy_source"], label="source")
        axes[2, 1].plot(pr["energy_translated"], label="translated")
        axes[2, 1].set_title("energy contours")
        axes[2, 1].legend(fontsize=8)

    out = Path(out_path)
    out.parent.mkdir(parents=True, exist_ok=True)
    fig.savefig(out, dpi=110)
    plt.close(fig)
    log.info("diagnostic figure written to %s", out)
    return out
