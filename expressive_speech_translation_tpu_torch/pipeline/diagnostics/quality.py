"""QualityMetrics: 1–5 scores per quality dimension + neural-artifact analysis.

Parity with services/diagnostics/quality_metrics.py (:31 — robotic /
pronunciation / clarity / noise / consistency / balance scores on a 1–5 scale)
and the monolith's ``analyze_neural_synthesis_artifacts`` /
``_measure_metallic_resonance`` (audio_diagnostics.py:1567, :1372). The STFTs
run on the port's ``ops`` on the card unless ``device="cpu"``.
"""

from __future__ import annotations

from typing import Dict

import numpy as np
import torch

from ...core.device import resolve_device
from ...evals.acoustic_metrics import harmonics_to_noise_ratio, track_f0
from ...ops.stft import stft
from .spectral import SpectralAnalyzer
from .temporal import TemporalAnalyzer


def _to_score(value: float, lo: float, hi: float, *, invert: bool = False) -> float:
    """Map a raw measure to the reference's 1–5 scale."""
    t = np.clip((value - lo) / max(hi - lo, 1e-9), 0.0, 1.0)
    if invert:
        t = 1.0 - t
    return float(1.0 + 4.0 * t)


class QualityMetrics:
    def __init__(self, sr: int = 16_000, *, device=None):
        self.sr = sr
        self.device = resolve_device(device)
        self.spectral = SpectralAnalyzer(sr, device=self.device)
        self.temporal = TemporalAnalyzer(sr)

    def _magnitude(self, x: np.ndarray) -> np.ndarray:
        """|STFT| [frames, bins] at n_fft 1024, hop 256, computed on the device."""
        real, imag = stft(torch.from_numpy(x).to(self.device), 1024, 256)
        return torch.sqrt(real**2 + imag**2).cpu().numpy()

    def metallic_resonance(self, audio: np.ndarray) -> float:
        """Narrow persistent high-frequency peaks → metallic score in [0,1]
        (audio_diagnostics.py:1372)."""
        mag = self._magnitude(np.asarray(audio, np.float32).reshape(-1))
        freqs = np.linspace(0, self.sr / 2, mag.shape[-1])
        high = mag[:, freqs > 2000]
        if high.size == 0 or high.mean() < 1e-9:
            return 0.0
        # persistence: per-bin mean / std — steady narrow peaks have high ratio
        persistence = high.mean(axis=0) / (high.std(axis=0) + 1e-9)
        peakiness = high.max(axis=1).mean() / (high.mean() + 1e-9)
        return float(np.clip((np.percentile(persistence, 95) / 10.0) * (peakiness / 20.0), 0, 1))

    def analyze_neural_synthesis_artifacts(self, audio: np.ndarray) -> Dict[str, float]:
        """Artifacts typical of neural vocoders (audio_diagnostics.py:1567)."""
        x = np.asarray(audio, np.float32).reshape(-1)
        f0 = track_f0(x, self.sr)
        voiced = f0[~np.isnan(f0)]
        # unnatural F0 jumps between adjacent voiced frames
        jumps = 0.0
        if voiced.size > 2:
            rel = np.abs(np.diff(voiced)) / (voiced[:-1] + 1e-9)
            jumps = float((rel > 0.2).mean())
        # spectral discontinuity: frame-to-frame band-energy flux
        mag = self._magnitude(x)
        flux = np.sqrt(((np.diff(mag, axis=0)) ** 2).sum(axis=-1))
        flux_score = float(np.percentile(flux, 95) / (np.median(flux) + 1e-9))
        return {
            "metallic_resonance": self.metallic_resonance(x),
            "f0_discontinuity": jumps,
            "spectral_flux_outliers": flux_score,
        }

    def score(self, audio: np.ndarray) -> Dict[str, float]:
        """Six 1–5 quality scores (quality_metrics.py parity)."""
        x = np.asarray(audio, np.float32).reshape(-1)
        spec = self.spectral.analyze(x)
        temp = self.temporal.analyze(x)
        hnr = harmonics_to_noise_ratio(x, self.sr)
        artifacts = self.analyze_neural_synthesis_artifacts(x)

        speech_band = spec["band_mid"] + spec["band_upper_mid"]
        noise_band = spec["band_sub_bass"] + spec["band_brilliance"]
        return {
            # low metallic resonance + low F0 jumps → less robotic
            "robotic_score": _to_score(
                artifacts["metallic_resonance"] + artifacts["f0_discontinuity"],
                0.0, 1.0, invert=True),
            # presence-band energy + rolloff → articulation proxy
            "pronunciation_score": _to_score(spec["band_presence"] + spec["band_upper_mid"], 0.0, 0.4),
            "clarity_score": _to_score(spec["centroid_hz"], 300.0, 2500.0),
            "noise_score": _to_score(hnr if np.isfinite(hnr) else 0.0, 0.0, 20.0),
            "consistency_score": _to_score(
                temp["sustain_stability"] if np.isfinite(temp["sustain_stability"]) else 0.0,
                0.0, 1.0),
            "balance_score": _to_score(speech_band / max(noise_band + speech_band, 1e-9), 0.2, 0.9),
        }
