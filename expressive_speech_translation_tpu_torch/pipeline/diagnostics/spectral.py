"""SpectralAnalyzer: perceptual band energies + spectral shape + rhythm.

Parity with services/diagnostics/spectral_analysis.py (:14): seven perceptual
bands, centroid/spread/flatness/rolloff/entropy, rhythm/tempo estimate.
The STFT, flatness, rolloff and energy envelope run on the port's ``ops`` on
the card unless ``device="cpu"``; the statistics over them are numpy.
"""

from __future__ import annotations

from typing import Dict

import numpy as np
import torch

from ...core.device import resolve_device
from ...ops.dsp import energy_envelope, spectral_centroid_rolloff, spectral_flatness
from ...ops.stft import stft

PERCEPTUAL_BANDS = {
    "sub_bass": (20, 60),
    "bass": (60, 250),
    "low_mid": (250, 500),
    "mid": (500, 2000),
    "upper_mid": (2000, 4000),
    "presence": (4000, 6000),
    "brilliance": (6000, 8000),
}


class SpectralAnalyzer:
    def __init__(self, sr: int = 16_000, n_fft: int = 1024, hop: int = 256, *, device=None):
        self.sr, self.n_fft, self.hop = sr, n_fft, hop
        self.device = resolve_device(device)

    def analyze(self, audio: np.ndarray) -> Dict[str, float]:
        x = torch.from_numpy(np.asarray(audio, np.float32).reshape(-1)).to(self.device)
        real, imag = stft(x, self.n_fft, self.hop)
        mag = torch.sqrt(real**2 + imag**2).cpu().numpy()  # [frames, bins]
        power = mag**2
        freqs = np.linspace(0, self.sr / 2, mag.shape[-1])
        total = power.sum() + 1e-12

        out: Dict[str, float] = {}
        for name, (lo, hi) in PERCEPTUAL_BANDS.items():
            band = power[:, (freqs >= lo) & (freqs < hi)].sum()
            out[f"band_{name}"] = float(band / total)

        frame_total = power.sum(axis=-1) + 1e-12
        centroid = (power * freqs).sum(axis=-1) / frame_total
        spread = np.sqrt(((freqs - centroid[:, None]) ** 2 * power).sum(axis=-1) / frame_total)
        out["centroid_hz"] = float(np.median(centroid))
        out["spread_hz"] = float(np.median(spread))
        out["flatness"] = float(np.median(spectral_flatness(x).cpu().numpy()))
        _, rolloff = spectral_centroid_rolloff(x, sr=self.sr, n_fft=self.n_fft, hop=self.hop)
        out["rolloff_hz"] = float(np.median(rolloff.cpu().numpy()))

        p_norm = power / power.sum(axis=-1, keepdims=True).clip(1e-12)
        entropy = -(p_norm * np.log2(p_norm + 1e-12)).sum(axis=-1)
        out["spectral_entropy"] = float(np.median(entropy))

        # rhythm/tempo via envelope autocorrelation
        env = energy_envelope(x).cpu().numpy()
        env = env - env.mean()
        if len(env) > 8 and env.std() > 1e-9:
            ac = np.correlate(env, env, mode="full")[len(env) - 1:]
            ac /= ac[0] + 1e-12
            lo_l = max(int(0.25 * self.sr / 256), 1)
            hi_l = min(int(2.0 * self.sr / 256), len(ac) - 1)
            if hi_l > lo_l:
                peak = int(np.argmax(ac[lo_l:hi_l])) + lo_l
                out["rhythm_strength"] = float(ac[peak])
                out["tempo_bpm"] = float(60.0 / (peak * 256 / self.sr))
            else:
                out["rhythm_strength"], out["tempo_bpm"] = 0.0, float("nan")
        else:
            out["rhythm_strength"], out["tempo_bpm"] = 0.0, float("nan")
        return out
