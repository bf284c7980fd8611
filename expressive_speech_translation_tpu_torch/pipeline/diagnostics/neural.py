"""Neural-synthesis artifact analysis (the reference monolith's specialist
passes: ``analyze_neural_synthesis_artifacts`` audio_diagnostics.py:1567-1619
and ``_measure_metallic_resonance`` :1372-1419).

Host numpy over a high-resolution STFT (n_fft 4096 / hop 512 — the same
resolution the reference uses), producing the same report structure:

- metallic resonance: harmonic-peak regularity, sharp spectral spike count,
  persistent narrowband resonance bands, temporal stability, severity
- voice coherence: spectral-peak (formant-proxy) stability, voice breaks,
  timbre continuity (frame-to-frame spectral correlation)
- synthesis artifacts: oversmoothing (high-band variance deficit),
  artificial resonances (metallic severity)
- naturalness: micro-prosody (F0 jitter), energy micro-variation

Each block carries a human-readable description, mirroring the reference's
troubleshooting-report style.
"""

from __future__ import annotations

from typing import Any, Dict, List

import numpy as np

from . import phonetics as ph


def _hires_spectra(audio: np.ndarray, sr: int):
    return ph.frame_spectra(audio, sr, n_fft=4096, hop=512)


def measure_metallic_resonance(audio: np.ndarray, sr: int = 16_000) -> Dict[str, Any]:
    """audio_diagnostics.py:1372-1419 parity: harmonic regularity, spectral
    spikes, resonance bands, temporal stability → severity in [0, 1]."""
    mag, freqs = _hires_spectra(audio, sr)
    if mag.shape[0] < 4:
        return {"measurements": {}, "severity": 0.0, "description": ""}
    mean_spec = mag.mean(axis=0)

    peaks = ph.spectral_peaks(mean_spec, freqs, min_prominence=6.0)
    peaks = peaks[(peaks > 100) & (peaks < sr / 2 - 200)]
    if len(peaks) >= 3:
        spacing = np.diff(peaks)
        regularity = float(np.clip(1.0 - spacing.std() / (spacing.mean() + 1e-9), 0, 1))
    else:
        regularity = 0.0

    spikes = int(len(ph.spectral_peaks(mean_spec, freqs, min_prominence=12.0)))

    # persistent narrowband ridges: bins whose energy stays high across time
    norm = mag / (mag.max(axis=-1, keepdims=True) + 1e-12)
    persistent = (norm > 0.5).mean(axis=0)
    band_bins = np.nonzero(persistent > 0.8)[0]
    resonance_bands: List[float] = []
    if len(band_bins):
        splits = np.split(band_bins, np.nonzero(np.diff(band_bins) > 2)[0] + 1)
        resonance_bands = [float(freqs[int(np.mean(s))]) for s in splits if len(s)]

    peak_bin_per_frame = mag.argmax(axis=-1)
    stability = float(np.clip(1.0 - np.std(peak_bin_per_frame) /
                              (np.mean(peak_bin_per_frame) + 1e-9), 0, 1))

    measurements = {
        "harmonic_regularity": regularity,
        "spectral_spikes": spikes,
        "resonance_bands": resonance_bands,
        "temporal_stability": stability,
    }
    severity = float(np.clip(
        0.4 * regularity + 0.3 * min(spikes / 12.0, 1.0)
        + 0.2 * min(len(resonance_bands) / 4.0, 1.0) + 0.1 * stability, 0, 1))

    description = []
    if regularity > 0.8:
        description.append("Highly regular harmonic structure suggesting artificial resonance")
    if spikes > 10:
        description.append("Multiple sharp spectral peaks indicating metallic artifacts")
    if len(resonance_bands) > 3:
        description.append("Multiple resonance bands contributing to synthetic timbre")
    return {"measurements": measurements, "severity": severity,
            "description": ". ".join(description)}


def _voice_breaks(audio: np.ndarray, sr: int) -> int:
    """Unvoiced gaps inside energetic regions (synthesis dropouts)."""
    v = ph.voiced_mask(audio, sr)
    env = ph.frame_energy(audio, frame=256, hop=256)
    n = min(len(v), len(env))
    active = env[:n] > 0.2 * (env[:n].max() + 1e-12)
    breaks = 0
    in_break = False
    for on, voiced in zip(active, v[:n]):
        if on and not voiced:
            if not in_break:
                breaks += 1
                in_break = True
        else:
            in_break = False
    return breaks


def _timbre_continuity(mag: np.ndarray) -> float:
    """Median frame-to-frame spectral correlation (timbre stability)."""
    if mag.shape[0] < 3:
        return 1.0
    a = mag[:-1]
    b = mag[1:]
    num = (a * b).sum(axis=-1)
    den = np.linalg.norm(a, axis=-1) * np.linalg.norm(b, axis=-1) + 1e-12
    return float(np.median(num / den))


def _oversmoothing(mag: np.ndarray, freqs: np.ndarray) -> float:
    """High-band (3-7 kHz) temporal-variance deficit relative to the low
    band: oversmoothed neural output lacks high-frequency detail motion."""
    lo = ph.band_energy(mag, freqs, 300, 1500)
    hi = ph.band_energy(mag, freqs, 3000, 7000)
    lo_var = np.std(np.log10(lo + 1e-12))
    hi_var = np.std(np.log10(hi + 1e-12))
    if lo_var < 1e-6:
        return 0.0
    return float(np.clip(1.0 - hi_var / lo_var, 0, 1))


def _micro_prosody(audio: np.ndarray, sr: int) -> float:
    """F0 jitter: natural voices carry ~0.5-2 % cycle-to-cycle variation;
    neural synthesis often flattens it. Returns the jitter ratio."""
    from ...evals.acoustic_metrics import track_f0

    f0 = track_f0(audio, sr)
    voiced = f0[~np.isnan(f0)]
    if voiced.size < 6:
        return 0.0
    return float(np.abs(np.diff(voiced)).mean() / (voiced.mean() + 1e-9))


def analyze_neural_synthesis_artifacts(
    audio: np.ndarray, sr: int = 16_000,
) -> Dict[str, Any]:
    """audio_diagnostics.py:1567-1619 parity: the four-block report."""
    audio = np.asarray(audio, np.float32).reshape(-1)
    mag, freqs = _hires_spectra(audio, sr)
    metallic = measure_metallic_resonance(audio, sr)

    coherence = {
        "voice_breaks": _voice_breaks(audio, sr),
        "timbre_continuity": _timbre_continuity(mag),
        "formant_stability": metallic["measurements"].get("temporal_stability", 0.0),
    }
    artifacts = {
        "oversmoothing": _oversmoothing(mag, freqs),
        "artificial_resonances": metallic["severity"],
        "metallic": metallic,
    }
    naturalness = {
        "micro_prosody": _micro_prosody(audio, sr),
        "energy_variation": float(np.std(ph.frame_energy(audio))
                                  / (np.mean(ph.frame_energy(audio)) + 1e-9)),
    }

    descriptions = []
    if coherence["voice_breaks"] > 3:
        descriptions.append("Frequent voice breaks suggest synthesis dropouts")
    if coherence["timbre_continuity"] < 0.6:
        descriptions.append("Unstable timbre between frames")
    if artifacts["oversmoothing"] > 0.6:
        descriptions.append("High-frequency detail deficit typical of oversmoothed synthesis")
    if metallic["description"]:
        descriptions.append(metallic["description"])
    if naturalness["micro_prosody"] < 0.002:
        descriptions.append("Unnaturally flat micro-prosody (missing F0 jitter)")

    return {
        "voice_coherence": coherence,
        "synthesis_artifacts": artifacts,
        "naturalness_metrics": naturalness,
        "detailed_descriptions": ". ".join(descriptions),
    }
