"""AudioProcessor: validation, preprocessing, music detection, enhancement.

The port of the JAX package's ``pipeline/audio_processor.py``: the validity
checks, the preprocessing chain, music detection, the per-language
enhancement table and ``process_audio`` (downmix → Kaiser resample to 16 kHz
→ spectral noise gate). The split between host and device is JAX's: the
downmix, the band ratios and the rhythm autocorrelation run in numpy on the
host; the resample, the STFT gate, the features and the enhancement run as
torch on the processor's device (the card unless ``device="cpu"``).

The length buckets stay. They are not a compile device here: they define the
result. The gate runs on the input zero-padded to its bucket, so its
reflect pad at the end reflects the bucket's zeros and the last frames differ
from an unpadded run; the quietest-frame selection sees only the
``1 + n // hop`` frames of the input.
"""

from __future__ import annotations

import dataclasses
import logging
from typing import Any, Dict, Optional, Tuple, Union

import numpy as np
import torch

from ..core.config import AudioConfig
from ..core.device import resolve_device
from ..core.errors import ValidationError
from ..ops import dsp
from ..ops.resample import resample
from ..ops.stft import stft

log = logging.getLogger(__name__)

BAND_EDGES_HZ = (0.0, 150.0, 300.0, 800.0, 1500.0, 3000.0, 5000.0, 8000.0)


@dataclasses.dataclass(frozen=True)
class LanguageParams:
    """Per-language enhancement recipe."""

    band_multipliers: Tuple[float, ...] = (1.0,) * 7
    compression_threshold: float = 0.5
    compression_ratio: float = 1.0
    formant_boost: float = 0.0


LANGUAGE_PARAMS: Dict[str, LanguageParams] = {
    # French: presence-band lift, gentle compression
    "fra": LanguageParams(
        band_multipliers=(0.95, 1.0, 1.05, 1.15, 1.2, 1.1, 1.0),
        compression_threshold=0.45, compression_ratio=1.5, formant_boost=1.1,
    ),
    # German: low-mid clarity, stronger compression
    "deu": LanguageParams(
        band_multipliers=(0.9, 1.0, 1.1, 1.2, 1.15, 1.05, 0.95),
        compression_threshold=0.4, compression_ratio=1.8, formant_boost=1.15,
    ),
    "default": LanguageParams(),
}


def _median(x: torch.Tensor) -> float:
    """numpy's median: the mean of the two middle values for an even count
    (``torch.median`` returns the lower one)."""
    s = torch.sort(x.reshape(-1)).values
    n = s.shape[0]
    return float(s[n // 2]) if n % 2 else float((s[n // 2 - 1] + s[n // 2]) / 2)


class AudioProcessor:
    SUPPORTED_FORMATS = (".wav", ".mp3", ".ogg", ".flac")
    SAMPLE_RATE = 16_000
    # request lengths in seconds at 16 kHz: the input is zero-padded to the
    # first bucket that holds it before the resample and the gate
    DENOISE_BUCKETS_S = (5, 10, 30, 60, 150, 300)

    def __init__(self, config: Optional[AudioConfig] = None, *,
                 device: Optional[Union[str, torch.device]] = None):
        self.config = config or AudioConfig()
        self.device = resolve_device(device)

    def _tensor(self, audio) -> torch.Tensor:
        return torch.from_numpy(np.asarray(audio, np.float32).reshape(-1)).to(self.device)

    # ------------------------------------------------------------- validation

    def is_valid_audio(self, audio: np.ndarray) -> Tuple[bool, str]:
        """NaN/Inf, RMS ∈ [1e-6, 1.0], |DC| < 0.1, ≥ 100 ms."""
        x = np.asarray(audio, np.float32).reshape(-1)
        if x.size < int(0.1 * self.SAMPLE_RATE):
            return False, "Audio too short (minimum 100ms)"
        if not np.isfinite(x).all():
            return False, "Audio contains NaN or Inf values"
        rms = float(np.sqrt(np.mean(x**2)))
        if rms < 1e-6:
            return False, "Audio is silent (RMS too low)"
        if rms > 1.0:
            return False, "Audio RMS too high (clipped or unnormalised)"
        if abs(float(np.mean(x))) >= 0.1:
            return False, "Audio has excessive DC offset"
        return True, "ok"

    def validate_audio_length(self, duration_seconds: float, *,
                              max_seconds: Optional[float] = None) -> None:
        limit = max_seconds if max_seconds is not None else self.config.max_audio_seconds
        if duration_seconds > limit:
            raise ValidationError(
                f"Audio is too long ({duration_seconds:.1f}s). Maximum allowed is {limit:.0f}s")
        if duration_seconds < 0.1:
            raise ValidationError("Audio is too short (minimum 100ms)")

    # ---------------------------------------------------------- preprocessing

    def preprocess_audio(self, audio: np.ndarray) -> np.ndarray:
        """DC removal → pre-emphasis 0.97 → silence gate → 0.95 peak normalize."""
        x = dsp.remove_dc(self._tensor(audio))
        x = dsp.preemphasis(x, 0.97)
        x = dsp.silence_gate(x, threshold_db=-40.0)
        x = dsp.peak_normalize(x, 0.95)
        return x.cpu().numpy()

    # -------------------------------------------------------- music detection

    def detect_background_music(self, audio: np.ndarray, sr: int = 16_000) -> Dict[str, Any]:
        """Weighted flatness / band-ratio / rhythm / stability score.
        Returns {"has_music", "confidence", "features"}."""
        x = self._tensor(audio)
        if x.shape[0] < 1024:
            # shorter than one analysis frame: no music evidence
            return {"has_music": False, "confidence": 0.0, "flatness": 0.0,
                    "bass_ratio": 0.0, "high_ratio": 0.0, "rhythm": 0.0,
                    "stability": 0.0}
        flatness = _median(dsp.spectral_flatness(x))

        real, imag = stft(x, 1024, 256)
        mag = torch.sqrt(real**2 + imag**2).cpu().numpy()
        freqs = np.linspace(0, sr / 2, mag.shape[-1])
        total = mag.sum() + 1e-8
        bass_ratio = mag[:, freqs < 250].sum() / total
        high_ratio = mag[:, freqs > 4000].sum() / total

        # rhythm: autocorrelation peaks of the energy envelope
        env = dsp.energy_envelope(x).cpu().numpy()
        env = env - env.mean()
        ac = np.correlate(env, env, mode="full")[len(env) - 1:]
        ac /= ac[0] + 1e-8
        # peaks in the 0.25–2 s lag range (30–240 BPM) at the envelope's hop
        # of 256; hi is the inclusive last lag, clamped to the envelope
        lo, hi = int(0.25 * sr / 256), min(int(2.0 * sr / 256), len(ac) - 1)
        rhythm = float(np.max(ac[lo:hi + 1])) if hi >= lo else 0.0

        # temporal stability of band energies
        frame_e = mag.sum(axis=-1)
        stability = 1.0 - float(np.std(frame_e) / (np.mean(frame_e) + 1e-8))

        confidence = float(np.clip(
            0.25 * min(flatness * 10, 1.0)
            + 0.15 * min((bass_ratio + high_ratio) * 1.5, 1.0)
            + 0.35 * np.clip((rhythm - 0.3) / 0.7, 0.0, 1.0)
            + 0.25 * np.clip(stability, 0.0, 1.0),
            0.0, 1.0,
        ))
        return {
            "has_music": confidence > 0.25,
            "confidence": confidence,
            "features": {
                "flatness": flatness, "bass_ratio": float(bass_ratio),
                "high_ratio": float(high_ratio), "rhythm": rhythm,
                "stability": stability,
            },
        }

    # ------------------------------------------------------------- main paths

    def _bucket(self, n: int, sr: int) -> int:
        """Samples of the first length bucket holding ``n`` samples at ``sr``
        (``n`` itself past the top bucket)."""
        bucket = next((b * sr for b in self.DENOISE_BUCKETS_S if n <= b * sr),
                      self.DENOISE_BUCKETS_S[-1] * sr)
        return max(bucket, n)

    def process_audio(self, audio: np.ndarray, orig_sr: int = 16_000, *,
                      denoise: bool = True) -> np.ndarray:
        """Downmix → resample → spectral noise gate. Accepts [T] or [C, T];
        returns mono [T'] float32 at 16 kHz."""
        x = np.asarray(audio, np.float32)
        if x.ndim == 2 and x.shape[0] > 2:
            # > 2 channels (5.1 etc.): average them all; front L/R alone
            # would drop the centre channel, which carries the dialogue
            x = x.mean(axis=0)
        elif x.ndim == 2 and x.shape[0] == 2:
            # correlation-aware downmix (dsp.stereo_to_mono's math, on the host)
            l, r = x[0], x[1]
            corr = float(np.sum(l * r) /
                         max(np.sqrt(np.sum(l * l) * np.sum(r * r)), 1e-8))
            mid = 0.5 * (l + r)
            x = mid if corr > 0.5 else mid + 0.25 * np.abs(l - r) * np.sign(mid)
        x = x.reshape(-1)

        if orig_sr != self.SAMPLE_RATE:
            # zero-padding is exact for a linear FIR (the resample right-pads
            # with zeros anyway), so the trimmed output is the unpadded one
            n_in = len(x)
            padded = np.zeros(self._bucket(n_in, orig_sr), np.float32)
            padded[:n_in] = x
            cfg = self.config
            y = resample(torch.from_numpy(padded).to(self.device), orig_sr, self.SAMPLE_RATE,
                         lowpass_filter_width=cfg.resample_lowpass_filter_width,
                         rolloff=cfg.resample_rolloff, beta=cfg.resample_kaiser_beta)
            x = y[:-(-n_in * self.SAMPLE_RATE // orig_sr)].cpu().numpy()
        ok, reason = self.is_valid_audio(x)
        if not ok:
            raise ValidationError(f"Invalid audio: {reason}")
        if denoise:
            n = len(x)
            padded = np.zeros(self._bucket(n, self.SAMPLE_RATE), np.float32)
            padded[:n] = x
            hop = self.config.denoise_hop
            y = dsp.spectral_noise_gate(
                torch.from_numpy(padded).to(self.device), sr=self.SAMPLE_RATE,
                n_fft=self.config.denoise_n_fft, hop=hop, speech_boost=1.2,
                valid_frames=1 + n // hop)        # the centred framing's count
            x = y[:n].cpu().numpy()
        return x.astype(np.float32)

    def apply_spectral_enhancement(self, audio: np.ndarray, language: str) -> np.ndarray:
        """Multi-resolution per-language EQ and compression, peak-normalised."""
        params = LANGUAGE_PARAMS.get(language, LANGUAGE_PARAMS["default"])
        y = dsp.spectral_enhance(
            self._tensor(audio),
            sr=self.SAMPLE_RATE,
            band_edges_hz=BAND_EDGES_HZ,
            band_multipliers=params.band_multipliers,
            compression_threshold=params.compression_threshold,
            compression_ratio=params.compression_ratio,
            resolutions=(512, 1024, 2048),
            resolution_weights=(0.2, 0.4, 0.4),
        )
        return dsp.peak_normalize(y, 0.95).cpu().numpy()

    def process_audio_enhanced(self, audio: np.ndarray, orig_sr: int = 16_000,
                               language: str = "default") -> np.ndarray:
        """The full chain: process, preprocess, enhance."""
        x = self.process_audio(audio, orig_sr)
        x = self.preprocess_audio(x)
        return self.apply_spectral_enhancement(x, language)
