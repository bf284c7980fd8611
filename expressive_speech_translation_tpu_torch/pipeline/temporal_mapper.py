"""TemporalMapper: audio-only timing transfer from the source utterance to
its translation (host numpy copy of the JAX package's
pipeline/temporal_mapper.py ``timing_profile`` / ``apply_temporal_guidance``):
timing profile from word timestamps or a multi-feature VAD, then onset
alignment, a phase-vocoder stretch clipped to [0.7, 1.5] and room tone up to
the source duration."""

from __future__ import annotations

import dataclasses
from typing import Dict, List, Optional

import numpy as np

from ..ops.host_dsp import phase_vocoder_stretch_np, stft_np

MIN_STRETCH, MAX_STRETCH = 0.7, 1.5
PAUSE_MIN_SECONDS = 0.25               # inter-word gaps longer than this are pauses


@dataclasses.dataclass
class TimingProfile:
    duration: float
    speech_onset: float
    speech_offset: float
    pauses: List[Dict[str, float]]      # [{"start", "end", "duration"}]
    speech_ratio: float


class TemporalMapper:
    def __init__(self, sr: int = 16_000, frame: int = 512, hop: int = 256):
        self.sr = sr
        self.frame = frame
        self.hop = hop

    # ------------------------------------------------------------- analysis

    def _vad_features_np(self, x: np.ndarray):
        """Frame energy (512 / 256, no centring) and spectral centroid and
        85 % rolloff of a centred 1024-point STFT."""
        n = max((len(x) - self.frame) // self.hop + 1, 0)
        if n == 0:
            return np.zeros(0), np.zeros(0), np.zeros(0)
        idx = np.arange(n)[:, None] * self.hop + np.arange(self.frame)[None, :]
        energy = np.sqrt((x[idx] ** 2).mean(axis=-1) + 1e-12)

        spec = stft_np(x, 1024, self.hop)
        mag = np.sqrt(spec.real**2 + spec.imag**2 + 1e-12)
        freqs = np.linspace(0, self.sr / 2, 1024 // 2 + 1).astype(np.float32)
        total = mag.sum(axis=-1)
        centroid = (mag * freqs).sum(axis=-1) / np.maximum(total, 1e-8)
        cum = np.cumsum(mag, axis=-1)
        rolloff_idx = np.argmax(cum >= 0.85 * total[..., None], axis=-1)
        rolloff = freqs[rolloff_idx]
        return energy, centroid, rolloff

    def _vad(self, audio: np.ndarray) -> np.ndarray:
        """Multi-feature VAD (energy-gated centroid and rolloff) → per-frame
        speech bool."""
        energy, centroid, rolloff = self._vad_features_np(np.asarray(audio, np.float32))
        n = min(len(energy), len(centroid))
        energy, centroid, rolloff = energy[:n], centroid[:n], rolloff[:n]

        def norm(v):
            lo, hi = np.percentile(v, 5), np.percentile(v, 95)
            return np.clip((v - lo) / max(hi - lo, 1e-8), 0, 1)

        # Energy gates the spectral features (centroid/rolloff are noise-driven
        # in silence, so they must not contribute without energy support).
        e = norm(energy)
        score = e * (0.5 + 0.3 * norm(centroid) + 0.2 * norm(rolloff))
        return score >= 0.3

    def timing_profile(
        self, audio: np.ndarray, word_timestamps: Optional[List[Dict[str, float]]] = None
    ) -> TimingProfile:
        """From word timestamps when available (ASR path), else VAD."""
        audio = np.asarray(audio, np.float32).reshape(-1)
        duration = len(audio) / self.sr

        if word_timestamps:
            onset = float(word_timestamps[0]["start"])
            offset = float(word_timestamps[-1]["end"])
            pauses = []
            for prev, cur in zip(word_timestamps, word_timestamps[1:]):
                gap = float(cur["start"]) - float(prev["end"])
                if gap > PAUSE_MIN_SECONDS:
                    pauses.append({
                        "start": float(prev["end"]), "end": float(cur["start"]),
                        "duration": gap,
                    })
            speech = sum(float(w["end"]) - float(w["start"]) for w in word_timestamps)
            return TimingProfile(duration, onset, offset, pauses, speech / max(duration, 1e-8))

        speech = self._vad(audio)
        frame_t = self.hop / self.sr
        if not speech.any():
            return TimingProfile(duration, 0.0, duration, [], 0.0)
        idx = np.where(speech)[0]
        onset, offset = idx[0] * frame_t, (idx[-1] + 1) * frame_t
        pauses = []
        run_start = None
        for i in range(idx[0], idx[-1] + 1):
            if not speech[i] and run_start is None:
                run_start = i
            elif speech[i] and run_start is not None:
                gap = (i - run_start) * frame_t
                if gap > PAUSE_MIN_SECONDS:
                    pauses.append({
                        "start": run_start * frame_t, "end": i * frame_t, "duration": gap,
                    })
                run_start = None
        return TimingProfile(duration, onset, offset, pauses, float(speech.mean()))

    # ------------------------------------------------------------- transform

    def room_tone(self, reference: np.ndarray, n_samples: int) -> np.ndarray:
        """Room tone tiled from the quietest window of the reference."""
        ref = np.asarray(reference, np.float32).reshape(-1)
        win = min(len(ref), self.sr // 2)
        if win < self.hop:
            return np.zeros(n_samples, np.float32)
        hop = win // 2
        frames = [(i, float(np.sqrt(np.mean(ref[i:i + win] ** 2)))) for i in range(0, len(ref) - win + 1, hop)]
        start = min(frames, key=lambda f: f[1])[0]
        quiet = ref[start:start + win]
        reps = int(np.ceil(n_samples / win))
        tone = np.tile(quiet, reps)[:n_samples]
        # cross-fade the tile seams lightly by attenuating overall
        return (0.8 * tone).astype(np.float32)

    def stretch_to_duration(self, audio: np.ndarray, target_seconds: float) -> np.ndarray:
        """Phase-vocoder stretch with the [0.7, 1.5] rate clip."""
        audio = np.asarray(audio, np.float32).reshape(-1)
        current = len(audio) / self.sr
        if current < 1e-3 or target_seconds < 1e-3:
            return audio
        rate = float(np.clip(current / target_seconds, MIN_STRETCH, MAX_STRETCH))
        if abs(rate - 1.0) < 0.02:
            return audio
        return phase_vocoder_stretch_np(audio, rate)

    def apply_temporal_guidance(
        self,
        translated: np.ndarray,
        source: np.ndarray,
        source_profile: Optional[TimingProfile] = None,
    ) -> np.ndarray:
        """Map translated audio onto the source's timing skeleton:
        onset offset → global stretch → room tone up to the source duration."""
        translated = np.asarray(translated, np.float32).reshape(-1)
        source = np.asarray(source, np.float32).reshape(-1)
        profile = source_profile or self.timing_profile(source)

        # 1. global stretch toward the source's speech span
        speech_span = max(profile.speech_offset - profile.speech_onset, 0.1)
        stretched = self.stretch_to_duration(translated, speech_span)

        # 2. leading silence to match the source onset
        onset_samples = int(profile.speech_onset * self.sr)
        lead = self.room_tone(source, onset_samples) if onset_samples > 0 else np.zeros(0, np.float32)

        # 3. trailing room tone UP TO the source duration. Never truncate: a
        # translation longer than the source even at MAX_STRETCH keeps its
        # full content.
        total = int(profile.duration * self.sr)
        used = len(lead) + len(stretched)
        tail_n = max(total - used, 0)
        tail = self.room_tone(source, tail_n) if tail_n else np.zeros(0, np.float32)
        return np.concatenate([lead, stretched, tail])
