"""VisualTemporalMapper: distribute translated audio into visually detected
speech segments.

The port's copy of the JAX package's ``pipeline/visual_temporal_mapper.py``
(host numpy, over the port's ``TemporalMapper``): energy-valley chunk
splitting (3 to 8 chunks), chunk placement into one segment with natural
0.2–0.4 s gaps of room tone and a buffer that grows to hold the content,
and proportional distribution with a per-segment stretch over several
segments.
"""

from __future__ import annotations

import logging
from typing import List, Optional, Sequence

import numpy as np

from .temporal_mapper import TemporalMapper
from .visual_speech_detector import SpeechSegment

log = logging.getLogger(__name__)

MIN_CHUNKS, MAX_CHUNKS = 3, 8            # visual_temporal_mapper.py:405-477
NATURAL_GAP_RANGE = (0.2, 0.4)           # :303-403


class VisualTemporalMapper:
    def __init__(self, sr: int = 16_000):
        self.sr = sr
        self.mapper = TemporalMapper(sr)
        self.detector = None  # optional VisualSpeechDetector, set by the caller
        self.initialized = False

    def initialize(self) -> None:
        if self.detector is not None and not getattr(self.detector, "initialized", False):
            self.detector.initialize()
        self.initialized = True

    # ------------------------------------------------------------- chunking

    def split_into_chunks(self, audio: np.ndarray, n_chunks: int) -> List[np.ndarray]:
        """Split at the lowest-energy points so cuts land in pauses
        (energy-valley splitting, :405-477)."""
        audio = np.asarray(audio, np.float32).reshape(-1)
        n_chunks = int(np.clip(n_chunks, 1, MAX_CHUNKS))
        if n_chunks == 1 or len(audio) < self.sr:
            return [audio]
        frame = 512
        n_frames = len(audio) // frame
        energy = np.sqrt(
            (audio[: n_frames * frame].reshape(n_frames, frame) ** 2).mean(axis=1)
        )
        # candidate cut: the minimum-energy frame inside each target window
        cuts = []
        for i in range(1, n_chunks):
            target = i * n_frames // n_chunks
            lo = max(target - n_frames // (2 * n_chunks), 1)
            hi = min(target + n_frames // (2 * n_chunks), n_frames - 1)
            cuts.append((lo + int(np.argmin(energy[lo:hi]))) * frame)
        cuts = sorted(set(cuts))
        pieces, prev = [], 0
        for c in cuts:
            pieces.append(audio[prev:c])
            prev = c
        pieces.append(audio[prev:])
        return [p for p in pieces if len(p)]

    # ----------------------------------------------------------- distribution

    def distribute_audio(
        self,
        translated: np.ndarray,
        segments: Sequence[SpeechSegment],
        total_duration: float,
        *,
        source_audio: Optional[np.ndarray] = None,
        rng: Optional[np.random.Generator] = None,
    ) -> np.ndarray:
        """Place translated audio into the video's speech segments.

        Single segment → chunked placement with natural gaps (:258 surviving
        definition); multiple segments → proportional-duration distribution
        with per-segment stretch; output buffer grows if content overflows
        (:303-403). Silence gaps are filled with room tone when a source is
        available.
        """
        rng = rng or np.random.default_rng(0)
        translated = np.asarray(translated, np.float32).reshape(-1)
        out_len = int(total_duration * self.sr)

        if not segments:
            # no visual speech found → natural flow fallback handled by caller
            return translated

        tone_src = source_audio if source_audio is not None else translated

        if len(segments) == 1:
            seg = segments[0]
            n_chunks = int(np.clip(round(seg.duration / 2.0), MIN_CHUNKS, MAX_CHUNKS))
            chunks = self.split_into_chunks(translated, n_chunks)
            pos = int(seg.start * self.sr)
            placed: List[np.ndarray] = []
            total_content = sum(len(c) for c in chunks)
            for i, chunk in enumerate(chunks):
                placed.append(chunk)
                if i < len(chunks) - 1:
                    gap = rng.uniform(*NATURAL_GAP_RANGE)
                    placed.append(self.mapper.room_tone(tone_src, int(gap * self.sr)))
            content = np.concatenate(placed)
            needed = pos + len(content)
            out_len = max(out_len, needed)  # dynamic buffer extension (:303-403)
            out = np.zeros(out_len, np.float32)
            if source_audio is not None and out_len:
                out = self.mapper.room_tone(source_audio, out_len)
                out *= 0.5
            out[pos: pos + len(content)] = content
            return out

        # multi-segment: split proportionally to segment durations
        durations = np.asarray([s.duration for s in segments])
        weights = durations / durations.sum()
        boundaries = np.concatenate([[0], np.cumsum((weights * len(translated)).astype(int))])
        boundaries[-1] = len(translated)
        out = np.zeros(out_len, np.float32)
        for seg, lo, hi in zip(segments, boundaries[:-1], boundaries[1:]):
            piece = translated[lo:hi]
            if not len(piece):
                continue
            piece = self.mapper.stretch_to_duration(piece, seg.duration)
            pos = int(seg.start * self.sr)
            end = min(pos + len(piece), len(out))
            if end > len(out):  # pragma: no cover — end is clamped above
                pass
            if pos < len(out):
                out[pos:end] = piece[: end - pos]
        return out
