"""VisualSpeechDetector: per-frame mouth activity → speech segments.

The port's copy of the JAX package's ``pipeline/visual_speech_detector.py``
(host numpy): every-3rd-frame mouth-area analysis, activity threshold 0.005,
minimum speech run 0.5 s, gaps under 0.5 s merged. The reference measures
MediaPipe FaceMesh convex-hull mouth area; in its place the clip-level
detector of ``pipeline/face.py`` localizes the face and mouth and measures
the open-mouth interior area per analysed frame. When no face is found, a
luminance-variance proxy over the lower-centre region keeps segments flowing.
A custom ``mouth_area_fn`` can be plugged in through the constructor.
"""

from __future__ import annotations

import dataclasses
import logging
from typing import Callable, List, Optional

import numpy as np

log = logging.getLogger(__name__)

FRAME_SKIP = 3              # visual_speech_detector.py:25
ACTIVITY_THRESHOLD = 0.005  # :165
MIN_SPEECH_SECONDS = 0.5
MERGE_GAP_SECONDS = 0.5


@dataclasses.dataclass
class SpeechSegment:
    start: float
    end: float

    @property
    def duration(self) -> float:
        return self.end - self.start


def _default_mouth_area(frame: np.ndarray) -> float:
    """Proxy for mouth openness without a landmark model: normalised intensity
    variance in the lower-centre region (where the mouth sits for a centred
    talking head)."""
    h, w = frame.shape[:2]
    region = frame[int(0.55 * h): int(0.85 * h), int(0.3 * w): int(0.7 * w)]
    if region.size == 0:
        return 0.0
    gray = region.mean(axis=-1) if region.ndim == 3 else region
    return float(np.var(gray) / (255.0**2))


class VisualSpeechDetector:
    def __init__(
        self,
        fps: float = 25.0,
        mouth_area_fn: Optional[Callable[[np.ndarray], float]] = None,
        *,
        frame_skip: int = FRAME_SKIP,
        activity_threshold: float = ACTIVITY_THRESHOLD,
        use_landmarks: bool = True,
    ):
        self.fps = fps
        self.mouth_area_fn = mouth_area_fn
        self.frame_skip = frame_skip
        self.activity_threshold = activity_threshold
        self.use_landmarks = use_landmarks and mouth_area_fn is None
        self.initialized = False

    def initialize(self) -> None:
        self.initialized = True

    def _mouth_areas(self, frames: List[np.ndarray]) -> np.ndarray:
        """Mouth area per analysed frame: real face/mouth localization when
        available, else the constructor fn, else the lower-centre proxy."""
        if self.use_landmarks:
            from .face import FaceLandmarkDetector

            areas = FaceLandmarkDetector().mouth_area_series(
                frames, frame_skip=self.frame_skip)
            if len(areas):
                return areas
            log.info("no face found; falling back to lower-centre proxy")
        fn = self.mouth_area_fn or _default_mouth_area
        return np.asarray([fn(f) for f in frames[:: self.frame_skip]])

    def mouth_activity(self, frames: List[np.ndarray]) -> np.ndarray:
        """Per-analysed-frame |Δ mouth area| (every ``frame_skip``-th frame)."""
        areas = self._mouth_areas(frames)
        if len(areas) < 2:
            return np.zeros(max(len(areas), 0))
        return np.abs(np.diff(areas, prepend=areas[0]))

    def detect_speech_segments(self, frames: List[np.ndarray]) -> List[SpeechSegment]:
        """Threshold → min-duration filter → gap merge (:165-241)."""
        activity = self.mouth_activity(frames)
        dt = self.frame_skip / self.fps
        speaking = activity > self.activity_threshold

        segments: List[SpeechSegment] = []
        start = None
        for i, on in enumerate(speaking):
            if on and start is None:
                start = i * dt
            elif not on and start is not None:
                segments.append(SpeechSegment(start, i * dt))
                start = None
        if start is not None:
            segments.append(SpeechSegment(start, len(speaking) * dt))

        # merge gaps < MERGE_GAP_SECONDS
        merged: List[SpeechSegment] = []
        for seg in segments:
            if merged and seg.start - merged[-1].end < MERGE_GAP_SECONDS:
                merged[-1] = SpeechSegment(merged[-1].start, seg.end)
            else:
                merged.append(seg)
        return [s for s in merged if s.duration >= MIN_SPEECH_SECONDS]
