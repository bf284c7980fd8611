"""The port's face / visual-speech detector and visual temporal mapper against
the JAX package's on the CPU: both are host numpy (scipy for the filters), so
boxes, mouth-area series and segments must be equal, and the distributed
audio equal on the same ``default_rng(0)`` draws (1e-6 absolute: the same
numpy arithmetic; the phase-vocoder stretch of the multi-segment case is the
port's host copy of JAX's).
"""

import numpy as np
import pytest

from expressive_speech_translation_tpu.pipeline import face as jface
from expressive_speech_translation_tpu.pipeline.visual_speech_detector import (
    SpeechSegment as JaxSegment, VisualSpeechDetector as JaxDetector)
from expressive_speech_translation_tpu.pipeline.visual_temporal_mapper import (
    VisualTemporalMapper as JaxMapper)
from expressive_speech_translation_tpu_torch.pipeline import face
from expressive_speech_translation_tpu_torch.pipeline.visual_speech_detector import (
    SpeechSegment, VisualSpeechDetector)
from expressive_speech_translation_tpu_torch.pipeline.visual_temporal_mapper import (
    VisualTemporalMapper)

from test_face import synthetic_clip
from test_pipeline import _talking_frames, speech_like


def _noisy_clip():
    """The talking head under strong sensor noise: pixels spread across the
    detector's thresholds (skin box, dark interior, motion floor)."""
    g = np.random.default_rng(1)
    clip = synthetic_clip(n=72).astype(np.int16)
    return list(np.clip(clip + g.normal(0, 12, clip.shape), 0, 255).astype(np.uint8))


CLIPS = {
    "talking head": lambda: list(synthetic_clip(n=120, mouth_open_every=12)),
    "noisy head": _noisy_clip,
    "grey mouth region": lambda: _talking_frames(),
    "still": lambda: [np.full((64, 64, 3), 90, np.uint8)] * 30,
}


def _segments(segs):
    return [(s.start, s.end) for s in segs]


@pytest.mark.parametrize("clip", sorted(CLIPS))
def test_face_and_mouth_boxes_match_jax(clip):
    frames = CLIPS[clip]()
    box = face.detect_face_bbox(frames)
    assert box == jface.detect_face_bbox(frames)
    if box is not None:
        assert face.detect_mouth_bbox(frames, box) == jface.detect_mouth_bbox(frames, box)
    got, want = face.FaceLandmarkDetector(), jface.FaceLandmarkDetector()
    np.testing.assert_array_equal(got.mouth_area_series(frames),
                                  want.mouth_area_series(frames))
    assert got.face_bbox_for_lipsync(frames) == want.face_bbox_for_lipsync(frames)
    if clip.endswith("head"):
        assert box is not None and got.mouth_area_series(frames).max() > 0


@pytest.mark.parametrize("clip,fps", [("talking head", 24.0), ("noisy head", 24.0),
                                      ("grey mouth region", 25.0), ("still", 25.0)])
def test_speech_segments_match_jax(clip, fps):
    """The landmark path on a face clip, the lower-centre proxy where no face
    is found, and no segment on a still clip."""
    frames = CLIPS[clip]()
    got = VisualSpeechDetector(fps=fps).detect_speech_segments(frames)
    want = JaxDetector(fps=fps).detect_speech_segments(frames)
    assert _segments(got) == _segments(want)
    assert (len(got) == 0) == (clip == "still")
    np.testing.assert_array_equal(VisualSpeechDetector(fps=fps).mouth_activity(frames),
                                  JaxDetector(fps=fps).mouth_activity(frames))


def test_a_provided_learned_detector_matches_jax():
    """The learned-detector seam: an injected per-frame detector carries the
    face box in both packages (median over sampled frames)."""
    frames = list(synthetic_clip(n=24))
    boxes = iter(range(100))

    def det(frame):
        k = next(boxes) % 3
        return (40 + k, 80, 140 + k, 160)

    for mod in (face, jface):
        mod.provide_learned_detector(det)
    try:
        got = face.detect_face_bbox(frames)
        boxes = iter(range(100))
        assert got == jface.detect_face_bbox(frames) == (41, 80, 141, 160)
    finally:
        for mod in (face, jface):
            mod._reset_learned()


@pytest.mark.parametrize("seconds,n_chunks", [(3.0, 3), (5.0, 8), (0.5, 4), (4.0, 1)])
def test_split_into_chunks_matches_jax(seconds, n_chunks):
    x = speech_like(seconds, seed=5)
    got = VisualTemporalMapper().split_into_chunks(x, n_chunks)
    want = JaxMapper().split_into_chunks(x, n_chunks)
    assert [len(p) for p in got] == [len(p) for p in want]
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g, w)


@pytest.mark.parametrize("segments,with_source", [
    ([(1.0, 3.0)], True), ([(1.0, 3.0)], False), ([(0.2, 9.5)], True),
    ([(0.5, 1.5), (2.5, 3.5)], True), ([(0.5, 1.2), (1.8, 2.2), (2.6, 3.9)], False)])
def test_distribute_audio_matches_jax(segments, with_source):
    """One segment: chunks at energy valleys with room-tone gaps drawn from
    ``default_rng(0)`` (a translation longer than the clip grows the buffer);
    several: proportional pieces stretched into each."""
    translated = speech_like(6.0 if segments[0] == (0.2, 9.5) else 2.0, seed=3)
    source = speech_like(4.0, seed=4) if with_source else None
    got = VisualTemporalMapper().distribute_audio(
        translated, [SpeechSegment(*s) for s in segments], 4.0, source_audio=source,
        rng=np.random.default_rng(0))
    want = JaxMapper().distribute_audio(
        translated, [JaxSegment(*s) for s in segments], 4.0, source_audio=source,
        rng=np.random.default_rng(0))
    assert got.shape == want.shape and len(got) >= 4 * 16_000
    np.testing.assert_allclose(got, want, atol=1e-6, rtol=0)
    np.testing.assert_array_equal(VisualTemporalMapper().distribute_audio(translated, [], 4.0),
                                  translated)


def test_the_chip_smoke_frames_show_speech_to_the_port_detector():
    """``chip_smoke.py``'s frontend phase drives ``translate_speech`` with these
    frames and fails if the visual branch falls back: the port's detector must
    find speech in them between the 2 s and 8 s the lips move, and JAX's the
    same segments."""
    import chip_smoke

    frames = chip_smoke.frontend_frames()
    assert len(frames) == 250 and frames[0].shape == (360, 640, 3)
    segs = VisualSpeechDetector(fps=chip_smoke.FRONTEND_FPS).detect_speech_segments(frames)
    assert segs and all(1.5 <= s.start and s.end <= 8.5 for s in segs)
    assert sum(s.duration for s in segs) >= 4.0
    assert _segments(segs) == _segments(
        JaxDetector(fps=chip_smoke.FRONTEND_FPS).detect_speech_segments(frames))
