"""Host-side face and mouth localization for visual speech detection.

The port's copy of the JAX package's ``pipeline/face.py`` up to the
clip-level detector (the per-window tracking and per-frame boxes that serve
lip-sync are not ported). The reference localizes mouths with MediaPipe
FaceMesh (convex hull of 15 mouth landmarks, every 3rd frame) and faces with
DWPose / S3FD boxes. Neither model is available, so this module is a
classical detector that localizes faces and mouths on real video:

1. **Face**: skin-chroma mask (YCbCr box) ∧ temporal-motion mask — skin color
   alone is not enough (wood panelling passes the chroma test; a speaking face
   is the skin region that *moves*). The blob holding the score peak → bbox,
   aggregated over sampled frames for stability.
2. **Mouth**: within the face box, the peak of the temporally aggregated lip
   map (lip-colored and articulating) → a fixed-proportion mouth box.
3. **Mouth-area series**: per analysed frame, the open-mouth interior area
   (pixels darker than the local median) normalized by rough face size.

All of it is numpy/scipy on the host (scipy imported inside the functions
that use it): per-clip video preparation, not a device hot path.

When a learned detector checkpoint is mounted it takes over face
localization (the classical detector stays the fallback): see
:func:`learned_detector`, discovered under ``$EST_MODELS_DIR/face_detector``.
"""

from __future__ import annotations

import dataclasses
import json
import logging
import os
from pathlib import Path
from typing import Callable, List, Optional, Sequence, Tuple

import numpy as np

log = logging.getLogger(__name__)

BBox = Tuple[int, int, int, int]  # (y0, x0, y1, x1) — half-open


# ------------------------------------------------------- learned-detector seam
#
# The reference localizes with learned models everywhere: MediaPipe FaceMesh
# (services/visual_speech_detector.py:33-46), DWPose for MuseTalk
# (Docker/api_inference_logic.py:42-73), vendored S3FD for diff2lip
# (Backend/diff2lip/face_detection/). None ship in this environment, so the
# production path discovers one under ``$EST_MODELS_DIR/face_detector`` when
# weights are mounted and falls back to the classical detector below
# otherwise.
#
# ``config.json`` contract (mirrors evals/visual_models.py):
#   {"format": "torchscript", "file": "model.pt", "min_score": 0.5}
# The scripted module maps one float32 frame [1,3,H,W] in [0,1] (NCHW — what
# real S3FD/RetinaFace exports take) to an [N,5] tensor of
# (x0, y0, x1, y1, score) boxes in pixels; the highest-scoring box above
# ``min_score`` wins. Tests and bespoke deployments can inject a per-frame
# callable directly via :func:`provide_learned_detector`.

# per-frame detector: frame [H,W,3] uint8/float → (y0,x0,y1,x1) or None
FrameDetector = Callable[[np.ndarray], Optional[BBox]]

_UNSET = object()
_learned: object = _UNSET


def _load_torchscript_detector(d: Path, cfg: dict) -> FrameDetector:
    import torch

    mod = torch.jit.load(str(d / cfg.get("file", "model.pt")), map_location="cpu")
    mod.eval()
    min_score = float(cfg.get("min_score", 0.5))

    def fn(frame: np.ndarray) -> Optional[BBox]:
        f = np.asarray(frame)
        if f.ndim == 2:  # grayscale → stacked channels
            f = np.repeat(f[..., None], 3, axis=-1)
        is_int = np.issubdtype(f.dtype, np.integer)
        x = np.ascontiguousarray(f, dtype=np.float32)
        # key the scale off the DTYPE: a near-black uint8 frame (max 0/1)
        # would pass a max()-based heuristic unscaled, turning 1/255 pixels
        # into full-white 1.0 and producing garbage detections on dark scenes
        if is_int or x.max() > 1.5:
            x = x / 255.0
        with torch.no_grad():
            out = mod(torch.from_numpy(x).permute(2, 0, 1)[None])
        boxes = np.asarray(out, np.float32).reshape(-1, 5)
        boxes = boxes[boxes[:, 4] >= min_score]
        if len(boxes) == 0:
            return None
        x0, y0, x1, y1, _ = boxes[int(np.argmax(boxes[:, 4]))]
        h, w = f.shape[:2]
        y0, y1 = int(np.clip(y0, 0, h - 1)), int(np.clip(y1, 1, h))
        x0, x1 = int(np.clip(x0, 0, w - 1)), int(np.clip(x1, 1, w))
        if y1 - y0 < 2 or x1 - x0 < 2:
            return None
        return (y0, x0, y1, x1)

    return fn


_DETECTOR_LOADERS = {"torchscript": _load_torchscript_detector}


def learned_detector() -> Optional[FrameDetector]:
    """Singleton with lazy ``$EST_MODELS_DIR/face_detector`` discovery.
    ``None`` → the classical detector carries localization."""
    global _learned
    if _learned is _UNSET:
        _learned = _discover_learned()
    return _learned  # type: ignore[return-value]


def provide_learned_detector(fn: Optional[FrameDetector]) -> None:
    """Inject a learned per-frame detector (tests / bespoke deployments)."""
    global _learned
    _learned = fn


def _reset_learned() -> None:
    """Drop the cached detector (tests re-discover after env changes)."""
    global _learned
    _learned = _UNSET


def _discover_learned() -> Optional[FrameDetector]:
    root = os.environ.get("EST_MODELS_DIR")
    if not root:
        return None
    d = Path(root) / "face_detector"
    cfg_path = d / "config.json"
    if not cfg_path.exists():
        return None
    try:
        cfg = json.loads(cfg_path.read_text())
        fmt = cfg.get("format", "")
        if fmt not in _DETECTOR_LOADERS:
            raise ValueError(f"unknown face-detector format {fmt!r}")
        fn = _DETECTOR_LOADERS[fmt](d, cfg)
        log.info("face: learned detector from %s (%s)", d, fmt)
        return fn
    except Exception as e:  # noqa: BLE001 — localization degrades to classical
        log.warning("face: learned detector load failed (%s); using classical", e)
        return None


def _learned_clip_bbox(
    frames: Sequence[np.ndarray], det: FrameDetector, max_samples: int,
) -> Optional[BBox]:
    """Clip-stable box from a per-frame learned detector: median over sampled
    frames' detections (the same role 5-frame bbox smoothing plays for the
    reference's per-frame DWPose/S3FD boxes — api_inference_logic.py:89-97)."""
    idx = _sample_indices(len(frames), max_samples)
    boxes = []
    for i in idx:
        try:
            b = det(np.asarray(frames[i]))
        except Exception as e:  # noqa: BLE001
            log.warning("face: learned detector failed on a frame (%s); "
                        "falling back to classical", e)
            return None
        if b is not None:
            boxes.append(b)
    if not boxes:
        return None
    med = np.median(np.asarray(boxes, np.float32), axis=0)
    h, w = np.asarray(frames[0]).shape[:2]
    y0, x0, y1, x1 = (int(round(v)) for v in med)
    return (max(0, y0), max(0, x0), min(h, max(y1, y0 + 2)),
            min(w, max(x1, x0 + 2)))


def _ycbcr(frame: np.ndarray) -> Tuple[np.ndarray, np.ndarray, np.ndarray]:
    f = np.asarray(frame, np.float32)
    r, g, b = f[..., 0], f[..., 1], f[..., 2]
    y = 0.299 * r + 0.587 * g + 0.114 * b
    cb = 128.0 - 0.168736 * r - 0.331264 * g + 0.5 * b
    cr = 128.0 + 0.5 * r - 0.418688 * g - 0.081312 * b
    return y, cb, cr


def skin_mask(frame: np.ndarray) -> np.ndarray:
    """Classic YCbCr skin-chroma box (Chai & Ngan ranges)."""
    _, cb, cr = _ycbcr(frame)
    return (cr > 133) & (cr < 173) & (cb > 77) & (cb < 127)


def lip_map(frame: np.ndarray) -> np.ndarray:
    """Classical chroma lip map: Cr² − k·(Cr/Cb) with k auto-balanced so plain
    skin cancels out (Hsu/Abdel-Mottaleb/Jain face-detection lip feature).
    Lips carry higher Cr and lower Cb than surrounding skin; the map peaks on
    the lips and is near zero on cheeks, beard, and background."""
    _, cb, cr = _ycbcr(frame)
    cr2 = (cr / 255.0) ** 2
    ratio = np.where(cb > 1.0, cr / cb, 0.0)
    k = 0.95 * cr2.mean() / max(float(ratio.mean()), 1e-6)
    return np.clip(cr2 - k * ratio, 0.0, None) * cr2


def _sample_indices(n: int, k: int) -> np.ndarray:
    if n <= k:
        return np.arange(n)
    return np.linspace(0, n - 1, k).round().astype(int)


def _downsample(img: np.ndarray, step: int) -> np.ndarray:
    return img[::step, ::step]


def detect_face_bbox(
    frames: Sequence[np.ndarray],
    *,
    max_samples: int = 8,
    downsample: int = 4,
    min_area_frac: float = 0.002,
) -> Optional[BBox]:
    """Stable face bbox for a clip, or None when no face-like region exists.

    Score = skin-chroma fraction × smoothed consecutive-frame motion, at
    reduced resolution. Consecutive-pair diffs (not long-range std) so slow
    camera drift and lighting shifts don't light up static skin-toned
    background; the *product* (not conjunction) of the cues, thresholded
    relative to its own peak, so a wall that is skin-colored but barely moving
    scores low even when both cues individually clear a floor. The face is the
    connected blob containing the score peak — the articulating head is where
    skin and motion coincide hardest (tuned on the committed speaking-head
    fixture where largest-blob picking grabs the speaker's shadow on wood
    panelling instead).

    When a learned detector is mounted (``$EST_MODELS_DIR/face_detector``) it
    carries localization instead — every consumer (MuseTalk, diff2lip, the
    visual speech detector, windowed tracking) funnels through here, so the
    seam upgrades all of them at once. Per-frame failures fall back to the
    classical path below.
    """
    from scipy import ndimage

    if len(frames) == 0:
        return None
    det = learned_detector()
    if det is not None:
        box = _learned_clip_bbox(frames, det, max_samples)
        if box is not None:
            return box
        # a mounted detector that found no face on any sampled frame is an
        # honest no-face answer ONLY if it ran; _learned_clip_bbox returns
        # None on execution failure too — classical continues below either
        # way (a missed small face costs less than a crashed clip)
    h, w = np.asarray(frames[0]).shape[:2]
    if len(frames) == 1:
        idx_pairs = []
    else:
        idx_pairs = _sample_indices(len(frames) - 1, max_samples)

    diffs = []
    skins = []

    def prep(i):
        f = _downsample(np.asarray(frames[i]), downsample)
        if f.ndim == 3:
            return f.astype(np.float32).mean(axis=-1), skin_mask(f)
        # grayscale: no chroma cue — motion alone must carry it
        return f.astype(np.float32), np.ones(f.shape, bool)

    for i in idx_pairs:
        ga, sa = prep(i)
        gb, _ = prep(i + 1)
        diffs.append(np.abs(gb - ga))
        skins.append(sa)
    if not diffs:
        _, skin = prep(0)
        score = ndimage.gaussian_filter(skin.astype(np.float32), sigma=2.0)
    else:
        motion = np.mean(diffs, axis=0)
        # sensor/compression noise moves every pixel a little; the median is
        # that floor (faces are a minority of pixels) — subtract it so static
        # background scores zero regardless of camera noise level
        motion = np.maximum(motion - float(np.median(motion)), 0.0)
        motion = ndimage.gaussian_filter(motion, sigma=3.0)
        skin_frac = np.mean(skins, axis=0)
        score = ndimage.gaussian_filter(
            skin_frac * (motion / max(float(motion.max()), 1e-6)), sigma=2.0)

    if float(score.max()) <= 0.0:
        return None
    # a face must actually be skin-colored where the score peaks — random
    # noise and non-skin scenes produce a peak too, just not a skin-backed one
    if diffs:
        peak0 = np.unravel_index(int(np.argmax(score)), score.shape)
        if float(skin_frac[peak0]) < 0.4:
            return None
    mask = score > 0.3 * score.max()
    mask = ndimage.binary_opening(mask, iterations=1)
    labels, n = ndimage.label(mask)
    if n == 0:
        return None
    peak = np.unravel_index(int(np.argmax(score)), score.shape)
    lab = labels[peak]
    if lab == 0:  # peak eroded away: fall back to the largest blob
        sizes = ndimage.sum(mask, labels, index=np.arange(1, n + 1))
        lab = int(np.argmax(sizes)) + 1
    blob = labels == lab
    if float(blob.sum()) < min_area_frac * blob.size:
        return None
    ys, xs = np.nonzero(blob)
    s = downsample
    y0, y1 = int(ys.min()) * s, (int(ys.max()) + 1) * s
    x0, x1 = int(xs.min()) * s, (int(xs.max()) + 1) * s
    # small margin, clamped to frame
    my, mx = (y1 - y0) // 10, (x1 - x0) // 10
    return (max(0, y0 - my), max(0, x0 - mx), min(h, y1 + my), min(w, x1 + mx))


def detect_mouth_bbox(
    frames: Sequence[np.ndarray],
    face_bbox: BBox,
    *,
    max_samples: int = 16,
) -> Optional[BBox]:
    """Mouth bbox inside a face bbox: peak of the temporally-aggregated lip
    map (mean × std over sampled frames — lips are both lip-colored and
    articulating), smoothed at face scale. Returns a fixed-proportion box
    (0.35 fw × 0.18 fh) centred on the peak. Verified against the committed
    speaking-head fixture, where grayscale-variance approaches lock onto eyes
    and cheek highlights instead."""
    from scipy import ndimage

    y0, x0, y1, x1 = face_bbox
    fh, fw = y1 - y0, x1 - x0
    if fh < 8 or fw < 8 or len(frames) < 1:
        return None
    frame0 = np.asarray(frames[0])
    if frame0.ndim != 3:  # grayscale: no chroma — no mouth localization
        return None
    idx = _sample_indices(len(frames), max_samples)
    stack = np.stack([
        lip_map(np.asarray(frames[i])[y0:y1, x0:x1]) for i in idx
    ])
    agg = stack.mean(axis=0)
    if len(idx) >= 2:
        agg = agg * (stack.std(axis=0) + 0.1 * float(agg.max()))
    score = ndimage.gaussian_filter(agg, sigma=max(2.0, fh / 40.0))
    if float(score.max()) <= 0.0:
        return None
    py, px = np.unravel_index(int(np.argmax(score)), score.shape)
    cy, cx = y0 + py, x0 + px
    mh, mw = max(4, int(0.18 * fh)), max(4, int(0.35 * fw))
    h, w = frame0.shape[:2]
    my0 = int(np.clip(cy - mh // 2, 0, h - 1))
    mx0 = int(np.clip(cx - mw // 2, 0, w - 1))
    return (my0, mx0, min(h, my0 + mh), min(w, mx0 + mw))


def mouth_open_area(frame: np.ndarray, mouth_bbox: BBox, frame_area: float) -> float:
    """Open-mouth interior area for one frame, normalized by rough face size
    (frame area × 0.1, matching the reference's normalization —
    visual_speech_detector.py:150-160). Open interiors read as pixels darker
    than the local median luminance."""
    y0, x0, y1, x1 = mouth_bbox
    region = np.asarray(frame[y0:y1, x0:x1], np.float32)
    if region.size == 0:
        return 0.0
    gray = region.mean(axis=-1) if region.ndim == 3 else region
    dark = gray < 0.62 * float(np.median(gray))
    area = float(dark.sum())
    return min(1.0, area / max(frame_area * 0.1, 1.0))


@dataclasses.dataclass
class FaceTrack:
    """Per-clip detection result: stable face + mouth boxes. ``detected``
    is False for windows that inherited a neighbour's box via gap-fill —
    flow refinement must not drift-correct onto those pseudo-anchors."""

    face: BBox
    mouth: Optional[BBox]
    detected: bool = True


class FaceLandmarkDetector:
    """Clip-level detector: finds a stable face + mouth box once, then serves
    per-frame mouth-area measurements and lip-sync crops from it.

    Substitutes for the reference's MediaPipe FaceMesh / DWPose / S3FD stack
    with a self-contained classical detector — see module docstring.
    """

    def __init__(self):
        self._track: Optional[FaceTrack] = None

    def track(self, frames: Sequence[np.ndarray]) -> Optional[FaceTrack]:
        face = detect_face_bbox(frames)
        if face is None:
            self._track = None
            return None
        mouth = detect_mouth_bbox(frames, face)
        self._track = FaceTrack(face=face, mouth=mouth)
        return self._track

    def mouth_area_series(
        self, frames: Sequence[np.ndarray], *, frame_skip: int = 3,
    ) -> np.ndarray:
        """Mouth-openness per analysed frame (every ``frame_skip``-th —
        visual_speech_detector.py:25). Empty array when no face is found."""
        track = self._track or self.track(frames)
        if track is None or track.mouth is None:
            return np.zeros(0)
        h, w = frames[0].shape[:2]
        fy0, fx0, fy1, fx1 = track.face
        face_area = float((fy1 - fy0) * (fx1 - fx0))
        return np.asarray([
            mouth_open_area(f, track.mouth, face_area)
            for f in frames[::frame_skip]
        ])

    def face_bbox_for_lipsync(
        self, frames: Sequence[np.ndarray],
    ) -> Optional[BBox]:
        """Square-ish face crop box for MuseTalk/diff2lip (the reference feeds
        256×256 face crops — Docker/api_inference_logic.py:89-97). Expands the
        detected bbox to a square around its centre, clamped to the frame."""
        track = self._track or self.track(frames)
        if track is None:
            return None
        y0, x0, y1, x1 = track.face
        h, w = frames[0].shape[:2]
        side = max(y1 - y0, x1 - x0)
        cy, cx = (y0 + y1) // 2, (x0 + x1) // 2
        half = min(side // 2, cy, cx, h - cy, w - cx)
        return (cy - half, cx - half, cy + half, cx + half)
