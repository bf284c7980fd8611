"""Host-side face and mouth localization for lip-sync and visual speech.

The port's copy of the JAX package's ``pipeline/face.py``: the clip-level
detector, and the per-window tracking, phase-correlation refinement and
per-frame boxes that serve lip-sync. The reference localizes mouths with
MediaPipe FaceMesh (convex hull of 15 mouth landmarks, every 3rd frame) and faces with
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


def frames_face_detector(frames: Sequence[np.ndarray]) -> BBox:
    """diff2lip-compatible detector: real face box when one is found, centre
    crop otherwise (pipeline/diff2lip.py center_face_detector fallback)."""
    if len(frames) == 0:
        from ..core.errors import MediaError

        raise MediaError("no video frames for face detection",
                         user_message="The video contains no frames")
    box = FaceLandmarkDetector().face_bbox_for_lipsync(frames)
    if box is not None:
        return box
    h, w = np.asarray(frames[0]).shape[:2]
    s = min(h, w)
    y0, x0 = (h - s) // 2, (w - s) // 2
    return (y0, x0, y0 + s, x0 + s)


def track_face_windows(
    frames: Sequence[np.ndarray], fps: float = 25.0, *, window_s: float = 2.0,
) -> List[Optional[FaceTrack]]:
    """Windowed tracking: one FaceTrack per ~window_s slice of the clip
    (multi-shot videos and moving heads need more than a single per-clip box;
    the reference re-detects with FaceMesh every analysed frame). Windows
    with no detection inherit the nearest detected neighbour."""
    n = len(frames)
    if n == 0:
        return []
    win = max(int(window_s * fps), 4)
    tracks: List[Optional[FaceTrack]] = []
    for s in range(0, n, win):
        chunk = frames[s: s + win]
        face = detect_face_bbox(chunk)
        if face is None:
            tracks.append(None)
            continue
        # anchor localisation: the full-window box smears a fast-moving head
        # along its path (the blob covers the swept strip). Re-detect inside
        # that ROI on a narrow chunk around the window CENTRE — constrained
        # to the ROI it cannot wander onto background, and over 8 frames it
        # sees the head only where it actually is at the anchor frame.
        c = min(s + win // 2, n - 1)
        sub = [np.asarray(frames[i])[face[0]:face[2], face[1]:face[3]]
               for i in range(max(c - 4, s), min(c + 4, s + len(chunk)))]
        if len(sub) >= 2 and (face[2] - face[0]) >= 8 and (face[3] - face[1]) >= 8:
            local = detect_face_bbox(sub)
            if local is not None:
                face = (face[0] + local[0], face[1] + local[1],
                        face[0] + local[2], face[1] + local[3])
        tracks.append(FaceTrack(face=face, mouth=detect_mouth_bbox(chunk, face)))
    # fill gaps from the nearest detected window — marked detected=False so
    # downstream refinement knows these centres are NOT real detections
    detected = [i for i, t in enumerate(tracks) if t is not None]
    for i, t in enumerate(tracks):
        if t is None and detected:
            src_track = tracks[min(detected, key=lambda j: abs(j - i))]
            tracks[i] = dataclasses.replace(src_track, detected=False)
    return tracks


def _gray_patch(frame: np.ndarray, box, size: int = 48) -> np.ndarray:
    """Fixed-size grayscale crop of ``box`` (nearest resample — translation
    estimation only needs consistent sampling, not fidelity)."""
    f = np.asarray(frame)
    h, w = f.shape[:2]
    y0 = int(np.clip(box[0], 0, h - 2))
    x0 = int(np.clip(box[1], 0, w - 2))
    y1 = int(np.clip(box[2], y0 + 2, h))
    x1 = int(np.clip(box[3], x0 + 2, w))
    crop = f[y0:y1, x0:x1]
    if crop.ndim == 3:
        crop = crop.mean(axis=-1)
    yi = np.linspace(0, crop.shape[0] - 1, size).astype(int)
    xi = np.linspace(0, crop.shape[1] - 1, size).astype(int)
    return crop[np.ix_(yi, xi)].astype(np.float32)


def _phase_shift(a: np.ndarray, b: np.ndarray) -> Tuple[float, float]:
    """Phase correlation: the (dy, dx) translating patch ``a`` onto ``b``
    in patch pixels (FFT cross-power spectrum peak, wraparound-signed)."""
    win = np.outer(np.hanning(a.shape[0]), np.hanning(a.shape[1]))
    fa = np.fft.fft2((a - a.mean()) * win)
    fb = np.fft.fft2((b - b.mean()) * win)
    r = fb * np.conj(fa)
    r /= np.maximum(np.abs(r), 1e-9)
    corr = np.abs(np.fft.ifft2(r))
    peak = np.unravel_index(int(np.argmax(corr)), corr.shape)

    def subpixel(axis_idx, axis_len, pick):
        # parabolic interpolation around the peak along one axis; ``pick``
        # indexes corr at a given position along that axis
        c0 = pick((axis_idx - 1) % axis_len)
        c1 = pick(axis_idx)
        c2 = pick((axis_idx + 1) % axis_len)
        denom = c0 - 2 * c1 + c2
        return float(axis_idx) + (0.5 * (c0 - c2) / denom if abs(denom) > 1e-12 else 0.0)

    dy = subpixel(peak[0], a.shape[0], lambda i: corr[i, peak[1]])
    dx = subpixel(peak[1], a.shape[1], lambda j: corr[peak[0], j])
    if dy > a.shape[0] / 2:
        dy -= a.shape[0]
    if dx > a.shape[1] / 2:
        dx -= a.shape[1]
    return dy, dx


def smooth_boxes(boxes: List, window: int = 5) -> List[BBox]:
    """MuseTalk's CENTERED 5-frame bbox smoothing
    (Docker/api_inference_logic.py:27-38 smooth_bbox parity: window
    [i−w//2, i+w//2], out-of-place). The diff2lip pipeline's FORWARD
    in-place smoother is pipeline/diff2lip.smooth_boxes — the reference
    ships both with different semantics."""
    arr = np.asarray(boxes, np.float32)
    out = []
    for i in range(len(arr)):
        lo, hi = max(0, i - window // 2), min(len(arr), i + window // 2 + 1)
        out.append(tuple(int(round(v)) for v in arr[lo:hi].mean(axis=0)))
    return out


def refine_boxes_flow(
    frames: Sequence[np.ndarray],
    boxes: List[BBox],
    anchors: List[int],
    *,
    patch: int = 48,
    max_step_frac: float = 0.35,
) -> List[BBox]:
    """Per-frame refinement between detection anchors (VERDICT r2 #9): the
    face patch is tracked frame-to-frame by phase correlation, with linear
    drift correction so each segment lands exactly on the next anchored
    detection. Fast head motion inside a window — which pure window
    interpolation lags — follows the actual pixels."""
    n = len(frames)
    if n == 0 or not anchors:
        return list(boxes)
    out = np.asarray(boxes, np.float32).copy()
    anchors = sorted(set(int(a) for a in anchors))
    # interior segments run detection→detection (drift-corrected to land on
    # the far anchor); boundary segments run detection→clip edge where no
    # detection exists — pure flow there, NO correction (correcting toward
    # the interpolated edge box would drag the track back off the face)
    segments = [(c0, c1, True) for c0, c1 in zip(anchors[:-1], anchors[1:])]
    if anchors[0] > 0:
        segments.insert(0, (anchors[0], 0, False))
    if anchors[-1] < n - 1:
        segments.append((anchors[-1], n - 1, False))
    h, w = np.asarray(frames[0]).shape[:2]
    for c0, c1, correct in segments:
        if c0 == c1:
            continue
        step = 1 if c1 > c0 else -1
        box = out[c0].copy()
        bh, bw = box[2] - box[0], box[3] - box[1]
        if bh < 4 or bw < 4:
            continue
        max_dy, max_dx = max_step_frac * bh, max_step_frac * bw
        prev_patch = _gray_patch(frames[c0], box, patch)
        pred = {c0: box.copy()}
        for f in range(c0 + step, c1 + step, step):
            cur_patch = _gray_patch(frames[f], box, patch)
            dy, dx = _phase_shift(prev_patch, cur_patch)
            # patch pixels → frame pixels; clamp implausible jumps
            dy = float(np.clip(dy * bh / patch, -max_dy, max_dy))
            dx = float(np.clip(dx * bw / patch, -max_dx, max_dx))
            box = box + np.asarray([dy, dx, dy, dx], np.float32)
            box[0::2] = np.clip(box[0::2], 0, h - 1)
            box[1::2] = np.clip(box[1::2], 0, w - 1)
            pred[f] = box.copy()
            prev_patch = _gray_patch(frames[f], box, patch)
        # drift correction: distribute the endpoint error linearly so the
        # segment still lands on the detected box at c1 (interior only —
        # both endpoints are real detections there)
        err = (out[c1] - pred[c1]) if correct else np.zeros(4, np.float32)
        span = abs(c1 - c0)
        for f in pred:
            a = abs(f - c0) / span
            out[f] = pred[f] + a * err
    return [tuple(int(round(v)) for v in b) for b in out]


def per_frame_face_boxes(
    frames: Sequence[np.ndarray], fps: float = 25.0, *, window_s: float = 2.0,
    refine: bool = True,
) -> List[BBox]:
    """Per-frame face boxes: windowed detections → linear interpolation →
    phase-correlation flow refinement between anchors (``refine``) → 5-frame
    smoothing (the reference's per-frame S3FD/DWPose boxes get the same
    5-frame smoothing — api_inference_logic.py:89-97, diff2lip smooth_boxes).

    With a learned detector mounted the pipeline is the reference's exact
    shape instead: TRUE per-frame detection + 5-frame smoothing, no windowed
    interpolation or flow refinement needed. Frames the detector misses
    inherit the previous detection (the reference's coord_placeholder reuse);
    a clip it misses entirely falls through to the classical path."""
    n = len(frames)
    det = learned_detector()
    if det is not None and n > 0:
        try:
            boxes, last = [], None
            for f in frames:
                b = det(np.asarray(f))
                if b is not None:
                    last = b
                boxes.append(last)
            if last is not None:
                first = next(b for b in boxes if b is not None)
                boxes = [b if b is not None else first for b in boxes]
                return smooth_boxes(boxes) if n > 1 else list(boxes)
        except Exception as e:  # noqa: BLE001 — degrade to classical
            log.warning("face: per-frame learned detection failed (%s); "
                        "using classical tracking", e)
    tracks = track_face_windows(frames, fps, window_s=window_s)
    if not tracks or all(t is None for t in tracks):
        h, w = np.asarray(frames[0]).shape[:2]
        s = min(h, w)
        y0, x0 = (h - s) // 2, (w - s) // 2
        return [(y0, x0, y0 + s, x0 + s)] * n
    win = max(int(window_s * fps), 4)
    centers = [min(i * win + win // 2, n - 1) for i in range(len(tracks))]
    # only REAL detections anchor the flow's drift correction: gap-filled
    # windows carry a copied neighbour box at the wrong place, and correcting
    # toward them drags the track off the face exactly where detection failed
    real_anchors = [c for c, t in zip(centers, tracks) if t.detected]
    boxes_at = np.asarray([t.face for t in tracks], np.float32)
    out: List[BBox] = []
    for f in range(n):
        j = int(np.searchsorted(centers, f))
        if j == 0:
            box = boxes_at[0]
        elif j >= len(centers):
            box = boxes_at[-1]
        else:
            c0, c1 = centers[j - 1], centers[j]
            a = (f - c0) / max(c1 - c0, 1)
            box = (1 - a) * boxes_at[j - 1] + a * boxes_at[j]
        out.append(tuple(int(round(v)) for v in box))
    if refine and n > 1 and real_anchors:
        out = refine_boxes_flow(frames, out, real_anchors)
    return smooth_boxes(out) if n > 1 else out
