"""Visual evaluation battery — self-contained stand-ins for the reference's
external visual models, built on the port's own face/mouth localization
(pipeline/face.py); the port's copy of the JAX package's
``evals/visual_metrics.py``. The proxies are numpy on the host; mounted
learned members run on the registry's device.

Reference → stand-in map (Evaluation/analyze_outputs.py:177-426):

- DeepFace visual emotion (:177-218)          → mouth-geometry quadrant label
- ArcFace identity distance (:231-255)        → face-crop embedding cosine
  distance (normalized grayscale structure + chroma histogram)
- OpenFace Action Units (:259-275)            → AU12 (lip-corner pull, mouth
  width) / AU25-26 (jaw drop, open-mouth area) proxies from the lip map
- MediaPipe mouth↔audio correlation + head
  pose std (:277-370)                         → mouth-area series ↔ envelope
  Pearson; head pose std from mouth-peak offset inside the face box
- DFDC deepfake probability (:372-426)        → temporal-artifact score
  (face-region flicker + boundary blockiness)

Each function documents exactly what it measures; absolute numbers are not
comparable to the external models, but the *relative* orderings the MCF study
consumes (system A vs system B on the same inputs) are.

When real learned models ARE mounted (``$EST_MODELS_DIR/arcface``,
``/visual_emotion``, ``/deepfake`` — see :mod:`.visual_models`), the battery
dispatches to them instead, and ``video_metrics`` labels each member's source
(``visual_battery_sources`` CSV column) so proxy orderings are never mistaken
for learned absolute scores.
"""

from __future__ import annotations

import logging
from typing import Dict, Optional, Sequence

import numpy as np

from ..pipeline.face import (
    FaceLandmarkDetector,
    detect_face_bbox,
    detect_mouth_bbox,
    lip_map,
    mouth_open_area,
)

log = logging.getLogger(__name__)


def _mid_face_crop(frames: np.ndarray, size: int = 64) -> Optional[np.ndarray]:
    """Face crop from the clip (resized to size×size float [0,1])."""
    box = detect_face_bbox(frames)
    if box is None:
        return None
    y0, x0, y1, x1 = box
    crop = np.asarray(frames[len(frames) // 2][y0:y1, x0:x1], np.float32) / 255.0
    if crop.size == 0:
        return None
    ys = np.linspace(0, crop.shape[0] - 1, size).astype(int)
    xs = np.linspace(0, crop.shape[1] - 1, size).astype(int)
    return crop[ys][:, xs]


def _identity_embedding(crop: np.ndarray) -> np.ndarray:
    """Pose-tolerant identity features: zero-mean grayscale structure at low
    resolution + chroma histograms (ArcFace stand-in — analyze_outputs.py:231)."""
    gray = crop.mean(axis=-1)
    gray = (gray - gray.mean()) / (gray.std() + 1e-6)
    small = gray[::4, ::4].reshape(-1)
    hists = [
        np.histogram(crop[..., c], bins=16, range=(0.0, 1.0), density=True)[0]
        for c in range(crop.shape[-1])
    ]
    emb = np.concatenate([small, np.concatenate(hists)])
    return emb / (np.linalg.norm(emb) + 1e-9)


def visual_identity_distance(
    source_frames: np.ndarray, output_frames: np.ndarray,
) -> float:
    """Cosine distance between face-crop embeddings (lower = same identity
    preserved; DeepFace.verify 'distance' semantics). Uses the mounted
    ArcFace-style embedder when present (visual_models.registry().identity),
    the classical proxy otherwise."""
    from .visual_models import registry

    a = _mid_face_crop(source_frames)
    b = _mid_face_crop(output_frames)
    if a is None or b is None:
        return float("nan")
    learned = registry().identity
    if learned is not None:
        try:
            ea, eb = (np.asarray(learned(c), np.float32).reshape(-1)
                      for c in (a, b))
            ea = ea / (np.linalg.norm(ea) + 1e-9)
            eb = eb / (np.linalg.norm(eb) + 1e-9)
            return float(1.0 - np.dot(ea, eb))
        except Exception:  # noqa: BLE001 — degrade to the proxy, don't crash the battery
            log.warning("learned identity model failed; proxy", exc_info=True)
    return float(1.0 - np.dot(_identity_embedding(a), _identity_embedding(b)))


def action_units(frames: np.ndarray) -> Dict[str, float]:
    """OpenFace AU proxies over the clip (analyze_outputs.py:259-275):
    AU12 (lip-corner pull) ≈ normalized lip-map horizontal spread;
    AU25/26 (lips part / jaw drop) ≈ open-mouth interior area."""
    det = FaceLandmarkDetector()
    track = det.track(frames)
    if track is None or track.mouth is None:
        return {"au12_mean": float("nan"), "au25_mean": float("nan"),
                "au12_std": float("nan"), "au25_std": float("nan")}
    fy0, fx0, fy1, fx1 = track.face
    face_area = float((fy1 - fy0) * (fx1 - fx0))
    my0, mx0, my1, mx1 = track.mouth
    widths, opens = [], []
    for f in frames[::3]:
        m = lip_map(np.asarray(f)[my0:my1, mx0:mx1])
        thr = 0.5 * float(m.max()) if m.size else 0.0
        xs = np.nonzero((m > thr).any(axis=0))[0]
        widths.append((xs.max() - xs.min() + 1) / max(mx1 - mx0, 1) if len(xs) else 0.0)
        opens.append(mouth_open_area(f, track.mouth, face_area))
    return {
        "au12_mean": float(np.mean(widths)), "au12_std": float(np.std(widths)),
        "au25_mean": float(np.mean(opens)), "au25_std": float(np.std(opens)),
    }


def classify_visual_emotion(frames: np.ndarray,
                            aus: Optional[Dict[str, float]] = None) -> str:
    """Dominant-emotion label from mouth geometry (DeepFace stand-in,
    analyze_outputs.py:177-218): wide+open → happy, narrow+open → surprise,
    wide+closed+active → happy (a smile), else → neutral. Pass precomputed
    ``aus`` to share one tracking pass with the rest of the battery. A
    mounted emotion classifier (visual_models.registry().emotion) replaces
    the geometry heuristic."""
    from .visual_models import registry

    learned = registry().emotion
    if learned is not None:
        try:
            return str(learned(np.asarray(frames)))
        except Exception:  # noqa: BLE001 — degrade to the proxy
            log.warning("learned emotion model failed; proxy", exc_info=True)
    if aus is None:
        aus = action_units(frames)
    if np.isnan(aus["au12_mean"]):
        return "no_face_detected"
    wide = aus["au12_mean"] > 0.55
    open_ = aus["au25_mean"] > 0.05
    active = aus["au25_std"] > 0.01
    if wide and open_:
        return "happy"
    if open_ and not wide:
        return "surprise"
    if wide and active:
        return "happy"       # smiling mouth, mostly closed but moving
    return "neutral"


def mouth_audio_correlation(
    frames: np.ndarray, fps: float, audio: np.ndarray, sr: int = 16_000,
    *, openings: Optional[np.ndarray] = None,
) -> float:
    """Pearson correlation between per-frame mouth opening and the audio
    envelope (analyze_outputs.py:277-370 run_mediapipe_analysis semantics:
    landmark mouth opening vs mean |y| per frame-length window). Pass
    precomputed ``openings`` to share one tracking pass with other metrics."""
    if openings is None:
        det = FaceLandmarkDetector()
        openings = det.mouth_area_series(frames, frame_skip=1)
    if len(openings) < 2:
        return 0.0
    y = np.abs(np.asarray(audio, np.float32).reshape(-1))
    frame_len = max(int(sr / fps), 1)
    env = np.asarray([
        y[i: i + frame_len].mean() for i in range(0, len(y), frame_len)
    ])
    n = min(len(openings), len(env))
    if n < 2:
        return 0.0
    a, b = openings[:n], env[:n]
    sa, sb = a.std(), b.std()
    if sa < 1e-9 or sb < 1e-9:
        return 0.0
    return float(np.corrcoef(a, b)[0, 1])


def head_pose_std(frames: np.ndarray) -> Dict[str, float]:
    """Head-pose variability proxies (analyze_outputs.py head_pose_*_std):
    yaw/pitch read as the mouth-peak offset within the face box (a turning
    head translates the mouth horizontally; a nodding head vertically),
    measured per short temporal slice and reported as std in box units."""
    n = len(frames)
    if n < 8:
        return {"head_pose_yaw_std": 0.0, "head_pose_pitch_std": 0.0}
    face = detect_face_bbox(frames)
    if face is None:
        return {"head_pose_yaw_std": 0.0, "head_pose_pitch_std": 0.0}
    fy0, fx0, fy1, fx1 = face
    fh, fw = max(fy1 - fy0, 1), max(fx1 - fx0, 1)
    xs, ys = [], []
    slice_len = max(n // 8, 2)
    for s in range(0, n - slice_len + 1, slice_len):
        mouth = detect_mouth_bbox(frames[s: s + slice_len], face, max_samples=4)
        if mouth is None:
            continue
        my0, mx0, my1, mx1 = mouth
        xs.append(((mx0 + mx1) / 2 - (fx0 + fx1) / 2) / fw)
        ys.append(((my0 + my1) / 2 - (fy0 + fy1) / 2) / fh)
    if len(xs) < 2:
        return {"head_pose_yaw_std": 0.0, "head_pose_pitch_std": 0.0}
    return {"head_pose_yaw_std": float(np.std(xs)),
            "head_pose_pitch_std": float(np.std(ys))}


def deepfake_artifact_score(frames: np.ndarray) -> float:
    """Deepfake-probability stand-in in [0, 1] (analyze_outputs.py:372-426
    DFDC): generated mouths flicker frame-to-frame and leave blending seams.
    Score = normalized face-region temporal flicker (vs global motion) +
    box-boundary gradient discontinuity. A mounted DFDC-style classifier
    (visual_models.registry().deepfake) replaces the artifact heuristic."""
    from .visual_models import registry

    learned = registry().deepfake
    if learned is not None:
        try:
            return float(learned(np.asarray(frames)))
        except Exception:  # noqa: BLE001 — degrade to the proxy
            log.warning("learned deepfake model failed; proxy", exc_info=True)
    n = len(frames)
    face = detect_face_bbox(frames)
    if face is None or n < 3:
        return float("nan")
    y0, x0, y1, x1 = face
    jaw0 = y0 + (y1 - y0) // 2
    diffs_face, diffs_glob = [], []
    for i in range(0, n - 1, max(n // 12, 1)):
        a = np.asarray(frames[i], np.float32).mean(axis=-1)
        b = np.asarray(frames[i + 1], np.float32).mean(axis=-1)
        d = np.abs(b - a)
        diffs_face.append(float(d[jaw0:y1, x0:x1].mean()))
        diffs_glob.append(float(d.mean()))
    flicker_ratio = np.mean(diffs_face) / (np.mean(diffs_glob) + 1e-6)
    # boundary seam: gradient magnitude straddling the face-box edge vs inside
    mid = np.asarray(frames[n // 2], np.float32).mean(axis=-1)
    grad = np.abs(np.diff(mid, axis=0))
    if 1 <= y1 < grad.shape[0]:
        seam = float(grad[y1 - 1, x0:x1].mean())
        inside = float(grad[max(y0, 1):y1 - 1, x0:x1].mean()) + 1e-6
        seam_ratio = seam / inside
    else:
        seam_ratio = 1.0
    score = 0.5 * np.tanh(max(flicker_ratio - 1.5, 0.0)) + 0.5 * np.tanh(
        max(seam_ratio - 1.5, 0.0))
    return float(np.clip(score, 0.0, 1.0))


def video_metrics(
    frames: np.ndarray, fps: float, audio: np.ndarray, sr: int = 16_000,
    *, source_frames: Optional[np.ndarray] = None,
    mouth_openings: Optional[np.ndarray] = None, device=None,
) -> Dict[str, object]:
    """The full visual column set for one job (analyze_outputs.py battery).
    The per-frame tracking pass (action_units) runs ONCE and is shared with
    the emotion classifier — it dominates the sweep's cost. Callers that
    also need the mouth-opening series (av-sync) pass ``mouth_openings``.
    Mounted learned members are discovered onto ``device`` (the card unless
    ``device="cpu"``) if the registry has not been built yet."""
    from .visual_models import registry

    registry(device)
    aus = action_units(frames)
    out: Dict[str, object] = {
        "visual_emotion": classify_visual_emotion(frames, aus),
        "lip_audio_correlation": round(
            mouth_audio_correlation(frames, fps, audio, sr,
                                    openings=mouth_openings), 4),
        "deepfake_score": deepfake_artifact_score(frames),
    }
    out.update({k: round(v, 4) for k, v in head_pose_std(frames).items()})
    out.update({k: (round(v, 4) if not np.isnan(v) else v)
                for k, v in aus.items()})
    if source_frames is not None:
        out["visual_identity_distance"] = round(
            visual_identity_distance(source_frames, frames), 4)
    out["visual_battery_sources"] = ";".join(
        f"{k}={v}" for k, v in registry().sources().items())
    return out
