"""Per-job output analysis → analysis_results.csv (the port's copy of the
JAX package's ``evals/analyze.py``; the ECAPA similarity, the NLLB semantic
scorer and mounted visual members run on ``device``, the card unless
``device="cpu"``).

A working rebuild of Evaluation/analyze_outputs.py (599 LoC WIP template with
syntax/name errors — ``return results-`` at :511, undefined
``run_mediapi_equation`` at :482, scope bugs at :479/:548; SURVEY.md repo-health
notes). Orchestrates the metric battery per manifest job for two systems
(ours vs a comparison dir) and writes one CSV row per job.

Covers the full reference column set:

- linguistic: BLEU/chrF/token-F1 vs reference transcripts; ``sonar_score`` /
  ``bert_score_f1`` are pluggable hooks (the reference's SONAR/BERTScore need
  checkpoints absent here) — absent hooks emit NaN, never crash (the
  reference template crashed)
- audio: F0/intensity/HNR (:142-175), ECAPA speaker similarity (:113-121),
  SER emotion label (:125-138 — acoustic-proxy classifier, evals/ser.py)
- visual (when ``{job_id}.mp4`` exists): emotion label, identity distance,
  AU proxies, mouth↔audio correlation, head-pose std, deepfake-artifact
  score (:177-426 — self-contained stand-ins, evals/visual_metrics.py)

Extra per-job callables can be added via ``extra_metrics``.
"""

from __future__ import annotations

import csv
import json
import logging
from pathlib import Path
from typing import Any, Callable, Dict, List, Optional

import numpy as np

from ..media.wavio import read_wav
from .acoustic_metrics import (
    f0_statistics,
    harmonics_to_noise_ratio,
    rms_intensity,
    speaker_similarity,
)
from .text_metrics import chrf, sentence_bleu, token_f1

log = logging.getLogger(__name__)


def analyze_single_job(
    job_id: str,
    system_dir: Path,
    reference_dir: Optional[Path] = None,
    *,
    source_audio: Optional[np.ndarray] = None,
    extra_metrics: Optional[Dict[str, Callable[..., float]]] = None,
    device=None,
) -> Dict[str, Any]:
    """Metrics for one job's outputs ({job_id}.wav + {job_id}_transcripts.json)."""
    row: Dict[str, Any] = {"job_id": job_id}
    wav = system_dir / f"{job_id}.wav"
    if not wav.exists():
        err = system_dir / f"{job_id}.error"
        row["status"] = "error" if err.exists() else "missing"
        return row
    row["status"] = "ok"

    audio, sr = read_wav(wav)
    audio = np.asarray(audio, np.float32).reshape(-1)
    row["duration_s"] = round(len(audio) / sr, 2)
    row.update({k: round(v, 3) for k, v in f0_statistics(audio, sr).items()})
    row.update({k: round(v, 2) for k, v in rms_intensity(audio).items()})
    row["hnr_db"] = round(harmonics_to_noise_ratio(audio, sr), 2)

    from .ser import classify_audio_emotion

    row["audio_emotion"] = classify_audio_emotion(audio, sr)

    # semantic scores are checkpoint-backed in the reference (SONAR,
    # BERTScore — analyze_outputs.py:92-109). Here they run off the baked
    # NLLB encoder (EST_MODELS_DIR/nmt — SONAR's text encoder is itself
    # NLLB-derived): evals/semantic.py. NaN when no checkpoint is mounted.
    row.setdefault("sonar_score", float("nan"))
    row.setdefault("bert_score_f1", float("nan"))

    video = system_dir / f"{job_id}.mp4"
    if video.exists():
        try:
            from ..media import native
            from .acoustic_metrics import av_sync_correlation
            from .visual_metrics import video_metrics

            frames, fps = native.decode_video(video, max_frames=240)
            src_video = (reference_dir / f"{job_id}.mp4") if reference_dir else None
            src_frames = None
            if src_video is not None and src_video.exists():
                src_frames, _ = native.decode_video(src_video, max_frames=240)
            # mouth-opening series computed ONCE, shared by the battery's
            # lip_audio_correlation and the av-sync column below
            from ..pipeline.face import FaceLandmarkDetector

            activity = FaceLandmarkDetector().mouth_area_series(
                frames, frame_skip=1)
            row.update(video_metrics(frames, fps, audio, sr,
                                     source_frames=src_frames,
                                     mouth_openings=activity, device=device))
            # AV-sync confidence = mouth-activity↔envelope correlation at the
            # video frame rate (SyncNet-confidence stand-in)
            row["av_sync_confidence"] = round(
                av_sync_correlation(audio, sr, activity, fps), 4)
        except Exception:  # noqa: BLE001 — visual battery must not kill the sweep
            log.exception("visual metrics failed for %s", job_id)
            row["visual_metrics_error"] = True

    tpath = system_dir / f"{job_id}_transcripts.json"
    transcripts = json.loads(tpath.read_text()) if tpath.exists() else {}
    row["target_text"] = transcripts.get("target", "")

    if reference_dir is not None:
        ref_t = reference_dir / f"{job_id}_transcripts.json"
        if ref_t.exists():
            ref_text = json.loads(ref_t.read_text()).get("target", "")
            row["bleu_vs_ref"] = round(sentence_bleu(row["target_text"], [ref_text]), 2)
            row["chrf_vs_ref"] = round(chrf(row["target_text"], ref_text), 2)
            row["token_f1_vs_ref"] = round(token_f1(row["target_text"], ref_text), 3)
            from .semantic import default_scorer

            scorer = default_scorer(device)
            if scorer.available() and row["target_text"] and ref_text:
                try:
                    row["sonar_score"] = round(
                        scorer.sonar_score(row["target_text"], ref_text), 4)
                    row["bert_score_f1"] = round(
                        scorer.bert_score_f1(row["target_text"], ref_text), 4)
                except Exception:  # noqa: BLE001 — scorer must not kill the sweep
                    log.exception("semantic scorer failed for %s", job_id)
        ref_w = reference_dir / f"{job_id}.wav"
        if ref_w.exists():
            ref_audio, _ = read_wav(ref_w)
            row["speaker_sim_vs_ref"] = round(
                speaker_similarity(audio, np.asarray(ref_audio).reshape(-1),
                                   device=device), 4
            )

    if source_audio is not None:
        row["speaker_sim_vs_source"] = round(
            speaker_similarity(audio, source_audio, device=device), 4)

    for name, fn in (extra_metrics or {}).items():
        try:
            row[name] = fn(audio=audio, sr=sr, job_id=job_id)
        except Exception:  # noqa: BLE001 — hooks must not kill the sweep
            log.exception("extra metric %s failed for %s", name, job_id)
            row[name] = float("nan")
    return row


def analyze_outputs(
    manifest_rows: List[Dict[str, str]],
    system_dir: str | Path,
    reference_dir: Optional[str | Path] = None,
    out_csv: str | Path = "analysis_results.csv",
    **kwargs: Any,
) -> List[Dict[str, Any]]:
    """All jobs → CSV (analyze_outputs.py:517-599 orchestration, fixed)."""
    system_dir = Path(system_dir)
    reference_dir = Path(reference_dir) if reference_dir else None
    rows = [
        analyze_single_job(r["job_id"], system_dir, reference_dir, **kwargs)
        for r in manifest_rows
    ]
    fields: List[str] = []
    for r in rows:
        for k in r:
            if k not in fields:
                fields.append(k)
    with Path(out_csv).open("w", newline="") as f:
        writer = csv.DictWriter(f, fieldnames=fields)
        writer.writeheader()
        writer.writerows(rows)
    log.info("wrote %d analysis rows to %s", len(rows), out_csv)
    return rows
