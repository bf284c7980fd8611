"""Video dubbing as a stream of SSE progress frames (the JAX package's
``serve/video.py``).

A request runs in a UUID temp directory (with a path-escape guard): extract
the audio, check its length, ``process_audio``, translate (with the visual
speech mapping when the media backend decodes frames), then lip-sync, or mux
the dubbed audio when lip-sync fails or is disabled, watermark the delivered
MP4, and answer with its base64. Progress frames come at 10, 20, 30, 55, 60,
(75,) 90, then the final frame; the directory is removed in ``finally``.
A failure mid-stream ends the stream with an error frame.

Decode and encode go through a :class:`VideoIO`, so the pipeline runs
without containers under a test one.
"""

from __future__ import annotations

import base64
import json
import logging
import shutil
import uuid
from pathlib import Path
from typing import Any, Dict, Generator, Protocol

import numpy as np

from ..core.errors import MediaError, ValidationError, error_id
from ..obs.logging_setup import new_request_id
from ..pipeline.watermark import WaterMark, make_payload

log = logging.getLogger(__name__)

PROGRESS_STEPS = {
    "extract": 10, "preprocess": 20, "translate": 30, "watermark": 55,
    "lipsync": 60, "finalize": 75, "encode": 90,
}


class VideoIO(Protocol):
    def extract_audio(self, video_path: str) -> tuple[np.ndarray, int]:
        """video → (mono float32 audio, sample_rate)."""

    def mux(self, video_path: str, audio: np.ndarray, sr: int, out_path: str) -> None:
        """Replace the video's audio track."""

    def lipsync(self, video_path: str, audio: np.ndarray, sr: int, out_path: str) -> None:
        """Render lip-synced video (may raise — fallback is mux)."""


def generate_progress_event(progress: int, phase: str, **extra: Any) -> str:
    """One SSE frame: ``data: {"progress", "phase", ...}`` and a blank line."""
    payload = {"progress": progress, "phase": phase, **extra}
    return f"data: {json.dumps(payload)}\n\n"


class VideoProcessor:
    def __init__(
        self,
        video_io: VideoIO,
        *,
        temp_root: str | Path | None = None,
        max_video_mb: float = 150.0,
        audio_processor=None,
        device=None,
    ):
        """``audio_processor``: the app's configured AudioProcessor, so video
        requests get the audio route's resample and denoise settings and its
        ``max_audio_seconds`` cap (a 150 MB video can carry hours of
        low-bitrate audio). Without one, a default-configured processor is
        built on ``device`` (the card unless ``device="cpu"``)."""
        self.video_io = video_io
        if temp_root is None:
            # runtime artifacts live under the configured temp path, never cwd
            from ..core.config import _default_temp_dir

            temp_root = _default_temp_dir()
        self.temp_root = Path(temp_root).absolute()
        self.max_video_mb = max_video_mb
        if audio_processor is None:
            from ..pipeline.audio_processor import AudioProcessor

            audio_processor = AudioProcessor(device=device)
        self.audio_processor = audio_processor

    def _request_dir(self) -> Path:
        """A UUID temp directory, guarded against escaping the temp root."""
        req = uuid.uuid4().hex
        path = (self.temp_root / req).absolute()
        if not str(path).startswith(str(self.temp_root)):
            raise ValidationError("Invalid request path")
        path.mkdir(parents=True, exist_ok=True)
        return path

    def process_video(
        self,
        video_bytes: bytes,
        backend,
        source_lang: str,
        target_lang: str,
        *,
        filename: str = "input.mp4",
        use_voice_cloning: bool = True,
        apply_lip_sync: bool = True,
    ) -> Generator[str, None, None]:
        """Returns an SSE-frame generator; final frame carries the base64 MP4 +
        transcripts. Validation happens eagerly (before the 200 is committed)."""
        if len(video_bytes) > self.max_video_mb * 1e6:
            raise ValidationError(
                f"Video too large ({len(video_bytes)/1e6:.1f} MB > {self.max_video_mb:.1f} MB)"
            )
        req_dir = self._request_dir()
        req_id = new_request_id()
        return self._stream(video_bytes, backend, source_lang, target_lang,
                            filename=filename, req_dir=req_dir, req_id=req_id,
                            use_voice_cloning=use_voice_cloning,
                            apply_lip_sync=apply_lip_sync)

    def _stream(
        self, video_bytes, backend, source_lang, target_lang, *, filename,
        req_dir, req_id, use_voice_cloning=True, apply_lip_sync=True,
    ) -> Generator[str, None, None]:
        phase = "Starting"

        def _ev(step: str, label: str) -> str:
            nonlocal phase
            phase = label
            return generate_progress_event(PROGRESS_STEPS[step], label)

        try:
            # reserved name: the user's filename must never collide with the
            # pipeline's own artifacts (an upload literally named
            # "output.mp4" or "dubbed.wav" would be read and written as the
            # same file — corrupt render or destroyed source)
            src = req_dir / ("upload" + (Path(filename).suffix or ".mp4"))
            src.write_bytes(video_bytes)

            yield _ev("extract", "Extracting audio")
            audio, sr = self.video_io.extract_audio(str(src))
            # the same duration cap the audio route enforces (app.py
            # validate_audio_length) — a small video file can carry hours of
            # low-bitrate audio
            self.audio_processor.validate_audio_length(len(audio) / max(sr, 1))

            yield _ev("preprocess", "Preprocessing audio")
            audio16 = self.audio_processor.process_audio(audio, orig_sr=sr)

            # visual speech mapping: when the media backend decodes
            # (subsampled) frames, the dubbed audio is placed into the
            # on-screen speech segments instead of the natural flow
            frame_kw: Dict[str, Any] = {}
            frames_fn = getattr(self.video_io, "frames", None)
            if frames_fn is not None:
                try:
                    vframes, eff_fps = frames_fn(str(src))
                    if len(vframes):
                        frame_kw = dict(original_video_frames=list(vframes),
                                        video_fps=float(eff_fps))
                except Exception:  # noqa: BLE001 — mapping is best-effort
                    log.exception("frame decode for visual mapping failed "
                                  "(non-fatal; natural-flow mapping)")

            yield _ev("translate", "Translating speech")
            result = backend.translate_speech(
                audio16, source_lang, target_lang,
                use_voice_cloning=use_voice_cloning, **frame_kw)
            dubbed = result["audio"][0]

            yield _ev("watermark", "Adding watermark")
            # provenance is embedded in the DELIVERED artifact: the final MP4
            # gets a top-level free-box payload after mux/lipsync (a RIFF
            # ICMT chunk on an intermediate WAV would be discarded with the
            # temp dir and never reach the user)
            payload = make_payload(req_id)

            yield _ev("lipsync", "Applying lip sync")
            out_path = req_dir / "output.mp4"
            if not apply_lip_sync:
                # lip-sync disabled by the user: the same 75 tick, then the mux
                yield generate_progress_event(
                    PROGRESS_STEPS["finalize"],
                    "Lip sync disabled, combining audio with video")
                self.video_io.mux(str(src), dubbed, 16_000, str(out_path))
            else:
                try:
                    self.video_io.lipsync(str(src), dubbed, 16_000, str(out_path))
                    if not out_path.exists() or out_path.stat().st_size <= 1024:
                        raise MediaError("lip-sync output too small")
                except Exception:  # noqa: BLE001 — the fallback is the audio-dub mux
                    log.exception("lip sync failed; falling back to audio dub")
                    yield generate_progress_event(
                        PROGRESS_STEPS["finalize"], "Lip sync unavailable; muxing dubbed audio"
                    )
                    self.video_io.mux(str(src), dubbed, 16_000, str(out_path))

            try:
                WaterMark.add_watermark_mp4(out_path, payload)
            except Exception:  # noqa: BLE001 — a watermark failure is not fatal
                log.exception("watermarking failed (non-fatal)")

            yield _ev("encode", "Encoding result")
            encoded = base64.b64encode(out_path.read_bytes()).decode()
            yield (
                "data: "
                + json.dumps({
                    "progress": 100,
                    "phase": "complete",
                    "result": {
                        "video": encoded,
                        "transcripts": result.get("transcripts", {}),
                        "request_id": req_id,
                    },
                })
                + "\n\n"
            )
        except ValidationError as e:
            # mid-stream client errors (unsupported language, audio too
            # long): surface the user-safe message — the same text the audio
            # route returns as a 400 — instead of a generic failure frame
            log.info("video request rejected mid-stream: %s", e)
            yield generate_progress_event(
                100, phase, error=str(e), error_id=e.error_id)
        except Exception as e:  # noqa: BLE001 — a failure mid-stream ends
            # the stream with a data:{error, phase} frame, not a truncation
            eid = error_id(repr(e))
            log.exception("video processing failed %s (phase %s)", eid, phase)
            yield generate_progress_event(
                100, phase, error="Video processing failed", error_id=eid)
        finally:
            shutil.rmtree(req_dir, ignore_errors=True)
