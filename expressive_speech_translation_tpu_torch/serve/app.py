"""HTTP server: the JAX package's WSGI app (``serve/app.py``) on werkzeug,
over the port's backend.

Routes:
  POST /translate                  (rate limit 20/min; ``stream=true`` → SSE)
  POST /translate-text
  POST /process-video              (SSE; 10/min)
  GET  /available-backends
  GET  /supported-languages
  POST /process-audio-url          (10/min)
  GET  /translation-service-status
  POST /upload_podcast             (5/min)
  GET  /podcasts, /podcasts/<id>, /podcasts/<id>/audio
  GET  /health/model
  GET  /auth-config
  GET  /, /static/<path>           (the SPA)

Around them: CORS for the configured origins, default limits of 500/day and
100/hour (health, status, auth-config and static files exempt), a
content-type gate on POSTs, one error handler that answers every
:class:`ESTError` with its status and payload, shutdown hooks, and a hard
fail at start-up when the default backend does not initialise.

This is the only module of the port that imports werkzeug at module level
(the model services and the clients import it where they use it).

    EST_ENGINES__MODE=jax python -m expressive_speech_translation_tpu_torch.serve.app
"""

from __future__ import annotations

import atexit
import base64
import json
import logging
import os
import signal
import sys
import time
from pathlib import Path
from typing import Any, Dict, Optional

import numpy as np
from werkzeug.exceptions import HTTPException, NotFound
from werkzeug.routing import Map, Rule
from werkzeug.wrappers import Request, Response

from ..core.config import AppConfig
from ..core.errors import ESTError, ValidationError, error_id
from ..media.wavio import read_wav_bytes, wav_bytes
from ..obs.logging_setup import new_request_id, setup_logging
from ..pipeline.audio_processor import AudioProcessor
from ..pipeline.backend import TranslationManager
from .audio_link import process_audio_url
from .limiter import RateLimiter
from .podcasts import PodcastStore
from .resource_monitor import check_resources, device_memory_stats, process_rss_bytes
from .video import VideoProcessor, generate_progress_event

log = logging.getLogger(__name__)


def _json(payload: Dict[str, Any], status: int = 200) -> Response:
    return Response(json.dumps(payload), status=status, mimetype="application/json")


class App:
    """The WSGI application. ``device`` is where its audio processing runs:
    the card unless ``device="cpu"``."""

    def __init__(
        self,
        manager: TranslationManager,
        config: Optional[AppConfig] = None,
        *,
        video_io=None,
        url_fetcher=None,
        device=None,
    ):
        self.config = config or AppConfig()
        self.manager = manager
        self.audio_processor = AudioProcessor(self.config.audio, device=device)
        self.device = self.audio_processor.device
        self.limiter = RateLimiter(self.config.serve.default_limits)
        self.video_processor = (
            VideoProcessor(video_io, temp_root=self.config.temp_dir,
                           max_video_mb=self.config.audio.max_video_mb,
                           audio_processor=self.audio_processor)
            if video_io is not None else None
        )
        if url_fetcher is None:
            # yt-dlp when installed, the direct media download otherwise
            # (audio_link_routes.py:83-180's role; serve/media_fetcher.py)
            from .media_fetcher import default_fetcher

            url_fetcher = default_fetcher
        self.url_fetcher = url_fetcher
        self.podcasts = PodcastStore(Path(self.config.temp_dir) / "podcasts")
        self.started_at = time.time()
        self.url_map = Map([
            Rule("/", endpoint="index", methods=["GET"]),
            Rule("/static/<path:filename>", endpoint="static", methods=["GET"]),
            Rule("/translate", endpoint="translate", methods=["POST"]),
            Rule("/translate-text", endpoint="translate_text", methods=["POST"]),
            Rule("/process-video", endpoint="process_video", methods=["POST"]),
            Rule("/available-backends", endpoint="available_backends", methods=["GET"]),
            Rule("/supported-languages", endpoint="supported_languages", methods=["GET"]),
            Rule("/process-audio-url", endpoint="process_audio_url", methods=["POST"]),
            Rule("/translation-service-status", endpoint="service_status", methods=["GET"]),
            Rule("/upload_podcast", endpoint="upload_podcast", methods=["POST"]),
            Rule("/podcasts", endpoint="list_podcasts", methods=["GET"]),
            Rule("/podcasts/<podcast_id>", endpoint="get_podcast", methods=["GET"]),
            Rule("/podcasts/<podcast_id>/audio", endpoint="get_podcast_audio",
                 methods=["GET"]),
            Rule("/health/model", endpoint="health_model", methods=["GET"]),
            Rule("/auth-config", endpoint="auth_config", methods=["GET"]),
        ])
        self._route_limits = {
            "translate": (self.config.serve.translate_limit,),
            "process_video": (self.config.serve.video_limit,),
            "process_audio_url": (self.config.serve.audio_url_limit,),
            "upload_podcast": (self.config.serve.podcast_limit,),
        }
        # exempt from the default limits: liveness probes, the SPA's status
        # polls and its assets must never answer 429; the expensive routes
        # above keep their own budgets
        self._unlimited_endpoints = frozenset({
            "health_model", "service_status", "auth_config", "static", "index",
        })

    # ------------------------------------------------------------------ WSGI

    def __call__(self, environ, start_response):
        request = Request(environ)
        t0 = time.perf_counter()
        try:
            response = self.dispatch(request)
        except ESTError as e:
            log.warning("request error %s: %s", e.error_id, e)
            response = _json(e.to_payload(), e.http_status)
        except HTTPException as e:
            response = _json({"error": e.description or e.name}, e.code or 500)
        except Exception as e:  # noqa: BLE001 — the central error handler
            eid = error_id(repr(e))
            log.exception("unhandled error %s", eid)
            response = _json({"error": "An internal error occurred", "error_id": eid}, 500)
        self._apply_cors(request, response)
        log.info("%s %s -> %s (%.3fs)", request.method, request.path,
                 response.status_code, time.perf_counter() - t0)
        return response(environ, start_response)

    def dispatch(self, request: Request) -> Response:
        if request.method == "OPTIONS":  # CORS preflight
            return Response(status=204)
        adapter = self.url_map.bind_to_environ(request.environ)
        endpoint, args = adapter.match()

        if request.method == "POST" and endpoint != "process_audio_url":
            ct = request.content_type or ""
            if not (ct.startswith("multipart/form-data") or ct.startswith("application/json")):
                raise ValidationError("Content-Type must be multipart/form-data or application/json")

        # counters are kept per (client, route), so static and status hits
        # never spend the translate budget
        if endpoint not in self._unlimited_endpoints:
            limits = self._route_limits.get(endpoint, ())
            ok, rule = self.limiter.check(
                f"{request.remote_addr or 'anon'}|{endpoint}", limits)
            if not ok:
                return _json({"error": f"Rate limit exceeded ({rule})"}, 429)

        return getattr(self, f"route_{endpoint}")(request, **args)

    def _apply_cors(self, request: Request, response: Response) -> None:
        origin = request.headers.get("Origin", "")
        if origin in self.config.serve.cors_origins:
            response.headers["Access-Control-Allow-Origin"] = origin
            response.headers["Access-Control-Allow-Headers"] = "Content-Type"
            response.headers["Access-Control-Allow-Methods"] = "GET, POST, OPTIONS"

    # ---------------------------------------------------------------- routes

    def _read_upload(self, request: Request) -> tuple[np.ndarray, int, str, bytes]:
        # the byte-size gate comes before the body is buffered or decoded
        # (the duration caps run only after a full read)
        cap = int(self.config.audio.max_audio_upload_mb * 1024 * 1024)
        if (request.content_length or 0) > cap:
            raise ValidationError(
                f"Upload exceeds {self.config.audio.max_audio_upload_mb:g} MB")
        file = request.files.get("file") or request.files.get("audio")
        if file is None or not file.filename:
            raise ValidationError("No audio file provided")
        suffix = Path(file.filename).suffix.lower()
        if suffix not in self.audio_processor.SUPPORTED_FORMATS:
            raise ValidationError(
                f"Unsupported format {suffix!r}. Supported: "
                + ", ".join(self.audio_processor.SUPPORTED_FORMATS)
            )
        raw = file.read(cap + 1)
        if len(raw) > cap:
            raise ValidationError(
                f"Upload exceeds {self.config.audio.max_audio_upload_mb:g} MB")
        if suffix == ".wav":
            audio, sr = read_wav_bytes(raw, label=file.filename)
        else:
            from ..media import decode_audio_bytes

            audio, sr = decode_audio_bytes(raw, suffix)
        return audio, sr, file.filename, raw

    _STATIC_DIR = Path(__file__).parent / "static"
    _STATIC_TYPES = {".html": "text/html", ".js": "application/javascript",
                     ".css": "text/css", ".svg": "image/svg+xml"}

    def route_index(self, request: Request) -> Response:
        return self.route_static(request, filename="index.html")

    def route_static(self, request: Request, filename: str) -> Response:
        # containment compares against "<dir>/": a bare prefix would also
        # accept a sibling whose name starts with "static"
        path = (self._STATIC_DIR / filename).resolve()
        root = str(self._STATIC_DIR.resolve())
        if not str(path).startswith(root + os.sep) or not path.is_file():
            raise NotFound()
        mime = self._STATIC_TYPES.get(path.suffix, "application/octet-stream")
        return Response(path.read_bytes(), mimetype=mime)

    def route_translate(self, request: Request) -> Response:
        check_resources(self.config.serve.memory_threshold)
        target = request.form.get("target_language") or request.form.get("target_lang")
        if not target:
            raise ValidationError("target_language is required")
        source = request.form.get("source_language", "eng")
        backend_name = request.form.get("backend")
        audio, sr, _, _ = self._read_upload(request)

        # [T] or [C, T]: the duration is the last axis either way
        duration = np.asarray(audio).shape[-1] / max(sr, 1)
        self.audio_processor.validate_audio_length(duration)

        processed = self.audio_processor.process_audio(audio, orig_sr=sr)
        backend = self.manager.get_backend(backend_name)
        if (request.form.get("stream", "").lower() in ("1", "true", "yes")
                and hasattr(backend, "translate_speech_streaming")):
            req_id = new_request_id()

            def events():
                # a failure mid-stream ends it with an error frame
                phase = "Translating speech"
                prog = 50
                try:
                    for ev in backend.translate_speech_streaming(processed, source, target):
                        if ev["type"] == "transcripts":
                            # each transcripts frame supersedes the last;
                            # progress stays monotonic across them
                            yield generate_progress_event(
                                prog, phase,
                                transcripts={"source": ev["source"], "target": ev["target"]},
                                request_id=req_id)
                            phase = "Synthesizing speech"
                            prog = 75
                        else:
                            pcm = np.clip(ev["chunk"], -1.0, 1.0)
                            yield generate_progress_event(
                                75, phase,
                                audio_chunk=base64.b64encode(
                                    (pcm * 32767.0).astype("<i2").tobytes()).decode(),
                                sample_rate=ev["sample_rate"])
                    yield generate_progress_event(100, "Complete", done=True)
                except Exception as e:  # noqa: BLE001 — the SSE error frame
                    eid = error_id(repr(e))
                    log.exception("streaming translate failed %s", eid)
                    yield generate_progress_event(
                        100, phase, error="Translation failed", error_id=eid)

            # not direct_passthrough (JAX's app passes it): the frames are
            # str, and a WSGI server takes bytes only, so werkzeug must encode
            return Response(events(), mimetype="text/event-stream",
                            headers={"Cache-Control": "no-cache",
                                     "X-Accel-Buffering": "no"})
        result = backend.translate_speech(processed, source, target)
        encoded = base64.b64encode(wav_bytes(result["audio"][0], 16_000)).decode()
        return _json({
            "audio": encoded,
            "transcripts": result.get("transcripts", {}),
            "request_id": result.get("process_id", new_request_id()),
            "weights": getattr(backend, "weights_info", lambda: "unknown")(),
        })

    def route_process_video(self, request: Request) -> Response:
        if self.video_processor is None:
            raise ESTError("video processing unavailable: no media backend",
                           user_message="Video processing is not available")
        # the byte-size gate comes before the multipart parse buffers the body
        cap = self.video_processor.max_video_mb * 1e6
        if (request.content_length or 0) > cap + 1e6:   # +1 MB of form overhead
            raise ValidationError(
                f"Video too large ({(request.content_length or 0)/1e6:.1f} MB "
                f"> {self.video_processor.max_video_mb:.1f} MB)")
        file = request.files.get("file") or request.files.get("video")
        if file is None:
            raise ValidationError("No video file provided")
        target = request.form.get("target_language")
        if not target:
            raise ValidationError("target_language is required")
        source = request.form.get("source_language", "eng")
        backend = self.manager.get_backend(request.form.get("backend"))
        cloning = request.form.get("use_voice_cloning", "true").lower() != "false"
        lipsync = request.form.get("apply_lip_sync", "true").lower() == "true"
        stream = self.video_processor.process_video(
            file.read(), backend, source, target,
            filename=file.filename or "input.mp4", use_voice_cloning=cloning,
            apply_lip_sync=lipsync,
        )
        return Response(stream, mimetype="text/event-stream",
                        headers={"Cache-Control": "no-cache", "X-Accel-Buffering": "no"})

    def route_translate_text(self, request: Request) -> Response:
        """JSON or form {text, source_language, target_language, synthesize?}
        → {source_text, target_text, audio?}."""
        data = request.get_json(force=True, silent=True) or {}
        text = (data.get("text") or request.form.get("text") or "").strip()
        if not text:
            raise ValidationError("text is required")
        target = data.get("target_language") or request.form.get("target_language")
        if not target:
            raise ValidationError("target_language is required")
        source = data.get("source_language") or request.form.get("source_language") or "eng"
        synth = str(data.get("synthesize",
                             request.form.get("synthesize", ""))).lower() in (
            "1", "true", "yes")
        backend = self.manager.get_backend(
            data.get("backend") or request.form.get("backend"))
        if not hasattr(backend, "translate_text"):
            raise ValidationError(
                f"backend {type(backend).__name__} has no text mode")
        result = backend.translate_text(text, source, target, synthesize=synth)
        payload = {"source_text": result["source_text"],
                   "target_text": result["target_text"]}
        if "audio" in result:
            payload["audio"] = base64.b64encode(
                wav_bytes(result["audio"][0], 16_000)).decode()
        return _json(payload)

    def route_available_backends(self, request: Request) -> Response:
        # "backends" is a bare list of names; "weights" and "decode" give
        # each backend's provenance and decode modes at selection time
        return _json({
            "backends": self.manager.available_backends(),
            "default": self.manager.default_backend,
            "weights": self.manager.backend_weights(),
            "decode": self.manager.backend_decode(),
        })

    def route_auth_config(self, request: Request) -> Response:
        """The SPA's OIDC gate: enabled once an authority is configured."""
        s = self.config.serve
        return _json({
            "enabled": bool(s.auth_authority),
            "authority": s.auth_authority,
            "client_id": s.auth_client_id,
            "response_type": "code",
            "scope": s.auth_scope,
        })

    def route_supported_languages(self, request: Request) -> Response:
        backend = self.manager.get_backend()
        return _json({"languages": backend.get_supported_languages()})

    def route_process_audio_url(self, request: Request) -> Response:
        data = request.get_json(force=True, silent=True) or {}
        url = data.get("url") or request.form.get("url")
        if not url:
            raise ValidationError("url is required")
        target = data.get("target_language") or request.form.get("target_language")
        if not target:
            raise ValidationError("target_language is required")
        source = (data.get("source_language")
                  or request.form.get("source_language") or "eng")
        backend = self.manager.get_backend(
            data.get("backend") or request.form.get("backend"))
        result = process_audio_url(url, backend, target, source,
                                   fetcher=self.url_fetcher, device=self.device)
        encoded = base64.b64encode(wav_bytes(result["audio"][0], 16_000)).decode()
        return _json({"audio": encoded, "transcripts": result.get("transcripts", {})})

    def route_upload_podcast(self, request: Request) -> Response:
        """Save the upload under a UUID name and answer with its metadata
        (mm:ss duration, episode number); read back through GET /podcasts,
        /podcasts/<id> and /podcasts/<id>/audio."""
        audio, sr, filename, raw = self._read_upload(request)
        duration = np.asarray(audio).shape[-1] / max(sr, 1)
        self.audio_processor.validate_audio_length(
            duration, max_seconds=self.config.audio.max_podcast_seconds
        )
        meta = self.podcasts.save(
            raw, filename, title=request.form.get("title"),
            duration_seconds=float(duration), sample_rate=sr)
        return _json({**meta, "status": "uploaded"})

    def route_list_podcasts(self, request: Request) -> Response:
        return _json({"podcasts": self.podcasts.list()})

    def route_get_podcast(self, request: Request, podcast_id: str) -> Response:
        meta, _ = self.podcasts.get(podcast_id)
        return _json(meta)

    def route_get_podcast_audio(self, request: Request, podcast_id: str) -> Response:
        meta, path = self.podcasts.get(podcast_id)
        suffix = Path(meta["filename"]).suffix.lower()
        ctype = {".wav": "audio/wav", ".mp3": "audio/mpeg",
                 ".ogg": "audio/ogg", ".flac": "audio/flac"}.get(
            suffix, "application/octet-stream")
        return Response(path.read_bytes(), mimetype=ctype)

    def route_service_status(self, request: Request) -> Response:
        return _json({
            "status": "ok",
            "uptime_seconds": round(time.time() - self.started_at, 1),
            "backends": {
                name: {"initialized": getattr(self.manager.peek_backend(name), "initialized", False)}
                for name in self.manager.available_backends()
            },
        })

    def route_health_model(self, request: Request) -> Response:
        # peek, not get_backend(): the manager initialises lazily there,
        # which would make this route lie about a cold backend
        backend_ok = False
        weights = "unknown"
        placement: dict = {}
        decode: dict = {}
        name = self.manager.default_backend
        if name is not None:
            b = self.manager.peek_backend(name)
            backend_ok = bool(getattr(b, "initialized", False))
            weights = getattr(b, "weights_info", lambda: "unknown")()
            placement = getattr(b, "placement_info", dict)()
            decode = getattr(b, "decode_info", dict)()
        return _json({
            "healthy": backend_ok,
            "weights": weights,
            "placement": placement,
            "decode": decode,
            "process_rss_mb": round(process_rss_bytes() / 1e6, 1),
            "device_memory": device_memory_stats(),
        }, 200 if backend_ok else 503)


def create_app(
    manager: Optional[TranslationManager] = None,
    config: Optional[AppConfig] = None,
    *,
    device=None,
    **kwargs: Any,
) -> App:
    """Build the WSGI app. With no manager, register the cascaded backend
    over the engines ``config.engines.mode`` names ("" takes
    ``default_engine_mode``, "fake" here so that an embedded app stays
    hermetic; the server's entry point passes "jax"): "jax" is the port's
    own engines (``torch_engines``) on ``device``, "remote" the reference's
    split deployment (the port's ASR and NMT on ``device``, the TTS a
    :class:`~.clients.CosyVoiceClient` of ``endpoints.cosyvoice_url``,
    health-checked and warmed up before the app is returned), "fake" the
    fakes.
    ``device`` (the card unless ``device="cpu"``) also places the app's
    audio processing."""
    config = config or AppConfig()
    default_engine_mode = kwargs.pop("default_engine_mode", "fake")
    if manager is None:
        from ..pipeline.cascaded import CascadedBackend

        mode = config.engines.mode or default_engine_mode
        if mode == "jax":
            from ..pipeline.torch_engines import torch_engines

            engines = torch_engines(
                scale=config.engines.scale,
                device=device,
                quantize=config.engines.quantize,
                asr_context_buckets=tuple(config.engines.asr_context_buckets),
                tts_mtp=config.engines.tts_mtp,
                tts_spec=config.engines.tts_spec,
                stage_parallel=config.engines.stage_parallel,
                stage_tp=config.engines.stage_tp,
                batch_tts=config.serve.tts_batching,
                max_batch=config.serve.tts_max_batch,
                batch_wait_ms=config.serve.tts_batch_wait_ms,
            )
        elif mode == "remote":
            # the reference's split deployment: ASR and NMT in-process, TTS
            # through the CosyVoice container's contract (cascaded_backend.py:455-475)
            from ..pipeline.torch_engines import torch_engines
            from .clients import HttpTransport, remote_engines

            local = torch_engines(
                scale=config.engines.scale,
                device=device,
                quantize=config.engines.quantize,
                asr_context_buckets=tuple(config.engines.asr_context_buckets),
                tts_mtp=config.engines.tts_mtp,
                tts_spec=config.engines.tts_spec,
            )
            engines = remote_engines(
                HttpTransport(config.endpoints.cosyvoice_url),
                asr=local.asr, nmt=local.nmt,
                retries=config.endpoints.health_retries,
                retry_delay_s=config.endpoints.health_backoff_seconds,
            )
        elif mode == "fake":
            from ..pipeline.engines import fake_engines

            engines = fake_engines()
        else:
            raise ValueError(f"unknown engine mode {mode!r} (jax|remote|fake)")
        manager = TranslationManager()
        manager.register_backend("cascaded", CascadedBackend(engines), is_default=True)
    return App(manager, config, device=device, **kwargs)


def main() -> None:
    """python -m expressive_speech_translation_tpu_torch.serve.app"""
    from werkzeug.serving import run_simple

    from ..core.config import load_config

    config = load_config()
    setup_logging(config.log_dir)
    # multi-host serving: join the torch.distributed group before any engine
    # touches a card (a no-op on a single host)
    from ..parallel.mesh import maybe_initialize_distributed

    maybe_initialize_distributed(config.mesh)
    # the server defaults to the port's engines (mode "jax";
    # EST_ENGINES__MODE overrides); random weights show in /health/model
    # and in every /translate response. The video route runs in-process when
    # the native media shim builds: decode and mux through the C++ shim,
    # lip-sync through the resident MuseTalk pipeline (baked weights and the
    # whisper condition when EST_MODELS_DIR has them).
    video_io = None
    from ..media import native as est_media

    if est_media.available():
        from ..pipeline.musetalk_pipeline import default_lipsync_fn

        # lazy: building the MuseTalk pipeline (random weights = a full
        # SD-scale init) must not hold up startup when /process-video is not
        # used; the first video request pays for it. The lock matters:
        # run_simple(threaded=True) serves concurrent requests, and an
        # unguarded check-then-build would build the pipeline twice
        import threading

        _lipsync_cell: list = []
        _lipsync_lock = threading.Lock()

        def _lazy_lipsync(frames, fps, audio, sr):
            with _lipsync_lock:
                if not _lipsync_cell:
                    _lipsync_cell.append(default_lipsync_fn())
                fn = _lipsync_cell[0]
            return fn(frames, fps, audio, sr)

        video_io = est_media.NativeVideoIO(lipsync_fn=_lazy_lipsync)
    else:
        log.warning("native media shim not built: /process-video disabled "
                    "(deploy/ images build media/csrc)")
    app = create_app(config=config, default_engine_mode="jax", video_io=video_io)
    try:
        app.manager.get_backend()
    except Exception:
        log.exception("default backend failed to initialize")
        sys.exit(1)

    def shutdown(*_args):
        log.info("shutting down: cleaning up backends")
        app.manager.cleanup()
        sys.exit(0)

    atexit.register(app.manager.cleanup)
    signal.signal(signal.SIGTERM, shutdown)
    signal.signal(signal.SIGINT, shutdown)
    run_simple(config.serve.host, config.serve.port, app, threaded=True)


if __name__ == "__main__":
    main()
