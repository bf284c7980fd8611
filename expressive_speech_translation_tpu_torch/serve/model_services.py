"""The four model services of a split deployment (the JAX package's
``serve/model_services.py``, the reference's Docker microservice contracts).

The port runs every stage in-process, but the reference's container HTTP
contracts stay for split deployments and their clients (``serve/clients.py``):

- CosyVoice  (:8002)  ``POST /generate-speech/``  multipart: text, style_prompt,
                      reference_audio, model, stream → WAV (streamed with
                      ``stream``); ``GET /health`` (Docker/cosyvoice_api.py:82-153;
                      the model registry {"default", "greek"}, loaded lazily, :37-69)
- MuseTalk   (:8003)  ``POST /lipsync-video/``  multipart: video, audio → MP4, the
                      plain mux when the lip-sync fails (Docker/musetalk_api.py:48-77)
- Similarity (:8001)  ``POST /compare-voices/``  two audio files → cosine score
                      (Docker/similarity_api.py:27-74)
- OpenVoice  (:8004)  ``POST /clone-voice``  source + reference audio → converted
                      WAV at 22 050 Hz; ``GET /status`` (Docker/openvoice_api.py:119-288)

Each service is a small werkzeug WSGI app around an engine object, with an
8-character request id a call (cosyvoice_api.py:104). Each runs its device
work on its ``device``: the card unless ``device="cpu"``. werkzeug is
imported where a response or a route table is made, never at module level::

    python -m expressive_speech_translation_tpu_torch.serve.model_services \\
        {cosyvoice|musetalk|similarity|openvoice} [port]
"""

from __future__ import annotations

import functools
import json
import logging
import os
import struct
import tempfile
import threading
import time
from pathlib import Path
from typing import Any, Callable, Dict, Optional

import numpy as np
import torch

from ..core.device import resolve_device
from ..core.errors import ESTError, ValidationError, error_id
from ..media.wavio import read_wav_bytes, wav_bytes
from ..obs.logging_setup import new_request_id
from ..ops.resample import resample

log = logging.getLogger(__name__)


def _json(payload, status=200):
    from werkzeug.wrappers import Response

    return Response(json.dumps(payload), status=status, mimetype="application/json")


def _routes(*rules):
    """A werkzeug route table of (path, endpoint, method) rules."""
    from werkzeug.routing import Map, Rule

    return Map([Rule(path, endpoint=endpoint, methods=[method])
                for path, endpoint, method in rules])


def _wav_response(audio: np.ndarray, sr: int):
    from werkzeug.wrappers import Response

    return Response(wav_bytes(audio, sr), mimetype="audio/wav")


def _streaming_wav_response(chunks, sr: int):
    """Chunked-transfer WAV: a header with unbounded RIFF and data sizes (the
    live-stream convention players accept), then PCM16 chunks as they are
    synthesised, so the first byte waits one TTS chunk, not the utterance."""
    from werkzeug.wrappers import Response

    header = (
        b"RIFF" + struct.pack("<I", 0xFFFFFFFF) + b"WAVEfmt "
        + struct.pack("<IHHIIHH", 16, 1, 1, sr, sr * 2, 2, 16)
        + b"data" + struct.pack("<I", 0xFFFFFFFF)
    )

    def gen():
        yield header
        for c in chunks:
            pcm = np.clip(np.asarray(c, np.float32), -1.0, 1.0)
            yield (pcm * 32767.0).astype("<i2").tobytes()

    return Response(gen(), mimetype="audio/wav", direct_passthrough=True)


def _read_audio_upload(file) -> tuple[np.ndarray, int]:
    suffix = Path(file.filename or "a.wav").suffix.lower() or ".wav"
    raw = file.read()
    if suffix == ".wav":
        return read_wav_bytes(raw, label=file.filename or "upload")
    from ..media import decode_audio_bytes

    return decode_audio_bytes(raw, suffix)


def _resampled(audio: np.ndarray, sr: int, target: int, device: torch.device) -> np.ndarray:
    """``audio`` at ``target`` Hz through the port's resampler on ``device``."""
    if sr == target:
        return audio
    return resample(torch.from_numpy(audio).to(device), sr, target).cpu().numpy()


class _ServiceApp:
    """The WSGI plumbing the four services share: routing, a request id a
    call, every :class:`ESTError` answered with its status and payload, any
    other error a logged 500 with an error id."""

    routes: Any

    def __call__(self, environ, start_response):
        from werkzeug.wrappers import Request

        request = Request(environ)
        req_id = new_request_id()
        t0 = time.perf_counter()
        try:
            adapter = self.routes.bind_to_environ(environ)
            endpoint, args = adapter.match()
            response = getattr(self, f"route_{endpoint}")(request, req_id, **args)
        except ESTError as e:
            response = _json(e.to_payload(), e.http_status)
        except Exception as e:  # noqa: BLE001 — the service boundary
            eid = error_id(repr(e))
            log.exception("[%s] service error %s", req_id, eid)
            code = getattr(e, "code", None)       # a werkzeug HTTPException's status
            response = _json({"error": "internal error", "error_id": eid}, code or 500)
        log.info("[%s] %s %s -> %s (%.3fs)", req_id, request.method, request.path,
                 response.status_code, time.perf_counter() - t0)
        return response(environ, start_response)


class CosyVoiceService(_ServiceApp):
    """TTS with the model registry (default / greek, loaded lazily). With no
    factories the registry serves :class:`FakeTts`, as the JAX package's
    does; :func:`run_service` gives "default" the port's TTS engine. A
    reference at another rate is resampled to 16 kHz on ``device``."""

    def __init__(
        self,
        model_factories: Optional[Dict[str, Callable[[], Any]]] = None,
        *,
        batching: bool = False,
        max_batch: int = 8,
        batch_wait_ms: float = 20.0,
        device=None,
    ):
        if model_factories is None:
            from ..pipeline.engines import FakeTts

            model_factories = {"default": FakeTts, "greek": FakeTts}
        self.device = resolve_device(device)
        self._factories = model_factories
        self._models: Dict[str, Any] = {}
        self._load_lock = threading.Lock()
        self._batching = batching
        self._max_batch = max_batch
        self._batch_wait_ms = batch_wait_ms
        self.routes = _routes(("/generate-speech/", "generate", "POST"),
                              ("/health", "health", "GET"))

    def get_model(self, name: str):
        """Load once and keep (cosyvoice_api.py:37-69); with batching on, a
        model that serves batches goes behind the micro-batcher. Locked:
        under the threaded server two first requests would otherwise both
        run the factory, loading the weights twice and leaking the loser's
        collector thread."""
        key = name if name in self._factories else "default"
        if key not in self._models:
            with self._load_lock:
                if key not in self._models:
                    log.info("loading TTS model %r", key)
                    model = self._factories[key]()
                    if self._batching and hasattr(model, "synthesize_batch"):
                        from .batching import BatchedTts

                        model = BatchedTts(model, max_batch=self._max_batch,
                                           max_wait_ms=self._batch_wait_ms)
                    self._models[key] = model
        return self._models[key]

    def warm_up(self):
        """The start-up warm-up (cosyvoice_api.py:71-80)."""
        self.get_model("default").synthesize("Hello world.")

    def route_health(self, request, req_id):
        payload = {"status": "healthy", "models_loaded": list(self._models)}
        batch_stats = {name: m.stats for name, m in self._models.items() if hasattr(m, "stats")}
        if batch_stats:
            payload["batching"] = batch_stats
        return _json(payload)

    def route_generate(self, request, req_id):
        text = request.form.get("text")
        if not text:
            raise ValidationError("text is required")
        style = request.form.get("style_prompt", "")
        model = self.get_model(request.form.get("model", "default"))
        ref = None
        if "reference_audio" in request.files:
            ref_audio, ref_sr = _read_audio_upload(request.files["reference_audio"])
            ref = _resampled(np.asarray(ref_audio, np.float32).reshape(-1), ref_sr, 16_000,
                             self.device)
        sr = getattr(model, "sample_rate", 24_000)
        want_stream = request.form.get("stream", "").lower() in ("1", "true", "yes")
        if want_stream and hasattr(model, "synthesize_streaming"):
            chunks = model.synthesize_streaming(text, style_prompt=style, reference_audio_16k=ref)
            return _streaming_wav_response(chunks, sr)
        wave = model.synthesize(text, style_prompt=style, reference_audio_16k=ref)
        return _wav_response(np.asarray(wave, np.float32), sr)


class MuseTalkService(_ServiceApp):
    """Lip-sync through ``video_io`` (by default the port's libav shim, with
    no lip-sync model: the mux fallback); its lip-sync fn holds the device
    work. A lip-sync that fails falls back to the plain mux and still
    answers 200 (musetalk_api.py answers 500)."""

    def __init__(self, video_io=None):
        if video_io is None:
            from ..media.native import NativeVideoIO

            video_io = NativeVideoIO()
        self.video_io = video_io
        self.routes = _routes(("/lipsync-video/", "lipsync", "POST"), ("/health", "health", "GET"))

    def route_health(self, request, req_id):
        return _json({"status": "healthy"})

    def route_lipsync(self, request, req_id):
        from werkzeug.wrappers import Response

        video = request.files.get("video")
        audio_file = request.files.get("audio")
        if video is None or audio_file is None:
            raise ValidationError("video and audio files are required")
        audio, sr = _read_audio_upload(audio_file)
        audio = np.asarray(audio, np.float32).reshape(-1)
        with tempfile.TemporaryDirectory() as tmp:
            vin = Path(tmp) / (video.filename or "in.mp4")
            vin.write_bytes(video.read())
            vout = Path(tmp) / "out.mp4"
            try:
                self.video_io.lipsync(str(vin), audio, sr, str(vout))
            except Exception:  # noqa: BLE001 — the reference answers 500; this muxes
                log.exception("[%s] lipsync failed; muxing", req_id)
                self.video_io.mux(str(vin), audio, sr, str(vout))
            return Response(vout.read_bytes(), mimetype="video/mp4")


class SimilarityService(_ServiceApp):
    """Voice similarity: ``scorer(a, b)``, by default the ECAPA cosine of
    ``evals.acoustic_metrics.speaker_similarity`` on ``device`` (its seeded
    random tree unless a scorer with weights is given)."""

    def __init__(self, scorer: Optional[Callable[[np.ndarray, np.ndarray], float]] = None, *,
                 device=None):
        if scorer is None:
            from ..evals.acoustic_metrics import speaker_similarity

            scorer = functools.partial(speaker_similarity, device=resolve_device(device))
        self.scorer = scorer
        self.routes = _routes(("/compare-voices/", "compare", "POST"),
                              ("/health", "health", "GET"))

    def route_health(self, request, req_id):
        return _json({"status": "healthy"})

    def route_compare(self, request, req_id):
        f1, f2 = request.files.get("audio1"), request.files.get("audio2")
        if f1 is None or f2 is None:
            raise ValidationError("audio1 and audio2 files are required")
        a1, _ = _read_audio_upload(f1)
        a2, _ = _read_audio_upload(f2)
        score = float(self.scorer(np.asarray(a1).reshape(-1), np.asarray(a2).reshape(-1)))
        return _json({"similarity": round(score, 4), "request_id": req_id})


class OpenVoiceService(_ServiceApp):
    """Tone-colour cloning: ``converter(src, src_sr, ref, ref_sr)`` when one
    is given, else the OpenVoice v2 converter on ``device``, from
    ``EST_MODELS_DIR/openvoice`` when it is baked there (``bake_models
    --openvoice``), seeded random weights otherwise; loaded at the first
    request."""

    def __init__(self, converter: Optional[Callable[..., np.ndarray]] = None, *, device=None):
        self._converter = converter
        self.device = resolve_device(device)
        self._params = None
        self.routes = _routes(("/clone-voice", "clone", "POST"), ("/status", "status", "GET"))

    def _ensure_model(self):
        if self._converter is not None or self._params is not None:
            return
        from ..models import openvoice as ov

        root = os.environ.get("EST_MODELS_DIR")
        if root and (Path(root) / "openvoice" / "config.json").exists():
            from ..models.loaders import load_converted

            self._params, self._cfg = load_converted(Path(root) / "openvoice",
                                                     ov.OpenVoiceConfig, self.device)
            log.info("OpenVoiceService: baked converter from %s", Path(root) / "openvoice")
            return
        self._cfg = ov.OpenVoiceConfig()
        log.warning("OpenVoiceService: random weights (no checkpoint supplied)")
        self._params = ov.init_openvoice(5, self._cfg, self.device)

    def route_status(self, request, req_id):
        return _json({
            "status": "ready",
            "model_loaded": self._converter is not None or self._params is not None,
            "native_sample_rate": 22_050,   # openvoice_api.py's native rate
        })

    def route_clone(self, request, req_id):
        src_f = request.files.get("source_audio") or request.files.get("audio")
        ref_f = request.files.get("reference_audio") or request.files.get("target_audio")
        if src_f is None or ref_f is None:
            raise ValidationError("source_audio and reference_audio files are required")
        src, src_sr = _read_audio_upload(src_f)
        ref, ref_sr = _read_audio_upload(ref_f)
        src = np.asarray(src, np.float32).reshape(-1)
        ref = np.asarray(ref, np.float32).reshape(-1)

        if self._converter is not None:
            out = self._converter(src, src_sr, ref, ref_sr)
            return _wav_response(np.asarray(out, np.float32), 22_050)

        self._ensure_model()
        from ..models import openvoice as ov

        with torch.no_grad():
            src22, ref22 = (torch.from_numpy(_resampled(a, sr, 22_050, self.device))
                            .to(self.device)[None] for a, sr in ((src, src_sr), (ref, ref_sr)))
            se_src = ov.extract_se(self._params, self._cfg, ov.spectrogram_22k(src22, self._cfg))
            se_tgt = ov.extract_se(self._params, self._cfg, ov.spectrogram_22k(ref22, self._cfg))
            out = ov.convert_tone(self._params, self._cfg, src22, se_src, se_tgt)
        return _wav_response(out[0].float().cpu().numpy(), 22_050)


SERVICES = {"cosyvoice": 8002, "musetalk": 8003, "similarity": 8001, "openvoice": 8004}


def build_service(name: str, device=None):
    """One model service as its container serves it, on ``device`` (the card
    unless ``device="cpu"``):

    - cosyvoice: the registry's "default" is the port's TTS engine,
      ``torch_engines(scale=config.engines.scale).tts``, which serves the
      bake under ``EST_MODELS_DIR`` as the engines do, behind the
      micro-batcher when ``serve.tts_batching`` is on; warmed up once. (The
      JAX package's entry point gives the registry no factories, so its
      container serves the fake.)
    - musetalk: the libav shim with the resident MuseTalk lip-sync
      (``default_lipsync_fn``: baked weights and the whisper condition from
      ``EST_MODELS_DIR``, random weights otherwise);
    - similarity and openvoice: their defaults on ``device``."""
    if name not in SERVICES:
        raise ValueError(f"unknown service {name!r} ({'|'.join(SERVICES)})")
    if name == "cosyvoice":
        from ..core.config import load_config

        config = load_config()
        sc = config.serve

        def default_tts():
            from ..pipeline.torch_engines import torch_engines

            return torch_engines(scale=config.engines.scale, device=device).tts

        app = CosyVoiceService({"default": default_tts}, batching=sc.tts_batching,
                               max_batch=sc.tts_max_batch, batch_wait_ms=sc.tts_batch_wait_ms,
                               device=device)
        app.warm_up()
        return app
    if name == "musetalk":
        from ..media.native import NativeVideoIO
        from ..pipeline.musetalk_pipeline import default_lipsync_fn

        return MuseTalkService(video_io=NativeVideoIO(lipsync_fn=default_lipsync_fn(device)))
    if name == "similarity":
        return SimilarityService(device=device)
    return OpenVoiceService(device=device)


def run_service(name: str, port: Optional[int] = None, device=None) -> None:
    """Serve one model service (cosyvoice | musetalk | similarity |
    openvoice) on ``port`` (its container's port by default)."""
    from werkzeug.serving import run_simple

    app = build_service(name, device)
    run_simple("0.0.0.0", port or SERVICES[name], app, threaded=True)


if __name__ == "__main__":
    import sys

    run_service(sys.argv[1], int(sys.argv[2]) if len(sys.argv) > 2 else None)
