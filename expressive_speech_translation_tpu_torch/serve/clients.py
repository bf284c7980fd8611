"""HTTP clients for the four model-service contracts (split deployments):
the JAX package's ``serve/clients.py``.

The reference's cascade consumes its model containers over HTTP: CosyVoice TTS
via multipart ``POST /generate-speech/`` with a 3600 s timeout
(Backend/services/cascaded_backend.py:455-475), health checked with 5 retries
spaced 10 s apart (:87-115), warmed up with a silent 1 s reference + "Hello
world." before the backend reports ready (:117-137); MuseTalk lip-sync with a
7200 s timeout (Backend/services/video_routes.py:116-161); the similarity and
OpenVoice services likewise (Docker/similarity_api.py, openvoice_api.py).

This module is the consumer side of ``serve/model_services.py``. Every client
takes a :class:`Transport`, so the same code runs over real HTTP
(:class:`HttpTransport`, requests) or against an in-process WSGI app
(:class:`WsgiTransport`, werkzeug test client) — round-trip tests exercise the
full contract without sockets.

``remote_engines()`` assembles an :class:`~..pipeline.engines.Engines` with the
reference's split: ASR+NMT in-process (the port's engines, on the card unless
``device="cpu"``), TTS remote. ``requests`` and werkzeug are imported by the
transport that uses them, never at module level.
"""

from __future__ import annotations

import io
import logging
import time
import wave
from pathlib import Path
from typing import Any, Dict, Iterable, Optional, Protocol, Tuple

import numpy as np

log = logging.getLogger(__name__)

# Reference timeouts (cascaded_backend.py:475, video_routes.py:144, :97).
TTS_TIMEOUT_S = 3600.0
LIPSYNC_TIMEOUT_S = 7200.0
HEALTH_TIMEOUT_S = 20.0
HEALTH_RETRIES = 5
HEALTH_RETRY_DELAY_S = 10.0


class Reply:
    """Uniform response: status, raw body, JSON view, chunk iterator."""

    def __init__(self, status: int, content: bytes = b"",
                 chunks: Optional[Iterable[bytes]] = None):
        self.status = status
        self._content = content
        self._chunks = chunks

    @property
    def content(self) -> bytes:
        if self._chunks is not None:
            self._content = b"".join(self._chunks)
            self._chunks = None
        return self._content

    def iter_content(self) -> Iterable[bytes]:
        if self._chunks is not None:
            chunks, self._chunks = self._chunks, None
            return chunks
        return iter((self._content,))

    def json(self) -> Any:
        import json

        return json.loads(self.content.decode("utf-8"))


class Transport(Protocol):
    def get(self, path: str, *, timeout: float) -> Reply: ...

    def post(self, path: str, *, data: Dict[str, str],
             files: Dict[str, Tuple[str, bytes, str]], timeout: float,
             stream: bool = False) -> Reply: ...


class HttpTransport:
    """requests-backed transport against a live service base URL."""

    def __init__(self, base_url: str):
        self.base_url = base_url.rstrip("/")

    def get(self, path: str, *, timeout: float) -> Reply:
        import requests

        r = requests.get(self.base_url + path, timeout=timeout)
        return Reply(r.status_code, r.content)

    def post(self, path: str, *, data: Dict[str, str],
             files: Dict[str, Tuple[str, bytes, str]], timeout: float,
             stream: bool = False) -> Reply:
        import requests

        r = requests.post(self.base_url + path, data=data,
                          files={k: v for k, v in files.items()},
                          timeout=timeout, stream=stream)
        if stream:
            return Reply(r.status_code, chunks=r.iter_content(chunk_size=65536))
        return Reply(r.status_code, r.content)


class WsgiTransport:
    """In-process transport around a WSGI app (model_services.*Service)."""

    def __init__(self, app):
        from werkzeug.test import Client

        self._client = Client(app)

    def get(self, path: str, *, timeout: float) -> Reply:
        r = self._client.get(path)
        return Reply(r.status_code, r.get_data())

    def post(self, path: str, *, data: Dict[str, str],
             files: Dict[str, Tuple[str, bytes, str]], timeout: float,
             stream: bool = False) -> Reply:
        body = dict(data)
        for field, (name, payload, mime) in files.items():
            body[field] = (io.BytesIO(payload), name, mime)
        r = self._client.post(path, data=body)
        if stream:
            return Reply(r.status_code, chunks=r.response)
        return Reply(r.status_code, r.get_data())


def _wav_bytes(audio: np.ndarray, sr: int) -> bytes:
    pcm = np.clip(np.asarray(audio, np.float32).reshape(-1), -1.0, 1.0)
    buf = io.BytesIO()
    with wave.open(buf, "wb") as w:
        w.setnchannels(1)
        w.setsampwidth(2)
        w.setframerate(sr)
        w.writeframes((pcm * 32767.0).astype("<i2").tobytes())
    return buf.getvalue()


def _parse_wav_bytes(data: bytes) -> Tuple[np.ndarray, int]:
    """Decode a (possibly streamed, 0xFFFFFFFF-sized) RIFF/PCM16 payload."""
    if data[:4] != b"RIFF" or data[8:12] != b"WAVE":
        raise RemoteServiceError("response is not a WAV payload")
    try:
        with wave.open(io.BytesIO(data), "rb") as w:
            sr = w.getframerate()
            n = w.getnframes()
            raw = w.readframes(n)
        if raw:
            pcm = np.frombuffer(raw, dtype="<i2")
            return pcm.astype(np.float32) / 32767.0, sr
    except wave.Error:
        pass
    # Streamed header declares unbounded sizes; parse fmt manually and take
    # everything after the data tag (model_services._streaming_wav_response).
    import struct

    fmt_at = data.find(b"fmt ")
    data_at = data.find(b"data")
    if fmt_at < 0 or data_at < 0:
        raise RemoteServiceError("malformed WAV stream")
    _, _, sr = struct.unpack_from("<HHI", data, fmt_at + 8)
    pcm = np.frombuffer(data[data_at + 8:], dtype="<i2")
    return pcm.astype(np.float32) / 32767.0, sr


class RemoteServiceError(RuntimeError):
    pass


class _BaseClient:
    health_path = "/health"

    def __init__(self, transport: Transport, *,
                 retries: int = HEALTH_RETRIES,
                 retry_delay_s: float = HEALTH_RETRY_DELAY_S):
        self.transport = transport
        self._retries = retries
        self._retry_delay_s = retry_delay_s

    def check_health(self) -> bool:
        """5×10 s health poll (cascaded_backend.py:87-115): healthy only when
        HTTP 200 and the body's status field agrees."""
        for attempt in range(self._retries):
            try:
                reply = self.transport.get(self.health_path, timeout=HEALTH_TIMEOUT_S)
                if reply.status == 200:
                    payload = reply.json()
                    status = payload.get("status", payload.get("healthy"))
                    if status in ("healthy", "ready", True):
                        return True
                    log.warning("service reported status %r; retrying", status)
                else:
                    log.warning("health check HTTP %s; retrying", reply.status)
            except Exception as e:  # noqa: BLE001 — connection errors retry
                log.warning("health check error: %s; retrying", e)
            if attempt < self._retries - 1:
                time.sleep(self._retry_delay_s)
        return False


class CosyVoiceClient(_BaseClient):
    """TTS over ``POST /generate-speech/`` — satisfies the TtsEngine protocol
    so a CascadedBackend can be wired to a remote TTS transparently."""

    sample_rate = 24_000
    weightless = False  # remote service owns its weights

    def warm_up(self) -> None:
        """Silent 1 s reference + 'Hello world.' so the remote loads its models
        before we report ready (cascaded_backend.py:117-137)."""
        if not self.check_health():
            raise RemoteServiceError("CosyVoice service did not become healthy")
        self.synthesize("Hello world.",
                        reference_audio_16k=np.zeros(16_000, np.float32))

    def synthesize(self, text: str, *, style_prompt: str = "",
                   reference_audio_16k: Optional[np.ndarray] = None,
                   language: str = "en", model: str = "default") -> np.ndarray:
        files: Dict[str, Tuple[str, bytes, str]] = {}
        if reference_audio_16k is not None:
            files["reference_audio"] = (
                "reference.wav", _wav_bytes(reference_audio_16k, 16_000), "audio/wav")
        reply = self.transport.post(
            "/generate-speech/",
            data={"text": text, "style_prompt": style_prompt, "model": model},
            files=files, timeout=TTS_TIMEOUT_S)
        if reply.status != 200:
            raise RemoteServiceError(
                f"CosyVoice API failed: {reply.status} - {reply.content[:200]!r}")
        wave_out, sr = _parse_wav_bytes(reply.content)
        self.sample_rate = sr
        return wave_out

    def synthesize_streaming(self, text: str, *, style_prompt: str = "",
                             reference_audio_16k: Optional[np.ndarray] = None,
                             language: str = "en",
                             chunk_samples: int = 24_000):
        """Incremental chunks from the service's streamed WAV (stream=1)."""
        files: Dict[str, Tuple[str, bytes, str]] = {}
        if reference_audio_16k is not None:
            files["reference_audio"] = (
                "reference.wav", _wav_bytes(reference_audio_16k, 16_000), "audio/wav")
        reply = self.transport.post(
            "/generate-speech/",
            data={"text": text, "style_prompt": style_prompt, "stream": "1"},
            files=files, timeout=TTS_TIMEOUT_S, stream=True)
        if reply.status != 200:
            raise RemoteServiceError(
                f"CosyVoice API failed: {reply.status}")
        pending = b""
        header_done = False
        for chunk in reply.iter_content():
            pending += chunk
            if not header_done:
                data_at = pending.find(b"data")
                if data_at < 0:
                    continue
                import struct

                fmt_at = pending.find(b"fmt ")
                if fmt_at >= 0:
                    _, _, self.sample_rate = struct.unpack_from(
                        "<HHI", pending, fmt_at + 8)
                pending = pending[data_at + 8:]
                header_done = True
            usable = len(pending) - (len(pending) % 2)
            if usable:
                pcm = np.frombuffer(pending[:usable], dtype="<i2")
                pending = pending[usable:]
                yield pcm.astype(np.float32) / 32767.0


class MuseTalkClient(_BaseClient):
    """Lip-sync over ``POST /lipsync-video/`` (video_routes.py:116-161)."""

    def lipsync(self, video_path: str, audio: np.ndarray, sr: int,
                out_path: str) -> None:
        reply = self.transport.post(
            "/lipsync-video/",
            data={},
            files={
                "video": (Path(video_path).name, Path(video_path).read_bytes(),
                          "video/mp4"),
                "audio": ("audio.wav", _wav_bytes(audio, sr), "audio/wav"),
            },
            timeout=LIPSYNC_TIMEOUT_S)
        if reply.status != 200:
            raise RemoteServiceError(
                f"MuseTalk API failed: {reply.status} - {reply.content[:200]!r}")
        Path(out_path).write_bytes(reply.content)


class SimilarityClient(_BaseClient):
    """Voice similarity over ``POST /compare-voices/``."""

    def compare(self, audio1: np.ndarray, audio2: np.ndarray,
                sr: int = 16_000) -> float:
        reply = self.transport.post(
            "/compare-voices/",
            data={},
            files={
                "audio1": ("a1.wav", _wav_bytes(audio1, sr), "audio/wav"),
                "audio2": ("a2.wav", _wav_bytes(audio2, sr), "audio/wav"),
            },
            timeout=HEALTH_TIMEOUT_S * 30)
        if reply.status != 200:
            raise RemoteServiceError(f"Similarity API failed: {reply.status}")
        return float(reply.json()["similarity"])


class OpenVoiceClient(_BaseClient):
    """Tone-color cloning over ``POST /clone-voice`` (+ GET /status)."""

    health_path = "/status"

    def status(self) -> Dict[str, Any]:
        reply = self.transport.get("/status", timeout=HEALTH_TIMEOUT_S)
        if reply.status != 200:
            raise RemoteServiceError(f"OpenVoice status failed: {reply.status}")
        return reply.json()

    def clone(self, source: np.ndarray, source_sr: int,
              reference: np.ndarray, reference_sr: int) -> Tuple[np.ndarray, int]:
        reply = self.transport.post(
            "/clone-voice",
            data={},
            files={
                "source_audio": ("src.wav", _wav_bytes(source, source_sr), "audio/wav"),
                "reference_audio": ("ref.wav", _wav_bytes(reference, reference_sr), "audio/wav"),
            },
            timeout=TTS_TIMEOUT_S)
        if reply.status != 200:
            raise RemoteServiceError(f"OpenVoice API failed: {reply.status}")
        return _parse_wav_bytes(reply.content)


def remote_engines(tts_transport: Transport, *, asr=None, nmt=None,
                   warm_up: bool = True, retries: int = HEALTH_RETRIES,
                   retry_delay_s: float = HEALTH_RETRY_DELAY_S, device=None):
    """Engines with the reference's split: ASR+NMT in-process, TTS over HTTP
    (cascaded_backend.py keeps whisper/NLLB local and calls CosyVoice remotely).

    ``asr``/``nmt`` default to the port's in-process engines
    (``torch_engines(device=device)``: the card unless ``device="cpu"``);
    pass fakes in tests.
    """
    from ..pipeline.engines import Engines

    if asr is None or nmt is None:
        from ..pipeline.torch_engines import torch_engines

        local = torch_engines(device=device)
        asr = asr or local.asr
        nmt = nmt or local.nmt
    tts = CosyVoiceClient(tts_transport, retries=retries,
                          retry_delay_s=retry_delay_s)
    if warm_up:
        tts.warm_up()
    return Engines(asr=asr, nmt=nmt, tts=tts)
