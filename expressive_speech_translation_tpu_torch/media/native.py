"""ctypes bindings for the C++ libav media shim (``media/csrc/est_media.cpp``).

The port's copy of the JAX package's ``media/native.py``: in-process decode,
encode and mux in place of ffmpeg subprocess calls. The shim is host code.
It is built from the port's own source with g++ and libav's headers into
``_build/libest_media-<hash of the source>.so`` the first time it is needed
(or by :func:`build`), so a changed source never loads a stale library, and
it is loaded lazily. A failed build logs the compiler's full output; callers
then get a clear :class:`MediaError` (WAV I/O never needs the shim:
``media/wavio.py`` is numpy alone).
"""

from __future__ import annotations

import ctypes
import hashlib
import logging
import os
import shutil
import subprocess
import tempfile
import threading
from pathlib import Path
from typing import Dict, Optional, Tuple

import numpy as np

from ..core.errors import MediaError
from ..ops.build import BUILD_DIR

log = logging.getLogger(__name__)

SOURCE = Path(__file__).resolve().parent / "csrc" / "est_media.cpp"
INCLUDE_DIR = "/usr/include/x86_64-linux-gnu"
LIBAV = ("avformat", "avcodec", "avutil", "swresample", "swscale")
# the JAX package's build_native.sh flags
GXX_FLAGS = ("-O2", "-fPIC", "-shared", "-std=c++17", f"-I{INCLUDE_DIR}")

_lock = threading.Lock()
_LIB: Optional[ctypes.CDLL] = None
_BUILD_ERROR: Optional[str] = None


def library_path() -> Path:
    digest = hashlib.sha256(SOURCE.read_bytes()).hexdigest()[:16]
    return BUILD_DIR / f"libest_media-{digest}.so"


def toolchain() -> Dict[str, object]:
    """What the build needs, looked up without building: the g++ found (or
    None) and, for each libav header directory, whether it exists."""
    return {"g++": shutil.which("g++"),
            "headers": {f"{INCLUDE_DIR}/lib{name}": os.path.isdir(f"{INCLUDE_DIR}/lib{name}")
                        for name in LIBAV}}


def build() -> Path:
    """Compile the shim unless its library exists; → the library's path.
    The output goes to a temporary name and is renamed into place, so
    concurrent builds never load a half-written file. Raises with the
    compiler's full output when the build fails."""
    path = library_path()
    if path.exists():
        return path
    gxx = shutil.which("g++")
    if gxx is None:
        raise RuntimeError("g++ not found: the media shim is built from "
                           f"{SOURCE} at first use and needs g++ and libav's headers")
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    fd, tmp = tempfile.mkstemp(suffix=".so", dir=BUILD_DIR)
    os.close(fd)
    cmd = [gxx, *GXX_FLAGS, str(SOURCE), "-o", tmp, *(f"-l{name}" for name in LIBAV)]
    proc = subprocess.run(cmd, capture_output=True, text=True, timeout=300)
    if proc.returncode != 0:
        os.unlink(tmp)
        raise RuntimeError(f"g++ failed ({' '.join(cmd)}):\n{proc.stdout}{proc.stderr}")
    os.replace(tmp, path)
    log.info("built native media shim at %s", path)
    return path


def available() -> bool:
    try:
        return _load() is not None
    except MediaError:
        return False


def _load() -> ctypes.CDLL:
    global _LIB, _BUILD_ERROR
    with _lock:
        if _LIB is not None:
            return _LIB
        if _BUILD_ERROR is None and not library_path().exists():
            try:
                build()
            except (RuntimeError, OSError, subprocess.SubprocessError) as e:
                _BUILD_ERROR = str(e)
                log.error("native media shim build failed:\n%s", _BUILD_ERROR)
        if not library_path().exists():
            # JAX's message, word for word: the 400's error_id is its hash
            raise MediaError(
                "native media shim not built (run media/csrc/build_native.sh); "
                "only WAV input is supported without it",
                user_message="Only WAV input is supported in this deployment",
            )
        lib = ctypes.CDLL(str(library_path()))
        lib.est_last_error.restype = ctypes.c_char_p
        lib.est_decode_audio.argtypes = [
            ctypes.c_char_p, ctypes.c_int, ctypes.c_int,
            ctypes.POINTER(ctypes.POINTER(ctypes.c_float)),
            ctypes.POINTER(ctypes.c_long), ctypes.POINTER(ctypes.c_int),
            ctypes.POINTER(ctypes.c_int),
        ]
        lib.est_decode_video.argtypes = [
            ctypes.c_char_p, ctypes.c_long, ctypes.c_int,
            ctypes.POINTER(ctypes.POINTER(ctypes.c_uint8)),
            ctypes.POINTER(ctypes.c_long), ctypes.POINTER(ctypes.c_int),
            ctypes.POINTER(ctypes.c_int), ctypes.POINTER(ctypes.c_double),
        ]
        lib.est_encode_audio.argtypes = [
            ctypes.c_char_p, ctypes.POINTER(ctypes.c_float), ctypes.c_long, ctypes.c_int,
        ]
        lib.est_mux_audio_video.argtypes = [
            ctypes.c_char_p, ctypes.POINTER(ctypes.c_float), ctypes.c_long,
            ctypes.c_int, ctypes.c_char_p,
        ]
        lib.est_encode_video.argtypes = [
            ctypes.c_char_p, ctypes.POINTER(ctypes.c_uint8), ctypes.c_long,
            ctypes.c_int, ctypes.c_int, ctypes.c_double,
            ctypes.POINTER(ctypes.c_float), ctypes.c_long, ctypes.c_int,
        ]
        lib.est_free.argtypes = [ctypes.c_void_p]
        _LIB = lib
        return lib


def _err(lib) -> str:
    return lib.est_last_error().decode(errors="replace")


def decode_audio(
    path: str | Path, *, target_rate: int = 0, target_channels: int = 0
) -> Tuple[np.ndarray, int]:
    """Any container/codec → (float32 [T] mono or [C, T], sample_rate)."""
    lib = _load()
    out = ctypes.POINTER(ctypes.c_float)()
    n = ctypes.c_long()
    ch = ctypes.c_int()
    sr = ctypes.c_int()
    rc = lib.est_decode_audio(
        str(path).encode(), target_rate, target_channels,
        ctypes.byref(out), ctypes.byref(n), ctypes.byref(ch), ctypes.byref(sr),
    )
    if rc != 0:
        raise MediaError(f"decode_audio({path}): {_err(lib)}")
    total = n.value * ch.value
    audio = np.ctypeslib.as_array(out, shape=(total,)).copy()
    lib.est_free(out)
    if ch.value > 1:
        audio = audio.reshape(n.value, ch.value).T
    return np.ascontiguousarray(audio), sr.value


def decode_audio_bytes(raw: bytes, suffix: str) -> Tuple[np.ndarray, int]:
    """Decode compressed audio bytes (mp3/ogg/flac/...) via a temp file."""
    with tempfile.NamedTemporaryFile(suffix=suffix) as f:
        Path(f.name).write_bytes(raw)
        return decode_audio(f.name)


def decode_video(
    path: str | Path, *, max_frames: int = 0, frame_step: int = 1
) -> Tuple[np.ndarray, float]:
    """video → (uint8 RGB frames [N, H, W, 3], fps)."""
    lib = _load()
    out = ctypes.POINTER(ctypes.c_uint8)()
    n = ctypes.c_long()
    w = ctypes.c_int()
    h = ctypes.c_int()
    fps = ctypes.c_double()
    rc = lib.est_decode_video(
        str(path).encode(), max_frames, frame_step,
        ctypes.byref(out), ctypes.byref(n), ctypes.byref(w), ctypes.byref(h),
        ctypes.byref(fps),
    )
    if rc != 0:
        raise MediaError(f"decode_video({path}): {_err(lib)}")
    total = n.value * h.value * w.value * 3
    frames = np.ctypeslib.as_array(out, shape=(total,)).copy()
    lib.est_free(out)
    return frames.reshape(n.value, h.value, w.value, 3), fps.value


def encode_audio(path: str | Path, audio: np.ndarray, sr: int) -> None:
    """mono float32 → container by extension (.wav/.mp4/.m4a/...)."""
    lib = _load()
    x = np.ascontiguousarray(np.asarray(audio, np.float32).reshape(-1))
    rc = lib.est_encode_audio(
        str(path).encode(), x.ctypes.data_as(ctypes.POINTER(ctypes.c_float)),
        len(x), sr,
    )
    if rc != 0:
        raise MediaError(f"encode_audio({path}): {_err(lib)}")


def mux_audio_video(video_path: str | Path, audio: np.ndarray, sr: int,
                    out_path: str | Path) -> None:
    """Replace the video's audio track (video stream-copied)."""
    lib = _load()
    x = np.ascontiguousarray(np.asarray(audio, np.float32).reshape(-1))
    rc = lib.est_mux_audio_video(
        str(video_path).encode(), x.ctypes.data_as(ctypes.POINTER(ctypes.c_float)),
        len(x), sr, str(out_path).encode(),
    )
    if rc != 0:
        raise MediaError(f"mux({video_path}): {_err(lib)}")


def encode_video(
    path: str | Path, frames: np.ndarray, fps: float,
    audio: Optional[np.ndarray] = None, audio_rate: int = 16_000,
) -> None:
    """uint8 RGB frames [N, H, W, 3] (+ optional mono audio) → container."""
    lib = _load()
    f = np.ascontiguousarray(np.asarray(frames, np.uint8))
    n, h, w, c = f.shape
    if c != 3:
        raise MediaError("frames must be RGB24 [N, H, W, 3]")
    if audio is not None:
        a = np.ascontiguousarray(np.asarray(audio, np.float32).reshape(-1))
        a_ptr, a_n = a.ctypes.data_as(ctypes.POINTER(ctypes.c_float)), len(a)
    else:
        a, a_ptr, a_n = None, ctypes.POINTER(ctypes.c_float)(), 0
    rc = lib.est_encode_video(
        str(path).encode(), f.ctypes.data_as(ctypes.POINTER(ctypes.c_uint8)),
        n, w, h, fps, a_ptr, a_n, audio_rate,
    )
    if rc != 0:
        raise MediaError(f"encode_video({path}): {_err(lib)}")


class NativeVideoIO:
    """``serve/video.VideoIO`` backed by the shim. The lip-sync model is
    supplied by the caller (``lipsync_fn(frames, fps, audio, sr) → frames``);
    without one, ``lipsync`` raises and the route falls back to the mux."""

    def __init__(self, lipsync_fn=None):
        self._lipsync_fn = lipsync_fn

    def extract_audio(self, video_path: str) -> Tuple[np.ndarray, int]:
        return decode_audio(video_path, target_channels=1)

    def frames(self, video_path: str, *, frame_step: int = 3,
               max_frames: int = 1200) -> Tuple[np.ndarray, float]:
        """Subsampled RGB frames for visual speech mapping → (frames,
        EFFECTIVE fps = source_fps / frame_step).

        Returns an EMPTY array when the cap truncates the clip: the visual
        mapper derives the clip duration from len(frames)/fps, so a
        truncated set would squeeze the dubbed audio into the first part of
        the video — strictly worse than the natural-flow fallback.
        """
        fr, fps = decode_video(video_path, max_frames=max_frames,
                               frame_step=frame_step)
        if len(fr) >= max_frames:
            log.info("frames(%s): clip longer than the %d-frame mapping cap; "
                     "visual mapping skipped", video_path, max_frames)
            return fr[:0], fps / frame_step
        return fr, fps / frame_step

    def mux(self, video_path: str, audio: np.ndarray, sr: int, out_path: str) -> None:
        mux_audio_video(video_path, audio, sr, out_path)

    def lipsync(self, video_path: str, audio: np.ndarray, sr: int, out_path: str) -> None:
        if self._lipsync_fn is None:
            raise MediaError("no lip-sync model configured")
        frames, fps = decode_video(video_path)
        rendered = self._lipsync_fn(frames, fps, audio, sr)
        encode_video(out_path, rendered, fps, audio=audio, audio_rate=sr)
