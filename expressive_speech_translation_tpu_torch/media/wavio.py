"""WAV read and write in numpy (PCM 8/16/24/32-bit and float32), no other
dependency: the port of the JAX package's ``media/wavio.py``. Audio is
float32 in [-1, 1], shape [T] mono or [C, T] multichannel."""

from __future__ import annotations

import struct
from pathlib import Path
from typing import Tuple, Union

import numpy as np

from ..core.errors import MediaError


def read_wav(path: Union[str, Path]) -> Tuple[np.ndarray, int]:
    """→ (audio float32 [T] or [C, T], sample_rate)."""
    return read_wav_bytes(Path(path).read_bytes(), label=str(path))


def read_wav_bytes(data: bytes, *, label: str = "<bytes>") -> Tuple[np.ndarray, int]:
    """Decode a WAV held in memory (an upload need not pass through a file)."""
    if len(data) < 44 or data[:4] != b"RIFF" or data[8:12] != b"WAVE":
        raise MediaError(f"{label} is not a RIFF/WAVE file")
    pos, fmt, raw, fmt_body = 12, None, None, None
    while pos + 8 <= len(data):
        cid = data[pos:pos + 4]
        size = struct.unpack("<I", data[pos + 4:pos + 8])[0]
        body = data[pos + 8:pos + 8 + size]
        if cid == b"fmt ":
            fmt = struct.unpack("<HHIIHH", body[:16])
            fmt_body = body
        elif cid == b"data":
            raw = body
        pos += 8 + size + (size % 2)
    if fmt is None or raw is None:
        raise MediaError(f"{label}: missing fmt/data chunk")
    audio_format, channels, sr, _, _, bits = fmt
    if audio_format == 0xFFFE:  # WAVE_FORMAT_EXTENSIBLE
        # the sample format is the SubFormat GUID's first two bytes, past
        # cbSize at fmt offset 24; a short fmt chunk leaves only the depth
        if fmt_body is not None and len(fmt_body) >= 26:
            audio_format = struct.unpack("<H", fmt_body[24:26])[0]
        else:
            audio_format = 1 if bits != 32 else 3

    if audio_format == 1 and bits == 16:
        x = np.frombuffer(raw, "<i2").astype(np.float32) / 32768.0
    elif audio_format == 1 and bits == 24:
        b = np.frombuffer(raw, np.uint8).reshape(-1, 3)
        i32 = (b[:, 0].astype(np.int32) | (b[:, 1].astype(np.int32) << 8)
               | (b[:, 2].astype(np.int32) << 16))
        i32 = np.where(i32 & 0x800000, i32 - (1 << 24), i32)
        x = i32.astype(np.float32) / 8388608.0
    elif audio_format == 1 and bits == 32:
        x = np.frombuffer(raw, "<i4").astype(np.float32) / 2147483648.0
    elif audio_format == 3 and bits == 32:
        x = np.frombuffer(raw, "<f4").astype(np.float32)
    elif audio_format == 1 and bits == 8:
        x = (np.frombuffer(raw, np.uint8).astype(np.float32) - 128.0) / 128.0
    else:
        raise MediaError(f"{label}: unsupported WAV format {audio_format}/{bits}-bit")

    if channels > 1:
        x = x[: (len(x) // channels) * channels].reshape(-1, channels).T
    return np.ascontiguousarray(x), sr


def write_wav(path: Union[str, Path], audio: np.ndarray, sr: int, *, bits: int = 16) -> None:
    """audio: float32 [T] or [C, T] in [-1, 1], written as PCM 16-bit by
    default (``bits=32``: float32)."""
    Path(path).write_bytes(wav_bytes(audio, sr, bits=bits))


def wav_bytes(audio: np.ndarray, sr: int, *, bits: int = 16) -> bytes:
    """Encode a WAV in memory (a response carries it base64, with no file)."""
    x = np.asarray(audio, np.float32)
    if x.ndim == 2:
        channels = x.shape[0]
        x = x.T.reshape(-1)  # interleave the channels
    else:
        channels = 1
    x = np.clip(x, -1.0, 1.0)

    if bits == 16:
        raw = (x * 32767.0).astype("<i2").tobytes()
        fmt_code, block = 1, 2 * channels
    elif bits == 32:
        raw = x.astype("<f4").tobytes()
        fmt_code, block = 3, 4 * channels
    else:
        raise MediaError(f"unsupported write depth {bits}")

    header = (b"RIFF" + struct.pack("<I", 36 + len(raw)) + b"WAVE"
              + b"fmt " + struct.pack("<IHHIIHH", 16, fmt_code, channels, sr, sr * block, block,
                                      bits)
              + b"data" + struct.pack("<I", len(raw)))
    return header + raw
