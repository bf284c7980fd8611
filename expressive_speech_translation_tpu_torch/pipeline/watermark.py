"""Provenance watermarking (the JAX package's ``pipeline/watermark.py``).

A JSON payload ``{app, v, req_id, ts_utc, pipeline}`` rides the delivered
file as container metadata: a LIST-INFO ICMT chunk in a RIFF/WAVE file, a
top-level ``free`` box (prefixed with a magic) in an ISO-BMFF (MP4) file.
``verify`` reads it back and checks that it is ours. The app name is the JAX
package's, so either package verifies the other's files.
"""

from __future__ import annotations

import json
import logging
import struct
import time
from pathlib import Path
from typing import Any, Dict, Optional

log = logging.getLogger(__name__)

APP_NAME = "expressive-speech-translation-tpu"
VERSION = 1


def make_payload(request_id: str, pipeline: str = "cascaded") -> Dict[str, Any]:
    return {
        "app": APP_NAME,
        "v": VERSION,
        "req_id": request_id,
        "ts_utc": time.strftime("%Y-%m-%dT%H:%M:%SZ", time.gmtime()),
        "pipeline": pipeline,
    }


class WaterMark:
    """add / extract / verify over WAV (RIFF ICMT) and MP4 (top-level free box)."""

    @staticmethod
    def add_watermark(path: str | Path, payload: Dict[str, Any]) -> None:
        """Append a LIST-INFO chunk carrying the JSON payload as ICMT."""
        path = Path(path)
        data = path.read_bytes()
        if data[:4] != b"RIFF" or data[8:12] != b"WAVE":
            raise ValueError(f"{path} is not a RIFF/WAVE file")
        comment = json.dumps(payload, separators=(",", ":")).encode()
        if len(comment) % 2:
            comment += b"\x00"
        icmt = b"ICMT" + struct.pack("<I", len(comment)) + comment
        chunk = b"LIST" + struct.pack("<I", 4 + len(icmt)) + b"INFO" + icmt
        out = data + chunk
        out = out[:4] + struct.pack("<I", len(out) - 8) + out[8:]   # the RIFF size field
        path.write_bytes(out)
        log.info("watermarked %s (req_id=%s)", path, payload.get("req_id"))

    @staticmethod
    def extract_watermark(path: str | Path) -> Optional[Dict[str, Any]]:
        """Scan the RIFF chunks for LIST-INFO/ICMT; the decoded payload or None."""
        data = Path(path).read_bytes()
        if data[:4] != b"RIFF":
            return None
        pos = 12
        while pos + 8 <= len(data):
            cid = data[pos:pos + 4]
            size = struct.unpack("<I", data[pos + 4:pos + 8])[0]
            body = data[pos + 8:pos + 8 + size]
            if cid == b"LIST" and body[:4] == b"INFO":
                ipos = 4
                while ipos + 8 <= len(body):
                    sub = body[ipos:ipos + 4]
                    ssize = struct.unpack("<I", body[ipos + 4:ipos + 8])[0]
                    if sub == b"ICMT":
                        raw = body[ipos + 8:ipos + 8 + ssize].rstrip(b"\x00")
                        try:
                            return json.loads(raw.decode())
                        except (ValueError, UnicodeDecodeError):
                            return None
                    ipos += 8 + ssize + (ssize % 2)
            pos += 8 + size + (size % 2)
        return None

    # An ICMT chunk on an intermediate WAV does not survive muxing into MP4,
    # so the video route marks the delivered MP4: ISO-BMFF allows top-level
    # `free` boxes, which every parser skips.

    _MP4_MAGIC = b"ESTWM1"

    @staticmethod
    def add_watermark_mp4(path: str | Path, payload: Dict[str, Any]) -> None:
        """Append a top-level `free` box carrying the JSON payload."""
        path = Path(path)
        data = path.read_bytes()
        if len(data) < 8 or data[4:8] not in (b"ftyp", b"moov", b"mdat", b"free", b"wide", b"skip"):
            raise ValueError(f"{path} is not an ISO-BMFF (MP4) file")
        body = WaterMark._MP4_MAGIC + json.dumps(
            payload, separators=(",", ":")).encode()
        box = struct.pack(">I", 8 + len(body)) + b"free" + body
        with path.open("ab") as f:
            f.write(box)
        log.info("watermarked %s (req_id=%s)", path, payload.get("req_id"))

    @staticmethod
    def extract_watermark_mp4(path: str | Path) -> Optional[Dict[str, Any]]:
        """Walk the top-level boxes for a `free` box with our magic, then scan
        from the tail (the payload is appended, so it is found even when an
        earlier malformed or size-0 box ends the walk)."""
        data = Path(path).read_bytes()
        found = WaterMark._walk_mp4_boxes(data)
        if found is not None:
            return found
        idx = data.rfind(WaterMark._MP4_MAGIC)
        if idx >= 8 and data[idx - 4:idx] == b"free":
            size = struct.unpack(">I", data[idx - 8:idx - 4])[0]
            body = data[idx + len(WaterMark._MP4_MAGIC): idx - 8 + size]
            try:
                return json.loads(body.decode())
            except (ValueError, UnicodeDecodeError):
                return None
        return None

    @staticmethod
    def _walk_mp4_boxes(data: bytes) -> Optional[Dict[str, Any]]:
        pos = 0
        while pos + 8 <= len(data):
            size = struct.unpack(">I", data[pos:pos + 4])[0]
            btype = data[pos + 4:pos + 8]
            header = 8
            if size == 1:  # 64-bit largesize
                if pos + 16 > len(data):
                    return None
                size = struct.unpack(">Q", data[pos + 8:pos + 16])[0]
                header = 16
            elif size == 0:  # the box extends to the end of the file
                size = len(data) - pos
            if size < header:
                return None
            if btype == b"free":
                body = data[pos + header:pos + size]
                if body.startswith(WaterMark._MP4_MAGIC):
                    try:
                        return json.loads(body[len(WaterMark._MP4_MAGIC):].decode())
                    except (ValueError, UnicodeDecodeError):
                        return None
            pos += size
        return None

    @staticmethod
    def verify(path: str | Path) -> bool:
        """The payload is present and ours; dispatches on the container."""
        data = Path(path).read_bytes()[:12]
        if data[:4] == b"RIFF":
            payload = WaterMark.extract_watermark(path)
        else:
            payload = WaterMark.extract_watermark_mp4(path)
        return bool(payload) and payload.get("app") == APP_NAME
