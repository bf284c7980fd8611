"""The safetensors file format, read and written with torch alone.

HF checkpoints (Whisper, Qwen2, sharded ``model.safetensors.index.json``
directories) and the port's baked trees (``params.safetensors``) use it, and
the card's machine has no ``safetensors`` package. A file is a little-endian
u64 header length, a JSON header ``{name: {"dtype", "shape",
"data_offsets": [begin, end]}, "__metadata__": {str: str}}`` whose offsets
count from the end of the header, then the raw little-endian bytes.
"""

from __future__ import annotations

import json
import math
import struct
from pathlib import Path
from typing import Dict, Mapping, Optional, Union

import torch

DTYPES = {"F32": torch.float32, "F16": torch.float16, "BF16": torch.bfloat16,
          "I64": torch.int64, "I32": torch.int32, "U8": torch.uint8, "I8": torch.int8,
          "BOOL": torch.bool}
_NAMES = {v: k for k, v in DTYPES.items()}


def _read_all(path: Path) -> bytearray:
    """The whole file in one writable buffer (a read returns at most ~2 GiB
    at a time, so loop until it is full)."""
    size = path.stat().st_size
    buf = bytearray(size)
    view = memoryview(buf)
    with open(path, "rb", buffering=0) as f:
        got = 0
        while got < size:
            n = f.readinto(view[got:])
            if not n:
                raise ValueError(f"{path}: file ended after {got} of {size} bytes")
            got += n
    return buf


def read_safetensors(path: Union[str, Path]) -> Dict[str, torch.Tensor]:
    """name → CPU tensor. Each tensor is a view of the file's bytes
    (``torch.frombuffer``), copied only where its offset is not aligned to
    its element size. Raises ``ValueError`` on a dtype outside ``DTYPES`` or
    a header that does not fit the file."""
    path = Path(path)
    buf = _read_all(path)
    if len(buf) < 8:
        raise ValueError(f"{path}: too short for a safetensors header")
    (n,) = struct.unpack("<Q", bytes(buf[:8]))
    if 8 + n > len(buf):
        raise ValueError(f"{path}: header of {n} bytes runs past the file's {len(buf)}")
    header = json.loads(bytes(buf[8:8 + n]))
    base = 8 + n
    out: Dict[str, torch.Tensor] = {}
    for name, info in header.items():
        if name == "__metadata__":
            continue
        if info["dtype"] not in DTYPES:
            raise ValueError(f"{path}: tensor {name!r} has dtype {info['dtype']}, which the "
                             f"reader does not take ({', '.join(DTYPES)})")
        dtype = DTYPES[info["dtype"]]
        shape = tuple(int(s) for s in info["shape"])
        begin, end = (int(o) for o in info["data_offsets"])
        count, size = math.prod(shape), dtype.itemsize
        if not (0 <= begin <= end <= len(buf) - base and end - begin == count * size):
            raise ValueError(f"{path}: tensor {name!r} of shape {shape} {info['dtype']} has "
                             f"offsets [{begin}, {end}] in {len(buf) - base} data bytes")
        if count == 0:
            out[name] = torch.empty(shape, dtype=dtype)
            continue
        t = torch.frombuffer(buf, dtype=dtype, count=count, offset=base + begin)
        if (base + begin) % size:
            t = t.clone()
        out[name] = t.reshape(shape)
    return out


def write_safetensors(tensors: Mapping[str, torch.Tensor], path: Union[str, Path],
                      metadata: Optional[Mapping[str, str]] = None) -> None:
    """Write ``tensors`` (any device; copied to the host) as one safetensors
    file, laid out as the library lays it out: the widest dtypes first, then
    by name, the header padded with spaces to a multiple of 8 bytes."""
    host = {}
    for name, t in tensors.items():
        if t.dtype not in _NAMES:
            raise ValueError(f"tensor {name!r} has dtype {t.dtype}, which safetensors files "
                             f"written here do not take ({', '.join(DTYPES)})")
        host[name] = t.detach().to("cpu").contiguous()
    order = sorted(host, key=lambda k: (-host[k].element_size(), k))
    header: Dict[str, object] = {}
    if metadata:
        header["__metadata__"] = {str(k): str(v) for k, v in metadata.items()}
    offset = 0
    for name in order:
        t = host[name]
        nbytes = t.numel() * t.element_size()
        header[name] = {"dtype": _NAMES[t.dtype], "shape": list(t.shape),
                        "data_offsets": [offset, offset + nbytes]}
        offset += nbytes
    text = json.dumps(header, separators=(",", ":")).encode("utf-8")
    text += b" " * (-len(text) % 8)
    with open(path, "wb") as f:
        f.write(struct.pack("<Q", len(text)))
        f.write(text)
        for name in order:
            t = host[name]
            if t.numel():
                f.write(t.reshape(-1).view(torch.uint8).numpy().data)
