"""KV logger with Human / JSON / CSV sinks + profiling context managers (a
copy of the JAX package's ``obs/kvlogger.py``: the standard library only).

Parity with the OpenAI-baselines logger vendored in the reference
(diff2lip/guided_diffusion/logger.py, 491 LoC): ``logkv``/``logkv_mean``/
``dumpkvs`` (:37-176), Human/JSON/CSV output formats, and
``profile``/``profile_kv`` timing context managers (~:250-280). A TensorBoard
sink can be added by registering a writer with the same ``writekvs`` protocol.
"""

from __future__ import annotations

import contextlib
import csv
import json
import time
from pathlib import Path
from typing import Any, Dict, List, Optional, TextIO


class HumanOutput:
    def __init__(self, stream: Optional[TextIO] = None):
        import sys

        self.stream = stream or sys.stdout

    def writekvs(self, kvs: Dict[str, Any]) -> None:
        if not kvs:
            return
        items = sorted((str(k), f"{v:.5g}" if isinstance(v, float) else str(v))
                       for k, v in kvs.items())
        key_w = max(len(k) for k, _ in items)
        val_w = max(len(v) for _, v in items)
        dashes = "-" * (key_w + val_w + 7)
        lines = [dashes]
        for k, v in items:
            lines.append(f"| {k.ljust(key_w)} | {v.ljust(val_w)} |")
        lines.append(dashes)
        self.stream.write("\n".join(lines) + "\n")
        self.stream.flush()


class JSONOutput:
    def __init__(self, path: str | Path):
        self.file = Path(path).open("a")

    def writekvs(self, kvs: Dict[str, Any]) -> None:
        self.file.write(json.dumps({k: float(v) if hasattr(v, "item") else v
                                    for k, v in kvs.items()}) + "\n")
        self.file.flush()


class CSVOutput:
    def __init__(self, path: str | Path):
        self.path = Path(path)
        self.keys: List[str] = []
        # resume: seed columns from an existing file's header, or the first
        # writekvs of a new process rewrites it with FEWER columns than the
        # old rows carry and DictWriter raises on the extras
        if self.path.exists():
            with self.path.open() as f:
                header = f.readline().strip()
            if header:
                self.keys = header.split(",")

    def writekvs(self, kvs: Dict[str, Any]) -> None:
        extra = sorted(k for k in kvs if k not in self.keys)
        if extra:
            self.keys.extend(extra)
            rows = []
            if self.path.exists():
                with self.path.open() as f:
                    rows = list(csv.DictReader(f))
            with self.path.open("w", newline="") as f:
                writer = csv.DictWriter(f, fieldnames=self.keys)
                writer.writeheader()
                writer.writerows(rows)
        with self.path.open("a", newline="") as f:
            csv.DictWriter(f, fieldnames=self.keys).writerow(
                {k: kvs.get(k, "") for k in self.keys})


class KVLogger:
    def __init__(self, sinks: Optional[List[Any]] = None):
        self.sinks = sinks if sinks is not None else [HumanOutput()]
        self._kvs: Dict[str, Any] = {}
        self._counts: Dict[str, int] = {}
        self._profile: Dict[str, float] = {}

    def logkv(self, key: str, value: Any) -> None:
        self._kvs[key] = value

    def logkv_mean(self, key: str, value: float) -> None:
        count = self._counts.get(key, 0)
        old = self._kvs.get(key, 0.0)
        self._kvs[key] = (old * count + value) / (count + 1)
        self._counts[key] = count + 1

    def dumpkvs(self) -> Dict[str, Any]:
        for name, seconds in self._profile.items():
            self.logkv_mean(f"wait_{name}", seconds)
        out = dict(self._kvs)
        for sink in self.sinks:
            sink.writekvs(out)
        self._kvs.clear()
        self._counts.clear()
        self._profile.clear()
        return out

    @contextlib.contextmanager
    def profile_kv(self, name: str):
        t0 = time.perf_counter()
        try:
            yield
        finally:
            self._profile[name] = self._profile.get(name, 0.0) + time.perf_counter() - t0

    def profile(self, name: str):
        """Decorator form of profile_kv (logger.profile parity)."""
        def wrap(fn):
            import functools

            @functools.wraps(fn)
            def inner(*args, **kwargs):
                with self.profile_kv(name):
                    return fn(*args, **kwargs)

            return inner

        return wrap


def make_logger(log_dir: Optional[str | Path] = None, formats=("human", "json", "csv")) -> KVLogger:
    sinks: List[Any] = []
    for fmt in formats:
        if fmt == "human":
            sinks.append(HumanOutput())
        elif fmt == "json" and log_dir:
            sinks.append(JSONOutput(Path(log_dir) / "progress.json"))
        elif fmt == "csv" and log_dir:
            sinks.append(CSVOutput(Path(log_dir) / "progress.csv"))
    return KVLogger(sinks)
