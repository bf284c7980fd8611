"""Per-stage wall time and real-time factor (copy of the JAX package's
obs/perf.py ``StageTimer``, without its psutil dependency)."""

from __future__ import annotations

import contextlib
import time
from dataclasses import dataclass, field
from typing import Dict, Iterator


def rtf(processing_seconds: float, audio_seconds: float) -> float:
    """Real-time factor; <1 means faster than real time."""
    if audio_seconds <= 0:
        return float("inf")
    return processing_seconds / audio_seconds


@dataclass
class StageTimer:
    """Accumulates per-stage wall time for one request; xRT per stage.

    Stages time device work only if the work is finished inside the ``with``:
    the engines return host (numpy) results, which waits for the card."""

    audio_seconds: float = 0.0
    stages: Dict[str, float] = field(default_factory=dict)
    _t0: float = field(default_factory=time.perf_counter)

    @contextlib.contextmanager
    def stage(self, name: str) -> Iterator[None]:
        start = time.perf_counter()
        try:
            yield
        finally:
            self.stages[name] = self.stages.get(name, 0.0) + time.perf_counter() - start

    def total_seconds(self) -> float:
        return time.perf_counter() - self._t0

    def summary(self) -> Dict[str, Dict[str, float]]:
        out: Dict[str, Dict[str, float]] = {}
        for name, seconds in self.stages.items():
            out[name] = {"seconds": seconds, "xrt": rtf(seconds, self.audio_seconds)}
        total = self.total_seconds()
        out["total"] = {"seconds": total, "xrt": rtf(total, self.audio_seconds)}
        return out
