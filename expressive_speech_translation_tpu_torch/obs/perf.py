"""Per-stage wall time and real-time factor (copy of the JAX package's
obs/perf.py ``StageTimer``, without its psutil dependency), and the card's
clock for kernels: CUDA-event times, CUDA-graph replays, the card line."""

from __future__ import annotations

import contextlib
import subprocess
import time
from dataclasses import dataclass, field
from typing import Callable, Dict, Iterator, Sequence

import torch


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


def sync_time(fn: Callable[[], object], iters: int, warmup: int = 2) -> float:
    """Mean milliseconds of ``fn()`` over ``iters`` launches (CUDA events)."""
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / iters


def stack_time(calls: Sequence[Callable[[], object]], reps: int = 20) -> tuple:
    """(device ms, eager ms) of one call over passes of a layer stack. The
    device time replays one pass captured as a CUDA graph, so the host's
    launch cost (a few tens of µs of Python and ctypes a call, more than the
    decode kernels take) stays out of it; the eager time launches from Python."""
    eager = sync_time(lambda: [c() for c in calls], 3, warmup=1) / len(calls)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        for c in calls:
            c()
    device = sync_time(graph.replay, reps) / len(calls)
    del graph
    return device, eager


def graph_turns(fns: Dict[str, Callable[[], object]], calls: int = 50, rounds: int = 4,
                reps: int = 10) -> Dict[str, list]:
    """Device ms of one call of each ``fn``, one time per turn. Each ``fn`` is
    warmed up eagerly, then captured ``calls`` times in a row into a CUDA graph
    of its own, so the host's launch cost stays out of a call of a few µs; the
    graphs are replayed in turns (A B C, C B A, …) ``rounds`` times, ``reps``
    replays a turn, so versions compared share the card's clocks and caches."""
    graphs = {}
    for name, fn in fns.items():
        fn()
        torch.cuda.synchronize()
        graph = torch.cuda.CUDAGraph()
        with torch.cuda.graph(graph):
            for _ in range(calls):
                fn()
        graphs[name] = graph
    times: Dict[str, list] = {name: [] for name in fns}
    order = list(graphs)
    for r in range(rounds):
        for name in (order if r % 2 == 0 else order[::-1]):
            times[name].append(sync_time(graphs[name].replay, reps, warmup=1) / calls)
    del graphs
    return times


def card_line() -> str:
    """The first card's name and power limit, as nvidia-smi gives them."""
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        check=True, capture_output=True, text=True, timeout=60).stdout.strip()
    return out.splitlines()[0]
