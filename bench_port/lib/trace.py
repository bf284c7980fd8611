"""The traced slice of a ``--trace 1`` run: ``torch.profiler`` (CUDA
activity: kernels, copies and the runtime's launch calls) over the window's
last :data:`SLICE_S` seconds, a stretch in which every stage dispatches, reduced to plain numbers once the window's requests have
returned: the device's busy union, launches, kernel time by name, the
longest idle gaps named by what the host was doing, and the resblock kernels
paired with the shapes their function was handed."""

from __future__ import annotations

import dataclasses
import re
import sys
import time
from typing import Dict, List, Optional, Tuple

DEVICE_KINDS = ("kernel", "gpu_memcpy", "gpu_memset")
RESBLOCK_KERNEL = "resblock_stage"


@dataclasses.dataclass
class Event:
    name: str
    kind: str           # kineto's activity type: "kernel", "gpu_memcpy", "cuda_runtime", ...
    start_ns: int
    dur_ns: int

    @property
    def end_ns(self) -> int:
        return self.start_ns + self.dur_ns


@dataclasses.dataclass
class Slice:
    t0: float           # perf_counter at the profiler's start
    t1: float
    t0_ns: int          # the same instants on the profiler's clock (time_ns)
    t1_ns: int
    events: List[Event]             # the card's operations and the host's longer runtime calls
    resblock_calls: List[tuple]
    launches: int = 0               # kernel launch calls the host made in the slice

    @property
    def seconds(self) -> float:
        return (self.t1_ns - self.t0_ns) / 1e9


def kind(event) -> str:
    """The activity type of a profiler event, from its device and name: an
    operation on the card ("kernel", "gpu_memcpy", "gpu_memset"), a CUDA
    runtime or driver call ("cuda_runtime"), or a host op ("cpu_op")."""
    name = event.name()
    if event.device_type().name == "CUDA":
        if name.startswith("Memcpy"):
            return "gpu_memcpy"
        if name.startswith("Memset"):
            return "gpu_memset"
        return "kernel"
    if name.startswith("cu"):
        return "cuda_runtime"
    return "cpu_op"


def is_launch(name: str) -> bool:
    return "Launch" in name and name.startswith("cu")


LONG_CALL_NS = 50_000   # runtime calls kept to name idle gaps


def reduce_events(raw, t0_ns: int, t1_ns: int) -> Tuple[List[Event], int, Dict[str, int]]:
    """Profiler events → (the card's operations and the runtime calls of
    50 µs or more, the launch calls inside [t0, t1), events by kind)."""
    kept: List[Event] = []
    n_launch = 0
    kinds: Dict[str, int] = {}
    for e in raw:
        k = kind(e)
        kinds[k] = kinds.get(k, 0) + 1
        if k == "cuda_runtime":
            start, name = e.start_ns(), e.name()
            if is_launch(name) and t0_ns <= start < t1_ns:
                n_launch += 1
            dur = e.duration_ns()
            if dur >= LONG_CALL_NS:
                kept.append(Event(name, k, start, dur))
        elif k in DEVICE_KINDS:
            kept.append(Event(e.name(), k, e.start_ns(), e.duration_ns()))
    return kept, n_launch, kinds


SLICE_S = 30.0     # the traced slice: the window's last seconds (at most half the window)


class Tracer:
    """The profiler over a window of ``seconds``: :meth:`prepare`, before
    the window, sets tracing up (a warm-up step whose events are dropped);
    as ``during(start)`` for :func:`~.drive.run_window` it records from the
    slice's start to the window's close and stops there; :meth:`finish`,
    once the window's requests have returned, reads the events into
    :attr:`slice`."""

    def __init__(self, recorder, seconds: float):
        self.recorder = recorder
        self.seconds = float(seconds)
        self.length = min(SLICE_S, self.seconds / 2)
        self.slice: Optional[Slice] = None
        self._prof = None
        self._done: Dict[str, object] = {}
        self._pending = None

    def prepare(self) -> "Tracer":
        import torch
        from torch.profiler import ProfilerActivity, profile, schedule

        activities = [ProfilerActivity.CUDA] if torch.cuda.is_available() else [ProfilerActivity.CPU]
        self._prof = profile(activities=activities,
                             schedule=schedule(wait=0, warmup=1, active=1, repeat=1),
                             on_trace_ready=lambda p: self._done.update(
                                 results=p.profiler.kineto_results))
        self._prof.start()
        return self

    def __call__(self, start: float) -> None:
        end = start + self.seconds
        time.sleep(max(end - self.length - time.perf_counter(), 0.0))
        self.recorder.resblock_calls.clear()
        self.recorder.tracing = True
        t = time.perf_counter()
        self._prof.step()
        t0, t0_ns = time.perf_counter(), time.time_ns()
        time.sleep(max(end - time.perf_counter(), 0.0))
        self.recorder.tracing = False
        t1, t1_ns = time.perf_counter(), time.time_ns()
        calls = list(self.recorder.resblock_calls)
        self._prof.step()
        self._prof.stop()
        self._prof = None
        self._pending = (t0, t1, t0_ns, t1_ns, calls, self._done.pop("results", None), t0 - t)

    def finish(self) -> Optional[Slice]:
        """The slice, its events read now (after the window)."""
        if self._pending is None:
            return None
        t0, t1, t0_ns, t1_ns, calls, results, began_s = self._pending
        self._pending = None
        t = time.perf_counter()
        raw = results.events() if results is not None else []
        events, n_launch, kinds = reduce_events(raw, t0_ns, t1_ns)
        del raw, results
        self.slice = Slice(t0, t1, t0_ns, t1_ns, events, calls, n_launch)
        resblock = sorted({e.name[:60] for e in events if RESBLOCK_KERNEL in e.name})
        print(f"  trace: the window's last {t1 - t0:.3f} s (recording took {began_s:.3f} s to "
              f"begin), read in {time.perf_counter() - t:.3f} s after it; events {kinds}; "
              f"resblock calls {len(calls)}, kernels {resblock}",
              file=sys.stderr, flush=True)
        return self.slice


def _clip(events: List[Event], lo: int, hi: int) -> List[Tuple[int, int]]:
    return [(max(e.start_ns, lo), min(e.end_ns, hi)) for e in events
            if e.end_ns > lo and e.start_ns < hi]


def union(intervals: List[Tuple[int, int]]) -> List[Tuple[int, int]]:
    """Sorted disjoint intervals covering the given ones."""
    out: List[Tuple[int, int]] = []
    for s, e in sorted(intervals):
        if out and s <= out[-1][1]:
            out[-1] = (out[-1][0], max(out[-1][1], e))
        else:
            out.append((s, e))
    return out


def device_events(sl: Slice) -> List[Event]:
    return [e for e in sl.events if e.kind in DEVICE_KINDS]


def busy_s(sl: Slice) -> float:
    """Seconds of the slice in which some operation ran on the device."""
    return sum(e - s for s, e in union(_clip(device_events(sl), sl.t0_ns, sl.t1_ns))) / 1e9


def launches(sl: Slice) -> int:
    """Kernel launch calls the host made in the slice."""
    return sl.launches


def device_ops(sl: Slice, top: int = 10) -> List[list]:
    """The device operations that took most time: [[name, seconds], ...]."""
    total: Dict[str, int] = {}
    for e in device_events(sl):
        total[e.name] = total.get(e.name, 0) + e.dur_ns
    ranked = sorted(total.items(), key=lambda kv: -kv[1])[:top]
    return [[name[:160], ns / 1e9] for name, ns in ranked]


def idle_gaps(sl: Slice, dispatches, top: int = 10) -> List[list]:
    """The longest stretches with nothing on the device, each named by the
    stages whose batched dispatch the host was inside and the runtime call
    under way then (or "python" for none): [[name, seconds], ...]."""
    busy = union(_clip(device_events(sl), sl.t0_ns, sl.t1_ns))
    gaps, cursor = [], sl.t0_ns
    for s, e in busy + [(sl.t1_ns, sl.t1_ns)]:
        if s > cursor:
            gaps.append((cursor, s))
        cursor = max(cursor, e)
    gaps.sort(key=lambda g: g[0] - g[1])
    runtime = [e for e in sl.events if e.kind == "cuda_runtime"]
    out = []
    for s, e in gaps[:top]:
        mid = (s + e) // 2
        stages = sorted({d.stage for d in dispatches if d.t0_ns <= mid <= (d.t1_ns or mid)})
        call = next((r.name for r in runtime if r.start_ns <= mid <= r.end_ns), "python")
        out.append([f"{'+'.join(stages) or 'no dispatch'}: {call}", (e - s) / 1e9])
    return out


def resblock_pairs(sl: Slice) -> List[Tuple[tuple, int]]:
    """The resblock kernels of the slice in launch order, each paired with
    the (B, C, T, element bytes) its function was handed: the two lists are
    aligned at the shift that matches the most channel counts read from the
    kernel's template arguments (a call at an end of the slice may miss its
    kernel, or a kernel its call)."""
    kernels = sorted((e for e in sl.events if e.kind == "kernel" and RESBLOCK_KERNEL in e.name
                      and sl.t0_ns <= e.start_ns < sl.t1_ns), key=lambda e: e.start_ns)
    calls = sl.resblock_calls
    if not kernels or not calls:
        return []

    def channels(name: str) -> Optional[int]:
        m = re.search(r"<(\d+)", name)
        return int(m.group(1)) if m else None

    def pairs(shift: int):
        return [(calls[i + shift], k.dur_ns) for i, k in enumerate(kernels)
                if 0 <= i + shift < len(calls)]

    def score(shift: int) -> int:
        return sum(1 for (call, _), k in zip(pairs(shift), kernels[max(-shift, 0):])
                   if channels(k.name) in (None, call[1]))

    best = max(range(-2, 3), key=lambda s: (score(s), -abs(s)))
    return pairs(best)
