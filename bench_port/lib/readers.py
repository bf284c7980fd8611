"""What the per-layer readers of ``metrics/`` share: the run's context and
the reductions more than one reader takes. A reader returns ``None`` when it
finds nothing to read, and the harness then leaves its metric out."""

from __future__ import annotations

import dataclasses
import importlib.util
from typing import Any, Dict, List, Optional

from . import stats, trace, work
from .drive import Window
from .record import Dispatch
from .spec import BENCH


@dataclasses.dataclass
class Context:
    config: Dict[str, Any]
    traffic: Dict[str, Any]
    window: Window
    dispatches: List[Dispatch]
    batch_stats: Dict[str, Dict[str, int]]     # stage → items / batches formed in the window
    flops_per_row: Dict[str, float]            # stage → model FLOPs of one served row
    slice: Optional[trace.Slice] = None


def load(name: str):
    """The reader ``metrics/<name>.py``."""
    path = BENCH / "metrics" / f"{name}.py"
    spec = importlib.util.spec_from_file_location(f"bench_port.metrics.{name.replace('.', '_')}",
                                                  path)
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module.read


def stage_seconds(ctx: Context, stage: str) -> Optional[float]:
    """Mean of each completed request's seconds in ``stage`` (the
    orchestrator's ``StageTimer``, the batcher's wait included)."""
    values = [r.stages[stage] for r in stats.completed(ctx.window) if stage in r.stages]
    return sum(values) / len(values) if values else None


def batch_rows(ctx: Context, stage: str) -> Optional[float]:
    """Requests a batched dispatch of ``stage`` carried in the window."""
    formed = ctx.batch_stats.get(stage, {})
    return formed["items"] / formed["batches"] if formed.get("batches") else None


def _share(d: Dispatch, lo: float, hi: float) -> float:
    """The share of a dispatch's duration inside [lo, hi]."""
    if d.t1 <= d.t0:
        return 0.0
    return max(min(d.t1, hi) - max(d.t0, lo), 0.0) / (d.t1 - d.t0)


def requests_worked(ctx: Context, lo: float, hi: float) -> float:
    """Requests' worth of work done in [lo, hi]: every dispatch's rows at
    the share of its duration inside, over the three stages a request
    passes."""
    return sum(len(d.items) * _share(d, lo, hi) for d in ctx.dispatches) / 3.0


def window_flops(ctx: Context) -> Optional[float]:
    """Model FLOPs of the work done in the window: each dispatch's rows at
    the share of its duration that fell inside the window (in-flight work
    counted by its progress, taken as even over the dispatch)."""
    if not ctx.flops_per_row:
        return None
    total = 0.0
    for d in ctx.dispatches:
        share = _share(d, ctx.window.start, ctx.window.end)
        if share <= 0:
            continue
        if d.stage not in ctx.flops_per_row:
            return None
        total += len(d.items) * ctx.flops_per_row[d.stage] * share
    return total


def kernel_roofline_pct(ctx: Context, pairs, work_fn) -> Optional[float]:
    """Bound time over device time of the kernel events in ``pairs``
    [((shape...), device ns)], in %."""
    if not pairs:
        return None
    bound = sum(work.bound_s(*work_fn(call), call[-1]) for call, _ in pairs)
    device = sum(ns for _, ns in pairs) / 1e9
    return 100.0 * bound / device if device > 0 else None
