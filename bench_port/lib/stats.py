"""End-to-end arithmetic over all requests of the window."""

from __future__ import annotations

import math
from typing import List, Sequence

from .drive import Window


def percentile(values: Sequence[float], q: float) -> float:
    """The nearest-rank ``q``-th percentile: the smallest value with at
    least q % of the values at or below it."""
    if not values:
        raise ValueError("no values")
    ordered = sorted(values)
    rank = max(int(math.ceil(q / 100.0 * len(ordered))), 1)
    return ordered[rank - 1]


def completed(window: Window) -> List:
    """Requests that returned inside the window."""
    return [r for r in window.requests if r.done is not None and r.done <= window.end]


def requests_per_s(window: Window) -> float:
    """Every request sent in the window that returned, over the seconds from
    the window's start until the last of them had returned (the clock read
    after the drain). A window of a few decode rounds counted only to its
    close moves by a whole round's requests, whichever side of the close the
    round ends on."""
    done = sum(1 for r in window.requests if r.done is not None)
    return done / (window.drained - window.start)


def window_requests_per_s(window: Window) -> float:
    """Requests completed in the window over the window's seconds (printed
    beside the rate, not reported)."""
    return len(completed(window)) / (window.end - window.start)


def latencies(window: Window) -> List[float]:
    """Each request's time from when it was due to its result, or to the
    window's close for one still in flight then (or failed)."""
    return [min(r.done if r.done is not None else math.inf, window.end) - r.due
            for r in window.requests]


def latency_p90_s(window: Window) -> float:
    return percentile(latencies(window), 90.0)
