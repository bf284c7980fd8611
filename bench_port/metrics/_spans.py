"""What the readers of the port's spans share: the spans the port holds
(its ring, ``obs/spans.py``, read after the window), each span's stage (the
``dispatch.<stage>`` span it ran under, on the batcher's collector thread),
the window on the spans' clock, and interval arithmetic against the card's
busy union in the traced slice. A traced run only: with no slice, or a port
that records no spans, a reader gives ``None`` and its metric is left out."""

from __future__ import annotations

from typing import Dict, List, Optional, Tuple

from bench_port.lib import trace

DISPATCH = "dispatch."


def port_spans(ctx) -> Optional[list]:
    """Every span the port holds, or None with no slice or no spans (the
    slice also ties the window's clock to the spans')."""
    if ctx.slice is None or ctx.slice.t1_ns <= ctx.slice.t0_ns:
        return None
    try:
        from expressive_speech_translation_tpu_torch.obs import spans
    except ImportError:
        return None
    held = spans.RING.snapshot()
    return held or None


def stage_of(span, by_id: Dict[int, object]) -> Optional[str]:
    """The stage whose dispatch ``span`` ran under (itself included)."""
    while span is not None:
        if span.name.startswith(DISPATCH):
            return span.name[len(DISPATCH):]
        span = by_id.get(span.parent)
    return None


def staged(held: list, name: str) -> List[Tuple[object, str]]:
    """(span, stage) of the spans called ``name`` that ran under a dispatch."""
    by_id = {s.id: s for s in held}
    out = []
    for s in held:
        if s.name == name:
            stage = stage_of(s, by_id)
            if stage is not None:
                out.append((s, stage))
    return out


def window_ns(ctx) -> Tuple[int, int]:
    """The measured window on the spans' clock, through the slice's pair of
    readings of both clocks."""
    sl = ctx.slice
    return (sl.t0_ns - round((sl.t0 - ctx.window.start) * 1e9),
            sl.t0_ns - round((sl.t0 - ctx.window.end) * 1e9))


def queue_wait_s(ctx, stage: str) -> Optional[float]:
    """The mean, over the items of ``stage``'s dispatches that start inside
    the measured window, of the dispatch's start less the item's submit
    time. The whole window, not only its traced slice: a round of the
    closed loop outlasts the slice, so a slice may see no dispatch start."""
    held = port_spans(ctx)
    if held is None:
        return None
    lo, hi = window_ns(ctx)
    waits = [s.start_ns - t for s in held
             if s.name == DISPATCH + stage and lo <= s.start_ns <= hi
             for t in s.attrs.get("submitted_ns", ())]
    return sum(waits) / len(waits) / 1e9 if waits else None


def decode_step_ms(ctx, stage: str) -> Optional[float]:
    """Wall ms a step of ``stage``'s decode loops: each loop that overlaps
    the measured window counts its time inside the window and its steps at
    the same share (steps taken as even over the loop), so a 256-step loop
    that straddles an end of the window still counts."""
    held = port_spans(ctx)
    if held is None:
        return None
    lo, hi = window_ns(ctx)
    inside = steps = 0.0
    for s, st in staged(held, "decode"):
        overlap = min(s.end_ns, hi) - max(s.start_ns, lo)
        if st == stage and overlap > 0 and s.attrs.get("steps"):
            inside += overlap
            steps += s.attrs["steps"] * overlap / (s.end_ns - s.start_ns)
    return inside / 1e6 / steps if steps else None


def _clipped(intervals, lo: int, hi: int) -> List[Tuple[int, int]]:
    return trace.union([(max(s, lo), min(e, hi)) for s, e in intervals if e > lo and s < hi])


def _length(intervals: List[Tuple[int, int]]) -> int:
    return sum(e - s for s, e in intervals)


def busy(ctx) -> List[Tuple[int, int]]:
    """The card's busy union inside the slice."""
    sl = ctx.slice
    return _clipped([(e.start_ns, e.end_ns) for e in trace.device_events(sl)], sl.t0_ns, sl.t1_ns)


def idle_while_pct(ctx, open_: List[Tuple[int, int]]) -> float:
    """The share of the slice, in %, with nothing on the card while some
    interval of ``open_`` is open."""
    sl = ctx.slice
    on = busy(ctx)
    either = _length(_clipped(list(open_) + on, sl.t0_ns, sl.t1_ns))
    return 100.0 * (either - _length(on)) / (sl.t1_ns - sl.t0_ns)   # |open \ busy|


def idle_outside_pct(ctx, open_: List[Tuple[int, int]]) -> float:
    """The share of the slice, in %, with nothing on the card and no
    interval of ``open_`` open."""
    sl = ctx.slice
    covered = _length(_clipped(list(open_) + busy(ctx), sl.t0_ns, sl.t1_ns))
    return 100.0 * (1.0 - covered / (sl.t1_ns - sl.t0_ns))
