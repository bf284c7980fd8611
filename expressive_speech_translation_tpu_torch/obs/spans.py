"""Spans: named stretches of the host's work, a request's tied together by
its id.

A span has a name, a start and an end on ``time.time_ns()`` (the clock the
torch profiler's events carry), the thread that ran it, its id and its
parent's (the innermost span open on the same thread), and a small dict of
attributes (request ids, rows, padded rows, steps). On exit it is appended to
:data:`RING`, a ring of :data:`CAPACITY` spans whose oldest fall off and are
counted (:attr:`Ring.dropped`). Recording is always on: two clock reads and
an append a span.

While a torch profiler records, a span also opens
``torch.profiler.record_function(name)``, so it shows in the profiler's trace
(``obs.perf.profiler_trace``, or any kineto trace) on the device trace's
clock. With no profiler ``record_function`` is never entered: it costs
microseconds a use even then, against tens of nanoseconds for the flag read.

A span around device work times the host's launching of that work; no span
waits for the device. The granularity is request, stage, dispatch, phase and
decode loop, never a decode step or a layer: a loop's steps are an attribute
of its span.

The request id travels in a context variable: the orchestrator sets it
(:func:`request`), a micro-batcher reads it on the submitting thread
(:func:`request_id`) and writes the ids it carried onto its dispatch span.

Names in use: ``request``; ``stage.asr`` / ``.nmt`` / ``.tts`` / ``.post``;
``dispatch.asr`` / ``.nmt`` / ``.tts``; the phases ``asr.detect``,
``asr.mel``, ``asr.encode``, ``asr.to_host``, ``asr.gate``, ``nmt.encode``,
``nmt.to_host``, ``tts.cond``, ``tts.prefill``, ``tts.flow``,
``tts.vocoder``, ``tts.to_host``; and ``decode`` (``steps``: the loop's
iterations, ``rows``).
"""

from __future__ import annotations

import collections
import contextlib
import contextvars
import itertools
import threading
import time
from typing import Any, Dict, Iterator, List, Optional

import torch
from torch.autograd import profiler as _autograd_profiler

CAPACITY = 1 << 15


class Span:
    """One span; a context manager that records itself on exit."""

    __slots__ = ("name", "start_ns", "end_ns", "thread", "id", "parent", "attrs", "_rf")

    def __init__(self, name: str, attrs: Dict[str, Any]):
        self.name = name
        self.attrs = attrs
        self.start_ns = self.end_ns = 0
        self.thread = threading.get_ident()
        self.id = next(_ids)
        self.parent: Optional[int] = None
        self._rf = None

    @property
    def seconds(self) -> float:
        return (self.end_ns - self.start_ns) / 1e9

    def __enter__(self) -> "Span":
        stack = _open_stack()
        self.parent = stack[-1] if stack else None
        stack.append(self.id)
        self.start_ns = time.time_ns()
        if _autograd_profiler._is_profiler_enabled:
            self._rf = torch.profiler.record_function(self.name)
            self._rf.__enter__()
        return self

    def __exit__(self, *exc) -> bool:
        self.end_ns = time.time_ns()
        if self._rf is not None:
            self._rf.__exit__(*exc)
            self._rf = None
        _open_stack().pop()
        RING.add(self)
        return False


class Ring:
    """The last ``capacity`` spans recorded, and how many fell off."""

    def __init__(self, capacity: int):
        self.capacity = capacity
        self.recorded = 0
        self._spans: "collections.deque[Span]" = collections.deque(maxlen=capacity)
        self._lock = threading.Lock()

    def add(self, span: Span) -> None:
        with self._lock:
            self._spans.append(span)
            self.recorded += 1

    @property
    def dropped(self) -> int:
        return max(self.recorded - self.capacity, 0)

    def snapshot(self) -> List[Span]:
        """The spans held, oldest first."""
        with self._lock:
            return list(self._spans)


RING = Ring(CAPACITY)
_ids = itertools.count(1)
_local = threading.local()
_request: contextvars.ContextVar[Optional[str]] = contextvars.ContextVar("request_id",
                                                                         default=None)


def _open_stack() -> list:
    stack = getattr(_local, "stack", None)
    if stack is None:
        stack = _local.stack = []
    return stack


def span(name: str, **attrs: Any) -> Span:
    """``with span(name, rows=8) as s:`` records the enclosed block;
    ``s.attrs`` may be added to inside it."""
    return Span(name, attrs)


@contextlib.contextmanager
def request(request_id: str) -> Iterator[None]:
    """Make ``request_id`` the current request of the enclosed block."""
    token = _request.set(request_id)
    try:
        yield
    finally:
        _request.reset(token)


def request_id() -> Optional[str]:
    """The current request's id, None outside a request."""
    return _request.get()
