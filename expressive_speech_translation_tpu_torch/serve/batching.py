"""Micro-batching: concurrent requests → one batched dispatch (copy of the
JAX package's ``serve/batching.py``).

A collector thread blocks on the first submitted request, gathers whatever
else arrives within ``max_wait_ms`` (up to ``max_batch``), runs one batched
call, and hands each caller its own result. The engines pad each batch to a
bucket of ``core/buckets.py``, so a serving lifetime touches a handful of
shapes.

Model-agnostic: it batches any ``run_batch: list[item] -> list[result]``.
Each dispatch is a span (``obs/spans.py``, named by the batcher's ``span``)
carrying its rows, the ids of the requests whose items it carried and each
item's submit time, so a reader tells the queue wait from the dispatch.
"""

from __future__ import annotations

import logging
import queue
import threading
import time
from concurrent.futures import Future
from typing import Any, Callable, List, Optional

from ..obs import spans

log = logging.getLogger(__name__)


class MicroBatcher:
    """Gathers submitted items into batches for one runner callable.

    ``submit`` is thread-safe and returns a ``Future``. The wait window
    bounds the latency a request pays for batching; the batch width is the
    throughput gained."""

    _SHUTDOWN = object()

    def __init__(self, run_batch: Callable[[List[Any]], List[Any]], *, max_batch: int = 8,
                 max_wait_ms: float = 20.0, name: str = "microbatcher",
                 span: str = "dispatch"):
        if max_batch < 1:
            raise ValueError("max_batch must be >= 1")
        self._run_batch = run_batch
        self._span = span
        self.max_batch = max_batch
        self.max_wait_s = max_wait_ms / 1000.0
        self._q: "queue.Queue[Any]" = queue.Queue()
        self._closed = False
        self._submit_lock = threading.Lock()
        # served items and batches (only the collector thread writes them)
        self.n_items = 0
        self.n_batches = 0
        self._thread = threading.Thread(target=self._loop, name=name, daemon=True)
        self._thread.start()

    def submit(self, item: Any) -> Future:
        # the closed check and the enqueue are one step: a submit racing
        # shutdown() could otherwise land behind the sentinel, and its
        # Future would never resolve
        with self._submit_lock:
            if self._closed:
                raise RuntimeError("MicroBatcher is shut down")
            fut: Future = Future()
            self._q.put((item, fut, spans.request_id(), time.time_ns()))
        return fut

    def __call__(self, item: Any) -> Any:
        """Submit and wait."""
        return self.submit(item).result()

    def shutdown(self, *, wait: bool = True) -> None:
        with self._submit_lock:
            if self._closed:
                return
            self._closed = True
            self._q.put(self._SHUTDOWN)
        if wait:
            self._thread.join(timeout=30)

    def _collect(self) -> Optional[List[tuple]]:
        first = self._q.get()
        if first is self._SHUTDOWN:
            return None
        batch = [first]
        t_end = time.monotonic() + self.max_wait_s
        while len(batch) < self.max_batch:
            remaining = t_end - time.monotonic()
            if remaining <= 0:
                break
            try:
                nxt = self._q.get(timeout=remaining)
            except queue.Empty:
                break
            if nxt is self._SHUTDOWN:
                self._q.put(self._SHUTDOWN)  # for the outer loop
                break
            batch.append(nxt)
        return batch

    def _loop(self) -> None:
        while True:
            batch = self._collect()
            if batch is None:
                return
            items = [b[0] for b in batch]
            futures = [b[1] for b in batch]
            try:
                with spans.span(self._span, rows=len(items), requests=[b[2] for b in batch],
                                submitted_ns=[b[3] for b in batch]):
                    results = self._run_batch(items)
                if len(results) != len(items):
                    raise RuntimeError(
                        f"run_batch returned {len(results)} results for {len(items)} items")
            except Exception as e:  # noqa: BLE001 — every caller of the batch gets the error
                log.exception("%s: batch of %d failed", self._thread.name, len(items))
                for f in futures:
                    if not f.done():
                        f.set_exception(e)
                continue
            self.n_items += len(items)
            self.n_batches += 1
            for f, r in zip(futures, results):
                if not f.done():
                    f.set_result(r)


class _BatchedEngine:
    """What the Batched* facades share: the engine check, the MicroBatcher,
    ``weightless`` and ``stats``, shutdown, and streaming methods that bypass
    the batcher.

    Streaming methods (``_STREAM_ATTRS``) resolve through ``__getattr__`` and
    exist on the facade only when the inner engine has them, so ``hasattr``
    on the facade tells the truth."""

    _BATCH_ATTR = ""
    _STREAM_ATTRS: tuple = ()
    _STAGE = ""     # names the collector thread and the dispatch span

    def __init__(self, engine: Any, *, max_batch: int, max_wait_ms: float):
        run = getattr(engine, self._BATCH_ATTR, None)
        if run is None:
            raise TypeError(f"engine must expose {self._BATCH_ATTR}(requests)")
        self.engine = engine
        self._mb = MicroBatcher(run, max_batch=max_batch, max_wait_ms=max_wait_ms,
                                name=f"{self._STAGE}-microbatch",
                                span=f"dispatch.{self._STAGE}")

    def __getattr__(self, name: str):
        if name in self._STREAM_ATTRS:
            return getattr(self.engine, name)
        raise AttributeError(name)

    @property
    def weightless(self):
        """The inner engine's weights state, so weights-gated checks (the
        cascade's empty-translation failure) see through the facade."""
        return getattr(self.engine, "weightless", None)

    @property
    def stats(self) -> dict:
        return {"items": self._mb.n_items, "batches": self._mb.n_batches}

    def shutdown(self):
        self._mb.shutdown()


class BatchedTts(_BatchedEngine):
    """TTS facade: ``synthesize`` callers coalesce into
    ``engine.synthesize_batch`` dispatches."""

    _BATCH_ATTR = "synthesize_batch"
    _STREAM_ATTRS = ("synthesize_streaming",)
    _STAGE = "tts"

    def __init__(self, engine: Any, *, max_batch: int = 8, max_wait_ms: float = 20.0):
        super().__init__(engine, max_batch=max_batch, max_wait_ms=max_wait_ms)
        self.sample_rate = getattr(engine, "sample_rate", 24_000)

    def synthesize(self, text: str, *, style_prompt: str = "", reference_audio_16k: Any = None,
                   language: str = "en"):
        return self._mb({"text": text, "style_prompt": style_prompt,
                         "reference_audio_16k": reference_audio_16k, "language": language})


class BatchedAsr(_BatchedEngine):
    """ASR facade: ``transcribe`` callers coalesce into
    ``engine.transcribe_batch`` dispatches."""

    _BATCH_ATTR = "transcribe_batch"
    _STREAM_ATTRS = ("transcribe_streaming",)
    _STAGE = "asr"

    def __init__(self, engine: Any, *, max_batch: int = 8, max_wait_ms: float = 20.0):
        super().__init__(engine, max_batch=max_batch, max_wait_ms=max_wait_ms)

    def transcribe(self, audio_16k: Any, language: Optional[str] = None):
        return self._mb({"audio_16k": audio_16k, "language": language})


class BatchedNmt(_BatchedEngine):
    """NMT facade: ``translate`` callers coalesce into
    ``engine.translate_batch`` dispatches."""

    _BATCH_ATTR = "translate_batch"
    _STAGE = "nmt"

    def __init__(self, engine: Any, *, max_batch: int = 16, max_wait_ms: float = 10.0):
        super().__init__(engine, max_batch=max_batch, max_wait_ms=max_wait_ms)

    def translate(self, text: str, source_lang: str, target_lang: str) -> str:
        return self._mb({"text": text, "source_lang": source_lang, "target_lang": target_lang})
