"""The measured window: a closed loop of clients or an open loop of
scheduled arrivals against ``CascadedBackend.translate_speech``, each
request timed from when it was due. When the window's time is up nothing
more is sent; the requests in flight are waited for, and the clock is read
after that wait (``drained``), so the rate counts all the work sent over all
the time it took."""

from __future__ import annotations

import dataclasses
import threading
import time
from concurrent.futures import ThreadPoolExecutor
from typing import Any, Callable, Dict, List, Optional

import numpy as np

from . import traffic as traffic_mod


@dataclasses.dataclass
class Request:
    due: float
    done: Optional[float] = None       # None while in flight or when it failed
    error: Optional[str] = None
    stages: Dict[str, float] = dataclasses.field(default_factory=dict)


@dataclasses.dataclass
class Window:
    start: float
    end: float
    requests: List[Request]
    late_s: float                      # how late the open loop's generator ran, at most
    drained: Optional[float] = None    # the clock once every request sent had returned


def _serve(backend, x: np.ndarray, traffic: Dict[str, Any], req: Request) -> None:
    try:
        out = backend.translate_speech(x, traffic["source_lang"], traffic["target_lang"],
                                       use_voice_cloning=bool(traffic["voice_cloning"]))
        req.stages = {k: v["seconds"] for k, v in out["stage_summary"].items() if k != "total"}
        req.done = time.perf_counter()
    except Exception as e:  # noqa: BLE001 — a failed request is counted, not fatal
        req.error = f"{type(e).__name__}: {e}"


STAGE_CALLS = {"asr": "transcribe_batch", "nmt": "translate_batch", "tts": "synthesize_batch"}


def warm(sut, traffic: Dict[str, Any], inputs: List[np.ndarray]) -> None:
    """The cell's shapes: one request through ``translate_speech`` (the
    orchestrator's own steps), then each stage's engine called directly with
    that request's stage input repeated at every batch width the batchers
    can form (the bucket ladder up to ``max_batch``), one width after
    another on this thread."""
    from expressive_speech_translation_tpu_torch.core.buckets import BATCH_BUCKETS

    req = Request(due=0.0)
    _serve(sut.backend, inputs[0], traffic, req)
    if req.error:
        raise RuntimeError(f"warm-up request failed: {req.error}")
    width = int(traffic["batch"]["max_batch"])
    widths = sorted({b for b in BATCH_BUCKETS if 1 < b < width} | {width})
    for stage, call in STAGE_CALLS.items():
        item = sut.recorder.last_items[stage][0]
        for w in widths:
            getattr(sut.inner(stage), call)([dict(item) for _ in range(w)])


def run_window(backend, traffic: Dict[str, Any], inputs: List[np.ndarray], seed: int,
               seconds: float, during: Callable[[float], None] = lambda start: None) -> Window:
    """Drive ``seconds`` of the traffic; ``during(start)`` runs on this
    thread while the load runs (the trace)."""
    requests: List[Request] = []
    lock = threading.Lock()
    start = time.perf_counter()
    end = start + seconds
    late = 0.0
    if traffic["loop"] == "closed":
        clients = int(traffic["clients"])

        def client(c: int) -> None:
            k = 0
            while time.perf_counter() < end:
                req = Request(due=time.perf_counter())
                with lock:
                    requests.append(req)
                _serve(backend, inputs[(c + k * clients) % len(inputs)], traffic, req)
                k += 1

        threads = [threading.Thread(target=client, args=(c,), name=f"client-{c}")
                   for c in range(clients)]
        for t in threads:
            t.start()
        during(start)
        for t in threads:
            t.join()
        drained = time.perf_counter()
    else:
        arrivals = traffic_mod.open_arrivals(seed, float(traffic["rate_per_s"]), seconds)
        pool = ThreadPoolExecutor(int(traffic["uploaders"]), thread_name_prefix="uploader")
        tracer = threading.Thread(target=during, args=(start,), name="trace")
        tracer.start()
        for i, offset in enumerate(arrivals):
            due = start + offset
            wait = due - time.perf_counter()
            if wait > 0:
                time.sleep(wait)
            late = max(late, time.perf_counter() - due)
            req = Request(due=due)
            requests.append(req)
            pool.submit(_serve, backend, inputs[i % len(inputs)], traffic, req)
        tracer.join()
        pool.shutdown(wait=True)
        drained = time.perf_counter()
    return Window(start=start, end=end, requests=requests, late_s=late, drained=drained)
