"""The readers of the port's spans (``metrics/_spans.py`` and the nine
metrics on it) on a hand-built context whose spans and device intervals
overlap in known ways, with nothing to read, on a port without spans, and in
a toy traced run on the CPU."""

from __future__ import annotations

import sys
import time

import pytest
import torch

from bench_port.lib import readers, runner, trace
from bench_port.lib.drive import Request, Window
from bench_port.tests.toy import toy_cell
from expressive_speech_translation_tpu_torch import obs
from expressive_speech_translation_tpu_torch.obs import spans

NEW = ["queue_wait_s.asr", "queue_wait_s.nmt", "queue_wait_s.tts", "decode_step_ms.asr",
       "decode_step_ms.nmt", "decode_step_ms.tts", "idle_pct.decode", "idle_pct.no_dispatch",
       "stage_s.post"]
SPAN_READERS = [n for n in NEW if n != "stage_s.post"]


def _span(name, start, end, parent=None, thread=1, **attrs):
    s = spans.Span(name, attrs)
    s.start_ns, s.end_ns, s.parent, s.thread = start, end, parent, thread
    return s


def _held():
    """The window is [550, 2000] ns, its traced slice [1000, 2000]. Two asr
    dispatches began before the window, an nmt and a tts one inside the
    slice; each has a decode loop, the first asr one half inside the
    window; one decode loop ran outside any dispatch."""
    early = _span("dispatch.asr", 300, 720, thread=2, submitted_ns=[250], requests=["z"])
    asr = _span("dispatch.asr", 500, 1080, thread=2, submitted_ns=[400], requests=["a"])
    tts = _span("dispatch.tts", 1050, 1700, thread=3, submitted_ns=[1000, 950],
                requests=["a", "b"])
    nmt = _span("dispatch.nmt", 1750, 1850, thread=4, submitted_ns=[1740], requests=["c"])
    return [early, asr, tts, nmt,
            _span("decode", 400, 700, parent=early.id, thread=2, steps=6),
            _span("decode", 600, 1050, parent=asr.id, thread=2, steps=5),
            _span("decode", 1100, 1400, parent=tts.id, thread=3, steps=10),
            _span("tts.flow", 1400, 1650, parent=tts.id, thread=3),
            _span("decode", 1760, 1840, parent=nmt.id, thread=4, steps=4),
            _span("decode", 1300, 1350, thread=5, steps=1)]


def _ctx(held=None, traced=True, requests=()):
    if held is not None:
        ring = spans.Ring(64)
        for s in held:
            ring.add(s)
        spans.RING = ring
    events = [trace.Event("k", "kernel", s, e - s)
              for s, e in ((1100, 1200), (1150, 1300), (1500, 1600), (1900, 2100))]
    events.append(trace.Event("cudaLaunchKernel", "cuda_runtime", 1700, 60))
    sl = trace.Slice(100.0, 100.0 + 1e-6, 1000, 2000, events, []) if traced else None
    window = Window(100.0 - 450e-9, 100.0 + 1e-6, list(requests), 0.0)
    return readers.Context(config={}, traffic={}, window=window,
                           dispatches=[], batch_stats={}, flops_per_row={}, slice=sl)


@pytest.fixture(autouse=True)
def _keep_ring(monkeypatch):
    monkeypatch.setattr(spans, "RING", spans.RING)


# Steps: the first asr loop has 150 of its 300 ns inside the window, so 3 of
# its 6 steps. Busy in the slice: [1100, 1300] [1500, 1600] [1900, 2000] =
# 400 ns. Decode loops under a dispatch, clipped to the slice: [1000, 1050]
# [1100, 1400] [1760, 1840], idle in 50 + 100 + 80 ns. Dispatches cover
# [1000, 1700] [1750, 1850]; with the busy union, all but [1700, 1750]
# [1850, 1900].
@pytest.mark.parametrize("name, value", [
    ("queue_wait_s.asr", None),          # its dispatches began before the window
    ("queue_wait_s.nmt", 10e-9),
    ("queue_wait_s.tts", 75e-9),
    ("decode_step_ms.asr", (150 + 450) / (3 + 5) / 1e6),
    ("decode_step_ms.nmt", 80 / 4 / 1e6),
    ("decode_step_ms.tts", 300 / 10 / 1e6),
    ("idle_pct.decode", 23.0),
    ("idle_pct.no_dispatch", 10.0),
])
def test_a_reader_gives_the_hand_computed_value(name, value):
    got = readers.load(name)(_ctx(_held()))
    assert got == pytest.approx(value) if value is not None else got is None


def test_the_idle_split_fits_inside_the_device_idle_share():
    ctx = _ctx(_held())
    idle = readers.load("device_idle_pct")(ctx)
    assert idle == pytest.approx(60.0)
    split = readers.load("idle_pct.decode")(ctx) + readers.load("idle_pct.no_dispatch")(ctx)
    assert split <= idle


def test_stage_s_post_reads_the_completed_requests_post_stage():
    done = [Request(due=0.0, done=5.0, stages={"post": 0.25}),
            Request(due=0.0, done=6.0, stages={"post": 0.75}), Request(due=0.0)]
    assert readers.load("stage_s.post")(_ctx(requests=done)) == pytest.approx(0.5)
    assert readers.load("stage_s.post")(_ctx(requests=done[2:])) is None


@pytest.mark.parametrize("name", SPAN_READERS)
def test_a_reader_finds_nothing_without_a_slice_spans_or_the_spans_module(name, monkeypatch):
    read = readers.load(name)
    assert read(_ctx(_held(), traced=False)) is None
    assert read(_ctx([])) is None
    ctx = _ctx(_held())
    # a port without obs/spans.py
    monkeypatch.delattr(obs, "spans")
    monkeypatch.setitem(sys.modules, "expressive_speech_translation_tpu_torch.obs.spans", None)
    assert read(ctx) is None


def test_a_toy_traced_run_reports_all_nine_metrics():
    torch.manual_seed(0)
    res = runner.run(toy_cell("native", "closed"), 2**31 + 777, 12.0, True, time.perf_counter(),
                     device="cpu")
    assert res["correct"]
    assert set(NEW) <= set(res["metrics"]), sorted(set(NEW) - set(res["metrics"]))
    got = {n: res["metrics"][n]["value"] for n in NEW}
    assert all(v >= 0 for v in got.values())
    assert got["idle_pct.decode"] + got["idle_pct.no_dispatch"] <= \
        res["metrics"]["device_idle_pct"]["value"] + 1e-9
