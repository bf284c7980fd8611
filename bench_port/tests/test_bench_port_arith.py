"""The harness's arithmetic against hand-worked cases: percentiles and rates
over all requests (in-flight ones at their age), the arrival schedule, the
resblock's operations and bytes, the roofline and MFU shares, and the
trace reductions."""

from __future__ import annotations

import math

import pytest

from bench_port.lib import stats, trace, traffic, work
from bench_port.lib.drive import Request, Window
from bench_port.lib.readers import Context, kernel_roofline_pct, window_flops
from bench_port.lib.record import Dispatch


def _window():
    # a 10 s window: three requests done inside, one done after the close,
    # one still in flight, one failed
    reqs = [Request(due=0.0, done=2.0), Request(due=1.0, done=4.0), Request(due=2.0, done=9.0),
            Request(due=6.0, done=12.0), Request(due=8.0), Request(due=9.5, error="boom")]
    return Window(start=0.0, end=10.0, requests=reqs, late_s=0.0, drained=15.0)


def test_rate_counts_only_requests_completed_in_the_window():
    assert stats.window_requests_per_s(_window()) == pytest.approx(3 / 10.0)


def test_rate_counts_every_returned_request_over_the_drained_window():
    # four done before the drain ended at 15 s; the one in flight never
    # returned and the failed one count as work not done
    w = _window()
    w.requests[4].done = 14.0
    assert stats.requests_per_s(w) == pytest.approx(5 / 15.0)


def test_latency_counts_in_flight_requests_at_their_age():
    w = _window()
    assert stats.latencies(w) == pytest.approx([2.0, 3.0, 7.0, 4.0, 2.0, 0.5])
    # nearest rank: ceil(0.9 * 6) = 6th of [0.5, 2, 2, 3, 4, 7]
    assert stats.latency_p90_s(w) == 7.0
    assert stats.percentile(list(range(1, 11)), 90) == 9
    assert stats.percentile([5.0], 90) == 5.0


def test_open_arrivals_are_one_set_of_gaps_in_a_seeded_order():
    a = traffic.open_arrivals(7, 2.0, 30.0)
    b = traffic.open_arrivals(2**31 + 5, 2.0, 30.0)
    assert a == traffic.open_arrivals(7, 2.0, 30.0)
    assert a != b and all(0 <= t < 30.0 for t in a + b)
    n = int(math.ceil(2.0 * 30.0 * 1.5))
    fixed = {round(-math.log1p(-(j + 0.5) / n) / 2.0, 6) for j in range(n)}
    for ts in (a, b):
        assert {round(y - x, 6) for x, y in zip([0.0] + ts, ts)} <= fixed
        assert 0.7 * 60 <= len(ts) <= 1.3 * 60


def test_utterances_follow_the_seed():
    x = traffic.utterances(3, 2, 1.0)
    y = traffic.utterances(3, 2, 1.0)
    assert len(x) == 2 and x[0].shape == (16_000,) and (x[0] == y[0]).all()
    assert not (x[0] == x[1]).all()


def test_resblock_work_by_hand():
    # one branch of width 3 at dilations (1, 2): 2 units × 2 convs × 3 taps = 12 taps
    flops, nbytes = work.resblock_work(2, 8, 100, 2, (3,), ((1, 2),))
    assert flops == 2 * 8 * 8 * 100 * 12 * 2
    assert nbytes == (2 * 2 * 100 * 8 + 12 * 8 * 8 + 4 * 8) * 2
    # the native vocoder's stage at C = 64: 126 taps
    f, _ = work.resblock_work(16, 64, 245_760, 2, (3, 7, 11), ((1, 3, 5),) * 3)
    assert f == 2 * 64 * 64 * 245_760 * 126 * 16
    assert work.bound_s(f, 1.0, 2) == pytest.approx(f / 989e12)
    assert work.bound_s(1.0, 3.35e12, 4) == pytest.approx(1.0)
    assert work.mfu_pct(989e12, 2.0) == pytest.approx(50.0)


def _slice(events, calls=(), launches=0):
    return trace.Slice(t0=0.0, t1=1.0, t0_ns=1_000, t1_ns=11_000, events=events,
                       resblock_calls=list(calls), launches=launches)


class _Raw:
    """A profiler event as ``torch.profiler`` gives it."""

    def __init__(self, name, device, start, dur):
        self._n, self._d, self._s, self._t = name, device, start, dur

    def name(self):
        return self._n

    def device_type(self):
        return type("D", (), {"name": self._d})()

    def start_ns(self):
        return self._s

    def duration_ns(self):
        return self._t


def test_reduce_events_keeps_the_cards_operations_and_counts_launches():
    raw = [_Raw("gemm", "CUDA", 1_500, 100), _Raw("Memcpy DtoH", "CUDA", 2_000, 10),
           _Raw("cudaLaunchKernel", "CPU", 1_200, 5), _Raw("cuLaunchKernelEx", "CPU", 10_999, 5),
           _Raw("cudaLaunchKernel", "CPU", 11_000, 5),          # at the end: outside
           _Raw("cudaStreamSynchronize", "CPU", 3_000, 80_000), _Raw("aten::mm", "CPU", 0, 9)]
    kept, n, kinds = trace.reduce_events(raw, 1_000, 11_000)
    assert n == 2
    assert [(e.name, e.kind) for e in kept] == [("gemm", "kernel"), ("Memcpy DtoH", "gpu_memcpy"),
                                                ("cudaStreamSynchronize", "cuda_runtime")]
    assert kinds == {"kernel": 1, "gpu_memcpy": 1, "cuda_runtime": 4, "cpu_op": 1}


def test_trace_busy_union_launches_and_gaps():
    ev = [trace.Event("k1", "kernel", 500, 1_500),          # clipped to [1000, 2000]
          trace.Event("k2", "kernel", 1_500, 1_000),         # overlaps k1: union [1000, 2500]
          trace.Event("Memcpy HtoD", "gpu_memcpy", 5_000, 1_000),
          trace.Event("cudaLaunchKernel", "cuda_runtime", 3_000, 100),
          trace.Event("cudaLaunchKernel", "cuda_runtime", 12_000, 100),   # after the slice
          trace.Event("cudaStreamSynchronize", "cuda_runtime", 7_000, 3_000)]
    sl = _slice(ev, launches=1)
    assert trace.busy_s(sl) == pytest.approx((1_500 + 1_000) / 1e9)
    assert trace.launches(sl) == 1
    d = Dispatch("tts", 0.0, 6_500, [{}], t1=0.5, t1_ns=10_500)
    gaps = trace.idle_gaps(sl, [d])
    assert gaps[0] == ["tts: cudaStreamSynchronize", pytest.approx(5_000 / 1e9)]
    assert gaps[1] == ["no dispatch: python", pytest.approx(2_500 / 1e9)]
    assert trace.device_ops(sl)[0][0] == "k1"


def test_resblock_pairs_align_calls_with_kernels():
    k = [trace.Event("void resblock_stage_wg_kernel<128, 256>(StageArgs)", "kernel", 2_000, 100),
         trace.Event("void resblock_stage_wg_kernel<64, 512>(StageArgs)", "kernel", 3_000, 300)]
    # the first call's kernel ran before the slice began
    calls = [(16, 64, 245_760, 2), (16, 128, 24_576, 2), (16, 64, 245_760, 2)]
    pairs = trace.resblock_pairs(_slice(k, calls))
    assert [c for c, _ in pairs] == [calls[1], calls[2]]
    ctx = Context(config={}, traffic={}, window=_window(), dispatches=[], batch_stats={},
                  flops_per_row={})
    voc = ((3, 7, 11), ((1, 3, 5),) * 3)
    pct = kernel_roofline_pct(ctx, pairs, lambda c: work.resblock_work(*c, *voc))
    want = sum(work.bound_s(*work.resblock_work(*c, *voc), 2) for c in calls[1:]) / 400e-9 * 100
    assert pct == pytest.approx(want)


def test_window_flops_count_rows_of_dispatches_that_ended_inside():
    w = _window()
    ds = [Dispatch("asr", 1.0, 0, [{}, {}], t1=3.0), Dispatch("tts", 5.0, 0, [{}], t1=9.0),
          Dispatch("tts", 9.0, 0, [{}, {}], t1=11.0),       # half of it inside the window
          Dispatch("asr", 10.5, 0, [{}], t1=12.0)]          # after the close
    ctx = Context(config={}, traffic={}, window=w, dispatches=ds, batch_stats={},
                  flops_per_row={"asr": 10.0, "tts": 100.0})
    assert window_flops(ctx) == pytest.approx(2 * 10.0 + 100.0 + 2 * 100.0 * 0.5)
    assert math.isfinite(window_flops(ctx))


def test_the_readers_of_the_traced_slice():
    from bench_port.lib.readers import load
    w = _window()
    sl = _slice([trace.Event("k", "kernel", 1_000, 2_500)], launches=30)
    ctx = Context(config={}, traffic={"loop": "closed", "clients": 2}, window=w, dispatches=[],
                  batch_stats={"asr": {"items": 12, "batches": 3}, "nmt": {"items": 0, "batches": 0}},
                  flops_per_row={}, slice=sl)
    # 30 launches in the slice [0, 1) s, in which no dispatch ran
    assert load("launches_per_request")(ctx) is None
    ctx.dispatches = [Dispatch("asr", 0.0, 0, [{}] * 3, t1=2.0),     # half of it in the slice
                      Dispatch("tts", 0.5, 0, [{}] * 3, t1=1.0)]     # all of it
    # (3 × 0.5 + 3) rows over three stages: 1.5 requests' worth
    assert load("launches_per_request")(ctx) == pytest.approx(30 / 1.5)
    ctx.dispatches = []
    assert load("device_idle_pct")(ctx) == pytest.approx(75.0)
    assert load("batch_rows.asr")(ctx) == 4.0
    assert load("batch_rows.nmt")(ctx) is None
    assert load("stage_s.tts")(ctx) is None
    assert load("resblock_roofline")(Context(config={"tts": {"config": {}}}, traffic={}, window=w,
                                             dispatches=[], batch_stats={}, flops_per_row={},
                                             slice=sl)) is None
