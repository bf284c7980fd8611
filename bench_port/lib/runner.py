"""One run of one cell: set-up (the kernels' build, the engines, the cell's
warm batches; ``CascadedBackend.initialize()``, which warms the single-request
shapes no cell sends, is left out), the measured window (its last seconds
traced with ``trace``), the device's numbers, then the program freed and the
judge; → the result's fields. A control run (``control=True``) judges the
control's readings in the program's place by the same limits."""

from __future__ import annotations

import gc
import sys
import time
from typing import Any, Dict, Optional

import torch

from . import drive, readers, stats, system, trace
from . import traffic as traffic_mod
from . import judge as judge_mod
from .judge import Judge, token_counts
from .record import Recorder
from .spec import Cell

FORBIDDEN = ("jax", "jaxlib", "flax", "expressive_speech_translation_tpu")


def forbidden_modules() -> list:
    """Top-level names of loaded modules that must not be there, compared
    whole (the port's name begins with the JAX package's)."""
    tops = {name.split(".")[0] for name in list(sys.modules)}
    return sorted(tops & set(FORBIDDEN))


def _device_info(device: torch.device, chips: int) -> Dict[str, Any]:
    if device.type == "cuda":
        return {"platform": "gpu", "kind": torch.cuda.get_device_name(device), "count": chips,
                "memory_peak_bytes": int(torch.cuda.max_memory_allocated(device))}
    return {"platform": "cpu", "kind": "cpu", "count": chips, "memory_peak_bytes": 0}


def _sync(device: torch.device) -> None:
    if device.type == "cuda":
        torch.cuda.synchronize(device)


def checks(limits: Dict[str, float], numbers: Dict[str, Any]) -> Dict[str, Dict[str, Any]]:
    """Each compared number beside its limit."""
    return {name: {"value": numbers.get(name), "limit": limits[name]} for name in limits}


def passes(checked: Dict[str, Dict[str, Any]]) -> bool:
    return all(c["value"] is not None and c["value"] <= c["limit"] for c in checked.values())


def run(cell: Cell, seed: int, seconds: float, traced: bool, t_start: float,
        device: Optional[str] = None, log=sys.stderr, control: bool = False) -> Dict[str, Any]:
    """The run's result (the keys of the last line, ``checks`` last)."""
    from expressive_speech_translation_tpu_torch.ops import build as kbuild

    dev = torch.device(device or "cuda")
    config, traffic = cell.config, cell.traffic
    parts: Dict[str, float] = {}

    def phase(name: str, t0: float) -> float:
        _sync(dev)
        now = time.perf_counter()
        parts[name] = now - t0
        print(f"  {name}: {parts[name]:.3f} s", file=log, flush=True)
        return now

    t = time.perf_counter()
    if dev.type == "cuda":
        kbuild.build(config["kernels"])
    t = phase("build_s", t)
    recorder = Recorder(seed).install()
    try:
        sut = system.build(config, traffic, dev, recorder)
        t = phase("engines_s", t)
        inputs = traffic_mod.requests(traffic, seed)
        drive.warm(sut, traffic, inputs)
        t = phase("warm_s", t)
        widths = {s: sorted({n for st, n in recorder.started if st == s}) for s in sut.stages}
        print(f"  warmed widths {widths}", file=log, flush=True)
        before = {k: dict(f.stats) for k, f in sut.stages.items()}
        tracer = trace.Tracer(recorder, seconds).prepare() if traced else None
        recorder.pick(judge_mod.FROM_DISPATCHES, judge_mod.ROWS)
        recorder.active = True
        window = drive.run_window(sut.backend, traffic, inputs, seed, seconds,
                                  during=tracer or (lambda start: None))
        _sync(dev)
        recorder.active = False
        if tracer:
            tracer.finish()
        after = {k: dict(f.stats) for k, f in sut.stages.items()}
        setup_s = window.start - t_start
        dev_info = _device_info(dev, cell.chips)
        sut.shutdown()
        del sut
    finally:
        recorder.uninstall()
    gc.collect()
    if dev.type == "cuda":
        torch.cuda.empty_cache()

    dispatches = recorder.dispatches
    t = time.perf_counter()
    counts = token_counts(dispatches, traffic["pins"], config["nmt"]["pad_token"])
    judge = Judge(config, traffic, seed, dev, control=control)
    numbers = {"tokens_off": counts["tokens_off"], **judge.run(dispatches)}
    if control:
        numbers = judge_mod.control_numbers(numbers)
    parts["judge_s"] = time.perf_counter() - t
    print(f"  judge_s: {parts['judge_s']:.3f} s; decoded tokens a row {counts['counts']}",
          file=log, flush=True)

    failed = sum(1 for r in window.requests if r.error)
    metrics: Dict[str, Dict[str, Any]] = {}
    e2e = {"requests_per_s": lambda: stats.requests_per_s(window),
           "setup_s": lambda: setup_s}
    result: Dict[str, Any] = {}
    if traced:
        ctx = readers.Context(config=config, traffic=traffic, window=window,
                              dispatches=dispatches,
                              batch_stats={k: {m: after[k][m] - before[k][m] for m in after[k]}
                                           for k in after},
                              flops_per_row=judge.flops.per_row,
                              slice=tracer.slice if tracer else None)
        for m in cell.per_layer:
            value = readers.load(m["name"])(ctx)
            if value is not None:
                metrics[m["name"]] = {"value": float(value), "unit": m["unit"]}
        sl = tracer.slice
        dev_info.update(busy_s=trace.busy_s(sl), window_s=sl.seconds)
        result["breakdown"] = {"device_ops": trace.device_ops(sl),
                               "idle_gaps": trace.idle_gaps(sl, dispatches)}
    else:
        for m in cell.end_to_end:
            metrics[m["name"]] = {"value": float(e2e[m["name"]]()), "unit": m["unit"]}

    limits = config["limits"]
    checked = checks(limits, numbers)
    readings = {k: v for k, v in numbers.items() if k not in limits}
    correct = failed == 0 and passes(checked)
    errors = sorted({r.error for r in window.requests if r.error})
    return {"correct": correct, "attempted": len(window.requests), "failed": failed,
            "metrics": metrics, "device": dev_info, **result,
            "setup_parts": parts, "late_s": window.late_s, "errors": errors[:3],
            "drain_s": window.drained - window.end,
            "window_requests_per_s": stats.window_requests_per_s(window),
            "readings": readings, "checks": checked}
