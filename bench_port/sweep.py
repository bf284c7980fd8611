"""The open loop's capacity, found once on the card: for each offered rate
a window of the cell's open traffic through one process's engines, and
whether the backlog grew over it. The highest rate whose backlog does not
grow is the knee; an open cell offers a fixed share of it (written into its
traffic file as a number):

    python3 bench_port/sweep.py --workload native.open-10s --seconds 45 --rates 0.4,0.6,0.8,1.0

Prints one JSON line a rate: requests offered and completed in the window,
in flight at its middle and at its close, and the p50 / p90 latency of the
first and the second half's arrivals."""

from __future__ import annotations

import argparse
import json
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
if str(ROOT) not in sys.path:
    sys.path.insert(0, str(ROOT))


def backlog(window, at: float) -> int:
    """Requests due by ``at`` and not done by it."""
    return sum(1 for r in window.requests
               if r.due <= at and (r.done is None or r.done > at))


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seconds", type=float, default=45.0)
    ap.add_argument("--rates", required=True)
    ap.add_argument("--seed", type=int, default=1)
    args = ap.parse_args(argv)
    import torch

    from bench_port.lib import drive, stats, system
    from bench_port.lib import traffic as traffic_mod
    from bench_port.lib.record import Recorder
    from bench_port.lib.spec import load_cell

    if not torch.cuda.is_available():
        print("bench_port sweep: no CUDA device", file=sys.stderr)
        return 3
    cell = load_cell(args.workload)
    recorder = Recorder(args.seed).install()
    try:
        sut = system.build(cell.config, cell.traffic, "cuda", recorder)
        inputs = traffic_mod.requests(cell.traffic, args.seed)
        drive.warm(sut, cell.traffic, inputs)
        for rate in (float(r) for r in args.rates.split(",")):
            traffic = {**cell.traffic, "rate_per_s": rate}
            w = drive.run_window(sut.backend, traffic, inputs, args.seed, args.seconds)
            mid = w.start + (w.end - w.start) / 2
            lat = stats.latencies(w)
            first = [x for r, x in zip(w.requests, lat) if r.due < mid]
            second = [x for r, x in zip(w.requests, lat) if r.due >= mid]
            row = {"rate": rate, "offered": len(w.requests), "completed": len(stats.completed(w)),
                   "failed": sum(1 for r in w.requests if r.error),
                   "backlog_mid": backlog(w, mid), "backlog_end": backlog(w, w.end),
                   "p50_first": stats.percentile(first, 50) if first else None,
                   "p90_first": stats.percentile(first, 90) if first else None,
                   "p50_second": stats.percentile(second, 50) if second else None,
                   "p90_second": stats.percentile(second, 90) if second else None,
                   "late_s": w.late_s}
            print(json.dumps(row), flush=True)
        sut.shutdown()
    finally:
        recorder.uninstall()
    return 0


if __name__ == "__main__":
    sys.exit(main())
