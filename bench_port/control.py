"""The readings that set a cell's limits, on the card at the cell's own
size: for each seed a short window of the cell's traffic through the
program, judged as a run judges it, with the control read beside each
number (the reference computed in fp8 e4m3, put in the program's place at
the same prompts and tokens) and judged by the same limits
(``control_correct``, which has to come out false); then, with
``--int8-seeds``, the port's own int8 decode path (``quantize=True``) as the
program. One process builds the engines once for all seeds:

    python3 bench_port/control.py --workload native.c16-10s --seconds 15 \\
        --seeds 1,2,3,4,5,6,7,8,9,10,11,12 --int8-seeds 21,22,23

Prints one JSON line a seed (``program``: bf16 or int8, the numbers,
``correct`` and, beside the bf16 program, ``control_correct``). A single
full run of the control: ``run.py ... --control 1``."""

from __future__ import annotations

import argparse
import gc
import json
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
if str(ROOT) not in sys.path:
    sys.path.insert(0, str(ROOT))


def readings(cell, seeds, seconds: float, device, quantize: bool, control: bool):
    """One dict a seed: the judge's numbers over a ``seconds`` window."""
    import torch

    from bench_port.lib import drive, judge, system
    from bench_port.lib import traffic as traffic_mod
    from bench_port.lib.judge import Judge, token_counts
    from bench_port.lib.runner import checks, passes
    from bench_port.lib.record import Recorder

    recorder = Recorder(seeds[0]).install()
    try:
        sut = system.build(cell.config, cell.traffic, device, recorder, quantize=quantize)
        drive.warm(sut, cell.traffic, traffic_mod.requests(cell.traffic, seeds[0]))
        out = []
        for seed in seeds:
            recorder.seed = seed
            recorder.dispatches = []
            inputs = traffic_mod.requests(cell.traffic, seed)
            recorder.pick(judge.FROM_DISPATCHES, judge.ROWS)
            recorder.active = True
            window = drive.run_window(sut.backend, cell.traffic, inputs, seed, seconds)
            recorder.active = False
            dispatches = recorder.dispatches
            counts = token_counts(dispatches, cell.traffic["pins"], cell.config["nmt"]["pad_token"])
            t0 = time.perf_counter()
            numbers = {"tokens_off": counts["tokens_off"],
                       **Judge(cell.config, cell.traffic, seed, device, control).run(dispatches)}
            failed = sum(1 for r in window.requests if r.error)
            limits = cell.config["limits"]
            row = {"seed": seed, "program": "int8" if quantize else cell.config["dtype"],
                   "requests": len(window.requests), "failed": failed,
                   "judge_s": time.perf_counter() - t0, **numbers,
                   "correct": failed == 0 and passes(checks(limits, numbers))}
            if control:
                row["control_correct"] = passes(checks(limits, judge.control_numbers(numbers)))
            print(json.dumps(row), flush=True)
            out.append(row)
        sut.shutdown()
        del sut
    finally:
        recorder.uninstall()
    gc.collect()
    if torch.device(device).type == "cuda":
        torch.cuda.empty_cache()
    return out


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seconds", type=float, default=15.0)
    ap.add_argument("--seeds", default="")
    ap.add_argument("--int8-seeds", default="")
    args = ap.parse_args(argv)
    import torch

    from bench_port.lib.spec import load_cell

    if not torch.cuda.is_available():
        print("bench_port control: no CUDA device", file=sys.stderr)
        return 3
    cell = load_cell(args.workload)
    seeds = [int(s) for s in args.seeds.split(",") if s]
    if seeds:
        readings(cell, seeds, args.seconds, "cuda", quantize=False, control=True)
    int8 = [int(s) for s in args.int8_seeds.split(",") if s]
    if int8:
        readings(cell, int8, args.seconds, "cuda", quantize=True, control=False)
    return 0


if __name__ == "__main__":
    sys.exit(main())
