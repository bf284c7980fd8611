"""Run one cell of ``BENCHMARK.json`` on this machine's card(s) and print
its result as the last line of standard output:

    python3 bench_port/run.py --workload native.c16-10s --seed 7 --seconds 51 --trace 0

``--trace 0`` reports the cell's end-to-end metrics, ``--trace 1`` its
per-layer metrics (a slice of the window under ``torch.profiler``). Every
run judges what the window served against the plain reference
(``correct``) and prints each compared number beside its limit, last on
standard error and last in the result; with ``--control 1`` the control's
readings stand in the program's place (it has to come out not correct).
Exits non-zero, printing no result, without enough CUDA devices or when JAX
or the JAX package got loaded."""

from __future__ import annotations

import time

T_START = time.perf_counter()

import argparse  # noqa: E402
import json  # noqa: E402
import os  # noqa: E402
import sys  # noqa: E402
from pathlib import Path  # noqa: E402

ROOT = Path(__file__).resolve().parents[1]
CACHE = ROOT / "bench_port" / "_cache"


def _environment() -> None:
    """Caches at fixed paths inside the checkout; no library loads JAX."""
    os.environ.setdefault("USE_FLAX", "0")
    os.environ.setdefault("USE_JAX", "0")
    os.environ["TRITON_CACHE_DIR"] = str(CACHE / "triton")
    os.environ["TORCH_EXTENSIONS_DIR"] = str(CACHE / "torch_extensions")
    if str(ROOT) not in sys.path:
        sys.path.insert(0, str(ROOT))


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    ap.add_argument("--control", type=int, choices=(0, 1), default=0,
                    help="judge the control (the reference in fp8) in the program's place")
    args = ap.parse_args(argv)
    _environment()
    import torch

    from bench_port.lib.runner import forbidden_modules, run
    from bench_port.lib.spec import load_cell

    try:
        cell = load_cell(args.workload)
    except (KeyError, FileNotFoundError, StopIteration) as e:
        print(f"bench_port: {e}", file=sys.stderr)
        return 2
    if not torch.cuda.is_available() or torch.cuda.device_count() < cell.chips:
        have = torch.cuda.device_count() if torch.cuda.is_available() else 0
        print(f"bench_port: {args.workload} needs {cell.chips} CUDA device(s), found {have}",
              file=sys.stderr)
        return 3
    result = run(cell, args.seed, args.seconds, bool(args.trace), T_START,
                 control=bool(args.control))
    found = forbidden_modules()
    if found:
        print(f"bench_port: loaded after the window: {', '.join(found)}", file=sys.stderr)
        return 4
    for name, c in result["checks"].items():
        print(f"{name} {c['value']} limit {c['limit']}", file=sys.stderr)
    print(json.dumps(result), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
