"""What binds the bf16 ``matmul_int4`` kernel: the kernel timed against
copies of itself, each with one part of its work cut out.

    python3 -m expressive_speech_translation_tpu_torch.obs.int4_probe [--old PATH]

Builds ``csrc/int4.cu`` as it is and in the variants of :data:`CUTS`, each
compiled from that source with a few lines inserted before an anchor (the
cut variants compute wrong results by design and are not checked). With
``--old PATH`` it also builds another ``int4.cu`` with the same C entry point,
such as an earlier version of the kernel taken from git history, and holds it
like the kernel against :func:`cuda_int4.matmul_int4_plain`. Each build is
timed as one bf16 call in a pass over a stack of distinct weights larger than
the L2, replayed as a CUDA graph, in turns (all builds, then all again in
reverse; best of the two), at each of :data:`SHAPES`. Prints a table and
writes ``chiprun_out/int4_probe.json``. Needs a card and nvcc.
"""

from __future__ import annotations

import argparse
import ctypes
import functools
import hashlib
import json
import math
import os
import subprocess
import sys

import torch

from expressive_speech_translation_tpu_torch.obs.perf import card_line, stack_time
from expressive_speech_translation_tpu_torch.ops import build, cuda_int4

SHAPES = ((8, 2048, 8192), (1, 1024, 4096), (16, 2048, 8192), (8, 8192, 8192))  # (B, K, N)
PEAK_BYTES = 3.35e12          # H100 SXM HBM3, as in chip_smoke.py
BF16_RTOL = 1.6e-2            # max |kernel - plain| / max |plain|, as chip_smoke.py holds int4
STACK_MIN_LAYERS, STACK_MIN_BYTES = 24, 100e6
OUT = os.path.join("chiprun_out", "int4_probe.json")

# Anchors in int4.cu: the first follows the definitions of mma_bf16 and
# dequant2 (a function-like macro defined there replaces their later uses,
# which are all in int4_mma_kernel), the second precedes the host code that
# launches the bf16 kernel and its finishing kernel.
AFTER_HELPERS = "__host__ __device__ constexpr size_t mma_ring_bytes"
BEFORE_LAUNCH = "template <int NT>\nint mma_group"
NO_DEQUANT = "#define dequant2(v) (v)  // the mma takes the packed bytes as they are\n"
NO_MMA = ("#define mma_bf16(c, a, b0, b1) /* one add of all operands keeps them live */ \\\n"
          "  ((c)[0] += __uint_as_float((a)[0] ^ (a)[1] ^ (a)[2] ^ (a)[3] ^ (b0) ^ (b1)))\n")
NO_FINISH = ("template <typename T> int skip_finish(const Args&, int, cudaStream_t) { return 0; }\n"
             "#define finish skip_finish  // the split-K partials are never added\n")
CUTS = {
    "kernel": (),
    "no-dequant": ((AFTER_HELPERS, NO_DEQUANT),),
    "no-mma": ((AFTER_HELPERS, NO_MMA),),
    "stream": ((AFTER_HELPERS, NO_DEQUANT + NO_MMA),),
    "no-finish": ((BEFORE_LAUNCH, NO_FINISH),),
    "stream, no-finish": ((AFTER_HELPERS, NO_DEQUANT + NO_MMA), (BEFORE_LAUNCH, NO_FINISH)),
}


def variant_source(source: str, cuts) -> str:
    """``source`` with each cut's code inserted before its anchor, which must
    occur exactly once."""
    for anchor, code in cuts:
        if source.count(anchor) != 1:
            raise ValueError(f"int4.cu holds {source.count(anchor)} copies of {anchor!r}, "
                             "not one: the probe's anchors need updating")
        source = source.replace(anchor, code + anchor)
    return source


def _build_all(sources: dict) -> dict:
    """{name: loaded library} for {name: CUDA source}, one nvcc each, all
    started together, into ``_build/int4_probe/``."""
    out_dir = build.BUILD_DIR / "int4_probe"
    out_dir.mkdir(parents=True, exist_ok=True)
    nvcc = build.nvcc_path()
    procs = {}
    for name, text in sources.items():
        tag = hashlib.sha256(text.encode()).hexdigest()[:16]
        src, lib = out_dir / f"{tag}.cu", out_dir / f"lib{tag}.so"
        src.write_text(text)
        procs[name] = lib, subprocess.Popen([nvcc, *build.NVCC_FLAGS, "-o", str(lib), str(src)],
                                            stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
                                            text=True)
    libs = {}
    for name, (lib, proc) in procs.items():
        log, _ = proc.communicate()
        if proc.returncode:
            raise RuntimeError(f"nvcc failed for {name}:\n{log}")
        libs[name] = ctypes.CDLL(str(lib))
    return libs


def _scratch_floats(lib, bsz: int, k: int, n: int) -> int:
    """f32 scratch of a bf16 call: the entry point that reports it, or that of
    the first version (slices x min(B, 8) rows x N)."""
    i = ctypes.c_int
    if hasattr(lib, "est_int4_scratch_floats"):
        lib.est_int4_scratch_floats.argtypes = [i, i, i, i]
        lib.est_int4_scratch_floats.restype = ctypes.c_longlong
        return lib.est_int4_scratch_floats(bsz, k, n, 1)
    lib.est_int4_splits.argtypes = [i, i]
    lib.est_int4_splits.restype = i
    splits = lib.est_int4_splits(k, n)
    return splits * min(bsz, 8) * n if splits > 1 else 0


def _launcher(lib, x: torch.Tensor, n: int):
    """A function of one layer (packed, scale) that launches ``lib``'s bf16
    kernel on it into one output (returned) and one scratch."""
    p, i = ctypes.c_void_p, ctypes.c_int
    lib.est_matmul_int4.argtypes = [p, p, p, p, p, i, i, i, i, p]
    lib.est_matmul_int4.restype = i
    bsz, k = x.shape
    out = torch.empty((bsz, n), dtype=x.dtype, device=x.device)
    part = torch.empty((max(1, _scratch_floats(lib, bsz, k, n)),), dtype=torch.float32,
                       device=x.device)

    def launch(layer):
        packed, scale = layer
        build.check(lib.est_matmul_int4(x.data_ptr(), packed.data_ptr(), scale.data_ptr(),
                                        out.data_ptr(), part.data_ptr(), bsz, k, n, 1,
                                        torch.cuda.current_stream().cuda_stream), "int4 probe")
        return out
    return launch


def probe_shape(libs: dict, checked, bsz: int, k: int, n: int) -> dict:
    dev = torch.device("cuda")
    g = torch.Generator(device=dev).manual_seed(k + n + bsz)
    x = torch.randn((bsz, k), generator=g, device=dev).bfloat16()
    layers = max(STACK_MIN_LAYERS, math.ceil(STACK_MIN_BYTES / (k * n // 2)))
    stack = []
    for _ in range(layers):
        packed, scale = cuda_int4.pack_int4(torch.randn((k, n), generator=g, device=dev))
        stack.append((packed, scale.reshape(-1).float().contiguous()))
    launch = {name: _launcher(lib, x, n) for name, lib in libs.items()}
    want = cuda_int4.matmul_int4_plain(x, *stack[0])
    peak = float(want.float().abs().max())
    errs = {}
    for name in checked:
        errs[name] = float((launch[name](stack[0]).float() - want.float()).abs().max())
        if not (math.isfinite(errs[name]) and errs[name] <= BF16_RTOL * peak):
            raise AssertionError(f"int4 probe {name} B={bsz} K={k} N={n}: max |err| "
                                 f"{errs[name]} > {BF16_RTOL} * {peak}")
    times = {name: [] for name in libs}
    for name in list(libs) + list(libs)[::-1]:
        times[name].append(stack_time([functools.partial(launch[name], layer)
                                       for layer in stack])[0] * 1e3)
    nbytes = k * n // 2 + bsz * (k + n) * 2 + n * 4
    return {"B": bsz, "K": k, "N": n, "layers": layers, "mbytes": nbytes / 1e6,
            "bound_us": nbytes / PEAK_BYTES * 1e6, "us": times,
            "best_us": {name: min(t) for name, t in times.items()}, "max_abs_err": errs,
            "peak": peak}


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--old", metavar="PATH",
                    help="another int4.cu with the same C entry point, built and timed beside")
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        print("int4_probe: no CUDA device", file=sys.stderr)
        return 1
    card = card_line()
    print(card, flush=True)
    source = (build.CSRC_DIR / "int4.cu").read_text()
    sources = {name: variant_source(source, cuts) for name, cuts in CUTS.items()}
    checked = ["kernel"]
    if args.old:
        with open(args.old) as f:
            sources["old"] = f.read()
        checked.append("old")
    libs = _build_all(sources)
    rows = []
    for bsz, k, n in SHAPES:
        row = probe_shape(libs, checked, bsz, k, n)
        rows.append(row)
        base = row["best_us"]["kernel"]
        cells = "  ".join(f"{name} {us:.2f}" + ("" if name == "kernel" else
                                               f" ({100 * (us - base) / base:+.1f} %)")
                          for name, us in row["best_us"].items())
        print(f"B={bsz} K={k} N={n} ({row['mbytes']:.1f} MB, bound {row['bound_us']:.2f} us, "
              f"kernel at {100 * row['bound_us'] / base:.1f} % of it, "
              f"{1e3 * row['mbytes'] / base:.0f} GB/s): {cells}", flush=True)
    os.makedirs(os.path.dirname(OUT), exist_ok=True)
    with open(OUT, "w") as f:
        json.dump({"card": card, "old": args.old, "rows": rows}, f, indent=1)
    return 0


if __name__ == "__main__":
    sys.exit(main())
