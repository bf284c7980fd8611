"""What binds the wgmma resblock kernel: the kernel timed in turns against
copies of itself with one part of its work cut out, and against an older
``resblock.cu``.

    python3 -m expressive_speech_translation_tpu_torch.obs.resblock_probe [--old PATH]

Builds ``csrc/resblock.cu`` as it is and in the variants of :data:`CUTS`, each
compiled from that source with a few lines inserted before an anchor (the
cut variants compute wrong results by design and are not checked). With
``--old PATH`` it also builds another ``resblock.cu`` whose C entry point
takes the tensor-core window and the weights as ``[taps, C_out, C_in]``, as
the ``mma.sync`` kernel this one replaced did (``git show 096cb98:<package>/
csrc/resblock.cu``), and holds it like the kernel against
:func:`cuda_vocoder.resblock_stage_plain`. Each build is timed with CUDA events
(mean of :data:`LAUNCHES` launches of the kernel alone, the weights laid out
beforehand) at the two stages of 10 s of speech in the main path's layout, in
turns: all builds, then all again in reverse, twice; the best turn counts.
Prints a table and writes ``chiprun_out/resblock_probe.json``. Needs a card
and nvcc.
"""

from __future__ import annotations

import argparse
import ctypes
import hashlib
import json
import math
import os
import subprocess
import sys

import torch

from expressive_speech_translation_tpu_torch.obs.perf import card_line, sync_time
from expressive_speech_translation_tpu_torch.ops import build, cuda_vocoder

STAGES = ((128, 24_000), (64, 240_000))   # (C, T) of the narrow stages of 10 s of speech
KERNELS = (3, 7, 11)
DILATIONS = ((1, 3, 5),) * 3
PEAK_BF16 = 989e12          # H100 SXM dense bf16, as in chip_smoke.py
BF16_RTOL = 1.6e-2          # max |kernel - plain| / max |plain|, as chip_smoke.py holds it
LAUNCHES = 10
OUT = os.path.join("chiprun_out", "resblock_probe.json")

# Anchors in resblock.cu, each present once: the first follows the
# definitions of ldsm_x4, bulk_copy and the barrier helpers, the second the
# wgmma instructions, the third the epilogue and window functions and precedes
# the kernel that calls them all.
AFTER_HELPERS = "// Per-thread consumer state"
AFTER_WGMMA = "template <int C>\n__device__ __forceinline__ void wgmma_c("
BEFORE_KERNEL = "template <int C, int W>\n__global__ void __launch_bounds__(WG_THREADS, 1)"
NO_COPY = ("#define mbar_expect_tx(bar, bytes) mbar_arrive(bar)  // the slot keeps stale weights\n"
           "#define bulk_copy(dst, src, bytes, bar) ((void)0)\n")
NO_LDSM = ("#define ldsm_x4(addr, d) /* A from the address, no shared-memory read */ \\\n"
           "  ((d)[0] = (d)[1] = (d)[2] = (d)[3] = (addr))\n")
NO_MMA = ("#define wgmma_n64(d, a, desc) /* one add keeps A and the descriptor live */ \\\n"
          "  ((d)[0] += __uint_as_float((a)[0] ^ (a)[1] ^ (a)[2] ^ (a)[3] ^ (unsigned)(desc)))\n"
          "#define wgmma_n128(d, a, desc) wgmma_n64(d, a, desc)\n")
NO_SYNC = "#define consumer_sync() ((void)0)  // races by design: timing only\n"
NO_RING = ("#define mbar_wait(bar, parity) ((void)0)  // no weights move: B reads stale slots\n"
           "#define mbar_arrive(bar) ((void)0)\n#define mbar_expect_tx(bar, bytes) ((void)0)\n"
           "#define bulk_copy(dst, src, bytes, bar) ((void)0)\n")
# The cut part's call: nothing, except that accumulators passed to it are
# summed into one value stored where nothing reads it, so ptxas keeps the
# products that fill them (it drops a wgmma whose sums are never read).
SKIP = ("template <int... N, typename... A>\n"
        "__device__ __forceinline__ void probe_skip(const A&...) {}\n"
        "template <int... N, int M, int K, typename... A>\n"
        "__device__ __forceinline__ void probe_skip(const WgWindow& v, const float (&acc)[M][K],\n"
        "                                           const A&...) {\n"
        "  float s = 0.f;\n"
        "  for (int m = 0; m < M; ++m)\n"
        "    for (int k = 0; k < K; ++k) s += acc[m][k];\n"
        "  if (s == 1.2345e-30f) v.h[0] = s;\n"
        "}\n")
NO_OPERAND = SKIP + "#define store_operand probe_skip\n"
NO_STATE = SKIP + "#define add_to_state probe_skip\n"
NO_LOAD = SKIP + "#define load_window probe_skip\n"
NO_SUM = SKIP + "#define branch_sum probe_skip\n"
NO_OUT = SKIP + "#define write_out probe_skip\n"
NO_IO = (SKIP + "#define load_window probe_skip\n#define branch_sum probe_skip\n"
         "#define write_out probe_skip\n")
CUTS = {
    "kernel": (),
    "no-copy": ((AFTER_HELPERS, NO_COPY),),
    "no-ring": ((AFTER_HELPERS, NO_RING),),
    "no-ldsm": ((AFTER_HELPERS, NO_LDSM),),
    "no-mma": ((AFTER_WGMMA, NO_MMA),),
    "no-sync": ((BEFORE_KERNEL, NO_SYNC),),
    "no-operand": ((BEFORE_KERNEL, NO_OPERAND),),
    "no-state": ((BEFORE_KERNEL, NO_STATE),),
    "no-load": ((BEFORE_KERNEL, NO_LOAD),),
    "no-sum": ((BEFORE_KERNEL, NO_SUM),),
    "no-out": ((BEFORE_KERNEL, NO_OUT),),
    "no-io": ((BEFORE_KERNEL, NO_IO),),
    "shell": ((AFTER_HELPERS, NO_LDSM), (AFTER_WGMMA, NO_MMA)),
}


def variant_source(source: str, cuts) -> str:
    """``source`` with each cut's code inserted before its anchor, which must
    occur exactly once."""
    for anchor, code in cuts:
        if source.count(anchor) != 1:
            raise ValueError(f"resblock.cu holds {source.count(anchor)} copies of {anchor!r}, "
                             "not one: the probe's anchors need updating")
        source = source.replace(anchor, code + anchor)
    return source


def _build_all(sources: dict) -> tuple:
    """({name: loaded library}, {name: ptxas lines}) for {name: CUDA source},
    one nvcc each, all started together, into ``_build/resblock_probe/``."""
    out_dir = build.BUILD_DIR / "resblock_probe"
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
    libs, ptxas = {}, {}
    for name, (lib, proc) in procs.items():
        log, _ = proc.communicate()
        if proc.returncode:
            raise RuntimeError(f"nvcc failed for {name}:\n{log}")
        libs[name] = ctypes.CDLL(str(lib))
        ptxas[name] = [ln.strip() for ln in log.splitlines()
                       if "registers" in ln or "spill" in ln or "Compiling entry" in ln]
    return libs, ptxas


def _tensor_core_entries(lines):
    """(kernel, "registers | spills") for each tensor-core entry in ptxas's
    report (``Compiling entry function`` names the kernel its next lines
    describe)."""
    out, entry, facts = [], None, []
    for ln in lines + ["Compiling entry function 'end'"]:
        if "Compiling entry function" in ln:
            if entry and ("wg_kernel" in entry or "mma_kernel" in entry):
                out.append((entry.split("resblock_stage_")[-1][:40], " | ".join(facts)))
            entry, facts = ln.split("'")[1], []
        else:
            facts.append(ln.replace("ptxas info    : ", ""))
    return out


def _launcher(lib, x: torch.Tensor, weights, old: bool):
    """A function that launches ``lib``'s bf16 tensor-core kernel on ``x``
    with ``weights`` laid out for it beforehand, into one output."""
    p, i, q = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong
    fn = lib.est_resblock_stage
    fn.argtypes = [p, p, p, p, p, i, i, i, q, q, q, q, q, q, i, i, p, p, p, i, i, i] + (
        [p] if old else [i, p])
    fn.restype = i
    bsz, t, c = x.shape
    pl = cuda_vocoder.plan(c, x.dtype, KERNELS, DILATIONS)
    w, b = weights
    w = w.transpose(1, 2).contiguous() if old else cuda_vocoder.wgmma_weight_image(w)
    out = torch.empty_like(x)
    scratch = torch.empty((bsz, c, t), dtype=torch.float32, device=x.device)
    n = len(KERNELS)
    ks = (ctypes.c_int * n)(*KERNELS)
    n_dil = (ctypes.c_int * n)(*[len(d) for d in DILATIONS])
    dil = (ctypes.c_int * (n * cuda_vocoder.MAX_DILATIONS))(
        *[v for d in DILATIONS for v in (list(d) + [0] * (cuda_vocoder.MAX_DILATIONS - len(d)))])
    window = 512 if old and c == 64 else pl.window
    tail = ([window] if old else [window, cuda_vocoder.stage_margin(KERNELS, DILATIONS)])
    halo = cuda_vocoder.stage_halo(KERNELS, DILATIONS)

    def launch():
        status = fn(x.data_ptr(), out.data_ptr(), scratch.data_ptr(), w.data_ptr(), b.data_ptr(),
                    bsz, t, c, *x.stride(), *out.stride(), halo,
                    n, ctypes.addressof(ks), ctypes.addressof(n_dil), ctypes.addressof(dil), 1, 0,
                    *tail, torch.cuda.current_stream().cuda_stream)
        build.check(status, "resblock probe")
        return out
    return launch


def _stage_inputs(c: int, t: int, dev):
    """x as vocode hands it over (the transposed view of [1, C, T]) and
    seeded weights of the size chip_smoke.py uses."""
    g = torch.Generator(device="cpu").manual_seed(c + t)
    x = (0.3 * torch.randn((1, c, t), generator=g)).to(dev, torch.bfloat16).transpose(1, 2)
    taps, biases = [], []
    for k, dils in zip(KERNELS, DILATIONS):
        for _ in range(2 * len(dils)):
            taps.append((torch.rand((k, c, c), generator=g) * 2 - 1) / math.sqrt(c * k))
            biases.append((torch.rand((c,), generator=g) * 2 - 1) * 0.05)
    return x, (torch.cat(taps).to(dev, torch.bfloat16).contiguous(),
               torch.stack(biases).to(dev, torch.bfloat16).contiguous())


def probe_stage(libs: dict, checked, c: int, t: int) -> dict:
    dev = torch.device("cuda")
    x, weights = _stage_inputs(c, t, dev)
    launch = {name: _launcher(lib, x, weights, name == "old") for name, lib in libs.items()}
    want = cuda_vocoder.resblock_stage_plain(x, weights, kernels=KERNELS, dilations=DILATIONS)
    peak = float(want.float().abs().max())
    errs = {}
    for name in checked:
        errs[name] = float((launch[name]().float() - want.float()).abs().max())
        if not (math.isfinite(errs[name]) and errs[name] <= BF16_RTOL * peak):
            raise AssertionError(f"resblock probe {name} C={c} T={t}: max |err| "
                                 f"{errs[name]} > {BF16_RTOL} * {peak}")
    times = {name: [] for name in libs}
    order = list(libs)
    for turn in range(4):
        for name in (order if turn % 2 == 0 else order[::-1]):
            times[name].append(sync_time(launch[name], LAUNCHES, warmup=1))
    flops = 2 * c * c * t * sum(2 * k * len(d) for k, d in zip(KERNELS, DILATIONS))
    return {"C": c, "T": t, "bound_ms": flops / PEAK_BF16 * 1e3, "ms": times,
            "best_ms": {name: min(v) for name, v in times.items()}, "max_abs_err": errs,
            "peak": peak}


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--old", metavar="PATH",
                    help="an older resblock.cu (the mma.sync kernel's C entry point), timed beside")
    ap.add_argument("--alt", metavar="PATH",
                    help="another resblock.cu with this one's C entry point, timed beside")
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        print("resblock_probe: no CUDA device", file=sys.stderr)
        return 1
    card = card_line()
    print(card, flush=True)
    source = (build.CSRC_DIR / "resblock.cu").read_text()
    sources = {name: variant_source(source, cuts) for name, cuts in CUTS.items()}
    checked = ["kernel"]
    if args.old:
        with open(args.old) as f:
            sources = {"old": f.read(), **sources}
        checked.append("old")
    if args.alt:
        with open(args.alt) as f:
            sources["alt"] = f.read()
        checked.append("alt")
    libs, ptxas = _build_all(sources)
    for name, lines in ptxas.items():
        for entry, use in _tensor_core_entries(lines):
            print(f"  {name} ptxas {entry}: {use}", flush=True)
    rows = []
    for c, t in STAGES:
        row = probe_stage(libs, checked, c, t)
        rows.append(row)
        base = row["best_ms"]["kernel"]
        cells = "  ".join(f"{name} {ms:.4f}" + ("" if name == "kernel" else
                                               f" ({100 * (ms - base) / base:+.1f} %)")
                          for name, ms in row["best_ms"].items())
        print(f"C={c} T={t} (bound {row['bound_ms']:.4f} ms, kernel at "
              f"{100 * row['bound_ms'] / base:.1f} % of it): {cells}  [{card}]", flush=True)
        print("  turns (ms): " + "  ".join(f"{k} " + ", ".join(f"{v:.4f}" for v in vs)
                                           for k, vs in row["ms"].items()), flush=True)
    os.makedirs(os.path.dirname(OUT), exist_ok=True)
    with open(OUT, "w") as f:
        json.dump({"card": card, "old": args.old, "ptxas": ptxas, "rows": rows}, f, indent=1)
    return 0


if __name__ == "__main__":
    sys.exit(main())
