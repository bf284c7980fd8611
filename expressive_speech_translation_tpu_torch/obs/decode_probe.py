"""What binds the decode kernels (``fused_ln_matvec``, ``fused_ln_mlp``): each
timed alone against copies of itself with one part of its work cut out, and
against an older ``decode.cu``.

    python3 -m expressive_speech_translation_tpu_torch.obs.decode_probe [--old PATH] [--alt PATH]

Builds ``csrc/decode.cu`` as it is and in the variants of :data:`CUTS`, each
compiled from that source with a few lines inserted before an anchor (the cut
variants compute wrong results by design and are not checked). With ``--old
PATH`` it also builds another ``decode.cu`` whose C entry points take a scratch
of f32 partials, as the kernels before the cluster redesign did (``git show
2d496af:<package>/csrc/decode.cu``), and holds it like the kernel against the
plain versions; with ``--alt PATH``, a candidate ``decode.cu`` with the current
entry points, built, checked and timed the same way. Each build is timed as
one bf16 call in a pass over a stack of distinct weights larger than the L2,
replayed as a CUDA graph, in turns (all builds, then all again in reverse;
best of the two), at each of
:data:`MATVEC_SHAPES` and :data:`MLP_SHAPES`. Prints a table and writes
``chiprun_out/decode_probe.json``. Needs a card and nvcc.
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
from expressive_speech_translation_tpu_torch.ops import build, cuda_decode

MATVEC_SHAPES = (  # (label, B, D, N, norm, eps)
    ("whisper qkv", 1, 1024, 3072, "layer", 1e-5), ("whisper qkv", 4, 1024, 3072, "layer", 1e-5),
    ("whisper qkv", 8, 1024, 3072, "layer", 1e-5), ("qwen2 qkv", 1, 896, 1152, "rms", 1e-6),
    ("qwen2 qkv", 8, 896, 1152, "rms", 1e-6),
)
MLP_SHAPES = (  # (label, B, D, F, gated, norm, eps, activation)
    ("whisper mlp", 1, 1024, 4096, False, "layer", 1e-5, "gelu"),
    ("whisper mlp", 4, 1024, 4096, False, "layer", 1e-5, "gelu"),
    ("whisper mlp", 8, 1024, 4096, False, "layer", 1e-5, "gelu"),
    ("qwen2 gated mlp", 1, 896, 4864, True, "rms", 1e-6, "silu"),
    ("qwen2 gated mlp", 8, 896, 4864, True, "rms", 1e-6, "silu"),
)
PEAK_BYTES = 3.35e12          # H100 SXM HBM3, as in chip_smoke.py
BF16_RTOL = 1.6e-2            # max |kernel - plain| / max |plain|, as chip_smoke.py holds them
STACK_MIN_LAYERS, STACK_MIN_BYTES = 24, 100e6
OUT = os.path.join("chiprun_out", "decode_probe.json")

# Anchors in decode.cu, each present once: the first follows the definitions
# of ldsm_x4(_t), mma_bf16 and griddep_wait (a macro defined there replaces
# their later uses, all in the kernels), the second follows normed_slice and
# cluster_reduce and precedes the stream kernel that calls them, the third
# precedes the host code that launches the kernels.
AFTER_HELPERS = "// ------------------------------------------------------------ stream kernel"
BEFORE_KERNEL = "// One tile of 128-byte rows over one slice of D a block;"
BEFORE_HOST = "// ---------------------------------------------------------------------- host"
NO_MMA = ("#define mma_bf16(c, a, b0, b1) /* one add of all operands keeps them live */ \\\n"
          "  ((c)[0] += __uint_as_float((a)[0] ^ (a)[1] ^ (a)[2] ^ (a)[3] ^ (b0) ^ (b1)))\n")
NO_LDSM = ("#define ldsm_x4(addr, d) ((d)[0] = (d)[1] = (d)[2] = (d)[3] = (addr))\n"
           "#define ldsm_x4_t(addr, d) ldsm_x4(addr, d)  // no shared-memory read\n")
NO_NORM = ("template <typename T, typename P>  // x^ left as the shared memory holds it\n"
           "__device__ void probe_no_norm(const StreamArgs&, int, int, int, T*, const P&) {}\n"
           "template <typename T, typename P>\n"
           "__device__ void probe_no_prefetch(const StreamArgs&, int, P&) {}\n"
           "#define normed_slice probe_no_norm\n#define norm_prefetch probe_no_prefetch\n")
NO_CLUSTER = (  # each block stores its own partials: no cluster barrier, no remote stores
    "template <typename T, int G>\n"
    "__device__ void probe_local(const StreamArgs& a, float* wpart, float*, unsigned, int,\n"
    "                            int n0) {\n"
    "  constexpr int TN = Stream<T>::TN;\n"
    "  const int cpr = TN / gridDim.x, c0 = blockIdx.x * cpr;\n"
    "  __syncthreads();\n"
    "  for (int i = threadIdx.x; i < a.nb * cpr; i += THREADS) {\n"
    "    const int n = i / cpr, col = c0 + i % cpr;\n"
    "    static_cast<T*>(a.out)[(size_t)n * a.N + n0 + col] = from_f<T>(wpart[n * TN + col]);\n"
    "  }\n"
    "}\n"
    "#define cluster_reduce probe_local\n"
    "#define cluster_arrive_relaxed() ((void)0)\n")
EMPTY = ("template <typename T, int G, int NT>  // the launch alone: same grid, cluster, smem\n"
         "__global__ void __launch_bounds__(THREADS, 2) probe_empty(\n"
         "    StreamArgs, const __grid_constant__ CUtensorMap,\n"
         "    const __grid_constant__ CUtensorMap) {}\n"
         "#define ln_stream_kernel probe_empty\n")
NO_WAIT = "#define griddep_wait() ((void)0)  // races on u by design: timing only\n"
NO_PDL = ("#define cudaLaunchAttributeProgrammaticStreamSerialization cudaLaunchAttributeIgnore"
          "  // the second MLP kernel waits for the first in stream order\n")
CUTS = {
    "kernel": (),
    "no-mma": ((AFTER_HELPERS, NO_MMA),),
    "stream": ((AFTER_HELPERS, NO_MMA + NO_LDSM),),
    "no-norm": ((BEFORE_KERNEL, NO_NORM),),
    "no-cluster": ((BEFORE_KERNEL, NO_CLUSTER),),
    "bare": ((AFTER_HELPERS, NO_MMA + NO_LDSM), (BEFORE_KERNEL, NO_NORM + NO_CLUSTER)),
    "empty": ((BEFORE_HOST, EMPTY),),
    "no-wait": ((AFTER_HELPERS, NO_WAIT),),
    "no-pdl": ((BEFORE_HOST, NO_PDL),),
}
MATVEC_CUTS = ("kernel", "no-mma", "stream", "no-norm", "no-cluster", "bare", "empty")


def variant_source(source: str, cuts) -> str:
    """``source`` with each cut's code inserted before its anchor, which must
    occur exactly once."""
    for anchor, code in cuts:
        if source.count(anchor) != 1:
            raise ValueError(f"decode.cu holds {source.count(anchor)} copies of {anchor!r}, "
                             "not one: the probe's anchors need updating")
        source = source.replace(anchor, code + anchor)
    return source


def _build_all(sources: dict) -> dict:
    """{name: loaded library} for {name: CUDA source}, one nvcc each, all
    started together, into ``_build/decode_probe/``."""
    out_dir = build.BUILD_DIR / "decode_probe"
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


def _is_old(lib) -> bool:
    """The parent's entry points take an f32 scratch of split-K partials."""
    return hasattr(lib, "est_ln_matvec_splits")


def _matvec_launcher(lib, x, sc, bi, b, n: int, norm: str, eps: float):
    """A function of one layer's weights that launches ``lib``'s ln_matvec."""
    p, i, f = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
    old = _is_old(lib)
    lib.est_ln_matvec.argtypes = [p] * (7 if old else 6) + [i, i, i, i, f, i, p]
    lib.est_ln_matvec.restype = i
    bsz, d = x.shape
    out = torch.empty((bsz, n), dtype=x.dtype, device=x.device)
    scratch = ()
    if old:
        lib.est_ln_matvec_splits.argtypes = [i, i, i]
        lib.est_ln_matvec_splits.restype = i
        splits = lib.est_ln_matvec_splits(d, n, 1)
        part = torch.empty((max(1, splits * min(bsz, 8) * n),), dtype=torch.float32,
                           device=x.device)
        scratch = (part.data_ptr(),)

    def launch(w):
        build.check(lib.est_ln_matvec(x.data_ptr(), sc.data_ptr(), bi.data_ptr(), w.data_ptr(),
                                      b.data_ptr(), out.data_ptr(), *scratch, bsz, d, n,
                                      cuda_decode.NORMS[norm], eps, 1,
                                      torch.cuda.current_stream().cuda_stream), "decode probe")
        return out
    return launch


def _mlp_launcher(lib, x, sc, bi, b1, b2, f: int, gated: bool, norm: str, eps: float, act: str):
    """A function of one layer's packed weights that launches ``lib``'s
    ln_mlp (residual on)."""
    p, i, fl = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
    lib.est_ln_mlp.argtypes = [p] * 8 + [i, i, i, i, fl, i, i, i, i, p]
    lib.est_ln_mlp.restype = i
    bsz, d = x.shape
    out = torch.empty_like(x)
    if _is_old(lib):   # f32 partials of each 32-column chunk of F
        scratch = torch.empty((f // 32 * min(bsz, 8) * d,), dtype=torch.float32, device=x.device)
    else:              # u, the hidden rows between the two kernels
        scratch = torch.empty((min(bsz, cuda_decode.MAX_NB), f), dtype=x.dtype, device=x.device)

    def launch(w):
        build.check(lib.est_ln_mlp(x.data_ptr(), sc.data_ptr(), bi.data_ptr(), w.data_ptr(),
                                   b1.data_ptr(), b2.data_ptr(), out.data_ptr(),
                                   scratch.data_ptr(), bsz, d, f, cuda_decode.NORMS[norm], eps,
                                   cuda_decode.ACTIVATIONS[act], int(gated), 1, 1,
                                   torch.cuda.current_stream().cuda_stream), "decode probe")
        return out
    return launch


def _turns(launch: dict, stack: list) -> dict:
    times = {name: [] for name in launch}
    for name in list(launch) + list(launch)[::-1]:
        times[name].append(stack_time([functools.partial(launch[name], layer)
                                       for layer in stack])[0] * 1e3)
    return times


def _check(name, got, plain, label):
    """``got`` against the plain version, computed afresh after the launch
    (so a launch that wrote outside its output shows as a changed input)."""
    want = plain()
    peak = float(want.float().abs().max())
    err = float((got.float() - want.float()).abs().max())
    if not (math.isfinite(err) and err <= BF16_RTOL * peak):
        raise AssertionError(f"decode probe {name} {label}: max |err| {err} > {BF16_RTOL} * {peak}")
    return err


def _stack(first, g, shape, scale, nbytes):
    layers = max(STACK_MIN_LAYERS, math.ceil(STACK_MIN_BYTES / nbytes))
    return [first] + [(torch.randn(shape, generator=g, device=first.device) * scale).bfloat16()
                      for _ in range(layers - 1)]


def probe_matvec(libs: dict, checked, label, bsz, d, n, norm, eps) -> dict:
    dev = torch.device("cuda")
    g = torch.Generator(device=dev).manual_seed(d + n + bsz)
    x = torch.randn((bsz, d), generator=g, device=dev).bfloat16()
    sc = 1 + 0.1 * torch.randn((d,), generator=g, device=dev)
    bi = 0.1 * torch.randn((d,), generator=g, device=dev)
    b = torch.randn((n,), generator=g, device=dev)
    stack = _stack((torch.randn((d, n), generator=g, device=dev) * d ** -0.5).bfloat16(), g,
                   (d, n), d ** -0.5, d * n * 2)
    launch = {name: _matvec_launcher(lib, x, sc, bi, b, n, norm, eps)
              for name, lib in libs.items() if name in MATVEC_CUTS or name in checked}
    errs = {name: _check(name, launch[name](stack[0]),
                         lambda: cuda_decode.fused_ln_matvec_plain(x, sc, bi, stack[0], b,
                                                                   norm=norm, eps=eps),
                         f"{label} B={bsz}")
            for name in checked}
    nbytes = d * n * 2 + bsz * (d + n) * 2 + (2 * d + n) * 4
    return _row("ln_matvec", label, bsz, nbytes, len(stack), _turns(launch, stack), errs)


def probe_mlp(libs: dict, checked, label, bsz, d, f, gated, norm, eps, act) -> dict:
    dev = torch.device("cuda")
    g = torch.Generator(device=dev).manual_seed(d + f + bsz)
    x = torch.randn((bsz, d), generator=g, device=dev).bfloat16()
    sc = 1 + 0.1 * torch.randn((d,), generator=g, device=dev)
    bi = 0.1 * torch.randn((d,), generator=g, device=dev)
    b1 = 0.05 * torch.randn((f,), generator=g, device=dev)
    b2 = 0.05 * torch.randn((d,), generator=g, device=dev)
    rows = 3 * d if gated else 2 * d
    stack = _stack((torch.randn((rows, f), generator=g, device=dev) * d ** -0.5).bfloat16(), g,
                   (rows, f), d ** -0.5, rows * f * 2)
    launch = {name: _mlp_launcher(lib, x, sc, bi, b1, b2, f, gated, norm, eps, act)
              for name, lib in libs.items()}
    errs = {name: _check(name, launch[name](stack[0]),
                         lambda: cuda_decode.fused_ln_mlp_plain(
                             x, sc, bi, stack[0], b1, b2, gated=gated, norm=norm, eps=eps,
                             activation=act, residual=True),
                         f"{label} B={bsz}")
            for name in checked}
    nbytes = rows * f * 2 + 2 * bsz * d * 2 + (f + 3 * d) * 4
    return _row("ln_mlp", label, bsz, nbytes, len(stack), _turns(launch, stack), errs)


def _row(kernel, label, bsz, nbytes, layers, times, errs) -> dict:
    return {"kernel": kernel, "shape": label, "B": bsz, "layers": layers,
            "mbytes": nbytes / 1e6, "bound_us": nbytes / PEAK_BYTES * 1e6, "us": times,
            "best_us": {name: min(t) for name, t in times.items()}, "max_abs_err": errs}


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--old", metavar="PATH",
                    help="an older decode.cu (scratch-taking entry points), built and timed beside")
    ap.add_argument("--alt", metavar="PATH", action="append", default=[],
                    help="a candidate decode.cu with the current entry points, timed beside "
                         "(repeatable: alt1, alt2, ...)")
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        print("decode_probe: no CUDA device", file=sys.stderr)
        return 1
    card = card_line()
    print(card, flush=True)
    source = (build.CSRC_DIR / "decode.cu").read_text()
    sources = {name: variant_source(source, cuts) for name, cuts in CUTS.items()}
    checked = ["kernel", "no-pdl"]
    paths = ([("old", args.old)] if args.old else []) + [
        (f"alt{i + 1}" if len(args.alt) > 1 else "alt", path) for i, path in enumerate(args.alt)]
    for name, path in paths:
        with open(path) as f:
            sources[name] = f.read()
        checked.append(name)
    libs = _build_all(sources)
    rows = [probe_matvec(libs, [c for c in checked if c != "no-pdl"], *s) for s in MATVEC_SHAPES]
    rows += [probe_mlp(libs, checked, *s) for s in MLP_SHAPES]
    for row in rows:
        base = row["best_us"]["kernel"]
        cells = "  ".join(f"{name} {us:.2f}" + ("" if name == "kernel" else
                                               f" ({100 * (us - base) / base:+.1f} %)")
                          for name, us in row["best_us"].items())
        print(f"{row['kernel']} {row['shape']} B={row['B']} ({row['mbytes']:.2f} MB, bound "
              f"{row['bound_us']:.2f} us, kernel at {100 * row['bound_us'] / base:.1f} % of it, "
              f"{1e3 * row['mbytes'] / base:.0f} GB/s): {cells}", flush=True)
    os.makedirs(os.path.dirname(OUT), exist_ok=True)
    with open(OUT, "w") as f:
        json.dump({"card": card, "old": args.old, "alt": args.alt, "rows": rows}, f, indent=1)
    return 0


if __name__ == "__main__":
    sys.exit(main())
