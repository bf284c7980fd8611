"""Where diff2lip's render takes its device memory: each conv's bytes beyond
its output, at the published width, per dtype and cuDNN setting.

    python3 -m expressive_speech_translation_tpu_torch.obs.diff2lip_memory

Runs each setting of :data:`SETTINGS` in a process of its own (cuDNN keeps
its choice of algorithm per process): the f32 tree with TF32 off (as
``chip_smoke.py`` runs it), with cuDNN's benchmark mode (the plan timed
fastest, not the heuristic's first), with TF32 on (PyTorch's default for
cuDNN), with cuDNN off (PyTorch's own im2col and cuBLAS), and the bf16 tree.
Whether this PyTorch reads ``CUDNN_CONV_WSCAP_DBG``, a cap on cuDNN's
workspace, is printed. Each setting takes ``Diff2LipConfig()`` with seeded
random weights and reports, on a batch of 8: the peak above the resident of
one ``gd_unet_apply`` and of one ``Diff2LipPipeline.sample`` (ddim25), the
time of each, and the convs whose call held the most bytes beyond the
output it returned (the workspace cuDNN's plan asked for), with their shapes.
Prints a table and writes ``chiprun_out/diff2lip_memory.json``. Needs a card.
"""

from __future__ import annotations

import argparse
import json
import os
import subprocess
import sys
import time

import torch

BATCH = 8
OUT = os.path.join("chiprun_out", "diff2lip_memory.json")
# name → (tree dtype, TF32 for cuDNN, cuDNN on, cuDNN benchmark)
SETTINGS = {
    "f32, TF32 off": ("float32", False, True, False),
    "f32, TF32 off, cuDNN benchmark": ("float32", False, True, True),
    "f32, TF32 on": ("float32", True, True, False),
    "f32, TF32 off, cuDNN off": ("float32", False, False, False),
    "bf16": ("bfloat16", False, True, False),
}
GIB = 2**30


def _peak(fn):
    """(result, GiB above the allocation before the call at its peak, ms)."""
    torch.cuda.synchronize()
    base = torch.cuda.memory_allocated()
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    out = fn()
    torch.cuda.synchronize()
    return out, (torch.cuda.max_memory_allocated() - base) / GIB, 1e3 * (time.perf_counter() - t0)


def _conv_transients(run):
    """Each ``gd_unet._conv`` call of ``run()``: the bytes its call held at
    its peak beyond the allocation before it and the output it returned."""
    from expressive_speech_translation_tpu_torch.models import gd_unet

    conv, rows = gd_unet._conv, []

    def spy(p, x, **kw):
        torch.cuda.synchronize()
        before = torch.cuda.memory_allocated()
        torch.cuda.reset_peak_memory_stats()
        out = conv(p, x, **kw)
        torch.cuda.synchronize()
        extra = torch.cuda.max_memory_allocated() - before - out.numel() * out.element_size()
        k = p["kernel"]
        rows.append({"index": len(rows), "in": list(x.shape), "out": list(out.shape),
                     "kernel": list(k.shape), "stride": kw.get("stride", 1),
                     "transient_mib": extra / 2**20})
        return out

    gd_unet._conv = spy
    try:
        run()
    finally:
        gd_unet._conv = conv
    return rows


def _setting(name: str) -> dict:
    from expressive_speech_translation_tpu_torch.models import gd_unet
    from expressive_speech_translation_tpu_torch.models.common import cast_floats
    from expressive_speech_translation_tpu_torch.pipeline import diff2lip as d2l

    dtype, tf32, cudnn_on, benchmark = SETTINGS[name]
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = tf32
    torch.backends.cudnn.enabled = cudnn_on
    torch.backends.cudnn.benchmark = benchmark
    dev = torch.device("cuda")
    cfg = d2l.Diff2LipConfig()
    params = cast_floats(d2l.init_diff2lip_unet(11, cfg, dev), getattr(torch, dtype))
    pipe = d2l.Diff2LipPipeline(cfg, params, device=dev)
    g = torch.Generator(device=dev).manual_seed(3)
    s = cfg.image_size
    crops = torch.rand((BATCH, 3, s, s), generator=g, device=dev) * 2 - 1
    ref = crops.flip(0)
    mel = torch.randn((BATCH, cfg.mel_window, cfg.n_mels), generator=g, device=dev)
    t = torch.full((BATCH,), 500, device=dev)

    def unet():
        with torch.inference_mode():
            return gd_unet.gd_unet_apply(params, cfg.unet, crops, t, cond_img=crops,
                                         mask=pipe.mask, ref_img=ref, mel=mel)

    row = {"setting": name, "dtype": dtype, "cudnn_allow_tf32": tf32, "cudnn": cudnn_on,
           "cudnn_benchmark": benchmark, "resident_gib": torch.cuda.memory_allocated() / GIB}
    _, row["unet_first_gib"], row["unet_first_ms"] = _peak(unet)
    _, row["unet_gib"], row["unet_ms"] = _peak(unet)
    convs = _conv_transients(unet)
    row["convs"] = len(convs)
    row["top_convs"] = sorted(convs, key=lambda r: -r["transient_mib"])[:6]
    row["conv_transient_over_256mib"] = sum(r["transient_mib"] > 256 for r in convs)
    _, row["sample_gib"], row["sample_ms"] = _peak(
        lambda: pipe.sample(crops, ref, mel, generator=torch.Generator(device=dev).manual_seed(0)))
    row["sample_steps"] = pipe.diffusion.num_timesteps
    return row


def _reads_wscap() -> bool:
    """Whether this PyTorch's CUDA library names CUDNN_CONV_WSCAP_DBG."""
    lib = os.path.join(os.path.dirname(torch.__file__), "lib", "libtorch_cuda.so")
    if not os.path.exists(lib):
        return False
    with open(lib, "rb") as f:
        return b"CUDNN_CONV_WSCAP_DBG" in f.read()


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--setting", choices=list(SETTINGS), help="run one setting in this process")
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        print("diff2lip_memory: no CUDA device", file=sys.stderr)
        return 1
    if args.setting:
        print(json.dumps(_setting(args.setting)), flush=True)
        return 0

    from expressive_speech_translation_tpu_torch.obs.perf import card_line

    card = card_line()
    report = {"card": card, "torch": torch.__version__, "cuda": torch.version.cuda,
              "cudnn": torch.backends.cudnn.version(), "torch_names_wscap": _reads_wscap(),
              "rows": []}
    print(f"{card}; torch {torch.__version__}, CUDA {torch.version.cuda}, cuDNN "
          f"{report['cudnn']}; libtorch_cuda names CUDNN_CONV_WSCAP_DBG: "
          f"{report['torch_names_wscap']}", flush=True)
    for name in SETTINGS:
        proc = subprocess.run([sys.executable, "-m", __spec__.name, "--setting", name],
                              capture_output=True, text=True, timeout=600)
        if proc.returncode != 0:
            print(proc.stdout[-4000:], proc.stderr[-4000:], sep="\n", file=sys.stderr)
            return proc.returncode
        row = json.loads(proc.stdout.strip().splitlines()[-1])
        report["rows"].append(row)
        line = (f"{name}: one UNet call on {BATCH} crops peaks {row['unet_gib']:.3f} GiB above "
                f"the resident (first call {row['unet_first_gib']:.3f}) in {row['unet_ms']:.1f} "
                f"ms; {row['conv_transient_over_256mib']} of {row['convs']} convs hold over "
                f"256 MiB beyond their output; one sample ({row['sample_steps']} steps) peaks "
                f"{row['sample_gib']:.3f} GiB in {row['sample_ms']:.0f} ms")
        print(line, flush=True)
        for c in row["top_convs"]:
            print(f"    conv {c['index']}: in {c['in']} kernel {c['kernel']} stride "
                  f"{c['stride']} -> out {c['out']}: {c['transient_mib']:.1f} MiB beyond "
                  "its output", flush=True)
    os.makedirs(os.path.dirname(OUT), exist_ok=True)
    with open(OUT, "w") as f:
        json.dump(report, f, indent=1)
    print(f"wrote {OUT}  [{card}]", flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
