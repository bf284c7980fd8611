"""Drive the PyTorch port on one NVIDIA H100 and check it end to end.

    python3 chip_smoke.py

Phases, in order; any failure exits non-zero and prints no result:

1. devices  — the card's name and power limit (nvidia-smi);
2. build    — nvcc builds every kernel of the main path from csrc/, in parallel;
3. kernels  — each kernel against its plain PyTorch version at the shapes
              the main path gives it, with its time, bound, plain time and
              the time of one library call computing the same function;
4. e2e      — ``torch_engines(scale="reference")`` (Whisper-medium,
              NLLB-600M, CosyVoice2-0.5B dims, bf16, seeded random weights),
              ``CascadedBackend.initialize()`` and three ``translate_speech``
              requests, with every kernel's launch counter read around them;
5. the kernels line, the card line, and last the result line.

The long report goes to chiprun_out/chip_smoke.json.
"""

from __future__ import annotations

import json
import math
import os
import subprocess
import sys
import time

import numpy as np
import torch

from expressive_speech_translation_tpu_torch.ops import build, cuda_mel, cuda_vocoder

# NVIDIA H100 SXM data-sheet peaks (dense): FP32 on the CUDA cores, bf16 on
# the tensor cores, HBM3 bandwidth.
PEAK_FP32 = 67e12
PEAK_BF16 = 989e12
PEAK_BYTES = 3.35e12

MEL_ATOL = 1e-4          # normalised log-mel units, as tests/test_pallas_mel.py holds the JAX kernel
RES_F32_RTOL = 1e-5      # max |kernel - plain| / max |plain|: f32 sums in another order
RES_BF16_RTOL = 1.6e-2   # two bf16 ulps (2^-7 relative) of the peak, and a margin: operands and output round to bf16
KERNELS = (3, 7, 11)
DILATIONS = ((1, 3, 5),) * 3
OUT_DIR = "chiprun_out"
PORT = "expressive_speech_translation_tpu_torch"
REFERENCE = PORT.removesuffix("_torch")  # the JAX package the port replaces


def _sync_time(fn, iters: int, warmup: int = 2) -> float:
    """Mean milliseconds of ``fn()`` over ``iters`` launches (CUDA events)."""
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / iters


def card_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        check=True, capture_output=True, text=True, timeout=60).stdout.strip()
    return out.splitlines()[0]


def _speechlike(seconds: float, seed: int, sr: int = 16_000) -> np.ndarray:
    g = np.random.default_rng(seed)
    t = np.arange(int(sr * seconds)) / sr
    x = (0.4 * np.sin(2 * np.pi * 220 * t) + 0.2 * np.sin(2 * np.pi * 880 * t + 1.0)
         + 0.02 * g.standard_normal(t.shape))
    x *= 0.5 + 0.5 * np.sin(2 * np.pi * 3.0 * t) ** 2
    return x.astype(np.float32)


# ------------------------------------------------------------------ kernels


def check_log_mel(dev, report):
    """Kernel 1 at the 30 s (the default bucket) and 10 s windows, 80 mels."""
    rows = []
    for window_s, audio_s in ((30, 23.7), (10, 10.0)):
        chunk = 16_000 * window_s
        audio = torch.from_numpy(_speechlike(audio_s, seed=window_s)).to(dev)
        got = cuda_mel.whisper_log_mel_fused(audio, chunk_samples=chunk)
        want = cuda_mel.normalize_log_mel(
            cuda_mel.log_mel_frames_plain(audio, 80, chunk)).T
        torch.cuda.synchronize()
        err = float((got - want).abs().max())
        if not (got.shape == (80, chunk // 160) and math.isfinite(err) and err <= MEL_ATOL):
            raise AssertionError(f"log-mel {window_s}s: shape {tuple(got.shape)}, "
                                 f"max |err| {err} > {MEL_ATOL}")
        ms = _sync_time(lambda: cuda_mel.log_mel_frames(audio, 80, chunk), 200)
        plain_ms = _sync_time(lambda: cuda_mel.log_mel_frames_plain(audio, 80, chunk), 50)
        win = torch.hann_window(400, device=dev)
        fb = torch.as_tensor(cuda_mel._constants_np(80)[2], device=dev)
        x = audio[:chunk]

        def library():
            spec = torch.stft(x, 400, 160, window=win, center=True, pad_mode="reflect",
                              return_complex=True)
            return (spec.abs() ** 2).T @ fb

        library_ms = _sync_time(library, 200)
        frames = chunk // 160
        flops = 2 * frames * 400 * 402 + 2 * frames * 201 * 80
        nbytes = chunk * 4 + 2 * 400 * 201 * 4 + 201 * 80 * 4 + frames * 80 * 4
        bound_ms = max(flops / PEAK_FP32, nbytes / PEAK_BYTES) * 1e3
        rows.append({"window_s": window_s, "max_abs_err": err, "ms": ms,
                     "plain_ms": plain_ms, "library_ms": library_ms,
                     "bound_ms": bound_ms, "bound_share": bound_ms / ms,
                     "gflop": flops / 1e9, "mbytes": nbytes / 1e6})
        print(f"  log_mel {window_s:2d}s: err {err:.2e}  kernel {ms:.4f} ms  plain {plain_ms:.4f} ms"
              f"  stft+matmul {library_ms:.4f} ms  bound {bound_ms:.4f} ms"
              f" ({100 * bound_ms / ms:.1f}% of bound)", flush=True)
    report["log_mel"] = rows
    return rows


def _stage_weights(c: int, dtype, dev, seed: int):
    g = torch.Generator(device="cpu").manual_seed(seed)
    taps, biases = [], []
    for k, dils in zip(KERNELS, DILATIONS):
        for _ in dils:
            for _conv in range(2):
                scale = 1.0 / math.sqrt(c * k)
                taps.append((torch.rand((k, c, c), generator=g) * 2 - 1) * scale)
                biases.append((torch.rand((c,), generator=g) * 2 - 1) * 0.05)
    return (torch.cat(taps).to(dev, dtype).contiguous(),
            torch.stack(biases).to(dev, dtype).contiguous())


def check_resblock(dev, report):
    """Kernel 2 at the two narrow stages of 10 s of speech (C=128, T=24000;
    C=64, T=240000), in bf16 (serving) and f32, plus ragged lengths."""
    rows = []
    # the last shape (C % 32 != 0) runs the CUDA-core variant in bf16 too
    shapes = ((128, 24_000), (64, 240_000), (128, 24_001), (64, 240_007), (48, 20_011))
    for dtype in (torch.bfloat16, torch.float32):
        for c, t in shapes:
            g = torch.Generator(device="cpu").manual_seed(c + t)
            x = (0.3 * torch.randn((1, t, c), generator=g)).to(dev, dtype)
            w = _stage_weights(c, dtype, dev, seed=c)
            got = cuda_vocoder.fused_resblock_stage(x, w, kernels=KERNELS, dilations=DILATIONS)
            want = cuda_vocoder.resblock_stage_plain(x, w, kernels=KERNELS, dilations=DILATIONS)
            torch.cuda.synchronize()
            err = float((got.float() - want.float()).abs().max())
            peak = float(want.float().abs().max())
            tol = RES_BF16_RTOL if dtype == torch.bfloat16 else RES_F32_RTOL
            if not (got.shape == x.shape and math.isfinite(err) and err <= tol * peak):
                raise AssertionError(f"resblock C={c} T={t} {dtype}: max |err| {err} > "
                                     f"{tol} * {peak}")
            row = {"C": c, "T": t, "dtype": str(dtype).split(".")[-1],
                   "max_abs_err": err, "peak": peak}
            if t % 1000 == 0:
                row["ms"] = _sync_time(lambda: cuda_vocoder.fused_resblock_stage(
                    x, w, kernels=KERNELS, dilations=DILATIONS), 20, warmup=2)
                row["plain_ms"] = _sync_time(lambda: cuda_vocoder.resblock_stage_plain(
                    x, w, kernels=KERNELS, dilations=DILATIONS), 10, warmup=2)
                taps = sum(2 * k * len(d) for k, d in zip(KERNELS, DILATIONS))
                flops = 2 * c * c * t * taps
                es = x.element_size()
                nbytes = 2 * t * c * es + w[0].numel() * es + w[1].numel() * es
                peak_rate = PEAK_BF16 if dtype == torch.bfloat16 else PEAK_FP32
                row["bound_ms"] = max(flops / peak_rate, nbytes / PEAK_BYTES) * 1e3
                row["bound_share"] = row["bound_ms"] / row["ms"]
                row["gflop"] = flops / 1e9
                row["mbytes"] = nbytes / 1e6
            rows.append(row)
            extra = (f"  kernel {row['ms']:.3f} ms  plain {row['plain_ms']:.3f} ms  "
                     f"bound {row['bound_ms']:.4f} ms ({100 * row['bound_share']:.2f}% of bound)"
                     if "ms" in row else "")
            print(f"  resblock C={c:3d} T={t:6d} {row['dtype']:>8}: err {err:.2e} "
                  f"(peak {peak:.3f}){extra}", flush=True)
    report["resblock"] = rows
    return rows


def kernels_phase(dev, report):
    print("== kernels against their plain versions", flush=True)
    return check_log_mel(dev, report), check_resblock(dev, report)


REQUEST_SECONDS = (5.0, 10.0, 20.0)


def e2e_phase(dev, report, card):
    """Reference-scale engines, initialize(), three translate_speech requests
    (eng → fra, no voice cloning), with the kernels' launch counters read
    around the requests."""
    from expressive_speech_translation_tpu_torch.pipeline.cascaded import CascadedBackend
    from expressive_speech_translation_tpu_torch.pipeline.torch_engines import torch_engines

    print("== e2e: reference scale (Whisper-medium, NLLB-600M, CosyVoice2-0.5B), bf16, "
          "random weights", flush=True)
    t0 = time.perf_counter()
    engines = torch_engines(scale="reference")
    torch.cuda.synchronize()
    init_s = time.perf_counter() - t0
    backend = CascadedBackend(engines)
    t0 = time.perf_counter()
    backend.initialize()
    torch.cuda.synchronize()
    warm_s = time.perf_counter() - t0
    print(f"  engines {init_s:.1f} s, initialize {warm_s:.1f} s, "
          f"peak memory {torch.cuda.max_memory_allocated() / 2**30:.1f} GiB", flush=True)

    cuda_mel.log_mel_frames.launches = 0
    cuda_vocoder.fused_resblock_stage.launches = 0
    requests = []
    for seconds in REQUEST_SECONDS:
        x = _speechlike(seconds, seed=int(seconds))
        t0 = time.perf_counter()
        out = backend.translate_speech(x, "eng", "fra", use_voice_cloning=False)
        wall = time.perf_counter() - t0
        audio = out["audio"]
        if not (audio.ndim == 2 and audio.shape[0] == 1 and audio.shape[1] >= int(16_000 * seconds)
                and np.isfinite(audio).all() and np.abs(audio).max() <= 1.0):
            raise AssertionError(f"{seconds}s request: bad output {audio.shape}")
        stages = {k: v["seconds"] for k, v in out["stage_summary"].items()}
        requests.append({"audio_s": seconds, "wall_s": wall, "rtf": wall / seconds,
                         "stages_s": stages, "out_samples": int(audio.shape[1]),
                         "target_chars": len(out["transcripts"]["target"])})
        print(f"  {seconds:4.1f} s request: wall {wall:.3f} s, RTF {wall / seconds:.4f}  "
              + "  ".join(f"{k} {v:.3f} s" for k, v in stages.items()) + f"  [{card}]", flush=True)
    launches = {"log_mel_frames": cuda_mel.log_mel_frames.launches,
                "fused_resblock_stage": cuda_vocoder.fused_resblock_stage.launches}
    print(f"  kernel launches over {len(REQUEST_SECONDS)} requests: {launches}", flush=True)
    if min(launches.values()) <= 0:
        raise AssertionError(f"a kernel of the main path never launched: {launches}")
    e2e = {"engines_s": init_s, "initialize_s": warm_s, "requests": requests,
           "launches": launches,
           "peak_memory_gib": torch.cuda.max_memory_allocated() / 2**30}
    report["e2e"] = e2e
    return e2e


def _bound_by(flops, peak_rate, nbytes):
    return "operations" if flops / peak_rate >= nbytes / PEAK_BYTES else "bytes"


def kernels_line(mel_rows, res_rows, e2e):
    """One entry per kernel. Log-mel at the default 30 s window; the resblock
    stage as both narrow stages of 10 s of speech in bf16 (C=128, T=24000 and
    C=64, T=240000), their times and bounds summed."""
    mel = mel_rows[0]
    serving = [r for r in res_rows if r["dtype"] == "bfloat16" and "ms" in r]
    return [
        {"name": "log_mel_frames", "route": "cuda",
         "source": f"{PORT}/csrc/log_mel.cu",
         "replaces": f"{REFERENCE}/ops/pallas_mel.py:79",
         "launches": e2e["launches"]["log_mel_frames"],
         "max_abs_err": max(r["max_abs_err"] for r in mel_rows),
         "ms": mel["ms"], "plain_ms": mel["plain_ms"], "bound_ms": mel["bound_ms"],
         "bound_by": _bound_by(mel["gflop"] * 1e9, PEAK_FP32, mel["mbytes"] * 1e6),
         "library_ms": mel["library_ms"]},
        {"name": "fused_resblock_stage", "route": "cuda",
         "source": f"{PORT}/csrc/resblock.cu",
         "replaces": f"{REFERENCE}/ops/pallas_vocoder.py:113",
         "launches": e2e["launches"]["fused_resblock_stage"],
         "max_abs_err": max(r["max_abs_err"] for r in res_rows),
         "ms": sum(r["ms"] for r in serving), "plain_ms": sum(r["plain_ms"] for r in serving),
         "bound_ms": sum(r["bound_ms"] for r in serving),
         "bound_by": _bound_by(sum(r["gflop"] for r in serving) * 1e9, PEAK_BF16,
                               sum(r["mbytes"] for r in serving) * 1e6),
         "library_ms": None},
    ]


def build_phase(report):
    print("== build", flush=True)
    t0 = time.perf_counter()
    logs = build.build()
    seconds = time.perf_counter() - t0
    for name, info in logs.items():
        ptxas = [ln for ln in info["log"].splitlines()
                 if "registers" in ln or "spill" in ln or "smem" in ln]
        print(f"  {name}: {info['seconds']:.1f} s", flush=True)
        for ln in ptxas:
            print(f"    {ln.strip()}", flush=True)
    print(f"  build total {seconds:.1f} s", flush=True)
    report["build_seconds"] = seconds
    return seconds


def main() -> int:
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device", file=sys.stderr)
        return 1
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    dev = torch.device("cuda")
    report = {}
    print("== devices", flush=True)
    card = card_line()
    print(f"  {card}", flush=True)
    report["card"] = card
    build_phase(report)
    mel_rows, res_rows = kernels_phase(dev, report)
    e2e = e2e_phase(dev, report, card)
    os.makedirs(OUT_DIR, exist_ok=True)
    with open(os.path.join(OUT_DIR, "chip_smoke.json"), "w") as f:
        json.dump(report, f, indent=1)
    print(json.dumps({"kernels": kernels_line(mel_rows, res_rows, e2e)}))
    print(card)
    print(json.dumps({"ok": True, "device": {"platform": "gpu",
                                             "kind": torch.cuda.get_device_name(0),
                                             "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
