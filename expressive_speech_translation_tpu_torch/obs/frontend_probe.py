"""Where ``AudioProcessor.process_audio`` spends its time on the card, and
where its difference from the CPU comes from, for ``chip_smoke.py``'s 44.1 kHz
stereo uploads at 10 s and at the 300 s cap:

- each step alone, on the host clock around a synchronised card, best of
  three after one warm-up: the host downmix, the Kaiser resample of the
  bucket-padded upload (copy in, conv, copy out), the validity check, the
  noise gate (copy in, STFT gate, copy out);
- the resample three ways against a float64 conv of the same f32 inputs and
  kernels on the CPU: ``F.conv1d`` as the port runs it (cuDNN picks the
  algorithm), ``F.conv1d`` with cuDNN off, and the same polyphase product as
  one matmul over ``unfold``-ed blocks; and the CPU's own ``F.conv1d``;
- the gate on the card against the gate on the CPU, on the same resampled
  input;
- ``chip_smoke.py``'s own 10 s upload, card against CPU, in this process;
- ``torch.profiler`` over one 300 s call: device time by kernel.

    python3 -m expressive_speech_translation_tpu_torch.obs.frontend_probe

Run from the repository root (it imports ``chip_smoke`` for the uploads).
Writes ``frontend_probe.json`` into ``chip_smoke.py``'s output directory. Needs
a card.
"""

from __future__ import annotations

import json
import os
import sys
import time

import numpy as np
import torch
import torch.nn.functional as F

import chip_smoke
from expressive_speech_translation_tpu_torch.obs.perf import card_line
from expressive_speech_translation_tpu_torch.ops import dsp
from expressive_speech_translation_tpu_torch.ops.resample import _kernels, _resample_plan, resample
from expressive_speech_translation_tpu_torch.pipeline.audio_processor import AudioProcessor

SR_IN, SR_OUT = chip_smoke.FRONTEND_UPLOAD_SR, 16_000


def _best(fn, reps: int = 3) -> tuple:
    """(best seconds of ``reps`` after one warm-up, the last result)."""
    out = fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(reps):
        t0 = time.perf_counter()
        out = fn()
        torch.cuda.synchronize()
        times.append(time.perf_counter() - t0)
    return min(times), out


def _resample_variants(padded: np.ndarray, cfg, dev) -> dict:
    """The resample's conv three ways on the card and once on the CPU, each
    against float64: seconds (device work and copies) and max |diff|."""
    key = (SR_IN, SR_OUT, cfg.resample_lowpass_filter_width, cfg.resample_rolloff,
           cfg.resample_kaiser_beta)
    _, width, orig_g, new_g = _resample_plan(*key)
    t_in = len(padded)
    blocks = -(-t_in // orig_g)
    xb_cpu = F.pad(torch.from_numpy(padded).reshape(1, 1, t_in), (width, width + orig_g))
    k_cpu = _kernels(key, torch.device("cpu"))
    want = F.conv1d(xb_cpu.double(), k_cpu.double(), stride=orig_g)[..., :blocks]

    def conv(xb, k):
        return F.conv1d(xb, k, stride=orig_g)[..., :blocks]

    def unfold(xb, k):
        frames = xb[0, 0].unfold(0, k.shape[-1], orig_g)[:blocks]     # [blocks, K]
        return (frames @ k[:, 0, :].T).T[None]                           # [1, new_g, blocks]

    rows = {}
    k_dev = _kernels(key, dev)
    for name, fn, on_card in (("conv1d_cudnn", conv, True), ("conv1d_native", conv, True),
                              ("unfold_matmul", unfold, True), ("conv1d_cpu", conv, False)):
        def run():
            xb = xb_cpu.to(dev) if on_card else xb_cpu
            return fn(xb, k_dev if on_card else k_cpu).cpu()
        torch.backends.cudnn.enabled = name != "conv1d_native"
        try:
            seconds, got = _best(run)
        finally:
            torch.backends.cudnn.enabled = True
        err = float((got.double() - want).abs().max())
        rows[name] = {"seconds": seconds, "max_abs_err_vs_f64": err}
    rows["peak_abs"] = float(want.abs().max())
    rows["gflop"] = 2 * blocks * new_g * k_cpu.shape[-1] / 1e9
    return rows


def probe(seconds: float, dev, card) -> dict:
    proc, cpu = AudioProcessor(device=dev), AudioProcessor(device="cpu")
    cfg = proc.config
    x = chip_smoke._stereo_upload(seconds, SR_IN, 33)
    row = {"audio_s": seconds}

    def downmix():
        l, r = x[0], x[1]
        corr = float(np.sum(l * r) / max(np.sqrt(np.sum(l * l) * np.sum(r * r)), 1e-8))
        mid = 0.5 * (l + r)
        return mid if corr > 0.5 else mid + 0.25 * np.abs(l - r) * np.sign(mid)

    row["downmix_s"], mono = _best(downmix)
    padded = np.zeros(proc._bucket(len(mono), SR_IN), np.float32)
    padded[:len(mono)] = mono
    n16 = -(-len(mono) * SR_OUT // SR_IN)
    row["resample"] = _resample_variants(padded, cfg, dev)
    row["resample_s"], y16 = _best(lambda: resample(
        torch.from_numpy(padded).to(dev), SR_IN, SR_OUT,
        lowpass_filter_width=cfg.resample_lowpass_filter_width, rolloff=cfg.resample_rolloff,
        beta=cfg.resample_kaiser_beta)[:n16].cpu().numpy())
    row["valid_s"], _ = _best(lambda: proc.is_valid_audio(y16))
    gpad = np.zeros(proc._bucket(n16, SR_OUT), np.float32)
    gpad[:n16] = y16
    hop = cfg.denoise_hop

    def gate(device):
        g = dsp.spectral_noise_gate(torch.from_numpy(gpad).to(device), sr=SR_OUT,
                                    n_fft=cfg.denoise_n_fft, hop=hop, speech_boost=1.2,
                                    valid_frames=1 + n16 // hop)
        return g[:n16].cpu().numpy()

    row["gate_s"], g_card = _best(lambda: gate(dev))
    g_cpu = gate(torch.device("cpu"))
    row["gate_max_abs_diff_vs_cpu"] = float(np.abs(g_card - g_cpu).max())
    row["process_audio_s"], _ = _best(lambda: proc.process_audio(x, SR_IN))
    full_card = proc.process_audio(x, SR_IN)
    row["process_audio_max_abs_diff_vs_cpu"] = float(
        np.abs(full_card - cpu.process_audio(x, SR_IN)).max())
    rs = row["resample"]
    print(f"  {seconds:.0f} s at 44.1 kHz stereo: process_audio {row['process_audio_s'] * 1e3:.1f} ms"
          f" (against the CPU {row['process_audio_max_abs_diff_vs_cpu']:.3e}); downmix "
          f"{row['downmix_s'] * 1e3:.1f} ms, resample {row['resample_s'] * 1e3:.1f} ms, validity "
          f"{row['valid_s'] * 1e3:.1f} ms, gate {row['gate_s'] * 1e3:.1f} ms (against the CPU "
          f"{row['gate_max_abs_diff_vs_cpu']:.3e})  [{card}]", flush=True)
    for name in ("conv1d_cudnn", "conv1d_native", "unfold_matmul", "conv1d_cpu"):
        print(f"    resample {name}: {rs[name]['seconds'] * 1e3:.2f} ms with copies, max |diff| "
              f"from float64 {rs[name]['max_abs_err_vs_f64']:.3e} (peak {rs['peak_abs']:.3f}, "
              f"{rs['gflop']:.2f} GFLOP)", flush=True)
    return row


def upload_agreement(dev, card) -> dict:
    """``chip_smoke.py``'s 44.1 kHz stereo upload (seed 31, PCM16 through
    wavio) in this fresh process: ``process_audio`` on the card against the
    CPU, without and with the gate."""
    import tempfile

    from expressive_speech_translation_tpu_torch.media.wavio import read_wav, write_wav

    with tempfile.TemporaryDirectory() as tmp:
        path = os.path.join(tmp, "upload.wav")
        write_wav(path, chip_smoke._stereo_upload(chip_smoke.FRONTEND_SECONDS, SR_IN, 31), SR_IN)
        x, sr = read_wav(path)
    proc, cpu = AudioProcessor(device=dev), AudioProcessor(device="cpu")
    row = {f"denoise_{d}": float(np.abs(proc.process_audio(x, sr, denoise=d)
                                        - cpu.process_audio(x, sr, denoise=d)).max())
           for d in (False, True)}
    print(f"  chip_smoke's 44.1 kHz upload, card against CPU: resample alone "
          f"{row['denoise_False']:.3e}, with the gate {row['denoise_True']:.3e}  [{card}]",
          flush=True)
    return row


def profile(dev) -> list:
    """Device time by kernel over one 300 s process_audio (after a warm-up)."""
    from torch.profiler import ProfilerActivity, profile as tprofile

    proc = AudioProcessor(device=dev)
    x = chip_smoke._stereo_upload(chip_smoke.FRONTEND_CAP_SECONDS, SR_IN, 33)
    proc.process_audio(x, SR_IN)
    torch.cuda.synchronize()
    with tprofile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        proc.process_audio(x, SR_IN)
        torch.cuda.synchronize()
    rows = []
    for e in prof.key_averages():
        dev_us = getattr(e, "self_device_time_total", getattr(e, "self_cuda_time_total", 0))
        if dev_us > 0:
            rows.append({"name": e.key[:90], "device_ms": dev_us / 1e3, "count": e.count})
    rows.sort(key=lambda r: -r["device_ms"])
    total = sum(r["device_ms"] for r in rows)
    print(f"  profiler, one 300 s call: device time {total:.2f} ms in {len(rows)} kernels", flush=True)
    for r in rows[:10]:
        print(f"    {r['device_ms']:8.3f} ms  x{r['count']:<3d} {r['name']}", flush=True)
    return rows


def main() -> int:
    if not torch.cuda.is_available():
        print("frontend_probe: no CUDA device", file=sys.stderr)
        return 1
    dev = torch.device("cuda")
    card = card_line()
    print(card, flush=True)
    out = {"card": card, "rows": [probe(s, dev, card) for s in
                                  (chip_smoke.FRONTEND_SECONDS, chip_smoke.FRONTEND_CAP_SECONDS)],
           "upload": upload_agreement(dev, card), "profile_300s": profile(dev)}
    os.makedirs(chip_smoke.OUT_DIR, exist_ok=True)
    with open(os.path.join(chip_smoke.OUT_DIR, "frontend_probe.json"), "w") as f:
        json.dump(out, f, indent=1)
    return 0


if __name__ == "__main__":
    sys.exit(main())
