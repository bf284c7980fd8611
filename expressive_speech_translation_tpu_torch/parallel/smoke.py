"""The four-card check of meshes and stage-parallel serving.

    python3 -m expressive_speech_translation_tpu_torch.parallel.smoke

Run from the repository's root on a host with four cards. It builds the
kernels from ``csrc/`` and prints, each under its own heading:

1. peer access between every pair of cards;
2. each of the five kernels launched on cards 1-3 against its plain version
   (the tolerances of ``chip_smoke.py``);
3. stage placement at reference width (Whisper-medium, NLLB-600M,
   CosyVoice2-0.5B, bf16, seeded random weights): ``torch_engines(
   stage_meshes=...)`` over the four cards from the trees of one-card
   engines on card 0, each stage's cards and the bytes of its trees on each
   card; a 10 s request against the one-card engines (transcripts equal,
   audio within AUDIO_ATOL); 3 concurrent requests through the micro-batchers on the placed
   engines, and on the ``stage_parallel`` layout (one card a stage), beside
   the same on one card, in turns, with the batches each stage formed and
   each request's stage seconds; then the TTS's dispatch of those three
   requests on each, timed in turns, its audio against one card's, and
   traced (``torch.profiler``) on one card and on the dp=2 TTS groups;
4. the TTS speech LM at tp 2 and 4 in f32: speech tokens against the
   unsharded LM with the same noise, each card's weight bytes, ms a token;
5. ``vocode_sp`` of 60 s of mel over the four cards against ``vocode`` on
   one, in f32;
6. one SFT step of the published speech LM data-parallel over the four
   cards (dp=4) against the one-card step from the same state, in f32 at 8
   rows; then steps at the published batch in bf16, timed in turns;
7. two processes of two cards each (NCCL, bootstrapped through
   ``MeshConfig``) running one dp=2 × tp=2 SFT step of a small LM against
   the one-card step, and an all-reduce; then four processes of one card
   each stepping the published batch, timed.

Then the launch counts, the card line, and last one JSON line with
``"ok"``. ``--train-only`` runs phases 6-7 alone. ``--rehearse`` runs the same on four CPU slots at toy widths
(gloo; no kernels, no nvidia-smi) to try the control flow without a card.
"""

from __future__ import annotations

import argparse
import json
import os
import socket
import subprocess
import sys
import threading
import time
from typing import Any, Dict, List

import numpy as np
import torch

from ..models import cosyvoice as cvm
from ..models import qwen2 as q2
from ..models.common import Init, cast_floats, tree_to
from ..ops import cuda_decode, cuda_int4, cuda_mel, cuda_vocoder
from ..pipeline.cascaded import CascadedBackend
from ..pipeline.engines import Engines
from ..pipeline.torch_engines import STAGE_MAX_DP, TorchCosyVoiceTts, torch_engines
from ..serve.batching import BatchedAsr, BatchedNmt, BatchedTts
from ..train import sft
from .mesh import MeshSpec, Slot, global_slots, make_mesh, maybe_initialize_distributed
from .partition import Shards, tree_paths
from .stages import placement_report, stage_meshes

# chip_smoke.py's tolerances: max |kernel - plain| / max |plain|
MEL_ATOL = 1e-4
BF16_RTOL = 1.6e-2
LOSS_RTOL = 1e-4          # an f32 loss summed over shares in another order
SP_ATOL = 1e-4            # vocode_sp against vocode in f32, |wave| ≤ 1
AUDIO_ATOL = 1e-3         # a bf16 request on other cards: the same kernels, |audio| ≤ 1
REQUEST_SECONDS = 10.0


def _sync(devices) -> None:
    for d in devices:
        if d.type == "cuda":
            torch.cuda.synchronize(d)


def _speechlike(seconds: float, seed: int) -> np.ndarray:
    """A voiced-like 16 kHz signal: a wandering pitch with harmonics and noise."""
    g = np.random.default_rng(seed)
    n = int(16_000 * seconds)
    t = np.arange(n) / 16_000
    f0 = 140 + 30 * np.sin(2 * np.pi * 0.7 * t)
    phase = 2 * np.pi * np.cumsum(f0) / 16_000
    x = sum(np.sin(k * phase) / k for k in range(1, 6)) * (0.5 + 0.5 * np.sin(2 * np.pi * 3 * t))
    return (0.2 * x + 0.01 * g.standard_normal(n)).astype(np.float32)


def engines_like(engines: Engines, **kwargs) -> Engines:
    """``torch_engines`` over the trees of ``engines``: their configs,
    weights, conditioning models and NLLB language ids, with the ASR's
    temperature ladder, the decode budgets and the engines' ``weightless``
    flags (random trees stay random), so the same model serves from another
    placement.
    ``kwargs`` (a mesh, stage meshes, a device: by default the ASR's) go to
    the factory."""
    asr, nmt, tts = (getattr(e, "engine", e) for e in (engines.asr, engines.nmt, engines.tts))
    out = torch_engines(asr_cfg=asr.cfg, asr_params=asr.params, nmt_cfg=nmt.cfg,
                        nmt_params=nmt.params, lang_code_to_id=nmt.lang_code_to_id,
                        tts_cfg=tts.cfg, tts_params=tts.params, dtype=tts.dtype,
                        tts_ecapa=(tts._ecapa, tts._ecapa_cfg),
                        tts_speech_tokenizer=(tts._st, tts._st_cfg),
                        asr_context_buckets=asr.context_buckets,
                        **{"device": asr.device, **kwargs})
    out.asr.temperatures = asr.temperatures
    out.asr.max_new_tokens, out.nmt.max_new_tokens = asr.max_new_tokens, nmt.max_new_tokens
    for src, dst in ((asr, out.asr), (nmt, out.nmt), (tts, out.tts)):
        dst.weightless = src.weightless        # the same trees: random stays random
    out.tts.conditioning_weightless = tts.conditioning_weightless
    return out


def tree_bytes_by_device(tree) -> Dict[str, int]:
    """Bytes of a placed tree's tensors on each device (a Shards by part)."""
    out: Dict[str, int] = {}
    for _, leaf in tree_paths(tree):
        for t in (leaf.parts if isinstance(leaf, Shards) else [leaf]):
            if torch.is_tensor(t):
                out[str(t.device)] = out.get(str(t.device), 0) + t.numel() * t.element_size()
    return out


def _rel(got: torch.Tensor, want: torch.Tensor) -> float:
    return float((got.float() - want.float()).abs().max() / want.float().abs().max())


# ------------------------------------------------------------ kernels per card


def check_kernels_on(dev: torch.device, vocoder) -> Dict[str, float]:
    """Each kernel once on ``dev`` against its plain version: log-mel of a
    30 s window, the resblock at a vocoder stage's C = 128 and 64 (bf16, so
    the wgmma variant), the decode kernels at Whisper-medium's qkv and
    Qwen2's gated MLP widths (bf16), int4 at B = 8, K = 2048, N = 8192 (bf16).
    → each kernel's relative error (log-mel: absolute, normalised units)."""
    g = torch.Generator(device=dev).manual_seed(10 + dev.index)
    out = {}
    audio = 0.1 * torch.randn(480_000, generator=g, device=dev)
    got = cuda_mel.normalize_log_mel(cuda_mel.log_mel_frames(audio, 80, 480_000))
    want = cuda_mel.normalize_log_mel(cuda_mel.log_mel_frames_plain(audio, 80, 480_000))
    out["log_mel_frames"] = float((got - want).abs().max())
    errs = []
    for stage, t in ((1, 24_000), (2, 24_000)):
        w = cuda_vocoder.stage_weights_flat(vocoder["res"][stage], (3, 7, 11), ((1, 3, 5),) * 3)
        c = w[1].shape[-1]
        x = (0.3 * torch.randn((1, c, t), generator=g, device=dev)).to(torch.bfloat16)
        kw = dict(kernels=(3, 7, 11), dilations=((1, 3, 5),) * 3)
        errs.append(_rel(cuda_vocoder.fused_resblock_stage(x.transpose(1, 2), w, **kw),
                         cuda_vocoder.resblock_stage_plain(x.transpose(1, 2), w, **kw)))
    out["fused_resblock_stage"] = max(errs)
    bf = torch.bfloat16

    def rnd(shape, scale=1.0, dtype=bf):
        return (scale * torch.randn(shape, generator=g, device=dev)).to(dtype)

    x, sc, bi = rnd((1, 1024)), 1 + rnd((1024,), 0.1, torch.float32), rnd((1024,), 0.1,
                                                                            torch.float32)
    w, b = rnd((1024, 3072), 1024 ** -0.5), rnd((3072,), 0.05, torch.float32)
    out["fused_ln_matvec"] = _rel(cuda_decode.fused_ln_matvec(x, sc, bi, w, b),
                                  cuda_decode.fused_ln_matvec_plain(x, sc, bi, w, b))
    x, sc = rnd((1, 896)), 1 + rnd((896,), 0.1, torch.float32)
    wp, b1, b2 = rnd((3 * 896, 4864), 896 ** -0.5), rnd((4864,), 0.05, torch.float32), rnd(
        (896,), 0.05, torch.float32)
    kw = dict(gated=True, norm="rms", eps=1e-6, activation="silu", residual=True)
    out["fused_ln_mlp"] = _rel(cuda_decode.fused_ln_mlp(x, sc, sc, wp, b1, b2, **kw),
                               cuda_decode.fused_ln_mlp_plain(x, sc, sc, wp, b1, b2, **kw))
    x = rnd((8, 2048))
    p, s = cuda_int4.pack_int4(rnd((2048, 8192), 1.0, torch.float32))
    out["matmul_int4"] = _rel(cuda_int4.matmul_int4(x, p, s), cuda_int4.matmul_int4_plain(x, p, s))
    torch.cuda.synchronize(dev)
    return out


def kernels_phase(devices, vocoder) -> Dict[str, Any]:
    counters = {"log_mel_frames": cuda_mel.log_mel_frames,
                "fused_resblock_stage": cuda_vocoder.fused_resblock_stage,
                "fused_ln_matvec": cuda_decode.fused_ln_matvec,
                "fused_ln_mlp": cuda_decode.fused_ln_mlp, "matmul_int4": cuda_int4.matmul_int4}
    print("== kernels on cards 1-3 against their plain versions", flush=True)
    out = {}
    for dev in devices[1:]:
        before = {k: f.launches for k, f in counters.items()}
        errs = check_kernels_on(dev, tree_to(vocoder, dev))
        launched = {k: f.launches - before[k] for k, f in counters.items()}
        print(f"  {dev}: errors {errs}; launches {launched}", flush=True)
        bad = [k for k, e in errs.items()
               if not np.isfinite(e) or e > (MEL_ATOL if k == "log_mel_frames" else BF16_RTOL)]
        if bad or min(launched.values()) < 1:
            raise AssertionError(f"kernels on {dev}: {bad} {errs} {launched}")
        out[str(dev)] = {"max_err": errs, "launches": launched}
    return out


# ----------------------------------------------------------- stage placement


def _concurrent(backend, x, n: int) -> tuple:
    """``n`` requests started together from ``n`` threads → (wall seconds,
    each request's stage seconds)."""
    errors, stages, barrier = [], [], threading.Barrier(n)

    def run():
        barrier.wait()
        try:
            out = backend.translate_speech(x, "eng", "fra")
            stages.append({k: round(v["seconds"], 3) for k, v in out["stage_summary"].items()})
        except Exception as e:  # noqa: BLE001
            errors.append(e)

    threads = [threading.Thread(target=run) for _ in range(n)]
    t0 = time.perf_counter()
    for t in threads:
        t.start()
    for t in threads:
        t.join()
    if errors:
        raise errors[0]
    return time.perf_counter() - t0, stages


def _batched(engines: Engines) -> Engines:
    return Engines(asr=BatchedAsr(engines.asr), nmt=BatchedNmt(engines.nmt),
                   tts=BatchedTts(engines.tts))


def stage_phase(one: Engines, slots: List[Slot], seconds: float) -> Dict[str, Any]:
    devices = [s.device for s in slots]
    print("== stage placement: the one-card engines' trees over the four cards", flush=True)
    before = {str(d): torch.cuda.memory_allocated(d) for d in devices if d.type == "cuda"}
    meshes = stage_meshes(devices=slots)
    placed = engines_like(one, stage_meshes=meshes)
    _sync(devices)
    grown = {str(d): torch.cuda.memory_allocated(d) - before[str(d)]
             for d in devices if d.type == "cuda"}
    by_stage = {stage: tree_bytes_by_device([g.params for g in e.groups])
                for stage, e in (("asr", placed.asr), ("nmt", placed.nmt), ("tts", placed.tts))}
    info = placed.placement_info()
    print(f"  {placement_report(meshes)}", flush=True)
    print(f"  placement_info {info}; tree bytes by stage and card {by_stage}; "
          f"allocated bytes added by card {grown}", flush=True)
    if info != {"asr": [0], "nmt": [1], "tts": [2, 3]}:
        raise AssertionError(f"stage placement {info}")
    x = _speechlike(seconds, seed=10)
    outs, walls = {}, {}
    for name, engines in (("one card", one), ("placed", placed)):
        engines.tts._call_count = 0
        t0 = time.perf_counter()
        outs[name] = CascadedBackend(engines).translate_speech(x, "eng", "fra")
        walls[name] = time.perf_counter() - t0
    a, b = outs["one card"], outs["placed"]
    same_text = a["transcripts"] == b["transcripts"]
    diff = float(np.abs(a["audio"] - b["audio"]).max()) if a["audio"].shape == b["audio"].shape \
        else float("inf")
    print(f"  {seconds:.0f} s request: one card {walls['one card']:.3f} s, placed "
          f"{walls['placed']:.3f} s; transcripts equal {same_text}; audio samples "
          f"{a['audio'].shape[1]} / {b['audio'].shape[1]}, max |diff| {diff:.3g}", flush=True)
    if not same_text or diff > AUDIO_ATOL:
        raise AssertionError(f"the placed request differs from one card's: {diff}")
    # in turns, as the walls spread between runs; the factory's
    # stage_parallel layout as well (one group a stage: the TTS on one card
    # of its own, the fourth card idle), apart from the JAX layout's dp=2 TTS
    default = engines_like(one, stage_meshes=stage_meshes(devices=slots, max_dp=STAGE_MAX_DP))
    print(f"  stage_parallel layout (max_dp={STAGE_MAX_DP}): {default.placement_info()}",
          flush=True)
    wrapped = {"one card": _batched(one), "placed": _batched(placed),
               "placed, tts dp=1": _batched(default)}
    concurrent = {name: [] for name in wrapped}
    try:
        for name in list(wrapped) + list(wrapped)[::-1]:
            stages = wrapped[name]
            before = {k: getattr(stages, k).stats["batches"] for k in ("asr", "nmt", "tts")}
            wall, split = _concurrent(CascadedBackend(stages), x, 3)
            formed = {k: getattr(stages, k).stats["batches"] - before[k]
                      for k in ("asr", "nmt", "tts")}
            concurrent[name].append({"wall_s": wall, "batches": formed, "stages_s": split})
            print(f"  3 concurrent {seconds:.0f} s requests behind the micro-batchers, {name}: "
                  f"{wall:.3f} s; batches formed {formed}; stage seconds {split}", flush=True)
    finally:
        for stages in wrapped.values():
            for stage in (stages.asr, stages.nmt, stages.tts):
                stage.shutdown()
    return {"placement": info, "report": placement_report(meshes), "tree_bytes": by_stage,
            "allocated_added": grown, "request_s": walls, "max_audio_diff": diff,
            "concurrent3_s": concurrent}, placed, default


# ------------------------------------------------------- a TTS dispatch traced

TTS_TEXT = "Le temps est beau aujourd'hui, et la gare est tout près d'ici."


def _trace_summary(prof, wall_s: float, path: str) -> Dict[str, Any]:
    """From a torch.profiler run: each card's kernel time and its share of
    the wall, kernels and peer copies a card, the host's launch calls, and
    the ops with the most host time (the whole table goes to ``path``)."""
    busy: Dict[str, float] = {}
    kernels: Dict[str, int] = {}
    peer = launches = 0
    launch_us = 0.0
    for e in prof.events():
        us = e.time_range.elapsed_us()
        if e.device_type == torch.autograd.DeviceType.CUDA:
            card = f"cuda:{e.device_index}"
            busy[card] = busy.get(card, 0.0) + us
            kernels[card] = kernels.get(card, 0) + 1
            peer += "PtoP" in e.name
        elif e.name in ("cudaLaunchKernel", "cudaLaunchKernelExC", "cuLaunchKernel"):
            launches += 1
            launch_us += us
    table = prof.key_averages().table(sort_by="self_cpu_time_total", row_limit=40)
    with open(path, "w") as f:
        f.write(table)
    top = sorted(prof.key_averages(), key=lambda a: a.self_cpu_time_total, reverse=True)[:6]
    return {"wall_s": wall_s,
            "device_busy_s": {k: v / 1e6 for k, v in sorted(busy.items())},
            "device_busy_share": {k: v / 1e6 / wall_s for k, v in sorted(busy.items())},
            "kernels": dict(sorted(kernels.items())), "peer_copies": peer,
            "launch_calls": launches, "launch_call_s": launch_us / 1e6,
            "top_host_ops_s": {a.key: a.self_cpu_time_total / 1e6 for a in top}}


def tts_dispatch_phase(configs: Dict[str, Engines], x: np.ndarray) -> Dict[str, Any]:
    """One batched TTS dispatch of three requests (four padded rows) on
    each configuration's TTS, in turns, twice; its audio against one
    card's (gated where the rows are the same); then one traced dispatch on one card and on the JAX layout's
    dp=2 groups (``torch.profiler``)."""
    print("== the TTS stage's dispatch of 3 requests: timed in turns, then traced", flush=True)
    reqs = [{"text": TTS_TEXT, "reference_audio_16k": x, "style_prompt": "", "language": "fr"}
            for _ in range(3)]
    ttss = {name: getattr(e.tts, "engine", e.tts) for name, e in configs.items()}
    devices = sorted({g.device for t in ttss.values() for g in t.groups}, key=str)

    def run(tts):
        tts._call_count = 0
        _sync(devices)
        t0 = time.perf_counter()
        audio = tts.synthesize_batch(reqs)
        _sync(devices)
        return time.perf_counter() - t0, audio

    walls = {name: [] for name in ttss}
    audio = {}
    for name in list(ttss) + list(ttss)[::-1]:
        wall, audio[name] = run(ttss[name])
        walls[name].append(wall)
    ref = audio["one card"]
    diffs = {name: max(float(np.abs(a - b).max()) if a.shape == b.shape else float("inf")
                       for a, b in zip(out, ref)) for name, out in audio.items()}
    print(f"  walls {walls}; max |audio - one card's| {diffs}", flush=True)
    # the same rows on another card must agree; the dp=2 groups run two
    # rows each, whose bf16 products may round otherwise (reported only)
    if diffs["placed, tts dp=1"] > AUDIO_ATOL:
        raise AssertionError(f"the TTS on its own card differs from one card's: {diffs}")
    traces = {}
    if devices[0].type == "cuda":
        from torch.profiler import ProfilerActivity, profile

        os.makedirs("chiprun_out", exist_ok=True)
        for name in ("one card", "placed"):
            with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
                wall, _ = run(ttss[name])
            slug = name.replace(" ", "_").replace(",", "")
            traces[name] = _trace_summary(prof, wall, os.path.join(
                "chiprun_out", f"tts_trace_{slug}.txt"))
            print(f"  traced, {name}: {traces[name]}", flush=True)
    return {"walls_s": walls, "max_audio_diff": diffs, "traces": traces}


# --------------------------------------------------------- tensor parallelism


def tp_phase(one: Engines, slots: List[Slot], tokens: int) -> Dict[str, Any]:
    """The one-card TTS's speech LM in f32, unsharded on the first card and
    at tp 2 and 4 over the first cards: speech tokens with the same noise
    and prompt, each card's weight bytes, ms a token."""
    print("== tensor parallelism: the speech LM in f32 at tp 1, 2 and 4", flush=True)
    tts = getattr(one.tts, "engine", one.tts)
    params = cast_floats(tts.params, torch.float32)
    text = torch.tensor([[ord(c) % tts.cfg.lm.text_vocab
                          for c in "Le temps est beau aujourd'hui, et la gare est proche."]],
                        dtype=torch.int32)
    out, ref = {}, None
    for tp in (1, 2, 4):
        mesh = make_mesh(MeshSpec(dp=1, tp=tp), devices=slots[:tp])
        eng = TorchCosyVoiceTts(tts.cfg, params, mesh=mesh, dtype=torch.float32,
                                ecapa_weights=(tts._ecapa, tts._ecapa_cfg),
                                speech_tokenizer_weights=(tts._st, tts._st_cfg))
        lead = eng.device
        t_ids = text.to(lead)
        psp = torch.zeros((1, 2), dtype=torch.int32, device=lead)
        _sync([s.device for s in slots])
        t0 = time.perf_counter()
        toks, lengths = cvm.generate_speech_tokens(
            eng.params["lm"], eng.cfg.lm, cvm.GeneratorNoise(5, lead), t_ids,
            torch.ones_like(t_ids, dtype=torch.bool), psp, torch.ones_like(psp, dtype=torch.bool),
            max_new_tokens=tokens)
        _sync([s.device for s in slots])
        wall = time.perf_counter() - t0
        toks = toks.cpu()
        n = int(lengths[0])
        if ref is None:
            ref = toks
        match = int((toks == ref).int().cumprod(dim=1).sum())
        weights = tree_bytes_by_device(eng.params["lm"])
        head = eng.params["lm"]["head"]["kernel"]
        out[tp] = {"tokens": n, "prefix_equal": match, "equal": bool(torch.equal(toks, ref)),
                   "ms_per_token": wall * 1e3 / max(n, 1), "weight_bytes": weights,
                   "head_split": isinstance(head, Shards)}
        print(f"  tp={tp}: {n} tokens, {match} of {toks.shape[1]} equal to tp=1's "
              f"(all {out[tp]['equal']}), {out[tp]['ms_per_token']:.2f} ms a token, head split "
              f"{out[tp]['head_split']}, weight bytes by card {weights}", flush=True)
        del eng
    return out


# ------------------------------------------------------- sequence parallelism


def sp_phase(one: Engines, slots: List[Slot], seconds: float) -> Dict[str, Any]:
    print(f"== vocode_sp: {seconds:.0f} s of mel over {len(slots)} cards against one, f32",
          flush=True)
    tts = getattr(one.tts, "engine", one.tts)
    cfg = tts.cfg.vocoder
    params = cast_floats(tts.params["vocoder"], torch.float32)
    lead = slots[0].device
    g = torch.Generator(device=lead).manual_seed(60)
    mel = torch.randn((1, int(seconds * 50), cfg.n_mels), generator=g, device=lead)
    mesh = make_mesh(MeshSpec(dp=len(slots), tp=1), devices=slots)
    runs = {"vocode": [], "vocode_sp": []}
    for _ in range(2):
        for name, fn in (("vocode", lambda: cvm.vocode(params, cfg, mel)),
                         ("vocode_sp", lambda: cvm.vocode_sp(params, cfg, mel, mesh, "dp"))):
            _sync([s.device for s in slots])
            t0 = time.perf_counter()
            wave = fn()
            _sync([s.device for s in slots])
            runs[name].append(time.perf_counter() - t0)
            if name == "vocode":
                want = wave
            else:
                got = wave
    diff = float((got - want).abs().max())
    print(f"  samples {got.shape[1]}; vocode {runs['vocode']} s, vocode_sp {runs['vocode_sp']} s;"
          f" halo {cvm.vocoder_halo_frames(cfg)} frames; max |diff| {diff:.3g}", flush=True)
    if got.shape != want.shape or diff > SP_ATOL:
        raise AssertionError(f"vocode_sp differs: {diff}")
    return {"seconds_of_mel": seconds, "vocode_s": runs["vocode"],
            "vocode_sp_s": runs["vocode_sp"], "max_abs_diff": diff,
            "halo_frames": cvm.vocoder_halo_frames(cfg)}


# ------------------------------------------------------------- data parallel


def _lm_batch(cfg: cvm.SpeechLMConfig, rows: int, seed: int, accum: int = 1) -> sft.SFTBatch:
    """[accum, rows, ...] of random text and speech, rows with ragged speech."""
    g = np.random.default_rng(seed)
    tt, ts = 16, 48
    smask = np.arange(ts)[None, None, :] < g.integers(ts // 3, ts + 1, (accum, rows, 1))
    return sft.SFTBatch(g.integers(1, cfg.text_vocab, (accum, rows, tt)).astype(np.int32),
                        np.ones((accum, rows, tt), bool),
                        np.where(smask, g.integers(0, cfg.speech_token_size, (accum, rows, ts)),
                                 0).astype(np.int32), smask)


def _state(cfg: cvm.SpeechLMConfig, device, opt) -> sft.TrainState:
    """A seeded state drawn on the CPU and moved, so every device and
    process starts from the same parameters."""
    params = tree_to(cvm.init_speech_lm(Init(0, "cpu"), cfg), device)
    return sft.init_train_state(0, cfg, opt, params=params)


def dp_phase(slots: List[Slot], cfg: cvm.SpeechLMConfig, rows: int) -> Dict[str, Any]:
    print(f"== data parallel: one SFT step of the speech LM (hidden {cfg.backbone.hidden}, "
          f"{cfg.backbone.layers} layers), f32, {rows} rows, dp={len(slots)} against one card",
          flush=True)
    batch = _lm_batch(cfg, rows, seed=3)
    mesh = make_mesh(MeshSpec(dp=len(slots), tp=1), devices=slots)
    out = {}
    for name, m in (("one card", None), (f"dp={len(slots)}", mesh)):
        opt = sft.make_optimizer(1e-5)
        state = _state(cfg, slots[0].device, opt)
        step = sft.make_train_step(cfg, opt, m, accum_grad=1, compute_dtype=torch.float32)
        _sync([s.device for s in slots])
        t0 = time.perf_counter()
        state, metrics = step(state, batch)
        _sync([s.device for s in slots])
        out[name] = {"step_s": time.perf_counter() - t0,
                     **{k: float(v) for k, v in metrics.items()}}
        del state, step
    one, dp = out["one card"], out[f"dp={len(slots)}"]
    rel = abs(dp["loss"] - one["loss"]) / abs(one["loss"])
    print(f"  loss one card {one['loss']:.6f}, dp {dp['loss']:.6f} (rel {rel:.2e}); grad_norm "
          f"{one['grad_norm']:.6f} / {dp['grad_norm']:.6f}; step {one['step_s']:.3f} s / "
          f"{dp['step_s']:.3f} s", flush=True)
    if rel > LOSS_RTOL:
        raise AssertionError(f"dp loss {dp['loss']} against {one['loss']}")
    return {**out, "loss_rel": rel, "published": published_dp(slots, cfg, mesh)}


def _published_batch(cfg: cvm.SpeechLMConfig, dp: int, seed: int) -> sft.SFTBatch:
    """A step's batch at the published dynamic batching (``TrainConfig``:
    at most 2000 padded speech tokens a microbatch, 4 microbatches), rows
    rounded to a multiple of ``dp``, from random utterances of 60-150
    speech tokens (2.4-6 s) and 10-40 text tokens."""
    from ..core.config import TrainConfig
    from ..train.executor import batches_from_samples

    g = np.random.default_rng(seed)
    samples = []
    for i in range(400):
        ns = int(g.integers(60, 151))
        samples.append({"utt_id": f"u{i}", "num_frames": ns,
                        "text_tokens": g.integers(4, cfg.text_vocab,
                                                  int(g.integers(10, 41))).tolist(),
                        "speech_tokens": g.integers(0, cfg.speech_token_size, ns).tolist()})
    tc = TrainConfig()
    return next(iter(batches_from_samples(iter(samples), tc, accum=tc.accum_grad, seed=seed,
                                          rows_multiple=dp)))


def published_dp(slots: List[Slot], cfg: cvm.SpeechLMConfig, mesh) -> Dict[str, Any]:
    """Steps at the published batch and precision (bf16 compute, f32
    parameters): one card against dp over ``mesh``, each from the same
    seeded state, one warm-up step each, then two steps each in turns,
    twice."""
    batch = _published_batch(cfg, mesh.shape["dp"], seed=5)
    shape = tuple(batch.speech_tokens.shape)
    print(f"  published batch: [accum, rows, speech] {shape}, text {batch.text_tokens.shape[2]}, "
          f"{int(batch.speech_mask.sum())} speech tokens; bf16", flush=True)
    runs = {}
    for name, m in (("one card", None), (f"dp={mesh.shape['dp']}", mesh)):
        opt = sft.make_optimizer(1e-5)
        state = _state(cfg, slots[0].device, opt)
        step = sft.make_train_step(cfg, opt, m, accum_grad=batch.text_tokens.shape[0])
        state, metrics = step(state, batch)
        runs[name] = {"step": step, "state": state, "first_loss": float(metrics["loss"]),
                      "step_s": []}
    for name in list(runs) + list(runs)[::-1]:
        r = runs[name]
        for _ in range(2):
            _sync([s.device for s in slots])
            t0 = time.perf_counter()
            r["state"], _ = r["step"](r["state"], batch)
            _sync([s.device for s in slots])
            r["step_s"].append(time.perf_counter() - t0)
    out = {"shape": shape, **{name: {"first_loss": r["first_loss"], "step_s": r["step_s"]}
                              for name, r in runs.items()}}
    print(f"  published steps: {out}", flush=True)
    if slots[0].device.type == "cuda":
        from torch.profiler import ProfilerActivity, profile

        for name, r in runs.items():
            with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
                t0 = time.perf_counter()
                r["state"], _ = r["step"](r["state"], batch)
                _sync([s.device for s in slots])
                wall = time.perf_counter() - t0
            slug = name.replace(" ", "_").replace("=", "")
            out[name]["trace"] = _trace_summary(prof, wall, os.path.join(
                "chiprun_out", f"step_trace_{slug}.txt"))
            print(f"  traced step, {name}: {out[name]['trace']}", flush=True)
    return out


SMALL_LM = cvm.SpeechLMConfig(
    backbone=q2.Qwen2Config(hidden=64, layers=2, heads=4, kv_heads=2, ffn_dim=128,
                            max_positions=256),
    text_vocab=97, speech_token_size=61)


def _free_port() -> int:
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def processes_phase(rehearse: bool) -> Dict[str, Any]:
    """Two processes, two devices each, joined through MeshConfig: each runs
    the dp=2 × tp=2 step of SMALL_LM on the global batch, against this
    process's one-device step."""
    print("== two processes x two devices (MeshConfig bootstrap), dp=2 x tp=2 SFT step",
          flush=True)
    batch = _lm_batch(SMALL_LM, 4, seed=4, accum=2)
    opt = sft.make_optimizer(1e-4)
    dev = torch.device("cpu") if rehearse else torch.device("cuda", 0)
    _, want = sft.make_train_step(SMALL_LM, opt, accum_grad=2, compute_dtype=torch.float32)(
        _state(SMALL_LM, dev, opt), batch)
    want = {k: float(v) for k, v in want.items()}
    port = _free_port()
    procs = []
    for rank in (0, 1):
        env = {k: v for k, v in os.environ.items()
               if not k.startswith(("EST_MESH__", "MASTER_", "WORLD_SIZE", "RANK"))}
        env.update({"EST_MESH__COORDINATOR": f"127.0.0.1:{port}", "EST_MESH__NUM_PROCESSES": "2",
                    "EST_MESH__PROCESS_ID": str(rank)})
        if not rehearse:
            env["CUDA_VISIBLE_DEVICES"] = f"{2 * rank},{2 * rank + 1}"
        procs.append(subprocess.Popen(
            [sys.executable, "-m", "expressive_speech_translation_tpu_torch.parallel.smoke",
             "--worker"] + (["--rehearse"] if rehearse else []),
            stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True, env=env))
    outs = []
    try:
        for p in procs:
            stdout, stderr = p.communicate(timeout=300)
            if p.returncode != 0:
                raise AssertionError(f"worker failed ({p.returncode}): {stderr[-3000:]}")
            outs.append(json.loads(stdout.strip().splitlines()[-1]))
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
    rel = abs(outs[0]["loss"] - want["loss"]) / abs(want["loss"])
    print(f"  ranks {[o['rank'] for o in outs]} backend {outs[0]['backend']}, mesh "
          f"{outs[0]['mesh']}; losses {[o['loss'] for o in outs]} against one device "
          f"{want['loss']:.6f} (rel {rel:.2e}); all_reduce {[o['all_reduce'] for o in outs]}",
          flush=True)
    if outs[0]["loss"] != outs[1]["loss"] or rel > LOSS_RTOL or any(
            o["all_reduce"] != 2.0 for o in outs):
        raise AssertionError(f"two-process step: {outs} against {want}")
    return {"ranks": outs, "one_device": want, "loss_rel": rel}


def published_processes(rehearse: bool, one_card: Dict[str, Any]) -> Dict[str, Any]:
    """Four processes of one device each (``MeshConfig``; a dp=4 mesh, one
    slot a process, as ``train.run --device cuda:N`` in each of four
    processes), each stepping the published batch as in
    :func:`published_dp`, against ``one_card``'s figures."""
    print("== four processes x one device, the published batch (bf16)", flush=True)
    port, procs = _free_port(), []
    for rank in range(4):
        env = {k: v for k, v in os.environ.items()
               if not k.startswith(("EST_MESH__", "MASTER_", "WORLD_SIZE", "RANK"))}
        env.update({"EST_MESH__COORDINATOR": f"127.0.0.1:{port}", "EST_MESH__NUM_PROCESSES": "4",
                    "EST_MESH__PROCESS_ID": str(rank)})
        if not rehearse:
            env["CUDA_VISIBLE_DEVICES"] = str(rank)
        procs.append(subprocess.Popen(
            [sys.executable, "-m", "expressive_speech_translation_tpu_torch.parallel.smoke",
             "--worker", "--published"] + (["--rehearse"] if rehearse else []),
            stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True, env=env))
    outs = []
    try:
        for p in procs:
            stdout, stderr = p.communicate(timeout=300)
            if p.returncode != 0:
                raise AssertionError(f"worker failed ({p.returncode}): {stderr[-3000:]}")
            outs.append(json.loads(stdout.strip().splitlines()[-1]))
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
    rel = abs(outs[0]["first_loss"] - one_card["first_loss"]) / abs(one_card["first_loss"])
    out = {"first_loss": [o["first_loss"] for o in outs], "loss_rel": rel,
           "step_s": outs[0]["step_s"], "one_card_step_s": one_card["step_s"]}
    print(f"  {out}", flush=True)
    if len(set(out["first_loss"])) != 1:
        raise AssertionError(f"four-process losses differ: {out}")
    return out


def worker(rehearse: bool, published: bool = False) -> int:
    """One rank of :func:`processes_phase` or, with ``published``, of
    :func:`published_processes`."""
    from ..core.config import load_config

    maybe_initialize_distributed(load_config().mesh)
    dist = torch.distributed
    if published:
        cfg = SMALL_LM if rehearse else cvm.SpeechLMConfig()
        mesh = make_mesh(devices=global_slots(["cpu"] if rehearse else None))
        batch = _published_batch(cfg, mesh.shape["dp"], seed=5)
        opt = sft.make_optimizer(1e-5)
        step = sft.make_train_step(cfg, opt, mesh, accum_grad=batch.text_tokens.shape[0])
        lead = mesh.lead(mesh.local_groups()[0])
        state, metrics = step(_state(cfg, lead, opt), batch)
        times = []
        for _ in range(4):
            _sync([lead])
            t0 = time.perf_counter()
            state, _ = step(state, batch)
            _sync([lead])
            times.append(time.perf_counter() - t0)
        print(json.dumps({"rank": dist.get_rank(), "first_loss": float(metrics["loss"]),
                          "step_s": times}), flush=True)
        dist.destroy_process_group()
        return 0
    local = ["cpu", "cpu"] if rehearse else None
    mesh = make_mesh(MeshSpec(dp=2, tp=2), devices=global_slots(local))
    lead = mesh.lead(mesh.local_groups()[0])
    opt = sft.make_optimizer(1e-4)
    step = sft.make_train_step(SMALL_LM, opt, mesh, accum_grad=2, compute_dtype=torch.float32)
    _, metrics = step(_state(SMALL_LM, lead, opt), _lm_batch(SMALL_LM, 4, seed=4, accum=2))
    one = torch.ones(1, device=lead)
    dist.all_reduce(one)
    print(json.dumps({"rank": dist.get_rank(), "backend": dist.get_backend(),
                      "mesh": repr(mesh), "loss": float(metrics["loss"]),
                      "all_reduce": float(one[0])}), flush=True)
    dist.destroy_process_group()
    return 0


# ---------------------------------------------------------------------- main


def main(argv=None) -> int:
    parser = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    parser.add_argument("--rehearse", action="store_true",
                        help="four CPU slots at toy widths, gloo, no kernels")
    parser.add_argument("--train-only", action="store_true",
                        help="only the data-parallel and two-process training phases (6-7); "
                             "no kernel is built")
    parser.add_argument("--worker", action="store_true", help=argparse.SUPPRESS)
    parser.add_argument("--published", action="store_true", help=argparse.SUPPRESS)
    args = parser.parse_args(argv)
    if args.worker:
        return worker(args.rehearse, args.published)
    t_start = time.perf_counter()
    if args.rehearse:
        slots = [Slot(i, torch.device("cpu")) for i in range(4)]
        card = "cpu rehearsal"
    else:
        if not torch.cuda.is_available() or torch.cuda.device_count() < 4:
            print("parallel.smoke: needs four CUDA devices", file=sys.stderr)
            return 1
        from ..obs.perf import card_line
        from ..ops import build

        torch.backends.cuda.matmul.allow_tf32 = False
        torch.backends.cudnn.allow_tf32 = False
        card = card_line()
        slots = global_slots()[:4]
        print(f"== devices\n  {card}; {torch.cuda.device_count()} cards", flush=True)
        if not args.train_only:
            t0 = time.perf_counter()
            build.build()
            print(f"== build {time.perf_counter() - t0:.1f} s", flush=True)
    devices = [s.device for s in slots]
    report: Dict[str, Any] = {"card": card}
    if not args.rehearse:
        peers = [[i == j or torch.cuda.can_device_access_peer(i, j) for j in range(4)]
                 for i in range(4)]
        print(f"== peer access\n  {peers}", flush=True)
        report["peer_access"] = peers

    lm_cfg, rows = (SMALL_LM, 8) if args.rehearse else (cvm.SpeechLMConfig(), 8)
    if not args.train_only:
        print("== one-card engines on card 0" + (" (toy, f32)" if args.rehearse else
                                                  " (reference width, bf16)"), flush=True)
        t0 = time.perf_counter()
        if args.rehearse:
            one = torch_engines(device=devices[0], dtype=torch.float32)
            one.asr.max_new_tokens = one.nmt.max_new_tokens = 8
            tokens, seconds = 24, 2.0
        else:
            from ..models import ecapa
            from ..models import speech_tokenizer as stm

            ecfg, scfg = ecapa.EcapaConfig(), stm.SpeechTokenizerConfig()
            st = stm.init_speech_tokenizer(4, scfg, devices[0])
            one = torch_engines(scale="reference", device=devices[0],
                                tts_ecapa=(ecapa.init_ecapa(3, ecfg, devices[0]), ecfg),
                                tts_speech_tokenizer=(st, scfg))
            tokens, seconds = 250, REQUEST_SECONDS
        print(f"  {time.perf_counter() - t0:.1f} s", flush=True)
        if not args.rehearse:
            report["kernels"] = kernels_phase(devices, one.tts.params["vocoder"])
        report["stages"], placed, default = stage_phase(one, slots, seconds)
        report["tts_dispatch"] = tts_dispatch_phase(
            {"one card": one, "placed": placed, "placed, tts dp=1": default},
            _speechlike(seconds, seed=10))
        del placed, default
        report["tp"] = tp_phase(one, slots, tokens)
        report["sp"] = sp_phase(one, slots, 60.0)
        del one
    report["dp"] = dp_phase(slots, lm_cfg, rows)
    report["processes"] = processes_phase(args.rehearse)
    report["published_processes"] = published_processes(
        args.rehearse, report["dp"]["published"]["one card"])
    report["launches"] = {name: fn.launches for name, fn in (
        ("log_mel_frames", cuda_mel.log_mel_frames),
        ("fused_resblock_stage", cuda_vocoder.fused_resblock_stage),
        ("fused_ln_matvec", cuda_decode.fused_ln_matvec),
        ("fused_ln_mlp", cuda_decode.fused_ln_mlp), ("matmul_int4", cuda_int4.matmul_int4))}
    report["seconds"] = time.perf_counter() - t_start
    os.makedirs("chiprun_out", exist_ok=True)
    with open(os.path.join("chiprun_out", "parallel_smoke.json"), "w") as f:
        json.dump(report, f, indent=1, default=str)
    print(f"== launches {report['launches']}; done in {report['seconds']:.1f} s", flush=True)
    print(card)
    print(json.dumps({"ok": True, "device": {"platform": "cpu" if args.rehearse else "gpu",
                                             "kind": card, "count": len(devices)}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
