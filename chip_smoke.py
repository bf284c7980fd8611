"""Drive the PyTorch port on one NVIDIA H100 and check it end to end.

    python3 chip_smoke.py

Phases, in order; any failure exits non-zero and prints no result:

1. devices  — the card's name and power limit (nvidia-smi);
2. build    — nvcc builds every kernel of the main path from csrc/, in parallel;
3. kernels  — each kernel against its plain PyTorch version at the shapes
              the main path gives it (the decode kernels, which no path
              calls, at the decode shapes of the reference models), with its
              time, bound, plain time and the time of one library call (or,
              for the decode kernels, of the cuBLAS chain) computing the same
              function; the log-mel kernel, its plain version and the
              torch.stft chain are each captured as a CUDA graph and replayed
              in turns at the 10, 20 and 30 s windows; the resblock kernel's
              plan (variant, window, shared memory) is held against the
              kernel source's own estimate, and the kernel is checked in the
              contiguous layout and in vocode's (the transposed view of
              [B, C, T]) at B = 1 and at the B = 8 of a batched dispatch, and
              timed with CUDA events in both; the decode
              kernels' work split is held against the Python mirror, both
              are replayed from a CUDA graph against their eager launches,
              checked in bf16 and f32 at batch 1-16 and the Qwen2 widths, and
              timed at batch 1, 4 and 8 over stacks of distinct weights larger
              than the 50 MB L2, as a decoder walks its layers, each pass
              replayed as a CUDA graph;
4. e2e      — ``torch_engines(scale="reference")`` (Whisper-medium,
              NLLB-600M, CosyVoice2-0.5B dims, bf16, seeded random weights,
              full-width ECAPA and speech-tokenizer conditioning models),
              ``CascadedBackend.initialize()``, one voice-prompt conditioning
              call timed on its own, and three ``translate_speech`` requests
              at their defaults (voice cloning on), with every kernel's launch
              counter read around the requests; the resblock kernel at the
              (C, T) the 10 s request handed it, checked and timed; language
              detection of the 10 s request (one log-mel launch);
5. frontend — the e2e phase's backend: a 10 s 44.1 kHz stereo upload
              (decorrelated channels) and a 16 kHz mono one written and read
              back by ``media/wavio.py``, ``validate_audio_length`` and
              ``AudioProcessor.process_audio`` on the card against the same
              call with ``device="cpu"``; ``process_audio`` timed at 10 s and
              at the 300 s cap with its peak memory; then, launch counters at
              0, the upload's ``process_audio`` and ``translate_speech`` with
              250 frames of 360×640 synthetic talking-head video at 25 fps:
              the visual branch must find speech segments and call
              ``distribute_audio`` (detector and mapper seconds printed),
              log-mel launch once and the resblock twice;
6. serve    — the e2e phase's backend as the default of a
              ``TranslationManager``: with werkzeug (checked and printed),
              ``serve/app.py``'s ``create_app(device="cuda")`` served by
              ``make_server`` on a free localhost port in a thread, and real
              HTTP requests (urllib): ``/translate`` of a 10 s 44.1 kHz
              stereo PCM16 upload, the same streamed (SSE), ``/translate-text``
              with synthesis, ``/process-video`` over a test ``VideoIO`` (the
              upload's audio, the frontend phase's frames, a lip-sync that
              raises so the mux runs), ``/health/model`` and
              ``/available-backends``; without werkzeug, the calls each route
              makes, driven directly. Each route's wall beside the
              ``translate_speech`` seconds inside it, the stream's first
              audio frame, peak memory; the audio decodes, the video is
              watermarked and its visual branch ran, the placement is device
              0 for every stage, log-mel launches once and the resblock twice
              for each offline request;
7. lipsync  — MuseTalk at its published width (``MuseTalkConfig()``: VAE
              128/256/512/512, UNet 320/640/1280/1280, audio 384) in bf16 with
              seeded random weights, conditioned through ``whisper_feature_fn``
              on a random whisper-tiny-width encoder (d_model 384, 80 mels):
              ``musetalk_lipsync_fn`` renders the frontend phase's 250 frames
              against the e2e phase's 10 s dub (handed over at 24 kHz, so it
              resamples), timed and split into face boxes (host), the audio
              condition, the crops, ``lipsync_frames`` and the blend, with
              frames per second and peak memory; log-mel launches once and
              the resblock never; nothing outside the face boxes or above the
              jaw line changes and every jaw does; one batch of 2 crops in f32
              on the card against ``device="cpu"`` (LIPSYNC_F32_RTOL); then
              ``/process-video`` with ``apply_lip_sync=true`` over HTTP: through
              the port's libav shim (an MP4 from ``native.encode_video``,
              decoded back) where the card has g++ and libav's headers, and a
              FLAC upload to ``/translate``; else, said on an earlier line with
              the paths checked, over the serve phase's test VideoIO with the
              real lip-sync. Frames, fps and audio length against the dub, the
              visual branch run, log-mel twice and the resblock twice;
8. diff2lip — the diff2lip TFG UNet at its published width
              (``Diff2LipConfig()``: 128 px, 128 channels × (1, 1, 2, 3, 4),
              attention at ds 8/16, the audio-as-style encoder, ddim25),
              seeded random weights, its parameter count and the operations
              of one UNet call (``FlopCounterMode``): ``generate`` of the
              first 25 frontend frames with the f32 tree, of all 250 with
              the tree in bf16, and of one batch of 8 in cross-identity mode
              (the identity clip reversed), against the e2e phase's 10 s dub,
              each split into face boxes (host), mel windows, crops,
              sampling (card) and the blend (host), with frames per second,
              the sampling's TFLOP/s and share of the FP32 or bf16 peak, and
              peak memory; the frames' shape and dtype kept, nothing outside
              a face box changed, every jaw changed; in f32, one
              ``gd_unet_apply`` on 2 crops and the sampled crops of a
              ``ddim4`` batch of 2 on the card against ``device="cpu"``
              (DIFF2LIP_F32_RTOL); log-mel and the resblock never launched;
9. services — the split deployment: whether requests, urllib3 and yt-dlp are
              on the host (without requests the HTTP transport is not
              driven and the clients run over ``WsgiTransport``); the port's
              ``CosyVoiceService`` with the e2e phase's TTS engine as its
              "default", served on a free localhost port, and
              ``create_app`` in mode "remote" against its URL (the port's
              ASR and NMT at reference scale on the card, the TTS a
              ``CosyVoiceClient``), served too: the serve phase's 10 s
              upload posted to /translate over HTTP (wall beside the
              ``translate_speech`` inside it, the TTS call over the wire
              beside the engine's direct ``synthesize`` of the same text and
              reference, log-mel once and the resblock twice, the resblock
              kernel checked at the request's shapes); ``MuseTalkClient`` to
              ``MuseTalkService`` over the test VideoIO with the lipsync
              phase's MuseTalk fn (25 frames against the 10 s dub, only the
              jaws changed, log-mel once); ``SimilarityClient`` to
              ``SimilarityService`` with the full-width ECAPA (the dub with
              itself 1.0, with the upload; each the direct score within the
              response's rounding); OpenVoice at its published width in f32
              (``OpenVoiceConfig()``), its parameter count, emitted as
              ``checkpoint.pth`` + ``config.json``, read back by
              ``load_openvoice``, baked and reloaded, picked up from
              ``EST_MODELS_DIR`` by ``OpenVoiceService`` (``OpenVoiceClient.
              clone`` of 10 s against a 5 s reference: 22,050 Hz, the
              length its geometry gives, seconds and RTF, no launch), and
              its f32 ``convert_tone`` on the card against ``device="cpu"``
              (OPENVOICE_F32_RTOL); the phase's peak memory;
10. batched  — the same engines behind the three micro-batchers
              (``torch_engines(batch_*=True, max_batch=8)``), ``initialize()``,
              8 concurrent 10 s ``translate_speech`` requests from 8 threads:
              requests per second against the e2e phase's 10 s request served
              alone, the batches formed, peak memory; the resblock kernel must
              have launched at B > 1, and is checked and timed at the shapes
              the requests handed it;
11. streaming — the e2e phase's engines (no second ``initialize()``),
              ``translate_speech_streaming`` of a 10 s and a 40 s request
              (two ASR windows), cloning on: time to the first audio event,
              wall, events and chunk lengths, the launch counters around each
              stream (log-mel once a window, resblock twice a streamed TTS
              chunk); the resblock kernel checked and timed at the (B, C, T)
              the stream handed it, in vocode's layout and the contiguous one;
12. mtp     — the e2e phase's TTS config on one random tree with two MTP
              heads, bf16: ``synthesize`` of the 10 s request's text and voice
              prompt at ``mtp=1``, ``mtp=3`` (accept-all) and ``mtp=3,
              spec=True`` (stage seconds, speech tokens, backbone passes,
              tokens a pass; the resblock kernel must launch in each), and a
              batch of 8 at ``mtp=3``; in f32 the speculative stream against
              the single-token one on the same noise (250 tokens), failing if
              they part where decode_step and decode_span agree or where
              the two calls' logits do not give the two tokens; then one
              decode step of the Whisper, NLLB and Qwen2 decoders with int8
              weights against bf16 (logits within INT8_LOGIT_RTOL, both
              replayed as CUDA graphs in turns at B = 1 and 8) and one 10 s
              request on ``torch_engines(quantize=True)``;
13. official — the official CosyVoice2 chain at its full width
              (``OfficialTtsConfig()``: Qwen2-0.5B LM with 6,561 speech tokens,
              the 512-wide 6 + 4 block conformer, the 256-channel estimator of
              14 units × 4 transformer blocks, 10 Euler steps with CFG, HiFT
              at 512 channels), seeded random weights (the head's EOS logit
              lowered, so the LM runs its budget), bf16:
              ``torch_engines(scale="reference", tts_official=...)``,
              ``initialize()``, one 10 s ``translate_speech`` with cloning on
              (stage seconds and RTF beside the e2e phase's native 10 s
              request; log-mel launched for the request, the resblock kernel
              never during the official synthesis), one ``synthesize_batch``
              of a row with a reference and one without (each row's length
              its tokens × token_mel_ratio × HiFT's hop), one 10 s
              ``translate_speech_streaming`` (first audio, wall, chunks; the
              streamed samples add up to the streamed tokens × samples a
              token), the full-width ``flow.pt`` / ``hift.pt`` written by the
              port's emitters and read back by the loaders (the flow's config
              inferred), and the HiFT source of one 10 s bf16-representable
              f0 track with the engine's bf16 HiFT parameters against their
              f32 copies (the port integrates the phase in f32);
14. checkpoints — seeded random Whisper-medium, NLLB-200-distilled-600M,
              ECAPA (1,024 channels) and the official CosyVoice2 triple, f32,
              written by ``obs/checkpoint_emitters.py`` in their published
              formats (``model.safetensors``, ``pytorch_model.bin``,
              ``embedding_model.ckpt``, ``llm.pt`` / ``flow.pt`` / ``hift.pt``)
              to a temporary directory (free disk checked first), read back by
              ``load_whisper`` / ``load_nllb`` / ``load_ecapa`` (seconds and
              GB/s; configs and every tensor equal), baked by ``bake_models``
              and reloaded by ``load_converted`` / ``load_official_tts``
              (equal), then one 10 s ``translate_speech`` with cloning on,
              its audio read back through ``write_wav`` / ``read_wav``, served
              by ``torch_engines(scale="reference")`` from ``EST_MODELS_DIR``
              (asr, nmt and ecapa; the official triple left out, so the native
              TTS runs): weights supplied, a log-mel launch a rung of the ASR's
              temperature ladder and 2 resblock launches, the resblock kernel
              checked at the request's shapes; an orbax-style stage
              directory refused; and MuseTalk at its published width with a
              whisper-tiny, f32, written in the release layout, read back by
              ``load_musetalk`` (equal), baked, and 25 frames rendered by
              ``default_lipsync_fn`` from the bake (the whisper condition:
              log-mel once); and diff2lip at its published width, f32, written
              by the emitter as a ``module.``-prefixed ``e2e.pt``, read back
              by ``load_diff2lip`` (equal), baked, reloaded by
              ``load_converted`` (equal), and 8 frames rendered by
              ``Diff2LipPipeline.from_models_dir`` from the bake, each step's
              seconds and GB/s;
15. alternate — the alternate backends: SeamlessM4T-v2 at its published
              width (``SeamlessConfig.v2_large()``), f32, seeded random
              weights, its parameter count; written by ``write_seamless`` as
              sharded safetensors with their index, ``config.json`` and a
              ``generation_config.json`` of language maps (free disk checked
              first), read back by ``load_seamless`` / ``load_seamless_aux``
              (seconds, GB/s, config, maps and every tensor equal), baked by
              ``bake_models(seamless=...)``; in f32 ``encode_speech`` of 2 s
              and ``code_hifigan`` of 50 units on the card against
              ``device="cpu"`` (ALT_F32_RTOL); ``SeamlessBackend.
              from_models_dir()`` under EST_MODELS_DIR (weights "loaded"),
              ``initialize()`` (the bf16 cast) and a 10 s ``translate_speech``
              eng → fra at 5 beams and 64 text tokens, twice (seconds, RTF,
              samples equal to the vocoder's length and within the 2 ×
              max_units × hop horizon, |audio| ≤ 1, no launch of either
              kernel); ``ESPnetBackend`` with the e2e phase's Whisper-medium
              as its ASR and the default VITS: a 10 s request twice, log-mel
              once and the resblock never a request, 16 kHz output of the
              VITS's resampled samples; the three backends on one
              ``TranslationManager`` behind ``create_app`` over HTTP on
              localhost: ``/available-backends`` (Seamless "loaded", ESPnet
              "random") and ``/translate`` with ``backend=seamless``; the
              phase's peak memory and seconds;
16. tools   — the tools a user runs besides the server, on the e2e phase's
              backend where they take one: ``cli.main(["translate", in.wav,
              out.wav, "--target-lang", "fra"])`` (the CLI's default engines,
              toy ``torch_engines()`` on the card: its JSON, stage xRT and the
              launches it made, log-mel at least once); ``run_verify_quality``
              of configs 1, 2, 3 and 5 over the e2e engines with speech-like
              WAV fixtures, the ECAPA ``SpeakerScorer`` from an ``ecapa/``
              stage the phase bakes (a seeded full-width tree) and the
              published-width OpenVoice tone converter on a seeded tree
              (every config ``"ran": true``, each config's seconds and
              launches, the report's mode and verdict); the NLLB
              ``SemanticScorer`` over the e2e NLLB-600M tree (``sonar_score``
              and ``bert_score_f1`` of two sentences in bf16, and in f32 on
              the card against ``device="cpu"``, SEMANTIC_ATOL); ``cli.main
              (["embed", ...])`` from the baked stage; ``create_manifest`` →
              ``batch.runner.main([..., "--manifest", csv, "--row", "1"])``;
              then ``cli.main(["doctor"])``, every check ok but
              ``native_media_shim`` where the machine has no libav (its log-mel
              check against the plain version is not counted); the phase's
              peak memory and seconds;
17. the kernels line, the card line, and last the result line.

The e2e phase also times one ``translate`` at ``num_beams=4`` beside the
greedy call.

The long report goes to chiprun_out/chip_smoke.json.
"""

from __future__ import annotations

import base64
import contextlib
import dataclasses
import functools
import gc
import io
import json
import logging
import math
import os
import shutil
import sys
import tempfile
import threading
import time
import types

import numpy as np
import torch

import torch.nn.functional as F

from expressive_speech_translation_tpu_torch.obs.perf import (card_line, graph_turns, stack_time,
                                                              sync_time)
from expressive_speech_translation_tpu_torch.ops import (build, cuda_decode, cuda_int4,
                                                          cuda_mel, cuda_vocoder)

# NVIDIA H100 SXM data-sheet peaks (dense): FP32 on the CUDA cores, bf16 on
# the tensor cores, HBM3 bandwidth.
PEAK_FP32 = 67e12
PEAK_BF16 = 989e12
PEAK_BYTES = 3.35e12

MEL_ATOL = 1e-4          # normalised log-mel units, as tests/test_pallas_mel.py holds the JAX kernel
RES_F32_RTOL = 1e-5      # max |kernel - plain| / max |plain|: f32 sums in another order
RES_BF16_RTOL = 1.6e-2   # two bf16 ulps (2^-7 relative) of the peak, and a margin: operands and output round to bf16
DEC_F32_RTOL = 1e-5      # decode kernels, f32: max |kernel - plain| / max |plain|, sums in another order
DEC_BF16_RTOL = 1.6e-2   # decode kernels, bf16: an output rounded to bf16 plus summation order
STACK_MIN_LAYERS = 24
STACK_MIN_BYTES = 100e6
KERNELS = (3, 7, 11)
DILATIONS = ((1, 3, 5),) * 3
OUT_DIR = "chiprun_out"
_KEPT: dict = {}         # arrays one phase hands a later one (never written to the report)
PORT = "expressive_speech_translation_tpu_torch"
REFERENCE = PORT.removesuffix("_torch")  # the JAX package the port replaces


def _speechlike(seconds: float, seed: int, sr: int = 16_000) -> np.ndarray:
    g = np.random.default_rng(seed)
    t = np.arange(int(sr * seconds)) / sr
    x = (0.4 * np.sin(2 * np.pi * 220 * t) + 0.2 * np.sin(2 * np.pi * 880 * t + 1.0)
         + 0.02 * g.standard_normal(t.shape))
    x *= 0.5 + 0.5 * np.sin(2 * np.pi * 3.0 * t) ** 2
    return x.astype(np.float32)


# ------------------------------------------------------------------ kernels


# (window s, mels, seconds of speech): the ASR's context buckets at 80 mels
# (the kernels line takes 30 s, the default bucket) and 30 s at 128 mels
MEL_CASES = ((10, 80, 10.0), (20, 80, 17.3), (30, 80, 23.7), (30, 128, 23.7))
MEL_GRAPH_CALLS = 50     # launches captured into one CUDA graph


def _log_mel_work(frames: int, n_mels: int, nnz: int, audio_len: int) -> tuple:
    """(FLOPs, bytes) the FFT design must do for one window: per frame the
    Hann window (400 products), a 200-point complex FFT of the even/odd
    sample pairs in three Stockham passes (25 radix-8 butterflies of 56
    FLOPs; 2 x 40 radix-5 butterflies of 56 FLOPs plus 4 twiddle products of
    6), the real-FFT split and power of 201 bins (25 FLOPs a bin) and the
    banded mel projection (2 FLOPs a filterbank nonzero, one log a mel);
    bytes: the samples read once, the frames written once, and the tables
    (window, 400 complex twiddles, the band table and its weights)."""
    per_frame = 400 + 25 * 56 + 2 * 40 * (56 + 4 * 6) + 201 * 25 + 2 * nnz + n_mels
    table_bytes = 400 * 4 + 400 * 8 + n_mels * 3 * 4 + nnz * 4
    return frames * per_frame, audio_len * 4 + frames * n_mels * 4 + table_bytes


def _host_ms(fn, iters: int = 50) -> tuple:
    """(host issue ms, synchronised wall ms) of one eager call of ``fn``, each
    call started on an idle card: what a caller pays for it on the host
    clock."""
    fn()
    torch.cuda.synchronize()
    issue = wall = 0.0
    for _ in range(iters):
        t0 = time.perf_counter()
        fn()
        t1 = time.perf_counter()
        torch.cuda.synchronize()
        issue += t1 - t0
        wall += time.perf_counter() - t0
    return issue / iters * 1e3, wall / iters * 1e3


def _log_mel_f64(audio, n_mels: int, chunk: int) -> torch.Tensor:
    """``log_mel_frames_plain``'s definition evaluated in float64, with the
    same f32 window and filterbank: frames, window, DFT as a product, power,
    mel projection, log10. The reference that says where the f32 plain
    version is itself further than MEL_ATOL from the function."""
    from expressive_speech_translation_tpu_torch.ops.mel import fit_to_chunk, mel_filterbank
    from expressive_speech_translation_tpu_torch.ops.stft import reflect_pad
    from expressive_speech_translation_tpu_torch.ops.windows import hann

    dev = audio.device
    x = reflect_pad(fit_to_chunk(audio.double(), chunk), 200)
    frames = x.unfold(-1, 400, 160)[: chunk // 160]
    angle = -2.0 * np.pi * np.arange(400)[:, None] * np.arange(201)[None, :] / 400
    window = hann(400).astype(np.float64)[:, None]
    re = frames @ torch.from_numpy(window * np.cos(angle)).to(dev)
    im = frames @ torch.from_numpy(window * np.sin(angle)).to(dev)
    fb = torch.from_numpy(mel_filterbank(16_000, 400, n_mels).astype(np.float64)).to(dev)
    return torch.log10(torch.clamp_min((re * re + im * im) @ fb, 1e-10))


def _mel_agreement(got, audio, n_mels: int, chunk: int) -> dict:
    """The kernel's normalised log-mel ``got`` [n_mels, frames] against the
    plain version and against its float64 evaluation. The kernel must lie
    within MEL_ATOL of the plain version wherever the plain version lies
    within MEL_ATOL of float64, and within MEL_ATOL of float64 everywhere: a
    band far under its frame's peak is where an f32 DFT product cancels, and
    there the plain version on the card can miss the function by more than
    the tolerance (30 s, 128 mels)."""
    want = cuda_mel.normalize_log_mel(cuda_mel.log_mel_frames_plain(audio, n_mels, chunk)).T
    raw = _log_mel_f64(audio, n_mels, chunk)
    ref = cuda_mel.normalize_log_mel(raw).T
    err = (got - want).abs()
    plain_err = (want.double() - ref).abs()
    plain_off = plain_err > MEL_ATOL
    m, f = divmod(int(plain_err.argmax()), plain_err.shape[1])
    return {"max_abs_err": float(err.max()),
            "err_where_plain_holds": float(err.masked_fill(plain_off, 0).max()),
            "err_f64": float((got.double() - ref).abs().max()),
            "plain_err_f64": float(plain_err.max()),
            "plain_off_points": int(plain_off.sum()),
            # where the plain version misses float64 the most: frame, mel, and
            # that band's level in decades under its frame's peak and above the floor
            "plain_worst": (f, m, float(raw[f].max() - raw[f, m]),
                            float(raw[f, m] - raw.max() + 8))}


def check_log_mel(dev, report):
    """Kernel 1 at each of MEL_CASES against its plain version and the plain
    version's float64 evaluation (``_mel_agreement``), on the waveform as the
    ASR hands it over (zero-padded to the window) and on the bare speech (the
    kernel pads it); then the device times of the kernel, the
    plain version and the library chain (torch.stft, power, mel matmul), each
    captured MEL_GRAPH_CALLS times into a CUDA graph and replayed in turns,
    the same three launched eagerly from Python, and the host cost of one
    ``whisper_log_mel_fused`` call."""
    from expressive_speech_translation_tpu_torch.ops.mel import mel_filterbank

    for ln in report.get("ptxas", {}).get("log_mel", []):
        print(f"  log_mel ptxas: {ln}", flush=True)
    rows = []
    win = torch.hann_window(400, device=dev)
    for window_s, n_mels, audio_s in MEL_CASES:
        chunk = 16_000 * window_s
        speech = _speechlike(audio_s, seed=window_s + n_mels)
        padded = np.zeros(chunk, np.float32)
        padded[: len(speech)] = speech
        agreements = []
        for x in (padded, speech):
            audio = torch.from_numpy(x).to(dev)
            got = cuda_mel.whisper_log_mel_fused(audio, n_mels=n_mels, chunk_samples=chunk)
            a = _mel_agreement(got, audio, n_mels, chunk)
            if not (got.shape == (n_mels, chunk // 160)
                    and all(math.isfinite(a[k]) for k in ("max_abs_err", "err_f64"))
                    and a["err_where_plain_holds"] <= MEL_ATOL and a["err_f64"] <= MEL_ATOL):
                raise AssertionError(f"log-mel {window_s}s {n_mels} mels ({len(x)} samples): "
                                     f"shape {tuple(got.shape)}, {a} against {MEL_ATOL}")
            agreements.append(a)
        agree = {k: max(a[k] for a in agreements) for k in a if k != "plain_worst"}
        agree["plain_worst"] = max(agreements, key=lambda a: a["plain_err_f64"])["plain_worst"]
        err = agree["max_abs_err"]
        audio = torch.from_numpy(padded).to(dev)
        fb_np = mel_filterbank(16_000, 400, n_mels).astype(np.float32)
        fb = torch.from_numpy(fb_np).to(dev)

        def kernel():
            return cuda_mel.log_mel_frames(audio, n_mels, chunk)

        def plain():
            return cuda_mel.log_mel_frames_plain(audio, n_mels, chunk)

        def library():
            spec = torch.stft(audio, 400, 160, window=win, center=True, pad_mode="reflect",
                              return_complex=True)
            return (spec.abs() ** 2).T @ fb

        turns = graph_turns({"kernel": kernel, "library": library, "plain": plain},
                            calls=MEL_GRAPH_CALLS)
        frames = chunk // 160
        flops, nbytes = _log_mel_work(frames, n_mels, int((fb_np != 0).sum()), chunk)
        bound_ms = max(flops / PEAK_FP32, nbytes / PEAK_BYTES) * 1e3
        ms = min(turns["kernel"])
        row = {"window_s": window_s, "n_mels": n_mels, **agree,
               "ms": ms, "plain_ms": min(turns["plain"]), "library_ms": min(turns["library"]),
               "turns_ms": turns, "bound_ms": bound_ms, "bound_share": bound_ms / ms,
               "gflop": flops / 1e9, "mbytes": nbytes / 1e6,
               "eager_ms": sync_time(kernel, 200), "library_eager_ms": sync_time(library, 200)}
        row["fused_issue_ms"], row["fused_wall_ms"] = _host_ms(
            lambda: cuda_mel.whisper_log_mel_fused(audio, n_mels=n_mels, chunk_samples=chunk))
        row["kernel_issue_ms"] = _host_ms(kernel)[0]
        rows.append(row)
        print(f"  log_mel {window_s:2d}s {n_mels:3d} mels: against the plain version {err:.2e} "
              f"({agree['err_where_plain_holds']:.2e} where the plain version is within "
              f"{MEL_ATOL} of float64; it misses at {agree['plain_off_points']} points, by up to "
              f"{agree['plain_err_f64']:.2e}, most at frame %d mel %d, %.2f decades under the "
              f"frame's peak and %.2f above the floor), against float64 {agree['err_f64']:.2e}"
              % agree["plain_worst"], flush=True)
        print(f"    graph-replayed: "
              f"kernel {ms:.4f} ms  stft+matmul {row['library_ms']:.4f} ms  plain "
              f"{row['plain_ms']:.4f} ms  bound {bound_ms:.5f} ms ({row['gflop']:.4f} GFLOP, "
              f"{row['mbytes']:.3f} MB; {100 * bound_ms / ms:.1f}% of bound)  eager: kernel "
              f"{row['eager_ms']:.4f} ms  stft+matmul {row['library_eager_ms']:.4f} ms  "
              f"whisper_log_mel_fused: host {row['fused_issue_ms']:.4f} ms (the kernel's "
              f"wrapper {row['kernel_issue_ms']:.4f}), wall {row['fused_wall_ms']:.4f} ms",
              flush=True)
        print("    turns (ms): " + "  ".join(
            f"{k} " + ", ".join(f"{t:.4f}" for t in v) for k, v in turns.items()), flush=True)
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


# (C, T) of the two narrow stages of 10 s of speech (HiFi-GAN base 512, rates 8 6 10)
RES_STAGES = ((128, 24_000), (64, 240_000))
RES_SHAPES = (  # (C, T, layout, timed); layout "bct": x is the transposed view of [B, C, T]
    *((c, t, layout, True) for layout in ("bct", "btc") for c, t in RES_STAGES),
    (128, 24_001, "btc", False), (64, 240_007, "btc", False),
    (128, 24_001, "bct", False), (64, 240_007, "bct", False),
    (48, 20_011, "btc", False),     # C % 32 != 0: the CUDA-core variant in bf16 too
    (96, 20_011, "btc", True),      # C % 64 != 0: the CUDA-core variant under the wgmma routing
)


# The batched TTS dispatch of 8 requests: random-weight NMT text is empty, so
# each row speaks the 64-token minimum (128 mel frames): the same (C, T) as
# one request, at B = 8; and a ragged T of each stage
RES_BATCH = 8
RES_BATCH_SHAPES = (  # (C, T, layout, timed)
    *((c, t, layout, True) for layout in ("bct", "btc")
      for c, t in ((128, 6_144), (64, 61_440))),
    *((c, t, layout, False) for layout in ("bct", "btc")
      for c, t in ((128, 6_151), (64, 61_447))),
)


def _res_input(c: int, t: int, layout: str, dtype, dev, b: int = 1) -> torch.Tensor:
    """x [B, T, C]: contiguous ("btc"), or the transposed view of a
    contiguous [B, C, T] ("bct"), as vocode hands it to the kernel."""
    g = torch.Generator(device="cpu").manual_seed(c + t)
    x = 0.3 * torch.randn((b, t, c), generator=g)
    if layout == "bct":
        return x.transpose(1, 2).contiguous().to(dev, dtype).transpose(1, 2)
    return x.to(dev, dtype)


def _res_work(b: int, c: int, t: int, es: int, w) -> tuple:
    """(FLOPs, bytes) of one stage over B rows: 2 C^2 T a tap a row; x read
    once, the output written once, the weights and biases read once."""
    taps = sum(2 * k * len(d) for k, d in zip(KERNELS, DILATIONS))
    return 2 * c * c * t * taps * b, 2 * b * t * c * es + (w[0].numel() + w[1].numel()) * es


def time_resblock(row: dict, x, w) -> dict:
    """Add the kernel's and the plain version's CUDA-event times, the bound
    and its share to ``row``."""
    kw = dict(kernels=KERNELS, dilations=DILATIONS)
    row["ms"] = sync_time(lambda: cuda_vocoder.fused_resblock_stage(x, w, **kw), 20, warmup=2)
    row["plain_ms"] = sync_time(lambda: cuda_vocoder.resblock_stage_plain(x, w, **kw),
                                10, warmup=2)
    b, t, c = x.shape
    flops, nbytes = _res_work(b, c, t, x.element_size(), w)
    peak_rate = PEAK_BF16 if x.dtype == torch.bfloat16 else PEAK_FP32
    row["bound_ms"] = max(flops / peak_rate, nbytes / PEAK_BYTES) * 1e3
    row["bound_share"] = row["bound_ms"] / row["ms"]
    row["gflop"] = flops / 1e9
    row["mbytes"] = nbytes / 1e6
    return row


def check_resblock_plans() -> list:
    """The wrapper's plan for every width and dtype checked: its shared memory
    (computed in Python) equals the kernel source's own estimate and fits a
    block, and the two 10 s stages run the wgmma variant in bf16."""
    lib = cuda_vocoder._lib()
    margin = cuda_vocoder.stage_margin(KERNELS, DILATIONS)
    plans = []
    for dtype in (torch.bfloat16, torch.float32):
        for c in sorted({c for c, *_ in RES_SHAPES}):
            pl = cuda_vocoder.plan(c, dtype, KERNELS, DILATIONS)
            est = (lib.est_resblock_wg_smem_bytes(c, pl.window, margin) if pl.variant == "wgmma"
                   else lib.est_resblock_smem_bytes(c, pl.window // 32, 2 if dtype == torch.bfloat16
                                                    else 4))
            main = dtype == torch.bfloat16 and c in dict(RES_STAGES)
            if est != pl.smem_bytes or est > cuda_vocoder.SMEM_OPTIN_BYTES or (
                    main and pl.variant != "wgmma"):
                raise AssertionError(f"resblock plan C={c} {dtype}: {pl}, kernel's estimate {est}")
            plans.append({"C": c, "dtype": str(dtype).split(".")[-1], **pl._asdict()})
            print(f"  resblock plan C={c:3d} {plans[-1]['dtype']:>8}: {pl.variant}, window "
                  f"{pl.window}, {pl.smem_bytes} B of shared memory, {pl.threads} threads",
                  flush=True)
    return plans


def check_resblock(dev, report):
    """Kernel 2 at the two narrow stages of 10 s of speech (C=128, T=24000;
    C=64, T=240000) and ragged lengths, in bf16 (serving) and f32, in the
    contiguous layout and in the main path's (the transposed view of
    [1, C, T]); C=48 and C=96 run the CUDA-core variant. The 10 s stages and
    C=96 are timed in bf16, each with its bound and share."""
    for ln in report.get("ptxas", {}).get("resblock", []):
        print(f"  resblock ptxas: {ln}", flush=True)
    report["resblock_plans"] = check_resblock_plans()
    rows = []
    cases = [(1, *shape) for shape in RES_SHAPES] + [(RES_BATCH, *shape)
                                                      for shape in RES_BATCH_SHAPES]
    for dtype in (torch.bfloat16, torch.float32):
        for b, c, t, layout, timed in cases:
            x = _res_input(c, t, layout, dtype, dev, b)
            w = _stage_weights(c, dtype, dev, seed=c)
            got = cuda_vocoder.fused_resblock_stage(x, w, kernels=KERNELS, dilations=DILATIONS)
            want = cuda_vocoder.resblock_stage_plain(x, w, kernels=KERNELS, dilations=DILATIONS)
            torch.cuda.synchronize()
            err = float((got.float() - want.float()).abs().max())
            peak = float(want.float().abs().max())
            tol = RES_BF16_RTOL if dtype == torch.bfloat16 else RES_F32_RTOL
            if not (got.shape == x.shape and got.stride() == x.stride() and math.isfinite(err)
                    and err <= tol * peak):
                raise AssertionError(f"resblock B={b} C={c} T={t} {layout} {dtype}: max |err| "
                                     f"{err} > {tol} * {peak} (shape {tuple(got.shape)}, "
                                     f"strides {got.stride()})")
            row = {"B": b, "C": c, "T": t, "layout": layout, "dtype": str(dtype).split(".")[-1],
                   "variant": cuda_vocoder.variant(x, KERNELS, DILATIONS),
                   "max_abs_err": err, "peak": peak}
            if timed and dtype == torch.bfloat16:
                time_resblock(row, x, w)
            rows.append(row)
            extra = (f"  kernel {row['ms']:.4f} ms  plain {row['plain_ms']:.3f} ms  "
                     f"bound {row['bound_ms']:.4f} ms ({100 * row['bound_share']:.2f}% of bound)"
                     if "ms" in row else "")
            print(f"  resblock B={b} C={c:3d} T={t:6d} {layout} {row['dtype']:>8} "
                  f"[{row['variant']}]: err {err:.2e} (peak {peak:.3f}){extra}", flush=True)
            del x, got, want
    for label, b in (("pair", 1), (f"B={RES_BATCH} pair", RES_BATCH)):
        pair = _res_pair(rows, b)
        print(f"  resblock {label}, main-path layout: {sum(r['ms'] for r in pair):.4f} ms, bound "
              f"{sum(r['bound_ms'] for r in pair):.4f} ms, plain "
              f"{sum(r['plain_ms'] for r in pair):.3f} ms  [{report['card']}]", flush=True)
    report["resblock"] = rows
    return rows


def _res_pair(rows, b: int) -> list:
    """The timed bf16 rows of the two narrow stages at batch ``b`` in the
    main path's layout: 10 s of speech at B = 1, a batched dispatch's rows
    at B = RES_BATCH."""
    stages = RES_STAGES if b == 1 else [(c, t) for c, t, _, timed in RES_BATCH_SHAPES if timed]
    return [r for r in rows if r["B"] == b and (r["C"], r["T"]) in stages
            and r["layout"] == "bct" and r["dtype"] == "bfloat16" and "ms" in r]


# Decode shapes of the reference models (no path calls these kernels: the
# JAX decode loops keep them off too). Timed in bf16 at decode batch 1, 4 and
# 8 (Whisper) and 1 and 8 (Qwen2); the rest are checked for correctness only:
# batches that cross the groups of 8 rows (3, 5, 9, 16), and the Qwen2 widths
# (D = 896, N = 1152, F = 4864 gated), which split unevenly into tiles.
MATVEC_SHAPES = (  # (label, B, D, N, norm, eps, timed)
    *((f"whisper-medium qkv B={b}", b, 1024, 3072, "layer", 1e-5, b in (1, 4, 8))
      for b in (1, 4, 8, 3, 5, 9, 16)),
    *((f"qwen2-0.5b qkv B={b}", b, 896, 1152, "rms", 1e-6, b in (1, 8)) for b in (1, 8, 5, 9)),
)
MLP_SHAPES = (  # (label, B, D, F, gated, norm, eps, activation, timed)
    *((f"whisper-medium / nllb-600m mlp B={b}", b, 1024, 4096, False, "layer", 1e-5, "gelu",
       b in (1, 4, 8)) for b in (1, 4, 8, 3, 5, 9, 16)),
    *((f"qwen2-0.5b gated mlp B={b}", b, 896, 4864, True, "rms", 1e-6, "silu", b in (1, 8))
      for b in (1, 8, 3, 9, 16)),
)
INT4_SHAPES = ((8, 2048, 8192), (1, 1024, 4096))  # (B, K, N), timed
# correctness only, for the tensor-core kernel: K/2 = 100 and 104 end in a
# ragged k-step (x copied element by element, and with cp.async); 16 rows
# take two n-tiles; 20 rows a group of 16 and then a group of 4
INT4_EDGE_SHAPES = ((3, 200, 384), (3, 208, 384), (16, 2048, 1024), (20, 2048, 1024))


def _stack_layers(layer_bytes: int) -> int:
    """Distinct weight layers to time over: at least 24, and at least 100 MB,
    so repeated launches cannot be served from the 50 MB L2."""
    return max(STACK_MIN_LAYERS, math.ceil(STACK_MIN_BYTES / layer_bytes))


def _compare(label, dtype, got, want):
    torch.cuda.synchronize()
    err = float((got.float() - want.float()).abs().max())
    peak = float(want.float().abs().max())
    tol = DEC_BF16_RTOL if dtype == torch.bfloat16 else DEC_F32_RTOL
    if not (got.shape == want.shape and got.dtype == want.dtype and math.isfinite(err)
            and err <= tol * peak):
        raise AssertionError(f"{label} {dtype}: max |err| {err} > {tol} * {peak}")
    return err, peak


def _bound(nbytes: float, flops: float) -> dict:
    bound_ms = max(nbytes / PEAK_BYTES, flops / PEAK_BF16) * 1e3
    return {"bound_ms": bound_ms, "mbytes": nbytes / 1e6, "gflop": flops / 1e9}


def _gen(dev, seed):
    return torch.Generator(device=dev).manual_seed(seed)


def _randn(shape, g, dev, dtype, s=1.0):
    return (torch.randn(shape, generator=g, device=dev) * s).to(dtype)


def _time_stack(row, stack, kernel, plain, chain, chain_calls, nbytes, flops):
    """Time one call of ``kernel``, ``plain`` and ``chain`` (each a function
    of one layer's weights) over the layer ``stack``; add the times, the
    bound and its share to ``row``."""
    for key, fn in (("", kernel), ("plain_", plain), ("chain_", chain)):
        row[f"{key}ms"], row[f"{key}eager_ms"] = stack_time(
            [functools.partial(fn, layer) for layer in stack])
    row.update(layers=len(stack), chain_calls=chain_calls, **_bound(nbytes, flops))
    row["bound_share"] = row["bound_ms"] / row["ms"]


def _norm_chain(x, norm, d, scale, bias, eps):
    return (F.layer_norm(x, (d,), scale, bias, eps) if norm == "layer"
            else F.rms_norm(x, (d,), scale, eps))


def check_decode_plans(dev) -> list:
    """The split ``decode.cu`` reports for every decode shape and dtype
    checked equals the Python mirror's (``cuda_decode.stream_plan`` /
    ``out_plan``) at this card's SM count, and fits a block."""
    sms = torch.cuda.get_device_properties(dev).multi_processor_count
    plans = []
    cases = [(label, bsz, d, n, False, False) for label, bsz, d, n, *_ in MATVEC_SHAPES]
    cases += [(label, bsz, d, f, True, gated) for label, bsz, d, f, gated, *_ in MLP_SHAPES]
    for label, bsz, d, n, mlp, gated in cases:
        for dtype in (torch.bfloat16, torch.float32):
            got = cuda_decode.kernel_plans(d, n, bsz, dtype, mlp=mlp, gated=gated)
            want = (cuda_decode.mlp_plan(d, n, bsz, gated, dtype, sms) if mlp
                    else (cuda_decode.matvec_plan(d, n, bsz, dtype, sms),))
            if got != want or max(p.smem for p in got) > cuda_decode.SMEM_OPTIN_BYTES:
                raise AssertionError(f"decode plan {label} {dtype}: kernel {got}, mirror {want}")
            plans.append({"shape": label, "dtype": str(dtype).split(".")[-1],
                          "plans": [p._asdict() for p in got]})
            if dtype == torch.bfloat16 and bsz in (1, 16):
                print(f"  decode plan {label} bf16: " + "; ".join(
                    f"cluster {p.cluster}, ks {p.ks}, {p.stages} stages in {p.slots} slots, "
                    f"{p.smem} B" for p in got), flush=True)
    return plans


def check_decode_graph(dev) -> None:
    """Both decode kernels captured into a CUDA graph (the MLP's second
    kernel by programmatic dependent launch) and replayed give what they give
    launched eagerly."""
    g = _gen(dev, 7)
    for dtype in (torch.bfloat16, torch.float32):
        x = _randn((4, 1024), g, dev, dtype)
        sc = 1 + 0.1 * _randn((1024,), g, dev, torch.float32)
        bi = 0.1 * _randn((1024,), g, dev, torch.float32)
        w, b = _randn((1024, 3072), g, dev, dtype, 1 / 32), _randn((3072,), g, dev, torch.float32)
        wp, b1 = _randn((2048, 4096), g, dev, dtype, 1 / 32), _randn((4096,), g, dev, torch.float32)
        calls = (lambda: cuda_decode.fused_ln_matvec(x, sc, bi, w, b),
                 lambda: cuda_decode.fused_ln_mlp(x, sc, bi, wp, b1, sc))
        for fn in calls:
            eager = fn()
            graph = torch.cuda.CUDAGraph()
            with torch.cuda.graph(graph):
                replayed = fn()
            graph.replay()
            torch.cuda.synchronize()
            if not torch.equal(eager, replayed):
                raise AssertionError(f"decode kernel replayed from a CUDA graph differs ({dtype})")
            del graph
    print("  decode kernels under CUDA graph capture: replays equal eager launches", flush=True)


def check_ln_matvec(dev, report):
    """Kernel 3 at the qkv shapes, bf16 and f32 against the plain version;
    the timed shapes in bf16 over a weight stack with the plain version and
    the cuBLAS chain (layer_norm or rms_norm, then addmm: 2 calls)."""
    report["decode_plans"] = check_decode_plans(dev)
    check_decode_graph(dev)
    rows = []
    for label, bsz, d, n, norm, eps, timed in MATVEC_SHAPES:
        for dtype in (torch.bfloat16, torch.float32):
            g = _gen(dev, d + n + bsz)
            x = _randn((bsz, d), g, dev, dtype)
            sc, bi = 1 + 0.1 * _randn((d,), g, dev, torch.float32), 0.1 * _randn((d,), g, dev, torch.float32)
            w, b = _randn((d, n), g, dev, dtype, d ** -0.5), 0.05 * _randn((n,), g, dev, torch.float32)
            kw = dict(norm=norm, eps=eps)
            got = cuda_decode.fused_ln_matvec(x, sc, bi, w, b, **kw)
            want = cuda_decode.fused_ln_matvec_plain(x, sc, bi, w, b, **kw)
            err, peak = _compare(f"ln_matvec {label}", dtype, got, want)
            row = {"shape": label, "B": bsz, "D": d, "N": n, "norm": norm,
                   "dtype": str(dtype).split(".")[-1], "max_abs_err": err, "peak": peak}
            if timed and dtype == torch.bfloat16:
                es = x.element_size()
                stack = [w] + [_randn((d, n), g, dev, dtype, d ** -0.5)
                               for _ in range(_stack_layers(d * n * es) - 1)]
                sc16, bi16, b16 = sc.to(dtype), bi.to(dtype), b.to(dtype)
                _time_stack(
                    row, stack,
                    lambda wl: cuda_decode.fused_ln_matvec(x, sc, bi, wl, b, **kw),
                    lambda wl: cuda_decode.fused_ln_matvec_plain(x, sc, bi, wl, b, **kw),
                    lambda wl: torch.addmm(b16, _norm_chain(x, norm, d, sc16, bi16, eps), wl),
                    2, d * n * es + bsz * (d + n) * es + (2 * d + n) * 4, 2 * bsz * d * n)
                del stack
            rows.append(row)
            _print_decode_row("ln_matvec", row)
    report["ln_matvec"] = rows
    return rows


def check_ln_mlp(dev, report):
    """Kernel 4 at the MLP shapes (residual on), bf16 and f32; the timed
    shapes in bf16 over a stack with the plain version and the cuBLAS chain (norm, addmm, act,
    addmm, add: 5 calls; gated: norm, mm, silu, addmm, mul, addmm, add: 7)."""
    rows = []
    for label, bsz, d, f, gated, norm, eps, act, timed in MLP_SHAPES:
        for dtype in (torch.bfloat16, torch.float32):
            g = _gen(dev, d + f + bsz)
            x = _randn((bsz, d), g, dev, dtype)
            sc, bi = 1 + 0.1 * _randn((d,), g, dev, torch.float32), 0.1 * _randn((d,), g, dev, torch.float32)
            b1, b2 = 0.05 * _randn((f,), g, dev, torch.float32), 0.05 * _randn((d,), g, dev, torch.float32)
            rows_w = 3 * d if gated else 2 * d
            wp = _randn((rows_w, f), g, dev, dtype, d ** -0.5)
            kw = dict(gated=gated, norm=norm, eps=eps, activation=act, residual=True)
            got = cuda_decode.fused_ln_mlp(x, sc, bi, wp, b1, b2, **kw)
            want = cuda_decode.fused_ln_mlp_plain(x, sc, bi, wp, b1, b2, **kw)
            err, peak = _compare(f"ln_mlp {label}", dtype, got, want)
            row = {"shape": label, "B": bsz, "D": d, "F": f, "gated": gated, "norm": norm,
                   "activation": act, "dtype": str(dtype).split(".")[-1],
                   "max_abs_err": err, "peak": peak}
            if timed and dtype == torch.bfloat16:
                es = x.element_size()
                stack = [wp] + [_randn((rows_w, f), g, dev, dtype, d ** -0.5)
                                for _ in range(_stack_layers(rows_w * f * es) - 1)]
                sc16, bi16, b1_16, b2_16 = (v.to(dtype) for v in (sc, bi, b1, b2))

                def chain(wl):
                    xh = _norm_chain(x, norm, d, sc16, bi16, eps)
                    if gated:
                        u = F.silu(torch.mm(xh, wl[2 * d:])) * torch.addmm(b1_16, xh, wl[:d])
                    else:
                        u = F.gelu(torch.addmm(b1_16, xh, wl[:d]))
                    return torch.addmm(b2_16, u, wl[d:2 * d].t()) + x

                _time_stack(
                    row, stack,
                    lambda wl: cuda_decode.fused_ln_mlp(x, sc, bi, wl, b1, b2, **kw),
                    lambda wl: cuda_decode.fused_ln_mlp_plain(x, sc, bi, wl, b1, b2, **kw),
                    chain, 7 if gated else 5,
                    rows_w * f * es + 2 * bsz * d * es + (f + 3 * d) * 4,
                    2 * bsz * d * f * (3 if gated else 2))
                del stack
            rows.append(row)
            _print_decode_row("ln_mlp", row)
    report["ln_mlp"] = rows
    return rows


def check_int4(dev, report):
    """Kernel 5, bf16 (tensor-core variant) and f32 (CUDA-core variant), at
    B=8 K=2048 N=8192 and B=1 K=1024 N=4096, and for correctness alone at a
    ragged k-step (B=3 K=200 N=384) and two n-tiles (B=16 K=2048 N=1024);
    bf16 at the first two timed over a stack with the plain version and
    torch.matmul on bf16 weights dequantised beforehand (1 call, 4x the
    weight bytes)."""
    rows = []
    for bsz, k, n in INT4_SHAPES + INT4_EDGE_SHAPES:
        for dtype in (torch.bfloat16, torch.float32):
            g = _gen(dev, k + n + bsz)
            x = _randn((bsz, k), g, dev, dtype)
            p, s = cuda_int4.pack_int4(_randn((k, n), g, dev, torch.float32))
            got = cuda_int4.matmul_int4(x, p, s)
            want = cuda_int4.matmul_int4_plain(x, p, s)
            err, peak = _compare(f"int4 B={bsz} K={k} N={n}", dtype, got, want)
            row = {"shape": f"B={bsz} K={k} N={n}", "B": bsz, "K": k, "N": n,
                   "dtype": str(dtype).split(".")[-1], "variant": cuda_int4.variant(dtype),
                   "max_abs_err": err, "peak": peak}
            if dtype == torch.bfloat16 and (bsz, k, n) in INT4_SHAPES:
                es = x.element_size()
                stack = [(p, s)] + [cuda_int4.pack_int4(_randn((k, n), g, dev, torch.float32))
                                    for _ in range(_stack_layers(k * n // 2) - 1)]
                # the yardstick's weights are dequantised before the clock starts
                deq = {id(pl): cuda_int4.unpack_int4(pl, sl, dtype) for pl, sl in stack}
                _time_stack(
                    row, stack,
                    lambda layer: cuda_int4.matmul_int4(x, *layer),
                    lambda layer: cuda_int4.matmul_int4_plain(x, *layer),
                    lambda layer: torch.matmul(x, deq[id(layer[0])]),
                    1, k * n // 2 + bsz * (k + n) * es + n * 4, 2 * bsz * k * n)
                del stack, deq
            rows.append(row)
            _print_decode_row("int4", row)
    report["int4"] = rows
    return rows


def _print_decode_row(name, row):
    extra = ""
    if "ms" in row:
        extra = (f"  kernel {row['ms']:.4f} ms  plain {row['plain_ms']:.4f} ms  "
                 f"cuBLAS chain of {row['chain_calls']} {row['chain_ms']:.4f} ms  "
                 f"bound {row['bound_ms']:.4f} ms ({100 * row['bound_share']:.1f}% of bound, "
                 f"{row['layers']} layers, graph-replayed; launched from Python: kernel "
                 f"{row['eager_ms']:.4f}, plain {row['plain_eager_ms']:.4f}, chain "
                 f"{row['chain_eager_ms']:.4f} ms)")
    variant = f" [{row['variant']}]" if "variant" in row else ""
    print(f"  {name} {row['shape']} {row['dtype']}{variant}: err {row['max_abs_err']:.2e} "
          f"(peak {row['peak']:.3f}){extra}", flush=True)


def kernels_phase(dev, report):
    print("== kernels against their plain versions", flush=True)
    rows = []
    for check in (check_log_mel, check_resblock, check_ln_matvec, check_ln_mlp, check_int4):
        rows.append(check(dev, report))
        torch.cuda.empty_cache()   # the decode checks' weight stacks take up to 1.3 GB
    return rows


REQUEST_SECONDS = (5.0, 10.0, 20.0)


LAUNCH_COUNTERS = {"log_mel_frames": cuda_mel.log_mel_frames,
                   "fused_resblock_stage": cuda_vocoder.fused_resblock_stage,
                   "fused_ln_matvec": cuda_decode.fused_ln_matvec,
                   "fused_ln_mlp": cuda_decode.fused_ln_mlp,
                   "matmul_int4": cuda_int4.matmul_int4}
MAIN_PATH_KERNELS = ("log_mel_frames", "fused_resblock_stage")


def _check_conditioning(tts, spk, pmel, psp):
    ok = (tuple(spk.shape) == (1, tts.cfg.flow.spk_embed_dim)
          and tuple(pmel.shape) == (1, tts._prompt_frames, tts.cfg.flow.n_mels)
          and tuple(psp.shape) == (1, tts._prompt_tokens) and psp.dtype == torch.int32
          and bool(torch.isfinite(spk.float()).all()) and bool(torch.isfinite(pmel.float()).all())
          and abs(float(spk.float().norm()) - 1.0) < 1e-2
          and int(psp.min()) >= 0 and int(psp.max()) < tts.cfg.lm.speech_token_size)
    if not ok:
        raise AssertionError(f"conditioning: bad outputs {tuple(spk.shape)} {tuple(pmel.shape)} "
                             f"{tuple(psp.shape)} {psp.dtype}")


RES_REQUEST_SECONDS = 10.0   # the request whose resblock launches are recorded and timed


@contextlib.contextmanager
def _recording_resblock_shapes(shapes: list):
    """Append (B, C, T, strides) of every resblock launch inside the block to
    ``shapes``: for the block's duration vocode sees a copy of the
    ``cuda_vocoder`` module whose ``fused_resblock_stage`` records its input
    and calls the wrapper, whose launch counter still counts each launch."""
    from expressive_speech_translation_tpu_torch.models import cosyvoice

    kernel = cuda_vocoder.fused_resblock_stage

    def recording(x, *args, **kwargs):
        if x.is_cuda:
            shapes.append((int(x.shape[0]), int(x.shape[2]), int(x.shape[1]),
                           tuple(x.stride())))
        return kernel(x, *args, **kwargs)

    cosyvoice.cuda_vocoder = types.SimpleNamespace(**{**vars(cuda_vocoder),
                                                      "fused_resblock_stage": recording})
    try:
        yield shapes
    finally:
        cosyvoice.cuda_vocoder = cuda_vocoder


def time_request_resblock(dev, shapes, card, label: str, layouts=("bct",),
                          graphed: bool = False) -> list:
    """The kernel at each distinct (B, C, T) requests handed it, in the main
    path's layout (and any other of ``layouts``), against its plain version;
    timed with its bound (CUDA events through the wrapper, and with
    ``graphed`` also one call captured into a CUDA graph, replayed in turns
    with the plain version, so the host's cost of a call stays out)."""
    rows = []
    for (b, c, t, strides), layout in ((s, lay) for s in dict.fromkeys(shapes) for lay in layouts):
        if strides[1] != 1 or strides[0] != c * t:
            raise AssertionError(f"vocode handed the resblock kernel strides {strides}, "
                                 "not the transposed view of [B, C, T]")
        x = _res_input(c, t, layout, torch.bfloat16, dev, b)
        w = _stage_weights(c, torch.bfloat16, dev, seed=c)
        kw = dict(kernels=KERNELS, dilations=DILATIONS)
        got = cuda_vocoder.fused_resblock_stage(x, w, **kw)
        want = cuda_vocoder.resblock_stage_plain(x, w, **kw)
        torch.cuda.synchronize()
        err = float((got.float() - want.float()).abs().max())
        peak = float(want.float().abs().max())
        if not (math.isfinite(err) and err <= RES_BF16_RTOL * peak):
            raise AssertionError(f"resblock request shape B={b} C={c} T={t}: {err} > "
                                 f"{RES_BF16_RTOL} * {peak}")
        variant = cuda_vocoder.variant(x, KERNELS, DILATIONS)
        if variant != "wgmma":
            raise AssertionError(f"resblock request shape B={b} C={c} T={t} runs {variant}")
        row = time_resblock({"B": b, "C": c, "T": t, "layout": layout, "variant": variant,
                             "max_abs_err": err, "peak": peak,
                             "scratch_mb": b * c * t * 4 / 1e6}, x, w)
        graph = ""
        if graphed:
            turns = graph_turns({"kernel": lambda: cuda_vocoder.fused_resblock_stage(x, w, **kw),
                                 "plain": lambda: cuda_vocoder.resblock_stage_plain(x, w, **kw)},
                                calls=10)
            row.update(graph_ms=min(turns["kernel"]), graph_plain_ms=min(turns["plain"]),
                       graph_turns_ms=turns)
            graph = (f"; graph-replayed kernel {row['graph_ms']:.4f} ms  plain "
                     f"{row['graph_plain_ms']:.4f} ms "
                     f"({100 * row['bound_ms'] / row['graph_ms']:.2f}% of bound)")
        rows.append(row)
        print(f"  resblock at {label}'s shape B={b} C={c} T={t} {layout} [{row['variant']}]: err "
              f"{err:.2e}  kernel {row['ms']:.4f} ms  plain {row['plain_ms']:.3f} ms  bound "
              f"{row['bound_ms']:.4f} ms ({100 * row['bound_share']:.2f}% of bound){graph}, "
              f"branch-sum scratch {row['scratch_mb']:.2f} MB  [{card}]", flush=True)
    if not rows:
        raise AssertionError(f"{label} launched no resblock kernel")
    return rows


def e2e_phase(dev, report, card):
    """Reference-scale engines with full-width conditioning models,
    initialize(), one conditioning call on its own, three translate_speech
    requests at their defaults (eng → fra, voice cloning on), with the
    kernels' launch counters read around the requests; one translate greedy
    and at ``num_beams=4``. → (the phase's results, the backend, which the
    streaming phase reuses)."""
    from expressive_speech_translation_tpu_torch.models import ecapa
    from expressive_speech_translation_tpu_torch.models import speech_tokenizer as stm
    from expressive_speech_translation_tpu_torch.pipeline.cascaded import CascadedBackend
    from expressive_speech_translation_tpu_torch.pipeline.torch_engines import torch_engines

    print("== e2e: reference scale (Whisper-medium, NLLB-600M, CosyVoice2-0.5B; ECAPA 1024 ch, "
          "speech tokenizer dim 256 x 4), bf16, random weights, voice cloning on", flush=True)
    t0 = time.perf_counter()
    ecfg, scfg = ecapa.EcapaConfig(), stm.SpeechTokenizerConfig()
    engines = torch_engines(scale="reference",
                            tts_ecapa=(ecapa.init_ecapa(3, ecfg, dev), ecfg),
                            tts_speech_tokenizer=(stm.init_speech_tokenizer(4, scfg, dev), scfg))
    torch.cuda.synchronize()
    init_s = time.perf_counter() - t0
    backend = CascadedBackend(engines)
    t0 = time.perf_counter()
    backend.initialize()
    torch.cuda.synchronize()
    warm_s = time.perf_counter() - t0
    print(f"  engines {init_s:.1f} s, initialize {warm_s:.1f} s, "
          f"peak memory {torch.cuda.max_memory_allocated() / 2**30:.1f} GiB", flush=True)

    tts = engines.tts
    ref = np.resize(_speechlike(REQUEST_SECONDS[0], seed=99), 16_000 * 10)
    cond_runs = []
    for _ in range(3):
        t0 = time.perf_counter()
        spk, pmel, psp = tts._cond(ref)
        torch.cuda.synchronize()
        cond_runs.append(time.perf_counter() - t0)
    _check_conditioning(tts, spk, pmel, psp)
    print(f"  conditioning (10 s reference: ECAPA, resample, prompt fbank, FSQ tokens): "
          f"{min(cond_runs) * 1e3:.1f} ms (runs {', '.join(f'{c * 1e3:.1f}' for c in cond_runs)})"
          f"  [{card}]", flush=True)

    _reset_launches()
    requests = []
    res_shapes = []
    for seconds in REQUEST_SECONDS:
        x = _speechlike(seconds, seed=int(seconds))
        t0 = time.perf_counter()
        with _recording_resblock_shapes(res_shapes if seconds == RES_REQUEST_SECONDS else []):
            out = backend.translate_speech(x, "eng", "fra")
        wall = time.perf_counter() - t0
        _check_request(out, seconds, f"{seconds} s request")
        if seconds == LIPSYNC_DUB_SECONDS:
            _KEPT["dub"] = out["audio"][0]
        stages = {k: v["seconds"] for k, v in out["stage_summary"].items()}
        requests.append({"audio_s": seconds, "wall_s": wall, "rtf": wall / seconds,
                         "stages_s": stages, "out_samples": int(out["audio"].shape[1]),
                         "target_chars": len(out["transcripts"]["target"]),
                         "transcripts": out["transcripts"]})
        print(f"  {seconds:4.1f} s request: wall {wall:.3f} s, RTF {wall / seconds:.4f}  "
              + "  ".join(f"{k} {v:.3f} s" for k, v in stages.items()) + f"  [{card}]", flush=True)
    launches = _read_launches()
    print(f"  kernel launches over {len(REQUEST_SECONDS)} requests: {launches}", flush=True)
    if min(launches[k] for k in MAIN_PATH_KERNELS) <= 0:
        raise AssertionError(f"a kernel of the main path never launched: {launches}")
    e2e = {"engines_s": init_s, "initialize_s": warm_s, "requests": requests,
           "conditioning_s": cond_runs, "launches": launches,
           "peak_memory_gib": torch.cuda.max_memory_allocated() / 2**30,
           "resblock_request": time_request_resblock(
               dev, res_shapes, card, f"a {RES_REQUEST_SECONDS:.0f} s request"),
           "detect": detect_check(engines.asr, card),
           "beam": beam_check(engines.nmt, card)}
    report["e2e"] = e2e
    return e2e, backend


BEAM_TEXT = "The weather is fine today, and the station is not far from here."


def beam_check(nmt, card) -> dict:
    """One ``translate`` of BEAM_TEXT greedy and one at ``num_beams=4`` on the
    reference-width NMT (NLLB-600M), each timed on the host clock with the
    card synchronised; both must give a string."""
    out, default = {}, nmt.num_beams
    for beams in (1, 4):
        nmt.num_beams = beams
        try:
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            text = nmt.translate(BEAM_TEXT, "eng", "fra")
            torch.cuda.synchronize()
            out[f"beams_{beams}_s"] = time.perf_counter() - t0
        finally:
            nmt.num_beams = default
        if not isinstance(text, str):
            raise AssertionError(f"translate at num_beams={beams} gave {type(text)}")
        out[f"beams_{beams}_chars"] = len(text)
    print(f"  translate ({len(BEAM_TEXT)} chars, NLLB-600M, {nmt.max_new_tokens}-token budget): "
          f"greedy {out['beams_1_s']:.3f} s, num_beams=4 {out['beams_4_s']:.3f} s  [{card}]",
          flush=True)
    return out


def _reset_launches() -> None:
    for fn in LAUNCH_COUNTERS.values():
        fn.launches = 0


def _read_launches() -> dict:
    return {name: fn.launches for name, fn in LAUNCH_COUNTERS.items()}


def detect_check(asr, card) -> dict:
    """Language detection of the 10 s request on the single-request path:
    one log-mel kernel launch, one decoder pass; the code it gives must be
    one the decode prompt takes."""
    from expressive_speech_translation_tpu_torch.pipeline.languages import whisper_lang_index

    x = _speechlike(RES_REQUEST_SECONDS, seed=int(RES_REQUEST_SECONDS))
    _reset_launches()
    t0 = time.perf_counter()
    lang = asr.detect_language(x)
    seconds = time.perf_counter() - t0
    launches = _read_launches()
    whisper_lang_index(lang)
    if launches["log_mel_frames"] != 1 or sum(launches.values()) != 1:
        raise AssertionError(f"detect_language launched {launches}, not one log-mel kernel")
    print(f"  detect_language of the {RES_REQUEST_SECONDS:.0f} s request: {lang!r} in "
          f"{seconds * 1e3:.1f} ms, launches {launches}  [{card}]", flush=True)
    return {"language": lang, "seconds": seconds, "launches": launches}


def _check_request(out, seconds: float, label: str) -> None:
    """A translate_speech result is a [1, T] float32 16 kHz waveform at least
    as long as the input, finite and within [-1, 1]."""
    audio = out["audio"]
    if not (audio.ndim == 2 and audio.shape[0] == 1 and audio.shape[1] >= int(16_000 * seconds)
            and np.isfinite(audio).all() and np.abs(audio).max() <= 1.0):
        raise AssertionError(f"{label}: bad output {audio.shape}")


FRONTEND_SECONDS = 10.0
FRONTEND_UPLOAD_SR = 44_100
FRONTEND_CAP_SECONDS = 300.0     # AudioConfig.max_audio_seconds, the longest upload served
FRONTEND_ATOL = 1e-4             # process_audio on the card against device="cpu", f32
FRONTEND_FPS = 25.0
FRONTEND_FRAME = (360, 640)
FRONTEND_LIPS_S = (2.0, 8.0)     # the lips open and close between these times
# tests/test_face.py's synthetic talking head: a skin-toned wall, a skin
# ellipse, lips, and a dark mouth interior
_WALL, _SKIN, _LIPS, _MOUTH = (226, 176, 140), (195, 130, 105), (185, 70, 85), (20, 10, 10)


def frontend_frames(seed: int = 0) -> list:
    """10 s of 360×640 RGB uint8 video at 25 fps: tests/test_face.py's
    talking head scaled ×2 (a head that sways, sensor noise), whose mouth
    opens and closes every 6 frames between 2 s and 8 s and stays shut
    outside them."""
    h, w = FRONTEND_FRAME
    g = np.random.default_rng(seed)
    yy, xx = np.mgrid[:h, :w]
    lo, hi = (int(s * FRONTEND_FPS) for s in FRONTEND_LIPS_S)
    frames = []
    for t in range(int(FRONTEND_SECONDS * FRONTEND_FPS)):
        f = np.empty((h, w, 3), np.uint8)
        f[:] = _WALL
        f += g.integers(0, 3, f.shape, dtype=np.uint8)
        cy, cx = h // 2, w // 2 + int(12 * np.sin(t / 2.0))
        f[((yy - cy) / 90.0) ** 2 + ((xx - cx) / 60.0) ** 2 < 1.0] = _SKIN
        ly, lx = cy + 48, cx
        f[ly - 6: ly + 6, lx - 18: lx + 18] = _LIPS
        if lo <= t < hi and (t // 6) % 2 == 1:
            f[ly - 4: ly + 4, lx - 12: lx + 12] = _MOUTH
        frames.append(f)
    return frames


def _stereo_upload(seconds: float, sr: int, seed: int) -> np.ndarray:
    """[2, T] at ``sr``: the speech-like left channel and a right channel of
    other tones under another envelope (decorrelated, so the downmix takes
    its side-boosted branch)."""
    t = np.arange(int(sr * seconds)) / sr
    g = np.random.default_rng(seed)
    right = (0.3 * np.sin(2 * np.pi * 330 * t) + 0.15 * np.sin(2 * np.pi * 1320 * t)
             + 0.02 * g.standard_normal(t.shape)) * (0.5 + 0.5 * np.cos(2 * np.pi * 2.0 * t) ** 2)
    return np.stack([_speechlike(seconds, seed, sr), right.astype(np.float32)])


def _quiet_frames(proc, x, sr) -> tuple:
    """The noise gate's quietest-frame selection of ``process_audio(x, sr)`` on
    ``proc``'s device: (sorted frame indices, frame energies on the host)."""
    from expressive_speech_translation_tpu_torch.ops.stft import stft

    y = proc.process_audio(x, orig_sr=sr, denoise=False)
    padded = np.zeros(proc._bucket(len(y), 16_000), np.float32)
    padded[:len(y)] = y
    real, imag = stft(torch.from_numpy(padded).to(proc.device), proc.config.denoise_n_fft,
                      proc.config.denoise_hop)
    energy = torch.sqrt(real * real + imag * imag + 1e-12).sum(-1)
    energy = energy[:1 + len(y) // proc.config.denoise_hop]
    return sorted(torch.topk(-energy, 10).indices.tolist()), energy.cpu().numpy()


def frontend_upload(backend, dev, card, tmp) -> tuple:
    """A 44.1 kHz stereo and a 16 kHz mono PCM16 upload written and read back
    with ``media/wavio.py``, then ``validate_audio_length`` and
    ``process_audio`` on the card (the backend's processor) against the same
    call with ``device="cpu"``. → (rows, (the 44.1 kHz upload read back, its rate))."""
    from expressive_speech_translation_tpu_torch.media.wavio import read_wav, write_wav
    from expressive_speech_translation_tpu_torch.pipeline.audio_processor import AudioProcessor

    proc, cpu = backend.audio_processor, AudioProcessor(backend.config.audio, device="cpu")
    if proc.device.type != dev.type:
        raise AssertionError(f"the backend's audio processor runs on {proc.device}, not {dev}")
    rows, request = [], None
    uploads = (("44.1 kHz stereo", _stereo_upload(FRONTEND_SECONDS, FRONTEND_UPLOAD_SR, 31),
                FRONTEND_UPLOAD_SR),
               ("16 kHz mono", _speechlike(FRONTEND_SECONDS, 32), 16_000))
    for label, audio, sr in uploads:
        path = os.path.join(tmp, f"upload_{sr}.wav")
        write_wav(path, audio, sr)
        x, got_sr = read_wav(path)
        if got_sr != sr or x.shape != audio.shape:
            raise AssertionError(f"{label}: read back {x.shape} at {got_sr} Hz")
        corr = (float(np.sum(x[0] * x[1]) / np.sqrt(np.sum(x[0] ** 2) * np.sum(x[1] ** 2)))
                if x.ndim == 2 else None)
        proc.validate_audio_length(x.shape[-1] / sr)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        y = proc.process_audio(x, orig_sr=sr)
        seconds = time.perf_counter() - t0
        want = cpu.process_audio(x, orig_sr=sr)
        err = float(np.abs(y - want).max()) if y.shape == want.shape else math.inf
        # the same without the gate (the resample's share of the difference),
        # and the gate's quietest-frame selection on both
        err_resample = float(np.abs(proc.process_audio(x, orig_sr=sr, denoise=False)
                                    - cpu.process_audio(x, orig_sr=sr, denoise=False)).max())
        (quiet, e_card), (quiet_cpu, e_cpu) = _quiet_frames(proc, x, sr), _quiet_frames(cpu, x, sr)
        energy_rel = float(np.abs(e_card - e_cpu).max() / np.abs(e_cpu).max())
        rows.append({"upload": label, "sr": sr, "channels": 1 if x.ndim == 1 else x.shape[0],
                     "channel_corr": corr, "out_samples": len(y), "first_call_s": seconds,
                     "max_abs_err_vs_cpu": err, "max_abs_err_vs_cpu_no_gate": err_resample,
                     "quiet_frames": quiet, "quiet_frames_cpu": quiet_cpu,
                     "frame_energy_max_rel_diff": energy_rel,
                     "peak": float(np.abs(want).max())})
        print(f"  {label} upload ({FRONTEND_SECONDS:.0f} s PCM16 through wavio"
              + (f", channel correlation {corr:.4f}" if corr is not None else "")
              + f"): process_audio on the card {len(y)} samples, first call {seconds:.3f} s; "
              f"against device='cpu' max |diff| {err:.3e} (limit {FRONTEND_ATOL}; without the "
              f"gate {err_resample:.3e}; quietest frames "
              f"{'equal' if quiet == quiet_cpu else f'{quiet} against {quiet_cpu}'}, frame "
              f"energies within {energy_rel:.1e})  [{card}]",
              flush=True)
        if not (np.isfinite(y).all() and y.dtype == np.float32
                and len(y) == int(FRONTEND_SECONDS * 16_000) and err <= FRONTEND_ATOL):
            raise AssertionError(f"{label}: process_audio on the card {y.shape} {y.dtype}, "
                                 f"{err} from the CPU's (limit {FRONTEND_ATOL})")
        if corr is not None and corr > 0.5:
            raise AssertionError(f"{label}: channel correlation {corr} takes the plain average")
        request = request or (x, sr)
    return rows, request


def frontend_timing(backend, card) -> dict:
    """``process_audio`` of a 44.1 kHz stereo upload at the 10 s bucket and at
    the 300 s cap, timed on the host clock around a synchronised card (the
    first call apart, then the best of three), with the peak device memory
    above what was allocated before."""
    proc = backend.audio_processor
    out = {}
    for seconds in (FRONTEND_SECONDS, FRONTEND_CAP_SECONDS):
        x = _stereo_upload(seconds, FRONTEND_UPLOAD_SR, 33)
        torch.cuda.synchronize()
        base = torch.cuda.memory_allocated()
        torch.cuda.reset_peak_memory_stats()
        runs = []
        for _ in range(4):
            t0 = time.perf_counter()
            y = proc.process_audio(x, orig_sr=FRONTEND_UPLOAD_SR)
            torch.cuda.synchronize()
            runs.append(time.perf_counter() - t0)
        peak = (torch.cuda.max_memory_allocated() - base) / 2**20
        if not (np.isfinite(y).all() and len(y) == int(seconds * 16_000)):
            raise AssertionError(f"process_audio of {seconds} s: {y.shape}")
        out[f"{seconds:.0f}s"] = {"first_s": runs[0], "best_s": min(runs[1:]), "runs_s": runs,
                                  "peak_mib_above_resident": peak}
        print(f"  process_audio of {seconds:.0f} s at 44.1 kHz stereo: first {runs[0] * 1e3:.1f} ms, "
              f"best of 3 {min(runs[1:]) * 1e3:.1f} ms ({', '.join(f'{r * 1e3:.1f}' for r in runs)})"
              f", peak {peak:.1f} MiB above the resident engines  [{card}]", flush=True)
    return out


@contextlib.contextmanager
def _timing_calls(owner, name: str, calls: list):
    """For the block's duration ``owner.name`` calls through, appending
    (seconds, result) of each call to ``calls``."""
    fn = getattr(owner, name)

    def timed(*args, **kwargs):
        t0 = time.perf_counter()
        out = fn(*args, **kwargs)
        calls.append((time.perf_counter() - t0, out))
        return out

    setattr(owner, name, timed)
    try:
        yield calls
    finally:
        setattr(owner, name, fn)


def frontend_phase(dev, report, card, backend, e2e):
    """The audio front end and video-guided ``translate_speech`` on the e2e
    phase's backend: a 44.1 kHz stereo and a 16 kHz mono upload through
    wavio, ``validate_audio_length`` and ``process_audio`` on the card
    against ``device="cpu"``; ``process_audio`` timed at 10 s and at the
    300 s cap; then, with the launch counters set to 0, the 10 s upload's
    ``process_audio`` and ``translate_speech`` with 250 frames of 360×640
    video at 25 fps (cloning on): the visual branch must run (speech
    segments found, ``distribute_audio`` called), log-mel launch once and
    the resblock twice."""
    import tempfile

    from expressive_speech_translation_tpu_torch.pipeline import visual_speech_detector as vsd

    print(f"== frontend: AudioProcessor on the card, then a {FRONTEND_SECONDS:.0f} s request "
          f"with {FRONTEND_FRAME[0]}x{FRONTEND_FRAME[1]} video frames at {FRONTEND_FPS:.0f} fps",
          flush=True)
    t_phase = time.perf_counter()
    with tempfile.TemporaryDirectory() as tmp:
        uploads, (upload, sr) = frontend_upload(backend, dev, card, tmp)
    timing = frontend_timing(backend, card)
    t0 = time.perf_counter()
    frames = frontend_frames()
    frames_s = time.perf_counter() - t0

    _reset_launches()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    processed = backend.audio_processor.process_audio(upload, orig_sr=sr)
    detect, mapped = [], []
    with _timing_calls(vsd.VisualSpeechDetector, "detect_speech_segments", detect), \
            _timing_calls(backend.visual_mapper, "distribute_audio", mapped):
        out = backend.translate_speech(processed, "eng", "fra", original_video_frames=frames,
                                       video_fps=FRONTEND_FPS)
    wall = time.perf_counter() - t0
    launches = _read_launches()
    _check_request(out, FRONTEND_SECONDS, "frontend request")
    stages = {k: v["seconds"] for k, v in out["stage_summary"].items()}
    segments = [(s.start, s.end) for s in detect[0][1]] if detect else []
    native = next(r for r in e2e["requests"] if r["audio_s"] == FRONTEND_SECONDS)
    print(f"  {FRONTEND_SECONDS:.0f} s upload, process_audio + translate_speech with frames: wall "
          f"{wall:.3f} s  " + "  ".join(f"{k} {v:.3f} s" for k, v in stages.items())
          + f"  (audio only, e2e phase: wall {native['wall_s']:.3f} s, post "
          f"{native['stages_s']['post']:.3f} s)  [{card}]", flush=True)
    print(f"    visual branch: detector {detect[0][0] if detect else math.nan:.3f} s, segments "
          f"{[(round(a, 3), round(b, 3)) for a, b in segments]}, distribute_audio "
          f"{mapped[0][0] if mapped else math.nan:.3f} s; frames built in {frames_s:.1f} s "
          f"(host)", flush=True)
    print(f"    launches over process_audio and the request: {launches}", flush=True)
    if len(detect) != 1 or not segments or len(mapped) != 1:
        raise AssertionError(f"the visual branch did not run: detector calls {len(detect)}, "
                             f"segments {segments}, distribute_audio calls {len(mapped)}")
    narrow = _narrow_stages(backend)
    if launches["log_mel_frames"] != 1 or launches["fused_resblock_stage"] != narrow:
        raise AssertionError(f"frontend request launched {launches}, not log-mel 1 and "
                             f"resblock {narrow}")
    front = {"uploads": uploads, "timing": timing, "wall_s": wall, "stages_s": stages,
             "detector_s": detect[0][0], "distribute_s": mapped[0][0], "segments": segments,
             "frames_build_s": frames_s, "launches": launches,
             "out_samples": int(out["audio"].shape[1])}
    front["seconds"] = time.perf_counter() - t_phase
    print(f"  frontend phase {front['seconds']:.1f} s", flush=True)
    report["frontend"] = front
    return front


SERVE_SECONDS = FRONTEND_SECONDS
SERVE_TEXT = "The weather is fine today."
_SSE_PREFIX = "data: "


class SmokeVideoIO:
    """The serve phase's test VideoIO: the upload's audio (its channels
    averaged, at the upload's rate), the frontend phase's frames at 25 fps, a
    lip-sync that raises (so the route falls back to the mux), and a mux that
    writes a minimal ISO-BMFF file (an ftyp box, then an mdat box holding the
    dubbed audio as PCM16), which the route watermarks."""

    def __init__(self, audio: np.ndarray, sr: int, frames: list, fps: float = FRONTEND_FPS):
        self.audio = (audio.mean(0) if audio.ndim == 2 else audio).astype(np.float32)
        self.sr, self.video_frames, self.fps = sr, frames, fps

    def extract_audio(self, video_path):
        return self.audio, self.sr

    def frames(self, video_path):
        return self.video_frames, self.fps

    def lipsync(self, video_path, audio, sr, out_path):
        raise RuntimeError("no lip-sync model in the smoke")

    def mux(self, video_path, audio, sr, out_path):
        pcm = (np.clip(audio, -1.0, 1.0) * 32767.0).astype("<i2").tobytes()
        ftyp = b"\x00\x00\x00\x18ftypisom\x00\x00\x02\x00isomiso2"
        with open(out_path, "wb") as f:
            f.write(ftyp + (8 + len(pcm)).to_bytes(4, "big") + b"mdat" + pcm)


def _sse(lines) -> list:
    return [json.loads(line[len(_SSE_PREFIX):]) for line in lines if line.startswith(_SSE_PREFIX)]


@contextlib.contextmanager
def _http_server(app):
    """``app`` served by werkzeug on a free localhost port, in a thread →
    ``request(path, fields, files, body, stream)`` over real HTTP (urllib):
    (status, body bytes or SSE frames, seconds to the first audio frame of a
    stream). The server is shut down when the block ends."""
    import urllib.error
    import urllib.request

    from werkzeug.datastructures import FileStorage
    from werkzeug.serving import make_server
    from werkzeug.test import encode_multipart

    logging.getLogger("werkzeug").setLevel(logging.WARNING)    # no line a request
    server = make_server("127.0.0.1", 0, app, threaded=True)
    thread = threading.Thread(target=server.serve_forever, daemon=True)
    thread.start()
    base = f"http://127.0.0.1:{server.server_port}"

    def request(path, fields=None, files=None, body=None, stream=False):
        headers, data = {}, None
        if files is not None:
            boundary, data = encode_multipart({**fields, **{
                k: FileStorage(io.BytesIO(raw), filename=name) for k, (raw, name) in files.items()}})
            headers["Content-Type"] = f"multipart/form-data; boundary={boundary}"
        elif body is not None:
            data, headers["Content-Type"] = json.dumps(body).encode(), "application/json"
        t0 = time.perf_counter()
        req = urllib.request.Request(base + path, data=data, headers=headers,
                                     method="GET" if data is None else "POST")
        try:
            with urllib.request.urlopen(req, timeout=900) as resp:
                if not stream:
                    return resp.status, resp.read(), None
                lines, first = [], None
                for raw in resp:
                    line = raw.decode().rstrip("\n")
                    if first is None and '"audio_chunk"' in line:
                        first = time.perf_counter() - t0
                    lines.append(line)
                return resp.status, _sse(lines), first
        except urllib.error.HTTPError as e:
            return e.code, e.read(), None

    request.url = base
    try:
        yield request
    finally:
        server.shutdown()
        server.server_close()
        thread.join(timeout=60)


def _serve_http(manager, vio, wav, video, device, tmp, run) -> None:
    """The routes through the port's app served by werkzeug on a free
    localhost port, in a thread, with real HTTP requests from urllib."""
    from expressive_speech_translation_tpu_torch.core.config import AppConfig
    from expressive_speech_translation_tpu_torch.serve.app import create_app

    app = create_app(manager, AppConfig(temp_dir=tmp), device=device, video_io=vio)
    with _http_server(app) as request:
        run("translate", lambda: request(
            "/translate", {"target_language": "fra", "source_language": "eng"},
            {"file": (wav, "upload.wav")}))
        run("stream", lambda: request(
            "/translate", {"target_language": "fra", "stream": "true"},
            {"file": (wav, "upload.wav")}, stream=True))
        run("text", lambda: request("/translate-text", body={
            "text": SERVE_TEXT, "source_language": "eng", "target_language": "fra",
            "synthesize": True}))
        run("video", lambda: request("/process-video", {"target_language": "fra"},
                                     {"file": (video, "clip.mp4")}, stream=True))
        run("health", lambda: request("/health/model"))
        run("backends", lambda: request("/available-backends"))


def _serve_direct(manager, vio, wav, video, device, tmp, run) -> None:
    """The calls each route makes under the HTTP layer, made directly: the
    WAV read, ``validate_audio_length``, ``process_audio``,
    ``translate_speech`` and the WAV encode; the stream framed with
    ``generate_progress_event``; ``translate_text``; ``process_video``; the
    health payload's parts. Each gives what its route's body would."""
    from expressive_speech_translation_tpu_torch.media.wavio import read_wav_bytes, wav_bytes
    from expressive_speech_translation_tpu_torch.serve.resource_monitor import (
        device_memory_stats, process_rss_bytes)
    from expressive_speech_translation_tpu_torch.serve.video import (VideoProcessor,
                                                                     generate_progress_event)
    from expressive_speech_translation_tpu_torch.pipeline.audio_processor import AudioProcessor

    proc = AudioProcessor(device=device)
    backend = manager.get_backend()

    def b64_wav(audio):
        return base64.b64encode(wav_bytes(audio, 16_000)).decode()

    def processed():
        x, sr = read_wav_bytes(wav, label="upload.wav")
        proc.validate_audio_length(x.shape[-1] / sr)
        return proc.process_audio(x, orig_sr=sr)

    def translate():
        out = backend.translate_speech(processed(), "eng", "fra")
        return 200, json.dumps({"audio": b64_wav(out["audio"][0]),
                                "transcripts": out["transcripts"],
                                "weights": backend.weights_info()}).encode(), None

    def stream():
        t0, first, frames = time.perf_counter(), None, []
        for ev in backend.translate_speech_streaming(processed(), "eng", "fra"):
            if ev["type"] == "transcripts":
                frame = generate_progress_event(50, "Translating speech", transcripts={
                    "source": ev["source"], "target": ev["target"]})
            else:
                pcm = (np.clip(ev["chunk"], -1.0, 1.0) * 32767.0).astype("<i2").tobytes()
                frame = generate_progress_event(75, "Synthesizing speech",
                                                audio_chunk=base64.b64encode(pcm).decode(),
                                                sample_rate=ev["sample_rate"])
                first = first or time.perf_counter() - t0
            frames.append(frame)
        frames.append(generate_progress_event(100, "Complete", done=True))
        return 200, _sse("".join(frames).split("\n\n")), first

    def text():
        out = backend.translate_text(SERVE_TEXT, "eng", "fra", synthesize=True)
        return 200, json.dumps({"source_text": out["source_text"], "target_text": out["target_text"],
                                "audio": b64_wav(out["audio"][0])}).encode(), None

    def video_route():
        frames = VideoProcessor(vio, temp_root=tmp, audio_processor=proc).process_video(
            video, backend, "eng", "fra", filename="clip.mp4")
        return 200, _sse("".join(frames).split("\n\n")), None

    def health():
        return 200, json.dumps({
            "healthy": backend.initialized, "weights": backend.weights_info(),
            "placement": backend.placement_info(), "decode": backend.decode_info(),
            "process_rss_mb": round(process_rss_bytes() / 1e6, 1),
            "device_memory": device_memory_stats()}).encode(), None

    def backends():
        return 200, json.dumps({"backends": manager.available_backends(),
                                "default": manager.default_backend,
                                "weights": manager.backend_weights(),
                                "decode": manager.backend_decode()}).encode(), None

    for name, fn in (("translate", translate), ("stream", stream), ("text", text),
                     ("video", video_route), ("health", health), ("backends", backends)):
        run(name, fn)


def serve_routes(manager, backend, upload, frames, device, *, http: bool,
                 seconds: float = SERVE_SECONDS, tmp: str) -> dict:
    """Drive /translate (offline and streamed), /translate-text with
    synthesis, /process-video over :class:`SmokeVideoIO`, /health/model and
    /available-backends: through the port's app over HTTP (``http=True``),
    or through the calls each route makes. ``upload`` is a [2, T] upload at
    44.1 kHz of ``seconds``. → per route: status, body (JSON, or SSE frames),
    wall seconds, the ``translate_speech`` seconds inside it, the launch
    counts, and for the streams the seconds to the first audio frame."""
    from expressive_speech_translation_tpu_torch.media.wavio import wav_bytes

    wav = wav_bytes(upload, FRONTEND_UPLOAD_SR)
    video = b"\x00\x00\x00\x18ftypisom\x00\x00\x02\x00isomiso2" + bytes(4096)
    vio = SmokeVideoIO(upload, FRONTEND_UPLOAD_SR, frames)
    out = {"http": http}

    def run(name, fn):
        translated, mapped, chunks = [], [], []
        if torch.device(device).type == "cuda":
            torch.cuda.synchronize()
        _reset_launches()
        with _timing_calls(backend, "translate_speech", translated), \
                _timing_calls(backend.visual_mapper, "distribute_audio", mapped), \
                _counting_stream_chunks(chunks):
            t0 = time.perf_counter()
            status, body, first = fn()
            wall = time.perf_counter() - t0
        out[name] = {"status": status, "wall_s": wall, "first_audio_s": first,
                     "translate_s": translated[0][0] if translated else None,
                     "launches": _read_launches(), "tts_chunks": len(chunks),
                     "distribute_calls": len(mapped),
                     "body": body if isinstance(body, list) else json.loads(body)}

    (_serve_http if http else _serve_direct)(manager, vio, wav, video, device, tmp, run)
    return out


def _decoded_wav(b64: str) -> np.ndarray:
    from expressive_speech_translation_tpu_torch.media.wavio import read_wav_bytes

    x, sr = read_wav_bytes(base64.b64decode(b64), label="response")
    if sr != 16_000:
        raise AssertionError(f"a response's WAV is at {sr} Hz")
    return x


def check_serve_routes(out: dict, *, seconds: float, weights: str, placement: dict) -> None:
    """What both branches must give: 200s; the offline and video audio
    decodes, finite and at least ``seconds`` of 16 kHz; the stream a
    transcripts frame, an audio frame and ``done``; the video's last frame
    complete, its MP4 watermarked, the visual branch run; the health
    payload healthy with ``weights`` and ``placement``."""
    from expressive_speech_translation_tpu_torch.pipeline.watermark import WaterMark

    bad = {k: v["status"] for k, v in out.items() if k != "http" and v["status"] != 200}
    if bad:
        raise AssertionError(f"serve: routes answered {bad}: "
                             + str({k: str(out[k]["body"])[:300] for k in bad}))
    n = int(seconds * 16_000)
    body = out["translate"]["body"]
    audio = _decoded_wav(body["audio"])
    if not (audio.ndim == 1 and len(audio) >= n and np.isfinite(audio).all()):
        raise AssertionError(f"serve /translate: audio {audio.shape}")
    if body["weights"] != weights or set(body["transcripts"]) != {"source", "target"}:
        raise AssertionError(f"serve /translate: weights {body['weights']!r}, "
                             f"transcripts {body['transcripts']}")
    frames = out["stream"]["body"]
    pcm = [np.frombuffer(base64.b64decode(f["audio_chunk"]), "<i2") for f in frames
           if "audio_chunk" in f]
    if not (any("transcripts" in f for f in frames) and pcm and frames[-1].get("done") is True
            and sum(map(len, pcm)) > 0 and all(f.get("sample_rate", 16_000) == 16_000
                                               for f in frames)):
        raise AssertionError(f"serve stream: frames {[sorted(f) for f in frames][:8]}")
    text = out["text"]["body"]
    speech = _decoded_wav(text["audio"])
    if not (text["source_text"] == SERVE_TEXT and len(speech) and np.isfinite(speech).all()):
        raise AssertionError(f"serve /translate-text: {text.get('target_text')!r}, "
                             f"{speech.shape}")
    frames = out["video"]["body"]
    final = frames[-1]
    if final.get("phase") != "complete":
        raise AssertionError(f"serve /process-video ended with {final}")
    mp4 = base64.b64decode(final["result"]["video"])
    size = int.from_bytes(mp4[24:28], "big")
    dubbed = np.frombuffer(mp4[32:24 + size], "<i2")
    with tempfile.TemporaryDirectory() as tmp:
        path = os.path.join(tmp, "delivered.mp4")
        with open(path, "wb") as f:
            f.write(mp4)
        marked = WaterMark.verify(path)
    if not (mp4[4:8] == b"ftyp" and mp4[28:32] == b"mdat" and len(dubbed) >= n and marked):
        raise AssertionError(f"serve /process-video: {len(mp4)} bytes, {len(dubbed)} samples, "
                             f"watermark {marked}")
    if [f["progress"] for f in frames] != [10, 20, 30, 55, 60, 75, 90, 100]:
        raise AssertionError(f"serve /process-video progress {[f['progress'] for f in frames]}")
    if out["video"]["distribute_calls"] != 1:
        raise AssertionError("serve /process-video: the visual branch did not run "
                             f"({out['video']['distribute_calls']} distribute_audio calls)")
    health = out["health"]["body"]
    if not (health["healthy"] is True and health["weights"] == weights
            and health["placement"] == placement):
        raise AssertionError(f"serve /health/model: {health}")
    if out["backends"]["body"]["weights"] != {"cascaded": weights}:
        raise AssertionError(f"serve /available-backends: {out['backends']['body']}")


def serve_phase(dev, report, card, backend, e2e, front):
    """The HTTP server over the e2e phase's backend, registered as the
    default of a ``TranslationManager``: with werkzeug, ``create_app``
    served by ``make_server`` in a thread and real HTTP requests; without
    it, the calls each route makes. /translate and /process-video each
    launch log-mel once and the resblock twice; the streamed /translate
    log-mel once and the resblock twice a TTS chunk."""
    import importlib.util

    from expressive_speech_translation_tpu_torch.pipeline.backend import TranslationManager

    http = importlib.util.find_spec("werkzeug") is not None
    print(f"== serve: werkzeug {'imports' if http else 'is missing'}; "
          + ("the port's app served over HTTP on localhost" if http else
             "the HTTP layer itself is not run on the card: the calls each route makes are "
             "driven directly") + f", a {SERVE_SECONDS:.0f} s 44.1 kHz stereo upload", flush=True)
    t_phase = time.perf_counter()
    manager = TranslationManager()
    manager.register_backend("cascaded", backend, is_default=True)
    upload = _stereo_upload(SERVE_SECONDS, FRONTEND_UPLOAD_SR, 41)
    frames = frontend_frames()
    torch.cuda.synchronize()
    base = torch.cuda.memory_allocated()
    torch.cuda.reset_peak_memory_stats()
    with tempfile.TemporaryDirectory() as tmp:
        out = serve_routes(manager, backend, upload, frames, dev, http=http, tmp=tmp)
    peak = (torch.cuda.max_memory_allocated() - base) / 2**30
    native = next(r for r in e2e["requests"] if r["audio_s"] == SERVE_SECONDS)
    for name, row in out.items():
        if name == "http":
            continue
        inner = row["translate_s"]
        print(f"  {name:9s} {'HTTP' if http else 'direct'}: status {row['status']}, wall "
              f"{row['wall_s']:.3f} s"
              + (f", translate_speech {inner:.3f} s inside (the rest {row['wall_s'] - inner:.3f} s)"
                 if inner is not None else "")
              + (f", first audio frame at {row['first_audio_s']:.3f} s"
                 if row["first_audio_s"] is not None else "")
              + (f", launches {row['launches']}" if any(row["launches"].values()) else "")
              + (f", {row['tts_chunks']} TTS chunks" if row["tts_chunks"] else "")
              + f"  [{card}]", flush=True)
    print(f"    peak {peak:.2f} GiB above the resident engines; the e2e phase's {SERVE_SECONDS:.0f} s "
          f"request {native['wall_s']:.3f} s, the frontend's video request "
          f"{front['wall_s']:.3f} s", flush=True)
    check_serve_routes(out, seconds=SERVE_SECONDS, weights="random",
                       placement={"asr": [0], "nmt": [0], "tts": [0]})
    narrow = _narrow_stages(backend)
    for name in ("translate", "video"):
        got = out[name]["launches"]
        if got["log_mel_frames"] != 1 or got["fused_resblock_stage"] != narrow:
            raise AssertionError(f"serve {name}: launched {got}, not log-mel 1 and resblock "
                                 f"{narrow}")
    got = out["stream"]["launches"]
    if (got["log_mel_frames"] != 1 or not out["stream"]["tts_chunks"]
            or got["fused_resblock_stage"] != narrow * out["stream"]["tts_chunks"]):
        raise AssertionError(f"serve stream: launched {got} for {out['stream']['tts_chunks']} "
                             f"TTS chunks")
    serve = {"http": http, "peak_gib_above_resident": peak,
             "routes": {k: {f: v for f, v in row.items() if f != "body"}
                        for k, row in out.items() if k != "http"},
             "health": out["health"]["body"],
             "launches": {k: sum(row["launches"][k] for name, row in out.items()
                                 if name != "http") for k in LAUNCH_COUNTERS}}
    serve["seconds"] = time.perf_counter() - t_phase
    print(f"  serve phase {serve['seconds']:.1f} s", flush=True)
    report["serve"] = serve
    return serve


LIPSYNC_DUB_SECONDS = 10.0     # the e2e request whose dubbed audio the lip-sync renders against
LIPSYNC_DUB_SR = 24_000        # the dub handed to the lip-sync fn at 24 kHz, so its resample runs
LIPSYNC_F32_RTOL = 1e-3        # lipsync_frames f32 on the card against device="cpu": max |diff| / peak
LIPSYNC_BAKE_FRAMES = 25       # frames rendered from the bake


@contextlib.contextmanager
def _synced_timing(owner, name: str, calls: list):
    """:func:`_timing_calls` with the card synchronised before and after
    each call, so the seconds are the call's own device work too."""
    fn = getattr(owner, name)

    def timed(*args, **kwargs):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        out = fn(*args, **kwargs)
        torch.cuda.synchronize()
        calls.append((time.perf_counter() - t0, out))
        return out

    setattr(owner, name, timed)
    try:
        yield calls
    finally:
        setattr(owner, name, fn)


def lipsync_render(fn, frames: np.ndarray, dub: np.ndarray, sr: int, card) -> tuple:
    """One ``musetalk_lipsync_fn`` call on the frames against the dub, the
    counters at 0 just before it: seconds split into face boxes (host), the
    audio condition, the crops, ``lipsync_frames`` and the blend; frames per
    second; peak memory above what is resident. → (rendered frames, boxes,
    figures)."""
    from expressive_speech_translation_tpu_torch.models import musetalk as mtm
    from expressive_speech_translation_tpu_torch.pipeline import musetalk_pipeline as mtp

    pipe = fn.pipeline
    boxes, cond, lip, blend, crops = [], [], [], [], []
    torch.cuda.synchronize()
    base = torch.cuda.memory_allocated()
    torch.cuda.reset_peak_memory_stats()
    _reset_launches()
    t0 = time.perf_counter()
    with _synced_timing(mtp, "per_frame_face_boxes", boxes), \
            _synced_timing(pipe, "audio_feature_fn", cond), \
            _synced_timing(pipe, "crops", crops), \
            _synced_timing(mtm, "lipsync_frames", lip), \
            _timing_calls(mtp, "blend_face_np", blend):
        out = fn(frames, FRONTEND_FPS, dub, sr)
    wall = time.perf_counter() - t0
    launches = _read_launches()
    peak = (torch.cuda.max_memory_allocated() - base) / 2**30
    split = {"face_boxes_s": boxes[0][0], "condition_s": cond[0][0], "crops_s": crops[0][0],
             "lipsync_frames_s": lip[0][0], "blend_s": sum(c[0] for c in blend)}
    split["rest_s"] = wall - sum(split.values())
    figures = {"frames": len(frames), "wall_s": wall, "fps": len(frames) / wall, **split,
               "peak_gib_above_resident": peak, "launches": launches,
               "condition_shape": list(cond[0][1].shape)}
    print(f"  render of {len(frames)} frames {frames.shape[1]}x{frames.shape[2]}: {wall:.3f} s, "
          f"{len(frames) / wall:.2f} frames/s: " + ", ".join(
              f"{k[:-2]} {v:.3f} s" for k, v in split.items())
          + f"; peak {peak:.2f} GiB above the resident; launches {launches}  [{card}]", flush=True)
    boxes = [mtp.clamp_box(b, frames.shape[1], frames.shape[2]) for b in boxes[0][1]]
    return out, boxes, figures


def check_lipsync_output(frames: np.ndarray, out: np.ndarray, boxes) -> dict:
    """The render's frames: the input's shape and dtype; outside each face
    box equal; inside it, above the jaw line (the blend's alpha is 0 there),
    within one level (the uint8 → float32 → uint8 round trip); the jaw
    region changed in every frame."""
    if out.shape != frames.shape or out.dtype != np.uint8:
        raise AssertionError(f"lip-sync output {out.shape} {out.dtype}, not {frames.shape} uint8")
    jaw_change = []
    for i, (y0, x0, y1, x1) in enumerate(boxes):
        outside = np.ones(frames.shape[1:3], bool)
        outside[y0:y1, x0:x1] = False
        if not np.array_equal(out[i][outside], frames[i][outside]):
            raise AssertionError(f"lip-sync frame {i}: pixels outside the box {boxes[i]} changed")
        jaw = y0 + int(np.floor((y1 - y0) * 0.45)) + 1          # the first row with alpha > 0
        above = np.abs(out[i, y0:jaw, x0:x1].astype(int) - frames[i, y0:jaw, x0:x1].astype(int))
        if above.max(initial=0) > 1:
            raise AssertionError(f"lip-sync frame {i}: above the jaw line changed by "
                                 f"{above.max()} levels")
        jaw_change.append(float(np.abs(out[i, jaw:y1, x0:x1].astype(int)
                                       - frames[i, jaw:y1, x0:x1].astype(int)).mean()))
    if min(jaw_change) <= 0.0:
        raise AssertionError(f"lip-sync: the jaw region of frame {int(np.argmin(jaw_change))} "
                             "is unchanged")
    return {"jaw_mean_abs_change": [min(jaw_change), float(np.mean(jaw_change)),
                                    max(jaw_change)]}


def lipsync_f32_check(fn, frames, boxes, dub16, dev, card) -> dict:
    """One batch of 2 crops through ``lipsync_frames`` in f32 on the card
    and with ``device="cpu"`` on the same f32 weights (the pipeline's seed)
    and the same condition: the largest difference relative to the output's
    peak, held to LIPSYNC_F32_RTOL."""
    from expressive_speech_translation_tpu_torch.models import musetalk as mtm

    pipe = fn.pipeline
    params = mtm.init_musetalk(7, pipe.cfg, dev)             # MuseTalkPipeline's random seed
    crops = pipe.crops(frames[:2], boxes[:2]).float()
    windows = mtm.whisper_chunks_for_video(pipe.audio_feature_fn(dub16), len(frames),
                                           FRONTEND_FPS, ctx=pipe.cfg.audio_ctx)[:2].float()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    with torch.inference_mode():
        got = mtm.lipsync_frames(params, pipe.cfg, crops, windows, batch_size=2).cpu()
        got_latents = mtm.vae_encode(params["vae"], pipe.cfg, crops).cpu()
    card_s = time.perf_counter() - t0
    host = _tree_to(params, "cpu")
    del params
    t0 = time.perf_counter()
    with torch.inference_mode():
        want = mtm.lipsync_frames(host, pipe.cfg, crops.cpu(), windows.cpu(), batch_size=2)
        want_latents = mtm.vae_encode(host["vae"], pipe.cfg, crops.cpu())
    cpu_s = time.perf_counter() - t0
    err = float((got - want).abs().max())
    peak = float(want.abs().max())
    # the encoder alone, to say where along the chain the two devices part
    enc_rel = float((got_latents - want_latents).abs().max() / want_latents.abs().max())
    print(f"  lipsync_frames f32, 2 crops, card against device=\"cpu\": max |diff| {err:.3e}, "
          f"peak {peak:.3f}, ratio {err / peak:.3e} (tolerance {LIPSYNC_F32_RTOL:g}; the VAE "
          f"encoder alone {enc_rel:.3e}); card {card_s:.3f} s, CPU {cpu_s:.1f} s  [{card}]",
          flush=True)
    if not (np.isfinite(err) and err <= LIPSYNC_F32_RTOL * peak):
        raise AssertionError(f"lipsync_frames f32 on the card differs from the CPU by {err:.3e} "
                             f"(peak {peak:.3f})")
    return {"max_abs_err": err, "peak": peak, "rel": err / peak, "vae_encode_rel": enc_rel,
            "card_s": card_s, "cpu_s": cpu_s}


def _tree_to(tree, device):
    if isinstance(tree, dict):
        return {k: _tree_to(v, device) for k, v in tree.items()}
    if isinstance(tree, list):
        return [_tree_to(v, device) for v in tree]
    return tree.to(device)


class LipsyncVideoIO(SmokeVideoIO):
    """The serve phase's test VideoIO with a real lip-sync: ``lipsync`` runs
    ``lipsync_fn`` on the frames and writes an ftyp box, an mdat box of the
    audio as PCM16 and a ``rndr`` box holding, as JSON, what was rendered
    (frame count, shape, fps, frames changed), which the route watermarks."""

    def __init__(self, audio, sr, frames, lipsync_fn):
        super().__init__(audio, sr, frames)
        self.lipsync_fn = lipsync_fn

    def lipsync(self, video_path, audio, sr, out_path):
        frames = np.stack(self.video_frames)
        rendered = self.lipsync_fn(frames, self.fps, audio, sr)
        pcm = (np.clip(audio, -1.0, 1.0) * 32767.0).astype("<i2").tobytes()
        info = json.dumps({"frames": len(rendered), "shape": list(rendered.shape[1:]),
                           "fps": self.fps, "sr": sr,
                           "changed": int((rendered != frames).any(axis=(1, 2, 3)).sum())}).encode()
        ftyp = b"\x00\x00\x00\x18ftypisom\x00\x00\x02\x00isomiso2"
        with open(out_path, "wb") as f:
            f.write(ftyp + (8 + len(pcm)).to_bytes(4, "big") + b"mdat" + pcm
                    + (8 + len(info)).to_bytes(4, "big") + b"rndr" + info)


def _read_rndr(mp4: bytes) -> tuple:
    """(PCM16 audio, the rndr box's JSON) of a LipsyncVideoIO output."""
    size = int.from_bytes(mp4[24:28], "big")
    audio = np.frombuffer(mp4[32:24 + size], "<i2")
    at = 24 + size
    n = int.from_bytes(mp4[at:at + 4], "big")
    if mp4[at + 4:at + 8] != b"rndr":
        raise AssertionError(f"no rndr box after the mdat box: {mp4[at:at + 8]!r}")
    return audio, json.loads(mp4[at + 8:at + n])


def lipsync_route(manager, backend, fn, frames, upload, dev, tmp, libav: bool) -> dict:
    """``/process-video`` with ``apply_lip_sync=true`` through the port's
    app served over HTTP on localhost (werkzeug is on the card: the serve
    phase checks): through the port's shim when ``libav`` (an MP4 encoded by
    ``native.encode_video``, decoded back after), else over
    :class:`LipsyncVideoIO`; with the shim, a FLAC upload to /translate as
    well. The counters are set to 0 just before each request."""
    from expressive_speech_translation_tpu_torch.core.config import AppConfig
    from expressive_speech_translation_tpu_torch.media import native
    from expressive_speech_translation_tpu_torch.serve.app import create_app

    mono = upload.mean(0).astype(np.float32)
    renders, translated, mapped = [], [], []

    def timed_fn(*args):
        t0 = time.perf_counter()
        out = fn(*args)
        renders.append(time.perf_counter() - t0)
        return out

    if libav:
        src = os.path.join(tmp, "clip.mp4")
        native.encode_video(src, np.stack(frames), FRONTEND_FPS, audio=mono,
                            audio_rate=FRONTEND_UPLOAD_SR)
        vio = native.NativeVideoIO(lipsync_fn=timed_fn)
        video = open(src, "rb").read()
    else:
        vio = LipsyncVideoIO(upload, FRONTEND_UPLOAD_SR, frames, timed_fn)
        video = b"\x00\x00\x00\x18ftypisom\x00\x00\x02\x00isomiso2" + bytes(4096)
    fields = {"target_language": "fra", "source_language": "eng", "apply_lip_sync": "true"}
    out = {"shim": libav}

    def run(name, call):
        torch.cuda.synchronize()
        _reset_launches()
        with _timing_calls(backend, "translate_speech", translated), \
                _timing_calls(backend.visual_mapper, "distribute_audio", mapped):
            t0 = time.perf_counter()
            status, body, _ = call()
            wall = time.perf_counter() - t0
        out[name] = {"status": status, "wall_s": wall, "launches": _read_launches(),
                     "translate_s": translated[-1][0] if translated else None, "body": body}

    app = create_app(manager, AppConfig(temp_dir=tmp), device=dev, video_io=vio)
    with _http_server(app) as request:
        run("video", lambda: request("/process-video", fields, {"file": (video, "clip.mp4")},
                                     stream=True))
        if libav:
            flac = os.path.join(tmp, "upload.flac")
            native.encode_audio(flac, mono, FRONTEND_UPLOAD_SR)
            run("flac", lambda: request("/translate", fields,
                                        {"file": (open(flac, "rb").read(), "upload.flac")}))
    out["lipsync_s"] = renders
    out["distribute_calls"] = len(mapped)
    return out


def check_lipsync_route(out: dict, frames, narrow: int, card) -> dict:
    """The route's MP4: the final frame complete and watermarked, lip-sync
    run (no 75 tick: the mux fallback did not run), the visual branch run;
    frame count, fps and audio length against the dub; log-mel twice (ASR
    and the condition), the resblock ``narrow`` times; the FLAC upload
    decodes and translates."""
    from expressive_speech_translation_tpu_torch.media import native
    from expressive_speech_translation_tpu_torch.pipeline.watermark import WaterMark

    row = out["video"]
    if row["status"] != 200:
        raise AssertionError(f"lipsync /process-video answered {row['status']}: "
                             f"{str(row['body'])[:300]}")
    sse = row["body"]
    final = sse[-1]
    if final.get("phase") != "complete":
        raise AssertionError(f"lipsync /process-video ended with {final}")
    if [f["progress"] for f in sse] != [10, 20, 30, 55, 60, 90, 100]:
        raise AssertionError(f"lipsync /process-video progress {[f['progress'] for f in sse]} "
                             "(75 = the mux fallback)")
    if len(out["lipsync_s"]) != 1 or out["distribute_calls"] != 1:
        raise AssertionError(f"lipsync /process-video: {len(out['lipsync_s'])} renders, "
                             f"{out['distribute_calls']} distribute_audio calls")
    mp4 = base64.b64decode(final["result"]["video"])
    with tempfile.TemporaryDirectory() as tmp:
        path = os.path.join(tmp, "delivered.mp4")
        with open(path, "wb") as f:
            f.write(mp4)
        if not WaterMark.verify(path):
            raise AssertionError("lipsync /process-video: the delivered MP4 has no watermark")
        if out["shim"]:
            video, fps = native.decode_video(path)
            audio, sr = native.decode_audio(path, target_rate=16_000, target_channels=1)
            n_frames, shape = len(video), list(video.shape[1:])
        else:
            pcm, info = _read_rndr(mp4)
            audio, sr, fps = pcm.astype(np.float32) / 32767.0, info["sr"], info["fps"]
            n_frames, shape = info["frames"], info["shape"]
            if info["changed"] != n_frames:
                raise AssertionError(f"lipsync: {info['changed']} of {n_frames} frames changed")
    dub_s = len(audio) / sr
    # a shim round trip (encode, then decode) keeps all but the last frame
    want_frames = len(frames) - 2 if out["shim"] else len(frames)
    if not (n_frames >= want_frames and shape == list(frames[0].shape)
            and abs(fps - FRONTEND_FPS) < 0.5 and dub_s >= FRONTEND_SECONDS - 0.1):
        raise AssertionError(f"lipsync /process-video: {n_frames} frames {shape} at {fps} fps, "
                             f"{dub_s:.3f} s of audio")
    got = row["launches"]
    if got["log_mel_frames"] != 2 or got["fused_resblock_stage"] != narrow:
        raise AssertionError(f"lipsync /process-video launched {got}, not log-mel 2 (ASR and "
                             f"the condition) and resblock {narrow}")
    result = {"frames": n_frames, "fps": fps, "audio_s": dub_s, "wall_s": row["wall_s"],
              "translate_s": row["translate_s"], "lipsync_s": out["lipsync_s"][0],
              "launches": got, "shim": out["shim"]}
    print(f"  /process-video apply_lip_sync=true (HTTP, "
          f"{'the shim' if out['shim'] else 'the test VideoIO'}): wall {row['wall_s']:.3f} s, "
          f"translate_speech {row['translate_s']:.3f} s and lip-sync {out['lipsync_s'][0]:.3f} s "
          f"inside; {n_frames} frames {shape} at {fps:.2f} fps, {dub_s:.3f} s of audio; launches "
          f"{got}  [{card}]", flush=True)
    if "flac" in out:
        flac = out["flac"]
        body = json.loads(flac["body"])
        if flac["status"] != 200 or len(_decoded_wav(body["audio"])) < int(16_000 * FRONTEND_SECONDS):
            raise AssertionError(f"lipsync: the FLAC upload to /translate answered "
                                 f"{flac['status']}: {str(body)[:300]}")
        result["flac"] = {"wall_s": flac["wall_s"], "translate_s": flac["translate_s"],
                          "launches": flac["launches"]}
        print(f"  /translate of a FLAC upload (decoded by the shim): wall {flac['wall_s']:.3f} s, "
              f"translate_speech {flac['translate_s']:.3f} s, launches {flac['launches']}  "
              f"[{card}]", flush=True)
    return result


def lipsync_phase(dev, report, card, backend, e2e):
    """MuseTalk at its published width (``MuseTalkConfig()``) in bf16 with
    seeded random weights, conditioned on a random whisper-tiny-width
    encoder (d_model 384, 80 mels) through ``whisper_feature_fn``: the
    frontend phase's 250 frames of 360×640 at 25 fps rendered against the
    e2e phase's 10 s dub (at 24 kHz: the fn resamples it), the split timed;
    log-mel once (the condition's 30 s window), the resblock never; the jaw
    changed and nothing above it; one batch of 2 crops in f32 on the card
    against device="cpu"; then /process-video with lip-sync through the
    port's shim where the card has libav, else over a test VideoIO."""
    from expressive_speech_translation_tpu_torch.media import native
    from expressive_speech_translation_tpu_torch.models import musetalk as mtm
    from expressive_speech_translation_tpu_torch.models import whisper
    from expressive_speech_translation_tpu_torch.ops.resample import resample
    from expressive_speech_translation_tpu_torch.pipeline.backend import TranslationManager
    from expressive_speech_translation_tpu_torch.pipeline.musetalk_pipeline import (
        musetalk_lipsync_fn)

    cfg, wcfg = mtm.MuseTalkConfig(), whisper.WhisperConfig.tiny()
    print(f"== lipsync: MuseTalk VAE {cfg.vae_channels}, UNet {cfg.unet_channels}, audio "
          f"{cfg.audio_dim} (whisper-tiny width, {wcfg.n_mels} mels), bf16, random weights",
          flush=True)
    t_phase = time.perf_counter()
    tools = native.toolchain()
    libav = tools["g++"] is not None and all(tools["headers"].values())
    print(f"  media shim toolchain: g++ {tools['g++']}; libav headers "
          + ", ".join(f"{p} {'found' if ok else 'missing'}" for p, ok in tools["headers"].items())
          + (" -> the route runs through the port's shim" if libav else
             " -> no libav here: the route runs over the serve phase's test VideoIO with the "
             "real MuseTalk lip-sync"), flush=True)
    if libav:
        t0 = time.perf_counter()
        native.build()
        print(f"  built {native.library_path().name} in {time.perf_counter() - t0:.1f} s",
              flush=True)

    torch.cuda.synchronize()
    resident = torch.cuda.memory_allocated()
    t0 = time.perf_counter()
    fn = musetalk_lipsync_fn(None, cfg, whisper=(whisper.init_whisper(21, wcfg, dev), wcfg),
                             device=dev, dtype=torch.bfloat16)
    torch.cuda.synchronize()
    build_s = time.perf_counter() - t0
    held = (torch.cuda.memory_allocated() - resident) / 2**30
    print(f"  musetalk_lipsync_fn built in {build_s:.2f} s, holding {held:.2f} GiB  [{card}]",
          flush=True)

    frames = np.stack(frontend_frames())
    dub16 = _KEPT["dub"]
    dub = resample(torch.from_numpy(dub16).to(dev), 16_000, LIPSYNC_DUB_SR).cpu().numpy()
    out, boxes, render = lipsync_render(fn, frames, dub, LIPSYNC_DUB_SR, card)
    launches = render["launches"]
    if launches["log_mel_frames"] != 1 or launches["fused_resblock_stage"] != 0:
        raise AssertionError(f"lip-sync render launched {launches}, not log-mel 1 (the "
                             "condition's window) and resblock 0")
    if render["condition_shape"] != [int(np.ceil(len(dub16) / 16_000 * 50)), cfg.audio_dim]:
        raise AssertionError(f"lip-sync condition {render['condition_shape']} for "
                             f"{len(dub16) / 16_000:.3f} s of dub")
    lipsync = {"build_s": build_s, "held_gib": held, "render": render,
               "output": check_lipsync_output(frames, out, boxes)}
    del out
    lipsync["f32_check"] = lipsync_f32_check(fn, frames, boxes, dub16, dev, card)
    gc.collect()
    torch.cuda.empty_cache()

    manager = TranslationManager()
    manager.register_backend("cascaded", backend, is_default=True)
    upload = _stereo_upload(FRONTEND_SECONDS, FRONTEND_UPLOAD_SR, 43)
    with tempfile.TemporaryDirectory() as tmp:
        route = lipsync_route(manager, backend, fn, list(frames), upload, dev, tmp, libav)
    lipsync["route"] = check_lipsync_route(route, frames, _narrow_stages(backend), card)
    lipsync["launches"] = {k: render["launches"][k] + route["video"]["launches"][k]
                           + route.get("flac", {"launches": {k: 0}})["launches"][k]
                           for k in LAUNCH_COUNTERS}
    _KEPT["lipsync_fn"] = fn          # the services phase's MuseTalk service renders with it
    del fn
    gc.collect()
    torch.cuda.empty_cache()
    lipsync["seconds"] = time.perf_counter() - t_phase
    print(f"  lipsync phase {lipsync['seconds']:.1f} s", flush=True)
    report["lipsync"] = lipsync
    return lipsync


DIFF2LIP_F32_RTOL = 1e-3       # diff2lip f32 on the card against device="cpu": max |diff| / peak
DIFF2LIP_F32_FRAMES = 25       # frames rendered with the f32 tree (JAX's default dtype)
DIFF2LIP_CROSS_FRAMES = 8      # one batch rendered in cross-identity mode
DIFF2LIP_BAKE_FRAMES = 8       # frames rendered from the bake


def diff2lip_unet_flops(params, cfg, dev) -> float:
    """Operations of one ``gd_unet_apply`` call for one frame: the
    convolutions' and matmuls' multiply-adds ×2, as ``FlopCounterMode``
    counts them on the call at the published width (norms, activations and
    the softmax left out)."""
    from torch.utils.flop_counter import FlopCounterMode

    from expressive_speech_translation_tpu_torch.models import gd_unet

    s = cfg.image_size
    x = torch.zeros((1, 3, s, s), device=dev)
    mask = torch.zeros((1, 1, s, 1), device=dev)
    counter = FlopCounterMode(display=False)
    with counter, torch.inference_mode():
        gd_unet.gd_unet_apply(params, cfg.unet, x, torch.zeros(1, dtype=torch.long, device=dev),
                              cond_img=x, mask=mask, ref_img=x,
                              mel=torch.zeros((1, cfg.mel_window, cfg.n_mels), device=dev))
    return float(counter.get_total_flops())


def diff2lip_render(pipe, frames: np.ndarray, dub16: np.ndarray, card, label: str,
                    unet_flops: float, identity=None) -> tuple:
    """One ``Diff2LipPipeline.generate`` on the frames against the 16 kHz
    dub, the card synchronised around each part: seconds split into face
    boxes (host), mel windows, crops, sampling (card) and the blend (host);
    frames per second; the sampling's TFLOP/s and its share of the FP32 or
    bf16 data-sheet peak; peak memory above the resident. → (frames, the
    target's boxes, figures)."""
    from expressive_speech_translation_tpu_torch.pipeline import diff2lip as d2l
    from expressive_speech_translation_tpu_torch.pipeline import musetalk_pipeline as mtp

    boxes, mels, crops, samples, blend = [], [], [], [], []
    torch.cuda.synchronize()
    base = torch.cuda.memory_allocated()
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    with _synced_timing(d2l, "per_frame_face_boxes", boxes), \
            _synced_timing(d2l, "mel_windows_for_frames", mels), \
            _synced_timing(pipe, "crops", crops), \
            _synced_timing(pipe, "sample", samples), \
            _timing_calls(d2l, "blend_face_np", blend):
        out = pipe.generate(frames, dub16, FRONTEND_FPS, identity_frames=identity,
                            generator=torch.Generator(device=pipe.device).manual_seed(0))
    wall = time.perf_counter() - t0
    peak = (torch.cuda.max_memory_allocated() - base) / 2**30
    split = {"face_boxes_s": sum(c[0] for c in boxes), "mel_windows_s": mels[0][0],
             "crops_s": sum(c[0] for c in crops), "sampling_s": sum(c[0] for c in samples),
             "blend_s": sum(c[0] for c in blend)}
    split["rest_s"] = wall - sum(split.values())
    dtype = pipe.params["out"]["conv"]["kernel"].dtype
    peak_rate = PEAK_BF16 if dtype == torch.bfloat16 else PEAK_FP32
    flop = len(frames) * pipe.diffusion.num_timesteps * unet_flops
    rate = flop / split["sampling_s"]
    figures = {"label": label, "frames": len(frames), "dtype": str(dtype), "wall_s": wall,
               "fps": len(frames) / wall, **split, "batches": len(samples),
               "sampling_tflop": flop / 1e12, "sampling_tflops": rate / 1e12,
               "peak_share": rate / peak_rate, "peak_gib_above_resident": peak,
               "cross_identity": identity is not None}
    print(f"  {label}: {len(frames)} frames {frames.shape[1]}x{frames.shape[2]} in {wall:.3f} s, "
          f"{len(frames) / wall:.2f} frames/s: " + ", ".join(
              f"{k[:-2]} {v:.3f} s" for k, v in split.items())
          + f"; sampling {flop / 1e12:.1f} TFLOP in {len(samples)} batches at "
          f"{rate / 1e12:.1f} TFLOP/s, {100 * rate / peak_rate:.1f}% of the "
          f"{'bf16' if peak_rate == PEAK_BF16 else 'FP32'} data-sheet peak; peak "
          f"{peak:.2f} GiB above the resident  [{card}]", flush=True)
    boxes = [mtp.clamp_box(b, frames.shape[1], frames.shape[2]) for b in boxes[0][1]]
    return out, boxes, figures


def diff2lip_f32_check(params, cfg, frames, boxes, dub16, dev, card) -> dict:
    """In f32, card against ``device="cpu"`` on the same tree and draws: one
    ``gd_unet_apply`` at the published width on 2 crops, and the sampled
    crops (before the blend) of one batch of 2 frames through a ``ddim4``
    copy of the config; each max |diff| / peak within DIFF2LIP_F32_RTOL."""
    from expressive_speech_translation_tpu_torch.models import gd_unet
    from expressive_speech_translation_tpu_torch.pipeline import diff2lip as d2l

    host = _tree_to(params, "cpu")
    cfg4 = dataclasses.replace(cfg, sampling_steps="ddim4")
    card_pipe = d2l.Diff2LipPipeline(cfg4, params, device=dev)
    cpu_pipe = d2l.Diff2LipPipeline(cfg4, host, device="cpu")
    crops = card_pipe.crops(list(frames[:2]), boxes[:2]).cpu()
    ref = crops.flip(0)
    mel = torch.from_numpy(d2l.mel_windows_for_frames(dub16, 2, FRONTEND_FPS, device="cpu"))
    g = torch.Generator().manual_seed(5)
    x = torch.randn(crops.shape, generator=g)
    t = torch.tensor([960, 40])
    draws = d2l.BatchNoise(torch.randn(crops.shape, generator=g),
                           torch.randn(crops.shape, generator=g),
                           [torch.randn(crops.shape, generator=g)
                            for _ in range(card_pipe.diffusion.num_timesteps)])
    rows = {}

    def unet(pipe, dev_):
        return gd_unet.gd_unet_apply(pipe.params, cfg.unet, x.to(dev_), t.to(dev_),
                                     cond_img=crops.to(dev_), mask=pipe.mask, ref_img=ref.to(dev_),
                                     mel=mel.to(dev_))

    def sampled(pipe, dev_):
        return pipe.sample(crops.to(dev_), ref.to(dev_), mel.to(dev_), noise=d2l.BatchNoise(
            draws.cond.to(dev_), draws.x_init.to(dev_), [d.to(dev_) for d in draws.steps]))

    for name, fn in (("gd_unet_apply", unet), ("sampled crops, ddim4", sampled)):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        with torch.inference_mode():
            got = fn(card_pipe, dev).float().cpu()
        card_s = time.perf_counter() - t0
        t0 = time.perf_counter()
        with torch.inference_mode():
            want = fn(cpu_pipe, "cpu").float()
        cpu_s = time.perf_counter() - t0
        err, peak = float((got - want).abs().max()), float(want.abs().max())
        rows[name] = {"max_abs_err": err, "peak": peak, "rel": err / peak, "card_s": card_s,
                      "cpu_s": cpu_s}
        print(f"  diff2lip {name} f32, 2 crops, card against device=\"cpu\": max |diff| "
              f"{err:.3e}, peak {peak:.3f}, ratio {err / peak:.3e} (tolerance "
              f"{DIFF2LIP_F32_RTOL:g}); card {card_s:.3f} s, CPU {cpu_s:.1f} s  [{card}]",
              flush=True)
        if not (np.isfinite(err) and err <= DIFF2LIP_F32_RTOL * peak):
            raise AssertionError(f"diff2lip {name} f32 on the card differs from the CPU by "
                                 f"{err:.3e} (peak {peak:.3f})")
    return rows


def diff2lip_phase(dev, report, card):
    """diff2lip at its published width (``Diff2LipConfig()``: 128 px, 128
    base channels, mult (1, 1, 2, 3, 4), attention at ds 8/16, ddim25) with
    seeded random weights, against the e2e phase's 10 s dub and the
    frontend phase's 360×640 frames at 25 fps: ``generate`` of the first
    DIFF2LIP_F32_FRAMES frames with the f32 tree, of all 250 with the same
    tree in bf16, and one batch in cross-identity mode (the identity clip
    reversed), each split and timed; shape and dtype kept, nothing outside
    a face box changed and every jaw changed; the card against the CPU in
    f32; log-mel and the resblock never launched."""
    from expressive_speech_translation_tpu_torch.models.common import cast_floats
    from expressive_speech_translation_tpu_torch.pipeline import diff2lip as d2l

    cfg = d2l.Diff2LipConfig()
    print(f"== diff2lip: TFG UNet {cfg.image_size} px, {cfg.model_channels} channels x "
          f"{cfg.channel_mult}, attention at ds {cfg.attention_ds}, {cfg.heads} heads, audio "
          f"encoder {cfg.audio_model_channels} x {cfg.audio_channel_mult}, {cfg.sampling_steps}, "
          "random weights", flush=True)
    t_phase = time.perf_counter()
    torch.cuda.synchronize()
    resident = torch.cuda.memory_allocated()
    _reset_launches()
    params = d2l.init_diff2lip_unet(11, cfg, dev)
    n_params = _tree_bytes(params) // 4                  # f32
    unet_flops = diff2lip_unet_flops(params, cfg, dev)
    pipe = d2l.Diff2LipPipeline(cfg, params, device=dev)
    steps = pipe.diffusion.num_timesteps
    print(f"  {n_params / 1e6:.2f} M parameters ({4 * n_params / 1e6:.0f} MB in f32); one UNet "
          f"call {unet_flops / 1e9:.1f} GFLOP a frame (FlopCounterMode), "
          f"{unet_flops * steps / 1e12:.2f} TFLOP a frame over {steps} steps", flush=True)
    frames = np.stack(frontend_frames())
    dub16 = _KEPT["dub"]
    runs = {}
    f32_frames = frames[:DIFF2LIP_F32_FRAMES]
    out, boxes, runs["f32"] = diff2lip_render(pipe, f32_frames, dub16, card,
                                              "f32 generate", unet_flops)
    runs["f32"]["output"] = check_lipsync_output(f32_frames, out, boxes)
    f32_boxes = boxes
    pipe = d2l.Diff2LipPipeline(cfg, cast_floats(params, torch.bfloat16), device=dev)
    out, boxes, runs["bf16"] = diff2lip_render(pipe, frames, dub16, card, "bf16 generate",
                                               unet_flops)
    runs["bf16"]["output"] = check_lipsync_output(frames, out, boxes)
    cross = frames[:DIFF2LIP_CROSS_FRAMES]
    out, boxes, runs["cross"] = diff2lip_render(pipe, cross, dub16, card,
                                                "bf16 generate, cross identity", unet_flops,
                                                identity=cross[::-1].copy())
    runs["cross"]["output"] = check_lipsync_output(cross, out, boxes)
    del out, pipe
    result = {"params": n_params, "unet_gflop_a_frame": unet_flops / 1e9, "runs": runs,
              "f32_check": diff2lip_f32_check(params, cfg, f32_frames, f32_boxes, dub16, dev,
                                              card)}
    result["launches"] = _read_launches()
    if any(result["launches"].values()):
        raise AssertionError(f"the diff2lip phase launched {result['launches']}: it runs no "
                             "kernel of the port")
    del params
    gc.collect()
    torch.cuda.empty_cache()
    result["held_gib_after"] = (torch.cuda.memory_allocated() - resident) / 2**30
    result["seconds"] = time.perf_counter() - t_phase
    print(f"  launches {result['launches']}; diff2lip phase {result['seconds']:.1f} s", flush=True)
    report["diff2lip"] = result
    return result


SERVICES_OV_SOURCE_S = 10.0     # OpenVoice: the clone's 16 kHz source
SERVICES_OV_REFERENCE_S = 5.0   # and its reference
SERVICES_OV_CHECK_S = 2.0       # the f32 card-against-CPU check's source
OPENVOICE_F32_RTOL = 1e-4       # convert_tone f32 on the card against device="cpu": max |diff| / peak
OPENVOICE_OUT_GAIN = 500.0      # the random tree's output conv scaled: a waveform, not a whisper
SERVICES_MUSETALK_FRAMES = 25
SERVICES_NMT_TOKENS = 48        # the remote app's NMT budget: its letters fill whatever it is given
SERVICES_SIMILARITY_ATOL = 5e-5 + 1e-6   # the response rounds the score to 4 decimals


def _host_packages() -> dict:
    """Whether the split deployment's optional host packages are here."""
    import importlib.util

    return {"requests": importlib.util.find_spec("requests") is not None,
            "urllib3": importlib.util.find_spec("urllib3") is not None,
            "yt-dlp": shutil.which("yt-dlp")}


@contextlib.contextmanager
def _service_transport(app, http: bool):
    """A client transport to ``app``: ``HttpTransport`` to it served by
    werkzeug on localhost (``http``), else a ``WsgiTransport``."""
    from expressive_speech_translation_tpu_torch.serve import clients

    if not http:
        yield clients.WsgiTransport(app)
        return
    with _http_server(app) as request:
        yield clients.HttpTransport(request.url)


def services_remote_route(dev, card, backend, e2e, upload, tmp, http: bool) -> dict:
    """The split deployment: the port's CosyVoiceService, its "default" the
    e2e phase's TTS engine, served on localhost; ``create_app`` in mode
    "remote" against its URL (``HttpTransport`` when requests imports, else
    patched to a ``WsgiTransport`` of the service), served too; the upload
    posted to /translate over HTTP, the counters at 0 just before. The TTS
    call over the wire is timed beside the engine's direct ``synthesize`` of
    the same text and reference."""
    from expressive_speech_translation_tpu_torch.core.config import load_config
    from expressive_speech_translation_tpu_torch.media.wavio import read_wav_bytes, wav_bytes
    from expressive_speech_translation_tpu_torch.serve import clients
    from expressive_speech_translation_tpu_torch.serve import model_services as ms
    from expressive_speech_translation_tpu_torch.serve.app import create_app

    tts = backend.engines.tts
    service = ms.CosyVoiceService({"default": lambda: tts}, device=dev)
    out = {}
    with _http_server(service) as tts_http:
        overrides = {"engines.mode": "remote", "engines.scale": "reference",
                     "endpoints.cosyvoice_url": tts_http.url,
                     "endpoints.health_backoff_seconds": 0.0, "temp_dir": tmp}
        http_transport = clients.HttpTransport
        if not http:
            clients.HttpTransport = lambda url: clients.WsgiTransport(service)
        try:
            t0 = time.perf_counter()
            app = create_app(config=load_config(env={}, **overrides), device=dev)
            remote = app.manager.get_backend()          # initialize(): the TTS over the wire
            torch.cuda.synchronize()
            out["build_s"] = time.perf_counter() - t0
        finally:
            clients.HttpTransport = http_transport
        engines = remote.engines
        # the CosyVoice service refuses an empty text with a 400, as the
        # reference's does, and the random NMT's 256k vocabulary almost never
        # decodes to a byte: its a-z rows are scaled, as the checkpoints phase
        # scales them, so that the translation has letters to speak
        engines.nmt.params["embed"][[4 + b for b in b"abcdefghijklmnopqrstuvwxyz"]] *= \
            NMT_LETTER_SCALE
        engines.nmt.max_new_tokens = SERVICES_NMT_TOKENS
        placement = remote.placement_info()
        if not (type(engines.tts) is clients.CosyVoiceClient and placement["asr"] == [0]
                and placement["nmt"] == [0] and placement["tts"] == []):
            raise AssertionError(f"remote app: TTS {type(engines.tts).__name__}, placement "
                                 f"{placement}")
        print(f"  remote app built and initialised in {out['build_s']:.1f} s (the port's ASR and "
              f"NMT at reference scale on the card, TTS {type(engines.tts).__name__} of "
              f"{tts_http.url} over {'HttpTransport' if http else 'WsgiTransport'}), placement "
              f"{placement}", flush=True)
        wav = wav_bytes(upload, FRONTEND_UPLOAD_SR)
        translated, tts_timed, tts_calls, shapes = [], [], [], []
        with _http_server(app) as request:
            torch.cuda.synchronize()
            calls_before = tts._call_count
            _reset_launches()
            with _timing_calls(remote, "translate_speech", translated), \
                    _timing_calls(engines.tts, "synthesize", tts_timed), \
                    _recording_calls(engines.tts, "synthesize", tts_calls,
                                     lambda args, kwargs, out: (args, kwargs, out)), \
                    _recording_resblock_shapes(shapes):
                t0 = time.perf_counter()
                status, body, _ = request("/translate", {"target_language": "fra",
                                                         "source_language": "eng"},
                                          {"file": (wav, "upload.wav")})
                wall = time.perf_counter() - t0
            launches = _read_launches()
            health = json.loads(request("/health/model")[1])
    if status != 200:
        raise AssertionError(f"remote /translate answered {status}: {body[:300]!r}")
    body = json.loads(body)
    audio = _decoded_wav(body["audio"])
    if not body["transcripts"]["target"]:
        raise AssertionError("remote /translate: an empty translation")
    if not (len(audio) >= int(SERVE_SECONDS * 16_000) and np.isfinite(audio).all()):
        raise AssertionError(f"remote /translate: audio {audio.shape}")
    if not (health["placement"] == placement and health["healthy"] is True):
        raise AssertionError(f"remote /health/model: {health}")
    narrow = _narrow_stages(backend)
    if launches["log_mel_frames"] != 1 or launches["fused_resblock_stage"] != narrow:
        raise AssertionError(f"remote /translate launched {launches}, not log-mel 1 and "
                             f"resblock {narrow}")
    if len(tts_calls) != 1:
        raise AssertionError(f"remote /translate made {len(tts_calls)} TTS calls")
    (wire_s, _), (args, kwargs, wire_out) = tts_timed[0], tts_calls[0]
    # the direct call takes the wire's draws (the engine's noise is indexed by
    # its call count) and the reference as the service read it (PCM16)
    ref = kwargs.get("reference_audio_16k")
    if ref is not None:
        kwargs = {**kwargs, "reference_audio_16k": (
            np.trunc(np.clip(ref, -1.0, 1.0) * 32767.0) / 32768.0).astype(np.float32)}
    tts._call_count = calls_before
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    direct = tts.synthesize(*args, **kwargs)
    torch.cuda.synchronize()
    direct_s = time.perf_counter() - t0
    n = min(len(direct), len(wire_out))
    wire_err = float(np.abs(np.clip(direct[:n], -1, 1) - wire_out[:n]).max(initial=0.0))
    native = next(r for r in e2e["requests"] if r["audio_s"] == SERVE_SECONDS)
    out.update(status=status, wall_s=wall, translate_s=translated[0][0], launches=launches,
               tts_wire_s=wire_s, tts_direct_s=direct_s, tts_wire_samples=int(len(wire_out)),
               tts_direct_samples=int(len(direct)), tts_wire_max_abs_diff=wire_err,
               target_chars=len(args[0]),
               placement=placement, weights=body["weights"],
               resblock_request=time_request_resblock(dev, shapes, card, "the remote request"))
    print(f"  remote /translate ({SERVE_SECONDS:.0f} s 44.1 kHz stereo upload, HTTP): status "
          f"{status}, wall {wall:.3f} s, translate_speech {out['translate_s']:.3f} s inside; the "
          f"TTS call over the wire {wire_s:.3f} s ({len(wire_out)} samples) against the engine's "
          f"direct synthesize of the same {len(args[0])} characters and reference {direct_s:.3f} s "
          f"({len(direct)} samples, the wire's draws and PCM16 reference; max |diff| "
          f"{wire_err:.2e}, a PCM16 step {1 / 32767:.2e}); launches "
          f"{launches}; the e2e phase's in-process {SERVE_SECONDS:.0f} s request "
          f"{native['wall_s']:.3f} s  [{card}]", flush=True)
    del app, remote, engines
    return out


def services_musetalk(dev, card, dub, http: bool, tmp) -> dict:
    """``MuseTalkClient.lipsync`` to ``MuseTalkService`` over the serve
    phase's test VideoIO with the lipsync phase's MuseTalk fn: 25 frontend
    frames against the 10 s dub; the rendered frame count, only the jaws
    changed, log-mel once."""
    from expressive_speech_translation_tpu_torch.pipeline import musetalk_pipeline as mtp
    from expressive_speech_translation_tpu_torch.serve import clients
    from expressive_speech_translation_tpu_torch.serve import model_services as ms

    fn = _KEPT.pop("lipsync_fn")
    frames = np.stack(frontend_frames()[:SERVICES_MUSETALK_FRAMES])
    rendered, boxes = [], []

    def render(f, fps, audio, sr):
        rendered.append(fn(f, fps, audio, sr))
        return rendered[-1]

    vio = LipsyncVideoIO(np.zeros(16_000, np.float32), 16_000, list(frames), render)
    vin, vout = os.path.join(tmp, "clip.mp4"), os.path.join(tmp, "lipsynced.mp4")
    with open(vin, "wb") as f:
        f.write(b"\x00\x00\x00\x18ftypisom\x00\x00\x02\x00isomiso2" + bytes(4096))
    with _service_transport(ms.MuseTalkService(vio), http) as transport:
        client = clients.MuseTalkClient(transport, retries=1, retry_delay_s=0)
        if not client.check_health():
            raise AssertionError("MuseTalk service unhealthy")
        torch.cuda.synchronize()
        _reset_launches()
        with _timing_calls(mtp, "per_frame_face_boxes", boxes):
            t0 = time.perf_counter()
            client.lipsync(vin, dub, 16_000, vout)
            wall = time.perf_counter() - t0
        launches = _read_launches()
    del fn
    with open(vout, "rb") as f:
        pcm, info = _read_rndr(f.read())
    if not (len(rendered) == 1 and info["frames"] == SERVICES_MUSETALK_FRAMES
            and info["changed"] == SERVICES_MUSETALK_FRAMES and len(pcm) == len(dub)):
        raise AssertionError(f"MuseTalk service: rendered {info}, {len(pcm)} samples")
    if launches["log_mel_frames"] != 1 or launches["fused_resblock_stage"] != 0:
        raise AssertionError(f"MuseTalk service launched {launches}, not log-mel 1")
    box = [mtp.clamp_box(b, frames.shape[1], frames.shape[2]) for b in boxes[0][1]]
    output = check_lipsync_output(frames, rendered[0], box)
    print(f"  MuseTalkClient.lipsync of {SERVICES_MUSETALK_FRAMES} frames against the "
          f"{len(dub) / 16_000:.1f} s dub: {wall:.3f} s, {info['frames']} frames rendered, only "
          f"the jaws changed (mean {output['jaw_mean_abs_change'][1]:.2f} levels); launches "
          f"{launches}  [{card}]", flush=True)
    return {"wall_s": wall, "frames": info["frames"], "launches": launches, "output": output}


def services_similarity(dev, card, dub, upload16, http: bool) -> dict:
    """``SimilarityClient.compare`` to ``SimilarityService`` with the
    full-width ECAPA (1,024 channels) on the card: the dub with itself (1.0)
    and with the upload, each equal to a direct ``speaker_similarity`` on the
    same tree of the audio as the WAV upload quantises it, within the
    response's 4-decimal rounding."""
    from expressive_speech_translation_tpu_torch.evals.acoustic_metrics import speaker_similarity
    from expressive_speech_translation_tpu_torch.models import ecapa
    from expressive_speech_translation_tpu_torch.serve import clients
    from expressive_speech_translation_tpu_torch.serve import model_services as ms

    cfg = ecapa.EcapaConfig()
    tree = ecapa.init_ecapa(13, cfg, dev)

    def score(a, b):
        return speaker_similarity(a, b, params=tree, cfg=cfg, device=dev)

    quantised = [np.trunc(np.clip(x, -1.0, 1.0) * 32767.0) / 32768.0 for x in (dub, upload16)]
    out = {"channels": cfg.channels}
    with _service_transport(ms.SimilarityService(score, device=dev), http) as transport:
        client = clients.SimilarityClient(transport, retries=1, retry_delay_s=0)
        for name, other, q_other in (("self", dub, quantised[0]),
                                     ("upload", upload16, quantised[1])):
            t0 = time.perf_counter()
            remote = client.compare(dub, other)
            wall = time.perf_counter() - t0
            direct = score(quantised[0], q_other)
            if abs(remote - direct) > SERVICES_SIMILARITY_ATOL:
                raise AssertionError(f"similarity {name}: {remote} over the service, {direct} "
                                     "directly")
            out[name] = {"score": remote, "direct": direct, "wall_s": wall}
    if out["self"]["score"] != 1.0:
        raise AssertionError(f"the dub against itself scores {out['self']['score']}")
    print(f"  SimilarityClient.compare, ECAPA {cfg.channels} channels: the dub with itself "
          f"{out['self']['score']} ({out['self']['wall_s']:.3f} s), with the upload "
          f"{out['upload']['score']} (direct {out['upload']['direct']:.6f}, "
          f"{out['upload']['wall_s']:.3f} s)  [{card}]", flush=True)
    return out


def _ov_tree_check(got, want, path="openvoice") -> list:
    """The loaded tree against the emitted one: equal, or for a weight-normed
    conv within the fold's rounding (an f32 ulp). → [(path, elements that
    differ, their largest |diff| / |w|)]."""
    if isinstance(want, dict):
        if set(got) != set(want):
            raise AssertionError(f"OpenVoice round trip: keys differ at {path}")
        return [r for k in want for r in _ov_tree_check(got[k], want[k], f"{path}.{k}")]
    if isinstance(want, list):
        return [r for i, (g, w) in enumerate(zip(got, want))
                for r in _ov_tree_check(g, w, f"{path}[{i}]")]
    if got.shape != want.shape or got.dtype != want.dtype:
        raise AssertionError(f"OpenVoice round trip: {path} {got.shape} {got.dtype}")
    diff = got != want
    if not diff.any():
        return []
    rel = float(((got - want).abs() / want.abs())[diff].max())
    if rel > 2.0 ** -23:
        raise AssertionError(f"OpenVoice round trip: {path} differs by {rel} relative")
    return [(path, int(diff.sum()), rel)]


def services_openvoice(dev, card, tmp, http: bool) -> dict:
    """OpenVoice at its published width (``OpenVoiceConfig()``), f32, seeded
    random weights (the flow's zero-initialised posts drawn too, so the flow
    carries the speaker, and the output conv scaled by OPENVOICE_OUT_GAIN so
    the random generator's waveform spans the audio range): emitted as ``checkpoint.pth`` + ``config.json``,
    read back by ``load_openvoice``, baked by ``bake_models(openvoice=...)``
    and reloaded; ``OpenVoiceService`` picks the bake up from
    ``EST_MODELS_DIR``; ``OpenVoiceClient.clone`` of a 10 s 16 kHz source
    against a 5 s reference (seconds, RTF, length, no launch); the card's f32
    ``convert_tone`` against ``device="cpu"`` on the same tree."""
    from expressive_speech_translation_tpu_torch.models import loaders
    from expressive_speech_translation_tpu_torch.models import openvoice as ov
    from expressive_speech_translation_tpu_torch.obs import checkpoint_emitters as em
    from expressive_speech_translation_tpu_torch.serve import clients
    from expressive_speech_translation_tpu_torch.serve import model_services as ms

    cfg = ov.OpenVoiceConfig()
    params = ov.init_openvoice(17, cfg, dev)
    g = torch.Generator(device=dev).manual_seed(18)
    for layer in params["flow"]:
        layer["post"]["kernel"].normal_(0.0, 0.02, generator=g)
    params["dec"]["conv_post"]["kernel"].mul_(OPENVOICE_OUT_GAIN)
    n_params = _tree_bytes(params) // 4                  # f32
    print(f"  OpenVoice v2 converter at its published width: inter/hidden {cfg.inter_channels}, "
          f"SE {cfg.se_dim}, HiFi-GAN {cfg.upsample_initial} x{cfg.upsample_rates}, "
          f"{cfg.post_wn_layers}-layer posterior WN, {cfg.n_flows} flows; "
          f"{n_params / 1e6:.2f} M parameters, f32", flush=True)
    t0 = time.perf_counter()
    src = em.write_openvoice(os.path.join(tmp, "converter"), params, cfg)
    emit_s = time.perf_counter() - t0
    t0 = time.perf_counter()
    loaded, loaded_cfg = loaders.load_openvoice(src, device=dev)
    load_s = time.perf_counter() - t0
    if loaded_cfg != cfg:
        raise AssertionError(f"load_openvoice read {loaded_cfg}")
    folded = _ov_tree_check(loaded, params)
    t0 = time.perf_counter()
    loaders.bake_models(os.path.join(tmp, "bake"), openvoice=str(src), device=dev)
    bake_s = time.perf_counter() - t0
    baked, _ = loaders.load_converted(os.path.join(tmp, "bake", "openvoice"), ov.OpenVoiceConfig,
                                      dev)
    _tensors_equal(baked, loaded, "bake openvoice")
    print(f"  checkpoint.pth ({os.path.getsize(os.path.join(src, 'checkpoint.pth')) / 2**20:.1f} "
          f"MiB) emitted in {emit_s:.2f} s, read back by load_openvoice in {load_s:.2f} s (config "
          f"equal; plain tensors equal, {len(folded)} weight-normed ones within the fold's "
          f"rounding, {sum(n for _, n, _ in folded)} elements an ulp off), baked in "
          f"{bake_s:.2f} s and reloaded equal", flush=True)

    records = []

    class Catch(logging.Handler):
        def emit(self, record):
            records.append(record.getMessage())

    catch = Catch()
    log = logging.getLogger(ms.__name__)
    level = log.level
    log.setLevel(logging.INFO)
    log.addHandler(catch)
    models_dir = os.environ.get("EST_MODELS_DIR")
    os.environ["EST_MODELS_DIR"] = os.path.join(tmp, "bake")
    source = _speechlike(SERVICES_OV_SOURCE_S, seed=71)
    reference = _speechlike(SERVICES_OV_REFERENCE_S, seed=72)
    try:
        service = ms.OpenVoiceService(device=dev)
        with _service_transport(service, http) as transport:
            client = clients.OpenVoiceClient(transport, retries=1, retry_delay_s=0)
            status = client.status()
            torch.cuda.synchronize()
            _reset_launches()
            runs = []
            for _ in range(2):                     # the first loads the bake
                t0 = time.perf_counter()
                out, sr = client.clone(source, 16_000, reference, 16_000)
                runs.append(time.perf_counter() - t0)
            launches = _read_launches()
    finally:
        log.removeHandler(catch)
        log.setLevel(level)
        if models_dir is None:
            os.environ.pop("EST_MODELS_DIR")
        else:
            os.environ["EST_MODELS_DIR"] = models_dir
    if not any("baked converter" in r for r in records):
        raise AssertionError(f"OpenVoiceService did not log the baked converter: {records}")
    _tensors_equal(service._params, baked, "service openvoice")
    n22 = -(-len(source) * 22_050 // 16_000)
    frames = (n22 + 2 * ((cfg.n_fft - cfg.hop) // 2) - cfg.n_fft) // cfg.hop + 1
    want_len = frames * int(np.prod(cfg.upsample_rates))
    if not (sr == 22_050 and len(out) == want_len and np.isfinite(out).all()
            and np.abs(out).max() > 0 and status["native_sample_rate"] == 22_050):
        raise AssertionError(f"OpenVoice clone: {sr} Hz, {len(out)} samples (want {want_len})")
    if any(launches.values()):
        raise AssertionError(f"OpenVoice launched {launches}: it runs no kernel of the port")
    print(f"  OpenVoiceService (the bake from EST_MODELS_DIR, 'baked converter' logged): "
          f"OpenVoiceClient.clone of {SERVICES_OV_SOURCE_S:.0f} s at 16 kHz against a "
          f"{SERVICES_OV_REFERENCE_S:.0f} s reference -> {len(out)} samples at {sr} Hz "
          f"({frames} frames x {int(np.prod(cfg.upsample_rates))}); {runs[0]:.3f} s with the "
          f"bake's load, then {runs[1]:.3f} s, RTF {runs[1] / SERVICES_OV_SOURCE_S:.4f}; "
          f"launches {launches}  [{card}]", flush=True)
    check = openvoice_f32_check(loaded, cfg, dev, card)
    return {"params": n_params, "emit_s": emit_s, "load_s": load_s, "bake_s": bake_s,
            "folded": folded, "clone_s": runs, "rtf": runs[1] / SERVICES_OV_SOURCE_S,
            "out_samples": len(out), "launches": launches, "f32_check": check}


def openvoice_f32_check(params, cfg, dev, card) -> dict:
    """``extract_se`` and ``convert_tone`` in f32 of a 2 s source against a
    5 s reference, on the card and with ``device="cpu"`` on a host copy of
    the same tree: the largest difference relative to the output's peak,
    held to OPENVOICE_F32_RTOL."""
    from expressive_speech_translation_tpu_torch.models import openvoice as ov
    from expressive_speech_translation_tpu_torch.ops.resample import resample

    src = torch.from_numpy(_speechlike(SERVICES_OV_CHECK_S, seed=73))
    ref = torch.from_numpy(_speechlike(SERVICES_OV_REFERENCE_S, seed=74))
    src22, ref22 = (resample(x, 16_000, 22_050)[None] for x in (src, ref))
    outs, secs = {}, {}
    for name, device, tree in (("card", dev, params), ("cpu", torch.device("cpu"),
                                                       _tree_to(params, "cpu"))):
        t0 = time.perf_counter()
        with torch.no_grad():
            s, r = src22.to(device), ref22.to(device)
            se_s = ov.extract_se(tree, cfg, ov.spectrogram_22k(s, cfg))
            se_t = ov.extract_se(tree, cfg, ov.spectrogram_22k(r, cfg))
            outs[name] = ov.convert_tone(tree, cfg, s, se_s, se_t).cpu()
        secs[name] = time.perf_counter() - t0
    peak = float(outs["cpu"].abs().max())
    err = float((outs["card"] - outs["cpu"]).abs().max())
    if not (peak > 0 and err <= OPENVOICE_F32_RTOL * peak):
        raise AssertionError(f"OpenVoice f32 card against CPU: {err} > {OPENVOICE_F32_RTOL} * "
                             f"{peak}")
    print(f"  OpenVoice f32 convert_tone of {SERVICES_OV_CHECK_S:.0f} s, card against "
          f"device=\"cpu\": max |diff| {err:.3e} at a peak of {peak:.4f} "
          f"({err / peak:.2e} of it; limit {OPENVOICE_F32_RTOL:g}); card {secs['card']:.3f} s, "
          f"CPU {secs['cpu']:.3f} s  [{card}]", flush=True)
    return {"max_abs_err": err, "peak": peak, "card_s": secs["card"], "cpu_s": secs["cpu"]}


def services_phase(dev, report, card, backend, e2e):
    """The split deployment on the card: the remote route (the port's
    CosyVoiceService over the e2e TTS engine, ``create_app(mode="remote")``,
    /translate over HTTP: log-mel 1, resblock 2), then the MuseTalk,
    similarity and OpenVoice services through their clients, and the
    OpenVoice emit / load / bake round trip at its published width."""
    from expressive_speech_translation_tpu_torch.ops.resample import resample

    host = _host_packages()
    http = host["requests"]
    print("== services: host packages: " + ", ".join(
        f"{k} {'present' if v else 'missing'}" for k, v in host.items())
          + ("" if http else "; requests is missing, so the HTTP transport is not driven: the "
             "remote app's TTS client and the services' clients run over WsgiTransport (the "
             "app itself is still served over HTTP)"), flush=True)
    t_phase = time.perf_counter()
    torch.cuda.synchronize()
    base = torch.cuda.memory_allocated()
    torch.cuda.reset_peak_memory_stats()
    upload = _stereo_upload(SERVE_SECONDS, FRONTEND_UPLOAD_SR, 47)
    upload16 = resample(torch.from_numpy(upload.mean(0)).to(dev), FRONTEND_UPLOAD_SR,
                        16_000).cpu().numpy()
    dub = _KEPT["dub"]
    out = {"host": {k: bool(v) for k, v in host.items()}}
    with tempfile.TemporaryDirectory() as tmp:
        out["remote"] = services_remote_route(dev, card, backend, e2e, upload, tmp, http)
        gc.collect()
        torch.cuda.empty_cache()
        out["musetalk"] = services_musetalk(dev, card, dub, http, tmp)
        gc.collect()
        torch.cuda.empty_cache()
        out["similarity"] = services_similarity(dev, card, dub, upload16, http)
        out["openvoice"] = services_openvoice(dev, card, tmp, http)
    gc.collect()
    torch.cuda.empty_cache()
    out["peak_gib_above_resident"] = (torch.cuda.max_memory_allocated() - base) / 2**30
    out["launches"] = {k: out["remote"]["launches"][k] + out["musetalk"]["launches"][k]
                       + out["openvoice"]["launches"][k] for k in LAUNCH_COUNTERS}
    out["seconds"] = time.perf_counter() - t_phase
    print(f"  peak {out['peak_gib_above_resident']:.2f} GiB above what was resident; launches "
          f"{out['launches']}; services phase {out['seconds']:.1f} s  [{card}]", flush=True)
    report["services"] = out
    return out


BATCH_REQUESTS = 8
BATCH_SECONDS = 10.0


def batched_phase(dev, report, card, e2e):
    """Reference-scale engines behind the three micro-batchers
    (``torch_engines(batch_asr=True, batch_nmt=True, batch_tts=True,
    max_batch=8)``, the same conditioning models as the e2e phase),
    ``initialize()`` (language detection in a batched pass), then 8
    concurrent 10 s ``translate_speech`` requests from 8 threads (eng → fra,
    voice cloning on), with the launch counters read around them and the
    resblock launches recorded: the kernel must have launched at B > 1, and
    is checked and timed at the recorded shapes."""
    from concurrent.futures import ThreadPoolExecutor

    from expressive_speech_translation_tpu_torch.models import cosyvoice, ecapa
    from expressive_speech_translation_tpu_torch.models import speech_tokenizer as stm
    from expressive_speech_translation_tpu_torch.pipeline.cascaded import CascadedBackend
    from expressive_speech_translation_tpu_torch.pipeline.torch_engines import torch_engines

    print(f"== batched: the same engines behind micro-batchers (max_batch {BATCH_REQUESTS}), "
          f"{BATCH_REQUESTS} concurrent {BATCH_SECONDS:.0f} s requests", flush=True)
    gc.collect()
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    # the e2e phase's engines stay resident for the streaming phase
    resident = torch.cuda.memory_allocated() / 2**30
    t0 = time.perf_counter()
    ecfg, scfg = ecapa.EcapaConfig(), stm.SpeechTokenizerConfig()
    engines = torch_engines(scale="reference", batch_asr=True, batch_nmt=True, batch_tts=True,
                            max_batch=BATCH_REQUESTS,
                            tts_ecapa=(ecapa.init_ecapa(3, ecfg, dev), ecfg),
                            tts_speech_tokenizer=(stm.init_speech_tokenizer(4, scfg, dev), scfg))
    stages = {"asr": engines.asr, "nmt": engines.nmt, "tts": engines.tts}
    try:
        torch.cuda.synchronize()
        init_s = time.perf_counter() - t0
        backend = CascadedBackend(engines)
        t0 = time.perf_counter()
        backend.initialize()
        torch.cuda.synchronize()
        warm_s = time.perf_counter() - t0
        print(f"  engines {init_s:.1f} s, initialize {warm_s:.1f} s", flush=True)
        inputs = [_speechlike(BATCH_SECONDS, seed=100 + i) for i in range(BATCH_REQUESTS)]
        start = threading.Barrier(BATCH_REQUESTS)

        def request(x):
            start.wait(timeout=120)
            t = time.perf_counter()
            out = backend.translate_speech(x, "eng", "fra")
            return out, time.perf_counter() - t

        before = {k: st.stats for k, st in stages.items()}
        res_shapes = []
        _reset_launches()
        t0 = time.perf_counter()
        with _recording_resblock_shapes(res_shapes), \
                ThreadPoolExecutor(BATCH_REQUESTS, thread_name_prefix="request") as pool:
            results = [f.result() for f in [pool.submit(request, x) for x in inputs]]
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        launches = _read_launches()
        formed = {k: {m: st.stats[m] - before[k][m] for m in ("items", "batches")}
                  for k, st in stages.items()}
    finally:
        for st in stages.values():
            st.shutdown()
    peak = torch.cuda.max_memory_allocated() / 2**30
    requests = []
    for i, (out, seconds) in enumerate(results):
        _check_request(out, BATCH_SECONDS, f"batched request {i}")
        split = {k: v["seconds"] for k, v in out["stage_summary"].items()}
        requests.append({"wall_s": seconds, "stages_s": split,
                         "out_samples": int(out["audio"].shape[1])})
        print(f"  request {i}: wall {seconds:.3f} s  "
              + "  ".join(f"{k} {v:.3f} s" for k, v in split.items()), flush=True)
    serial = next(r["wall_s"] for r in e2e["requests"] if r["audio_s"] == BATCH_SECONDS)
    rps, rps_serial = BATCH_REQUESTS / wall, 1.0 / serial
    print(f"  {BATCH_REQUESTS} concurrent {BATCH_SECONDS:.0f} s requests: wall {wall:.3f} s, "
          f"{rps:.4f} requests/s; serially (the e2e phase's {BATCH_SECONDS:.0f} s request, "
          f"{serial:.3f} s) {rps_serial:.4f} requests/s: {rps / rps_serial:.2f}x; peak memory "
          f"{peak:.2f} GiB, {peak - resident:.2f} GiB above the {resident:.2f} GiB the e2e "
          f"engines hold  [{card}]", flush=True)
    print(f"  batches formed (items / batches): {formed}; kernel launches {launches}; resblock "
          f"launches (B, C, T): {[shape[:3] for shape in res_shapes]}", flush=True)
    if launches["fused_resblock_stage"] <= 0 or not any(b > 1 for b, *_ in res_shapes):
        raise AssertionError(f"the resblock kernel never launched at B > 1: {res_shapes}")
    # the branch-sum scratch (B C T f32) of the largest TTS dispatch: 16 rows
    # at the 768-token budget, in the last stage
    cfg = cosyvoice.CosyVoiceConfig()
    c_last = cfg.vocoder.base_channels // 2 ** len(cfg.vocoder.upsample_rates)
    t_last = 768 * cfg.flow.token_mel_ratio * cfg.vocoder.hop
    worst_scratch_gb = 16 * c_last * t_last * 4 / 1e9
    print(f"  resblock branch-sum scratch at 16 rows x 768 tokens (C={c_last}, T={t_last}): "
          f"{worst_scratch_gb:.2f} GB, reckoned from the shapes", flush=True)
    batched = {"engines_s": init_s, "initialize_s": warm_s, "wall_s": wall,
               "requests_per_s": rps, "serial_request_s": serial,
               "serial_requests_per_s": rps_serial, "requests": requests, "formed": formed,
               "launches": launches, "peak_memory_gib": peak,
               "resident_before_gib": resident,
               "resblock_shapes": [list(shape[:3]) for shape in res_shapes],
               "worst_scratch_gb": worst_scratch_gb,
               "resblock_request": time_request_resblock(
                   dev, res_shapes, card, f"{BATCH_REQUESTS} batched requests")}
    report["batched"] = batched
    return batched


STREAM_SECONDS = (10.0, 40.0)   # the 40 s request spans two 30 s ASR windows


@contextlib.contextmanager
def _counting_stream_chunks(calls: list):
    """Append the token count of every streamed TTS chunk made inside the
    block (one ``flow_vocode_chunk`` call, one vocode) to ``calls``."""
    from expressive_speech_translation_tpu_torch.models import cosyvoice

    chunk = cosyvoice.flow_vocode_chunk

    def counting(params, flow_cfg, voc_cfg, noise, tokens, n_valid, *args):
        calls.append(int(n_valid))
        return chunk(params, flow_cfg, voc_cfg, noise, tokens, n_valid, *args)

    cosyvoice.flow_vocode_chunk = counting
    try:
        yield calls
    finally:
        cosyvoice.flow_vocode_chunk = chunk


def _narrow_stages(backend) -> int:
    """vocode's stages narrow enough for the resblock kernel (C ≤ 128, C % 8
    == 0): its launches a vocode (2 at reference width)."""
    tts = getattr(backend.engines.tts, "engine", backend.engines.tts)
    vc = tts.cfg.vocoder
    widths = [vc.base_channels // 2 ** (i + 1) for i in range(len(vc.upsample_rates))]
    return sum(1 for c in widths if c <= 128 and c % 8 == 0)


def streaming_phase(dev, report, card, backend, e2e):
    """``translate_speech_streaming`` (eng → fra, cloning on) of a 10 s and a
    40 s request on the e2e phase's backend, each with the launch counters
    set to 0 before it and read after: log-mel once an ASR window (the
    language is given: no detection), resblock twice a streamed TTS chunk;
    the 40 s request must give two transcripts events, and each at least one
    audio chunk. The resblock kernel is then checked and timed at the
    (B, C, T) the streams handed it, in both layouts (at reference width two
    narrow stages a chunk: C=128, T=2,976 and C=64, T=29,760 for the 62
    frames a chunk vocodes)."""
    print(f"== streaming: translate_speech_streaming of {', '.join(f'{s:.0f}' for s in STREAM_SECONDS)}"
          " s requests on the e2e engines, cloning on", flush=True)
    t_phase = time.perf_counter()
    streams, res_shapes = [], []
    launches_total = dict.fromkeys(LAUNCH_COUNTERS, 0)
    per_chunk = _narrow_stages(backend)
    for seconds in STREAM_SECONDS:
        x = _speechlike(seconds, seed=200 + int(seconds))
        shapes, chunks, events = [], [], []
        first_audio = None
        _reset_launches()
        t0 = time.perf_counter()
        with _recording_resblock_shapes(shapes), _counting_stream_chunks(chunks):
            for ev in backend.translate_speech_streaming(x, "eng", "fra"):
                if ev["type"] == "audio" and first_audio is None:
                    first_audio = time.perf_counter() - t0
                events.append((time.perf_counter() - t0, ev))
        wall = time.perf_counter() - t0
        launches = _read_launches()
        for k, v in launches.items():
            launches_total[k] += v
        res_shapes += shapes
        windows = math.ceil(seconds / 30.0)
        transcripts = [ev for _, ev in events if ev["type"] == "transcripts"]
        audio = [ev["chunk"] for _, ev in events if ev["type"] == "audio"]
        offline = next((r["wall_s"] for r in e2e["requests"] if r["audio_s"] == seconds), None)
        row = {"audio_s": seconds, "first_audio_s": first_audio, "wall_s": wall,
               "offline_wall_s": offline, "windows": windows,
               "transcripts_events": len(transcripts), "audio_chunks": len(audio),
               "chunk_samples": [len(a) for a in audio], "tts_chunks": len(chunks),
               "tts_chunk_tokens": chunks, "launches": launches,
               "events_at_s": [(round(t, 4), ev["type"]) for t, ev in events],
               "resblock_shapes": [list(shape[:3]) for shape in shapes]}
        streams.append(row)
        print(f"  {seconds:4.1f} s stream: first audio at {first_audio or math.nan:.3f} s, "
              f"wall {wall:.3f} s (offline request: "
              f"{'not run' if offline is None else f'{offline:.3f} s'}), {len(transcripts)} "
              f"transcripts events, {len(audio)} audio chunks of {row['chunk_samples']} samples "
              f"at 16 kHz, {len(chunks)} TTS chunks of {chunks} tokens  [{card}]", flush=True)
        print(f"    launches: log-mel {launches['log_mel_frames']}, resblock "
              f"{launches['fused_resblock_stage']} (all: {launches}); resblock (B, C, T): "
              f"{sorted(set(shape[:3] for shape in shapes))}", flush=True)
        for ev in transcripts:
            if "window" not in ev:
                raise AssertionError(f"{seconds} s stream: a transcripts event without a window")
        if seconds > 30 and len(transcripts) != 2:
            raise AssertionError(f"{seconds} s stream gave {len(transcripts)} transcripts events")
        if not audio or not all(np.isfinite(a).all() and a.dtype == np.float32 for a in audio):
            raise AssertionError(f"{seconds} s stream: no audio, or audio not finite f32")
        if not chunks or launches["fused_resblock_stage"] != per_chunk * len(chunks):
            raise AssertionError(f"{seconds} s stream: {launches['fused_resblock_stage']} resblock "
                                 f"launches for {len(chunks)} streamed TTS chunks of "
                                 f"{per_chunk} narrow vocoder stages")
        if launches["log_mel_frames"] != windows:
            raise AssertionError(f"{seconds} s stream: {launches['log_mel_frames']} log-mel "
                                 f"launches for {windows} ASR windows")
    stream = {"requests": streams, "launches": launches_total,
              "resblock_shapes": sorted(set(tuple(shape[:3]) for shape in res_shapes)),
              "resblock_request": time_request_resblock(
                  dev, res_shapes, card, "the streams", layouts=("bct", "btc"), graphed=True)}
    pair = [r for r in stream["resblock_request"] if r["layout"] == "bct"]
    print(f"  resblock at the stream's shapes, main-path layout, the pair: through the wrapper "
          f"{sum(r['ms'] for r in pair):.4f} ms, graph-replayed {sum(r['graph_ms'] for r in pair):.4f}"
          f" ms, plain {sum(r['graph_plain_ms'] for r in pair):.4f} ms (graph-replayed), bound "
          f"{sum(r['bound_ms'] for r in pair):.4f} ms  [{card}]", flush=True)
    stream["seconds"] = time.perf_counter() - t_phase
    print(f"  streaming phase {stream['seconds']:.1f} s", flush=True)
    report["streaming"] = stream
    return stream


MTP_WIDTH = 3                 # tokens a backbone pass: the main head and two MTP heads
MTP_BATCH = 8
SPEC_F32_BUDGET = 250         # speech tokens of the f32 speculative-against-single-token check
SPEC_F32_SEED = 7
DECODE_BATCHES = (1, 8)
# int8 against bf16 logits of one decode step, max |int8 - bf16| / max |bf16|:
# per-channel codes keep each weight within 1/254 of its channel's peak;
# through 24 random layers the logits moved 1.1-2.6 % of their peak at a
# reduced width (d 256) on the CPU, so 10 % leaves a margin of about four
INT8_LOGIT_RTOL = 0.1
LM_GENERATORS = ("generate_speech_tokens", "generate_speech_tokens_mtp",
                 "generate_speech_tokens_spec")


@contextlib.contextmanager
def _recording_lm(runs: list, hidden: list = None):
    """Append one entry to ``runs`` for each speech-token generation inside
    the block: the generator ``select_generator`` picked, its rows, its
    tokens, and its backbone passes after the prefill (the decode_step and
    decode_span calls it made; the speculative one's ``with_stats`` beside
    them). With ``hidden``, also append (cache slot, hidden states) of
    every such call. For the block's duration ``models/cosyvoice`` sees a
    copy of the ``qwen2`` module whose two decode functions count."""
    from expressive_speech_translation_tpu_torch.models import cosyvoice

    q2, gens = cosyvoice.q2, {name: getattr(cosyvoice, name) for name in LM_GENERATORS}
    passes = [0]

    def counting(fn):
        def call(params, cfg, x, pos, *args, **kwargs):
            passes[0] += 1
            out = fn(params, cfg, x, pos, *args, **kwargs)
            if hidden is not None:
                hidden.append((int(pos), out.detach().clone()))
            return out
        return call

    def recording(name, fn):
        def call(*args, **kwargs):
            passes[0] = 0
            stats = None
            if name == "generate_speech_tokens_spec":
                tokens, lengths, stats = fn(*args, with_stats=True, **kwargs)
            else:
                tokens, lengths = fn(*args, **kwargs)
            runs.append({"generator": name, "rows": int(tokens.shape[0]),
                         "lengths": lengths.tolist(), "tokens": tokens.tolist(),
                         "passes": passes[0], "stats": stats})
            return tokens, lengths
        return call

    cosyvoice.q2 = types.SimpleNamespace(**{**vars(q2), "decode_step": counting(q2.decode_step),
                                           "decode_span": counting(q2.decode_span)})
    for name, fn in gens.items():
        setattr(cosyvoice, name, recording(name, fn))
    try:
        yield runs
    finally:
        cosyvoice.q2 = q2
        for name, fn in gens.items():
            setattr(cosyvoice, name, fn)


def _first_difference(a, b):
    """The first index where two token lists differ, or None."""
    return next((i for i, (x, y) in enumerate(zip(a, b)) if x != y),
                None if len(a) == len(b) else min(len(a), len(b)))


def _tree_bytes(tree) -> int:
    """Bytes of the tensors of a parameter tree, each counted once."""
    seen, total, stack = set(), 0, [tree]
    while stack:
        node = stack.pop()
        if isinstance(node, dict):
            stack.extend(node.values())
        elif isinstance(node, (list, tuple)):
            stack.extend(node)
        elif torch.is_tensor(node) and node.data_ptr() not in seen:
            seen.add(node.data_ptr())
            total += node.numel() * node.element_size()
    return total


def mtp_tts_runs(dev, card, base, text, style, reference) -> dict:
    """Reference-width TTS engines in bf16 on one random tree with two MTP
    heads (the e2e engine's seed, so the tree is the e2e tree plus the heads,
    which ``init_cosyvoice`` draws last): ``synthesize`` of the 10 s
    request's text and voice prompt at ``mtp=1``, at ``mtp=3`` (accept-all)
    and at ``mtp=3, spec=True``, each engine's first call, so each takes
    the noise of call 1; then ``synthesize_batch`` of 8 requests at
    ``mtp=3``. The resblock kernel must launch in every run."""
    from expressive_speech_translation_tpu_torch.pipeline.torch_engines import TorchCosyVoiceTts

    cfg = dataclasses.replace(base.cfg, lm=dataclasses.replace(base.cfg.lm, mtp=1,
                                                               spec_decode=False))
    cond = dict(device=dev, ecapa_weights=(base._ecapa, base._ecapa_cfg),
                speech_tokenizer_weights=(base._st, base._st_cfg))
    heads = TorchCosyVoiceTts(cfg, None, mtp=MTP_WIDTH, **cond)
    engines = {"mtp=1": TorchCosyVoiceTts(cfg, heads.params, mtp=1, **cond),
               f"mtp={MTP_WIDTH}": heads,
               f"mtp={MTP_WIDTH}, spec": TorchCosyVoiceTts(cfg, heads.params, mtp=MTP_WIDTH,
                                                            spec=True, **cond)}
    routes = dict(zip(engines, LM_GENERATORS))
    out = {"runs": {}}
    for label, tts in engines.items():
        runs = []
        _reset_launches()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        with _recording_lm(runs):
            wave = tts.synthesize(text, style_prompt=style, reference_audio_16k=reference,
                                  language="fr")
        seconds = time.perf_counter() - t0
        launches = _read_launches()
        if len(runs) != 1 or runs[0]["generator"] != routes[label]:
            raise AssertionError(f"tts {label}: generators {[r['generator'] for r in runs]}, "
                                 f"not {routes[label]}")
        run = runs[0]
        emitted = run["stats"]["emitted"] if run["stats"] else run["lengths"][0]
        passes = run["stats"]["backbone_passes"] if run["stats"] else run["passes"]
        if run["stats"] and run["stats"]["backbone_passes"] != run["passes"]:
            raise AssertionError(f"tts {label}: with_stats counts {run['stats']} passes, "
                                 f"the backbone ran {run['passes']}")
        if not (wave.size and np.isfinite(wave).all()) or launches["fused_resblock_stage"] <= 0:
            raise AssertionError(f"tts {label}: {wave.size} samples, launches {launches}")
        row = {"tts_s": seconds, "speech_tokens": run["lengths"][0], "emitted": emitted,
               "backbone_passes": passes, "tokens_per_pass": emitted / max(passes, 1),
               "resblock_launches": launches["fused_resblock_stage"], "launches": launches,
               "tokens": run["tokens"][0][:run["lengths"][0]], "samples": int(wave.size)}
        out["runs"][label] = row
        print(f"  tts {label:12s} [{run['generator']}]: {seconds:.3f} s, {row['speech_tokens']} "
              f"speech tokens, {passes} backbone passes after the prefill, "
              f"{row['tokens_per_pass']:.3f} tokens a pass, resblock launches "
              f"{row['resblock_launches']}  [{card}]", flush=True)
    one, spec = out["runs"]["mtp=1"]["tokens"], out["runs"][f"mtp={MTP_WIDTH}, spec"]["tokens"]
    out["bf16_spec_parts_at"] = _first_difference(one, spec)
    print(f"  bf16 speculative stream against mtp=1: "
          f"{'identical' if out['bf16_spec_parts_at'] is None else 'parts at index %d' % out['bf16_spec_parts_at']}"
          f" (bf16 span and step differ in their low bits; not required)", flush=True)

    reqs = [{"text": text, "style_prompt": style, "language": "fr",
             "reference_audio_16k": np.resize(_speechlike(RES_REQUEST_SECONDS, seed=100 + i),
                                              16_000 * 10)} for i in range(MTP_BATCH)]
    runs = []
    _reset_launches()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    with _recording_lm(runs):
        waves = heads.synthesize_batch(reqs)
    wall = time.perf_counter() - t0
    launches = _read_launches()
    if ([(r["generator"], r["rows"]) for r in runs] != [("generate_speech_tokens_mtp", MTP_BATCH)]
            or len(waves) != MTP_BATCH or launches["fused_resblock_stage"] <= 0
            or not all(w.size and np.isfinite(w).all() for w in waves)):
        raise AssertionError(f"tts batch of {MTP_BATCH} at mtp={MTP_WIDTH}: {runs and runs[0]['generator']}, "
                             f"{len(waves)} waves, launches {launches}")
    out["batch"] = {"requests": MTP_BATCH, "wall_s": wall, "speech_tokens": runs[0]["lengths"],
                    "backbone_passes": runs[0]["passes"], "launches": launches,
                    "resblock_launches": launches["fused_resblock_stage"]}
    print(f"  tts batch of {MTP_BATCH} at mtp={MTP_WIDTH} [accept-all]: wall {wall:.3f} s, "
          f"speech tokens {runs[0]['lengths']}, {runs[0]['passes']} backbone passes, resblock "
          f"launches {launches['fused_resblock_stage']}  [{card}]", flush=True)
    out["launches"] = {k: sum(r["launches"][k] for r in out["runs"].values())
                       + out["batch"]["launches"][k] for k in LAUNCH_COUNTERS}
    out["prompt"] = heads._prepare_conditioning(text, reference, style)
    out["cfg"] = cfg
    return out


def spec_f32_check(dev, card, cfg, prompt) -> dict:
    """Reference width in f32 (TF32 off): the speculative stream at mtp=3
    against the single-token stream on the same position-keyed noise, 250
    tokens. Tokens may part only where the two backbone calls part in their
    low bits: where they part, the hidden states behind the first differing
    token (the single-token decode_step at its slot, the speculative pass's
    decode_span row at the same slot) must differ, and the single-token
    sampler at that index must give each stream's token from that stream's
    own logits. Printed either way: how far the two calls' hidden states
    lie apart behind the tokens both streams share."""
    from expressive_speech_translation_tpu_torch.models import cosyvoice as cvm
    from expressive_speech_translation_tpu_torch.models.common import dense

    lm3 = dataclasses.replace(cfg.lm, mtp=MTP_WIDTH, spec_decode=True)
    lm1 = dataclasses.replace(cfg.lm, mtp=1, spec_decode=False)
    params = cvm.init_cosyvoice(2, dataclasses.replace(cfg, lm=lm3), dev)["lm"]
    toks, tmask, _, _, _, psp, _ = prompt
    args = (toks, tmask, psp, torch.ones_like(psp, dtype=torch.bool))
    p_len = 2 + toks.shape[1] + psp.shape[1]
    hidden_one, hidden_spec, runs = [], [], []
    t0 = time.perf_counter()
    with _recording_lm(runs, hidden_one):
        cvm.generate_speech_tokens(params, lm1, cvm.GeneratorNoise(SPEC_F32_SEED, dev), *args,
                                   max_new_tokens=SPEC_F32_BUDGET)
    one_s = time.perf_counter() - t0
    t0 = time.perf_counter()
    with _recording_lm(runs, hidden_spec):
        cvm.generate_speech_tokens_spec(params, lm3, cvm.GeneratorNoise(SPEC_F32_SEED, dev), *args,
                                        max_new_tokens=SPEC_F32_BUDGET)
    spec_s = time.perf_counter() - t0
    d = _first_difference(runs[0]["tokens"][0], runs[1]["tokens"][0])
    steps = dict(hidden_one)

    def span_at(slot):
        """The speculative pass that covers cache slot ``slot`` (the last span
        that started at or before it: the pass that emitted the token this
        slot's state samples) → (its hidden states, the slot's row)."""
        start, span = [(pos, h) for pos, h in hidden_spec if pos <= slot][-1]
        if slot - start >= span.shape[1]:
            raise AssertionError(f"spec f32: no speculative pass covers slot {slot}")
        return span, slot - start

    def span_row(slot):
        span, r = span_at(slot)
        return span[:, r]

    # token i is sampled from the state at slot p_len + i - 1 in both loops
    emitted = runs[1]["stats"]["emitted"]
    common = range(1, emitted if d is None else d + 1)
    diffs = [float((steps[p_len + i - 1][:, 0] - span_row(p_len + i - 1)).abs().max())
             for i in common if p_len + i - 1 in steps]
    out = {"budget": SPEC_F32_BUDGET, "parts_at": d, "single_s": one_s, "spec_s": spec_s,
           "single_passes": runs[0]["passes"], "spec_stats": runs[1]["stats"],
           "speech_tokens": [runs[0]["lengths"][0], runs[1]["lengths"][0]],
           "hidden_max_abs_diff": max(diffs, default=0.0)}
    if d is not None:
        slot = p_len + d - 1
        span, r = span_at(slot)
        step = steps[slot][:, 0]
        logits = (dense(params["head"], step), dense(params["head"], span)[:, r])
        out["parting_hidden_max_abs_diff"] = float((step - span[:, r]).abs().max())
        out["parting_logits_max_abs_diff"] = float((logits[0] - logits[1]).abs().max())
        if not out["parting_hidden_max_abs_diff"] > 0:
            raise AssertionError(f"spec f32: the streams part at token {d} where decode_step and "
                                 "decode_span give the same hidden state: a logic fault")
        # each stream's token must come back from its own logits through the
        # single-token sampler at index d (same noise, window and gate)
        tokens = [runs[0]["tokens"][0], runs[1]["tokens"][0]]
        window = ([-1] * lm1.win_size + tokens[0][:d])[-lm1.win_size:]
        resampled = [int(cvm._sample_from_logits(
            lm1, cvm.GeneratorNoise(SPEC_F32_SEED, dev), lg,
            torch.tensor([window], dtype=torch.int32, device=dev),
            torch.zeros((1,), dtype=torch.bool, device=dev), d, 2)[0][0]) for lg in logits]
        if resampled != [tokens[0][d], tokens[1][d]]:
            raise AssertionError(f"spec f32: at token {d} the sampler gives {resampled} from the "
                                 f"two backbone calls' logits, the streams "
                                 f"{[tokens[0][d], tokens[1][d]]}: a logic fault")
    print(f"  f32 speculative (mtp={MTP_WIDTH}) against single-token over {SPEC_F32_BUDGET} tokens: "
          + ("identical" if d is None else
             f"part at index {d}; the hidden states behind it differ by "
             f"{out['parting_hidden_max_abs_diff']:.3e} (max abs), the logits by "
             f"{out['parting_logits_max_abs_diff']:.3e}")
          + f"; decode_step and decode_span states behind the {len(diffs)} shared tokens differ "
          f"by up to {out['hidden_max_abs_diff']:.3e}; speculative "
          f"{out['spec_stats']['backbone_passes']} passes for {emitted} tokens in {spec_s:.3f} s, "
          f"single-token {out['single_passes']} steps in {one_s:.3f} s  [{card}]", flush=True)
    return out


def _filled_cache(cache, g):
    for layer in cache:
        for t in layer.values():
            t.copy_(torch.randn(t.shape, generator=g, device=t.device, dtype=torch.float32))
    return cache


def _decode_step_fns(name, engine, quantize, b, dev):
    """A decode step of ``engine``'s model with its bf16 tree and with
    ``quantize`` of it, on the same inputs and equal caches: {label: fn →
    logits}, and the weights each tree holds (bytes)."""
    from expressive_speech_translation_tpu_torch.models import nllb as nlm
    from expressive_speech_translation_tpu_torch.models import qwen2 as q2
    from expressive_speech_translation_tpu_torch.models import whisper as wm
    from expressive_speech_translation_tpu_torch.models.common import (dense,
                                                                       precompute_layer_cross_kv)

    bf16 = torch.bfloat16
    trees = {"bf16": engine.params if name != "qwen2" else engine.params["lm"]}
    trees["int8"] = quantize(trees["bf16"])
    g = torch.Generator(device=dev).manual_seed(b)
    cfg, fns = engine.cfg, {}
    for label, p in trees.items():
        if name == "whisper":     # a 30 s window, step 100 of a 228-slot cache
            enc = torch.randn((b, cfg.max_source_positions, cfg.d_model),
                              generator=g.manual_seed(1), device=dev).to(bf16)
            cross = wm.precompute_cross_kv(p, cfg, enc)
            slots = min(228, cfg.max_target_positions)
            cache = _filled_cache(wm.init_kv_cache(cfg, b, bf16, dev, slots), g.manual_seed(2))
            token = torch.randint(0, cfg.vocab_size, (b,), generator=g.manual_seed(3), device=dev)
            fns[label] = functools.partial(lambda p, c, x, t: wm.decode_step_with_attn(
                p, cfg, t, slots // 2, c, x)[0], p, cache, cross, token)
        elif name == "nllb":      # a 64-token source, step 100 of a 202-slot cache
            enc = torch.randn((b, 64, cfg.d_model), generator=g.manual_seed(1), device=dev).to(bf16)
            cross = precompute_layer_cross_kv(p["decoder"]["layers"], cfg.attn, enc)
            cache = _filled_cache(
                [{"k": torch.empty((b, 202, cfg.heads, cfg.d_model // cfg.heads), dtype=bf16,
                                   device=dev),
                  "v": torch.empty((b, 202, cfg.heads, cfg.d_model // cfg.heads), dtype=bf16,
                                   device=dev)} for _ in range(cfg.decoder_layers)],
                g.manual_seed(2))
            mask = torch.ones((b, 1, 1, 64), dtype=torch.bool, device=dev)
            token = torch.randint(0, cfg.vocab_size, (b,), generator=g.manual_seed(3), device=dev)
            fns[label] = functools.partial(lambda p, c, x, t: nlm.decode_step(
                p, cfg, t, 100, c, x, mask), p, cache, cross, token)
        else:                     # step 180 of a 256-slot cache
            bcfg = cfg.lm.backbone
            cache = _filled_cache(q2.init_kv_cache(bcfg, b, 256, bf16, dev), g.manual_seed(2))
            x = p["speech_embed"][torch.randint(0, cfg.lm.speech_token_size, (b,),
                                                generator=g.manual_seed(3), device=dev)][:, None, :]
            fns[label] = functools.partial(lambda p, c, x: dense(p["head"], q2.decode_step(
                p["backbone"], bcfg, x, 180, c)[:, 0]), p, cache, x)
    return fns, {k: _tree_bytes(t) for k, t in trees.items()}


def int8_decode_check(dev, card, backend) -> dict:
    """One decode step of the e2e engines' Whisper-medium decoder, NLLB-600M
    decoder and Qwen2-0.5B speech LM (+ head) with their bf16 trees and with
    the int8 trees ``quantize`` makes of them, at B = 1 and 8: the int8
    logits against the bf16 ones (INT8_LOGIT_RTOL), and the two steps each
    captured 10 times into a CUDA graph and replayed in turns; the weights
    each tree holds and the peak memory of the timing."""
    from expressive_speech_translation_tpu_torch.models import cosyvoice as cvm
    from expressive_speech_translation_tpu_torch.models import nllb as nlm
    from expressive_speech_translation_tpu_torch.models import whisper as wm

    engines = {name: getattr(e, "engine", e) for name, e in
               (("whisper", backend.engines.asr), ("nllb", backend.engines.nmt),
                ("qwen2", backend.engines.tts))}
    quantizers = {"whisper": wm.quantize_whisper_decoder, "nllb": nlm.quantize_nllb_decoder,
                  "qwen2": cvm.quantize_speech_lm}
    rows = []
    for name, engine in engines.items():
        for b in DECODE_BATCHES:
            gc.collect()
            torch.cuda.empty_cache()
            torch.cuda.reset_peak_memory_stats()
            before = torch.cuda.memory_allocated()
            fns, nbytes = _decode_step_fns(name, engine, quantizers[name], b, dev)
            want, got = fns["bf16"]().float(), fns["int8"]().float()
            rel = float((got - want).abs().max() / want.abs().max())
            if not (math.isfinite(rel) and rel <= INT8_LOGIT_RTOL):
                raise AssertionError(f"int8 {name} B={b}: logits {rel:.3e} of the bf16 peak > "
                                     f"{INT8_LOGIT_RTOL}")
            turns = graph_turns(fns, calls=10)
            peak = (torch.cuda.max_memory_allocated() - before) / 2**30
            row = {"model": name, "B": b, "bf16_ms": min(turns["bf16"]),
                   "int8_ms": min(turns["int8"]), "turns_ms": turns, "logits_rel_err": rel,
                   "bf16_tree_gib": nbytes["bf16"] / 2**30, "int8_tree_gib": nbytes["int8"] / 2**30,
                   "timing_peak_above_gib": peak}
            rows.append(row)
            print(f"  decode step {name} B={b}: bf16 {row['bf16_ms']:.4f} ms, int8 "
                  f"{row['int8_ms']:.4f} ms ({row['int8_ms'] / row['bf16_ms']:.2f}x; graph-replayed "
                  f"in turns), int8 logits {rel:.2e} of the bf16 peak (bound {INT8_LOGIT_RTOL}); "
                  f"trees bf16 {row['bf16_tree_gib']:.3f} GiB, int8 {row['int8_tree_gib']:.3f} GiB "
                  f"(float embeddings kept), peak {peak:.2f} GiB above the resident engines  "
                  f"[{card}]", flush=True)
            del fns
    return {"decode_steps": rows}


def int8_request(dev, card, e2e) -> dict:
    """``torch_engines(scale="reference", quantize=True)`` with the e2e
    phase's conditioning models, ``initialize()``, and one 10 s
    ``translate_speech`` (cloning on): its stage seconds beside the e2e
    phase's 10 s request, the memory the engines hold and the peak."""
    from expressive_speech_translation_tpu_torch.models import ecapa
    from expressive_speech_translation_tpu_torch.models import speech_tokenizer as stm
    from expressive_speech_translation_tpu_torch.pipeline.cascaded import CascadedBackend
    from expressive_speech_translation_tpu_torch.pipeline.torch_engines import torch_engines

    gc.collect()
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    before = torch.cuda.memory_allocated()
    ecfg, scfg = ecapa.EcapaConfig(), stm.SpeechTokenizerConfig()
    engines = torch_engines(scale="reference", quantize=True,
                            tts_ecapa=(ecapa.init_ecapa(3, ecfg, dev), ecfg),
                            tts_speech_tokenizer=(stm.init_speech_tokenizer(4, scfg, dev), scfg))
    torch.cuda.synchronize()
    held = (torch.cuda.memory_allocated() - before) / 2**30
    backend = CascadedBackend(engines)
    backend.initialize()
    torch.cuda.reset_peak_memory_stats()
    x = _speechlike(RES_REQUEST_SECONDS, seed=int(RES_REQUEST_SECONDS))
    _reset_launches()
    t0 = time.perf_counter()
    out = backend.translate_speech(x, "eng", "fra")
    wall = time.perf_counter() - t0
    launches = _read_launches()
    _check_request(out, RES_REQUEST_SECONDS, "int8 request")
    if min(launches[k] for k in MAIN_PATH_KERNELS) <= 0:
        raise AssertionError(f"int8 request: a kernel of the main path never launched: {launches}")
    stages = {k: v["seconds"] for k, v in out["stage_summary"].items()}
    base = next(r for r in e2e["requests"] if r["audio_s"] == RES_REQUEST_SECONDS)
    peak = (torch.cuda.max_memory_allocated() - before) / 2**30
    print(f"  {RES_REQUEST_SECONDS:.0f} s request, quantize=True: wall {wall:.3f} s  "
          + "  ".join(f"{k} {v:.3f} s" for k, v in stages.items())
          + f" (bf16 in the e2e phase: wall {base['wall_s']:.3f} s  "
          + "  ".join(f"{k} {v:.3f} s" for k, v in base["stages_s"].items())
          + f"); the int8 engines hold {held:.2f} GiB, peak {peak:.2f} GiB above what was "
          f"resident before them  [{card}]", flush=True)
    return {"wall_s": wall, "stages_s": stages, "launches": launches, "held_gib": held,
            "peak_above_gib": peak, "bf16_wall_s": base["wall_s"],
            "bf16_stages_s": base["stages_s"]}


def mtp_phase(dev, report, card, backend, e2e):
    """Multi-token and speculative speech-token decoding at reference width
    (``mtp_tts_runs``, bf16; ``spec_f32_check``, f32), then int8 decode
    (``int8_decode_check``: one step of each model, int8 against bf16;
    ``int8_request``: one 10 s request on ``quantize=True`` engines). The
    launch counters of the TTS runs are the phase's."""
    print(f"== mtp: CosyVoice2-0.5B at mtp=1, {MTP_WIDTH}, {MTP_WIDTH} + spec (random heads), "
          "then int8 decode", flush=True)
    t_phase = time.perf_counter()
    base = getattr(backend.engines.tts, "engine", backend.engines.tts)
    req = next(r for r in e2e["requests"] if r["audio_s"] == RES_REQUEST_SECONDS)
    text, style = req["transcripts"]["target"], req["transcripts"]["source"]
    reference = backend.reference_audio_for_cloning(
        _speechlike(RES_REQUEST_SECONDS, seed=int(RES_REQUEST_SECONDS)))
    gc.collect()
    torch.cuda.empty_cache()
    tts = mtp_tts_runs(dev, card, base, text, style, reference)
    prompt, cfg = tts.pop("prompt"), tts.pop("cfg")
    gc.collect()
    torch.cuda.empty_cache()
    mtp = {"tts": tts, "launches": tts["launches"],
           "spec_f32": spec_f32_check(dev, card, cfg, prompt)}
    del prompt
    gc.collect()
    torch.cuda.empty_cache()
    mtp["int8"] = int8_decode_check(dev, card, backend)
    mtp["int8"]["request"] = int8_request(dev, card, e2e)
    mtp["seconds"] = time.perf_counter() - t_phase
    print(f"  mtp phase {mtp['seconds']:.1f} s", flush=True)
    report["mtp"] = mtp
    return mtp


OFFICIAL_SECONDS = 10.0
OFFICIAL_EOS_OFFSET = 30.0    # subtracted from the random head's EOS logit
OFFICIAL_SOURCE_ATOL = 1e-2   # bf16 HiFT source against its f32 copy: the output's bf16 rounding


@contextlib.contextmanager
def _recording_calls(module, name: str, calls: list, record):
    """For the block's duration ``module.name`` calls through, appending
    ``record(args, kwargs, result)`` of each call to ``calls``."""
    fn = getattr(module, name)

    def recording(*args, **kwargs):
        out = fn(*args, **kwargs)
        calls.append(record(args, kwargs, out))
        return out

    setattr(module, name, recording)
    try:
        yield calls
    finally:
        setattr(module, name, fn)


@contextlib.contextmanager
def _launches_around(engine, method: str, seen: list):
    """Each call of ``engine.method`` inside the block appends the kernels'
    launches made during that call (counters read before and after)."""
    fn = getattr(engine, method)

    def counted(*args, **kwargs):
        before = _read_launches()
        out = fn(*args, **kwargs)
        after = _read_launches()
        seen.append({k: after[k] - before[k] for k in after})
        return out

    setattr(engine, method, counted)
    try:
        yield seen
    finally:
        delattr(engine, method)


def official_request(backend, card, e2e) -> dict:
    """One 10 s translate_speech with cloning on through the official chain,
    the launch counters set to 0 before it and read after, and read around
    the TTS stage: log-mel launched for the request, resblock never in it."""
    x = _speechlike(OFFICIAL_SECONDS, seed=int(OFFICIAL_SECONDS))
    tts = backend.engines.tts
    _reset_launches()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    with _launches_around(tts, "synthesize", []) as tts_launches:
        out = backend.translate_speech(x, "eng", "fra")
    wall = time.perf_counter() - t0
    launches = _read_launches()
    _check_request(out, OFFICIAL_SECONDS, "official 10 s request")
    stages = {k: v["seconds"] for k, v in out["stage_summary"].items()}
    native = next(r for r in e2e["requests"] if r["audio_s"] == OFFICIAL_SECONDS)
    print(f"  {OFFICIAL_SECONDS:.0f} s request (official chain): wall {wall:.3f} s, RTF "
          f"{wall / OFFICIAL_SECONDS:.4f}  " + "  ".join(f"{k} {v:.3f} s" for k, v in stages.items())
          + f"  (native chain, e2e phase: wall {native['wall_s']:.3f} s, RTF {native['rtf']:.4f}  "
          + "  ".join(f"{k} {v:.3f} s" for k, v in native["stages_s"].items()) + f")  [{card}]",
          flush=True)
    print(f"    launches over the request {launches}; in the TTS stage {tts_launches}", flush=True)
    if launches["log_mel_frames"] < 1:
        raise AssertionError(f"official request: no log-mel launch ({launches})")
    if len(tts_launches) != 1 or any(tts_launches[0].values()):
        raise AssertionError(f"official synthesis launched kernels: {tts_launches}")
    if launches["fused_resblock_stage"]:
        raise AssertionError(f"official request launched the resblock kernel: {launches}")
    return {"wall_s": wall, "rtf": wall / OFFICIAL_SECONDS, "stages_s": stages,
            "launches": launches, "tts_launches": tts_launches[0],
            "native_wall_s": native["wall_s"], "native_stages_s": native["stages_s"],
            "out_samples": int(out["audio"].shape[1])}


def official_batch(tts, card) -> dict:
    """One synthesize_batch of a row with a reference and a row without
    (per-row prompt compaction at full width): finite audio, each row's
    length its tokens × token_mel_ratio × HiFT's hop."""
    from expressive_speech_translation_tpu_torch.models import cosyvoice_official as com

    spt = tts.official_cfg.flow.token_mel_ratio * tts.official_cfg.hift.hop
    reqs = [{"text": "Bonjour, je vous parle depuis la gare.", "style_prompt": "Hello from here.",
             "reference_audio_16k": _speechlike(OFFICIAL_SECONDS, seed=301), "language": "fr"},
            {"text": "Une phrase sans voix de référence.", "reference_audio_16k": None,
             "language": "fr"}]
    t0 = time.perf_counter()
    with _recording_calls(com, "synthesize_official", [],
                          lambda a, kw, out: (out["token_lengths"].tolist(),
                                              int(out["audio"].shape[1]))) as calls:
        audio = tts.synthesize_batch(reqs)
    seconds = time.perf_counter() - t0
    (lengths, width), = calls
    print(f"  synthesize_batch of 2 rows (one cloning): {seconds:.3f} s, tokens {lengths[:2]}, "
          f"samples {[len(a) for a in audio]} (padded batch width {width})  [{card}]", flush=True)
    for a, n in zip(audio, lengths):
        if not (np.isfinite(a).all() and len(a) == max(n, 1) * spt):
            raise AssertionError(f"official batch row: {len(a)} samples for {n} tokens × {spt}")
    return {"seconds": seconds, "tokens": lengths[:2], "samples": [len(a) for a in audio]}


def official_stream(backend, card) -> dict:
    """One 10 s translate_speech_streaming (cloning on) through the official
    chain: first audio, wall, chunks; the streamed TTS samples add up to the
    streamed tokens × samples a token; no resblock launch."""
    from expressive_speech_translation_tpu_torch.models import cosyvoice

    tts = backend.engines.tts
    spt = tts.official_cfg.flow.token_mel_ratio * tts.official_cfg.hift.hop
    eos = tts.official_cfg.lm.eos_speech
    x = _speechlike(OFFICIAL_SECONDS, seed=302)
    tts_chunks, lm_chunks, events = [], [], []
    synth = tts.synthesize_streaming

    def counted(*args, **kwargs):
        for chunk in synth(*args, **kwargs):
            tts_chunks.append(len(chunk))
            yield chunk

    def tokens_until_eos(args, kw, out):
        tok = out[0][0].cpu().numpy()
        return int(np.argmax(tok == eos)) if (tok == eos).any() else len(tok)

    _reset_launches()
    first_audio = None
    tts.synthesize_streaming = counted
    try:
        with _recording_calls(cosyvoice, "lm_stream_chunk", lm_chunks, tokens_until_eos):
            t0 = time.perf_counter()
            for ev in backend.translate_speech_streaming(x, "eng", "fra"):
                if ev["type"] == "audio" and first_audio is None:
                    first_audio = time.perf_counter() - t0
                events.append(ev["type"])
            wall = time.perf_counter() - t0
    finally:
        del tts.synthesize_streaming
    launches = _read_launches()
    tokens = sum(lm_chunks)      # a stream stops after the first chunk that ends early
    print(f"  {OFFICIAL_SECONDS:.0f} s stream (official chain): first audio at "
          f"{first_audio or math.nan:.3f} s, wall {wall:.3f} s, events {events}, TTS chunks "
          f"{tts_chunks} samples for {lm_chunks} tokens a chunk, launches {launches}  [{card}]",
          flush=True)
    if first_audio is None or not tts_chunks:
        raise AssertionError("official stream gave no audio")
    if sum(tts_chunks) != tokens * spt:
        raise AssertionError(f"official stream: {sum(tts_chunks)} samples for {tokens} tokens "
                             f"× {spt}")
    if launches["fused_resblock_stage"] or launches["log_mel_frames"] < 1:
        raise AssertionError(f"official stream launches {launches}")
    return {"first_audio_s": first_audio, "wall_s": wall, "events": events,
            "tts_chunk_samples": tts_chunks, "lm_chunk_tokens": lm_chunks, "tokens": tokens,
            "launches": launches}


def _tensors_equal(got, want, path="") -> None:
    if isinstance(want, dict):
        if set(got) != set(want):
            raise AssertionError(f"loader round trip: keys differ at {path}")
        for k in want:
            _tensors_equal(got[k], want[k], f"{path}.{k}")
    elif isinstance(want, list):
        if len(got) != len(want):
            raise AssertionError(f"loader round trip: lengths differ at {path}")
        for i, (g, w) in enumerate(zip(got, want)):
            _tensors_equal(g, w, f"{path}[{i}]")
    elif not (got.dtype == want.dtype and got.shape == want.shape
              and torch.equal(got, want.to(got.device))):
        raise AssertionError(f"loader round trip: tensor differs at {path}")


def official_loaders(params, cfg, dev, card) -> dict:
    """The full-width flow.pt and hift.pt written by the port's emitters into
    a temporary directory and read back by the loaders onto the card: the
    flow's config inferred from the tensors equals ``OfficialFlowConfig()``,
    and every tensor is equal."""
    import tempfile

    from expressive_speech_translation_tpu_torch.models import flow_matcha, hift, loaders

    t0 = time.perf_counter()
    with tempfile.TemporaryDirectory() as tmp:
        torch.save(flow_matcha.to_flow_state_dict(params["flow"]),
                   os.path.join(tmp, "flow.pt"))
        torch.save(hift.to_hift_state_dict(params["hift"], cfg.hift), os.path.join(tmp, "hift.pt"))
        sizes = {n: os.path.getsize(os.path.join(tmp, n)) / 2**20 for n in ("flow.pt", "hift.pt")}
        flow, flow_cfg = loaders.load_cosyvoice_flow(os.path.join(tmp, "flow.pt"), device=dev)
        hift_params, hift_cfg = loaders.load_cosyvoice_hift(os.path.join(tmp, "hift.pt"),
                                                             device=dev)
    seconds = time.perf_counter() - t0
    if flow_cfg != flow_matcha.OfficialFlowConfig() or hift_cfg != cfg.hift:
        raise AssertionError(f"loaders inferred {flow_cfg}, {hift_cfg}")
    _tensors_equal(flow, params["flow"], "flow")
    _tensors_equal(hift_params, params["hift"], "hift")
    print(f"  loaders: flow.pt {sizes['flow.pt']:.1f} MiB and hift.pt {sizes['hift.pt']:.1f} MiB "
          f"written and read back in {seconds:.2f} s, the flow's config inferred, every tensor "
          f"equal  [{card}]", flush=True)
    return {"seconds": seconds, "mib": sizes}


def official_source(tts, params, card) -> dict:
    """The HiFT source of one 10 s f0 track of bf16-representable values
    (200 Hz rising to 250 Hz) with the engine's bf16 HiFT parameters and
    with their f32 copies, and again through a merge reading the fundamental
    alone at a gain of 10 (a source swinging ±0.76): the port integrates the
    phase in f32 in both, so the largest difference is the bf16 output's
    rounding."""
    from expressive_speech_translation_tpu_torch.models import hift

    cfg = tts.official_cfg.hift
    frames = int(OFFICIAL_SECONDS * cfg.sampling_rate) // cfg.hop
    f0 = torch.linspace(200.0, 250.0, frames, device=tts.device).to(torch.bfloat16)[None]
    merge = torch.zeros((cfg.nb_harmonics + 1, 1), device=tts.device)
    merge[0, 0] = 10.0
    gain = {"kernel": merge, "bias": torch.zeros(1, device=tts.device)}
    out = {}
    for label, bf16, f32 in (("engine", tts.params["hift"], params["hift"]),
                             ("gain 10", {**tts.params["hift"], "m_source": {
                                 "l_linear": {k: v.to(torch.bfloat16) for k, v in gain.items()}}},
                              {**params["hift"], "m_source": {"l_linear": gain}})):
        src_bf16 = hift.harmonic_source(bf16, cfg, None, f0, deterministic=True)
        src_f32 = hift.harmonic_source(f32, cfg, None, f0.float(), deterministic=True)
        diff = float((src_bf16.float() - src_f32).abs().max())
        peak = float(src_f32.abs().max())
        out[label] = {"max_abs_diff": diff, "peak": peak, "dtype": str(src_bf16.dtype)}
        print(f"  HiFT source of {OFFICIAL_SECONDS:.0f} s of f0, {label} merge: bf16 against f32 "
              f"{diff:.3e} (peak {peak:.3f}, {src_bf16.dtype})  [{card}]", flush=True)
        if not (src_bf16.dtype == torch.bfloat16 and diff <= OFFICIAL_SOURCE_ATOL):
            raise AssertionError(f"bf16 HiFT source departs from f32 by {diff}")
    return out


def official_phase(dev, report, card, e2e):
    """The official CosyVoice2 chain at full width on seeded random weights
    (bf16): engines, initialize(), one 10 s request, a batched dispatch, a
    10 s stream, the loaders' round trip, the bf16 source. The launch
    counters of the 10 s request are the phase's."""
    from expressive_speech_translation_tpu_torch.models import cosyvoice_official as com
    from expressive_speech_translation_tpu_torch.models import ecapa
    from expressive_speech_translation_tpu_torch.models import speech_tokenizer as stm
    from expressive_speech_translation_tpu_torch.pipeline.cascaded import CascadedBackend
    from expressive_speech_translation_tpu_torch.pipeline.torch_engines import torch_engines

    print("== official: CosyVoice2-0.5B official chain (Qwen2-0.5B LM, matcha flow, HiFT), "
          "bf16, random weights, voice cloning on", flush=True)
    t_phase = time.perf_counter()
    cfg = com.OfficialTtsConfig()
    params = com.init_official_tts(7, cfg, dev)
    # the random head's EOS logit lowered, so the LM runs its budget (the
    # native tree's random LM does) and the flow, HiFT and the stream see
    # full-length work; with this seed it otherwise stops after 5-19 tokens
    params["lm"]["head"]["bias"][cfg.lm.eos_speech] -= OFFICIAL_EOS_OFFSET
    ecfg, scfg = ecapa.EcapaConfig(), stm.SpeechTokenizerConfig()
    engines = torch_engines(scale="reference", tts_official=(params, cfg),
                            tts_ecapa=(ecapa.init_ecapa(3, ecfg, dev), ecfg),
                            tts_speech_tokenizer=(stm.init_speech_tokenizer(4, scfg, dev), scfg))
    backend = CascadedBackend(engines)
    backend.initialize()
    torch.cuda.synchronize()
    print(f"  engines and initialize {time.perf_counter() - t_phase:.1f} s, official TTS "
          f"{_tree_bytes(engines.tts.params) / 2**30:.2f} GiB in bf16", flush=True)
    official = {"request": official_request(backend, card, e2e)}
    official["launches"] = official["request"]["launches"]
    official["batch"] = official_batch(engines.tts, card)
    official["stream"] = official_stream(backend, card)
    official["loaders"] = official_loaders(params, cfg, dev, card)
    official["source"] = official_source(engines.tts, params, card)
    del engines, backend, params
    gc.collect()
    torch.cuda.empty_cache()
    official["seconds"] = time.perf_counter() - t_phase
    print(f"  official phase {official['seconds']:.1f} s", flush=True)
    report["official"] = official
    return official


CKPT_SECONDS = 10.0
# NLLB-200's tokenizer ids of the eng_Latn and fra_Latn language tokens: the
# card's machine has no tokenizer with token_to_id, and an engine with
# supplied weights uses no placeholder ids
NLLB_LANG_IDS = {"eng": 256_047, "eng_Latn": 256_047, "fra": 256_057, "fra_Latn": 256_057}
# The random NMT's shared-embedding rows of the byte tokenizer's a-z scaled by
# this, so its tied head speaks letters: with supplied NMT weights an empty
# translation fails the request (as in JAX), and random rows of a 256k
# vocabulary almost never decode to a byte
NMT_LETTER_SCALE = 8.0
CKPT_DISK_MARGIN = 2e9


def _ckpt_configs():
    """The published widths: Whisper-medium, NLLB-200-distilled-600M,
    spkrec-ecapa-voxceleb's ECAPA-TDNN, CosyVoice2-0.5B's official triple."""
    from expressive_speech_translation_tpu_torch.models import cosyvoice_official as com
    from expressive_speech_translation_tpu_torch.models import ecapa, nllb, whisper

    return (whisper.WhisperConfig.medium(), nllb.NLLBConfig.distilled_600m(),
            ecapa.EcapaConfig(), com.OfficialTtsConfig())


def _dir_bytes(path) -> int:
    return sum(os.path.getsize(os.path.join(d, f)) for d, _, fs in os.walk(path) for f in fs)


def _timed(label, fn, nbytes, card):
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    out = fn()
    torch.cuda.synchronize()
    seconds = time.perf_counter() - t0
    print(f"  {label}: {nbytes / 1e9:.3f} GB in {seconds:.2f} s, {nbytes / 1e9 / seconds:.3f} GB/s"
          f"  [{card}]", flush=True)
    return out, {"seconds": seconds, "gb": nbytes / 1e9, "gb_per_s": nbytes / 1e9 / seconds}


def checkpoints_write(tmp, dev, card) -> tuple:
    """Seeded random trees at the published widths, written in the published
    formats by ``obs/checkpoint_emitters.py``: HF Whisper as
    ``model.safetensors`` (the tied ``proj_out.weight`` stored once, under
    the embedding's name, as ``save_pretrained`` stores it), HF NLLB as
    ``pytorch_model.bin``, speechbrain's ``embedding_model.ckpt``, and the
    official ``llm.pt`` / ``flow.pt`` / ``hift.pt``. → (trees, configs,
    source directories, figures)."""
    from expressive_speech_translation_tpu_torch.models import cosyvoice_official as com
    from expressive_speech_translation_tpu_torch.models import ecapa, flow_matcha, hift, nllb
    from expressive_speech_translation_tpu_torch.models import whisper
    from expressive_speech_translation_tpu_torch.models.safetensors_io import write_safetensors
    from expressive_speech_translation_tpu_torch.obs import checkpoint_emitters as em

    wcfg, ncfg, ecfg, ocfg = _ckpt_configs()
    trees = {"asr": whisper.init_whisper(11, wcfg, dev), "nmt": nllb.init_nllb(12, ncfg, dev),
             "ecapa": ecapa.init_ecapa(13, ecfg, dev), "tts": com.init_official_tts(14, ocfg, dev)}
    letters = [4 + b for b in b"abcdefghijklmnopqrstuvwxyz"]
    trees["nmt"]["embed"][letters] *= NMT_LETTER_SCALE
    need = 2 * sum(_tree_bytes(t) for t in trees.values()) + CKPT_DISK_MARGIN
    free = shutil.disk_usage(tmp).free
    print(f"  {free / 1e9:.1f} GB free at {tmp}, {need / 1e9:.1f} GB needed", flush=True)
    if free < need:
        raise AssertionError(f"checkpoints phase: {free / 1e9:.1f} GB free at {tmp}, "
                             f"{need / 1e9:.1f} GB needed for the checkpoints and their bake")
    src = {k: os.path.join(tmp, "src", k) for k in trees}
    for d in src.values():
        os.makedirs(d)

    def whisper_files():
        state = em.whisper_hf_state_dict(trees["asr"], wcfg)
        del state["proj_out.weight"]
        write_safetensors(state, os.path.join(src["asr"], "model.safetensors"),
                          metadata={"format": "pt"})
        with open(os.path.join(src["asr"], "config.json"), "w") as f:
            json.dump(em.whisper_hf_config(wcfg), f, indent=2)

    def nllb_files():
        torch.save(em.nllb_hf_state_dict(trees["nmt"], ncfg),
                   os.path.join(src["nmt"], "pytorch_model.bin"))
        with open(os.path.join(src["nmt"], "config.json"), "w") as f:
            json.dump(em.nllb_hf_config(ncfg), f, indent=2)

    def official_files():
        tts = trees["tts"]
        torch.save(em.cosyvoice_llm_state_dict(tts["lm"], ocfg.lm),
                   os.path.join(src["tts"], "llm.pt"))
        torch.save(flow_matcha.to_flow_state_dict(tts["flow"]), os.path.join(src["tts"], "flow.pt"))
        torch.save(hift.to_hift_state_dict(tts["hift"], ocfg.hift),
                   os.path.join(src["tts"], "hift.pt"))

    writers = {"asr": whisper_files, "nmt": nllb_files, "tts": official_files,
               "ecapa": lambda: torch.save(em.ecapa_speechbrain_state_dict(trees["ecapa"], ecfg),
                                           os.path.join(src["ecapa"], "embedding_model.ckpt"))}
    figures = {}
    for name, write in writers.items():
        t0 = time.perf_counter()
        write()
        seconds = time.perf_counter() - t0
        nbytes = _dir_bytes(src[name])
        figures[name] = {"seconds": seconds, "gb": nbytes / 1e9}
        print(f"  wrote {name} ({', '.join(sorted(os.listdir(src[name])))}): "
              f"{nbytes / 1e9:.3f} GB in {seconds:.2f} s  [{card}]", flush=True)
    return trees, {"asr": wcfg, "nmt": ncfg, "ecapa": ecfg, "tts": ocfg}, src, figures


def checkpoints_load(trees, cfgs, src, dev, card) -> dict:
    """``load_whisper`` / ``load_nllb`` / ``load_ecapa`` onto the card: the
    configs read from config.json or the tensors equal the sources', and
    every tensor equals its source after the layout change."""
    from expressive_speech_translation_tpu_torch.models import loaders

    out = {}
    for name, load in (("asr", loaders.load_whisper), ("nmt", loaders.load_nllb),
                       ("ecapa", loaders.load_ecapa)):
        (params, cfg), out[name] = _timed(f"{load.__name__} onto the card", lambda: load(
            src[name], device=dev), _dir_bytes(src[name]), card)
        if cfg != cfgs[name]:
            raise AssertionError(f"{load.__name__} read {cfg}, not {cfgs[name]}")
        _tensors_equal(params, trees[name], name)
        del params
    return out


def checkpoints_bake(trees, cfgs, src, bake, dev, card) -> dict:
    """``bake_models`` of the four sources (the triple's configs given, as a
    deployment of another width gives them: head counts are not in the
    shapes), then ``load_converted`` of each stage and
    ``load_official_tts``: equal configs and tensors."""
    from expressive_speech_translation_tpu_torch.models import ecapa, loaders, nllb, whisper

    nbytes = sum(_dir_bytes(d) for d in src.values())
    _, out = _timed("bake_models (asr, nmt, ecapa, the official triple)", lambda: loaders.
                    bake_models(bake, asr=src["asr"], nmt=src["nmt"], ecapa=src["ecapa"],
                                tts=src["tts"], tts_llm_cfg=cfgs["tts"].lm,
                                tts_flow_cfg=cfgs["tts"].flow, tts_hift_cfg=cfgs["tts"].hift,
                                device=dev), nbytes, card)
    out["bake_gb"] = _dir_bytes(bake) / 1e9
    out["stages"] = sorted(os.listdir(bake))
    stages = {"asr": whisper.WhisperConfig, "nmt": nllb.NLLBConfig, "ecapa": ecapa.EcapaConfig}
    for name, cls in stages.items():
        (params, cfg), out[f"load_{name}"] = _timed(
            f"load_converted {name}/", lambda: loaders.load_converted(os.path.join(bake, name),
                                                                     cls, dev),
            _dir_bytes(os.path.join(bake, name)), card)
        if cfg != cfgs[name]:
            raise AssertionError(f"bake {name}: config {cfg}")
        _tensors_equal(params, trees[name], f"bake {name}")
        del params
    (params, cfg), out["load_official"] = _timed(
        "load_official_tts", lambda: loaders.load_official_tts(bake, dev),
        sum(_dir_bytes(os.path.join(bake, s)) for s in ("tts_llm", "tts_flow", "tts_hift")), card)
    if cfg != cfgs["tts"]:
        raise AssertionError(f"bake official: config {cfg}")
    _tensors_equal(params, trees["tts"], "bake official")
    del params
    print(f"  bake: {out['stages']}, {out['bake_gb']:.3f} GB; every config and tensor equal",
          flush=True)
    return out


def checkpoints_request(bake, tmp, dev, card, e2e) -> dict:
    """``EST_MODELS_DIR`` at the bake with the official triple moved out (so
    the native TTS runs the resblock kernel): ``torch_engines(scale=
    "reference")`` serves ASR, NMT and the ECAPA conditioning from it, and
    one 10 s ``translate_speech`` with cloning on reads its audio back
    through ``write_wav`` / ``read_wav``; the launch counters are set to 0
    just before it and read after: one log-mel launch a rung of the ASR's
    temperature ladder (with supplied weights, 0.0 to 1.0 until the gates
    pass), 2 resblock."""
    from expressive_speech_translation_tpu_torch.media.wavio import read_wav, write_wav
    from expressive_speech_translation_tpu_torch.pipeline.cascaded import CascadedBackend
    from expressive_speech_translation_tpu_torch.pipeline.torch_engines import torch_engines

    served = os.path.join(tmp, "served")
    os.makedirs(served)
    for stage in ("asr", "nmt", "ecapa"):
        os.rename(os.path.join(bake, stage), os.path.join(served, stage))
    os.environ["EST_MODELS_DIR"] = served
    try:
        t0 = time.perf_counter()
        engines = torch_engines(scale="reference", lang_code_to_id=NLLB_LANG_IDS)
        torch.cuda.synchronize()
        engines_s = time.perf_counter() - t0
    finally:
        del os.environ["EST_MODELS_DIR"]
    flags = {"asr_weightless": engines.asr.weightless, "nmt_weightless": engines.nmt.weightless,
             "tts_weightless": engines.tts.weightless,
             "conditioning_weightless": engines.tts.conditioning_weightless,
             "official": engines.tts.official is not None}
    print(f"  torch_engines from EST_MODELS_DIR in {engines_s:.1f} s: {flags}", flush=True)
    if (flags["asr_weightless"] or flags["nmt_weightless"] or flags["conditioning_weightless"]
            or flags["official"]):
        raise AssertionError(f"EST_MODELS_DIR engines: {flags}")
    wav = os.path.join(tmp, "request.wav")
    write_wav(wav, _speechlike(CKPT_SECONDS, seed=401), 16_000)
    x, sr = read_wav(wav)
    if sr != 16_000 or x.shape != (int(16_000 * CKPT_SECONDS),):
        raise AssertionError(f"read_wav gave {x.shape} at {sr} Hz")
    backend = CascadedBackend(engines)
    temps, res_shapes = [], []
    _reset_launches()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    with _recording_calls(engines.asr, "_decode", temps, lambda a, kw, out: a[2]), \
            _recording_resblock_shapes(res_shapes):
        out = backend.translate_speech(x, "eng", "fra")
    wall = time.perf_counter() - t0
    launches = _read_launches()
    _check_request(out, CKPT_SECONDS, "checkpoints 10 s request")
    stages = {k: v["seconds"] for k, v in out["stage_summary"].items()}
    native = next(r for r in e2e["requests"] if r["audio_s"] == CKPT_SECONDS)
    print(f"  {CKPT_SECONDS:.0f} s request from the bake: wall {wall:.3f} s, RTF "
          f"{wall / CKPT_SECONDS:.4f}  " + "  ".join(f"{k} {v:.3f} s" for k, v in stages.items())
          + f"  (random weights, e2e phase: wall {native['wall_s']:.3f} s  "
          + "  ".join(f"{k} {v:.3f} s" for k, v in native["stages_s"].items()) + f")  [{card}]",
          flush=True)
    print(f"    ASR temperatures run {temps}; target {len(out['transcripts']['target'])} chars; "
          f"launches {launches}", flush=True)
    vc = engines.tts.cfg.vocoder
    narrow = sum(1 for i in range(len(vc.upsample_rates))       # vocode's narrow stages: 2
                 if (c := vc.base_channels // 2 ** (i + 1)) <= 128 and c % 8 == 0)
    # each rung of the ladder computes its window's log-mel again, as each
    # call of JAX's jitted decode runs the Pallas mel kernel
    if launches["log_mel_frames"] != len(temps) or launches["fused_resblock_stage"] != narrow:
        raise AssertionError(f"checkpoints request launched {launches}, not {len(temps)} "
                             f"log-mel (one a rung) and {narrow} resblock")
    result = {"wall_s": wall, "rtf": wall / CKPT_SECONDS, "stages_s": stages, "flags": flags,
              "engines_s": engines_s, "asr_temperatures": temps, "launches": launches,
              "target_chars": len(out["transcripts"]["target"]),
              "resblock_request": time_request_resblock(dev, res_shapes, card,
                                                        "the checkpoints request")}
    del engines, backend
    return result


def checkpoints_refusal(bake, tmp) -> str:
    """A stage directory with config.json and an orbax-style ``params/`` but
    no ``params.safetensors`` (the JAX package's bake) must raise."""
    from expressive_speech_translation_tpu_torch.models.loaders import WeightsNotFoundError
    from expressive_speech_translation_tpu_torch.pipeline.torch_engines import torch_engines

    orbax = os.path.join(tmp, "orbax", "asr")
    os.makedirs(os.path.join(orbax, "params"))
    shutil.copy(os.path.join(tmp, "served", "asr", "config.json"), orbax)
    os.environ["EST_MODELS_DIR"] = os.path.dirname(orbax)
    try:
        torch_engines(scale="reference")
    except WeightsNotFoundError as e:
        print(f"  an orbax stage directory is refused: {e}", flush=True)
        return str(e)
    finally:
        del os.environ["EST_MODELS_DIR"]
    raise AssertionError("an orbax stage directory was served")


def checkpoints_lipsync(tmp, dev, card) -> dict:
    """MuseTalk at its published width and a whisper-tiny, seeded random
    f32, written by the emitters in the MuseTalk release layout
    (``sd-vae-ft-mse/``, ``musetalk/pytorch_model.bin`` + ``musetalk.json``)
    and as an HF ``model.safetensors``; ``load_musetalk`` reads the pair
    back (equal config and tensors), ``bake_models(musetalk=...,
    musetalk_whisper=...)`` bakes both, and ``default_lipsync_fn(device=
    card)`` under ``EST_MODELS_DIR`` renders LIPSYNC_BAKE_FRAMES frames: it
    must take the whisper condition, so log-mel launches once."""
    from expressive_speech_translation_tpu_torch.models import loaders
    from expressive_speech_translation_tpu_torch.models import musetalk as mtm
    from expressive_speech_translation_tpu_torch.models import whisper
    from expressive_speech_translation_tpu_torch.models.safetensors_io import write_safetensors
    from expressive_speech_translation_tpu_torch.obs import checkpoint_emitters as em
    from expressive_speech_translation_tpu_torch.pipeline.musetalk_pipeline import (
        default_lipsync_fn)

    cfg, wcfg = mtm.MuseTalkConfig(), whisper.WhisperConfig.tiny()
    params, wparams = mtm.init_musetalk(31, cfg, dev), whisper.init_whisper(32, wcfg, dev)
    need = 3 * (_tree_bytes(params) + _tree_bytes(wparams)) + CKPT_DISK_MARGIN
    if shutil.disk_usage(tmp).free < need:
        raise AssertionError(f"checkpoints lipsync: {need / 1e9:.1f} GB needed at {tmp}")
    src, wdir, bake = (os.path.join(tmp, d) for d in ("musetalk_src", "whisper_tiny", "mt_bake"))

    def write():
        em.write_musetalk(src, params, cfg)
        os.makedirs(wdir)
        state = em.whisper_hf_state_dict(wparams, wcfg)
        del state["proj_out.weight"]
        write_safetensors(state, os.path.join(wdir, "model.safetensors"), metadata={"format": "pt"})
        with open(os.path.join(wdir, "config.json"), "w") as f:
            json.dump(em.whisper_hf_config(wcfg), f, indent=2)

    _, out = _timed("wrote MuseTalk (sd-vae-ft-mse/, musetalk/) and whisper-tiny", write,
                    _tree_bytes(params) + _tree_bytes(wparams), card)
    (loaded, got_cfg), out["load"] = _timed("load_musetalk onto the card", lambda: loaders.
                                            load_musetalk(src, device=dev), _dir_bytes(src), card)
    if got_cfg != cfg:
        raise AssertionError(f"load_musetalk read {got_cfg}")
    _tensors_equal(loaded, params, "musetalk")
    del loaded, params, wparams
    _, out["bake"] = _timed("bake_models (musetalk, musetalk_whisper)", lambda: loaders.
                            bake_models(bake, musetalk=src, musetalk_whisper=wdir, device=dev),
                            _dir_bytes(src) + _dir_bytes(wdir), card)
    os.environ["EST_MODELS_DIR"] = bake
    try:
        t0 = time.perf_counter()
        fn = default_lipsync_fn(device=dev)
        torch.cuda.synchronize()
        out["build_s"] = time.perf_counter() - t0
    finally:
        del os.environ["EST_MODELS_DIR"]
    condition = fn.pipeline.audio_feature_fn.__qualname__
    frames = np.stack(frontend_frames()[:LIPSYNC_BAKE_FRAMES])
    dub = _KEPT["dub"][: int(16_000 * LIPSYNC_BAKE_FRAMES / FRONTEND_FPS)]
    _reset_launches()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    rendered = fn(frames, FRONTEND_FPS, dub, 16_000)
    out["render_s"] = time.perf_counter() - t0
    out["launches"] = _read_launches()
    print(f"  default_lipsync_fn from the bake: built in {out['build_s']:.2f} s (condition "
          f"{condition}), {LIPSYNC_BAKE_FRAMES} frames in {out['render_s']:.3f} s, launches "
          f"{out['launches']}  [{card}]", flush=True)
    if not condition.startswith("whisper_feature_fn") or out["launches"]["log_mel_frames"] != 1:
        raise AssertionError(f"the bake's lip-sync took {condition} and launched "
                             f"{out['launches']}, not the whisper condition and log-mel once")
    if rendered.shape != frames.shape or rendered.dtype != np.uint8 or not (rendered != frames).any():
        raise AssertionError(f"the bake's lip-sync gave {rendered.shape} {rendered.dtype}")
    del fn
    return out


def checkpoints_diff2lip(tmp, dev, card) -> dict:
    """diff2lip at its published width, seeded random f32, written by the
    emitter as diff2lip's pickled ``e2e.pt`` (``module.``-prefixed keys, the
    qkv head-major); ``load_diff2lip`` reads it back (equal config and
    tensors), ``bake_models(diff2lip=...)`` bakes it, ``load_converted``
    reads the bake (equal), and ``Diff2LipPipeline.from_models_dir`` renders
    DIFF2LIP_BAKE_FRAMES frames from it."""
    from expressive_speech_translation_tpu_torch.models import loaders
    from expressive_speech_translation_tpu_torch.obs import checkpoint_emitters as em
    from expressive_speech_translation_tpu_torch.pipeline import diff2lip as d2l

    cfg = d2l.Diff2LipConfig()
    params = d2l.init_diff2lip_unet(41, cfg, dev)
    nbytes = _tree_bytes(params)
    need = 3 * nbytes + CKPT_DISK_MARGIN
    if shutil.disk_usage(tmp).free < need:
        raise AssertionError(f"checkpoints diff2lip: {need / 1e9:.1f} GB needed at {tmp}")
    src, bake = os.path.join(tmp, "diff2lip_src"), os.path.join(tmp, "d2l_bake")
    _, out = _timed("wrote diff2lip e2e.pt", lambda: em.write_diff2lip(
        os.path.join(src, "e2e.pt"), params, cfg.unet), nbytes, card)
    (loaded, got_cfg), out["load"] = _timed("load_diff2lip onto the card", lambda: loaders.
                                            load_diff2lip(src, device=dev), _dir_bytes(src), card)
    if got_cfg != cfg:
        raise AssertionError(f"load_diff2lip read {got_cfg}")
    _tensors_equal(loaded, params, "diff2lip")
    del loaded
    _, out["bake"] = _timed("bake_models (diff2lip)", lambda: loaders.bake_models(
        bake, diff2lip=src, device=dev), _dir_bytes(src), card)
    (baked, baked_cfg), out["load_converted"] = _timed(
        "load_converted diff2lip/", lambda: loaders.load_converted(
            os.path.join(bake, "diff2lip"), d2l.Diff2LipConfig, dev),
        _dir_bytes(os.path.join(bake, "diff2lip")), card)
    if baked_cfg != cfg:
        raise AssertionError(f"bake diff2lip: config {baked_cfg}")
    _tensors_equal(baked, params, "bake diff2lip")
    del baked, params
    t0 = time.perf_counter()
    pipe = d2l.Diff2LipPipeline.from_models_dir(bake, device=dev)
    torch.cuda.synchronize()
    out["build_s"] = time.perf_counter() - t0
    frames = np.stack(frontend_frames()[:DIFF2LIP_BAKE_FRAMES])
    dub = _KEPT["dub"][: int(16_000 * DIFF2LIP_BAKE_FRAMES / FRONTEND_FPS)]
    _reset_launches()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    rendered = pipe.generate(frames, dub, FRONTEND_FPS)
    out["render_s"] = time.perf_counter() - t0
    out["launches"] = _read_launches()
    print(f"  Diff2LipPipeline.from_models_dir: built in {out['build_s']:.2f} s, "
          f"{DIFF2LIP_BAKE_FRAMES} frames in {out['render_s']:.3f} s, launches "
          f"{out['launches']}  [{card}]", flush=True)
    if (rendered.shape != frames.shape or rendered.dtype != np.uint8
            or not (rendered != frames).any() or any(out["launches"].values())):
        raise AssertionError(f"the diff2lip bake rendered {rendered.shape} {rendered.dtype}, "
                             f"launches {out['launches']}")
    del pipe
    return out


def checkpoints_phase(dev, report, card, e2e):
    """Seeded random Whisper-medium, NLLB-600M, ECAPA and the official
    CosyVoice2 triple written in their published formats to a temporary
    directory, loaded back, baked and reloaded (equal tensors), one 10 s
    request served from the bake through EST_MODELS_DIR, and the orbax
    refusal; the directory is deleted after. The launch counters of the
    request are the phase's."""
    import tempfile

    print("== checkpoints: Whisper-medium (model.safetensors), NLLB-600M (pytorch_model.bin), "
          "ECAPA (embedding_model.ckpt), CosyVoice2 llm/flow/hift.pt, f32, random weights",
          flush=True)
    t_phase = time.perf_counter()
    tmp = tempfile.mkdtemp(prefix="est_checkpoints_")
    try:
        trees, cfgs, src, written = checkpoints_write(tmp, dev, card)
        ckpt = {"written": written, "loaded": checkpoints_load(trees, cfgs, src, dev, card)}
        bake = os.path.join(tmp, "bake")
        ckpt["bake"] = checkpoints_bake(trees, cfgs, src, bake, dev, card)
        del trees
        shutil.rmtree(os.path.join(tmp, "src"))
        gc.collect()
        torch.cuda.empty_cache()
        ckpt["request"] = checkpoints_request(bake, tmp, dev, card, e2e)
        ckpt["launches"] = ckpt["request"]["launches"]
        ckpt["refusal"] = checkpoints_refusal(bake, tmp)
        shutil.rmtree(os.path.join(tmp, "served"))
        gc.collect()
        torch.cuda.empty_cache()
        ckpt["lipsync"] = checkpoints_lipsync(tmp, dev, card)
        gc.collect()
        torch.cuda.empty_cache()
        ckpt["diff2lip"] = checkpoints_diff2lip(tmp, dev, card)
    finally:
        shutil.rmtree(tmp, ignore_errors=True)
    gc.collect()
    torch.cuda.empty_cache()
    ckpt["seconds"] = time.perf_counter() - t_phase
    print(f"  checkpoints phase {ckpt['seconds']:.1f} s", flush=True)
    report["checkpoints"] = ckpt
    return ckpt


ALT_SECONDS = 10.0            # the request each alternate backend serves
ALT_BEAMS = 5                 # SeamlessBackend's default (translate_speech.py's num_beams)
ALT_TEXT_TOKENS = 64          # SeamlessBackend's default text budget
ALT_F32_SECONDS = 2.0         # the f32 card-against-CPU check of the speech encoder
ALT_F32_UNITS = 50            # and of the code HiFi-GAN
ALT_F32_RTOL = 1e-4           # f32 on the card against device="cpu": max |diff| / peak
ALT_DISK_MARGIN = 2e9
SEAMLESS_OUT_GAIN = 2e4       # the random vocoder's output conv scaled: its wave peaks near 1e-5
# The language maps written into the emitted generation_config.json: NLLB-200's
# token ids of eng_Latn / fra_Latn (inside Seamless's 256,102-row vocabulary)
# and two vocoder language rows; a real checkpoint's file gives its own
SEAMLESS_LANG_IDS = {"eng": 256_047, "fra": 256_057}
SEAMLESS_VOCODER_LANG_IDS = {"eng": 0, "fra": 1}


def _seamless_config():
    """SeamlessM4T-v2-large's published widths (the rehearsal on the CPU
    patches this to the toy config)."""
    from expressive_speech_translation_tpu_torch.models import seamless as sm

    return sm.SeamlessConfig.v2_large()


def alternate_checkpoint(tmp, dev, card) -> tuple:
    """Seamless at its published width, f32, seeded random weights (the
    vocoder's output conv scaled by SEAMLESS_OUT_GAIN, so the random
    waveform spans the audio range rather than ~1e-5): emitted
    by ``write_seamless`` as sharded safetensors with their index,
    ``config.json`` and ``generation_config.json`` (free disk checked
    first), read back by ``load_seamless`` / ``load_seamless_aux`` (config,
    maps and every tensor equal), baked by ``bake_models(seamless=...)``,
    each timed with its GB/s; then the f32 check on the same tree. → (the
    figures, the bake's root)."""
    from expressive_speech_translation_tpu_torch.models import loaders
    from expressive_speech_translation_tpu_torch.models import seamless as sm
    from expressive_speech_translation_tpu_torch.obs import checkpoint_emitters as em

    cfg = _seamless_config()
    params = sm.init_seamless(19, cfg, dev)
    params["vocoder"]["hifi"]["conv_post"]["kernel"].mul_(SEAMLESS_OUT_GAIN)
    nbytes = _tree_bytes(params)
    n_params = nbytes // 4
    need = 2 * nbytes + ALT_DISK_MARGIN
    free = shutil.disk_usage(tmp).free
    print(f"  SeamlessM4T-v2 at its published width (hidden {cfg.hidden}, conformer "
          f"{cfg.speech_layers} layers, text decoder {cfg.decoder_layers} x vocab "
          f"{cfg.vocab_size}, t2u {cfg.t2u_encoder_layers}+{cfg.t2u_decoder_layers}, code HiFi-GAN "
          f"{cfg.upsample_initial_channel} x{cfg.upsample_rates}): {n_params / 1e9:.3f} B "
          f"parameters, {nbytes / 1e9:.3f} GB in f32; {free / 1e9:.1f} GB free at {tmp}, "
          f"{need / 1e9:.1f} GB needed", flush=True)
    if free < need:
        raise AssertionError(f"alternate phase: {free / 1e9:.1f} GB free at {tmp}, "
                             f"{need / 1e9:.1f} GB needed")
    tables = sum(_tree_bytes(t) for t in (params["text_decoder"]["pos"],
                                          params["t2u"]["decoder"]["pos"]))
    src = os.path.join(tmp, "seamless-m4t-v2-large")
    _, emit = _timed("write_seamless (sharded safetensors + index, config, generation config)",
                     lambda: em.write_seamless(src, params, cfg,
                                               text_lang_ids=SEAMLESS_LANG_IDS,
                                               vocoder_lang_ids=SEAMLESS_VOCODER_LANG_IDS),
                     nbytes - tables, card)                  # the sinusoid tables stay out
    with open(os.path.join(src, "model.safetensors.index.json")) as f:
        shards = json.load(f)
    (loaded, loaded_cfg), load = _timed("load_seamless", lambda: loaders.load_seamless(
        src, device=dev), _dir_bytes(src), card)
    if loaded_cfg != cfg:
        raise AssertionError(f"load_seamless read {loaded_cfg}")
    _tensors_equal(loaded, params, "load_seamless")
    aux = loaders.load_seamless_aux(src)
    if aux != {"text_decoder_lang_to_code_id": SEAMLESS_LANG_IDS,
               "vocoder_lang_code_to_id": SEAMLESS_VOCODER_LANG_IDS}:
        raise AssertionError(f"load_seamless_aux read {aux}")
    del loaded
    gc.collect()
    torch.cuda.empty_cache()
    bake = os.path.join(tmp, "bake")
    _, baked = _timed("bake_models(seamless=...)", lambda: loaders.bake_models(
        bake, seamless=src, device=dev), nbytes, card)
    stage = os.path.join(bake, "seamless")
    if sorted(os.listdir(stage)) != ["config.json", "generation_maps.json", "params.safetensors"]:
        raise AssertionError(f"the seamless bake holds {sorted(os.listdir(stage))}")
    print(f"  {len(set(shards['weight_map'].values()))} shards, {_dir_bytes(src) / 1e9:.3f} GB "
          f"emitted; load_seamless equal (config, maps, every tensor); the bake's "
          f"params.safetensors {os.path.getsize(os.path.join(stage, 'params.safetensors')) / 1e9:.3f}"
          f" GB", flush=True)
    shutil.rmtree(src)
    check = alternate_f32_check(params, cfg, dev, card)
    del params
    gc.collect()
    torch.cuda.empty_cache()
    return {"params": n_params, "gb": nbytes / 1e9, "emit": emit, "load": load, "bake": baked,
            "shards": len(set(shards["weight_map"].values())), "f32_check": check}, bake


def alternate_f32_check(params, cfg, dev, card) -> dict:
    """In f32 on the card against ``device="cpu"`` (a host copy of the
    subtree each needs): ``encode_speech`` of 2 s of features and
    ``code_hifigan`` of 50 units, each held to ALT_F32_RTOL of its peak."""
    from expressive_speech_translation_tpu_torch.models import seamless as sm
    from expressive_speech_translation_tpu_torch.pipeline.alternate_backends import (
        bandpass_80_7500, seamless_features)

    x = bandpass_80_7500(_speechlike(ALT_F32_SECONDS, seed=81))
    feats, mask = seamless_features(x, device=dev)
    units = np.random.default_rng(82).integers(0, cfg.unit_vocab_vocoder, (1, ALT_F32_UNITS))
    runs = {
        "encode_speech": (lambda tree, d: sm.encode_speech(
            tree, cfg, torch.from_numpy(feats).to(d), torch.from_numpy(mask).to(d))[0],
            "speech_encoder"),
        "code_hifigan": (lambda tree, d: sm.code_hifigan(
            tree, cfg, torch.from_numpy(units).to(d), 0, SEAMLESS_VOCODER_LANG_IDS["fra"],
            max_frames=2 * ALT_F32_UNITS)[0], "vocoder"),
    }
    out = {}
    for name, (fn, part) in runs.items():
        got, secs = {}, {}
        for where, device, tree in (("card", dev, {part: params[part]}),
                                    ("cpu", torch.device("cpu"),
                                     {part: _tree_to(params[part], "cpu")})):
            t0 = time.perf_counter()
            with torch.no_grad():
                got[where] = fn(tree, device).float().cpu()
            secs[where] = time.perf_counter() - t0
        peak = float(got["cpu"].abs().max())
        err = float((got["card"] - got["cpu"]).abs().max())
        if not (peak > 0 and err <= ALT_F32_RTOL * peak):
            raise AssertionError(f"Seamless {name} f32 card against CPU: {err} > "
                                 f"{ALT_F32_RTOL} * {peak}")
        print(f"  Seamless {name} f32 ({tuple(got['card'].shape)}), card against device=\"cpu\": "
              f"max |diff| {err:.3e} at a peak of {peak:.4f} ({err / peak:.2e} of it; limit "
              f"{ALT_F32_RTOL:g}); card {secs['card']:.3f} s, CPU {secs['cpu']:.3f} s  [{card}]",
              flush=True)
        out[name] = {"max_abs_err": err, "peak": peak, "card_s": secs["card"],
                     "cpu_s": secs["cpu"]}
    return out


def alternate_seamless(bake, dev, card) -> tuple:
    """``SeamlessBackend.from_models_dir()`` under EST_MODELS_DIR (weights
    "loaded"), ``initialize()`` (the bf16 cast), and the 10 s request eng →
    fra at 5 beams and 64 text tokens, twice: seconds, RTF, samples against
    the vocoder's length and the horizon (2 × max_units × hop), |audio| ≤ 1,
    no launch of either kernel."""
    from expressive_speech_translation_tpu_torch.models import seamless as sm
    from expressive_speech_translation_tpu_torch.pipeline.alternate_backends import (
        SeamlessBackend)

    models_dir = os.environ.get("EST_MODELS_DIR")
    os.environ["EST_MODELS_DIR"] = bake
    try:
        t0 = time.perf_counter()
        backend = SeamlessBackend.from_models_dir(device=dev, num_beams=ALT_BEAMS,
                                                  max_text_tokens=ALT_TEXT_TOKENS)
        torch.cuda.synchronize()
        load_s = time.perf_counter() - t0
    finally:
        if models_dir is None:
            os.environ.pop("EST_MODELS_DIR")
        else:
            os.environ["EST_MODELS_DIR"] = models_dir
    if backend.weights_info() != "loaded" or backend._lang_ids("fra") != (
            SEAMLESS_LANG_IDS["fra"], SEAMLESS_VOCODER_LANG_IDS["fra"]):
        raise AssertionError(f"SeamlessBackend.from_models_dir: {backend.weights_info()}, "
                             f"{backend._lang_ids('fra')}")
    t0 = time.perf_counter()
    backend.initialize()
    torch.cuda.synchronize()
    init_s = time.perf_counter() - t0
    horizon = backend.max_units * 2 * backend.cfg.hop_total
    x = _speechlike(ALT_SECONDS, seed=83)
    runs, record = [], []
    _reset_launches()
    # each request's waveform width and vocoder lengths, which the backend trims to
    with _recording_calls(sm, "speech_from_text", record, lambda a, kw, out: {
            "width": int(out[0].shape[1]), "lengths": out[1].tolist(),
            "units": int(out[2]["unit_lengths"][0])}):
        for _ in range(2):
            t0 = time.perf_counter()
            out = backend.translate_speech(x, "eng", "fra")
            runs.append(time.perf_counter() - t0)
            audio = out["audio"]
            want = min(record[-1]["lengths"][0], record[-1]["width"])
            if not (audio.ndim == 2 and audio.shape[0] == 1 and audio.shape[1] == want
                    and 0 < want <= horizon and np.isfinite(audio).all()
                    and np.abs(audio).max() <= 1.0):
                raise AssertionError(f"Seamless request: {audio.shape}, vocoder length "
                                     f"{record[-1]}, horizon {horizon}")
    launches = _read_launches()
    if any(launches.values()):
        raise AssertionError(f"SeamlessBackend launched {launches}: no kernel lies on its path")
    print(f"  SeamlessBackend.from_models_dir (weights {backend.weights_info()!r}) {load_s:.2f} s, "
          f"initialize (bf16 cast) {init_s:.2f} s; the {ALT_SECONDS:.0f} s request eng -> fra at "
          f"{ALT_BEAMS} beams, {ALT_TEXT_TOKENS} text tokens: {runs[0]:.3f} s, then {runs[1]:.3f} s "
          f"(RTF {runs[1] / ALT_SECONDS:.4f}); {audio.shape[1]} samples at 16 kHz (the vocoder's "
          f"length, {record[-1]['units']} units; horizon {horizon}), peak "
          f"{np.abs(audio).max():.4f}; launches {launches}  [{card}]", flush=True)
    return backend, {"load_s": load_s, "initialize_s": init_s, "runs_s": runs,
                     "rtf": runs[1] / ALT_SECONDS, "samples": int(audio.shape[1]),
                     "peak": float(np.abs(audio).max()),
                     "units": record[-1]["units"], "horizon": horizon, "launches": launches,
                     "target_chars": len(out["transcripts"]["target"])}


def alternate_espnet(asr, dev, card) -> tuple:
    """``ESPnetBackend`` with the e2e phase's Whisper-medium engine as its
    ASR and the default VITS a language: the 10 s request twice (the first
    builds the VITS), log-mel launched once a request and the resblock never;
    16 kHz output of the VITS's 22,050 Hz samples resampled."""
    from expressive_speech_translation_tpu_torch.pipeline.alternate_backends import ESPnetBackend

    backend = ESPnetBackend(asr_factory=lambda lang: asr, device=dev)
    backend.initialize()
    x = _speechlike(ALT_SECONDS, seed=84)
    runs, launches = [], []
    for _ in range(2):
        _reset_launches()
        t0 = time.perf_counter()
        out = backend.translate_speech(x, "eng", "fra")
        torch.cuda.synchronize()
        runs.append(time.perf_counter() - t0)
        launches.append(_read_launches())
    tts = backend._tts_models["fra"]
    n22 = len(tts.synthesize(out["transcripts"]["target"]))
    want = -(-n22 * 16_000 // tts.sample_rate)
    audio = out["audio"]
    if not (audio.shape == (1, want) and np.isfinite(audio).all()):
        raise AssertionError(f"ESPnet request: {audio.shape}, want (1, {want})")
    for got in launches:
        if got["log_mel_frames"] != 1 or got["fused_resblock_stage"] != 0:
            raise AssertionError(f"ESPnet request launched {got}: log-mel once, resblock never")
    print(f"  ESPnetBackend (the e2e Whisper-medium as ASR, VitsTTSModel('fra') at "
          f"{tts.sample_rate} Hz, weights {backend.weights_info()!r}): the {ALT_SECONDS:.0f} s "
          f"request {runs[0]:.3f} s with the VITS build, then {runs[1]:.3f} s (RTF "
          f"{runs[1] / ALT_SECONDS:.4f}); text {len(out['transcripts']['source'])} chars; "
          f"{n22} samples at 22,050 Hz -> {audio.shape[1]} at 16 kHz; launches {launches[-1]}"
          f"  [{card}]", flush=True)
    return backend, {"runs_s": runs, "rtf": runs[1] / ALT_SECONDS, "samples": int(audio.shape[1]),
                     "samples_22k": n22, "launches": launches[-1]}


def alternate_routes(cascaded, seamless, espnet, dev, tmp, card) -> dict:
    """The three backends on one ``TranslationManager`` (the e2e cascade the
    default) served by ``create_app(manager=...)`` over HTTP on localhost:
    ``/available-backends`` (Seamless "loaded", ESPnet "random") and
    ``/translate`` of the 10 s upload with ``backend=seamless``."""
    import werkzeug  # noqa: F401 — the card's machine has it; the route is served over HTTP

    from expressive_speech_translation_tpu_torch.core.config import AppConfig
    from expressive_speech_translation_tpu_torch.media.wavio import wav_bytes
    from expressive_speech_translation_tpu_torch.pipeline.backend import TranslationManager
    from expressive_speech_translation_tpu_torch.serve.app import create_app

    manager = TranslationManager()
    manager.register_backend("cascaded", cascaded, is_default=True)
    manager.register_backend("seamless", seamless)
    manager.register_backend("espnet", espnet)
    app = create_app(manager, AppConfig(temp_dir=tmp), device=dev)
    wav = wav_bytes(_speechlike(ALT_SECONDS, seed=85), 16_000)
    with _http_server(app) as request:
        status, body, _ = request("/available-backends")
        listed = json.loads(body)
        if status != 200 or listed["weights"].get("seamless") != "loaded" \
                or listed["weights"].get("espnet") != "random":
            raise AssertionError(f"/available-backends: {status} {listed}")
        _reset_launches()
        t0 = time.perf_counter()
        status, body, _ = request("/translate", {"target_language": "fra",
                                                 "source_language": "eng",
                                                 "backend": "seamless"},
                                  {"file": (wav, "upload.wav")})
        wall = time.perf_counter() - t0
        launches = _read_launches()
    if status != 200:
        raise AssertionError(f"/translate backend=seamless: {status} {body[:300]!r}")
    answer = json.loads(body)
    audio = _decoded_wav(answer["audio"])
    horizon = seamless.max_units * 2 * seamless.cfg.hop_total
    if not (answer["weights"] == "loaded" and 0 < audio.size <= horizon
            and np.isfinite(audio).all()) or any(launches.values()):
        raise AssertionError(f"/translate backend=seamless: weights {answer['weights']}, "
                             f"{audio.size} samples, launches {launches}")
    print(f"  over HTTP: /available-backends {listed['backends']}, weights {listed['weights']}; "
          f"/translate backend=seamless of a {ALT_SECONDS:.0f} s "
          f"upload {wall:.3f} s, {audio.size} samples, weights {answer['weights']!r}, launches "
          f"{launches}  [{card}]", flush=True)
    return {"wall_s": wall, "samples": int(audio.size), "weights": listed["weights"],
            "launches": launches}


def alternate_phase(dev, report, card, backend):
    """SeamlessM4T-v2 at its published width through the emitter, the loader
    and the bake, served by ``SeamlessBackend`` from EST_MODELS_DIR; the
    ESPnet backend over the e2e phase's ASR and the default VITS; both on a
    ``TranslationManager`` behind ``create_app`` over HTTP. The ESPnet
    request's launches are the phase's."""
    print("== alternate: SeamlessM4T-v2-large (emitted, loaded, baked, served), ESPnet "
          "(Whisper-medium + VITS), /translate backend=seamless over HTTP", flush=True)
    t_phase = time.perf_counter()
    torch.cuda.synchronize()
    base = torch.cuda.memory_allocated()
    torch.cuda.reset_peak_memory_stats()
    tmp = tempfile.mkdtemp(prefix="est_alternate_")
    try:
        alt, bake = alternate_checkpoint(tmp, dev, card)
        seamless, alt["seamless"] = alternate_seamless(bake, dev, card)
        shutil.rmtree(bake)
        espnet, alt["espnet"] = alternate_espnet(backend.engines.asr, dev, card)
        alt["route"] = alternate_routes(backend, seamless, espnet, dev, tmp, card)
    finally:
        shutil.rmtree(tmp, ignore_errors=True)
    del seamless, espnet
    gc.collect()
    torch.cuda.empty_cache()
    alt["launches"] = alt["espnet"]["launches"]
    alt["peak_gib_above_resident"] = (torch.cuda.max_memory_allocated() - base) / 2**30
    alt["seconds"] = time.perf_counter() - t_phase
    print(f"  peak {alt['peak_gib_above_resident']:.2f} GiB above what was resident; alternate "
          f"phase {alt['seconds']:.1f} s  [{card}]", flush=True)
    report["alternate"] = alt
    return alt


TOOLS_SECONDS = 10.0            # the translate / harvard fixture; short_audio is half of it
TOOLS_CONFIGS = (1, 2, 3, 5)    # config 4 needs the libav shim, which the card's machine lacks
SEMANTIC_ATOL = 1e-4            # f32 scores on the card against device="cpu"
SEMANTIC_TEXTS = ("The weather is fine today, and the station is not far from here.",
                  "Today the weather is good and the station is close by.")


def _cli(argv, dev, main=None) -> tuple:
    """(exit code, stdout) of ``main(argv)`` (the CLI's by default);
    ``--device cpu`` is added only for a CPU rehearsal, so on the card the
    entry point runs as a user runs it."""
    from expressive_speech_translation_tpu_torch import cli

    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        rc = (main or cli.main)([*argv, *([] if dev.type == "cuda" else ["--device", "cpu"])])
    return rc, buf.getvalue()


def tools_translate(tmp, dev, card) -> dict:
    """``est-torch translate`` with its default engines (toy ``torch_engines()``
    on the card): the JSON it prints, its stage xRT and its launches."""
    from expressive_speech_translation_tpu_torch.media.wavio import read_wav, write_wav

    src, dst = os.path.join(tmp, "translate_in.wav"), os.path.join(tmp, "translate_out.wav")
    write_wav(src, _speechlike(TOOLS_SECONDS, seed=61), 16_000)
    before = _read_launches()
    t0 = time.perf_counter()
    rc, out = _cli(["translate", src, dst, "--target-lang", "fra"], dev)
    wall = time.perf_counter() - t0
    launches = {k: v - before[k] for k, v in _read_launches().items()}
    body = json.loads(out)
    audio, sr = read_wav(dst)
    if rc != 0 or sr != 16_000 or audio.size < 16_000 * TOOLS_SECONDS or \
            not np.isfinite(audio).all() or set(body) != {"output", "transcripts", "stage_xrt"}:
        raise AssertionError(f"est-torch translate: rc {rc}, {body}, audio {audio.shape} @ {sr}")
    if launches["log_mel_frames"] < 1:
        raise AssertionError(f"est-torch translate launched no log-mel kernel: {launches}")
    print(f"  est-torch translate ({TOOLS_SECONDS:.0f} s, default engines: toy torch_engines on "
          f"the card): rc {rc}, wall {wall:.2f} s (engines built and warmed inside), stage xRT "
          f"{body['stage_xrt']}, launches {launches}  [{card}]", flush=True)
    return {"wall_s": wall, "stage_xrt": body["stage_xrt"], "launches": launches,
            "transcripts": body["transcripts"]}


def _timed_runners(vq, seconds: dict, launches: dict):
    """verify_quality's config runners wrapped to record each one's seconds
    (card synced) and launches; → the originals, to put back."""
    original = dict(vq._RUNNERS)

    def wrap(n, fn):
        def run(ctx):
            before = _read_launches()
            t0 = time.perf_counter()
            try:
                return fn(ctx)
            finally:
                if torch.cuda.is_available():
                    torch.cuda.synchronize()
                seconds[n] = time.perf_counter() - t0
                launches[n] = {k: v - before[k] for k, v in _read_launches().items()}
        return run

    for n, fn in original.items():
        vq._RUNNERS[n] = wrap(n, fn)
    return original


def tools_verify_quality(backend, bake, tmp, dev, card) -> dict:
    """``run_verify_quality`` of configs 1, 2, 3 and 5 over the e2e engines:
    every config must run; structure-only, as the weights are random."""
    from expressive_speech_translation_tpu_torch.evals import verify_quality as vq
    from expressive_speech_translation_tpu_torch.media.wavio import write_wav

    fixtures = {"harvard": os.path.join(tmp, "harvard.wav"),
                "short_audio": os.path.join(tmp, "short.wav")}
    write_wav(fixtures["harvard"], _speechlike(TOOLS_SECONDS, seed=62), 16_000)
    write_wav(fixtures["short_audio"], _speechlike(TOOLS_SECONDS / 2, seed=63), 16_000)
    scorer = vq.SpeakerScorer.from_models_dir(bake, device=dev)
    if not scorer.available:
        raise AssertionError(f"no ECAPA scorer from the bake at {bake}")
    seconds, launches = {}, {}
    original = _timed_runners(vq, seconds, launches)
    before = _read_launches()
    t0 = time.perf_counter()
    try:
        report = vq.run_verify_quality(out_dir=os.path.join(tmp, "vq"), configs=TOOLS_CONFIGS,
                                       engines=backend.engines, scorer=scorer,
                                       fixtures=fixtures, device=dev)
    finally:
        vq._RUNNERS.update(original)
    wall = time.perf_counter() - t0
    total = {k: v - before[k] for k, v in _read_launches().items()}
    for key, c in report["configs"].items():
        n = int(key.split("_")[0])
        print(f"    config {key}: ran {c['ran']}, {seconds[n]:.2f} s, launches {launches[n]}"
              + (f", error {c['error']}" if not c["ran"] else
                 f", gates {c['gates']}, spk_sim_delta mode "
                 f"{c['metrics'].get('spk_sim_mode', '-')}"), flush=True)
    if not all(c["ran"] for c in report["configs"].values()) or \
            report["overall"] != "structure-only":
        raise AssertionError(f"verify-quality: {json.dumps(report)[:2000]}")
    print(f"  verify-quality configs {TOOLS_CONFIGS}: mode {report['mode']}, overall "
          f"{report['overall']}, weights {report['weights']}, scorer {report['speaker_scorer']}, "
          f"{wall:.2f} s (initialize() inside), launches {total}  [{card}]", flush=True)
    return {"mode": report["mode"], "overall": report["overall"], "wall_s": wall,
            "config_s": seconds, "config_launches": launches, "launches": total,
            "report_elapsed_s": report["elapsed_s"]}


def tools_semantic(backend, dev, card) -> dict:
    """``SemanticScorer`` over the e2e NLLB-600M encoder: the bf16 tree as
    served, then an f32 copy on the card against the same on the CPU."""
    from expressive_speech_translation_tpu_torch.evals.semantic import SemanticScorer
    from expressive_speech_translation_tpu_torch.models.common import cast_floats

    nmt = backend.engines.nmt
    enc = {k: nmt.params[k] for k in ("embed", "pos", "encoder")}
    a, b = SEMANTIC_TEXTS
    out = {}
    for label, params, device in (("bf16", enc, dev),
                                  ("f32", cast_floats(enc, torch.float32), dev),
                                  ("f32_cpu", None, torch.device("cpu"))):
        if params is None:
            params = _tree_to(cast_floats(enc, torch.float32), "cpu")
        scorer = SemanticScorer(params=params, cfg=nmt.cfg, tokenizer=nmt.tokenizer,
                                device=device)
        t0 = time.perf_counter()
        sonar, bert = scorer.sonar_score(a, b), scorer.bert_score_f1(a, b)
        out[label] = {"sonar": sonar, "bert_f1": bert, "seconds": time.perf_counter() - t0}
        del params, scorer
    diff = max(abs(out["f32"][k] - out["f32_cpu"][k]) for k in ("sonar", "bert_f1"))
    out["f32_card_vs_cpu"] = diff
    for label in ("bf16", "f32", "f32_cpu"):
        r = out[label]
        if not (np.isfinite(r["sonar"]) and -1 <= r["sonar"] <= 1 and 0 < r["bert_f1"] <= 1):
            raise AssertionError(f"semantic scorer {label}: {r}")
    if not diff <= SEMANTIC_ATOL:
        raise AssertionError(f"semantic scorer f32 on the card off the CPU by {diff:.3g}")
    print("  semantic scorer (NLLB-600M encoder): "
          + "; ".join(f"{k} sonar {v['sonar']:.6f} bert_f1 {v['bert_f1']:.6f} in "
                      f"{v['seconds'] * 1e3:.1f} ms" for k, v in out.items() if k != "f32_card_vs_cpu")
          + f"; f32 card vs cpu max |Δ| {diff:.3g}  [{card}]", flush=True)
    gc.collect()
    if torch.cuda.is_available():
        torch.cuda.empty_cache()
    return out


def tools_embed(bake, tmp, dev, card) -> dict:
    """``est-torch embed`` of a 10 s WAV with the baked ECAPA stage."""
    from expressive_speech_translation_tpu_torch.media.wavio import write_wav

    src, dst = os.path.join(tmp, "embed_in.wav"), os.path.join(tmp, "embed.npy")
    write_wav(src, _speechlike(TOOLS_SECONDS, seed=64), 16_000)
    t0 = time.perf_counter()
    rc, out = _cli(["embed", src, dst, "--weights", bake], dev)
    wall = time.perf_counter() - t0
    body, emb = json.loads(out), np.load(dst)
    if rc != 0 or body != {"output": dst, "dim": 192, "weightless": False} or \
            emb.shape != (192,) or not np.isfinite(emb).all():
        raise AssertionError(f"est-torch embed: rc {rc}, {body}, {emb.shape}")
    print(f"  est-torch embed (baked ECAPA, 10 s): {body}, |e| {np.linalg.norm(emb):.4f}, "
          f"{wall:.2f} s  [{card}]", flush=True)
    return {"wall_s": wall, "dim": body["dim"]}


def tools_batch(tmp, dev, card) -> dict:
    """``create_manifest`` of one speech-like WAV, then the SLURM runner's
    entry point on its row 1 (its default backend: the fakes, the front end
    on the card)."""
    from expressive_speech_translation_tpu_torch.batch import manifest, runner
    from expressive_speech_translation_tpu_torch.media.wavio import write_wav

    data, out_dir = os.path.join(tmp, "dataset"), os.path.join(tmp, "batch_out")
    os.makedirs(data)
    write_wav(os.path.join(data, "row.wav"), _speechlike(TOOLS_SECONDS / 2, seed=65), 16_000)
    rows = manifest.create_manifest({"speech": data}, os.path.join(tmp, "m.csv"), per_dataset=1)
    t0 = time.perf_counter()
    rc, out = _cli([out_dir, "--manifest", os.path.join(tmp, "m.csv"), "--row", "1"], dev,
                   runner.main)
    wall = time.perf_counter() - t0
    job = rows[0]["job_id"]
    result = json.loads(out)
    if rc != 0 or result != {"job_id": job, "status": "ok"} or \
            not os.path.exists(os.path.join(out_dir, f"{job}.wav")):
        raise AssertionError(f"batch runner: rc {rc}, {result}, {os.listdir(out_dir)}")
    print(f"  manifest -> runner row 1: {result}, {wall:.2f} s  [{card}]", flush=True)
    return {"wall_s": wall, "status": result["status"]}


def tools_doctor(dev, card) -> dict:
    """``est-torch doctor``: every check ok but the media shim where the
    machine has no libav; its log-mel check is one launch against the plain
    version, read apart from the tools' path."""
    before = _read_launches()
    rc, out = _cli(["doctor"], dev)
    launches = {k: v - before[k] for k, v in _read_launches().items()}
    body = json.loads(out)
    bad = sorted(n for n, c in body["checks"].items() if not c["ok"])
    for n, c in body["checks"].items():
        print(f"    doctor {n}: {'ok' if c['ok'] else 'NOT OK'}: {c['detail']}", flush=True)
    if bad not in ([], ["native_media_shim"]) or rc != (0 if not bad else 1):
        raise AssertionError(f"est-torch doctor: rc {rc}, failing {bad}")
    print(f"  est-torch doctor: rc {rc}, not ok: {bad or 'none'}, launches {launches}  [{card}]",
          flush=True)
    return {"rc": rc, "not_ok": bad, "launches": launches}


def tools_phase(dev, report, card, backend):
    """The tools besides the server, on the card: ``est-torch translate``,
    verify-quality configs 1, 2, 3 and 5 over the e2e engines, the semantic
    scorer, ``embed``, the manifest and batch runner, then ``doctor``. The
    launches of translate, verify-quality and the runner are the phase's."""
    from expressive_speech_translation_tpu_torch.models import ecapa
    from expressive_speech_translation_tpu_torch.models.loaders import save_converted

    print("== tools: est-torch translate / embed / doctor, verify-quality configs "
          f"{TOOLS_CONFIGS} at reference width, the NLLB semantic scorer, manifest -> batch "
          "runner", flush=True)
    t_phase = time.perf_counter()
    torch.cuda.synchronize()
    base = torch.cuda.memory_allocated()
    torch.cuda.reset_peak_memory_stats()
    tmp = tempfile.mkdtemp(prefix="est_tools_")
    out = {}
    try:
        bake = os.path.join(tmp, "bake")
        ecfg = ecapa.EcapaConfig()
        save_converted(ecapa.init_ecapa(8, ecfg, dev), ecfg, os.path.join(bake, "ecapa"))
        _reset_launches()
        out["translate"] = tools_translate(tmp, dev, card)
        out["verify_quality"] = tools_verify_quality(backend, bake, tmp, dev, card)
        out["batch"] = tools_batch(tmp, dev, card)
        out["launches"] = _read_launches()
        out["semantic"] = tools_semantic(backend, dev, card)
        out["embed"] = tools_embed(bake, tmp, dev, card)
        out["doctor"] = tools_doctor(dev, card)
    finally:
        shutil.rmtree(tmp, ignore_errors=True)
    gc.collect()
    torch.cuda.empty_cache()
    out["peak_gib_above_resident"] = (torch.cuda.max_memory_allocated() - base) / 2**30
    out["seconds"] = time.perf_counter() - t_phase
    print(f"  launches (translate, verify-quality, runner) {out['launches']}; peak "
          f"{out['peak_gib_above_resident']:.2f} GiB above what was resident; tools phase "
          f"{out['seconds']:.1f} s  [{card}]", flush=True)
    report["tools"] = out
    return out


def _bound_by(flops, peak_rate, nbytes):
    return "operations" if flops / peak_rate >= nbytes / PEAK_BYTES else "bytes"


def _launches(name, e2e, front, serve, lipsync, diff2lip, services, batched, stream, mtp,
              official, ckpt, alt, tools) -> dict:
    """A kernel's launch count on each path driven: the three single
    requests, the detection of the 10 s request, the frontend's upload and
    video request, the serve phase's routes, the lip-sync render and its
    routes, the diff2lip phase, the services phase (the remote route, the
    MuseTalk and OpenVoice services), the batched requests, the two streamed
    requests, the mtp phase's TTS runs, the official chain's 10 s request,
    the 10 s request served from the bake, the alternate phase's ESPnet
    request (Seamless launches none), the tools phase's translate,
    verify-quality and batch runner."""
    return {"single": e2e["launches"][name], "detect": e2e["detect"]["launches"][name],
            "frontend": front["launches"][name], "serve": serve["launches"][name],
            "lipsync": lipsync["launches"][name], "diff2lip": diff2lip["launches"][name],
            "services": services["launches"][name],
            "batched": batched["launches"][name], "streaming": stream["launches"][name],
            "mtp": mtp["launches"][name], "official": official["launches"][name],
            "checkpoints": ckpt["launches"][name], "alternate": alt["launches"][name],
            "tools": tools["launches"][name]}


def _decode_entry(name, source, replaces, rows, e2e, front, serve, lipsync, diff2lip, services,
                  batched, stream, mtp, official, ckpt, alt, tools):
    """A decode kernel's entry: its first (bf16, B=1 or the first listed)
    shape's times; the library call is null (no single PyTorch call computes
    the fused function) and the cuBLAS chain's time rides beside it."""
    timed = next(r for r in rows if "ms" in r)
    return {"name": name, "route": "cuda", "source": f"{PORT}/csrc/{source}",
            "replaces": f"{REFERENCE}/{replaces}", "launches": e2e["launches"][name],
            "launches_by_path": _launches(name, e2e, front, serve, lipsync, diff2lip, services,
                                          batched, stream, mtp, official, ckpt, alt, tools),
            "max_abs_err": max(r["max_abs_err"] for r in rows),
            "ms": timed["ms"], "plain_ms": timed["plain_ms"], "bound_ms": timed["bound_ms"],
            "bound_by": _bound_by(timed["gflop"] * 1e9, PEAK_BF16, timed["mbytes"] * 1e6),
            "library_ms": None, "chain_ms": timed["chain_ms"],
            "chain_calls": timed["chain_calls"]}


def kernels_line(mel_rows, res_rows, mv_rows, mlp_rows, int4_rows, e2e, front, serve, lipsync,
                 diff2lip, services, batched, stream, mtp, official, ckpt, alt, tools):
    """One entry per kernel. ``launches`` counts the three single requests;
    ``launches_by_path`` adds the detection, the batched requests and the
    streamed ones.
    Log-mel at the default 30 s window and 80 mels, its times
    graph-replayed; the resblock stage as both narrow stages of 10 s of
    speech in bf16 (C=128, T=24000 and C=64, T=240000) at B=1 in the main
    path's layout, their times and bounds summed (the B=8 pair of a batched
    dispatch beside them, under ``b8_``, and the pair at a streamed chunk's
    shapes under ``stream_``; the contiguous layout, C=96 and the
    requests' shapes are timed beside, not summed); the decode kernels at
    the Whisper-medium shapes (and int4 at B=8, K=2048, N=8192) in bf16."""
    mel = next(r for r in mel_rows if r["window_s"] == 30 and r["n_mels"] == 80)
    serving, b8 = _res_pair(res_rows, 1), _res_pair(res_rows, RES_BATCH)
    streamed = [r for r in stream["resblock_request"] if r["layout"] == "bct"]
    return [
        {"name": "log_mel_frames", "route": "cuda",
         "source": f"{PORT}/csrc/log_mel.cu",
         "replaces": f"{REFERENCE}/ops/pallas_mel.py:79",
         "launches": e2e["launches"]["log_mel_frames"],
         "launches_by_path": _launches("log_mel_frames", e2e, front, serve, lipsync, diff2lip,
                                       services, batched, stream, mtp, official, ckpt, alt,
                                       tools),
         "max_abs_err": mel["max_abs_err"],
         "ms": mel["ms"], "plain_ms": mel["plain_ms"], "bound_ms": mel["bound_ms"],
         "bound_by": _bound_by(mel["gflop"] * 1e9, PEAK_FP32, mel["mbytes"] * 1e6),
         "library_ms": mel["library_ms"]},
        {"name": "fused_resblock_stage", "route": "cuda",
         "source": f"{PORT}/csrc/resblock.cu",
         "replaces": f"{REFERENCE}/ops/pallas_vocoder.py:113",
         "launches": e2e["launches"]["fused_resblock_stage"],
         "launches_by_path": _launches("fused_resblock_stage", e2e, front, serve, lipsync,
                                       diff2lip, services, batched, stream, mtp, official, ckpt,
                                       alt, tools),
         "max_abs_err": max(r["max_abs_err"] for r in res_rows),
         "ms": sum(r["ms"] for r in serving), "plain_ms": sum(r["plain_ms"] for r in serving),
         "bound_ms": sum(r["bound_ms"] for r in serving),
         "bound_by": _bound_by(sum(r["gflop"] for r in serving) * 1e9, PEAK_BF16,
                               sum(r["mbytes"] for r in serving) * 1e6),
         "library_ms": None,
         "b8_ms": sum(r["ms"] for r in b8), "b8_plain_ms": sum(r["plain_ms"] for r in b8),
         "b8_bound_ms": sum(r["bound_ms"] for r in b8),
         "stream_ms": sum(r["ms"] for r in streamed),
         "stream_graph_ms": sum(r["graph_ms"] for r in streamed),
         "stream_plain_ms": sum(r["graph_plain_ms"] for r in streamed),
         "stream_bound_ms": sum(r["bound_ms"] for r in streamed)},
        _decode_entry("fused_ln_matvec", "decode.cu", "ops/pallas_decode.py:124", mv_rows, e2e,
                      front, serve, lipsync, diff2lip, services, batched, stream, mtp, official,
                      ckpt, alt, tools),
        _decode_entry("fused_ln_mlp", "decode.cu", "ops/pallas_decode.py:209", mlp_rows, e2e,
                      front, serve, lipsync, diff2lip, services, batched, stream, mtp, official,
                      ckpt, alt, tools),
        _decode_entry("matmul_int4", "int4.cu", "ops/pallas_int4.py:94", int4_rows, e2e,
                      front, serve, lipsync, diff2lip, services, batched, stream, mtp, official,
                      ckpt, alt, tools),
    ]


def build_phase(report):
    print("== build", flush=True)
    t0 = time.perf_counter()
    logs = build.build()
    seconds = time.perf_counter() - t0
    report["ptxas"] = {}
    for name, info in logs.items():
        print(f"  {name}: {info['seconds']:.1f} s", flush=True)
        lines = report["ptxas"][name] = []
        for ln in info["log"].splitlines():
            if "Compiling entry function" in ln:  # names the kernel the next lines describe
                lines.append(ln.split("'")[1])
            elif "registers" in ln or "spill" in ln or "smem" in ln:
                lines.append(ln.strip())
        for ln in lines:
            print(f"    {ln}", flush=True)
    print(f"  build total {seconds:.1f} s", flush=True)
    report["build_seconds"] = seconds
    return seconds


def main() -> int:
    t_start = time.perf_counter()
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
    kernel_rows = kernels_phase(dev, report)
    e2e, backend = e2e_phase(dev, report, card)
    front = frontend_phase(dev, report, card, backend, e2e)
    serve = serve_phase(dev, report, card, backend, e2e, front)
    lipsync = lipsync_phase(dev, report, card, backend, e2e)
    diff2lip = diff2lip_phase(dev, report, card)
    services = services_phase(dev, report, card, backend, e2e)
    batched = batched_phase(dev, report, card, e2e)
    stream = streaming_phase(dev, report, card, backend, e2e)
    mtp = mtp_phase(dev, report, card, backend, e2e)
    official = official_phase(dev, report, card, e2e)
    ckpt = checkpoints_phase(dev, report, card, e2e)
    alt = alternate_phase(dev, report, card, backend)
    tools = tools_phase(dev, report, card, backend)
    report["seconds"] = time.perf_counter() - t_start
    print(f"== done in {report['seconds']:.1f} s", flush=True)
    os.makedirs(OUT_DIR, exist_ok=True)
    with open(os.path.join(OUT_DIR, "chip_smoke.json"), "w") as f:
        json.dump(report, f, indent=1)
    print(json.dumps({"kernels": kernels_line(*kernel_rows, e2e, front, serve, lipsync, diff2lip,
                                              services, batched, stream, mtp, official, ckpt,
                                              alt, tools)}))
    print(card)
    print(json.dumps({"ok": True, "device": {"platform": "gpu",
                                             "kind": torch.cuda.get_device_name(0),
                                             "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
