"""Standalone CLI pipelines of the port (the JAX package's ``cli.py``: the
same nine subcommands, flags, defaults and printed JSON).

Parity with the reference's CLI surface (SURVEY.md §2.18):

  est-torch translate        Backend/speech_translation_pipeline.py (ASR → NMT
                             → TTS) and translate_audio.py drivers
  est-torch s2st             Backend/translate_speech.py (direct
                             SeamlessM4T-v2 S2ST, beam 5, bandpass, tanh)
  est-torch simple-tts       Backend/simple_translate_tts.py (text-only
                             translate + TTS, no cloning)
  est-torch verify-watermark Backend/verify_watermark.py:12-50
  est-torch ab-test          services/audio_testing.py AudioTester.run_ab_test

plus ``doctor``, ``embed``, ``verify-quality`` and ``bake``. All are argparse
subcommands of ``python -m expressive_speech_translation_tpu_torch.cli``.
Every subcommand runs on the card unless it is given ``--device cpu``;
``--engines jax`` (the default, spelled as the JAX package spells it) is the
port's own engines, ``torch_engines()``.
"""

from __future__ import annotations

import argparse
import json
import logging
import os
import sys
from pathlib import Path

import numpy as np

log = logging.getLogger(__name__)

MEL_ATOL = 1e-4   # doctor's log-mel launch against its plain version (normalised units)


def _load_audio(path: str):
    from .media.wavio import read_wav

    p = Path(path)
    if p.suffix.lower() == ".wav":
        return read_wav(p)
    from .media import decode_audio_bytes

    return decode_audio_bytes(p.read_bytes(), p.suffix.lower())


def _prepare_16k(audio, sr, device):
    from .pipeline.audio_processor import AudioProcessor

    return AudioProcessor(device=device).process_audio(audio, orig_sr=sr)


def cmd_translate(args) -> int:
    """ASR → NMT → TTS (+ optional tone conversion) — speech_translation_pipeline.py."""
    from .media.wavio import write_wav
    from .pipeline.cascaded import CascadedBackend
    from .pipeline.engines import fake_engines

    audio, sr = _load_audio(args.input)
    x = _prepare_16k(audio, sr, args.device)
    if args.engines == "jax":
        from .pipeline.torch_engines import torch_engines

        engines = torch_engines(device=args.device)
    else:
        engines = fake_engines()
    backend = CascadedBackend(engines)
    backend.initialize()
    result = backend.translate_speech(x, args.source_lang, args.target_lang)
    write_wav(args.output, result["audio"][0], 16_000)
    print(json.dumps({
        "output": args.output,
        "transcripts": result["transcripts"],
        "stage_xrt": {k: round(v["xrt"], 4) for k, v in result["stage_summary"].items()},
    }, ensure_ascii=False))
    return 0


def cmd_s2st(args) -> int:
    """Direct S2ST (translate_speech.py parity: beam 5, bandpass, tanh)."""
    from .media.wavio import write_wav
    from .pipeline.alternate_backends import SeamlessBackend

    audio, sr = _load_audio(args.input)
    x = _prepare_16k(audio, sr, args.device)
    # baked seamless-m4t-v2 weights (est-torch bake --seamless) via --weights /
    # EST_MODELS_DIR; weightless toy instance otherwise
    backend = SeamlessBackend.from_models_dir(
        getattr(args, "weights", None), num_beams=args.num_beams, device=args.device)
    backend.initialize()
    result = backend.translate_speech(x, args.source_lang, args.target_lang)
    write_wav(args.output, result["audio"][0], 16_000)
    print(json.dumps({"output": args.output, "transcripts": result["transcripts"]},
                     ensure_ascii=False))
    return 0


def cmd_simple_tts(args) -> int:
    """Text → translate → TTS, no cloning (simple_translate_tts.py parity)."""
    from .media.wavio import write_wav
    from .pipeline.engines import FakeNmt, FakeTts

    if args.engines == "jax":
        from .pipeline.torch_engines import TorchCosyVoiceTts, TorchNllbNmt

        nmt, tts = TorchNllbNmt(device=args.device), TorchCosyVoiceTts(device=args.device)
    else:
        nmt, tts = FakeNmt(), FakeTts()
    from .pipeline.languages import NLLB_LANGUAGES

    translated = nmt.translate(
        args.text, NLLB_LANGUAGES.get(args.source_lang, args.source_lang),
        NLLB_LANGUAGES.get(args.target_lang, args.target_lang),
    )
    wave = tts.synthesize(translated, language=args.target_lang)
    sr = getattr(tts, "sample_rate", 24_000)
    write_wav(args.output, np.asarray(wave, np.float32), sr)
    print(json.dumps({"output": args.output, "translated": translated}, ensure_ascii=False))
    return 0


def cmd_verify_watermark(args) -> int:
    """Backend/verify_watermark.py:12-50 parity."""
    from .pipeline.watermark import WaterMark

    try:
        payload = WaterMark.extract_watermark(args.input)
    except (FileNotFoundError, OSError) as e:
        print(json.dumps({"watermarked": False, "error": str(e)}))
        return 1
    if payload is None:
        print(json.dumps({"watermarked": False}))
        return 1
    print(json.dumps({"watermarked": True, "payload": payload,
                      "valid": WaterMark.verify(args.input)}, ensure_ascii=False))
    return 0


def cmd_ab_test(args) -> int:
    """A/B sweep over per-language enhancement params (audio_testing.py:11-98)."""
    from .media.wavio import write_wav
    from .pipeline.audio_processor import LANGUAGE_PARAMS, AudioProcessor

    audio, sr = _load_audio(args.input)
    ap = AudioProcessor(device=args.device)
    x = ap.process_audio(audio, orig_sr=sr)
    out_dir = Path(args.output_dir)
    out_dir.mkdir(parents=True, exist_ok=True)
    results = []
    for i, (lang, params) in enumerate(sorted(LANGUAGE_PARAMS.items())):
        enhanced = ap.apply_spectral_enhancement(x, lang)
        path = out_dir / f"test_{i}_{lang}.wav"   # test_results/test_i_lang.wav parity
        write_wav(path, enhanced, 16_000)
        results.append({"variant": lang, "path": str(path),
                        "params": {"compression_ratio": params.compression_ratio}})
    print(json.dumps({"results": results}, ensure_ascii=False))
    return 0


def _count_tensors(tree) -> int:
    if isinstance(tree, dict):
        return sum(_count_tensors(v) for v in tree.values())
    if isinstance(tree, (list, tuple)):
        return sum(_count_tensors(v) for v in tree)
    return 1


def cmd_doctor(args) -> int:
    """Environment self-check (parity: Backend/verify_token.py token/model
    checks, Backend/check_files.py, Docker/setup_openvoice.py's six
    check_*/test_* functions — rebuilt as one offline diagnostic): the card,
    the four CUDA kernels built from ``csrc/``, one log-mel launch against its
    plain version, the media shim and the baked weights."""
    import torch

    checks = {}

    def check(name, fn):
        try:
            checks[name] = {"ok": True, "detail": fn()}
        except Exception as e:  # noqa: BLE001 — report, don't crash
            checks[name] = {"ok": False, "detail": f"{type(e).__name__}: {e}"}

    def _devices():
        if not torch.cuda.is_available():
            raise RuntimeError("no CUDA device")
        from .obs.perf import card_line

        names = [torch.cuda.get_device_name(i) for i in range(torch.cuda.device_count())]
        return {"devices": names, "name_and_power_limit": card_line()}

    def _kernel_builds():
        from .ops import build

        return {n: ("already built" if r["log"] == "already built"
                    else f"built in {r['seconds']:.1f} s")
                for n, r in build.build().items()}

    def _cuda_kernel():
        from .ops import cuda_mel

        if not torch.cuda.is_available():
            raise RuntimeError("no CUDA device")
        # white noise: every band near its frame's peak, where an f32 DFT
        # product does not cancel, so the plain version is exact to MEL_ATOL
        x = torch.from_numpy(np.random.default_rng(0).normal(
            0.0, 0.1, cuda_mel.WHISPER_SAMPLES).astype(np.float32)).cuda()
        out = cuda_mel.whisper_log_mel_fused(x)
        want = cuda_mel.normalize_log_mel(
            cuda_mel.log_mel_frames_plain(x, 80, cuda_mel.WHISPER_SAMPLES)).T
        err = float((out - want).abs().max())
        if not err <= MEL_ATOL:
            raise AssertionError(f"log-mel kernel off its plain version by {err:.3g}")
        return f"log-mel {tuple(out.shape)} on the card, max |Δ| {err:.2e} vs plain"

    def _native():
        from .media import native

        if not native.available():
            raise RuntimeError("libest_media.so missing and auto-build failed")
        return "libav shim loaded"

    def _weights():
        from .models.loaders import load_state_dict

        if not args.weights:
            return "no --weights dir given (running in random-weight mode)"
        state = load_state_dict(args.weights)
        return f"{len(state)} tensors at {args.weights}"

    def _tts_triple():
        """Baked CosyVoice triple (tts_llm/tts_flow/tts_hift): the official
        synthesis chain is available iff all three converted."""
        root = args.weights or os.environ.get("EST_MODELS_DIR")
        if not root:
            return "no weights root (EST_MODELS_DIR unset)"
        present = [s for s in ("tts_llm", "tts_flow", "tts_hift")
                   if (Path(root) / s / "config.json").exists()]
        if len(present) == 3:
            from .models.loaders import load_official_tts

            params, _ = load_official_tts(root, device=args.device)
            return f"official TTS triple loads ({_count_tensors(params)} tensors)"
        return f"baked: {present or 'none'} — official chain needs all three"

    def _secondary_models():
        """Baked secondary model families: which load real weights vs fall
        back to random (the reference loads all of these —
        api_inference_logic.py:42-73, openvoice_api.py:39-114,
        voice_similarity_analyser.py:26-33, translate_speech.py:79-154)."""
        root = args.weights or os.environ.get("EST_MODELS_DIR")
        if not root:
            return "no weights root (EST_MODELS_DIR unset)"
        subs = ("musetalk", "musetalk_whisper", "diff2lip", "openvoice",
                "ecapa", "seamless")
        present = [s for s in subs if (Path(root) / s / "config.json").exists()]
        missing = [s for s in subs if s not in present]
        return f"baked: {present or 'none'}; random-weight fallback: {missing or 'none'}"

    check("cuda_devices", _devices)
    check("kernel_builds", _kernel_builds)
    check("cuda_kernel", _cuda_kernel)
    check("native_media_shim", _native)
    check("weights", _weights)
    check("tts_triple", _tts_triple)
    check("secondary_models", _secondary_models)
    ok = all(c["ok"] for c in checks.values())
    print(json.dumps({"ok": ok, "checks": checks}, ensure_ascii=False, indent=2))
    return 0 if ok else 1


EMBED_SEED = 4   # the random ECAPA tree when no ecapa/ stage is baked


def cmd_embed(args) -> int:
    """ECAPA speaker embedding → .npy (Docker/create_embedding.py role: the
    reference extracts a campplus embedding for cloning prompts)."""
    import torch

    from .core.device import resolve_device
    from .media.wavio import read_wav
    from .models import ecapa

    dev = resolve_device(args.device)
    audio, sr = read_wav(args.input)
    audio = np.asarray(audio, np.float32).reshape(-1)
    if sr != 16_000:
        from .ops.host_dsp import resample_np

        audio = resample_np(audio, sr, 16_000)
    # weights plumbing mirrors `est-torch translate`: --weights / EST_MODELS_DIR
    # with an `ecapa/` subtree; a random-weight embedding carries no speaker
    # identity, so the fallback is LOUD, never silent
    root = getattr(args, "weights", None) or os.environ.get("EST_MODELS_DIR")
    weightless = True
    cfg = ecapa.EcapaConfig()
    params = None
    if root:
        from .models.loaders import load_converted

        edir = Path(root) / "ecapa"
        if (edir / "config.json").exists():
            params, cfg = load_converted(edir, ecapa.EcapaConfig, dev)
            weightless = False
    if params is None:
        print("WARNING: no ECAPA checkpoint (--weights/EST_MODELS_DIR with "
              "an ecapa/ subtree) — embedding uses RANDOM weights and "
              "carries no speaker identity", file=sys.stderr)
        params = ecapa.init_ecapa(EMBED_SEED, cfg, dev)
    with torch.inference_mode():
        emb = ecapa.embed_audio(params, cfg, torch.from_numpy(audio[None]).to(dev))
        emb = emb[0].float().cpu().numpy()
    np.save(args.output, emb)
    print(json.dumps({"output": args.output, "dim": int(emb.shape[-1]),
                      "weightless": weightless}))
    return 0


def cmd_verify_quality(args) -> int:
    """BASELINE five-config quality-parity harness (evals/verify_quality.py):
    per-config BLEU delta + ECAPA speaker-similarity delta vs stored torch-
    reference outputs, gated at ≤0.5 BLEU / ≤0.01 spk-sim (BASELINE.md), or a
    labeled structure-only report when run weightless."""
    from .evals.verify_quality import run_verify_quality

    configs = tuple(int(c) for c in args.configs.split(",")) if args.configs \
        else (1, 2, 3, 4, 5)
    fixtures = {}
    if args.harvard:
        fixtures["harvard"] = args.harvard
    if args.short_audio:
        fixtures["short_audio"] = args.short_audio
    if args.video:
        fixtures["short_video"] = args.video
    report = run_verify_quality(
        out_dir=args.out,
        models_dir=args.weights or os.environ.get("EST_MODELS_DIR"),
        reference_dir=args.reference_outputs,
        configs=configs,
        engines_mode=args.engines,
        fixtures=fixtures or None,
        max_seconds=args.max_seconds,
        device=args.device,
    )
    if args.promote_reference:
        from .evals.verify_quality import promote_reference

        report["promoted"] = promote_reference(report, args.promote_reference)
    print(json.dumps(report, ensure_ascii=False, indent=2))
    return 0 if report["overall"] in ("pass", "structure-only") else 1


def cmd_bake(args) -> int:
    """Convert HF checkpoints to the port's stage directories (models/loaders)."""
    from .models.loaders import bake_models

    bake_models(args.out, asr=args.asr, nmt=args.nmt, tts=args.tts,
                musetalk=args.musetalk, musetalk_whisper=args.musetalk_whisper,
                diff2lip=args.diff2lip, openvoice=args.openvoice,
                ecapa=args.ecapa, seamless=args.seamless, device=args.device)
    return 0


def build_parser() -> argparse.ArgumentParser:
    parser = argparse.ArgumentParser(prog="est-torch", description=__doc__)
    sub = parser.add_subparsers(dest="command", required=True)
    common = argparse.ArgumentParser(add_help=False)
    common.add_argument("--device", default=None,
                        help="torch device (default: the card; cpu to run without one)")

    def add(name, **kw):
        return sub.add_parser(name, parents=[common], **kw)

    p = add("translate", help="cascaded S2ST (ASR→NMT→TTS)")
    p.add_argument("input"); p.add_argument("output")
    p.add_argument("--source-lang", default="eng")
    p.add_argument("--target-lang", required=True)
    p.add_argument("--engines", choices=("fake", "jax"), default="jax")
    p.set_defaults(fn=cmd_translate)

    p = add("s2st", help="direct S2ST (Seamless-style)")
    p.add_argument("input"); p.add_argument("output")
    p.add_argument("--source-lang", default="eng")
    p.add_argument("--target-lang", required=True)
    p.add_argument("--num-beams", type=int, default=5)
    p.add_argument("--weights", help="models root with a seamless/ subtree "
                   "(defaults to EST_MODELS_DIR)")
    p.set_defaults(fn=cmd_s2st)

    p = add("simple-tts", help="text → translate → TTS (no cloning)")
    p.add_argument("text"); p.add_argument("output")
    p.add_argument("--source-lang", default="eng")
    p.add_argument("--target-lang", required=True)
    p.add_argument("--engines", choices=("fake", "jax"), default="jax")
    p.set_defaults(fn=cmd_simple_tts)

    p = add("verify-watermark", help="check provenance payload")
    p.add_argument("input")
    p.set_defaults(fn=cmd_verify_watermark)

    p = add("ab-test", help="sweep language enhancement params")
    p.add_argument("input"); p.add_argument("output_dir")
    p.set_defaults(fn=cmd_ab_test)

    p = add("doctor", help="environment self-check")
    p.add_argument("--weights", help="model checkpoint dir to validate")
    p.set_defaults(fn=cmd_doctor)

    p = add("embed", help="speaker embedding from audio (create_embedding.py role)")
    p.add_argument("input"); p.add_argument("output", help=".npy path")
    p.add_argument("--weights", help="models root with an ecapa/ subtree "
                   "(defaults to EST_MODELS_DIR)")
    p.set_defaults(fn=cmd_embed)

    p = add("verify-quality", help="BASELINE five-config BLEU/spk-sim parity harness")
    p.add_argument("--out", required=True, help="report + outputs directory")
    p.add_argument("--weights", help="models root (defaults to EST_MODELS_DIR)")
    p.add_argument("--reference-outputs",
                   help="dir of stored torch-reference outputs "
                        "(configN.json [+ wav]; see docs/VERIFY_QUALITY.md)")
    p.add_argument("--configs", help="comma list, e.g. 1,2,5 (default all)")
    p.add_argument("--engines", choices=("fake", "jax"), default="jax")
    p.add_argument("--harvard", help="override the harvard.wav fixture")
    p.add_argument("--short-audio", help="override input_audio_short.wav")
    p.add_argument("--video", help="override input_video_short.mov")
    p.add_argument("--max-seconds", type=float,
                   help="cap each fixture's audio length")
    p.add_argument("--promote-reference", metavar="DIR",
                   help="after the run, promote its outputs into DIR as a "
                        "reference-outputs set (one-command A/B: run config "
                        "A with this, config B with --reference-outputs DIR)")
    p.set_defaults(fn=cmd_verify_quality)

    p = add("bake", help="convert HF checkpoints to the port's stage dirs (models/loaders)")
    p.add_argument("--asr"); p.add_argument("--nmt"); p.add_argument("--tts")
    p.add_argument("--musetalk"); p.add_argument("--musetalk-whisper")
    p.add_argument("--diff2lip"); p.add_argument("--openvoice")
    p.add_argument("--ecapa"); p.add_argument("--seamless")
    p.add_argument("--out", required=True)
    p.set_defaults(fn=cmd_bake)
    return parser


def main(argv=None) -> int:
    args = build_parser().parse_args(argv)
    logging.basicConfig(level=logging.INFO)
    return args.fn(args)


if __name__ == "__main__":
    sys.exit(main())
