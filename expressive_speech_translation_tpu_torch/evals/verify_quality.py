"""One-command BASELINE five-config quality-parity harness (`est-torch
verify-quality`; the port's copy of the JAX package's
``evals/verify_quality.py``, every model on ``device``: the card unless
``device="cpu"``).

BASELINE.md's two quality gates — **≤ 0.5 BLEU delta** and **≤ 0.01
speaker-similarity delta vs the PyTorch reference** — are defined over five
concrete configs the reference can actually run
(the reference's Backend/translate_speech.py:79-154 and
Batch-Processing/run_batch_job.py:45-85 define the pipelines;
BASELINE.md lists the configs):

  1  asr_nmt          harvard.wav → Whisper ASR + NLLB EN→FR text
  2  s2st_clone       input_audio_short.wav → full S2ST with zero-shot clone
  3  openvoice        OpenVoice v2 tone-color-converter path
  4  video_lipsync    input_video_short.mov → video S2ST + lip-sync
  5  mcv_greek_batch  one MCV-Greek-style batch row (run_batch_job.py:45-85)

This module assembles pieces that already exist — the port's bake
(models/loaders.py), BLEU (evals/text_metrics.py), ECAPA similarity
(models/ecapa.py), the cascade (pipeline/cascaded.py), the video SSE pipeline
(serve/video.py), the batch runner (batch/runner.py) — into ONE command::

    EST_MODELS_DIR=/models est-torch verify-quality \
        --reference-outputs /ref_outputs --out /tmp/vq

Reference-outputs directory layout (produced by running the torch reference
once per config; docs/VERIFY_QUALITY.md gives the exact reference commands)::

    config1.json   {"source_text": ..., "target_text": ...,
                    "gold_target": ["..."], ...}      # gold refs optional
    config2.json   {"target_text": ..., "audio": "config2.wav"}
    config2.wav                                       # reference output audio
    config3.json   {"audio": "config3.wav"}
    config4.json   {"target_text": ..., "audio": "config4.wav"}
    config5.json   {"target_text": ..., "audio": "config5.wav"}

**BLEU-delta semantics** (two honest modes):

- with ``gold_target``: BLEU(ours vs gold) and BLEU(reference vs gold) are
  both computed; delta = |difference| — the gate's literal definition.
- without gold: delta = 100 − BLEU(ours vs the reference's own output) — a
  *stricter* proxy (systems scoring identically against gold can still differ
  from each other), labeled ``"bleu_mode": "vs_reference_output"``.

**Speaker-similarity delta**: ECAPA cosine sim(our output, the input speaker)
vs sim(reference output, the same speaker) — the similarity the reference's
own eval computes (Evaluation/analyze_outputs.py:113-121 verify_files). It
needs a converted ECAPA checkpoint (``$EST_MODELS_DIR/ecapa``): a
random-weight embedding carries no identity, so without one the spk gate
reports ``unavailable`` instead of a meaningless pass.

Without mounted weights the harness still runs every config end-to-end and
emits a **structure-only** report (``mode="structure-only"``) so the plumbing
is provable hermetically; the gates are only claimed when all cascade weights
are loaded.
"""

from __future__ import annotations

import base64
import dataclasses
import json
import logging
import os
import time
from pathlib import Path
from typing import Any, Callable, Dict, Optional, Sequence, Tuple

import numpy as np
import torch

from ..core.device import resolve_device
from .text_metrics import chrf, corpus_bleu

log = logging.getLogger(__name__)

BLEU_GATE = 0.5    # BASELINE.md: ≤ 0.5 BLEU delta
SPK_GATE = 0.01    # BASELINE.md: ≤ 0.01 speaker-similarity delta

CONFIG_NAMES = {
    1: "asr_nmt",
    2: "s2st_clone",
    3: "openvoice",
    4: "video_lipsync",
    5: "mcv_greek_batch",
}

# The reference's committed fixtures (SURVEY.md §4). input_video_short.mov was
# stripped upstream (.MISSING_LARGE_BLOBS); when absent, config 4 synthesises
# a speaking-head substitute from the committed frontend MP4 + short_audio.
DEFAULT_FIXTURES = {
    "harvard": "/root/reference/Backend/harvard.wav",
    "short_audio": "/root/reference/input_audio_short.wav",
    "short_video": "/root/reference/Backend/input_video_short.mov",
    "video_frames_fallback":
        "/root/reference/Frontend/public/videos/man-speaking-into-the-microphone.mp4",
}


# --------------------------------------------------------------- gate arithmetic


def gate_value(value: Optional[float], limit: float) -> str:
    """One gate: 'pass' | 'fail' | 'n/a' (None = metric not computable)."""
    if value is None:
        return "n/a"
    return "pass" if value <= limit else "fail"


def bleu_metrics(our_text: str, ref: Optional[dict]) -> Dict[str, Any]:
    """BLEU delta for one config (see module docstring for the two modes)."""
    ref_text = (ref or {}).get("target_text")
    if not ref_text:
        return {"bleu_delta": None, "bleu_mode": None}
    gold = (ref or {}).get("gold_target")
    if gold:
        gold = [gold] if isinstance(gold, str) else list(gold)
        ours = corpus_bleu([our_text], [gold])
        theirs = corpus_bleu([ref_text], [gold])
        return {
            "bleu_ours": round(ours, 3),
            "bleu_reference": round(theirs, 3),
            "bleu_delta": round(abs(ours - theirs), 3),
            "bleu_mode": "gold",
        }
    b = corpus_bleu([our_text], [[ref_text]])
    return {
        "bleu_ours": round(b, 3),
        "bleu_vs_reference_chrf": round(chrf(our_text, ref_text), 3),
        "bleu_delta": round(100.0 - b, 3),
        "bleu_mode": "vs_reference_output",
    }


def config_gates(metrics: Dict[str, Any], *, bleu_gate: float = BLEU_GATE,
                 spk_gate: float = SPK_GATE) -> Dict[str, str]:
    """Gate verdicts for one config's metric dict."""
    return {
        "bleu": gate_value(metrics.get("bleu_delta"), bleu_gate),
        "spk_sim": gate_value(metrics.get("spk_sim_delta"), spk_gate),
    }


def overall_verdict(configs: Dict[str, Any], mode: str) -> str:
    """'pass' iff every applicable gate in a weights-backed run passed and at
    least one gate was applicable; any 'fail' fails; structure-only runs and
    all-n/a runs report their mode instead of claiming the gates."""
    verdicts = [g for c in configs.values() if c.get("ran")
                for g in c.get("gates", {}).values()]
    if any(v == "fail" for v in verdicts):
        return "fail"
    if mode != "quality-parity":
        return mode
    if not any(v == "pass" for v in verdicts):
        return "no-applicable-gates"
    return "pass"


# ----------------------------------------------------------------- spk scorer


class SpeakerScorer:
    """ECAPA cosine-similarity scorer with honest availability semantics.

    ``from_models_dir`` loads the converted checkpoint under
    ``{root}/ecapa`` (written by ``est-torch bake --ecapa``) onto ``device``
    (the card unless ``device="cpu"``, resolved first, so a missing card
    raises instead of reading as no checkpoint); without one the
    scorer is UNAVAILABLE — random embeddings carry no speaker identity, so
    pretending otherwise would let the spk gate pass vacuously. Tests inject
    a deterministic ``embed_fn``.
    """

    def __init__(self, embed_fn: Optional[Callable[[np.ndarray], np.ndarray]] = None,
                 *, source: str = "injected"):
        self._embed = embed_fn
        self.available = embed_fn is not None
        self.source = source if self.available else "unavailable"

    @classmethod
    def from_models_dir(cls, root: Optional[str], *, device=None) -> "SpeakerScorer":
        dev = resolve_device(device)
        if not root:
            return cls(None)
        d = Path(root) / "ecapa"
        if not (d / "config.json").exists():
            return cls(None)
        from ..models import ecapa
        from ..models.loaders import load_converted

        params, cfg = load_converted(d, ecapa.EcapaConfig, dev)

        def embed(audio_16k: np.ndarray) -> np.ndarray:
            x = torch.from_numpy(np.asarray(audio_16k, np.float32).reshape(1, -1)).to(dev)
            with torch.inference_mode():
                return ecapa.embed_audio(params, cfg, x)[0].float().cpu().numpy()

        return cls(embed, source=str(d))

    def similarity(self, a_16k: np.ndarray, b_16k: np.ndarray) -> Optional[float]:
        if not self.available:
            return None
        ea, eb = self._embed(a_16k), self._embed(b_16k)
        denom = float(np.linalg.norm(ea) * np.linalg.norm(eb))
        return float(np.dot(ea, eb) / max(denom, 1e-9))


def spk_metrics(scorer: SpeakerScorer, our_audio: np.ndarray,
                ref_audio: Optional[np.ndarray],
                speaker_audio: np.ndarray) -> Dict[str, Any]:
    """Speaker-similarity delta vs the reference output, per module docstring."""
    if not scorer.available:
        return {"spk_sim_delta": None,
                "spk_sim_mode": "unavailable: no ECAPA checkpoint "
                                "($EST_MODELS_DIR/ecapa) — random embeddings "
                                "carry no identity"}
    sim_ours = scorer.similarity(our_audio, speaker_audio)
    out: Dict[str, Any] = {"spk_sim_ours": round(sim_ours, 4)}
    if ref_audio is None:
        out.update(spk_sim_delta=None,
                   spk_sim_mode="no reference output audio supplied")
        return out
    sim_ref = scorer.similarity(ref_audio, speaker_audio)
    out.update(spk_sim_reference=round(sim_ref, 4),
               spk_sim_delta=round(abs(sim_ours - sim_ref), 4),
               spk_sim_mode="vs_reference_output")
    return out


def _to_16k_mono(audio: np.ndarray, sr: int) -> np.ndarray:
    """Finished-output audio → 16 kHz mono, resample only (no enhancement)."""
    x = np.asarray(audio, np.float32)
    if x.ndim > 1:
        x = x.mean(axis=0)
    if sr != 16_000:
        from ..ops.host_dsp import resample_np

        x = resample_np(x, sr, 16_000)
    return x.reshape(-1)


# ------------------------------------------------------------------- context


@dataclasses.dataclass
class VerifyContext:
    engines: Any
    backend: Any
    scorer: SpeakerScorer
    out_dir: Path
    ref_dir: Optional[Path] = None
    fixtures: Dict[str, str] = dataclasses.field(
        default_factory=lambda: dict(DEFAULT_FIXTURES))
    video_io: Any = None            # serve/video.VideoIO; None → native shim
    tone_convert: Optional[Callable[[np.ndarray, np.ndarray],
                                    np.ndarray]] = None
    max_seconds: Optional[float] = None
    device: Any = None              # the front end's device (None → the card)
    _audio_cache: Dict[str, np.ndarray] = dataclasses.field(default_factory=dict)

    # -- fixtures ---------------------------------------------------------
    def fixture_path(self, name: str) -> Optional[Path]:
        p = self.fixtures.get(name)
        return Path(p) if p and Path(p).exists() else None

    def load_16k(self, name: str) -> np.ndarray:
        """Fixture → preprocessed 16 kHz mono float32 (the serve pipeline's
        exact front door: AudioProcessor.process_audio)."""
        if name in self._audio_cache:
            return self._audio_cache[name]
        path = self.fixture_path(name)
        if path is None:
            raise FileNotFoundError(f"fixture {name!r} not found "
                                    f"({self.fixtures.get(name)})")
        from ..media.wavio import read_wav
        from ..pipeline.audio_processor import AudioProcessor

        if path.suffix.lower() == ".wav":
            audio, sr = read_wav(path)
        else:
            from ..media import decode_audio_bytes

            audio, sr = decode_audio_bytes(path.read_bytes(), path.suffix.lower())
        x = AudioProcessor(device=self.device).process_audio(audio, orig_sr=sr)
        x = np.asarray(x, np.float32).reshape(-1)
        if self.max_seconds is not None:
            x = x[: int(self.max_seconds * 16_000)]
        self._audio_cache[name] = x
        return x

    # -- reference outputs -------------------------------------------------
    def ref(self, n: int) -> Optional[dict]:
        if self.ref_dir is None:
            return None
        p = self.ref_dir / f"config{n}.json"
        if not p.exists():
            return None
        return json.loads(p.read_text())

    def ref_audio(self, n: int) -> Optional[np.ndarray]:
        """Stored reference OUTPUT audio → 16 kHz mono. Resample only — it is
        a finished system output; running the input-enhancement chain on it
        would skew its ECAPA embedding relative to our in-memory output."""
        ref = self.ref(n)
        if not ref or "audio" not in ref:
            return None
        from ..media.wavio import read_wav

        audio, sr = read_wav(self.ref_dir / ref["audio"])
        return _to_16k_mono(audio, sr)

    # -- output persistence -------------------------------------------------
    def save_wav(self, name: str, audio: np.ndarray, sr: int = 16_000) -> str:
        from ..media.wavio import write_wav

        path = self.out_dir / name
        write_wav(path, np.asarray(audio, np.float32).reshape(-1), sr)
        return str(path)


# --------------------------------------------------------------- config runs


def _run_asr_nmt(ctx: VerifyContext) -> Dict[str, Any]:
    """Config 1: harvard.wav → ASR → NMT EN→FR text
    (translate_speech.py / speech_translation_pipeline.py ASR+NMT leg)."""
    from ..pipeline.languages import NLLB_LANGUAGES

    audio = ctx.load_16k("harvard")
    asr_out = ctx.engines.asr.transcribe(audio, language="eng")
    src_text = (asr_out.get("text") or "").strip()
    tgt_text = ctx.engines.nmt.translate(
        src_text, NLLB_LANGUAGES["eng"], NLLB_LANGUAGES["fra"])
    ref = ctx.ref(1)
    metrics = bleu_metrics(tgt_text, ref)
    if ref and ref.get("source_text"):
        metrics["asr_chrf_vs_reference"] = round(
            chrf(src_text, ref["source_text"]), 3)
    (ctx.out_dir / "config1.json").write_text(json.dumps(
        {"source_text": src_text, "target_text": tgt_text}, ensure_ascii=False))
    return {"outputs": {"source_text": src_text, "target_text": tgt_text},
            "metrics": metrics}


def _run_s2st_clone(ctx: VerifyContext) -> Dict[str, Any]:
    """Config 2: input_audio_short.wav → full cascade with zero-shot clone
    (the /translate hot path — cascaded_backend.py:397-483)."""
    audio = ctx.load_16k("short_audio")
    result = ctx.backend.translate_speech(audio, "eng", "fra")
    out_audio = np.asarray(result["audio"], np.float32).reshape(-1)
    wav = ctx.save_wav("config2.wav", out_audio)
    tgt_text = result.get("transcripts", {}).get("target", "")
    metrics = bleu_metrics(tgt_text, ctx.ref(2))
    metrics.update(spk_metrics(ctx.scorer, out_audio, ctx.ref_audio(2), audio))
    return {"outputs": {"audio": wav,
                        "transcripts": result.get("transcripts", {})},
            "metrics": metrics}


TONE_SEED = 0    # the posterior's draw when none is injected (JAX: PRNGKey(0))
TONE_INIT_SEED = 3   # the random tree when no openvoice/ stage is baked


def default_tone_convert(models_dir: Optional[str], *, device=None,
                         eps: Optional[Callable[[Tuple[int, ...]], np.ndarray]] = None):
    """OpenVoice v2 tone-color conversion (openvoice_api.py:141-155 path) on
    ``device`` (the card unless ``device="cpu"``): converted checkpoint under
    ``{models_dir}/openvoice`` when baked, a seeded random tree otherwise
    (structure-only). ``eps(shape)`` gives the posterior's standard-normal
    draw [1, frames, inter_channels] (JAX draws it from ``PRNGKey(0)`` on
    every call); without it a generator seeded with ``TONE_SEED`` draws it
    anew for each call. Returns (fn, weightless flag)."""
    from ..models import openvoice as ov
    from ..ops.resample import resample
    from ..ops.stft import num_frames

    dev = resolve_device(device)
    params, cfg, weightless = None, ov.OpenVoiceConfig(), True
    if models_dir and (Path(models_dir) / "openvoice" / "config.json").exists():
        from ..models.loaders import load_converted

        params, cfg = load_converted(Path(models_dir) / "openvoice",
                                     ov.OpenVoiceConfig, dev)
        weightless = False
    if params is None:
        params = ov.init_openvoice(TONE_INIT_SEED, cfg, dev)

    def draw(shape: Tuple[int, ...]) -> torch.Tensor:
        if eps is not None:
            return torch.tensor(np.asarray(eps(shape), np.float32), device=dev)
        g = torch.Generator(dev).manual_seed(TONE_SEED)
        return torch.randn(shape, generator=g, device=dev)

    def fn(source_16k: np.ndarray, target_16k: np.ndarray) -> np.ndarray:
        sr = cfg.sample_rate
        with torch.inference_mode():
            src = resample(torch.as_tensor(np.asarray(source_16k, np.float32), device=dev),
                           16_000, sr)[None]
            tgt = resample(torch.as_tensor(np.asarray(target_16k, np.float32), device=dev),
                           16_000, sr)[None]
            se_src = ov.extract_se(params, cfg, ov.spectrogram_22k(src, cfg))
            se_tgt = ov.extract_se(params, cfg, ov.spectrogram_22k(tgt, cfg))
            # spectrogram_22k reflect-pads (n_fft − hop)/2 a side, uncentred
            frames = num_frames(src.shape[-1] + (cfg.n_fft - cfg.hop) // 2 * 2,
                                cfg.n_fft, cfg.hop, center=False)
            conv = ov.convert_tone(params, cfg, src, se_src, se_tgt,
                                   eps=draw((1, frames, cfg.inter_channels)))
            out16 = resample(conv[0].float().reshape(-1), sr, 16_000)
            return out16.cpu().numpy().astype(np.float32)

    return fn, weightless


def _run_openvoice(ctx: VerifyContext) -> Dict[str, Any]:
    """Config 3: clone harvard's speech into input_audio_short's timbre via
    the tone-color converter; the metric is pure speaker similarity (the
    converter does not change the text)."""
    target_speaker = ctx.load_16k("short_audio")
    source = ctx.load_16k("harvard")
    cap = int((ctx.max_seconds or 8.0) * 16_000)
    source = source[:cap]
    converted = np.asarray(ctx.tone_convert(source, target_speaker),
                           np.float32).reshape(-1)
    wav = ctx.save_wav("config3.wav", converted)
    metrics = spk_metrics(ctx.scorer, converted, ctx.ref_audio(3),
                          target_speaker)
    if ctx.scorer.available:
        # identity-shift extra: conversion should move the output TOWARD the
        # target speaker relative to the unconverted source
        sim_before = ctx.scorer.similarity(source, target_speaker)
        metrics["spk_sim_source_before"] = round(sim_before, 4)
    return {"outputs": {"audio": wav}, "metrics": metrics}


def _run_video_lipsync(ctx: VerifyContext) -> Dict[str, Any]:
    """Config 4: video S2ST + lip-sync through the SSE pipeline
    (serve/video.py process_video — the /process-video route's generator)."""
    from ..serve.video import VideoProcessor

    video_path = ctx.fixture_path("short_video")
    synthesized = False
    if video_path is None:
        video_path = _synthesize_video_fixture(ctx)
        synthesized = True
    video_io = ctx.video_io
    if video_io is None:
        from ..media import native
        from ..pipeline.musetalk_pipeline import default_lipsync_fn

        if not native.available():
            raise RuntimeError("config 4 needs the native media shim or an "
                               "injected video_io")
        video_io = native.NativeVideoIO(lipsync_fn=default_lipsync_fn(ctx.device))

    vp = VideoProcessor(video_io, temp_root=ctx.out_dir / "tmp_video", device=ctx.device)
    result = None
    for frame in vp.process_video(Path(video_path).read_bytes(), ctx.backend,
                                  "eng", "fra", filename=Path(video_path).name):
        if not frame.startswith("data: "):
            continue
        ev = json.loads(frame[len("data: "):])
        if ev.get("error"):
            raise RuntimeError(f"video pipeline error: {ev['error']} "
                               f"(id {ev.get('error_id')})")
        if "result" in ev:
            result = ev["result"]
    if result is None:
        raise RuntimeError("video pipeline produced no result frame")
    out_path = ctx.out_dir / "config4.mp4"
    out_path.write_bytes(base64.b64decode(result["video"]))
    tgt_text = result.get("transcripts", {}).get("target", "")
    metrics = bleu_metrics(tgt_text, ctx.ref(4))
    # speaker similarity on the dubbed track vs the input video's speaker.
    # The dubbed track is a finished system output: resample-only, exactly
    # like the stored reference output (ref_audio) — running the input
    # enhancement chain on one side only would skew the ECAPA delta.
    out_audio, sr = video_io.extract_audio(str(out_path))
    in_audio, in_sr = video_io.extract_audio(str(video_path))
    from ..pipeline.audio_processor import AudioProcessor

    out16 = _to_16k_mono(out_audio, sr)
    ap = AudioProcessor(device=ctx.device)
    in16 = np.asarray(ap.process_audio(in_audio, orig_sr=in_sr), np.float32).reshape(-1)
    metrics.update(spk_metrics(ctx.scorer, out16, ctx.ref_audio(4), in16))
    return {"outputs": {"video": str(out_path),
                        "transcripts": result.get("transcripts", {}),
                        "fixture_synthesized": synthesized},
            "metrics": metrics}


def _synthesize_video_fixture(ctx: VerifyContext) -> Path:
    """input_video_short.mov was stripped from the reference checkout
    (.MISSING_LARGE_BLOBS): stand in a deterministic speaking-head clip —
    frames from the committed frontend MP4 muxed with input_audio_short —
    so config 4 still exercises the full video path. Labeled in the report."""
    from ..media import native

    frames_src = ctx.fixture_path("video_frames_fallback")
    if frames_src is None or not native.available():
        raise FileNotFoundError(
            "config 4 fixture missing: neither input_video_short.mov nor the "
            "frontend MP4 + native shim to synthesize a substitute")
    audio = ctx.load_16k("short_audio")
    seconds = min(len(audio) / 16_000.0, 4.0)
    fps = 25.0
    frames, _ = native.decode_video(str(frames_src),
                                    max_frames=int(seconds * fps))
    out = ctx.out_dir / "fixture_video.mp4"
    native.encode_video(out, frames, fps,
                        audio=audio[: int(seconds * 16_000)], audio_rate=16_000)
    return out


def _run_mcv_greek_batch(ctx: VerifyContext) -> Dict[str, Any]:
    """Config 5: one MCV-Greek-style batch row through the batch runner
    (run_batch_job.py:45-85 semantics: {job}.wav + {job}_transcripts.json,
    .error on failure), target language Greek."""
    from ..batch.runner import run_batch_job

    path = ctx.fixture_path("short_audio")
    if path is None:
        raise FileNotFoundError("config 5 fixture (short_audio) missing")
    batch_dir = ctx.out_dir / "batch"
    status = run_batch_job(path, batch_dir, job_id="config5",
                           target_lang="ell", backend=ctx.backend, device=ctx.device)
    if status["status"] != "ok":
        raise RuntimeError(
            f"batch row failed: {(batch_dir / 'config5.error').read_text()[:400]}")
    transcripts = json.loads((batch_dir / "config5_transcripts.json").read_text())
    from ..media.wavio import read_wav

    out_audio, _ = read_wav(batch_dir / "config5.wav")
    out_audio = np.asarray(out_audio, np.float32).reshape(-1)
    metrics = bleu_metrics(transcripts.get("target", ""), ctx.ref(5))
    metrics.update(spk_metrics(ctx.scorer, out_audio, ctx.ref_audio(5),
                               ctx.load_16k("short_audio")))
    return {"outputs": {"audio": str(batch_dir / "config5.wav"),
                        "transcripts": transcripts},
            "metrics": metrics}


_RUNNERS = {
    1: _run_asr_nmt,
    2: _run_s2st_clone,
    3: _run_openvoice,
    4: _run_video_lipsync,
    5: _run_mcv_greek_batch,
}


# -------------------------------------------------------- reference promotion


def promote_reference(report: Dict[str, Any], ref_dir: str | Path,
                      *, video_io: Any = None) -> Dict[str, str]:
    """Promote a completed run's outputs into a reference-outputs dir.

    This is how A/B quality comparisons become one command: run config A
    (``--promote-reference refs/``), then run config B with
    ``--reference-outputs refs/`` — the BLEU/spk-sim deltas between the two
    builds (bf16 vs int8, bucketed vs exact ASR context, old vs new
    checkpoint) come out gated. It is also the exact layout a torch-reference
    run must produce (docs/VERIFY_QUALITY.md).

    Returns {config_key: written-file} for what was promoted; configs that
    did not run are skipped. Config 4 needs a media backend (``video_io`` or
    the native shim) to extract the dubbed track from the output MP4.
    """
    import shutil

    ref = Path(ref_dir)
    ref.mkdir(parents=True, exist_ok=True)
    written: Dict[str, str] = {}
    configs = report.get("configs", {})

    def _store(n: int, target_text: Optional[str], audio_src: Optional[Path],
               key: str) -> None:
        meta: Dict[str, Any] = {}
        if target_text:
            meta["target_text"] = target_text
        if audio_src is not None:
            shutil.copy(audio_src, ref / f"config{n}.wav")
            meta["audio"] = f"config{n}.wav"
        (ref / f"config{n}.json").write_text(json.dumps(meta,
                                                        ensure_ascii=False))
        written[key] = f"config{n}.json"

    c = configs.get("1_asr_nmt")
    if c and c.get("ran"):
        out = dict(c["outputs"])
        (ref / "config1.json").write_text(json.dumps(
            {"source_text": out.get("source_text"),
             "target_text": out.get("target_text")}, ensure_ascii=False))
        written["1_asr_nmt"] = "config1.json"
    for n, key in ((2, "2_s2st_clone"), (5, "5_mcv_greek_batch")):
        c = configs.get(key)
        if c and c.get("ran"):
            _store(n, c["outputs"].get("transcripts", {}).get("target"),
                   Path(c["outputs"]["audio"]), key)
    c = configs.get("3_openvoice")
    if c and c.get("ran"):
        _store(3, None, Path(c["outputs"]["audio"]), "3_openvoice")
    c = configs.get("4_video_lipsync")
    if c and c.get("ran"):
        video = Path(c["outputs"]["video"])
        try:
            with open(video, "rb") as f:
                is_riff_wav = f.read(4) == b"RIFF"
            if is_riff_wav:
                # test rigs where 'videos' are WAV bytes (FakeVideoIO):
                # copy bit-identically — a decode/re-encode round-trip would
                # add int16 quantization noise to the stored reference
                shutil.copy(video, ref / "config4.wav")
            else:
                if video_io is not None:
                    audio, sr = video_io.extract_audio(str(video))
                else:
                    from ..media import native

                    if not native.available():
                        raise RuntimeError(
                            "no media backend to extract the track")
                    audio, sr = native.NativeVideoIO().extract_audio(str(video))
                from ..media.wavio import write_wav

                write_wav(ref / "config4.wav", _to_16k_mono(audio, sr), 16_000)
            (ref / "config4.json").write_text(json.dumps(
                {"target_text": c["outputs"].get("transcripts", {}).get("target"),
                 "audio": "config4.wav"}, ensure_ascii=False))
            written["4_video_lipsync"] = "config4.json"
        except Exception as e:  # noqa: BLE001 — promote what's promotable
            log.warning("promote: config 4 track extraction failed (%s)", e)
    return written


# ------------------------------------------------------------------- driver


def run_verify_quality(
    *,
    out_dir: str | Path,
    models_dir: Optional[str] = None,
    reference_dir: Optional[str] = None,
    configs: Sequence[int] = (1, 2, 3, 4, 5),
    engines: Any = None,
    engines_mode: str = "jax",
    scorer: Optional[SpeakerScorer] = None,
    video_io: Any = None,
    tone_convert: Optional[Callable] = None,
    fixtures: Optional[Dict[str, str]] = None,
    max_seconds: Optional[float] = None,
    bleu_gate: float = BLEU_GATE,
    spk_gate: float = SPK_GATE,
    device=None,
) -> Dict[str, Any]:
    """Run the five-config parity harness; returns (and writes) the report.

    Everything is injectable for hermetic tests: ``engines`` (stage engines),
    ``scorer`` (speaker embedder), ``video_io``, ``tone_convert``,
    ``fixtures``. The production path builds all of them from
    ``models_dir``/``EST_MODELS_DIR``, on ``device`` (the card unless
    ``device="cpu"``; ``engines_mode="jax"`` is the port's ``torch_engines``,
    as ``create_app`` maps the mode). The device is resolved first: a missing
    card raises before any config runs.
    """
    device = resolve_device(device)
    t0 = time.monotonic()
    out = Path(out_dir)
    out.mkdir(parents=True, exist_ok=True)
    models_dir = models_dir or os.environ.get("EST_MODELS_DIR")
    unknown = [n for n in configs if n not in _RUNNERS]
    if unknown:
        raise ValueError(f"unknown config number(s) {unknown}; "
                         f"valid: {sorted(_RUNNERS)}")

    # --weights/models_dir must act exactly like EST_MODELS_DIR for EVERY
    # env-discovered component (torch_engines baked weights, the face-detector
    # seam config 4 hits, the visual-model seams) — so it stays exported for
    # the WHOLE run, not just engine construction, and cached discoveries are
    # dropped so they re-discover under the new root.
    prev_env = os.environ.get("EST_MODELS_DIR")
    env_set = bool(models_dir) and str(models_dir) != prev_env
    if env_set:
        os.environ["EST_MODELS_DIR"] = str(models_dir)
        from ..pipeline import face as _face

        _face._reset_learned()
    try:
        return _run_verify_quality_inner(
            t0=t0, out=out, models_dir=models_dir,
            reference_dir=reference_dir, configs=configs, engines=engines,
            engines_mode=engines_mode, scorer=scorer, video_io=video_io,
            tone_convert=tone_convert, fixtures=fixtures,
            max_seconds=max_seconds, bleu_gate=bleu_gate, spk_gate=spk_gate,
            device=device)
    finally:
        if env_set:
            if prev_env is None:
                os.environ.pop("EST_MODELS_DIR", None)
            else:
                os.environ["EST_MODELS_DIR"] = prev_env
            from ..pipeline import face as _face

            _face._reset_learned()


def _run_verify_quality_inner(
    *, t0, out, models_dir, reference_dir, configs, engines, engines_mode,
    scorer, video_io, tone_convert, fixtures, max_seconds, bleu_gate,
    spk_gate, device,
) -> Dict[str, Any]:
    from ..pipeline.cascaded import CascadedBackend

    if engines is None:
        if engines_mode == "fake":
            from ..pipeline.engines import fake_engines

            engines = fake_engines()
        else:
            from ..pipeline.torch_engines import torch_engines

            engines = torch_engines(device=device)
    backend = CascadedBackend(engines)
    backend.initialize()

    scorer = scorer or SpeakerScorer.from_models_dir(models_dir, device=device)
    tone_weightless: Optional[bool] = None
    if tone_convert is None and 3 in configs:
        tone_convert, tone_weightless = default_tone_convert(models_dir, device=device)

    ctx = VerifyContext(
        engines=engines, backend=backend, scorer=scorer, out_dir=out,
        ref_dir=Path(reference_dir) if reference_dir else None,
        fixtures={**DEFAULT_FIXTURES, **(fixtures or {})},
        video_io=video_io, tone_convert=tone_convert,
        max_seconds=max_seconds, device=device,
    )

    weights = engines.weights_info()
    mode = ("quality-parity" if weights == "loaded" and reference_dir
            else "structure-only")

    report: Dict[str, Any] = {
        "mode": mode,
        "weights": weights,
        "models_dir": str(models_dir) if models_dir else None,
        "reference_outputs": str(reference_dir) if reference_dir else None,
        "speaker_scorer": scorer.source,
        "gates": {"bleu_delta_max": bleu_gate, "spk_sim_delta_max": spk_gate},
        "configs": {},
    }
    if tone_weightless:
        report["notes"] = ["config 3 tone converter ran with RANDOM weights "
                           "(no openvoice/ checkpoint) — structure-only"]

    for n in configs:
        key = f"{n}_{CONFIG_NAMES[n]}"
        try:
            result = _RUNNERS[n](ctx)
            result["ran"] = True
            result["gates"] = config_gates(result["metrics"],
                                           bleu_gate=bleu_gate,
                                           spk_gate=spk_gate)
        except Exception as e:  # noqa: BLE001 — one config never hides the rest
            log.exception("verify-quality config %s failed", key)
            result = {"ran": False, "error": f"{type(e).__name__}: {e}"}
        report["configs"][key] = result

    report["overall"] = overall_verdict(report["configs"], mode)
    if any(not c.get("ran") for c in report["configs"].values()):
        # a crashed config fails a parity run outright and downgrades a
        # structure-only run to "incomplete" (nonzero CLI exit either way —
        # a structure check where the plumbing threw must not read as green)
        report["overall"] = ("fail" if mode == "quality-parity"
                             else "incomplete")
        report.setdefault("notes", []).append(
            "one or more configs failed to run — see per-config 'error'")
    report["elapsed_s"] = round(time.monotonic() - t0, 1)
    (out / "report.json").write_text(json.dumps(report, indent=2,
                                                ensure_ascii=False))
    return report
