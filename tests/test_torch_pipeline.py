"""The port's cascade against the JAX package's on the CPU, on shared weights.

Tiny JAX engines draw their own random weights; the port's engines take the
same parameter trees through ``from_jax_params`` (the TTS's conditioning
models, ECAPA and the FSQ speech tokenizer, through its ``ecapa_weights`` /
``speech_tokenizer_weights`` seams) and the TTS takes the JAX key schedule's
noise (``fold_in(PRNGKey(42), call)`` → split into the LM and flow keys).
``translate_speech`` must then give token-exact transcripts and the same
16 kHz audio within 1e-4: everything after the vocoder is the same host
numpy on both sides, and the vocoder output differs only by f32 summation
order. The same holds with the official CosyVoice2 chain (matcha flow,
HiFT) serving the TTS stage, offline and streamed.
"""

import os
import subprocess
import sys
import textwrap

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from expressive_speech_translation_tpu.models import cosyvoice as jcv
from expressive_speech_translation_tpu.models import cosyvoice_official as jco
from expressive_speech_translation_tpu.models import nllb as jnl
from expressive_speech_translation_tpu.models import qwen2 as jq2
from expressive_speech_translation_tpu.models import whisper as jwh
from expressive_speech_translation_tpu.pipeline.cascaded import CascadedBackend as JaxBackend
from expressive_speech_translation_tpu.pipeline.engines import Engines as JaxEngines
from expressive_speech_translation_tpu.pipeline.jax_engines import (
    JaxCosyVoiceTts, JaxNllbNmt, JaxWhisperAsr)
from expressive_speech_translation_tpu_torch.models import cosyvoice as tcv
from expressive_speech_translation_tpu_torch.models import cosyvoice_official as tco
from expressive_speech_translation_tpu_torch.models import ecapa as tec
from expressive_speech_translation_tpu_torch.models import nllb as tnl
from expressive_speech_translation_tpu_torch.models import qwen2 as tq2
from expressive_speech_translation_tpu_torch.models import speech_tokenizer as tst
from expressive_speech_translation_tpu_torch.models import whisper as twh
from expressive_speech_translation_tpu_torch.pipeline.cascaded import CascadedBackend
from expressive_speech_translation_tpu_torch.pipeline.engines import Engines
from expressive_speech_translation_tpu_torch.pipeline.languages import nllb_placeholder_lang_ids
from expressive_speech_translation_tpu_torch.pipeline.torch_engines import (
    TorchCosyVoiceTts, TorchNllbNmt, TorchWhisperAsr, torch_engines)

from test_torch_official import CLONE, JCLONE, EngineNoise

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
AUDIO_ATOL = 1e-4


def _fields(cfg):
    return {f: getattr(cfg, f) for f in cfg.__dataclass_fields__}


WCFG = jwh.WhisperConfig(
    d_model=64, encoder_layers=2, decoder_layers=2, heads=4, ffn_dim=128,
    vocab_size=365, max_target_positions=64, eos_token=260, bos_token=261,
    lang_token_start=262, task_translate=361, task_transcribe=362, no_timestamps=363,
    sop_token=364, no_speech_token=360)
NCFG = jnl.NLLBConfig(d_model=64, encoder_layers=2, decoder_layers=2, heads=4, ffn_dim=128,
                      vocab_size=384, max_positions=128)
QCFG = jq2.Qwen2Config(hidden=64, layers=2, heads=4, kv_heads=2, ffn_dim=128, max_positions=1024)
CCFG = jcv.CosyVoiceConfig(
    lm=jcv.SpeechLMConfig(backbone=QCFG, text_vocab=384, speech_token_size=64),
    flow=jcv.FlowConfig(token_vocab=67, dim=64, layers=2, heads=4),
    vocoder=jcv.VocoderConfig(base_channels=64))
TCCFG = tcv.CosyVoiceConfig(
    lm=tcv.SpeechLMConfig(backbone=tq2.Qwen2Config(**_fields(QCFG)),
                          **{f: v for f, v in _fields(CCFG.lm).items()
                             if f in tcv.SpeechLMConfig.__dataclass_fields__ and f != "backbone"}),
    flow=tcv.FlowConfig(**_fields(CCFG.flow)),
    vocoder=tcv.VocoderConfig(**_fields(CCFG.vocoder)))


def _np(tree):
    return jax.tree.map(np.asarray, tree)


def _t(a):
    return torch.from_numpy(np.array(a))


class JaxCallNoise:
    """The JAX TTS engine's key schedule for synthesis call ``n``."""

    def __init__(self, n):
        key = jax.random.fold_in(jax.random.PRNGKey(42), jnp.uint32(n))
        self.k_lm, self.k_flow = jax.random.split(key)

    def ras_gumbel(self, step, shape):
        k1, k2 = jax.random.split(jax.random.fold_in(self.k_lm, step))
        return (_t(jax.random.gumbel(k1, shape, jnp.float32)),
                _t(jax.random.gumbel(k2, shape, jnp.float32)))

    def flow_x0(self, shape):
        return _t(jax.random.normal(self.k_flow, shape, jnp.float32))


def _speechlike(seconds, seed, sr=16_000):
    g = np.random.default_rng(seed)
    t = np.arange(int(sr * seconds)) / sr
    x = 0.4 * np.sin(2 * np.pi * 220 * t) + 0.02 * g.standard_normal(t.shape)
    return (x * (0.5 + 0.5 * np.sin(2 * np.pi * 3.0 * t) ** 2)).astype(np.float32)


@pytest.fixture(scope="module")
def cascades():
    """(JAX backend, port backend) on the same weights. Each test calls both
    once per synthesis, so their TTS call counters (the noise keys) agree."""
    lang_ids = nllb_placeholder_lang_ids(NCFG.vocab_size)
    jasr = JaxWhisperAsr(WCFG, None, dtype=jnp.float32, max_new_tokens=12,
                         context_buckets=(2,))
    jnmt = JaxNllbNmt(NCFG, None, dtype=jnp.float32, max_new_tokens=12)
    jtts = JaxCosyVoiceTts(CCFG, None, dtype=jnp.float32)
    cpu = "cpu"
    asr = TorchWhisperAsr(twh.WhisperConfig(**_fields(WCFG)),
                          twh.from_jax_params(_np(jasr.params), cpu), device=cpu,
                          dtype=torch.float32, max_new_tokens=12, context_buckets=(2,),
                          temperatures=(0.0,))
    nmt = TorchNllbNmt(tnl.NLLBConfig(**_fields(NCFG)), tnl.from_jax_params(_np(jnmt.params), cpu),
                       device=cpu, lang_code_to_id=lang_ids, dtype=torch.float32,
                       max_new_tokens=12)
    tts = TorchCosyVoiceTts(
        TCCFG, tcv.from_jax_params(_np(jtts.params), cpu), device=cpu, dtype=torch.float32,
        noise=JaxCallNoise,
        ecapa_weights=(tec.from_jax_params(_np(jtts._ecapa), cpu),
                       tec.EcapaConfig(**_fields(jtts._ecapa_cfg))),
        speech_tokenizer_weights=(tst.from_jax_params(_np(jtts._st), cpu),
                                  tst.SpeechTokenizerConfig(**_fields(jtts._st_cfg))))
    # the JAX engines drew their own weights, so they run with the
    # random-weight policies (no empty-translation failure, wrapped ids)
    nmt.weightless = tts.weightless = True
    return (JaxBackend(JaxEngines(asr=jasr, nmt=jnmt, tts=jtts)),
            CascadedBackend(Engines(asr=asr, nmt=nmt, tts=tts)))


def test_translate_speech_matches_jax_cascade(cascades):
    """4.5 s through 2 s ASR windows: three windows, the later ones prompted
    with the earlier windows' tokens (condition_on_previous_text)."""
    jax_backend, backend = cascades
    x = _speechlike(4.5, seed=5)
    want = jax_backend.translate_speech(x, "eng", "fra", use_voice_cloning=False)
    got = backend.translate_speech(x, "eng", "fra", use_voice_cloning=False)
    assert got["transcripts"] == want["transcripts"]
    assert got["transcripts"]["source"]
    assert got["audio"].shape == want["audio"].shape
    assert np.isfinite(got["audio"]).all()
    np.testing.assert_allclose(got["audio"], want["audio"], atol=AUDIO_ATOL, rtol=0)
    assert set(got["stage_summary"]) == {"asr", "nmt", "tts", "post", "total"}


def test_translate_speech_at_its_defaults_clones_the_voice_like_jax(cascades):
    """``translate_speech(x, src, tgt)`` with default arguments clones the
    source voice: the first 10 s of the source (tiled when shorter)
    conditions TTS through ECAPA, the Kaldi-fbank prompt mel and the FSQ
    prompt tokens, and the source transcript rides ahead of the text."""
    jax_backend, backend = cascades
    x = _speechlike(4.5, seed=8)
    want = jax_backend.translate_speech(x, "eng", "fra")
    got = backend.translate_speech(x, "eng", "fra")
    assert got["transcripts"] == want["transcripts"]
    assert got["audio"].shape == want["audio"].shape
    assert np.isfinite(got["audio"]).all()
    np.testing.assert_allclose(got["audio"], want["audio"], atol=AUDIO_ATOL, rtol=0)


def _visual_spies(monkeypatch, detector_cls, mapper):
    """Record each ``detect_speech_segments`` call (the detector's fps, the
    detector, the segments) and each ``distribute_audio`` call."""
    detects, distributes = [], []
    detect, distribute = detector_cls.detect_speech_segments, mapper.distribute_audio

    def spy_detect(self, frames):
        segs = detect(self, frames)
        detects.append((self.fps, self, [(g.start, g.end) for g in segs]))
        return segs

    def spy_distribute(*args, **kwargs):
        distributes.append(len(args[1]))
        return distribute(*args, **kwargs)

    monkeypatch.setattr(detector_cls, "detect_speech_segments", spy_detect)
    monkeypatch.setattr(mapper, "distribute_audio", spy_distribute)
    return detects, distributes


def test_translate_speech_takes_the_jax_keywords(cascades, monkeypatch):
    """The JAX backend's signature: without frames, ``video_fps`` and an
    unknown keyword change nothing. With frames the translation goes into the
    speech segments they show, as JAX's does: a talking-head clip (one
    segment, the visual branch taken), the same clip at 30 fps with a 25 fps
    detector preset (rebuilt at 30 fps), and still frames (no segment: the
    natural-flow mapping, the visual mapper not called)."""
    from expressive_speech_translation_tpu.pipeline import visual_speech_detector as jvsd
    from expressive_speech_translation_tpu_torch.pipeline import visual_speech_detector as tvsd
    from test_face import synthetic_clip

    jax_backend, backend = cascades
    x = _speechlike(2.5, seed=9)
    kw = dict(use_voice_cloning=False, video_fps=30.0, request_id="r1")
    want = jax_backend.translate_speech(x, "eng", "fra", **kw)
    got = backend.translate_speech(x, "eng", "fra", original_video_frames=[], **kw)
    assert got["transcripts"] == want["transcripts"]
    assert got["audio"].shape == want["audio"].shape
    np.testing.assert_allclose(got["audio"], want["audio"], atol=AUDIO_ATOL, rtol=0)

    jspies = _visual_spies(monkeypatch, jvsd.VisualSpeechDetector, jax_backend.visual_mapper)
    tspies = _visual_spies(monkeypatch, tvsd.VisualSpeechDetector, backend.visual_mapper)
    still = [np.full((64, 64, 3), 90, np.uint8)] * 60
    cases = [("face", list(synthetic_clip(n=60)), 24.0, None),
             ("fps mismatch", list(synthetic_clip(n=75)), 30.0, 25.0),
             ("still", still, 24.0, None)]
    for label, frames, fps, preset in cases:
        jax_backend.visual_mapper.detector = preset and jvsd.VisualSpeechDetector(fps=preset)
        backend.visual_mapper.detector = preset and tvsd.VisualSpeechDetector(fps=preset)
        vkw = dict(use_voice_cloning=False, original_video_frames=frames, video_fps=fps)
        want = jax_backend.translate_speech(x, "eng", "fra", **vkw)
        got = backend.translate_speech(x, "eng", "fra", **vkw)
        assert got["transcripts"] == want["transcripts"], label
        assert got["audio"].shape == want["audio"].shape, label
        assert np.isfinite(got["audio"]).all()
        np.testing.assert_allclose(got["audio"], want["audio"], atol=AUDIO_ATOL, rtol=0,
                                   err_msg=label)
        for (detects, distributes), mapper in ((jspies, jax_backend.visual_mapper),
                                               (tspies, backend.visual_mapper)):
            (det_fps, det, segs), = detects
            assert det_fps == fps and det is not mapper.detector, label
            assert bool(segs) == (label != "still"), (label, segs)
            assert distributes == ([len(segs)] if segs else []), label
            detects.clear(), distributes.clear()
    jax_backend.visual_mapper.detector = backend.visual_mapper.detector = None


def test_the_backend_language_queries_cleanup_and_audio_processor(cascades):
    """``get_supported_languages`` and ``cleanup`` as JAX's; the backend's
    audio processor is built at first use, on its ASR engine's device."""
    jax_backend, backend = cascades
    assert backend.get_supported_languages() == jax_backend.get_supported_languages()
    assert "fra" in backend.get_supported_languages() and "ukr" not in \
        backend.get_supported_languages()
    assert backend.cleanup() is None and jax_backend.cleanup() is None
    assert "audio_processor" not in vars(backend)
    proc = backend.audio_processor
    assert proc.device == torch.device("cpu") and backend.audio_processor is proc
    assert proc.config is backend.config.audio
    x = _speechlike(1.0, seed=10)
    np.testing.assert_allclose(proc.process_audio(x), jax_backend.audio_processor.process_audio(x),
                               atol=1e-5, rtol=0)


def test_a_backend_over_fakes_constructs_without_the_card():
    """Constructing and initializing needs no card; the audio processor,
    built at first use for engines that name no device, asks for it."""
    if torch.cuda.is_available():
        pytest.skip("this host has a CUDA device; the default device is valid here")

    class Fake:
        def transcribe(self, audio, language=None):
            return {"text": "bonjour", "words": []}

        def translate(self, text, src, tgt):
            return text

        def synthesize(self, text, **kw):
            return np.zeros(24_000, np.float32)

    f = Fake()
    backend = CascadedBackend(Engines(asr=f, nmt=f, tts=f))
    backend.initialize()
    assert backend.initialized and backend.visual_mapper.initialized
    with pytest.raises(RuntimeError, match="no CUDA device"):
        backend.audio_processor


def test_synthesize_with_a_reference_matches_jax(cascades):
    """The cloning branch on its own: the conditioning (speaker embedding,
    prompt mel, prompt speech tokens) and the synthesized audio."""
    jax_backend, backend = cascades
    jtts, tts = jax_backend.engines.tts, backend.engines.tts
    ref = _speechlike(3.2, seed=12)
    ref10 = np.resize(ref, 16_000 * 10)
    jspk, jpmel, jpsp = jtts._cond_fn(jtts._ecapa, jtts._st, ref10)
    spk, pmel, psp = tts._cond(ref10)
    assert psp.dtype == torch.int32 and tuple(psp.shape) == (1, 50)
    np.testing.assert_array_equal(psp.numpy(), np.asarray(jpsp))
    assert tuple(pmel.shape) == (1, 50 * TCCFG.flow.token_mel_ratio, TCCFG.flow.n_mels)
    np.testing.assert_allclose(spk.numpy(), np.asarray(jspk), atol=1e-5, rtol=0)
    # ln fbank: 1e-4 for bands within 50 dB of the frame's peak (see
    # tests/test_torch_conditioning.py); the weakest bands only to 1e-3
    np.testing.assert_allclose(pmel.numpy(), np.asarray(jpmel), atol=1e-3, rtol=0)
    want = jtts.synthesize("bonjour a tous", style_prompt="hello all", reference_audio_16k=ref)
    got = tts.synthesize("bonjour a tous", style_prompt="hello all", reference_audio_16k=ref)
    assert got.shape == want.shape and got.size > 0
    np.testing.assert_allclose(got, want, atol=AUDIO_ATOL, rtol=0)


@pytest.fixture(scope="module")
def official_cascades(cascades):
    """The two cascades with their TTS stage served by the official chain
    (one seeded tiny triple, its EOS logit raised by 1 so that speech ends
    before the 64-token budget), the ASR and NMT engines shared."""
    jax_backend, backend = cascades
    tree = jax.tree.map(np.array, jco.init_official_tts(jax.random.PRNGKey(0), JCLONE))
    tree["lm"]["head"]["bias"][JCLONE.lm.eos_speech] += 1.0
    jtts = JaxCosyVoiceTts(dtype=jnp.float32, official=(tree, JCLONE))
    tts = TorchCosyVoiceTts(
        device="cpu", dtype=torch.float32, noise=EngineNoise,
        official=(tco.from_jax_params(tree, "cpu"), CLONE),
        ecapa_weights=(tec.from_jax_params(_np(jtts._ecapa), "cpu"),
                       tec.EcapaConfig(**_fields(jtts._ecapa_cfg))),
        speech_tokenizer_weights=(tst.from_jax_params(_np(jtts._st), "cpu"),
                                  tst.SpeechTokenizerConfig(**_fields(jtts._st_cfg))))
    jeng, eng = jax_backend.engines, backend.engines
    return (JaxBackend(JaxEngines(asr=jeng.asr, nmt=jeng.nmt, tts=jtts)),
            CascadedBackend(Engines(asr=eng.asr, nmt=eng.nmt, tts=tts)))


def test_translate_speech_through_the_official_chain_matches_jax(official_cascades):
    """At its defaults (voice cloning on): the x-vector, the prompt mel and
    the FSQ prompt tokens of the source condition the official flow."""
    jax_backend, backend = official_cascades
    x = _speechlike(2.5, seed=21)
    want = jax_backend.translate_speech(x, "eng", "fra")
    got = backend.translate_speech(x, "eng", "fra")
    assert got["transcripts"] == want["transcripts"]
    assert got["audio"].shape == want["audio"].shape
    assert np.isfinite(got["audio"]).all()
    np.testing.assert_allclose(got["audio"], want["audio"], atol=AUDIO_ATOL, rtol=0)


def test_translate_speech_streaming_through_the_official_chain_matches_jax(official_cascades):
    """3 s through 2 s ASR windows, cloning on: a transcripts event a window,
    then that window's 16 kHz audio from the official chain's stream."""
    jax_backend, backend = official_cascades
    x = _speechlike(3.0, seed=22)
    want = list(jax_backend.translate_speech_streaming(x, "eng", "fra"))
    got = list(backend.translate_speech_streaming(x, "eng", "fra"))
    assert [e["type"] for e in got] == [e["type"] for e in want]
    assert [e["type"] for e in got].count("audio") >= 1
    for g, w in zip(got, want):
        if g["type"] == "audio":
            assert g["chunk"].shape == w["chunk"].shape
            np.testing.assert_allclose(g["chunk"], w["chunk"], atol=AUDIO_ATOL, rtol=0)
        else:
            assert g == w


def test_translate_text_matches_jax_cascade(cascades):
    jax_backend, backend = cascades
    want = jax_backend.translate_text("hello there, friend", "eng", "deu", synthesize=True)
    got = backend.translate_text("hello there, friend", "eng", "deu", synthesize=True)
    assert got["target_text"] == want["target_text"]
    assert got["audio"].shape == want["audio"].shape
    np.testing.assert_allclose(got["audio"], want["audio"], atol=AUDIO_ATOL, rtol=0)
    words = [{"word": "a", "start": 0.0, "end": 0.4}, {"word": "b", "start": 0.9, "end": 1.2},
             {"word": "c", "start": 1.3, "end": 1.5}]
    assert backend.extract_pauses(words) == jax_backend.extract_pauses(words)


def test_asr_fallback_ladder_and_previous_text_prompts():
    """Random weights fail the avg-logprob gate, so every rung of the ladder
    runs and the last is kept; a window kept at a rung of at most 0.5 prompts
    the next window with its tokens, and rungs above 0.5 drop that prompt
    (openai-whisper transcribe semantics, as in the JAX engine)."""
    asr = TorchWhisperAsr(twh.WhisperConfig(**_fields(WCFG)), device="cpu",
                          dtype=torch.float32, max_new_tokens=12, context_buckets=(2,),
                          temperatures=(0.0, 0.4))
    calls = []
    decode = asr._decode

    def spy(padded, row, temperature):
        calls.append((len(row), temperature))
        return decode(padded, row, temperature)

    asr._decode = spy
    out = asr.transcribe(_speechlike(4.5, seed=6), language="eng")
    assert [t for _, t in calls] == [0.0, 0.4] * 3
    assert [n for n, _ in calls[:2]] == [4, 4]
    assert all(n > 4 for n, _ in calls[2:])          # later windows carry prev text
    assert out["language"] == "eng" and isinstance(out["words"], list)
    calls.clear()
    asr.temperatures = (0.0, 0.8)
    padded, bucket_s = asr._pad_to_bucket(_speechlike(1.0, seed=7))
    row = [WCFG.sop_token] + [40] * 8 + asr._prompt_row("eng")
    *_, used = asr._decode_chunk_fallback(padded, row, 0.0, 1.0, bucket_s,
                                          bare_row=asr._prompt_row("eng"))
    assert calls == [(13, 0.0), (4, 0.8)] and used == 0.8
    # without a language the engine detects it, and the ladder runs as before
    calls.clear()
    silence = np.zeros(16_000, np.float32)
    assert asr.transcribe(silence)["language"] == asr.detect_language(silence)
    assert calls == [(4, 0.0), (4, 0.8)]


def test_port_runs_without_jax_or_the_jax_package():
    """A fresh process runs the port's tiny cascade on the CPU, imports
    every module (the checkpoint loaders, the safetensors reader, the
    tokenizers, the WAV codec, the audio front end, the visual mapping, the
    configuration, the serving stack, the media shim and MuseTalk among
    them), serves a bake, runs ``load_config()``, a request with video
    frames and a lip-sync render, ``est-torch translate`` with fake engines
    (the CLI, the batch runner and the evaluation modules imported), a
    two-step SFT run with a checkpoint restored and a diagnostics report
    (``train/``, ``obs/kvlogger.py``, ``pipeline/diagnostics/`` and
    ``pipeline/debug_analyzer.py``, none importing matplotlib), meshes,
    stage placement and ``vocode_sp`` (``parallel/``), with
    jax, the JAX
    package, ``yaml`` and ``psutil`` blocked from import, and must not have
    imported them nor the optional ``safetensors`` / ``transformers`` /
    ``tokenizers``, nor ``urllib3`` / ``certifi`` past what torch imports
    (this test process has them all: tests/conftest.py imports jax); the
    alternate backends (Seamless, VITS, ESPnet) translate a toy request; the
    new modules import no ``scipy``
    or ``yaml`` at module level. Every serving module but ``serve/app.py``
    imports with werkzeug blocked too; then ``serve/app.py`` imports and
    answers a request."""
    script = textwrap.dedent("""
        import sys
        import importlib.abc

        class Block(importlib.abc.MetaPathFinder):
            def find_spec(self, name, path=None, target=None):
                if name.split(".")[0] in BLOCKED:
                    raise ImportError(f"{name} is blocked")

        BLOCKED = {"jax", "expressive_speech_translation_tpu", "yaml", "psutil", "werkzeug"}
        sys.meta_path.insert(0, Block())
        import numpy as np, torch
        with_torch = set(sys.modules)      # torch itself may import certifi
        from expressive_speech_translation_tpu_torch.models import cosyvoice as cv, nllb, qwen2, whisper
        from expressive_speech_translation_tpu_torch.pipeline.cascaded import CascadedBackend
        from expressive_speech_translation_tpu_torch.pipeline.torch_engines import torch_engines
        eng = torch_engines(device="cpu", dtype=torch.float32,
            asr_cfg=whisper.WhisperConfig(d_model=32, encoder_layers=1, decoder_layers=1, heads=2,
                ffn_dim=64, vocab_size=365, max_target_positions=32, eos_token=260, bos_token=261,
                lang_token_start=262, task_transcribe=362, no_timestamps=363, sop_token=364,
                no_speech_token=360),
            nmt_cfg=nllb.NLLBConfig(d_model=32, encoder_layers=1, decoder_layers=1, heads=2,
                ffn_dim=64, vocab_size=384, max_positions=64),
            tts_cfg=cv.CosyVoiceConfig(
                lm=cv.SpeechLMConfig(backbone=qwen2.Qwen2Config(hidden=32, layers=1, heads=2,
                    kv_heads=1, ffn_dim=64, max_positions=1024), text_vocab=384, speech_token_size=32),
                flow=cv.FlowConfig(token_vocab=35, dim=32, layers=1, heads=2),
                vocoder=cv.VocoderConfig(base_channels=32)))
        eng.asr.max_new_tokens = eng.nmt.max_new_tokens = 8
        backend = CascadedBackend(eng)
        backend.initialize()              # warms TTS through the cloning path
        x = np.sin(np.arange(24_000) / 7.0).astype(np.float32)
        for cloning in (True, False):
            out = backend.translate_speech(x, "eng", "fra", use_voice_cloning=cloning)
            assert out["audio"].ndim == 2 and np.isfinite(out["audio"]).all()
        from expressive_speech_translation_tpu_torch.core import buckets
        from expressive_speech_translation_tpu_torch.models import (
            cosyvoice_official, ecapa, flow_matcha, hift, loaders, speech_tokenizer)
        cfg = cosyvoice_official.OfficialTtsConfig.tiny()
        official = torch_engines(device="cpu", dtype=torch.float32, tts_official=(
            cosyvoice_official.init_official_tts(0, cfg, "cpu"), cfg))
        wave = official.tts.synthesize("hello")
        assert wave.size > 0 and wave.size % (2 * cfg.hift.hop) == 0 and np.isfinite(wave).all()
        from expressive_speech_translation_tpu_torch.ops import (
            cuda_decode, cuda_int4, mel, resample)
        # meshes, stage placement and the four-card check
        from expressive_speech_translation_tpu_torch import parallel
        from expressive_speech_translation_tpu_torch.parallel import mesh as pmesh, smoke, stages
        meshes = stages.stage_meshes(devices=pmesh.cpu_slots(4))
        assert stages.placement_report(meshes).startswith("asr: devices [0] mesh {'dp': 1")
        sp = cv.vocode_sp(eng.tts.params["vocoder"], eng.tts.cfg.vocoder,
                          torch.zeros((1, 8, 80)), parallel.host_cpu_mesh(2), "dp")
        assert sp.shape == (1, 8 * eng.tts.cfg.vocoder.hop)
        from expressive_speech_translation_tpu_torch.serve import batching
        from expressive_speech_translation_tpu_torch.media import wavio
        from expressive_speech_translation_tpu_torch.models import safetensors_io
        from expressive_speech_translation_tpu_torch.obs import checkpoint_emitters
        from expressive_speech_translation_tpu_torch.pipeline import tokenizer
        # a bake served under EST_MODELS_DIR, read with torch alone
        import os, tempfile
        root = tempfile.mkdtemp()
        loaders.save_converted(ecapa.init_ecapa(0, ecapa.EcapaConfig(channels=16, mfa_out=48,
            bottleneck=8), "cpu"), ecapa.EcapaConfig(channels=16, mfa_out=48, bottleneck=8),
            os.path.join(root, "ecapa"))
        os.environ["EST_MODELS_DIR"] = root
        assert torch_engines(device="cpu").tts.conditioning_weightless is False
        assert type(tokenizer.load_tokenizer(None)).__name__ == "ByteTokenizer"
        # the audio front end, the visual mapping and the configuration
        from expressive_speech_translation_tpu_torch.core.config import load_config
        from expressive_speech_translation_tpu_torch.ops import dsp, stft
        from expressive_speech_translation_tpu_torch.pipeline import (
            audio_processor, face, visual_speech_detector, visual_temporal_mapper)
        assert not [m for m in sys.modules if m.split(".")[0] in ("scipy", "yaml")]
        cfg = load_config(env={"EST_SERVE__PORT": "7001", "EST_MODELS_DIR": root})
        assert cfg.serve.port == 7001 and load_config().audio.sample_rate == 16_000
        proc = audio_processor.AudioProcessor(cfg.audio, device="cpu")
        y = proc.process_audio(np.stack([x, x[::-1].copy()]), orig_sr=24_000)
        assert y.shape == (16_000,) and np.isfinite(y).all()
        frames = [np.full((48, 64, 3), 90, np.uint8)] * 12
        out = backend.translate_speech(x, "eng", "fra", original_video_frames=frames)
        assert out["audio"].ndim == 2 and np.isfinite(out["audio"]).all()
        # the serving stack: every module but the app without werkzeug
        from expressive_speech_translation_tpu_torch import media, serve
        from expressive_speech_translation_tpu_torch.core import errors
        from expressive_speech_translation_tpu_torch.obs import logging_setup
        from expressive_speech_translation_tpu_torch.pipeline import backend as be, engines, watermark
        from expressive_speech_translation_tpu_torch.serve import (
            audio_link, limiter, podcasts, resource_monitor, video)
        assert errors.MediaError("m", user_message="u").to_payload()["error"] == "u"
        # the video route's media shim and lip-sync
        from expressive_speech_translation_tpu_torch.media import native
        from expressive_speech_translation_tpu_torch.models import musetalk
        from expressive_speech_translation_tpu_torch.pipeline import musetalk_pipeline
        native.available()
        mt_cfg = musetalk.MuseTalkConfig(image_size=32, vae_channels=(8, 16), vae_layers=1,
            unet_channels=(8, 16), unet_layers=1, audio_dim=16, audio_ctx=4, heads=2,
            norm_groups=4)
        lip = musetalk_pipeline.musetalk_lipsync_fn(cfg=mt_cfg, device="cpu",
                                                    dtype=torch.float32)
        clip = np.random.default_rng(0).integers(0, 255, (3, 40, 48, 3), np.uint8)
        assert lip(clip, 25.0, np.zeros(3_000, np.float32), 24_000).shape == clip.shape
        # the diff2lip family: one toy frame rendered
        from expressive_speech_translation_tpu_torch.pipeline import diff2lip
        d2l_cfg = diff2lip.Diff2LipConfig(image_size=16, model_channels=8, channel_mult=(1, 2),
            attention_ds=(2,), heads=2, norm_groups=4, audio_model_channels=8,
            audio_channel_mult=(1, 2), audio_init_spatial=16, diffusion_steps=8,
            sampling_steps="ddim2")
        d2l = diff2lip.Diff2LipPipeline(d2l_cfg, device="cpu")
        assert d2l.generate(clip[:1], np.zeros(1_600, np.float32), 25.0).shape == clip[:1].shape
        assert resource_monitor.process_rss_bytes() > 0 and resource_monitor.device_memory_stats() == {}
        # the split deployment: OpenVoice, speaker similarity, the services,
        # their clients and the URL fetcher import without werkzeug
        from expressive_speech_translation_tpu_torch import evals
        from expressive_speech_translation_tpu_torch.evals import acoustic_metrics
        from expressive_speech_translation_tpu_torch.models import openvoice
        from expressive_speech_translation_tpu_torch.serve import (
            clients, media_fetcher, model_services)
        ov_cfg = openvoice.OpenVoiceConfig(n_fft=128, hop=32, n_spec=65, inter_channels=4,
            hidden=8, se_dim=8, n_flows=1, flow_wn_layers=1, post_wn_layers=1,
            upsample_initial=8, upsample_rates=(2, 2), upsample_kernels=(4, 4),
            resblock_kernels=(3,), resblock_dilations=((1,),), ref_filters=(2, 2))
        ov = openvoice.init_openvoice(0, ov_cfg, "cpu")
        wav = torch.from_numpy(x[None, :4_000])
        se = openvoice.extract_se(ov, ov_cfg, openvoice.spectrogram_22k(wav, ov_cfg))
        assert openvoice.convert_tone(ov, ov_cfg, wav, se, se).shape == (1, 125 * 4)
        ecfg = ecapa.EcapaConfig(channels=16, mfa_out=48, bottleneck=8)
        assert -1 <= acoustic_metrics.speaker_similarity(x, x[::-1].copy(), cfg=ecfg,
                                                          device="cpu") <= 1
        assert clients._parse_wav_bytes(clients._wav_bytes(x, 16_000))[1] == 16_000
        try:
            media_fetcher._resolve_public_host("http://10.0.0.1/a.wav")
        except errors.MediaError as e:
            assert "non-public" in str(e)
        # the alternate backends: Seamless, VITS and the ESPnet backend
        from expressive_speech_translation_tpu_torch.models import seamless, vits_tts
        from expressive_speech_translation_tpu_torch.pipeline import alternate_backends as ab
        sb = ab.SeamlessBackend(device="cpu", num_beams=2, max_text_tokens=4, max_chars=8,
                                max_units=8)
        sb.initialize()
        assert sb.translate_speech(x[:8_000], "eng", "fra")["audio"].shape[1] <= 8 * 2 * 16
        eb = ab.ESPnetBackend(asr_factory=lambda lang: eng.asr, device="cpu",
            tts_factory=lambda lang: vits_tts.VitsTTSModel(lang, device="cpu", max_frames=16))
        assert eb.translate_speech(x[:8_000], "eng", "fra")["audio"].ndim == 2
        assert ab.ModelManager(loader=dict).get_model_components() == {}
        # the tools: the CLI, the batch runner and the evaluation battery
        import contextlib, io, json
        from expressive_speech_translation_tpu_torch import cli
        from expressive_speech_translation_tpu_torch.batch import manifest, runner
        from expressive_speech_translation_tpu_torch.core import registry
        from expressive_speech_translation_tpu_torch.evals import (
            analyze, semantic, ser, text_metrics, verify_quality, visual_metrics, visual_models)
        wavio.write_wav(os.path.join(root, "in.wav"), x[:16_000], 16_000)
        out = io.StringIO()
        with contextlib.redirect_stdout(out):
            assert cli.main(["translate", os.path.join(root, "in.wav"),
                             os.path.join(root, "out.wav"), "--target-lang", "fra",
                             "--engines", "fake", "--device", "cpu"]) == 0
        assert json.loads(out.getvalue())["transcripts"]["target"].startswith("[fra_Latn]")
        # training and the diagnostics
        from expressive_speech_translation_tpu_torch import train
        from expressive_speech_translation_tpu_torch.obs import kvlogger
        from expressive_speech_translation_tpu_torch.pipeline import debug_analyzer, diagnostics
        from expressive_speech_translation_tpu_torch.pipeline.diagnostics import (
            languages, neural, phonetics, quality, spectral, temporal, visualize)
        from expressive_speech_translation_tpu_torch.train import (
            checkpoint, data, executor, plot, prepare_mcv, run, sft)
        lm = cv.SpeechLMConfig(backbone=qwen2.Qwen2Config(hidden=32, layers=1, heads=2,
            kv_heads=1, ffn_dim=64, max_positions=64), text_vocab=50, speech_token_size=20)
        opt = sft.make_optimizer(1e-2)
        state = sft.init_train_state(0, lm, opt, device="cpu")
        step = sft.make_train_step(lm, opt, accum_grad=1)
        ids = np.ones((1, 2, 4), np.int32)
        batch = sft.SFTBatch(ids, ids > 0, ids, ids > 0)
        for _ in range(2):
            state, metrics = step(state, batch)
        ckpt = checkpoint.CheckpointManager(os.path.join(root, "ckpt"), save_interval_steps=1)
        assert ckpt.save(state, metrics=metrics)
        assert ckpt.restore(sft.init_train_state(1, lm, opt, device="cpu")).step == 2
        report = diagnostics.AudioDiagnostics(device="cpu").analyze_translation(
            x[:16_000], x[:12_000], language="fra")
        assert report["narrative"] and debug_analyzer.AudioDebugAnalyzer().compare(x, x)
        assert "matplotlib" not in sys.modules
        assert "werkzeug" not in sys.modules
        BLOCKED.discard("werkzeug")
        from expressive_speech_translation_tpu_torch.serve import app
        from werkzeug.test import Client
        r = Client(app.create_app(device="cpu")).get("/available-backends")
        assert r.status_code == 200 and r.get_json()["weights"] == {"cascaded": "fake"}
        tts = clients.CosyVoiceClient(clients.WsgiTransport(
            model_services.CosyVoiceService(device="cpu")), retries=1, retry_delay_s=0)
        assert tts.check_health() and tts.synthesize("hello").size > 0
        bad = [m for m in sys.modules if m.split(".")[0] in (
            "jax", "expressive_speech_translation_tpu", "safetensors", "transformers",
            "tokenizers", "yaml", "psutil", "requests")]
        bad += [m for m in set(sys.modules) - with_torch
                if m.split(".")[0] in ("urllib3", "certifi")]
        print("FORBIDDEN", bad)
    """)
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    env["PYTHONPATH"] = REPO
    proc = subprocess.run([sys.executable, "-c", script], cwd=REPO, env=env,
                          capture_output=True, text=True, timeout=300)
    assert proc.returncode == 0, proc.stderr[-3000:]
    assert "FORBIDDEN []" in proc.stdout, proc.stdout


@pytest.mark.cuda
def test_a_train_step_and_a_diagnostics_report_on_the_card_agree_with_the_cpu():
    """On a card: two f32 SFT steps of a toy LM (loss, grad_norm, the tree)
    and a diagnostics report, each against the same call on the CPU."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    from expressive_speech_translation_tpu_torch.models.common import tree_from_numpy
    from expressive_speech_translation_tpu_torch.pipeline.diagnostics import AudioDiagnostics
    from expressive_speech_translation_tpu_torch.train import sft

    lm = tcv.SpeechLMConfig(backbone=tq2.Qwen2Config(hidden=64, layers=2, heads=4, kv_heads=2,
                                                     ffn_dim=128, max_positions=64),
                            text_vocab=50, speech_token_size=20)
    g = np.random.default_rng(0)
    ids = g.integers(1, 20, (2, 3, 8)).astype(np.int32)
    batch = sft.SFTBatch(ids, ids > 2, ids, ids > 1)
    runs = []
    for dev in ("cpu", "cuda"):
        opt = sft.make_optimizer(1e-5)
        host = sft.init_train_state(0, lm, opt, device="cpu").params
        state = sft.init_train_state(0, lm, opt, params=tree_from_numpy(
            jax.tree.map(lambda t: t.detach().numpy(), host), dev))
        step = sft.make_train_step(lm, opt, accum_grad=3, compute_dtype=torch.float32)
        for _ in range(2):
            state, m = step(state, batch)
        runs.append((m, [p.detach().cpu() for p in sft.tree_leaves(state.params)]))
    (m_cpu, p_cpu), (m_card, p_card) = runs
    for k in ("loss", "grad_norm"):
        assert float(m_card[k]) == pytest.approx(float(m_cpu[k]), rel=1e-5)
    for a, b in zip(p_card, p_cpu):
        assert float((a - b).abs().max()) <= 1e-5 * float(b.abs().max()) + 4e-5
    x = np.sin(np.arange(32_000) / 9.0).astype(np.float32) * np.linspace(0, 1, 32_000,
                                                                          dtype=np.float32)
    card = AudioDiagnostics(device="cuda").analyze_translation(x, x[::-1].copy(),
                                                               language="fra")
    host = AudioDiagnostics(device="cpu").analyze_translation(x, x[::-1].copy(),
                                                              language="fra")
    assert card.keys() == host.keys() and card["narrative"] == host["narrative"]
    for section in ("spectral", "quality"):
        for k, v in host[section].items():
            assert card[section][k] == pytest.approx(v, rel=1e-4, nan_ok=True), (section, k)


def test_torch_engines_without_a_device_need_the_card():
    if torch.cuda.is_available():
        pytest.skip("this host has a CUDA device; the default device is valid here")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        torch_engines()
    with pytest.raises(RuntimeError, match="no CUDA device"):
        TorchNllbNmt(tnl.NLLBConfig(**_fields(NCFG)))


def test_a_reference_of_at_most_a_tenth_of_a_second_engages_no_cloning():
    """As in the JAX engine: above 1600 samples the reference conditions the
    speech (and its transcript is prepended); at or below, nothing does."""
    tts = TorchCosyVoiceTts(TCCFG, device="cpu", dtype=torch.float32)
    calls = []
    cond = tts._cond
    tts._cond = lambda ref: calls.append(ref.shape) or cond(ref)
    assert tts.synthesize("hi", style_prompt="yo", reference_audio_16k=np.zeros(1600, np.float32)).size > 0
    assert calls == []
    assert tts._text_ids("hi", "yo", np.zeros(1600)) == tts._text_ids("hi", "", None)
    assert tts.synthesize("hi", style_prompt="yo", reference_audio_16k=np.ones(1601, np.float32)).size > 0
    assert calls == [(160_000,)]
    assert tts.conditioning_weightless and tts._ecapa_cfg.channels == 128
