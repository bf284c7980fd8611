"""Language detection and batched serving of the port, against the JAX
package on the CPU, on shared weights.

- ``detect_language`` (model and ASR engine) and ``transcribe`` without a
  language: the detected code and the transcript exact;
- ``transcribe_batch``, ``translate_batch`` and ``synthesize_batch`` against
  the JAX engines' batched paths: tokens exact, audio within 1e-4 (the TTS
  takes the JAX key schedule's noise, one key a dispatch);
- the micro-batchers of ``serve/batching.py``, which need no engine, and the
  cascade over all three Batched* facades with fake engines.
"""

import sys
import threading
import time

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from expressive_speech_translation_tpu.models import cosyvoice as jcv
from expressive_speech_translation_tpu.models import nllb as jnl
from expressive_speech_translation_tpu.models import qwen2 as jq2
from expressive_speech_translation_tpu.models import whisper as jwh
from expressive_speech_translation_tpu.pipeline.cascaded import CascadedBackend as JaxBackend
from expressive_speech_translation_tpu.pipeline.engines import Engines as JaxEngines
from expressive_speech_translation_tpu.pipeline.jax_engines import (
    JaxCosyVoiceTts, JaxNllbNmt, JaxWhisperAsr)
from expressive_speech_translation_tpu_torch.core.buckets import bucket_batch, row_slices
from expressive_speech_translation_tpu_torch.models import cosyvoice as tcv
from expressive_speech_translation_tpu_torch.models import ecapa as tec
from expressive_speech_translation_tpu_torch.models import nllb as tnl
from expressive_speech_translation_tpu_torch.models import qwen2 as tq2
from expressive_speech_translation_tpu_torch.models import speech_tokenizer as tst
from expressive_speech_translation_tpu_torch.models import whisper as twh
from expressive_speech_translation_tpu_torch.pipeline import languages
from expressive_speech_translation_tpu_torch.pipeline import torch_engines as te
from expressive_speech_translation_tpu_torch.pipeline.cascaded import CascadedBackend
from expressive_speech_translation_tpu_torch.pipeline.engines import Engines
from expressive_speech_translation_tpu_torch.pipeline.languages import nllb_placeholder_lang_ids
from expressive_speech_translation_tpu_torch.pipeline.torch_engines import (
    TorchCosyVoiceTts, TorchNllbNmt, TorchWhisperAsr)
from expressive_speech_translation_tpu_torch.serve.batching import (BatchedAsr, BatchedNmt,
                                                                    BatchedTts, MicroBatcher)

AUDIO_ATOL = 1e-4
PROB_ATOL = 1e-5


def _fields(cfg):
    return {f: getattr(cfg, f) for f in cfg.__dataclass_fields__}


def _np(tree):
    return jax.tree.map(np.asarray, tree)


def _t(a):
    return torch.from_numpy(np.array(a))


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
ASR_BUCKETS = (10, 30)
ASR_STEPS = 8
# gates every greedy row passes, so the ladder's sampled rungs never run
GREEDY_GATES = dict(temperatures=(0.0, 0.4), compression_ratio_threshold=1e9,
                    logprob_threshold=-1e9)


def _speechlike(seconds, seed, sr=16_000):
    g = np.random.default_rng(seed)
    t = np.arange(int(sr * seconds)) / sr
    x = 0.4 * np.sin(2 * np.pi * (180 + 20 * seed) * t) + 0.02 * g.standard_normal(t.shape)
    return (x * (0.5 + 0.5 * np.sin(2 * np.pi * 3.0 * t) ** 2)).astype(np.float32)


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


@pytest.fixture(scope="module")
def asr_pair():
    jasr = JaxWhisperAsr(WCFG, None, dtype=jnp.float32, max_new_tokens=ASR_STEPS,
                         context_buckets=ASR_BUCKETS, **GREEDY_GATES)
    asr = TorchWhisperAsr(twh.WhisperConfig(**_fields(WCFG)),
                          twh.from_jax_params(_np(jasr.params), "cpu"), device="cpu",
                          dtype=torch.float32, max_new_tokens=ASR_STEPS,
                          context_buckets=ASR_BUCKETS, **GREEDY_GATES)
    return jasr, asr


# ---------------------------------------------------------------- detection


@pytest.mark.parametrize("vocab_size, lang_start", [(365, 262), (300, 262), (365, 400)],
                         ids=["whole-block", "block-cut-by-vocab", "block-past-vocab"])
def test_detect_language_matches_jax(vocab_size, lang_start):
    """ids exact, probabilities within 1e-5, over a language block the
    vocabulary holds, one it cuts short, and one it lacks (the clamp)."""
    cfg = jwh.WhisperConfig(**{**_fields(WCFG), "vocab_size": vocab_size,
                               "lang_token_start": lang_start})
    params = jwh.init_whisper(jax.random.PRNGKey(3), cfg)
    mel = np.random.default_rng(4).standard_normal((3, cfg.n_mels, 200)).astype(np.float32)
    want_ids, want_p = jwh.detect_language(params, cfg, jnp.asarray(mel))
    got_ids, got_p = twh.detect_language(twh.from_jax_params(_np(params), "cpu"),
                                         twh.WhisperConfig(**_fields(cfg)), torch.from_numpy(mel))
    np.testing.assert_array_equal(got_ids.numpy(), np.asarray(want_ids))
    assert got_p.dtype == torch.float32 and got_p.shape == want_p.shape
    np.testing.assert_allclose(got_p.numpy(), np.asarray(want_p), atol=PROB_ATOL, rtol=0)


def test_language_token_tables_match_jax():
    from expressive_speech_translation_tpu.pipeline import languages as jl

    assert languages.WHISPER_LANG_TOKENS == jl.WHISPER_LANG_TOKENS
    for code in ("eng", "fra", "ukr", "uk", "haw", "ja"):
        assert languages.whisper_lang_token(code) == jl.whisper_lang_token(code)
    for tok in (50259, 50260, 50280, 50357, 50358, 1):
        assert languages.whisper_token_to_app(tok) == jl.whisper_token_to_app(tok)


@pytest.mark.parametrize("seconds", [3.0, 31.0])
def test_engine_detects_the_language_like_jax(asr_pair, seconds):
    """``detect_language`` and ``transcribe(audio)`` with no language: the
    detected code and the transcript exact (over 30 s, detection reads the
    first 30 s and the second window is prompted with it)."""
    jasr, asr = asr_pair
    x = _speechlike(seconds, seed=int(seconds))
    assert asr.detect_language(x) == jasr.detect_language(x)
    want, got = jasr.transcribe(x), asr.transcribe(x)
    assert got["language"] == want["language"] == asr.detect_language(x)
    assert got["text"] == want["text"]
    assert [w["word"] for w in got["words"]] == [w["word"] for w in want["words"]]


# ------------------------------------------------------------ batched paths


def test_transcribe_batch_matches_jax(asr_pair):
    """Mixed lengths (one over 30 s: two rows) and mixed given and missing
    languages in one dispatch padded to 4 rows and the 30 s bucket; then
    short requests alone, padded to the 10 s bucket."""
    jasr, asr = asr_pair
    batches = [
        [{"audio_16k": _speechlike(3.0, 1), "language": None},
         {"audio_16k": _speechlike(31.0, 2), "language": "fra"},
         {"audio_16k": _speechlike(7.0, 3), "language": None}],
        [{"audio_16k": _speechlike(2.0, 4), "language": "deu"},
         {"audio_16k": _speechlike(6.0, 5), "language": None}],
    ]
    for requests in batches:
        want = jasr.transcribe_batch(requests)
        got = asr.transcribe_batch(requests)
        assert [g["language"] for g in got] == [w["language"] for w in want]
        assert [g["text"] for g in got] == [w["text"] for w in want]
        assert any(g["text"] for g in got)
        for g, w in zip(got, want):
            assert [x["word"] for x in g["words"]] == [x["word"] for x in w["words"]]
    assert got[0]["language"] == "deu"


def test_transcribe_batch_reruns_a_failing_row_from_the_second_rung():
    """Random weights fail the avg-logprob gate: each batch row is re-run
    alone through the single path's ladder from ``temperatures[1:]``, with
    its own bare prompt; with a single rung nothing re-runs."""
    asr = TorchWhisperAsr(twh.WhisperConfig(**_fields(WCFG)), device="cpu", dtype=torch.float32,
                          max_new_tokens=ASR_STEPS, context_buckets=(2,),
                          temperatures=(0.0, 0.4, 0.8))
    calls = []
    decode = asr._decode

    def spy(padded, row, temperature):
        calls.append((len(padded), tuple(row), temperature))
        return decode(padded, row, temperature)

    asr._decode = spy
    out = asr.transcribe_batch([{"audio_16k": _speechlike(1.0, 6), "language": "eng"},
                                {"audio_16k": _speechlike(3.0, 7), "language": "fra"}])
    eng, fra = asr._prompt_row("eng"), asr._prompt_row("fra")
    assert [(n, t) for n, _, t in calls] == [(32_000, 0.4), (32_000, 0.8)] * 3
    assert [r for _, r, _ in calls] == [tuple(eng)] * 2 + [tuple(fra)] * 4
    assert [o["language"] for o in out] == ["eng", "fra"]
    calls.clear()
    asr.temperatures = (0.0,)
    asr.transcribe_batch([{"audio_16k": _speechlike(1.0, 6), "language": "eng"}])
    assert calls == []


def test_translate_batch_matches_jax_and_single_requests():
    """18 requests to two targets: two dispatch windows (16 + 2 rows), each
    grouped by target; each result equals JAX's and the port's own
    single-request translation (the padded rows change no live row)."""
    params = JaxNllbNmt(NCFG, None, dtype=jnp.float32).params
    lang_ids = nllb_placeholder_lang_ids(NCFG.vocab_size)
    jnmt = JaxNllbNmt(NCFG, params, dtype=jnp.float32, max_new_tokens=10,
                      lang_code_to_id=lang_ids)
    nmt = TorchNllbNmt(tnl.NLLBConfig(**_fields(NCFG)), tnl.from_jax_params(_np(params), "cpu"),
                       device="cpu", lang_code_to_id=lang_ids, dtype=torch.float32,
                       max_new_tokens=10)
    words = ["hello", "good morning to you all", "a", "the weather is fine today, friend",
             "yes", "where is the station"]
    requests = [{"text": words[i % len(words)] + "!" * (i // len(words)), "source_lang": "eng",
                 "target_lang": ("fra", "deu")[i % 2]} for i in range(18)]
    want = jnmt.translate_batch(requests)
    got = nmt.translate_batch(requests)
    assert got == want and all(got)
    assert got == [nmt.translate(r["text"], r["source_lang"], r["target_lang"]) for r in requests]
    assert nmt.translate_batch([]) == []


@pytest.fixture(scope="module")
def tts_pair():
    jtts = JaxCosyVoiceTts(CCFG, None, dtype=jnp.float32)
    tts = TorchCosyVoiceTts(
        TCCFG, tcv.from_jax_params(_np(jtts.params), "cpu"), device="cpu", dtype=torch.float32,
        noise=JaxCallNoise,
        ecapa_weights=(tec.from_jax_params(_np(jtts._ecapa), "cpu"),
                       tec.EcapaConfig(**_fields(jtts._ecapa_cfg))),
        speech_tokenizer_weights=(tst.from_jax_params(_np(jtts._st), "cpu"),
                                  tst.SpeechTokenizerConfig(**_fields(jtts._st_cfg))))
    tts.weightless = True   # the JAX engine drew its own weights: ids wrap as there
    return jtts, tts


def test_synthesize_batch_matches_jax(tts_pair, monkeypatch):
    """Mixed conditioning in one dispatch of 4 rows (3 live): a cloning
    reference with its transcript, no reference, and a reference of 0.1 s,
    which engages no cloning. Speech tokens exact, each row trimmed at its
    EOS, audio within 1e-4."""
    jtts, tts = tts_pair
    jax_tokens, port_tokens = [], []
    synth = jcv.synthesize

    def jax_spy(*args, **kwargs):
        out = synth(*args, **kwargs)
        jax.debug.callback(lambda t: jax_tokens.append(np.asarray(t)), out["speech_tokens"])
        return out

    monkeypatch.setattr(jcv, "synthesize", jax_spy)
    port_synth = te.cvm.synthesize

    def port_spy(*args, **kwargs):
        out = port_synth(*args, **kwargs)
        port_tokens.append(out["speech_tokens"].numpy())
        return out

    monkeypatch.setattr(te.cvm, "synthesize", port_spy)
    requests = [
        {"text": "bonjour a tous", "style_prompt": "hello all",
         "reference_audio_16k": _speechlike(3.2, 12), "language": "fr"},
        {"text": "merci beaucoup mes amis", "style_prompt": "thanks",
         "reference_audio_16k": None, "language": "fr"},
        {"text": "oui", "style_prompt": "yes",
         "reference_audio_16k": _speechlike(0.1, 13), "language": "fr"},
    ]
    want = jtts.synthesize_batch(requests)
    got = tts.synthesize_batch(requests)
    assert tts._call_count == jtts._call_count == 1
    assert len(jax_tokens) == len(port_tokens) == 1
    assert port_tokens[0].shape[0] == bucket_batch(len(requests)) == 4
    np.testing.assert_array_equal(port_tokens[0], jax_tokens[0])
    assert [g.shape for g in got] == [w.shape for w in want]
    for g, w in zip(got, want):
        assert g.size > 0 and np.isfinite(g).all()
        np.testing.assert_allclose(g, w, atol=AUDIO_ATOL, rtol=0)


def test_batched_conditioning_matches_jax_and_the_single_path(tts_pair):
    """``_cond_b``: the reference row equals the single path's conditioning;
    rows without one are zero, with ``_noref_tokens`` live token slots."""
    jtts, tts = tts_pair
    refs = np.zeros((2, 160_000), np.float32)
    refs[0] = np.resize(_speechlike(3.2, 12), 160_000)
    has_ref = np.array([1.0, 0.0], np.float32)
    want = jtts._cond_b_fn(jtts._ecapa, jtts._st, refs, has_ref)
    got = tts._cond_b(refs, has_ref)
    np.testing.assert_allclose(got[0].numpy(), np.asarray(want[0]), atol=1e-5, rtol=0)
    np.testing.assert_allclose(got[1].numpy(), np.asarray(want[1]), atol=1e-3, rtol=0)
    for g, w in zip(got[2:], want[2:]):
        np.testing.assert_array_equal(g.numpy(), np.asarray(w))
    assert got[3][1].tolist() == [True] * tts._noref_tokens + [False] * 48
    spk, pmel, psp = tts._cond(refs[0])       # the same pass over one row
    np.testing.assert_allclose(got[0][:1].numpy(), spk.numpy(), atol=1e-6, rtol=0)
    np.testing.assert_allclose(got[1][:1].numpy(), pmel.numpy(), atol=1e-5, rtol=0)
    np.testing.assert_array_equal(got[2][:1].numpy(), psp.numpy())
    assert not got[0][1].any() and not got[1][1].any() and not got[2][1].any()


# ------------------------------------------------------------ micro-batchers


def test_bucket_ladder_and_row_slices():
    assert [bucket_batch(n) for n in (1, 2, 3, 5, 8, 9, 17, 40, 99)] == \
        [1, 2, 4, 8, 8, 16, 32, 64, 128]
    assert bucket_batch(40, (1, 2, 4, 8, 16, 32)) == 64
    assert list(row_slices(35, 16)) == [(0, 16), (16, 32), (32, 35)]


def test_microbatcher_coalesces_and_preserves_mapping():
    calls = []

    def run(items):
        calls.append(len(items))
        time.sleep(0.05)  # a queue builds up behind the first batch
        return [x * 10 for x in items]

    mb = MicroBatcher(run, max_batch=8, max_wait_ms=30)
    futs = [mb.submit(i) for i in range(16)]
    results = [f.result(timeout=10) for f in futs]
    mb.shutdown()
    assert results == [i * 10 for i in range(16)]
    assert sum(calls) == 16 and len(calls) < 16 and max(calls) <= 8
    assert mb.n_items == 16 and mb.n_batches == len(calls)


def test_microbatcher_error_fans_out_and_recovers():
    def run(items):
        if any(x < 0 for x in items):
            raise ValueError("bad item")
        return items

    mb = MicroBatcher(run, max_batch=4, max_wait_ms=5)
    with pytest.raises(ValueError):
        mb.submit(-1).result(timeout=10)
    assert mb.submit(7).result(timeout=10) == 7
    mb.shutdown()
    with pytest.raises(RuntimeError, match="shut down"):
        mb.submit(1)
    with pytest.raises(ValueError):
        MicroBatcher(run, max_batch=0)


def test_microbatcher_concurrent_callers():
    mb = MicroBatcher(lambda xs: [x + 1 for x in xs], max_batch=8, max_wait_ms=10)
    out = {}

    def call(i):
        out[i] = mb(i)

    threads = [threading.Thread(target=call, args=(i,)) for i in range(12)]
    for t in threads:
        t.start()
    for t in threads:
        t.join(timeout=30)
    mb.shutdown()
    assert not any(t.is_alive() for t in threads)
    assert out == {i: i + 1 for i in range(12)}


def test_microbatcher_under_thread_switch_stress():
    """48 callers (more than the cores) with the interpreter switching
    threads every microsecond: every caller gets its own result, no item is
    lost or served twice, and shutdown leaves no collector running."""
    seen = []
    mb = MicroBatcher(lambda xs: seen.extend(xs) or [x * 3 for x in xs], max_batch=8,
                      max_wait_ms=1)
    out = {}
    interval = sys.getswitchinterval()
    sys.setswitchinterval(1e-6)
    try:
        threads = [threading.Thread(target=lambda i=i: out.__setitem__(i, mb(i)))
                   for i in range(48)]
        for t in threads:
            t.start()
        for t in threads:
            t.join(timeout=60)
    finally:
        sys.setswitchinterval(interval)
    mb.shutdown()
    assert not any(t.is_alive() for t in threads) and not mb._thread.is_alive()
    assert out == {i: 3 * i for i in range(48)}
    assert sorted(seen) == list(range(48)) and mb.n_items == 48


class _FakeAsr:
    def __init__(self, weightless):
        self.weightless = weightless

    def transcribe_batch(self, requests):
        out = []
        for r in requests:
            dur = len(np.asarray(r["audio_16k"]).reshape(-1)) / 16_000.0
            out.append({"text": "hello world", "language": r["language"] or "eng",
                        "words": [{"word": "hello", "start": 0.0, "end": dur / 2},
                                  {"word": "world", "start": dur / 2, "end": dur}]})
        return out


class _FakeNmt:
    def __init__(self, weightless, empty=False):
        self.weightless = weightless
        self.empty = empty

    def translate_batch(self, requests):
        return ["" if self.empty else f"[{r['target_lang']}] {r['text']}" for r in requests]


class _FakeTts:
    sample_rate = 24_000

    def __init__(self, weightless):
        self.weightless = weightless
        self.batch_sizes = []

    def synthesize_batch(self, requests):
        self.batch_sizes.append(len(requests))
        return [np.zeros(12_000, np.float32) + 0.1 for _ in requests]


def _batched_cascade(*, weightless, empty_nmt=False):
    return CascadedBackend(Engines(asr=BatchedAsr(_FakeAsr(weightless)),
                                   nmt=BatchedNmt(_FakeNmt(weightless, empty=empty_nmt)),
                                   tts=BatchedTts(_FakeTts(weightless))))


@pytest.mark.parametrize("weightless", [True, False])
def test_cascade_with_all_batched_wrappers_concurrent(weightless):
    """8 concurrent requests through the fully batched cascade succeed with
    and without weights, and the stages batch them."""
    backend = _batched_cascade(weightless=weightless)
    audio = np.sin(np.arange(16_000) * 0.05).astype(np.float32) * 0.3
    results, errors = [None] * 8, []
    start = threading.Barrier(8)

    def worker(i):
        try:
            start.wait(timeout=30)
            results[i] = backend.translate_speech(audio, "eng", "fra")
        except Exception as e:  # noqa: BLE001 — collected and asserted below
            errors.append(e)

    threads = [threading.Thread(target=worker, args=(i,)) for i in range(8)]
    for t in threads:
        t.start()
    for t in threads:
        t.join(timeout=60)
    assert not any(t.is_alive() for t in threads)
    assert not errors, f"concurrent batched cascade failed: {errors[:1]}"
    assert all(r["transcripts"]["target"].startswith("[fra") for r in results)
    tts = backend.engines.tts
    assert tts.stats["items"] == 8 and max(tts.engine.batch_sizes) > 1
    assert tts.weightless is weightless and backend.engines.nmt.weightless is weightless
    for stage in (backend.engines.asr, backend.engines.nmt, tts):
        stage.shutdown()


def test_cascade_batched_empty_translation_gate():
    """The empty-translation failure sees through the facades: with weights
    an empty translation raises, weightless it carries on."""
    audio = np.zeros(16_000, np.float32)
    with pytest.raises(RuntimeError, match="Translation result was empty"):
        _batched_cascade(weightless=False, empty_nmt=True).translate_speech(audio, "eng", "fra")
    assert "audio" in _batched_cascade(weightless=True, empty_nmt=True).translate_speech(
        audio, "eng", "fra")
    with pytest.raises(TypeError, match="transcribe_batch"):
        BatchedAsr(object())
    assert not hasattr(BatchedTts(_FakeTts(True)), "synthesize_streaming")


class _RecordingAsr:
    def __init__(self):
        self.languages = []

    def transcribe(self, audio, language=None):
        self.languages.append(language)
        return {"text": "", "language": language or "eng", "words": []}


class _Sink:
    sample_rate = 24_000
    weightless = True

    def translate(self, text, source_lang, target_lang):
        return text

    def synthesize(self, text, **kwargs):
        return np.zeros(2_400, np.float32)


def test_initialize_warms_language_detection_like_jax():
    """Both cascades warm ASR with silence and no language, so the
    detection path warms too."""
    port, ref = _RecordingAsr(), _RecordingAsr()
    CascadedBackend(Engines(asr=port, nmt=_Sink(), tts=_Sink())).initialize()
    JaxBackend(JaxEngines(asr=ref, nmt=_Sink(), tts=_Sink())).initialize()
    assert port.languages == ref.languages == [None]
