"""The port's streaming path against the JAX package's on the CPU.

Both sides take the same seeded weights (``from_jax_params``), and the port
takes the JAX stream's own key schedule as its noise: ``split(key,
2 n_chunks)`` gives chunk ci the keys [ci, 0] (its LM) and [ci, 1] (its
flow); inside a chunk the LM key is split in a chain, ``key, sk =
split(key)`` a step, and RAS splits ``sk`` in two. Speech tokens and
transcripts must be exact, f32 audio within 1e-4 (the vocoder output differs
only by f32 summation order; the host bookkeeping is the same numpy).
"""

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
from expressive_speech_translation_tpu.pipeline.engines import FakeAsr, FakeNmt, FakeTts
from expressive_speech_translation_tpu.pipeline.jax_engines import (
    JaxCosyVoiceTts, JaxNllbNmt, JaxWhisperAsr)
from expressive_speech_translation_tpu_torch.models import cosyvoice as tcv
from expressive_speech_translation_tpu_torch.models import ecapa as tec
from expressive_speech_translation_tpu_torch.models import nllb as tnl
from expressive_speech_translation_tpu_torch.models import qwen2 as tq2
from expressive_speech_translation_tpu_torch.models import speech_tokenizer as tst
from expressive_speech_translation_tpu_torch.models import whisper as twh
from expressive_speech_translation_tpu_torch.models.common import cast_floats
from expressive_speech_translation_tpu_torch.pipeline.cascaded import CascadedBackend
from expressive_speech_translation_tpu_torch.pipeline.engines import Engines
from expressive_speech_translation_tpu_torch.pipeline.languages import nllb_placeholder_lang_ids
from expressive_speech_translation_tpu_torch.pipeline.torch_engines import (
    TorchCosyVoiceTts, TorchNllbNmt, TorchWhisperAsr)
from expressive_speech_translation_tpu_torch.serve.batching import BatchedAsr, BatchedNmt, BatchedTts

AUDIO_ATOL = 1e-4


def _fields(cfg):
    return {f: getattr(cfg, f) for f in cfg.__dataclass_fields__}


def _np(tree):
    return jax.tree.map(np.array, tree)


def _t(a):
    return torch.from_numpy(np.array(a))


QCFG = jq2.Qwen2Config(hidden=64, layers=2, heads=4, kv_heads=2, ffn_dim=128, max_positions=1024)
CCFG = jcv.CosyVoiceConfig(
    lm=jcv.SpeechLMConfig(backbone=QCFG, text_vocab=384, speech_token_size=64),
    flow=jcv.FlowConfig(token_vocab=67, dim=64, layers=2, heads=4, n_steps=4),
    vocoder=jcv.VocoderConfig(base_channels=64))
TCCFG = tcv.CosyVoiceConfig(
    lm=tcv.SpeechLMConfig(backbone=tq2.Qwen2Config(**_fields(QCFG)),
                          **{f: v for f, v in _fields(CCFG.lm).items()
                             if f in tcv.SpeechLMConfig.__dataclass_fields__ and f != "backbone"}),
    flow=tcv.FlowConfig(**_fields(CCFG.flow)),
    vocoder=tcv.VocoderConfig(**_fields(CCFG.vocoder)))
STREAM = dict(chunk_tokens=8, flow_context=6, vocoder_context=4, fade_samples=256)


class _JaxChunkNoise:
    """One stream chunk's noise under the JAX schedule: the LM key split in
    a chain a step, each step's subkey split in two for RAS; the flow key
    drawn as is."""

    def __init__(self, k_lm, k_flow):
        self.key, self.k_flow, self.subkeys = k_lm, k_flow, []

    def ras_gumbel(self, step, shape):
        while len(self.subkeys) <= step:
            self.key, sk = jax.random.split(self.key)
            self.subkeys.append(sk)
        k1, k2 = jax.random.split(self.subkeys[step])
        return (_t(jax.random.gumbel(k1, shape, jnp.float32)),
                _t(jax.random.gumbel(k2, shape, jnp.float32)))

    def flow_x0(self, shape):
        return _t(jax.random.normal(self.k_flow, shape, jnp.float32))


class JaxStreamNoise:
    """The JAX key schedule of one stream of key ``key``."""

    def __init__(self, key):
        self.key = key

    def chunk(self, index, count):
        ks = np.asarray(jax.random.split(self.key, 2 * count)).reshape(count, 2, 2)
        return _JaxChunkNoise(ks[index, 0], ks[index, 1])


class JaxCallNoise(JaxStreamNoise):
    """The JAX TTS engine's noise for call ``n``: ``fold_in(PRNGKey(42), n)``,
    split into (LM, flow) offline and taken whole by a stream."""

    def __init__(self, n):
        super().__init__(jax.random.fold_in(jax.random.PRNGKey(42), jnp.uint32(n)))
        self.k_lm, self.k_flow = jax.random.split(self.key)

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


# ------------------------------------------------------------------- models


@pytest.fixture(scope="module")
def tts_weights():
    """{"plain": params, "eos": params whose head favours EOS} (numpy)."""
    plain = _np(jcv.init_cosyvoice(jax.random.PRNGKey(3), CCFG))
    eos = jax.tree.map(np.array, plain)
    eos["lm"]["head"]["bias"][CCFG.lm.eos_speech] += 12.0
    return {"plain": plain, "eos": eos}


def _prompt(b=1):
    """Text [b, 6], prompt speech tokens [b, 5] (the last masked out), the
    speaker embedding and a 10-frame prompt mel (its first 3 frames masked)."""
    g = np.random.default_rng(17)
    text = g.integers(0, 384, (b, 6)).astype(np.int32)
    tmask = np.ones((b, 6), bool)
    sp = g.integers(0, 64, (b, 5)).astype(np.int32)
    smask = np.ones((b, 5), bool)
    smask[:, -1] = False
    spk = (0.1 * g.standard_normal((b, 192))).astype(np.float32)
    pm = g.standard_normal((b, 10, 80)).astype(np.float32)
    pmm = np.ones((b, 10), bool)
    pmm[:, :3] = False
    return text, tmask, sp, smask, spk, pm, pmm


@pytest.mark.parametrize("weights_name", ["plain", "eos"])
def test_lm_stream_chunks_match_jax(tts_weights, weights_name):
    """Prefill, then three chunks of 8 tokens carried through the state: the
    tokens exact, and with the EOS-favouring head every row reaches EOS
    inside chunk 1 (``min_new_tokens`` 10) and keeps emitting it."""
    params = tts_weights[weights_name]
    text, tmask, sp, smask, *_ = _prompt(b=2)
    jlm = jax.tree.map(jnp.asarray, params["lm"])
    tlm = tcv.from_jax_params(params, "cpu")["lm"]
    p_len = 2 + text.shape[1] + sp.shape[1]
    jstate = jcv._lm_stream_start_j(jlm, CCFG.lm, jnp.asarray(text), jnp.asarray(tmask),
                                    jnp.asarray(sp), jnp.asarray(smask), max_new_tokens=24)
    state = tcv.lm_stream_start(tlm, TCCFG.lm, _t(text), _t(tmask), _t(sp), _t(smask),
                                max_new_tokens=24)
    noise = JaxStreamNoise(jax.random.PRNGKey(9))
    got, want = [], []
    for ci in range(3):
        jt, jstate = jcv._lm_stream_chunk_j(jlm, CCFG.lm, noise.chunk(ci, 3).key, jstate,
                                            chunk_tokens=8, min_new_tokens=10, p_len=p_len)
        t, state = tcv.lm_stream_chunk(tlm, TCCFG.lm, noise.chunk(ci, 3), state, chunk_tokens=8,
                                       min_new_tokens=10, p_len=p_len)
        want.append(np.asarray(jt))
        got.append(t.numpy())
    got, want = np.concatenate(got, 1), np.concatenate(want, 1)
    np.testing.assert_array_equal(got, want)
    assert state["step"] == int(jstate["step"]) == 24
    np.testing.assert_array_equal(state["done"].numpy(), np.asarray(jstate["done"]))
    np.testing.assert_allclose(state["h"].numpy(), np.asarray(jstate["h"]), atol=1e-4, rtol=0)
    eos = CCFG.lm.eos_speech
    if weights_name == "eos":
        assert (got[:, :10] != eos).all() and (got[:, 10:] == eos).all()
    else:
        assert (got != eos).all()


def _flow_inputs():
    g = np.random.default_rng(23)
    tokens = np.full((1, 8), CCFG.lm.eos_speech, np.int32)
    tokens[0, :5] = g.integers(0, 64, 5)
    ctx_mel = g.standard_normal((1, 6, 80)).astype(np.float32)
    ctx_mask = np.array([[False, False, True, True, True, True]])
    ctx_tok = np.array([[0, 7, 41]], np.int32)
    ctx_tok_mask = np.array([[False, True, True]])
    voc_hist = (0.5 * g.standard_normal((1, 4, 80))).astype(np.float32)
    spk = (0.1 * g.standard_normal((1, 192))).astype(np.float32)
    return tokens, 5, spk, ctx_mel, ctx_mask, ctx_tok, ctx_tok_mask, voc_hist


def test_flow_vocode_chunk_matches_jax(tts_weights):
    """Five valid tokens of eight, a part-masked context: the chunk's mel
    (frames past 2·5 zeroed) and the waveform of history + chunk."""
    params = tts_weights["plain"]
    args = _flow_inputs()
    key = jax.random.PRNGKey(31)
    jfv = {k: jax.tree.map(jnp.asarray, params[k]) for k in ("flow", "vocoder")}
    jgen, jwav = jcv._flow_vocode_chunk_j(jfv, CCFG.flow, CCFG.vocoder, key,
                                          *(jnp.asarray(a) for a in args))
    tp = tcv.from_jax_params(params, "cpu")
    gen, wav = tcv.flow_vocode_chunk({"flow": tp["flow"], "vocoder": tp["vocoder"]}, TCCFG.flow,
                                     TCCFG.vocoder, _JaxChunkNoise(None, key), _t(args[0]), args[1],
                                     *(_t(a) for a in args[2:]))
    assert tuple(gen.shape) == (1, 16, 80) and tuple(wav.shape) == (1, 20 * 480)
    assert (gen[0, 10:] == 0).all()
    np.testing.assert_allclose(gen.numpy(), np.asarray(jgen), atol=1e-4, rtol=0)
    np.testing.assert_allclose(wav.numpy(), np.asarray(jwav), atol=AUDIO_ATOL, rtol=0)


def test_flow_vocode_chunk_runs_a_bf16_flow_in_bf16(tts_weights, monkeypatch):
    """The context buffers arrive f32 from the host: with bf16 weights the
    flow still runs in bf16 (the entry cast), and so does its output."""
    tp = cast_floats(tcv.from_jax_params(tts_weights["plain"], "cpu"), torch.bfloat16)
    seen = []
    estimator = tcv.flow_estimator

    def spy(params, cfg, x_t, t, token_cond, spk, mel_cond, mask):
        seen.append((x_t.dtype, token_cond.dtype, spk.dtype, mel_cond.dtype))
        return estimator(params, cfg, x_t, t, token_cond, spk, mel_cond, mask)

    monkeypatch.setattr(tcv, "flow_estimator", spy)
    args = _flow_inputs()
    assert all(a.dtype != np.float64 for a in args[2:])
    gen, wav = tcv.flow_vocode_chunk({"flow": tp["flow"], "vocoder": tp["vocoder"]}, TCCFG.flow,
                                     TCCFG.vocoder, _JaxChunkNoise(None, jax.random.PRNGKey(1)),
                                     _t(args[0]), args[1], *(_t(a) for a in args[2:]))
    assert seen and all(d == torch.bfloat16 for row in seen for d in row)
    assert gen.dtype == torch.bfloat16 and torch.isfinite(wav.float()).all()


def _stream_both(params, *, max_new_tokens, min_new_tokens, stream=STREAM, b=1):
    text, tmask, sp, smask, spk, pm, pmm = _prompt(b=b)
    jcfg = jcv.StreamConfig(**stream)
    want = list(jcv.synthesize_streaming(
        jax.tree.map(jnp.asarray, params), CCFG, jax.random.PRNGKey(5), jnp.asarray(text),
        jnp.asarray(tmask), jnp.asarray(sp), jnp.asarray(smask), jnp.asarray(spk),
        jnp.asarray(pm), jnp.asarray(pmm), stream=jcfg, max_new_tokens=max_new_tokens,
        min_new_tokens=min_new_tokens))
    got = list(tcv.synthesize_streaming(
        tcv.from_jax_params(params, "cpu"), TCCFG, JaxStreamNoise(jax.random.PRNGKey(5)), _t(text),
        _t(tmask), _t(sp), _t(smask), _t(spk), _t(pm), _t(pmm),
        stream=tcv.StreamConfig(**stream), max_new_tokens=max_new_tokens,
        min_new_tokens=min_new_tokens))
    return got, want


@pytest.mark.parametrize("weights_name,max_new_tokens,min_new_tokens,n_tokens", [
    ("plain", 20, 64, 20),    # no EOS: chunks of 8, 8 and a short last chunk of 4
    ("eos", 40, 11, 11),      # EOS at token 11, inside the second chunk
])
def test_synthesize_streaming_matches_jax(tts_weights, weights_name, max_new_tokens,
                                          min_new_tokens, n_tokens):
    got, want = _stream_both(tts_weights[weights_name], max_new_tokens=max_new_tokens,
                             min_new_tokens=min_new_tokens)
    assert len(got) == len(want) >= 2
    assert [len(c) for c in got] == [len(c) for c in want]
    assert all(c.dtype == np.float32 for c in got)
    for g, w in zip(got, want):
        np.testing.assert_allclose(g, w, atol=AUDIO_ATOL, rtol=0)
    # the budget (or EOS) is honoured exactly: one token is r * hop samples
    assert sum(len(c) for c in got) == n_tokens * CCFG.flow.token_mel_ratio * CCFG.vocoder.hop


def test_synthesize_streaming_is_single_token_on_an_mtp_tree(tts_weights):
    """A stream decodes one token a step whatever the tree carries: on the
    tree with two MTP heads (and ``mtp=3, spec_decode`` set) it equals the
    stream on the same tree without them."""
    params = tts_weights["eos"]
    g = np.random.default_rng(41)
    heads = [{"kernel": (0.1 * g.standard_normal((64, 67))).astype(np.float32),
              "bias": np.zeros(67, np.float32)} for _ in range(2)]
    with_heads = {**params, "lm": {**params["lm"], "mtp_heads": heads}}
    cfg3 = TCCFG.__class__(**{**_fields(TCCFG), "lm": TCCFG.lm.__class__(
        **{**_fields(TCCFG.lm), "mtp": 3, "spec_decode": True})})
    text, tmask, sp, smask, spk, pm, pmm = (_t(a) for a in _prompt())
    kw = dict(stream=tcv.StreamConfig(**STREAM), max_new_tokens=24, min_new_tokens=11)
    streams = [list(tcv.synthesize_streaming(tcv.from_jax_params(p, "cpu"), cfg,
                                             JaxStreamNoise(jax.random.PRNGKey(5)), text, tmask,
                                             sp, smask, spk, pm, pmm, **kw))
               for p, cfg in ((with_heads, cfg3), (params, TCCFG))]
    assert len(streams[0]) == len(streams[1]) >= 2
    for a, b in zip(*streams):
        np.testing.assert_array_equal(a, b)


def test_generator_noise_draws_are_a_function_of_their_index():
    """The default noise source: equal indices give equal draws whatever
    the order of the asks (the speculative decoder draws a position twice),
    other indices and other chunks other draws, and a chunk's steps count
    from 0 again."""
    noise = tcv.GeneratorNoise(7, "cpu")
    shape = (2, 5)
    first = noise.ras_gumbel(3, shape)
    noise.ras_gumbel(4, shape)
    noise.mtp_gumbel(0, 1, shape)
    again = tcv.GeneratorNoise(7, "cpu").ras_gumbel(3, shape)
    for a, b, c in zip(first, noise.ras_gumbel(3, shape), again):
        assert torch.equal(a, b) and torch.equal(a, c)
    assert not torch.equal(first[0], first[1])
    assert not torch.equal(first[0], noise.ras_gumbel(2, shape)[0])
    assert torch.equal(noise.mtp_gumbel(1, 2, shape)[0], noise.mtp_gumbel(1, 2, shape)[0])
    assert not torch.equal(noise.mtp_gumbel(1, 2, shape)[0], noise.mtp_gumbel(1, 1, shape)[0])
    assert torch.equal(noise.flow_x0((1, 4, 3)), noise.flow_x0((1, 4, 3)))
    chunks = [noise.chunk(ci, 3) for ci in range(3)]
    draws = [c.ras_gumbel(0, shape)[0] for c in chunks]
    assert torch.equal(draws[1], noise.chunk(1, 3).ras_gumbel(0, shape)[0])
    assert not any(torch.equal(draws[i], draws[j]) for i in range(3) for j in range(i))
    assert not any(torch.equal(d, first[0]) or torch.equal(d, noise.ras_gumbel(0, shape)[0])
                   for d in draws)
    assert not torch.equal(chunks[0].flow_x0((1, 4, 3)), chunks[1].flow_x0((1, 4, 3)))
    u = torch.cat([noise.ras_gumbel(i, (64,))[0] for i in range(64)])
    assert torch.isfinite(u).all() and abs(float(u.mean()) - 0.5772) < 0.1   # Gumbel's mean


def test_synthesize_streaming_rejects_a_batch_and_a_misaligned_flow_context(tts_weights):
    params = tcv.from_jax_params(tts_weights["plain"], "cpu")
    text, tmask, sp, smask, spk, pm, pmm = (_t(a) for a in _prompt(b=2))
    noise = JaxStreamNoise(jax.random.PRNGKey(0))
    with pytest.raises(ValueError, match="single-stream"):
        next(tcv.synthesize_streaming(params, TCCFG, noise, text, tmask, sp, smask, spk, pm, pmm))
    one = [a[:1] for a in (text, tmask, sp, smask, spk, pm, pmm)]
    bad = tcv.StreamConfig(chunk_tokens=8, flow_context=5, vocoder_context=4)
    with pytest.raises(ValueError, match="multiple of token_mel_ratio"):
        next(tcv.synthesize_streaming(params, TCCFG, noise, *one, stream=bad, max_new_tokens=8))
    with pytest.raises(ValueError, match="multiple of token_mel_ratio"):
        next(jcv.synthesize_streaming(
            jax.tree.map(jnp.asarray, tts_weights["plain"]), CCFG, jax.random.PRNGKey(0),
            *(jnp.asarray(a.numpy()) for a in one), stream=jcv.StreamConfig(flow_context=5),
            max_new_tokens=8))


# ------------------------------------------------------------------ engines

WCFG = jwh.WhisperConfig(
    d_model=64, encoder_layers=2, decoder_layers=2, heads=4, ffn_dim=128,
    vocab_size=365, max_target_positions=64, eos_token=260, bos_token=261,
    lang_token_start=262, task_translate=361, task_transcribe=362, no_timestamps=363,
    sop_token=364, no_speech_token=360)
NCFG = jnl.NLLBConfig(d_model=64, encoder_layers=2, decoder_layers=2, heads=4, ffn_dim=128,
                      vocab_size=384, max_positions=128)


@pytest.fixture(scope="module")
def engines():
    """(JAX engines, the port's engines) on the same weights; the port's TTS
    takes the JAX engine's key schedule. Each test calls each side's TTS the
    same number of times, so their call counters (the keys) agree."""
    lang_ids = nllb_placeholder_lang_ids(NCFG.vocab_size)
    jasr = JaxWhisperAsr(WCFG, None, dtype=jnp.float32, max_new_tokens=10, context_buckets=(2,))
    jnmt = JaxNllbNmt(NCFG, None, dtype=jnp.float32, max_new_tokens=8)
    jtts = JaxCosyVoiceTts(CCFG, None, dtype=jnp.float32)
    cpu = "cpu"
    asr = TorchWhisperAsr(twh.WhisperConfig(**_fields(WCFG)),
                          twh.from_jax_params(_np(jasr.params), cpu), device=cpu,
                          dtype=torch.float32, max_new_tokens=10, context_buckets=(2,),
                          temperatures=(0.0,))
    nmt = TorchNllbNmt(tnl.NLLBConfig(**_fields(NCFG)), tnl.from_jax_params(_np(jnmt.params), cpu),
                       device=cpu, lang_code_to_id=lang_ids, dtype=torch.float32, max_new_tokens=8)
    tts = TorchCosyVoiceTts(
        TCCFG, tcv.from_jax_params(_np(jtts.params), cpu), device=cpu, dtype=torch.float32,
        noise=JaxCallNoise,
        ecapa_weights=(tec.from_jax_params(_np(jtts._ecapa), cpu),
                       tec.EcapaConfig(**_fields(jtts._ecapa_cfg))),
        speech_tokenizer_weights=(tst.from_jax_params(_np(jtts._st), cpu),
                                  tst.SpeechTokenizerConfig(**_fields(jtts._st_cfg))))
    # the JAX engines drew their own weights: both run the random-weight policies
    nmt.weightless = tts.weightless = True
    return (JaxEngines(asr=jasr, nmt=jnmt, tts=jtts), Engines(asr=asr, nmt=nmt, tts=tts))


@pytest.mark.parametrize("language", ["eng", None])
def test_transcribe_streaming_matches_jax(engines, language):
    """4.5 s through 2 s windows: three windows, the later ones prompted with
    the earlier ones' tokens; without a language it is detected first.
    ``transcribe`` is the windows aggregated."""
    jax_engines, port = engines
    x = _speechlike(4.5, seed=41)
    want = list(jax_engines.asr.transcribe_streaming(x, language=language))
    got = list(port.asr.transcribe_streaming(x, language=language))
    assert got == want
    assert [(s["start"], s["end"]) for s in got] == [(0.0, 2.0), (2.0, 4.0), (4.0, 4.5)]
    assert any(s["text"] for s in got)
    out = port.asr.transcribe(x, language=language)
    assert out == jax_engines.asr.transcribe(x, language=language)
    assert out["text"] == " ".join(s["text"] for s in got if s["text"])
    assert out["words"] == [w for s in got for w in s["words"]]
    assert out["language"] == got[-1]["language"]


def test_engine_synthesize_streaming_with_cloning_matches_jax(engines):
    """The engine's stream at the default StreamConfig with a cloning
    reference (and the source text ahead of the TTS text), against the JAX
    engine's: the chunks' lengths exact, the samples within 1e-4."""
    jax_engines, port = engines
    ref = _speechlike(3.2, seed=43)
    kw = dict(style_prompt="hello all", reference_audio_16k=ref)
    want = list(jax_engines.tts.synthesize_streaming("bonjour a tous", **kw))
    got = list(port.tts.synthesize_streaming("bonjour a tous", **kw))
    assert port.tts._call_count == jax_engines.tts._call_count
    assert len(got) == len(want) >= 3
    assert [len(c) for c in got] == [len(c) for c in want]
    for g, w in zip(got, want):
        assert g.dtype == np.float32
        np.testing.assert_allclose(g, w, atol=AUDIO_ATOL, rtol=0)


def _events_match(got, want):
    assert [e["type"] for e in got] == [e["type"] for e in want]
    for g, w in zip(got, want):
        if g["type"] == "audio":
            assert g["sample_rate"] == w["sample_rate"] == 16_000
            assert g["chunk"].dtype == np.float32 and g["chunk"].shape == w["chunk"].shape
            np.testing.assert_allclose(g["chunk"], w["chunk"], atol=AUDIO_ATOL, rtol=0)
        else:
            assert g == w


@pytest.mark.parametrize("batched", [False, True])
def test_translate_speech_streaming_matches_jax_cascade(engines, batched):
    """3 s through 2 s ASR windows: a transcripts event a window (the text
    accumulated so far and the window), then that window's 16 kHz audio,
    cloning the source voice; the same behind the port's micro-batch
    facades, whose streaming methods reach the inner engines."""
    jax_engines, port = engines
    if batched:
        port = Engines(asr=BatchedAsr(port.asr), nmt=BatchedNmt(port.nmt), tts=BatchedTts(port.tts))
    try:
        x = _speechlike(3.0, seed=47)
        want = list(JaxBackend(jax_engines).translate_speech_streaming(x, "eng", "fra"))
        got = list(CascadedBackend(port).translate_speech_streaming(x, "eng", "fra"))
    finally:
        if batched:
            for stage in (port.asr, port.nmt, port.tts):
                stage.shutdown()
    _events_match(got, want)
    kinds = [e["type"] for e in got]
    assert kinds.count("transcripts") == 2 and kinds.index("audio") == 1
    assert [e["window"] for e in got if e["type"] == "transcripts"] == [[0.0, 2.0], [2.0, 3.0]]


# ---------------------------------------------------------------- fallbacks


class StreamingFakeAsr:
    """Two windows; records when each decodes. ``texts`` may be empty
    strings (silence)."""

    def __init__(self, texts=("hello one", "hello two"), weightless=None):
        self.texts, self.decoded = texts, []
        if weightless is not None:
            self.weightless = weightless

    def transcribe(self, audio_16k, language=None):
        segs = list(self.transcribe_streaming(audio_16k, language))
        return {"text": " ".join(s["text"] for s in segs), "language": language or "eng",
                "words": [w for s in segs for w in s["words"]]}

    def transcribe_batch(self, requests):
        return [self.transcribe(r["audio_16k"], r["language"]) for r in requests]

    def transcribe_streaming(self, audio_16k, language=None):
        for i, text in enumerate(self.texts):
            self.decoded.append(i)
            yield {"text": text, "words": [], "start": 2.0 * i, "end": 2.0 * (i + 1),
                   "language": language or "eng"}


class OfflineFakeTts:
    """FakeTts without its streaming method, and with a batch one."""

    sample_rate = FakeTts.sample_rate

    def synthesize(self, text, **kw):
        return FakeTts().synthesize(text, **kw)

    def synthesize_batch(self, requests):
        return [self.synthesize(r["text"]) for r in requests]


class BatchingFakeNmt(FakeNmt):
    def translate_batch(self, requests):
        return [self.translate(r["text"], r["source_lang"], r["target_lang"]) for r in requests]


class BatchingFakeAsr(FakeAsr):
    def transcribe_batch(self, requests):
        return [self.transcribe(r["audio_16k"], r["language"]) for r in requests]


def _both(make_engines, audio, facades=False):
    """(port events, JAX events) over fresh fake engines; with ``facades``
    the port's engines sit behind its micro-batch facades."""
    port = Engines(**make_engines())
    if facades:
        port = Engines(asr=BatchedAsr(port.asr), nmt=BatchedNmt(port.nmt), tts=BatchedTts(port.tts))
    try:
        got = list(CascadedBackend(port).translate_speech_streaming(audio, "eng", "fra"))
    finally:
        if facades:
            for stage in (port.asr, port.nmt, port.tts):
                stage.shutdown()
    want = list(JaxBackend(JaxEngines(**make_engines())).translate_speech_streaming(
        audio, "eng", "fra"))
    return got, want


AUDIO = (0.2 * np.sin(2 * np.pi * 220 * np.arange(32_000) / 16_000)).astype(np.float32)


@pytest.mark.parametrize("facades", [False, True])
def test_streaming_falls_back_without_streaming_engines(facades):
    """Neither engine streams: one transcripts event for the utterance, then
    one offline chunk at 16 kHz (the facades hide no fallback)."""
    got, want = _both(lambda: dict(asr=BatchingFakeAsr("hello streaming world"),
                                   nmt=BatchingFakeNmt(), tts=OfflineFakeTts()),
                      AUDIO, facades)
    _events_match(got, want)
    assert [e["type"] for e in got] == ["transcripts", "audio"]
    assert got[0]["source"] == "hello streaming world" and "[fra_Latn]" in got[0]["target"]
    assert "window" not in got[0]


def test_streaming_tts_after_utterance_level_asr():
    """An ASR that does not stream, a TTS that does (FakeTts, 1 s chunks):
    utterance-level ASR and NMT, then the TTS's chunks, each resampled to
    16 kHz."""
    got, want = _both(lambda: dict(asr=FakeAsr("hello streaming world"), nmt=FakeNmt(),
                                   tts=FakeTts()), AUDIO)
    _events_match(got, want)
    assert [e["type"] for e in got] == ["transcripts", "audio", "audio"]
    assert [len(e["chunk"]) for e in got[1:]] == [16_000, 14_720]   # 24,000 + 22,080 at 24 kHz


@pytest.mark.parametrize("facades", [False, True])
def test_streaming_asr_pipelines_windows(facades):
    """Window 1's audio comes before window 2 is decoded; transcripts
    accumulate, the last one complete."""
    made = []

    def make():
        made.append(StreamingFakeAsr())
        return dict(asr=made[-1], nmt=BatchingFakeNmt(), tts=OfflineFakeTts())

    port = Engines(**make())
    if facades:
        port = Engines(asr=BatchedAsr(port.asr), nmt=BatchedNmt(port.nmt), tts=BatchedTts(port.tts))
    order = []
    try:
        for ev in CascadedBackend(port).translate_speech_streaming(np.zeros(64_000, np.float32),
                                                                   "eng", "fra"):
            order.append((ev["type"], len(made[0].decoded)))
    finally:
        if facades:
            for stage in (port.asr, port.nmt, port.tts):
                stage.shutdown()
    assert order == [("transcripts", 1), ("audio", 1), ("transcripts", 2), ("audio", 2)]
    got, want = _both(make, np.zeros(64_000, np.float32))
    _events_match(got, want)
    transcripts = [e for e in got if e["type"] == "transcripts"]
    assert transcripts[0]["source"] == "hello one"
    assert transcripts[1]["source"] == "hello one hello two"
    assert transcripts[1]["target"].count("[fra_Latn]") == 2


@pytest.mark.parametrize("weightless", [False, None])
def test_streaming_silence(weightless):
    """Windows that decode to no text: with real weights (``weightless`` is
    False) they are skipped and the stream ends with the structured empty
    event; otherwise (weightless, or not declared) the path still runs
    whole."""
    got, want = _both(lambda: dict(asr=StreamingFakeAsr(("", ""), weightless), nmt=FakeNmt(),
                                   tts=FakeTts()), np.zeros(64_000, np.float32))
    _events_match(got, want)
    if weightless is False:
        assert got == [{"type": "transcripts", "source": "", "target": ""}]
    else:
        assert [e["type"] for e in got] == ["transcripts", "audio"] * 2


def test_streaming_rejects_an_unsupported_target():
    from expressive_speech_translation_tpu_torch.core.errors import ValidationError

    backend = CascadedBackend(Engines(asr=FakeAsr(), nmt=FakeNmt(), tts=FakeTts()))
    with pytest.raises(ValidationError):
        next(backend.translate_speech_streaming(AUDIO, "eng", "xx"))
