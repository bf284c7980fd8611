"""How the port's engines are wired, against the JAX package's on the CPU.

- The NLLB engine resolves language tokens through a tokenizer's
  ``token_to_id`` when no ``lang_code_to_id`` is given, as ``JaxNllbNmt``
  does: the same forced BOS and the same tokens, with weights and weightless.
- ``torch_engines`` takes every key of the JAX factory ``jax_engines`` and
  honours each (ASR context buckets, per-stage tokenizers, the
  micro-batchers, int8 decode, the TTS engine's MTP width and speculative
  decoding, the official CosyVoice2 chain, a mesh, stage placement with its
  tensor parallelism, per-stage meshes).
- The official chain's engine (``official=``) serves ``synthesize``,
  ``synthesize_batch`` and ``synthesize_streaming`` as
  ``JaxCosyVoiceTts(official=...)`` does on the same tiny triple, with the
  JAX engine's key schedule injected, and cuts its audio by HiFT's hop.
"""

import dataclasses
import inspect
import re

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from expressive_speech_translation_tpu.models import cosyvoice as jcv
from expressive_speech_translation_tpu.models import nllb as jnl
from expressive_speech_translation_tpu.models import qwen2 as jq2
from expressive_speech_translation_tpu.models import whisper as jwh
from expressive_speech_translation_tpu.models import cosyvoice_official as jco
from expressive_speech_translation_tpu.pipeline.jax_engines import (JaxCosyVoiceTts, JaxNllbNmt,
                                                                    jax_engines)
from expressive_speech_translation_tpu.pipeline.tokenizer import nllb_lang_ids as jax_nllb_lang_ids
from expressive_speech_translation_tpu_torch.models import cosyvoice as tcv
from expressive_speech_translation_tpu_torch.models import cosyvoice_official as tco
from expressive_speech_translation_tpu_torch.models import ecapa as tec
from expressive_speech_translation_tpu_torch.models import speech_tokenizer as tst
from expressive_speech_translation_tpu_torch.models import nllb as tnl
from expressive_speech_translation_tpu_torch.models import qwen2 as tq2
from expressive_speech_translation_tpu_torch.models import whisper as twh
from expressive_speech_translation_tpu_torch.models.common import cast_floats
from expressive_speech_translation_tpu_torch.parallel import mesh as pmesh
from expressive_speech_translation_tpu_torch.parallel.partition import Shards
from expressive_speech_translation_tpu_torch.pipeline import torch_engines as te
from expressive_speech_translation_tpu_torch.pipeline.languages import NLLB_LANGUAGES
from expressive_speech_translation_tpu_torch.pipeline.tokenizer import nllb_lang_ids
from expressive_speech_translation_tpu_torch.pipeline.torch_engines import (
    TorchCosyVoiceTts, TorchNllbNmt, TorchWhisperAsr, torch_engines)
from expressive_speech_translation_tpu_torch.serve.batching import (BatchedAsr, BatchedNmt,
                                                                    BatchedTts)

from test_torch_official import JCLONE, TINY as OTINY, EngineNoise, port_cfg

NCFG = jnl.NLLBConfig(d_model=64, encoder_layers=2, decoder_layers=2, heads=4, ffn_dim=128,
                      vocab_size=384, max_positions=128)
FLORES_BASE = 300


def _fields(cfg):
    return {f: getattr(cfg, f) for f in cfg.__dataclass_fields__}


class VocabTokenizer:
    """UTF-8 bytes at 4..259 and the FLORES language tokens, sorted, at 300+
    (``fra_Latn`` is 305). ``decode`` spells out the ids, so equal text means
    equal tokens."""

    vocab_size = NCFG.vocab_size
    _lang = {code: FLORES_BASE + i for i, code in enumerate(sorted(NLLB_LANGUAGES.values()))}

    def encode(self, text):
        return [b + 4 for b in text.encode("utf-8")]

    def decode(self, ids):
        return " ".join(str(int(i)) for i in ids)

    def token_to_id(self, token):
        return self._lang.get(token)


def test_nllb_lang_ids_matches_jax():
    tok = VocabTokenizer()
    assert nllb_lang_ids(tok) == jax_nllb_lang_ids(tok)
    assert nllb_lang_ids(tok)["fra"] == nllb_lang_ids(tok)["fra_Latn"] == 305
    assert nllb_lang_ids(object()) == {}


@pytest.mark.parametrize("weightless", [False, True])
def test_nmt_takes_language_tokens_from_the_tokenizer_like_jax(weightless):
    tok = VocabTokenizer()
    params = JaxNllbNmt(NCFG, None, dtype=jnp.float32).params
    jnmt = JaxNllbNmt(NCFG, None if weightless else params, tok, dtype=jnp.float32,
                      max_new_tokens=12)
    tparams = tnl.from_jax_params(jax.tree.map(np.asarray, params), "cpu")
    nmt = TorchNllbNmt(tnl.NLLBConfig(**_fields(NCFG)), None if weightless else tparams, tok,
                       device="cpu", dtype=torch.float32, max_new_tokens=12)
    assert nmt.weightless is jnmt.weightless is weightless
    if weightless:   # the same weights, taken after a weightless start
        jnmt.params = params
        nmt.params = cast_floats(tparams, torch.float32)
    assert nmt.lang_code_to_id == jnmt.lang_code_to_id
    assert nmt._lang_id("fra") == jnmt._lang_id("fra") == 305
    for text, src, tgt in (("hello there", "eng", "fra"), ("guten tag", "deu", "spa")):
        want = jnmt.translate(text, src, tgt)
        got = nmt.translate(text, src, tgt)
        assert got == want and got


# ------------------------------------------------------------ torch_engines


def _jax_factory_keys():
    """Every key ``jax_engines`` reads: its parameters and its kwargs lookups."""
    src = inspect.getsource(jax_engines)
    keys = set(inspect.signature(jax_engines).parameters) - {"kwargs"}
    keys |= set(re.findall(r'kwargs\.get\("(\w+)"', src))
    keys |= set(re.findall(r'"(\w+)" (?:not )?in kwargs', src))
    return keys


class Marker:
    """A stand-in tokenizer: the engines only store it."""

    vocab_size = 260

    def encode(self, text):
        return [b + 4 for b in text.encode("utf-8")]

    def decode(self, ids):
        return ""


TINY = dict(
    device="cpu", dtype=torch.float32,
    asr_cfg=twh.WhisperConfig(
        d_model=32, encoder_layers=1, decoder_layers=1, heads=2, ffn_dim=64, vocab_size=365,
        max_target_positions=32, eos_token=260, bos_token=261, lang_token_start=262,
        task_transcribe=362, no_timestamps=363, sop_token=364, no_speech_token=360),
    nmt_cfg=tnl.NLLBConfig(d_model=32, encoder_layers=1, decoder_layers=1, heads=2, ffn_dim=64,
                           vocab_size=384, max_positions=64),
    tts_cfg=tcv.CosyVoiceConfig(
        lm=tcv.SpeechLMConfig(backbone=tq2.Qwen2Config(hidden=32, layers=1, heads=2, kv_heads=1,
                                                       ffn_dim=64, max_positions=1024),
                              text_vocab=384, speech_token_size=32),
        flow=tcv.FlowConfig(token_vocab=35, dim=32, layers=1, heads=2),
        vocoder=tcv.VocoderConfig(base_channels=32)))

# key → a value that asks for something
JAX_KEYS = {
    "asr_context_buckets": (10, 20, 30),
    "tokenizer": Marker(),
    "asr_tokenizer": Marker(),
    "nmt_tokenizer": Marker(),
    "tts_tokenizer": Marker(),
    "lang_code_to_id": {"eng": 370, "fra": 371},
    "scale": "toy",
    "asr_cfg": TINY["asr_cfg"], "asr_params": None,
    "nmt_cfg": TINY["nmt_cfg"], "nmt_params": None,
    "tts_cfg": TINY["tts_cfg"], "tts_params": None,
    "tts_ecapa": None, "tts_speech_tokenizer": None,
    "batch_tts": True, "batch_asr": True, "batch_nmt": True,
    "max_batch": 16, "batch_wait_ms": 5.0,
    "tts_mtp": 2, "tts_spec": True,
    "quantize": True,
    "tts_official": (tco.init_official_tts(0, OTINY, "cpu"), OTINY),
    "mesh": pmesh.make_mesh(pmesh.MeshSpec(dp=1, tp=2), devices=pmesh.cpu_slots(2)),
    "stage_parallel": True, "stage_tp": 2,
    "stage_meshes": {"asr": pmesh.make_mesh(pmesh.MeshSpec(dp=1, tp=2),
                                            devices=pmesh.cpu_slots(2))},
}


def test_every_jax_factory_key_is_handled():
    assert _jax_factory_keys() == set(JAX_KEYS)


def _q_kernel(engine):
    """The ASR or NLLB engine's first decoder block's q kernel."""
    return engine.params["decoder"]["layers"][0]["self_attn"]["q"]["kernel"]


@pytest.mark.parametrize("key", sorted(JAX_KEYS))
def test_torch_engines_honours_or_refuses_each_jax_key(key, monkeypatch):
    value = JAX_KEYS[key]
    kwargs = {**TINY, key: value}
    # stage placement takes every card by default: four CPU slots stand in
    monkeypatch.setattr(pmesh, "local_devices", lambda: [torch.device("cpu")] * 4)
    if key in ("max_batch", "batch_wait_ms"):   # they shape the batchers a batch key asks for
        kwargs["batch_nmt"] = True
    eng = torch_engines(**kwargs)
    batched = [getattr(eng, name) for name in ("asr", "nmt", "tts")
               if isinstance(getattr(eng, name), (BatchedAsr, BatchedNmt, BatchedTts))]
    for stage in batched:
        stage.shutdown()
    if key.startswith("batch_") or key == "max_batch":
        stage, facade, engine = {"batch_tts": ("tts", BatchedTts, TorchCosyVoiceTts),
                                 "batch_asr": ("asr", BatchedAsr, TorchWhisperAsr)}.get(
            key, ("nmt", BatchedNmt, TorchNllbNmt))
        assert [type(b) for b in batched] == [facade]
        wrapped = getattr(eng, stage)
        assert type(wrapped.engine) is engine and wrapped.weightless is True
        assert wrapped._mb.max_batch == (16 if key == "max_batch" else 8)
        assert wrapped._mb.max_wait_s == (0.005 if key == "batch_wait_ms" else 0.02)
        return
    assert not batched
    if key == "asr_context_buckets":
        assert eng.asr.context_buckets == (10, 20, 30)
    elif key == "tokenizer":
        assert eng.asr.tokenizer is eng.nmt.tokenizer is eng.tts.tokenizer is value
    elif key.endswith("_tokenizer") and key != "tts_speech_tokenizer":
        stage = key.split("_")[0]
        for name in ("asr", "nmt", "tts"):
            assert (getattr(eng, name).tokenizer is value) == (name == stage)
    elif key == "lang_code_to_id":
        assert eng.nmt._lang_id("fra") == 371
    elif key == "tts_mtp":
        assert (eng.tts.cfg.lm.mtp, eng.tts.cfg.lm.spec_decode) == (2, False)
        assert len(eng.tts.params["lm"]["mtp_heads"]) == 1
    elif key == "tts_spec":
        # alone it has no MTP width to verify over: off, single-token
        assert (eng.tts.cfg.lm.mtp, eng.tts.cfg.lm.spec_decode) == (1, False)
        assert "mtp_heads" not in eng.tts.params["lm"]
        eng = torch_engines(**kwargs, tts_mtp=2)
        assert (eng.tts.cfg.lm.mtp, eng.tts.cfg.lm.spec_decode) == (2, True)
        assert len(eng.tts.params["lm"]["mtp_heads"]) == 1
    elif key == "tts_official":
        assert eng.tts.official is value and eng.tts.official_cfg is OTINY
        assert eng.tts.params["hift"]["conv_post"]["kernel"].dtype == eng.tts.dtype
        assert eng.tts._samples_per_token() == 2 * 480 and not eng.tts.weightless
    elif key == "mesh":
        assert eng.asr.mesh is eng.nmt.mesh is eng.tts.mesh is value
        assert isinstance(_q_kernel(eng.asr), Shards) and isinstance(_q_kernel(eng.nmt), Shards)
        assert eng.tts.params["lm"]["backbone"]["layers"][0]["q"]["kernel"].slots == (0, 1)
        assert eng.placement_info() == {"asr": [0, 1], "nmt": [0, 1], "tts": [0, 1]}
    elif key == "stage_parallel":
        # one group a stage (dp capped at STAGE_MAX_DP): the fourth slot stays idle
        assert eng.placement_info() == {"asr": [0], "nmt": [1], "tts": [2]}
        assert dict(eng.tts.mesh.shape) == {"dp": 1, "tp": 1} and eng.tts.groups == [eng.tts]
    elif key == "stage_tp":
        # without stage_parallel it is ignored (with a warning), as in JAX
        assert eng.asr.mesh is eng.nmt.mesh is eng.tts.mesh is None
        assert not isinstance(_q_kernel(eng.asr), Shards)
    elif key == "stage_meshes":
        assert eng.asr.mesh is value["asr"] and eng.nmt.mesh is eng.tts.mesh is None
        assert isinstance(_q_kernel(eng.asr), Shards)
        assert not isinstance(_q_kernel(eng.nmt), Shards)
    elif key == "quantize":
        assert eng.asr.quantized and eng.nmt.quantized and eng.tts.quantized
        dec = eng.asr.params["decoder"]
        assert dec["layers"][0]["self_attn"]["q"]["kernel_q"].dtype == torch.int8
        assert dec["embed_q"]["q"].dtype == torch.int8 and "kernel" in eng.asr.params[
            "encoder"]["layers"][0]["mlp"]["fc1"]
        assert eng.nmt.params["embed_q"]["q"].dtype == torch.int8
        assert eng.nmt.params["decoder"]["layers"][0]["mlp"]["fc2"]["kernel_q"].dtype == torch.int8
        lm = eng.tts.params["lm"]
        assert lm["head"]["kernel_q"].dtype == lm["backbone"]["layers"][0]["down"][
            "kernel_q"].dtype == torch.int8
    else:
        assert eng.asr.context_buckets == (30,)
    if key != "quantize":
        assert not (eng.asr.quantized or eng.nmt.quantized or eng.tts.quantized)
    if key not in ("tts_mtp", "tts_spec"):
        assert (eng.tts.cfg.lm.mtp, eng.tts.cfg.lm.spec_decode) == (1, False)


def test_torch_engines_stages_follow_the_jax_factory():
    """The same keys give the JAX engines and the port's the same buckets
    and the same per-stage tokenizers, over the shared one."""
    shared, asr_tok, tts_tok = Marker(), Marker(), Marker()
    keys = dict(tokenizer=shared, asr_tokenizer=asr_tok, tts_tokenizer=tts_tok,
                asr_context_buckets=(20, 10))
    jax_eng = jax_engines(
        asr_cfg=jwh.WhisperConfig(**_fields(TINY["asr_cfg"])),
        nmt_cfg=jnl.NLLBConfig(**_fields(TINY["nmt_cfg"])),
        tts_cfg=jcv.CosyVoiceConfig(
            lm=jcv.SpeechLMConfig(backbone=jq2.Qwen2Config(**_fields(TINY["tts_cfg"].lm.backbone)),
                                  text_vocab=384, speech_token_size=32),
            flow=jcv.FlowConfig(**_fields(TINY["tts_cfg"].flow)),
            vocoder=jcv.VocoderConfig(**_fields(TINY["tts_cfg"].vocoder))), **keys)
    eng = torch_engines(**TINY, **keys)
    assert eng.asr.context_buckets == tuple(jax_eng.asr.context_buckets) == (10, 20)
    for name in ("asr", "nmt", "tts"):
        assert getattr(eng, name).tokenizer is getattr(jax_eng, name).tokenizer


def test_torch_engines_accepts_the_jax_defaults_and_refuses_the_unknown(monkeypatch):
    defaults = {k: v for k, v in inspect.signature(jax_engines).parameters.items()
                if v.default is not inspect.Parameter.empty and k != "scale"}
    eng = torch_engines(**TINY, **{k: p.default for k, p in defaults.items()},
                        mesh=None, stage_meshes=None, tts_official=None, tts_mtp=0,
                        tts_spec=False)
    assert eng.asr.context_buckets == (30,)
    with pytest.raises(TypeError, match="unexpected keyword argument 'asr_bucket'"):
        torch_engines(**TINY, asr_bucket=(10,))
    # a set EST_MODELS_DIR with no stage directory serves random weights, as in JAX
    monkeypatch.setenv("EST_MODELS_DIR", "/nonexistent")
    eng = torch_engines(**TINY)
    jax_eng = jax_engines(asr_cfg=jwh.WhisperConfig(**_fields(TINY["asr_cfg"])),
                          nmt_cfg=jnl.NLLBConfig(**_fields(TINY["nmt_cfg"])))
    for stage in ("asr", "nmt", "tts"):
        assert getattr(eng, stage).weightless is getattr(jax_eng, stage).weightless is True
    assert eng.tts.conditioning_weightless is jax_eng.tts.conditioning_weightless is True


# ------------------------------------------------------- the official chain


def _np(tree):
    return jax.tree.map(np.array, tree)


def _official_pair(jcfg, eos_bias=0.0):
    """(JAX engine, port engine) of the official chain on one seeded JAX
    triple, f32, the port with the JAX engine's conditioning models and its
    key schedule."""
    tree = _np(jco.init_official_tts(jax.random.PRNGKey(0), jcfg))
    tree["lm"]["head"]["bias"][jcfg.lm.eos_speech] += eos_bias
    jtts = JaxCosyVoiceTts(dtype=jnp.float32, official=(tree, jcfg))
    tts = TorchCosyVoiceTts(
        device="cpu", dtype=torch.float32, noise=EngineNoise,
        official=(tco.from_jax_params(tree, "cpu"), port_cfg(jcfg)),
        ecapa_weights=(tec.from_jax_params(_np(jtts._ecapa), "cpu"),
                       tec.EcapaConfig(**_fields(jtts._ecapa_cfg))),
        speech_tokenizer_weights=(tst.from_jax_params(_np(jtts._st), "cpu"),
                                  tst.SpeechTokenizerConfig(**_fields(jtts._st_cfg))))
    return jtts, tts


@pytest.fixture(scope="module")
def official_pair():
    # an EOS-favoured head keeps the 64-token budget from running to its end
    return _official_pair(JCLONE, eos_bias=1.0)


def _speech(seconds, seed):
    t = np.arange(int(16_000 * seconds)) / 16_000
    g = np.random.default_rng(seed)
    return (0.4 * np.sin(2 * np.pi * 180 * t) + 0.02 * g.standard_normal(t.shape)).astype(
        np.float32)


OFFICIAL_ATOL = 1e-4   # f32 waveform through conditioning, flow and HiFT


def test_official_engine_synthesize_matches_jax(official_pair):
    """With a cloning reference (ECAPA x-vector, prompt mel and FSQ prompt
    tokens into the official flow) and without one."""
    jtts, tts = official_pair
    assert tts.official_cfg.lm.mtp == jtts.official_cfg.lm.mtp == 1
    ref = _speech(2.5, seed=3)
    for kw in (dict(style_prompt="hello there", reference_audio_16k=ref), {}):
        want = jtts.synthesize("bonjour a tous", **kw)
        got = tts.synthesize("bonjour a tous", **kw)
        assert got.shape == want.shape and got.size % (2 * 480) == 0
        np.testing.assert_allclose(got, want, atol=OFFICIAL_ATOL, rtol=0)


def test_official_engine_synthesize_batch_matches_jax(official_pair):
    """Two rows, one cloning a reference and one without: per-row prompt
    compaction in the flow and HiFT masked to each row's frames."""
    jtts, tts = official_pair
    reqs = [{"text": "une phrase un peu plus longue", "reference_audio_16k": _speech(3.0, 4),
             "style_prompt": "a longer sentence", "language": "fr"},
            {"text": "court", "reference_audio_16k": None, "style_prompt": "", "language": "fr"}]
    want = jtts.synthesize_batch(reqs)
    got = tts.synthesize_batch(reqs)
    assert [g.shape for g in got] == [w.shape for w in want]
    for g, w in zip(got, want):
        np.testing.assert_allclose(g, w, atol=OFFICIAL_ATOL, rtol=0)


def test_official_engine_stream_matches_jax(official_pair):
    jtts, tts = official_pair
    ref = _speech(2.0, seed=5)
    want = list(jtts.synthesize_streaming("bonjour", reference_audio_16k=ref))
    got = list(tts.synthesize_streaming("bonjour", reference_audio_16k=ref))
    assert [len(c) for c in got] == [len(c) for c in want] and got
    for g, w in zip(got, want):
        np.testing.assert_allclose(g, w, atol=OFFICIAL_ATOL, rtol=0)


def test_official_samples_per_token_follow_hift_not_the_native_vocoder():
    """A HiFT of upsample rates (8, 5) has a hop of 4·8·5 = 160, while the
    engine's config view keeps the native vocoder's 480: the audio is cut at
    the token lengths × 2 × 160, as the JAX engine cuts it."""
    jcfg = dataclasses.replace(JCLONE, hift=dataclasses.replace(
        JCLONE.hift, upsample_rates=(8, 5), upsample_kernels=(16, 11)))
    jtts, tts = _official_pair(jcfg, eos_bias=1.0)
    assert tts._samples_per_token() == jtts._samples_per_token() == 2 * 160
    assert tts.cfg.vocoder.hop == 480
    want = jtts.synthesize("salut")
    got = tts.synthesize("salut")
    assert got.shape == want.shape and got.size % 320 == 0
    np.testing.assert_allclose(got, want, atol=OFFICIAL_ATOL, rtol=0)
    batch = tts.synthesize_batch([{"text": "salut"}, {"text": "salut encore"}])
    assert all(b.size % 320 == 0 for b in batch)
