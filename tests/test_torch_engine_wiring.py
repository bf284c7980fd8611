"""How the port's engines are wired, against the JAX package's on the CPU.

- The NLLB engine resolves language tokens through a tokenizer's
  ``token_to_id`` when no ``lang_code_to_id`` is given, as ``JaxNllbNmt``
  does: the same forced BOS and the same tokens, with weights and weightless.
- ``torch_engines`` takes every key of the JAX factory ``jax_engines``: it
  honours the ones the port can serve (ASR context buckets, per-stage
  tokenizers, the micro-batchers, int8 decode, the TTS engine's MTP width
  and speculative decoding) and raises ``NotImplementedError`` naming
  the ROADMAP item for the rest, unless their value is the JAX default, which
  asks for nothing.
"""

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
from expressive_speech_translation_tpu.pipeline.jax_engines import JaxNllbNmt, jax_engines
from expressive_speech_translation_tpu.pipeline.tokenizer import nllb_lang_ids as jax_nllb_lang_ids
from expressive_speech_translation_tpu_torch.models import cosyvoice as tcv
from expressive_speech_translation_tpu_torch.models import nllb as tnl
from expressive_speech_translation_tpu_torch.models import qwen2 as tq2
from expressive_speech_translation_tpu_torch.models import whisper as twh
from expressive_speech_translation_tpu_torch.models.common import cast_floats
from expressive_speech_translation_tpu_torch.pipeline import torch_engines as te
from expressive_speech_translation_tpu_torch.pipeline.languages import NLLB_LANGUAGES
from expressive_speech_translation_tpu_torch.pipeline.tokenizer import nllb_lang_ids
from expressive_speech_translation_tpu_torch.pipeline.torch_engines import (
    TorchCosyVoiceTts, TorchNllbNmt, TorchWhisperAsr, torch_engines)
from expressive_speech_translation_tpu_torch.serve.batching import (BatchedAsr, BatchedNmt,
                                                                    BatchedTts)

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

# key → (a value that asks for something, the ROADMAP Queue 1 item it waits
# for, or None where the port honours it)
JAX_KEYS = {
    "asr_context_buckets": ((10, 20, 30), None),
    "tokenizer": (Marker(), None),
    "asr_tokenizer": (Marker(), None),
    "nmt_tokenizer": (Marker(), None),
    "tts_tokenizer": (Marker(), None),
    "lang_code_to_id": ({"eng": 370, "fra": 371}, None),
    "scale": ("toy", None),
    "asr_cfg": (TINY["asr_cfg"], None), "asr_params": (None, None),
    "nmt_cfg": (TINY["nmt_cfg"], None), "nmt_params": (None, None),
    "tts_cfg": (TINY["tts_cfg"], None), "tts_params": (None, None),
    "tts_ecapa": (None, None), "tts_speech_tokenizer": (None, None),
    "batch_tts": (True, None), "batch_asr": (True, None), "batch_nmt": (True, None),
    "max_batch": (16, None), "batch_wait_ms": (5.0, None),
    "tts_mtp": (2, None), "tts_spec": (True, None),
    "quantize": (True, None),
    "tts_official": (object(), 8),
    "mesh": (object(), 12), "stage_parallel": (True, 12), "stage_tp": (2, 12),
    "stage_meshes": ({"asr": object()}, 12),
}


def test_every_jax_factory_key_is_handled():
    assert _jax_factory_keys() == set(JAX_KEYS)
    assert set(te._QUEUED_KEYS) == {k for k, (_, item) in JAX_KEYS.items() if item}


@pytest.mark.parametrize("key", sorted(JAX_KEYS))
def test_torch_engines_honours_or_refuses_each_jax_key(key):
    value, item = JAX_KEYS[key]
    kwargs = {**TINY, key: value}
    if item is not None:
        with pytest.raises(NotImplementedError, match=f"Queue 1 item {item} "):
            torch_engines(**kwargs)
        return
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
    monkeypatch.setenv("EST_MODELS_DIR", "/nonexistent")
    with pytest.raises(NotImplementedError, match="EST_MODELS_DIR.*Queue 1 item 8 "):
        torch_engines(**TINY)
