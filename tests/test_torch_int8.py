"""The port's weight-only int8 decode against the JAX package's on the CPU.

``quantize_dense`` / ``quantize_embed_head`` give symmetric int8 codes with
per-channel (per-vocabulary-row) f32 scales; ``quantize_whisper_decoder``,
``quantize_nllb_decoder`` and ``quantize_speech_lm`` apply them to the decode
path's weights; ``dense`` and ``tied_head_logits`` multiply by the codes in
the activations' dtype. The quantized trees must equal JAX's (codes exact,
scales within one ulp: the division by 127 may be reckoned otherwise), the
int8 products be within 1e-5 at f32, and the engines built with
``quantize=True`` give JAX's tokens.
"""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from expressive_speech_translation_tpu.models import common as jcm
from expressive_speech_translation_tpu.models import cosyvoice as jcv
from expressive_speech_translation_tpu.models import nllb as jnl
from expressive_speech_translation_tpu.models import qwen2 as jq2
from expressive_speech_translation_tpu.models import whisper as jwh
from expressive_speech_translation_tpu.pipeline.jax_engines import (
    JaxCosyVoiceTts, JaxNllbNmt, JaxWhisperAsr)
from expressive_speech_translation_tpu_torch.models import common as tcm
from expressive_speech_translation_tpu_torch.models import cosyvoice as tcv
from expressive_speech_translation_tpu_torch.models import nllb as tnl
from expressive_speech_translation_tpu_torch.models import qwen2 as tq2
from expressive_speech_translation_tpu_torch.models import whisper as twh
from expressive_speech_translation_tpu_torch.pipeline.languages import nllb_placeholder_lang_ids
from expressive_speech_translation_tpu_torch.pipeline.torch_engines import (
    TorchCosyVoiceTts, TorchNllbNmt, TorchWhisperAsr)

ATOL = 1e-5
AUDIO_ATOL = 1e-4
DTYPES = {"f32": (jnp.float32, torch.float32), "bf16": (jnp.bfloat16, torch.bfloat16)}


def _fields(cfg):
    return {f: getattr(cfg, f) for f in cfg.__dataclass_fields__}


def _np(tree):
    return jax.tree.map(np.asarray, tree)


def _t(a):
    return torch.from_numpy(np.array(a))


def _to_np(a):
    """A leaf of either side as numpy (bf16 through f32, exactly)."""
    if torch.is_tensor(a):
        return a.float().numpy() if a.dtype == torch.bfloat16 else a.numpy()
    a = np.asarray(a)
    return a.astype(np.float32) if a.dtype == jnp.bfloat16 else a


def _assert_trees_match(got, want, path="."):
    """The same nesting and keys; int8 codes exact; f32 ``scale`` leaves
    within one ulp; every other leaf equal."""
    if isinstance(want, dict):
        assert isinstance(got, dict) and set(got) == set(want), path
        for k in want:
            _assert_trees_match(got[k], want[k], f"{path}/{k}")
        return
    if isinstance(want, (list, tuple)):
        assert len(got) == len(want), path
        for i, (g, w) in enumerate(zip(got, want)):
            _assert_trees_match(g, w, f"{path}/{i}")
        return
    g, w = _to_np(got), _to_np(want)
    assert g.shape == w.shape, path
    if path.endswith("/scale") and got.dtype == torch.float32 and w.dtype == np.float32:
        np.testing.assert_array_max_ulp(g, w, maxulp=1)
    else:
        if w.dtype == np.int8:
            assert got.dtype == torch.int8, path
        np.testing.assert_array_equal(g, w, err_msg=path)


def _kernel(shape, seed):
    k = np.random.default_rng(seed).standard_normal(shape).astype(np.float32) * 0.05
    k[:, 3] = 0.0                      # a zero channel takes the 1e-8 floor
    k[1, 5] = 0.9                      # one large weight sets its channel's scale
    return k


# ----------------------------------------------------------------- the trees


@pytest.mark.parametrize("dtype", sorted(DTYPES))
def test_quantize_dense_matches_jax(dtype):
    jdt, tdt = DTYPES[dtype]
    k, b = _kernel((48, 24), 0), np.linspace(-1, 1, 24).astype(np.float32)
    for p in ({"kernel": k, "bias": b}, {"kernel": k}):
        want = jcm.quantize_dense({n: jnp.asarray(v, jdt) for n, v in p.items()})
        got = tcm.quantize_dense({n: _t(v).to(tdt) for n, v in p.items()})
        assert got["scale"].dtype == torch.float32 and tuple(got["scale"].shape) == (1, 24)
        _assert_trees_match(got, want)
        assert int(got["kernel_q"].abs().max()) == 127


@pytest.mark.parametrize("dtype", sorted(DTYPES))
def test_quantize_embed_head_matches_jax(dtype):
    jdt, tdt = DTYPES[dtype]
    embed = _kernel((40, 16), 1).T.copy()      # [vocab 16, d 40], row 3 zero
    want = jcm.quantize_embed_head(jnp.asarray(embed, jdt))
    got = tcm.quantize_embed_head(_t(embed).to(tdt))
    assert tuple(got["scale"].shape) == (16,)
    _assert_trees_match(got, want)


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
    lm=tcv.SpeechLMConfig(**{**_fields(CCFG.lm), "backbone": tq2.Qwen2Config(**_fields(QCFG))}),
    flow=tcv.FlowConfig(**_fields(CCFG.flow)),
    vocoder=tcv.VocoderConfig(**_fields(CCFG.vocoder)))


@pytest.fixture(scope="module")
def trees():
    """numpy trees drawn by the JAX inits (the speech LM with two MTP heads)."""
    lm_cfg = jcv.SpeechLMConfig(backbone=QCFG, text_vocab=384, speech_token_size=64, mtp=3)
    return {
        "whisper": _np(jax.jit(lambda k: jwh.init_whisper(k, WCFG))(jax.random.PRNGKey(0))),
        "nllb": _np(jax.jit(lambda k: jnl.init_nllb(k, NCFG))(jax.random.PRNGKey(1))),
        "speech_lm": _np(jax.jit(lambda k: jcv.init_speech_lm(k, lm_cfg))(
            jax.random.PRNGKey(2))),
    }


QUANTIZERS = {
    "whisper": (jwh.quantize_whisper_decoder, twh.quantize_whisper_decoder, twh.from_jax_params),
    "nllb": (jnl.quantize_nllb_decoder, tnl.quantize_nllb_decoder, tnl.from_jax_params),
    "speech_lm": (jcv.quantize_speech_lm, tcv.quantize_speech_lm,
                  lambda tree, dev: tcm.tree_from_numpy(tree, dev)),
}


@pytest.mark.parametrize("model", sorted(QUANTIZERS))
def test_quantized_trees_match_jax(trees, model):
    """Each model's quantizer on the same tree: the decode path's dense
    layers (and the tied head, and the speech LM's MTP heads) become codes
    and scales; the encoders, norms and float embeddings stay as they were."""
    jq, tq, convert = QUANTIZERS[model]
    tree = trees[model]
    want = jq(jax.tree.map(jnp.asarray, tree))
    got = tq(convert(tree, "cpu"))
    # the conversion keeps int8 leaves as they are, so JAX's quantized tree
    # converted is the port's layout of it
    _assert_trees_match(got, convert(_np(want), "cpu"))
    if model == "speech_lm":
        assert [h["kernel_q"].dtype for h in got["mtp_heads"]] == [torch.int8] * 2


# ------------------------------------------------------------ the products


def test_dense_int8_branch_matches_jax():
    k, b = _kernel((48, 24), 2), np.linspace(-1, 1, 24).astype(np.float32)
    x = np.random.default_rng(3).standard_normal((2, 3, 48)).astype(np.float32)
    for p in ({"kernel": k, "bias": b}, {"kernel": k}):
        jq = jcm.quantize_dense({n: jnp.asarray(v) for n, v in p.items()})
        tq = tcm.quantize_dense({n: _t(v) for n, v in p.items()})
        want = np.asarray(jcm.dense(jq, jnp.asarray(x)))
        got = tcm.dense(tq, _t(x))
        np.testing.assert_allclose(got.numpy(), want, atol=ATOL, rtol=0)
        exact = tcm.dense({n: _t(v) for n, v in p.items()}, _t(x)).numpy()
        assert 0 < np.abs(got.numpy() - exact).max() < 0.05     # the codes, not the floats


def test_tied_head_logits_int8_branch_matches_jax():
    embed = _kernel((40, 16), 4).T.copy()
    x = np.random.default_rng(5).standard_normal((3, 40)).astype(np.float32)
    container = {"embed": embed, "embed_q": _np(jcm.quantize_embed_head(jnp.asarray(embed)))}
    want = np.asarray(jcm.tied_head_logits(jax.tree.map(jnp.asarray, container),
                                           jnp.asarray(x), jnp.asarray(embed)))
    tcontainer = {"embed": _t(embed), "embed_q": tcm.quantize_embed_head(_t(embed))}
    got = tcm.tied_head_logits(tcontainer, _t(x), _t(embed))
    np.testing.assert_allclose(got.numpy(), want, atol=ATOL, rtol=0)
    plain = tcm.tied_head_logits({"embed": _t(embed)}, _t(x), _t(embed))
    np.testing.assert_allclose(plain.numpy(), x @ embed.T, atol=ATOL, rtol=0)
    assert np.abs(got.numpy() - plain.numpy()).max() > 0


# ------------------------------------------------------------ the engines


def _speechlike(seconds, seed, sr=16_000):
    g = np.random.default_rng(seed)
    t = np.arange(int(sr * seconds)) / sr
    x = 0.4 * np.sin(2 * np.pi * 220 * t) + 0.02 * g.standard_normal(t.shape)
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


def test_quantized_asr_engine_matches_jax(trees):
    kw = dict(max_new_tokens=12, context_buckets=(2,), temperatures=(0.0,), quantize=True)
    jasr = JaxWhisperAsr(WCFG, jax.tree.map(jnp.asarray, trees["whisper"]), dtype=jnp.float32,
                         **kw)
    asr = TorchWhisperAsr(twh.WhisperConfig(**_fields(WCFG)),
                          twh.from_jax_params(trees["whisper"], "cpu"), device="cpu",
                          dtype=torch.float32, **kw)
    assert asr.quantized and asr.params["decoder"]["embed_q"]["q"].dtype == torch.int8
    x = _speechlike(3.0, seed=6)
    want, got = jasr.transcribe(x, language="en"), asr.transcribe(x, language="en")
    assert got["text"] == want["text"] and got["text"]
    assert [w["word"] for w in got["words"]] == [w["word"] for w in want["words"]]


def test_quantized_nmt_engine_matches_jax(trees):
    ids = nllb_placeholder_lang_ids(NCFG.vocab_size)
    kw = dict(max_new_tokens=12, quantize=True, lang_code_to_id=ids)
    jnmt = JaxNllbNmt(NCFG, jax.tree.map(jnp.asarray, trees["nllb"]), dtype=jnp.float32, **kw)
    nmt = TorchNllbNmt(tnl.NLLBConfig(**_fields(NCFG)), tnl.from_jax_params(trees["nllb"], "cpu"),
                       device="cpu", dtype=torch.float32, **kw)
    assert nmt.quantized and nmt.params["embed_q"]["q"].dtype == torch.int8
    for text in ("hello there, friend", "the station is not far"):
        want = jnmt.translate(text, "eng_Latn", "fra_Latn")
        assert nmt.translate(text, "eng_Latn", "fra_Latn") == want


def test_quantized_tts_engine_matches_jax():
    """The speech LM's int8 decode, sampled with the JAX engine's noise: the
    same tokens (so the same length) and the audio within 1e-4."""
    params = _np(jax.jit(lambda k: jcv.init_cosyvoice(k, CCFG))(jax.random.PRNGKey(2)))
    jq = JaxCosyVoiceTts(CCFG, jax.tree.map(jnp.asarray, params), dtype=jnp.float32,
                         quantize=True)
    tts = TorchCosyVoiceTts(TCCFG, tcv.from_jax_params(params, "cpu"), device="cpu",
                            dtype=torch.float32, noise=JaxCallNoise, quantize=True)
    assert tts.quantized and tts.params["lm"]["head"]["kernel_q"].dtype == torch.int8
    assert "kernel" in tts.params["flow"]["in_proj"]
    want, got = jq.synthesize("bonjour a tous"), tts.synthesize("bonjour a tous")
    assert got.shape == want.shape and got.size > 0
    np.testing.assert_allclose(got, np.asarray(want), atol=AUDIO_ATOL, rtol=0)
