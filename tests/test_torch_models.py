"""The port's models against the JAX package on the CPU, on shared weights.

Each test draws its inputs from a numpy seed, initialises the JAX model, and
hands the same parameter tree to the port through ``from_jax_params``.
Greedy and injected-noise token streams must be token-exact. Float outputs
are held to 1e-4 absolute at these toy widths: both sides run IEEE f32 and
differ only in summation order over a few hundred terms per output, through
a few layers. Stochastic steps take the JAX key schedule's own noise: RAS
draws are ``argmax(logits + gumbel(k))`` with the keys of
``fold_in(key, i)`` split in two, the flow starts from ``normal(key)``.
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
from expressive_speech_translation_tpu_torch.models import cosyvoice as tcv
from expressive_speech_translation_tpu_torch.models import nllb as tnl
from expressive_speech_translation_tpu_torch.models import qwen2 as tq2
from expressive_speech_translation_tpu_torch.models import whisper as twh
from expressive_speech_translation_tpu_torch.ops import cuda_vocoder

ATOL = 1e-4
CPU = torch.device("cpu")


def _np(tree):
    return jax.tree.map(np.asarray, tree)


def _t(a, dtype=None):
    t = torch.from_numpy(np.array(a))
    return t if dtype is None else t.to(dtype)


class JaxKeyNoise:
    """The port's NoiseSource fed from a JAX key schedule (``k_lm`` for the
    RAS draws, ``k_flow`` for x_0)."""

    def __init__(self, k_lm, k_flow):
        self.k_lm, self.k_flow = k_lm, k_flow

    def ras_gumbel(self, step, shape):
        k1, k2 = jax.random.split(jax.random.fold_in(self.k_lm, step))
        return (_t(jax.random.gumbel(k1, shape, jnp.float32)),
                _t(jax.random.gumbel(k2, shape, jnp.float32)))

    def flow_x0(self, shape):
        return _t(jax.random.normal(self.k_flow, shape, jnp.float32))


# -------------------------------------------------------------------- whisper

WCFG = jwh.WhisperConfig(
    d_model=64, encoder_layers=2, decoder_layers=2, heads=4, ffn_dim=128,
    vocab_size=365, max_target_positions=64, eos_token=260, bos_token=261,
    lang_token_start=262, task_translate=361, task_transcribe=362, no_timestamps=363,
    sop_token=364, no_speech_token=360)
TWCFG = twh.WhisperConfig(**{f: getattr(WCFG, f) for f in WCFG.__dataclass_fields__})


@pytest.fixture(scope="module")
def whisper_pair():
    params = jwh.init_whisper(jax.random.PRNGKey(3), WCFG)
    return params, twh.from_jax_params(_np(params), CPU)


def test_whisper_encode_matches(whisper_pair):
    jp, tp = whisper_pair
    mel = np.random.default_rng(0).standard_normal((2, 80, 200)).astype(np.float32)
    want = np.asarray(jwh.encode(jp, WCFG, jnp.asarray(mel)))
    got = twh.encode(tp, TWCFG, _t(mel)).numpy()
    assert got.shape == want.shape == (2, 100, 64)
    np.testing.assert_allclose(got, want, atol=ATOL, rtol=0)


@pytest.mark.parametrize("prompt,sot,suppress", [
    ([261, 262, 362, 363], 0, ()),
    ([364, 40, 41, 42, 261, 262, 362, 363], 4, (50, 51, 52, 300)),
])
def test_whisper_greedy_decode_token_exact(whisper_pair, prompt, sot, suppress):
    jp, tp = whisper_pair
    mel = np.random.default_rng(1).standard_normal((1, 80, 200)).astype(np.float32)
    kw = dict(max_new_tokens=12, min_new_tokens=2, suppress_tokens=suppress,
              suppress_first_tokens=(36, 260), sot_index=sot)
    want = jwh.decode_with_alignment(jp, WCFG, jnp.asarray(mel),
                                     jnp.asarray([prompt], jnp.int32), **kw)
    got = twh.decode_with_alignment(tp, TWCFG, _t(mel), torch.tensor([prompt]), **kw)
    np.testing.assert_array_equal(got[0].numpy(), np.asarray(want[0]))
    for g, w in zip(got[1:], want[1:]):
        np.testing.assert_allclose(g.numpy(), np.asarray(w), atol=ATOL, rtol=0)


def test_whisper_sampled_decode_with_jax_noise_token_exact(whisper_pair):
    jp, tp = whisper_pair
    mel = np.random.default_rng(2).standard_normal((1, 80, 200)).astype(np.float32)
    prompt = [261, 262, 362, 363]
    key = jax.random.PRNGKey(11)
    want = jwh.decode_with_alignment(jp, WCFG, jnp.asarray(mel), jnp.asarray([prompt]),
                                     max_new_tokens=10, temperature=0.8, key=key)
    subs, k = [], key
    for _ in range(len(prompt) + 10):
        k, sub = jax.random.split(k)
        subs.append(sub)

    def gumbel(pos, shape):
        u = jax.random.uniform(subs[pos], shape, minval=1e-9, maxval=1.0)
        return _t(-jnp.log(-jnp.log(u)))

    got = twh.decode_with_alignment(tp, TWCFG, _t(mel), torch.tensor([prompt]),
                                    max_new_tokens=10, temperature=0.8, gumbel=gumbel)
    np.testing.assert_array_equal(got[0].numpy(), np.asarray(want[0]))
    with pytest.raises(ValueError, match="noise source"):
        twh.decode_with_alignment(tp, TWCFG, _t(mel), torch.tensor([prompt]),
                                  max_new_tokens=4, temperature=0.5)


def test_dtw_token_times_matches():
    a = np.random.default_rng(3).random((9, 150)).astype(np.float32)
    np.testing.assert_array_equal(twh.dtw_token_times(a, 7, 3.0), jwh.dtw_token_times(a, 7, 3.0))
    np.testing.assert_array_equal(twh.dtw_token_times(a, 9, 0.0), jwh.dtw_token_times(a, 9, 0.0))


# ----------------------------------------------------------------------- nllb

NCFG = jnl.NLLBConfig(d_model=64, encoder_layers=2, decoder_layers=2, heads=4, ffn_dim=128,
                      vocab_size=384, max_positions=128)
TNCFG = tnl.NLLBConfig(**{f: getattr(NCFG, f) for f in NCFG.__dataclass_fields__})


def test_nllb_greedy_generate_token_exact():
    jp = jnl.init_nllb(jax.random.PRNGKey(5), NCFG)
    tp = tnl.from_jax_params(_np(jp), CPU)
    g = np.random.default_rng(4)
    src = np.full((2, 16), NCFG.pad_token, np.int32)
    src[0, :11] = g.integers(3, 380, 11)
    src[1, :5] = g.integers(3, 380, 5)
    src[:, 10] = NCFG.eos_token
    want = np.asarray(jnl.generate(jp, NCFG, jnp.asarray(src), 377, max_new_tokens=20,
                                   min_new_tokens=3))
    got = tnl.generate(tp, TNCFG, _t(src), 377, max_new_tokens=20, min_new_tokens=3).numpy()
    np.testing.assert_array_equal(got, want)
    np.testing.assert_allclose(tnl.encode(tp, TNCFG, _t(src)).numpy(),
                               np.asarray(jnl.encode(jp, NCFG, jnp.asarray(src))), atol=ATOL, rtol=0)
    with pytest.raises(ValueError, match="position id"):
        tnl.generate(tp, TNCFG, _t(src), 377, max_new_tokens=200)


# ---------------------------------------------------------------------- qwen2

QCFG = jq2.Qwen2Config(hidden=64, layers=2, heads=4, kv_heads=2, ffn_dim=128, max_positions=256)
TQCFG = tq2.Qwen2Config(**{f: getattr(QCFG, f) for f in QCFG.__dataclass_fields__})


def test_qwen2_prefill_and_decode_step_match():
    jp = jq2.init_qwen2(jax.random.PRNGKey(6), QCFG)
    tp = tq2.from_jax_params(_np(jp), CPU)
    g = np.random.default_rng(5)
    x = g.standard_normal((2, 9, 64)).astype(np.float32)
    mask = np.ones((2, 9), bool)
    mask[1, 6:] = False
    jcache = jq2.init_kv_cache(QCFG, 2, 12)
    jh, jcache = jq2.prefill(jp, QCFG, jnp.asarray(x), jcache, length_mask=jnp.asarray(mask))
    tcache = tq2.init_kv_cache(TQCFG, 2, 12, torch.float32, CPU)
    th = tq2.prefill(tp, TQCFG, _t(x), tcache, length_mask=_t(mask))
    np.testing.assert_allclose(th.numpy(), np.asarray(jh), atol=ATOL, rtol=0)
    plen = np.array([9, 6])
    for i in range(3):
        step = g.standard_normal((2, 1, 64)).astype(np.float32)
        jh, jcache = jq2.decode_step(jp, QCFG, jnp.asarray(step), 9 + i, jcache,
                                     rope_pos=jnp.asarray(plen + i), prompt_len=jnp.asarray(plen),
                                     prompt_capacity=9)
        th = tq2.decode_step(tp, TQCFG, _t(step), 9 + i, tcache, rope_pos=_t(plen + i),
                             prompt_len=_t(plen), prompt_capacity=9)
        np.testing.assert_allclose(th.numpy(), np.asarray(jh), atol=ATOL, rtol=0)
    np.testing.assert_allclose(tcache[1]["k"].numpy(), np.asarray(jcache[1]["k"]), atol=ATOL, rtol=0)


# ------------------------------------------------------------------ cosyvoice

CCFG = jcv.CosyVoiceConfig(
    lm=jcv.SpeechLMConfig(backbone=QCFG, text_vocab=384, speech_token_size=64),
    flow=jcv.FlowConfig(token_vocab=67, dim=64, layers=2, heads=4),
    vocoder=jcv.VocoderConfig(base_channels=512))


def _tcfg(c):
    return tcv.CosyVoiceConfig(
        lm=tcv.SpeechLMConfig(backbone=TQCFG, **{f: getattr(c.lm, f) for f in (
            "text_vocab", "speech_token_size", "top_p", "top_k", "win_size", "tau_r",
            "max_tokens")}),
        flow=tcv.FlowConfig(**{f: getattr(c.flow, f) for f in c.flow.__dataclass_fields__}),
        vocoder=tcv.VocoderConfig(**{f: getattr(c.vocoder, f)
                                     for f in c.vocoder.__dataclass_fields__}))


TCCFG = _tcfg(CCFG)


@pytest.fixture(scope="module")
def cosy_pair():
    params = jcv.init_cosyvoice(jax.random.PRNGKey(7), CCFG)
    # adaLN-Zero starts every DiT block as the identity; random modulation
    # makes the flow test exercise the blocks
    g = np.random.default_rng(6)
    for blk in params["flow"]["blocks"]:
        blk["ada"]["kernel"] = jnp.asarray(0.05 * g.standard_normal(blk["ada"]["kernel"].shape),
                                           jnp.float32)
    return params, tcv.from_jax_params(_np(params), CPU)


def _lm_inputs():
    g = np.random.default_rng(7)
    text = np.zeros((2, 16), np.int32)
    tmask = np.zeros((2, 16), bool)
    text[0, :12] = g.integers(4, 300, 12)
    tmask[0, :12] = True
    text[1, :5] = g.integers(4, 300, 5)
    tmask[1, :5] = True
    psp = g.integers(0, 64, (2, 3)).astype(np.int32)
    psm = np.array([[True, True, True], [True, True, False]])
    return text, tmask, psp, psm


def test_prompt_embeddings_compaction_matches(cosy_pair):
    jp, tp = cosy_pair
    text, tmask, psp, psm = _lm_inputs()
    want = jcv.build_prompt_embeddings(jp["lm"], CCFG.lm, *map(jnp.asarray, (text, tmask, psp, psm)))
    got = tcv.build_prompt_embeddings(tp["lm"], TCCFG.lm, *map(_t, (text, tmask, psp, psm)))
    np.testing.assert_array_equal(got[1].numpy(), np.asarray(want[1]))
    np.testing.assert_allclose(got[0].numpy(), np.asarray(want[0]), atol=1e-6, rtol=0)


def test_speech_tokens_with_jax_noise_token_exact(cosy_pair):
    jp, tp = cosy_pair
    text, tmask, psp, psm = _lm_inputs()
    key = jax.random.PRNGKey(21)
    want_tok, want_len = jcv.generate_speech_tokens(
        jp["lm"], CCFG.lm, key, *map(jnp.asarray, (text, tmask, psp, psm)),
        max_new_tokens=40, min_new_tokens=2)
    got_tok, got_len = tcv.generate_speech_tokens(
        tp["lm"], TCCFG.lm, JaxKeyNoise(key, None), *map(_t, (text, tmask, psp, psm)),
        max_new_tokens=40, min_new_tokens=2)
    np.testing.assert_array_equal(got_tok.numpy(), np.asarray(want_tok))
    np.testing.assert_array_equal(got_len.numpy(), np.asarray(want_len))


def test_tokens_to_mel_with_jax_x0_matches(cosy_pair):
    jp, tp = cosy_pair
    g = np.random.default_rng(8)
    tokens = g.integers(0, 64, (2, 9)).astype(np.int32)
    tmask = np.ones((2, 9), bool)
    tmask[1, 6:] = False
    spk = g.standard_normal((2, 192)).astype(np.float32)
    pmel = g.standard_normal((2, 4, 80)).astype(np.float32)
    pmm = np.ones((2, 4), bool)
    ptok = np.zeros((2, 2), np.int32)
    ptm = np.ones((2, 2), bool)
    key = jax.random.PRNGKey(31)
    want, want_mask = jcv.tokens_to_mel(jp["flow"], CCFG.flow, key,
                                        *map(jnp.asarray, (tokens, tmask, spk, pmel, pmm)),
                                        prompt_tokens=jnp.asarray(ptok),
                                        prompt_token_mask=jnp.asarray(ptm))
    got, got_mask = tcv.tokens_to_mel(tp["flow"], TCCFG.flow, JaxKeyNoise(None, key),
                                      *map(_t, (tokens, tmask, spk, pmel, pmm)),
                                      prompt_tokens=_t(ptok), prompt_token_mask=_t(ptm))
    np.testing.assert_array_equal(got_mask.numpy(), np.asarray(want_mask))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=ATOL, rtol=0)


def test_vocode_matches_with_narrow_stages_on_the_kernel_path(cosy_pair):
    """base 512: the C=256 stage runs the plain conv loop, the C=128 and
    C=64 stages the resblock kernel's wrapper (its plain version here)."""
    jp, tp = cosy_pair
    mel = np.random.default_rng(9).standard_normal((1, 5, 80)).astype(np.float32)
    before = cuda_vocoder.fused_resblock_stage.launches
    want = np.asarray(jcv.vocode(jp["vocoder"], CCFG.vocoder, jnp.asarray(mel)))
    got = tcv.vocode(tp["vocoder"], TCCFG.vocoder, _t(mel)).numpy()
    assert got.shape == want.shape == (1, 5 * 480)
    np.testing.assert_allclose(got, want, atol=ATOL, rtol=0)
    assert cuda_vocoder.fused_resblock_stage.launches == before
