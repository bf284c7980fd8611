"""The port's multi-token speech-token decoding against the JAX package's on
the CPU: ``qwen2.decode_span``, accept-all MTP
(``generate_speech_tokens_mtp``), lossless speculative decoding
(``generate_speech_tokens_spec``), ``select_generator``, ``synthesize``'s
routing, and the TTS engine's ``mtp``/``spec`` reconciliation.

Both sides take the same seeded tree (the JAX init, through
``tree_from_numpy``), at the JAX package's spec-decode test sizes (hidden
64, two layers, 48 speech tokens). The port takes the JAX key schedule's
own Gumbel noise: the single-token loop and the speculative decoder draw
position i at ``fold_in(key, i)`` split in two; the MTP loop splits its key
once a pass (``key, sk = split(key)``), ``sk`` across the K heads, and each
head's key in two. Tokens must be exact at f32; hidden states within 1e-5.
"""

import dataclasses
import logging

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from expressive_speech_translation_tpu.models import cosyvoice as jcv
from expressive_speech_translation_tpu.models import qwen2 as jq2
from expressive_speech_translation_tpu.pipeline import jax_engines as jeng
from expressive_speech_translation_tpu_torch.models import cosyvoice as tcv
from expressive_speech_translation_tpu_torch.models import qwen2 as tq2
from expressive_speech_translation_tpu_torch.models.common import tree_from_numpy
from expressive_speech_translation_tpu_torch.pipeline import torch_engines as teng

V = 48
HIDDEN_ATOL = 1e-5


def _fields(cfg):
    return {f: getattr(cfg, f) for f in cfg.__dataclass_fields__}


def _t(a):
    return torch.from_numpy(np.array(a))


def _tree(params):
    return tree_from_numpy(jax.tree.map(np.asarray, params), "cpu", torch.float32)


QCFG = jq2.Qwen2Config(hidden=64, layers=2, heads=4, kv_heads=2, ffn_dim=128, max_positions=512)
TQCFG = tq2.Qwen2Config(**_fields(QCFG))


def _lm_cfgs(mtp=3, spec=True):
    jcfg = jcv.SpeechLMConfig(backbone=QCFG, text_vocab=16, speech_token_size=V, mtp=mtp,
                              spec_decode=spec)
    tcfg = tcv.SpeechLMConfig(**{**_fields(jcfg), "backbone": TQCFG})
    return jcfg, tcfg


class JaxLmNoise:
    """The JAX speech LM's key schedule from its key ``key``: position i of
    the single-token and speculative loops at ``fold_in(key, i)``; MTP pass
    i's head j at ``split(split(key_i)[1], K)[j]``, ``key_i`` the chain
    ``key, sk = split(key)``; each draw's key split in two."""

    def __init__(self, key, k_mtp=1):
        self.key, self.k_mtp, self.passes = key, k_mtp, []

    @staticmethod
    def _pair(key, shape):
        k1, k2 = jax.random.split(key)
        return (_t(jax.random.gumbel(k1, shape, jnp.float32)),
                _t(jax.random.gumbel(k2, shape, jnp.float32)))

    def ras_gumbel(self, step, shape):
        return self._pair(jax.random.fold_in(self.key, step), shape)

    def mtp_gumbel(self, pass_index, head, shape):
        chain = self.passes[-1][0] if self.passes else self.key
        while len(self.passes) <= pass_index:
            chain, sk = jax.random.split(chain)
            self.passes.append((chain, jax.random.split(sk, self.k_mtp)))
        return self._pair(self.passes[pass_index][1][head], shape)


def _inputs(seed, b=1, tt=5, ts=7, ragged=False):
    """Text [b, tt] and prompt speech [b, ts] from a numpy seed; ``ragged``
    right-pads the rows after the first to shorter lengths."""
    g = np.random.default_rng(seed)
    text = g.integers(0, 16, (b, tt)).astype(np.int32)
    speech = g.integers(0, V, (b, ts)).astype(np.int32)
    tmask, smask = np.ones((b, tt), bool), np.ones((b, ts), bool)
    if ragged:
        for r in range(1, b):
            tmask[r, tt - r:] = False
            smask[r, ts - 2 * r:] = False
    return text, tmask, speech, smask


def _both(args):
    return [jnp.asarray(a) for a in args], [_t(a) for a in args]


def _jit(fn, cfg, **kw):
    """``fn(params, cfg, key, *inputs, **kw)`` compiled once (the JAX side's
    eager ops compile one by one otherwise)."""
    return jax.jit(lambda p, k, *a: fn(p, cfg, k, *a, **kw))


def _lm_params(seed, jcfg, eos_bias=0.0):
    params = jcv.init_speech_lm(jax.random.PRNGKey(seed), jcfg)
    if eos_bias:
        params = jax.tree.map(np.array, params)
        for head in [params["head"]] + params.get("mtp_heads", []):
            head["bias"][jcfg.eos_speech] += eos_bias
        params = jax.tree.map(jnp.asarray, params)
    return params, _tree(params)


# ---------------------------------------------------------------- decode_span


@pytest.fixture(scope="module")
def backbone():
    params = jq2.init_qwen2(jax.random.PRNGKey(0), QCFG)
    return params, _tree(params)


def _prefilled(params, tparams, lens, t_prompt, room):
    g = np.random.default_rng(1)
    x = g.standard_normal((len(lens), t_prompt, 64)).astype(np.float32)
    mask = np.arange(t_prompt)[None] < np.asarray(lens)[:, None]
    jc = jq2.init_kv_cache(QCFG, len(lens), t_prompt + room, jnp.float32)
    _, jc = jax.jit(lambda p, x, c, m: jq2.prefill(p, QCFG, x, c, length_mask=m))(
        params, jnp.asarray(x), jc, jnp.asarray(mask))
    tc = tq2.init_kv_cache(TQCFG, len(lens), t_prompt + room, torch.float32, "cpu")
    tq2.prefill(tparams, TQCFG, _t(x), tc, length_mask=_t(mask))
    return jc, tc


@pytest.mark.parametrize("lens,s_len", [((9,), 3), ((9, 6, 4), 3), ((9, 5), 4)])
def test_decode_span_matches_jax_and_a_run_of_decode_steps(backbone, lens, s_len):
    """S positions after a right-padded prompt, each row at its own RoPE
    position with its pad slots masked: the hidden states and the cache
    within 1e-5 of JAX's, and of S decode_steps on the same cache (torch's
    CPU matmul sums a single row in another order than a block of rows, so
    the two agree to f32 rounding, not bit for bit)."""
    params, tparams = backbone
    t_prompt = 9
    jc, tc = _prefilled(params, tparams, lens, t_prompt, s_len + 2)
    tc_steps = [{k: v.clone() for k, v in c.items()} for c in tc]
    xs = np.random.default_rng(2).standard_normal((len(lens), s_len, 64)).astype(np.float32)
    last = np.asarray(lens) - 1
    kw = dict(prompt_capacity=t_prompt)
    jh, jc = jax.jit(lambda p, x, c, r: jq2.decode_span(p, QCFG, x, t_prompt, c, rope_pos=r,
                                                        prompt_len=r, **kw))(
        params, jnp.asarray(xs), jc, jnp.asarray(last + 1))
    th = tq2.decode_span(tparams, TQCFG, _t(xs), t_prompt, tc, rope_pos=_t(last + 1),
                         prompt_len=_t(last + 1), **kw)
    assert tuple(th.shape) == (len(lens), s_len, 64)
    np.testing.assert_allclose(th.numpy(), np.asarray(jh), atol=HIDDEN_ATOL, rtol=0)
    for c, jcc in zip(tc, jc):
        for name in ("k", "v"):
            np.testing.assert_allclose(c[name].numpy(), np.asarray(jcc[name]),
                                       atol=HIDDEN_ATOL, rtol=0)
    steps = torch.cat([tq2.decode_step(tparams, TQCFG, _t(xs[:, s:s + 1]), t_prompt + s,
                                       tc_steps, rope_pos=_t(last + 1 + s),
                                       prompt_len=_t(last + 1), **kw)
                       for s in range(s_len)], dim=1)
    np.testing.assert_allclose(th.numpy(), steps.numpy(), atol=HIDDEN_ATOL, rtol=0)
    for c, cs in zip(tc, tc_steps):
        np.testing.assert_allclose(c["k"].numpy(), cs["k"].numpy(), atol=HIDDEN_ATOL, rtol=0)


def test_decode_span_without_rope_pos_rotates_at_the_cache_slot(backbone):
    params, tparams = backbone
    jc, tc = _prefilled(params, tparams, (6,), 6, 4)
    xs = np.random.default_rng(3).standard_normal((1, 2, 64)).astype(np.float32)
    jh, _ = jax.jit(lambda p, x, c: jq2.decode_span(p, QCFG, x, 6, c))(params, jnp.asarray(xs), jc)
    th = tq2.decode_span(tparams, TQCFG, _t(xs), 6, tc)
    np.testing.assert_allclose(th.numpy(), np.asarray(jh), atol=HIDDEN_ATOL, rtol=0)


# --------------------------------------------------------------- init, trees


def test_mtp_heads_arrive_from_the_jax_tree_and_the_port_init_draws_them_last():
    jcfg, tcfg = _lm_cfgs(mtp=3)
    cfg = jcv.CosyVoiceConfig(lm=jcfg, flow=jcv.FlowConfig(token_vocab=V + 3, dim=32, layers=1,
                                                           heads=2),
                              vocoder=jcv.VocoderConfig(base_channels=32))
    params = jax.jit(lambda k: jcv.init_cosyvoice(k, cfg))(jax.random.PRNGKey(4))
    tp = tcv.from_jax_params(jax.tree.map(np.asarray, params), "cpu")
    assert len(tp["lm"]["mtp_heads"]) == 2
    for got, want in zip(tp["lm"]["mtp_heads"], params["lm"]["mtp_heads"]):
        for name in ("kernel", "bias"):
            assert tuple(got[name].shape) == want[name].shape
            np.testing.assert_array_equal(got[name].numpy(), np.asarray(want[name]))
    tcfg3 = tcv.CosyVoiceConfig(lm=tcfg, flow=tcv.FlowConfig(**_fields(cfg.flow)),
                                vocoder=tcv.VocoderConfig(**_fields(cfg.vocoder)))
    tcfg1 = dataclasses.replace(tcfg3, lm=dataclasses.replace(tcfg, mtp=1, spec_decode=False))
    p3, p1 = tcv.init_cosyvoice(7, tcfg3, "cpu"), tcv.init_cosyvoice(7, tcfg1, "cpu")
    heads = p3["lm"].pop("mtp_heads")
    assert [tuple(h["kernel"].shape) for h in heads] == [(64, V + 3)] * 2
    assert all(float(h["kernel"].abs().max()) <= 64 ** -0.5 and not h["bias"].any()
               for h in heads)
    assert "mtp_heads" not in p1["lm"]
    flat3, flat1 = jax.tree.leaves(jax.tree.map(np.asarray, p3)), jax.tree.leaves(
        jax.tree.map(np.asarray, p1))
    assert len(flat3) == len(flat1) and all(np.array_equal(a, b) for a, b in zip(flat3, flat1))


# ------------------------------------------------------------- accept-all MTP


@pytest.mark.parametrize("k_mtp,b", [(2, 1), (2, 3), (3, 1), (3, 3)])
def test_generate_mtp_matches_jax(k_mtp, b):
    """K tokens a pass, B rows with right-padded prompts, EOS-favouring
    heads: every row stops inside a block, and the tokens after its EOS in
    that block are EOS."""
    jcfg, tcfg = _lm_cfgs(mtp=k_mtp, spec=False)
    params, tparams = _lm_params(20 + k_mtp, jcfg, eos_bias=3.5)
    (jargs, targs) = _both(_inputs(5 + b, b=b, ragged=True))
    key = jax.random.PRNGKey(40 + b)
    kw = dict(max_new_tokens=31, min_new_tokens=3)
    want_t, want_l = _jit(jcv.generate_speech_tokens_mtp, jcfg, **kw)(params, key, *jargs)
    got_t, got_l = tcv.generate_speech_tokens_mtp(tparams, tcfg, JaxLmNoise(key, k_mtp),
                                                  *targs, **kw)
    assert got_t.dtype == torch.int32 and tuple(got_t.shape) == (b, 31)
    np.testing.assert_array_equal(got_t.numpy(), np.asarray(want_t))
    np.testing.assert_array_equal(got_l.numpy(), np.asarray(want_l))
    eos = jcfg.eos_speech
    toks = got_t.numpy()
    first = [int(np.argmax(row == eos)) if (row == eos).any() else None for row in toks]
    assert all(f is not None and f >= 3 for f in first)
    assert any(f % k_mtp != k_mtp - 1 for f in first)     # an EOS before a block's end
    assert all((row[f:] == eos).all() for row, f in zip(toks, first))


def test_generate_mtp_plain_weights_run_the_budget():
    jcfg, tcfg = _lm_cfgs(mtp=3, spec=False)
    params, tparams = _lm_params(11, jcfg)
    jargs, targs = _both(_inputs(3, b=2, ragged=True))
    key = jax.random.PRNGKey(12)
    want_t, _ = _jit(jcv.generate_speech_tokens_mtp, jcfg, max_new_tokens=20,
                     min_new_tokens=20)(params, key, *jargs)
    got_t, got_l = tcv.generate_speech_tokens_mtp(tparams, tcfg, JaxLmNoise(key, 3), *targs,
                                                  max_new_tokens=20, min_new_tokens=20)
    np.testing.assert_array_equal(got_t.numpy(), np.asarray(want_t))
    assert got_l.tolist() == [20, 20]
    with pytest.raises(ValueError, match="mtp > 1"):
        tcv.generate_speech_tokens_mtp(tparams, dataclasses.replace(tcfg, mtp=1),
                                       JaxLmNoise(key), *targs)


# ------------------------------------------------------- lossless speculative


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_spec_matches_jax_and_the_single_token_stream(seed):
    jcfg, tcfg = _lm_cfgs()
    params, tparams = _lm_params(seed + 10, jcfg)
    jargs, targs = _both(_inputs(seed))
    key = jax.random.PRNGKey(seed + 100)
    want_t, want_l, want_s = _jit(jcv.generate_speech_tokens_spec, jcfg, max_new_tokens=40,
                                  with_stats=True)(params, key, *jargs)
    got_t, got_l, stats = tcv.generate_speech_tokens_spec(tparams, tcfg, JaxLmNoise(key), *targs,
                                                          max_new_tokens=40, with_stats=True)
    np.testing.assert_array_equal(got_t.numpy(), np.asarray(want_t))
    np.testing.assert_array_equal(got_l.numpy(), np.asarray(want_l))
    assert stats == {"backbone_passes": int(want_s["backbone_passes"]),
                     "emitted": int(want_s["emitted"])}
    one_t, one_l = tcv.generate_speech_tokens(tparams, tcfg, JaxLmNoise(key), *targs,
                                              max_new_tokens=40)
    np.testing.assert_array_equal(got_t.numpy(), one_t.numpy())
    np.testing.assert_array_equal(got_l.numpy(), one_l.numpy())
    assert stats["backbone_passes"] <= max(stats["emitted"] - 1, 1)


@pytest.mark.parametrize("max_new", [1, 2, 5])
def test_spec_matches_the_single_token_stream_at_block_boundaries(max_new):
    jcfg, tcfg = _lm_cfgs()
    params, tparams = _lm_params(30, jcfg)
    jargs, targs = _both(_inputs(12))
    key = jax.random.PRNGKey(31)
    want_t, _ = _jit(jcv.generate_speech_tokens_spec, jcfg, max_new_tokens=max_new)(
        params, key, *jargs)
    got_t, got_l = tcv.generate_speech_tokens_spec(tparams, tcfg, JaxLmNoise(key), *targs,
                                                   max_new_tokens=max_new)
    one_t, _ = tcv.generate_speech_tokens(tparams, tcfg, JaxLmNoise(key), *targs,
                                          max_new_tokens=max_new)
    assert tuple(got_t.shape) == (1, max_new)
    np.testing.assert_array_equal(got_t.numpy(), np.asarray(want_t))
    np.testing.assert_array_equal(got_t.numpy(), one_t.numpy())


def test_spec_respects_min_new_tokens_and_stops_at_eos():
    """EOS-favouring heads with ``min_new_tokens`` 6: no EOS before token 6,
    then the stream stops where the single-token one does."""
    jcfg, tcfg = _lm_cfgs()
    params, tparams = _lm_params(5, jcfg, eos_bias=4.0)
    jargs, targs = _both(_inputs(3))
    key = jax.random.PRNGKey(6)
    kw = dict(max_new_tokens=24, min_new_tokens=6)
    want_t, want_l = _jit(jcv.generate_speech_tokens_spec, jcfg, **kw)(params, key, *jargs)
    got_t, got_l = tcv.generate_speech_tokens_spec(tparams, tcfg, JaxLmNoise(key), *targs, **kw)
    one_t, _ = tcv.generate_speech_tokens(tparams, tcfg, JaxLmNoise(key), *targs, **kw)
    np.testing.assert_array_equal(got_t.numpy(), np.asarray(want_t))
    np.testing.assert_array_equal(got_t.numpy(), one_t.numpy())
    assert 6 <= int(got_l[0]) < 24
    assert not np.isin(got_t.numpy(), [jcfg.sos_index, jcfg.task_index]).any()


def test_spec_accepts_whole_blocks_when_the_heads_agree():
    """Constant heads (zero kernel, one shared bias): draft and verifier
    logits agree at every position, so every pass emits K tokens."""
    jcfg, tcfg = _lm_cfgs()
    params = jcv.init_speech_lm(jax.random.PRNGKey(11), jcfg)
    bias = jax.random.normal(jax.random.PRNGKey(13), (V + 3,)) * 2.0
    head = {"kernel": jnp.zeros((64, V + 3)), "bias": bias}
    params = {**params, "head": head, "mtp_heads": [head, head]}
    tparams = _tree(params)
    jargs, targs = _both(_inputs(9))
    key = jax.random.PRNGKey(12)
    want_t, _, want_s = _jit(jcv.generate_speech_tokens_spec, jcfg, max_new_tokens=30,
                             with_stats=True)(params, key, *jargs)
    got_t, _, stats = tcv.generate_speech_tokens_spec(tparams, tcfg, JaxLmNoise(key), *targs,
                                                      max_new_tokens=30, with_stats=True)
    np.testing.assert_array_equal(got_t.numpy(), np.asarray(want_t))
    assert stats["backbone_passes"] == int(want_s["backbone_passes"])
    assert stats["emitted"] >= 2
    assert stats["backbone_passes"] <= -(-(stats["emitted"] - 1) // 3) + 1
    one_t, _ = tcv.generate_speech_tokens(tparams, tcfg, JaxLmNoise(key), *targs,
                                          max_new_tokens=30)
    np.testing.assert_array_equal(got_t.numpy(), one_t.numpy())


def test_spec_refuses_a_batch_and_a_config_without_heads():
    jcfg, tcfg = _lm_cfgs()
    _, tparams = _lm_params(7, jcfg)
    _, targs = _both(_inputs(2, b=2))
    with pytest.raises(ValueError, match="B=1"):
        tcv.generate_speech_tokens_spec(tparams, tcfg, JaxLmNoise(jax.random.PRNGKey(0)), *targs)
    _, targs = _both(_inputs(2))
    with pytest.raises(ValueError, match="mtp > 1"):
        tcv.generate_speech_tokens_spec(tparams, dataclasses.replace(tcfg, mtp=1),
                                        JaxLmNoise(jax.random.PRNGKey(0)), *targs)


# ------------------------------------------------------------------- routing


@pytest.mark.parametrize("mtp,spec,b,route", [
    (1, False, 1, "generate_speech_tokens"), (1, True, 1, "generate_speech_tokens"),
    (3, False, 1, "generate_speech_tokens_mtp"), (3, True, 1, "generate_speech_tokens_spec"),
    (3, True, 4, "generate_speech_tokens_mtp"),
])
def test_select_generator_routes_like_jax(mtp, spec, b, route):
    jcfg, tcfg = _lm_cfgs(mtp=mtp, spec=spec)
    assert tcv.select_generator(tcfg, b).__name__ == route
    assert jcv.select_generator(jcfg, b).__name__ == route


def test_synthesize_routes_b1_spec_to_the_lossless_stream():
    """``synthesize`` with spec at B = 1: its speech tokens equal the
    single-token generator's on the same noise, and JAX's synthesize's."""
    jcfg, tcfg = _lm_cfgs()
    cfg = jcv.CosyVoiceConfig(
        lm=jcfg,
        flow=jcv.FlowConfig(token_vocab=V + 3, dim=64, layers=1, heads=4, n_mels=8,
                            token_mel_ratio=2, spk_embed_dim=16, n_steps=2),
        vocoder=jcv.VocoderConfig(n_mels=8, base_channels=32, upsample_rates=(4, 4),
                                  upsample_kernels=(8, 8), resblock_kernels=(3,),
                                  resblock_dilations=((1, 2),)))
    tcfg_all = tcv.CosyVoiceConfig(lm=tcfg, flow=tcv.FlowConfig(**_fields(cfg.flow)),
                                   vocoder=tcv.VocoderConfig(**_fields(cfg.vocoder)))
    params = jcv.init_cosyvoice(jax.random.PRNGKey(21), cfg)
    tp = tcv.from_jax_params(jax.tree.map(np.asarray, params), "cpu")
    args = _inputs(15, tt=4, ts=6)
    jargs, targs = _both(args)
    key = jax.random.PRNGKey(22)
    k_lm, k_flow = jax.random.split(key)
    spk, pmel, pmm = np.zeros((1, 16), np.float32), np.zeros((1, 4, 8), np.float32), np.ones(
        (1, 4), bool)
    want = jax.jit(lambda p, k, *a: jcv.synthesize(p, cfg, k, *a, max_new_tokens=16))(
        params, key, *jargs, jnp.asarray(spk), jnp.asarray(pmel), jnp.asarray(pmm))

    class Noise(JaxLmNoise):
        def flow_x0(self, shape):
            return _t(jax.random.normal(k_flow, shape, jnp.float32))

    seen = []
    spec = tcv.generate_speech_tokens_spec

    def spy(*a, **kw):
        seen.append(True)
        return spec(*a, **kw)

    tcv.generate_speech_tokens_spec = spy
    try:
        got = tcv.synthesize(tp, tcfg_all, Noise(k_lm), *targs, _t(spk), _t(pmel), _t(pmm),
                             max_new_tokens=16)
    finally:
        tcv.generate_speech_tokens_spec = spec
    one_t, _ = tcv.generate_speech_tokens(tp["lm"], tcfg, Noise(k_lm), *targs, max_new_tokens=16)
    assert seen
    np.testing.assert_array_equal(got["speech_tokens"].numpy(), one_t.numpy())
    np.testing.assert_array_equal(got["speech_tokens"].numpy(), np.asarray(want["speech_tokens"]))
    np.testing.assert_allclose(got["audio"].numpy(), np.asarray(want["audio"]), atol=1e-4, rtol=0)


# ------------------------------------------------------------------ engines


HEADS2 = {"lm": {"mtp_heads": [object()]}}
RECONCILE_MTP = [  # (cfg_mtp, forced, params, width, warns)
    (1, 0, None, 1, False), (3, 0, None, 3, False), (1, 3, None, 3, False),
    (3, 1, None, 1, False), (3, 2, None, 2, False), (1, 0, HEADS2, 1, False),
    (2, 0, HEADS2, 2, False), (1, 3, HEADS2, 2, True), (1, 2, {"lm": {}}, 1, True),
    (4, 0, {}, 1, True),
]


@pytest.mark.parametrize("cfg_mtp,forced,params,width,warns", RECONCILE_MTP)
def test_reconcile_mtp_follows_jax(caplog, cfg_mtp, forced, params, width, warns):
    """The forced width beats the config, 0 is unset, ``params=None``
    honours the width, a tree takes its own head count (single-token
    without heads), with JAX's warnings."""
    with caplog.at_level(logging.WARNING):
        got = teng._reconcile_mtp(cfg_mtp, forced, params)
    assert got == jeng._reconcile_mtp(cfg_mtp, forced, params) == width
    assert any("mtp=" in r.getMessage() for r in caplog.records) == warns


@pytest.mark.parametrize("forced,cfg_spec,width,want,warns", [
    (False, False, 3, False, False), (True, False, 3, True, False),
    (False, True, 3, True, False), (True, False, 1, False, True),
    (False, True, 1, False, True), (False, False, 1, False, False),
])
def test_reconcile_spec_follows_jax(caplog, forced, cfg_spec, width, want, warns):
    with caplog.at_level(logging.WARNING):
        got = teng._reconcile_spec(forced, cfg_spec, width)
    assert got == jeng._reconcile_spec(forced, cfg_spec, width) == want
    assert any("tts_spec" in r.getMessage() for r in caplog.records) == warns


TINY_TTS = tcv.CosyVoiceConfig(
    lm=tcv.SpeechLMConfig(backbone=tq2.Qwen2Config(hidden=32, layers=1, heads=2, kv_heads=1,
                                                   ffn_dim=64, max_positions=1024),
                          text_vocab=384, speech_token_size=32),
    flow=tcv.FlowConfig(token_vocab=35, dim=32, layers=1, heads=2, n_steps=2),
    vocoder=tcv.VocoderConfig(base_channels=32))


def test_tts_engine_honours_mtp_and_spec(caplog):
    """A random engine asked for mtp=3 draws its two heads and synthesizes
    through accept-all MTP (a batch) and spec (one request); a tree without
    heads falls back to single-token with a warning; spec without width is
    off."""
    kw = dict(device="cpu", dtype=torch.float32, seconds_per_char=0.02)
    tts = teng.TorchCosyVoiceTts(TINY_TTS, mtp=3, spec=True, **kw)
    assert (tts.cfg.lm.mtp, tts.cfg.lm.spec_decode) == (3, True)
    assert len(tts.params["lm"]["mtp_heads"]) == 2
    assert tts.synthesize("spec decode").size > 0
    outs = tts.synthesize_batch([{"text": "first one"}, {"text": "second"}])
    assert len(outs) == 2 and all(o.size > 0 and np.isfinite(o).all() for o in outs)
    plain = teng.TorchCosyVoiceTts(TINY_TTS, **kw)
    with caplog.at_level(logging.WARNING):
        headless = teng.TorchCosyVoiceTts(TINY_TTS, plain.params, mtp=3, spec=True, **kw)
    assert (headless.cfg.lm.mtp, headless.cfg.lm.spec_decode) == (1, False)
    assert "mtp_heads" not in headless.params["lm"]
    messages = " ".join(r.getMessage() for r in caplog.records)
    assert "no mtp_heads" in messages and "tts_spec requested" in messages
