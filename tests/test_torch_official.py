"""The port's official CosyVoice2 chain against the JAX package's on the CPU:
the matcha flow (``flow_matcha``), the HiFT vocoder (``hift``), the chain
offline and streamed (``cosyvoice_official``), the three checkpoint
converters with the port's emitters, and the ``.pt`` loaders.

Both sides take the same seeded JAX tree at ``tiny()`` sizes (the port's
through ``from_jax_params``), and the port takes the JAX key schedule's own
noise: offline, ``split(key, 3)`` into (LM, flow, HiFT), the LM drawing step
i at ``fold_in(k_lm, i)`` split in two, the HiFT key split into (phases,
noise); streamed, ``split(key, 2 n_chunks + 1)`` into the chunks' LM keys,
their HiFT keys and the flow key, which is folded with the prefix bucket.
Speech tokens must be exact; f32 tolerances are stated beside each check.
"""

import dataclasses

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from expressive_speech_translation_tpu.models import cosyvoice_official as jco
from expressive_speech_translation_tpu.models import flow_matcha as jfm
from expressive_speech_translation_tpu.models import hift as jhm
from expressive_speech_translation_tpu_torch.models import cosyvoice as tcv
from expressive_speech_translation_tpu_torch.models import cosyvoice_official as tco
from expressive_speech_translation_tpu_torch.models import flow_matcha as tfm
from expressive_speech_translation_tpu_torch.models import hift as thm
from expressive_speech_translation_tpu_torch.models import qwen2 as tq2

CPU = "cpu"
FLOW_ATOL = 1e-4      # mel after two Euler steps of the estimator (f32 summation order)
AUDIO_ATOL = 1e-4     # HiFT waveform, |x| ≤ 0.99


def _fields(cfg):
    return {f: getattr(cfg, f) for f in cfg.__dataclass_fields__}


def _np(tree):
    return jax.tree.map(np.array, tree)


def _t(a):
    return torch.from_numpy(np.array(a))


def port_cfg(jcfg: jco.OfficialTtsConfig) -> tco.OfficialTtsConfig:
    """The port's config of the same values as a JAX one."""
    lm = jcfg.lm
    return tco.OfficialTtsConfig(
        lm=tcv.SpeechLMConfig(**{**{f: v for f, v in _fields(lm).items()
                                    if f in tcv.SpeechLMConfig.__dataclass_fields__},
                                 "backbone": tq2.Qwen2Config(**_fields(lm.backbone))}),
        flow=tfm.OfficialFlowConfig(**{
            **_fields(jcfg.flow),
            "encoder": tfm.UpsampleConformerConfig(**_fields(jcfg.flow.encoder)),
            "estimator": tfm.CausalDecoderConfig(**_fields(jcfg.flow.estimator))}),
        hift=thm.HiFTConfig(**_fields(jcfg.hift)), sample_rate=jcfg.sample_rate)


JTINY = jco.OfficialTtsConfig.tiny()
TINY = port_cfg(JTINY)
# the tiny triple at the conditioning models' widths (80 mels, 192-wide
# x-vectors) and the byte tokenizer's text vocabulary, for the engines
JCLONE = dataclasses.replace(
    JTINY, lm=dataclasses.replace(JTINY.lm, text_vocab=384),
    flow=dataclasses.replace(JTINY.flow, output_size=80, spk_embed_dim=192,
                             estimator=dataclasses.replace(JTINY.flow.estimator,
                                                           in_channels=320, out_channels=80)),
    hift=dataclasses.replace(JTINY.hift, in_channels=80))
CLONE = port_cfg(JCLONE)


# ------------------------------------------------------------------- noise


def _gumbel_pair(key, shape):
    k1, k2 = jax.random.split(key)
    return (_t(jax.random.gumbel(k1, shape, jnp.float32)),
            _t(jax.random.gumbel(k2, shape, jnp.float32)))


def _hift_draws(key, phase_shape, noise_shape):
    k1, k2 = jax.random.split(key)
    return (_t(jax.random.uniform(k1, phase_shape, jnp.float32, -np.pi, np.pi)),
            _t(jax.random.normal(k2, noise_shape, jnp.float32)))


class HiftKeyNoise:
    """``hift.harmonic_source``'s draws from one JAX key."""

    def __init__(self, key):
        self.key = key

    def hift_source(self, phase_shape, noise_shape):
        return _hift_draws(self.key, phase_shape, noise_shape)


class _JaxOfficialChunk:
    """A stream chunk: its LM key split in a chain a step, its HiFT key."""

    def __init__(self, k_lm, k_src):
        self.key, self.k_src, self.subkeys = k_lm, k_src, []

    def ras_gumbel(self, step, shape):
        while len(self.subkeys) <= step:
            self.key, sk = jax.random.split(self.key)
            self.subkeys.append(sk)
        return _gumbel_pair(self.subkeys[step], shape)

    def hift_source(self, phase_shape, noise_shape):
        return _hift_draws(self.k_src, phase_shape, noise_shape)


class JaxOfficialNoise:
    """The JAX key schedule of ``synthesize_official`` (offline) and of
    ``synthesize_streaming_official`` (``chunk`` / ``flow_x0_prefix``) for
    one key."""

    def __init__(self, key):
        self.key = key
        self.k_lm, self.k_flow, self.k_hift = jax.random.split(key, 3)
        self.stream_keys = None

    def ras_gumbel(self, step, shape):
        return _gumbel_pair(jax.random.fold_in(self.k_lm, step), shape)

    def flow_x0(self, shape):
        return _t(jax.random.normal(self.k_flow, shape, jnp.float32))

    def hift_source(self, phase_shape, noise_shape):
        return _hift_draws(self.k_hift, phase_shape, noise_shape)

    def chunk(self, index, count):
        self.stream_keys = np.asarray(jax.random.split(self.key, 2 * count + 1))
        return _JaxOfficialChunk(self.stream_keys[index], self.stream_keys[count + index])

    def flow_x0_prefix(self, bucket, shape):
        key = jax.random.fold_in(jnp.asarray(self.stream_keys[-1]), bucket)
        return _t(jax.random.normal(key, shape, jnp.float32))


class EngineNoise(JaxOfficialNoise):
    """The JAX TTS engine's noise for synthesis call ``n``."""

    def __init__(self, n):
        super().__init__(jax.random.fold_in(jax.random.PRNGKey(42), jnp.uint32(n)))


# ----------------------------------------------------------------- weights


@pytest.fixture(scope="module")
def tiny():
    """(JAX tree, port tree) of the tiny official triple."""
    tree = _np(jco.init_official_tts(jax.random.PRNGKey(0), JTINY))
    return tree, tco.from_jax_params(tree, CPU)


def _jp(tree):
    return jax.tree.map(jnp.asarray, tree)


# the JAX functions compiled once for the file (op by op they take ~10 s a call)
_jflow = jax.jit(jfm.flow_inference, static_argnames=("cfg",))
_jsynth = jax.jit(jco.synthesize_official,
                  static_argnames=("cfg", "max_new_tokens", "min_new_tokens",
                                   "deterministic_source"))
_jdecode = jax.jit(jhm.hift_decode, static_argnames=("cfg",))


# ---------------------------------------------------------------- the flow


def test_rel_pos_table_and_shift_match_jax():
    np.testing.assert_array_equal(
        tfm._rel_pos_encoding(5, 8, torch.float32, CPU).numpy(),
        np.asarray(jfm._rel_pos_encoding(5, 8, jnp.float32)))
    x = np.random.default_rng(0).standard_normal((2, 3, 4, 7)).astype(np.float32)
    np.testing.assert_array_equal(tfm._rel_shift(_t(x)).numpy(),
                                  np.asarray(jfm._rel_shift(jnp.asarray(x))))


def test_conformer_encoder_matches_jax(tiny):
    """Two rows, the second padded after 4 of 6 tokens: both the valid and
    the padded positions agree (the encoder masks before and after its
    lookahead conv). f32 within 1e-5."""
    tree, params = tiny
    g = np.random.default_rng(1)
    x = g.standard_normal((2, 6, 32)).astype(np.float32)
    mask = np.ones((2, 6), bool)
    mask[1, 4:] = False
    want, wmask = jfm.upsample_conformer_encode(_jp(tree["flow"]["encoder"]), JTINY.flow.encoder,
                                                jnp.asarray(x), jnp.asarray(mask))
    got, gmask = tfm.upsample_conformer_encode(params["flow"]["encoder"], TINY.flow.encoder,
                                               _t(x), _t(mask))
    np.testing.assert_array_equal(gmask.numpy(), np.asarray(wmask))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=1e-5, rtol=0)


def test_estimator_matches_jax(tiny):
    """The causal U-Net's velocity on random inputs with a padded row. f32
    within 1e-5."""
    tree, params = tiny
    g = np.random.default_rng(2)
    b, t, m = 2, 10, 8
    x, mu, cond = (g.standard_normal((b, t, m)).astype(np.float32) for _ in range(3))
    spk = g.standard_normal((b, m)).astype(np.float32)
    tt = np.array([0.25, 0.6], np.float32)
    mask = np.ones((b, t), bool)
    mask[0, 7:] = False
    want = jfm.causal_decoder_estimator(_jp(tree["flow"]["estimator"]), JTINY.flow.estimator,
                                        *map(jnp.asarray, (x, tt, mu, spk, cond, mask)))
    got = tfm.causal_decoder_estimator(params["flow"]["estimator"], TINY.flow.estimator,
                                       *map(_t, (x, tt, mu, spk, cond, mask)))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=1e-5, rtol=0)


def _flow_batch():
    """Two rows whose prompts differ in length (3 and 1 of 3 slots valid),
    generated tokens 5 and 3 of 5, the prompt mel end-padded."""
    g = np.random.default_rng(3)
    tokens = g.integers(0, 64, (2, 5)).astype(np.int32)
    tmask = np.array([[True] * 5, [True] * 3 + [False] * 2])
    ptok = g.integers(0, 64, (2, 3)).astype(np.int32)
    pmask = np.array([[True] * 3, [True] + [False] * 2])
    pfeat = g.standard_normal((2, 6, 8)).astype(np.float32)
    pfeat[1, 2:] = 0.0
    spk = g.standard_normal((2, 16)).astype(np.float32)
    return tokens, tmask, ptok, pmask, pfeat, spk


def test_flow_inference_matches_jax_with_prompts_of_different_lengths(tiny):
    """Per-row prompt compaction and the per-row prompt strip: the generated
    mel and its mask. f32 within FLOW_ATOL."""
    tree, params = tiny
    key = jax.random.PRNGKey(5)
    inputs = _flow_batch()
    want, wmask = _jflow(_jp(tree["flow"]), JTINY.flow, key, *map(jnp.asarray, inputs))
    got, gmask = tfm.flow_inference(params["flow"], TINY.flow,
                                    lambda shape: _t(jax.random.normal(key, shape, jnp.float32)),
                                    *map(_t, inputs))
    np.testing.assert_array_equal(gmask.numpy(), np.asarray(wmask))
    assert got.shape == (2, 10, 8)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=FLOW_ATOL, rtol=0)


# ------------------------------------------------------------------ HiFT


def test_small_stft_and_its_inverse_match_jax():
    x = np.random.default_rng(4).standard_normal((2, 96)).astype(np.float32)
    wr, wi = jhm.stft_small(jnp.asarray(x), 16, 4)
    gr, gi = thm.stft_small(_t(x), 16, 4)
    np.testing.assert_allclose(gr.numpy(), np.asarray(wr), atol=1e-6, rtol=0)
    np.testing.assert_allclose(gi.numpy(), np.asarray(wi), atol=1e-6, rtol=0)
    np.testing.assert_allclose(thm.istft_small(gr, gi, 16, 4).numpy(),
                               np.asarray(jhm.istft_small(wr, wi, 16, 4)), atol=1e-6, rtol=0)


def test_conv_transpose_refuses_an_odd_kernel_minus_stride():
    p = {"kernel": torch.zeros((4, 4, 6)), "bias": torch.zeros(4)}
    with pytest.raises(NotImplementedError, match="even kernel-stride, got k=6 s=3"):
        thm._conv_transpose1d(p, torch.zeros((1, 4, 5)), 3)
    with pytest.raises(NotImplementedError, match="even kernel-stride, got k=6 s=3"):
        jhm._conv_transpose1d({"kernel": jnp.zeros((6, 4, 4)), "bias": jnp.zeros(4)},
                              jnp.zeros((1, 5, 4)), 3)


def _mel(b=2, t=12, seed=6):
    return (0.5 * np.random.default_rng(seed).standard_normal((b, t, 8))).astype(np.float32)


def test_f0_predictor_matches_jax(tiny):
    tree, params = tiny
    mel = _mel()
    want = jhm.f0_predict(_jp(tree["hift"]), JTINY.hift, jnp.asarray(mel))
    got = thm.f0_predict(params["hift"], TINY.hift, _t(mel))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=1e-5, rtol=0)


def _f0_track(frames=12):
    """Voiced frames at 80–300 Hz and two unvoiced ones (≤ 10 Hz)."""
    f0 = np.linspace(80.0, 300.0, frames, dtype=np.float32)[None].repeat(2, 0)
    f0[1, 3:5] = 4.0
    return f0


@pytest.mark.parametrize("deterministic", [True, False])
def test_harmonic_source_matches_jax(tiny, deterministic):
    """Deterministic, and with JAX's phases and noise injected. The phase
    sums of the two sides differ by summation order (torch's cumsum against
    XLA's): within 2e-4 over 12 frames of 480 samples."""
    tree, params = tiny
    key = jax.random.PRNGKey(7)
    f0 = _f0_track()
    want = jhm.harmonic_source(_jp(tree["hift"]), JTINY.hift, key, jnp.asarray(f0),
                               deterministic=deterministic)
    got = thm.harmonic_source(params["hift"], TINY.hift, HiftKeyNoise(key), _t(f0),
                              deterministic=deterministic)
    assert got.shape == (2, 12 * 480, 1) and got.dtype == torch.float32
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=2e-4, rtol=0)


def test_hift_decode_matches_jax(tiny):
    tree, params = tiny
    mel = _mel()
    src = (0.1 * np.random.default_rng(8).standard_normal((2, 12 * 480, 1))).astype(np.float32)
    want = _jdecode(_jp(tree["hift"]), JTINY.hift, jnp.asarray(mel), jnp.asarray(src))
    got = thm.hift_decode(params["hift"], TINY.hift, _t(mel), _t(src))
    assert got.shape == (2, 12 * 480)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=AUDIO_ATOL, rtol=0)


@pytest.mark.parametrize("deterministic", [True, False])
def test_hift_inference_with_a_frame_mask_matches_jax(tiny, deterministic):
    """A padded batch: the second row's last 4 frames masked, its pad
    samples zero on both sides."""
    tree, params = tiny
    key = jax.random.PRNGKey(9)
    mel = _mel(seed=10)
    fmask = np.ones((2, 12), bool)
    fmask[1, 8:] = False
    want = jhm.hift_inference(_jp(tree["hift"]), JTINY.hift, key, jnp.asarray(mel),
                              deterministic=deterministic, frame_mask=jnp.asarray(fmask))
    got = thm.hift_inference(params["hift"], TINY.hift, HiftKeyNoise(key), _t(mel),
                             deterministic=deterministic, frame_mask=_t(fmask))
    assert not got[1, 8 * 480:].any()
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=AUDIO_ATOL, rtol=0)


def test_the_bf16_source_keeps_its_phase_where_jax_freezes_it(tiny):
    """One 1.5 s f0 track of bf16-representable values (a 200 Hz tone), given
    to both dtypes as it is, through a merge that reads the fundamental alone
    at a gain of 10 (so the source swings ±0.76). JAX integrates the phase in
    bf16: past 128 cycles the sum keeps no fraction, and its bf16 source
    departs from its f32 source by more than 0.5 after one second. The port
    integrates in f32 in both, so its bf16 source stays within 1e-2 of its
    f32 source (the bf16 rounding of the output); its f32 source is JAX's
    within 2e-4 over the first 9600 samples."""
    tree, params = tiny
    f0 = np.full((1, 36_000 // JTINY.hift.hop), 200.0, np.float32)
    assert (torch.from_numpy(f0).to(torch.bfloat16).float().numpy() == f0).all()
    merge = np.zeros((JTINY.hift.nb_harmonics + 1, 1), np.float32)
    merge[0, 0] = 10.0
    jtree = _jp({**tree["hift"], "m_source": {"l_linear": {"kernel": merge,
                                                          "bias": np.zeros(1, np.float32)}}})
    jsrc = {dt: np.asarray(jhm.harmonic_source(
        jax.tree.map(lambda a: a.astype(dt), jtree), JTINY.hift, jax.random.PRNGKey(0),
        jnp.asarray(f0, dt), deterministic=True), np.float32)
        for dt in (jnp.float32, jnp.bfloat16)}
    assert np.abs(jsrc[jnp.bfloat16] - jsrc[jnp.float32])[0, 24_000:].max() > 0.5
    tparams = {**params["hift"], "m_source": {"l_linear": {"kernel": _t(merge),
                                                          "bias": torch.zeros(1)}}}
    tsrc = {dt: thm.harmonic_source(_cast(tparams, dt), TINY.hift, None,
                                    torch.from_numpy(f0).to(dt), deterministic=True)
            for dt in (torch.float32, torch.bfloat16)}
    assert tsrc[torch.bfloat16].dtype == torch.bfloat16
    assert float(tsrc[torch.float32].abs().max()) > 0.7
    assert float((tsrc[torch.bfloat16].float() - tsrc[torch.float32]).abs().max()) <= 1e-2
    np.testing.assert_allclose(tsrc[torch.float32].numpy()[0, :9600],
                               jsrc[jnp.float32][0, :9600], atol=2e-4, rtol=0)


def _cast(tree, dtype):
    from expressive_speech_translation_tpu_torch.models.common import cast_floats

    return cast_floats(tree, dtype)


# ------------------------------------------------------------- the chain


def _tts_inputs(b=2):
    """Text [b, 6] (row 1 ends after 4), prompt speech tokens [b, 3] (row 1
    keeps 1), x-vectors [b, 16], the prompt mel [b, 6, 8] (end-padded)."""
    g = np.random.default_rng(11)
    text = g.integers(0, 128, (b, 6)).astype(np.int32)
    tmask = np.ones((b, 6), bool)
    psp = g.integers(0, 61, (b, 3)).astype(np.int32)
    psm = np.ones((b, 3), bool)
    pmel = g.standard_normal((b, 6, 8)).astype(np.float32)
    if b > 1:
        tmask[1, 4:] = False
        psm[1, 1:] = False
        pmel[1, 2:] = 0.0
    spk = g.standard_normal((b, 16)).astype(np.float32)
    return text, tmask, psp, psm, spk, pmel


def _eos_tree(tree, bias):
    out = jax.tree.map(np.array, tree)
    out["lm"]["head"]["bias"][JTINY.lm.eos_speech] += bias
    return out


@pytest.mark.parametrize("eos_bias", [0.0, 1.0])
def test_synthesize_official_matches_jax(tiny, eos_bias):
    """A batch of two rows whose texts and prompts differ in length; with the
    EOS-favoured head the rows stop at different lengths. Tokens exact,
    audio within AUDIO_ATOL, mel within FLOW_ATOL; every key of JAX's
    result."""
    tree = _eos_tree(tiny[0], eos_bias)
    params = tco.from_jax_params(tree, CPU)
    key = jax.random.PRNGKey(12)
    inputs = _tts_inputs()
    want = _jsynth(_jp(tree), JTINY, key, *map(jnp.asarray, inputs), max_new_tokens=8,
                   min_new_tokens=2)
    got = tco.synthesize_official(params, TINY, JaxOfficialNoise(key), *map(_t, inputs),
                                  max_new_tokens=8, min_new_tokens=2)
    assert set(got) == set(want)
    np.testing.assert_array_equal(got["speech_tokens"].numpy(), np.asarray(want["speech_tokens"]))
    np.testing.assert_array_equal(got["token_lengths"].numpy(), np.asarray(want["token_lengths"]))
    np.testing.assert_array_equal(got["frame_mask"].numpy(), np.asarray(want["frame_mask"]))
    if eos_bias:
        assert len(set(got["token_lengths"].tolist())) == 2
    np.testing.assert_allclose(got["mel"].numpy(), np.asarray(want["mel"]), atol=FLOW_ATOL, rtol=0)
    np.testing.assert_allclose(got["audio"].numpy(), np.asarray(want["audio"]), atol=AUDIO_ATOL,
                               rtol=0)


def _stream(fn, params, cfg, noise, inputs, **kw):
    return list(fn(params, cfg, noise, *inputs, chunk_tokens=4, mel_cache_frames=3,
                   fade_samples=256, **kw))


@pytest.mark.parametrize("case", ["whole_chunks_past_the_budget", "eos_inside_a_chunk"])
def test_synthesize_streaming_official_matches_jax(tiny, case):
    """Chunks of 4 tokens. With EOS held down, a budget of 10 runs three whole
    chunks (12 tokens: the LM runs whole chunks, as JAX's does); with an
    EOS-favoured head and ``min_new_tokens`` 6 the EOS falls inside chunk 1,
    whose 2 tokens make a short last chunk. Each yielded chunk within
    AUDIO_ATOL; the samples add up to the tokens × samples per token."""
    bias, kw, n_want = {
        "whole_chunks_past_the_budget": (-8.0, dict(max_new_tokens=10, min_new_tokens=2), 12),
        "eos_inside_a_chunk": (8.0, dict(max_new_tokens=12, min_new_tokens=6), 6)}[case]
    tree = _eos_tree(tiny[0], bias)
    params = tco.from_jax_params(tree, CPU)
    key = jax.random.PRNGKey(13)
    inputs = _tts_inputs(b=1)
    want = _stream(jco.synthesize_streaming_official, _jp(tree), JTINY, key,
                   list(map(jnp.asarray, inputs)), **kw)
    got = _stream(tco.synthesize_streaming_official, params, TINY, JaxOfficialNoise(key),
                  list(map(_t, inputs)), **kw)
    assert [len(c) for c in got] == [len(c) for c in want]
    hop_tok = JTINY.flow.token_mel_ratio * JTINY.hift.hop
    n_tok = sum(len(c) for c in got) // hop_tok
    assert sum(len(c) for c in got) == n_tok * hop_tok
    assert n_tok == n_want
    for g, w in zip(got, want):
        np.testing.assert_allclose(g, w, atol=AUDIO_ATOL, rtol=0)


def test_streaming_official_is_single_stream(tiny):
    with pytest.raises(ValueError, match="single-stream"):
        next(tco.synthesize_streaming_official(tiny[1], TINY, tcv.GeneratorNoise(0, CPU),
                                               *map(_t, _tts_inputs(b=2))))


def test_bf16_follows_the_jax_dtype_rules(tiny):
    """A bf16 flow keeps its encoder and ODE state in f32 and gives an f32
    mel, as JAX's does (numpy scalars promote); a bf16 HiFT takes its
    log-magnitudes to f32 before the exp (the clip's numpy bound) and gives
    an f32 waveform: within 1e-4 of JAX's bf16 waveform (2e-3 peak), where a
    bf16 exp would part by 1e-3."""
    from expressive_speech_translation_tpu.models.common import cast_floats as jcast

    tree, params = tiny
    key = jax.random.PRNGKey(5)
    tok, tmask, ptok, pmask, pfeat, spk = _flow_batch()
    want, _ = _jflow(jcast(_jp(tree["flow"]), jnp.bfloat16), JTINY.flow, key, tok, tmask, ptok,
                     pmask, jnp.asarray(pfeat, jnp.bfloat16), jnp.asarray(spk, jnp.bfloat16))
    got, _ = tfm.flow_inference(_cast(params["flow"], torch.bfloat16), TINY.flow,
                                lambda shape: _t(jax.random.normal(key, shape, jnp.float32)),
                                *map(_t, (tok, tmask, ptok, pmask)),
                                _t(pfeat).bfloat16(), _t(spk).bfloat16())
    assert want.dtype == jnp.float32 and got.dtype == torch.float32
    mel = np.asarray(want)
    src = (0.01 * np.random.default_rng(8).standard_normal((2, 10 * 480, 1))).astype(np.float32)
    jwave = _jdecode(jcast(_jp(tree["hift"]), jnp.bfloat16), JTINY.hift, jnp.asarray(mel),
                     jnp.asarray(src, jnp.bfloat16))
    wave = thm.hift_decode(_cast(params["hift"], torch.bfloat16), TINY.hift, _t(mel),
                           _t(src).bfloat16())
    assert jwave.dtype == jnp.float32 and wave.dtype == torch.float32
    np.testing.assert_allclose(wave.numpy(), np.asarray(jwave), atol=1e-4, rtol=0)
