"""The port's voice-prompt conditioning against the JAX package on the CPU.

Kaldi fbank, the 16 → 24 kHz resampler, the ECAPA speaker embedding and the
FSQ speech tokenizer, on the same inputs (numpy seed) and the same weights
(the JAX models' trees through each port model's ``from_jax_params``).
Tolerances: fbank 1e-4 in the ln domain for bands within 50 dB of their
frame's peak (f32 DFT sums over up to 1920 products in another order, then
ln), and every band's energy within 2e-6 of its frame's peak energy (the
weakest bands are f32 cancellation residue on both sides); the resampler
1e-5 (274-tap f32 FIR); ECAPA 1e-5 on the unit-norm embedding (a few f32
convs deep at these widths); FSQ ids token-exact.
"""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from expressive_speech_translation_tpu.models import ecapa as jec
from expressive_speech_translation_tpu.models import speech_tokenizer as jst
from expressive_speech_translation_tpu.models.common import host_init
from expressive_speech_translation_tpu.ops import kaldi_fbank as jax_kaldi_fbank
from expressive_speech_translation_tpu.ops import resample as jax_resample
from expressive_speech_translation_tpu.ops.windows import povey as jax_povey
from expressive_speech_translation_tpu_torch.models import ecapa as tec
from expressive_speech_translation_tpu_torch.models import speech_tokenizer as tst
from expressive_speech_translation_tpu_torch.ops.mel import kaldi_fbank
from expressive_speech_translation_tpu_torch.ops.resample import resample
from expressive_speech_translation_tpu_torch.ops.windows import povey

CPU = torch.device("cpu")
FBANK_ATOL = 1e-4
FBANK_PEAK_RTOL = 2e-6
RESAMPLE_ATOL = 1e-5
ECAPA_ATOL = 1e-5
JEC_CFG = jec.EcapaConfig(channels=32, mfa_out=96, bottleneck=16, attn_channels=16)
TEC_CFG = tec.EcapaConfig(**{f: getattr(JEC_CFG, f) for f in JEC_CFG.__dataclass_fields__})
JST_CFG = jst.SpeechTokenizerConfig(dim=32, layers=1, heads=4)
TST_CFG = tst.SpeechTokenizerConfig(**{f: getattr(JST_CFG, f) for f in JST_CFG.__dataclass_fields__})


def _np(tree):
    return jax.tree.map(np.asarray, tree)


def _speechlike(seconds, seed, sr):
    g = np.random.default_rng(seed)
    t = np.arange(int(sr * seconds)) / sr
    x = (0.4 * np.sin(2 * np.pi * 220 * t) + 0.2 * np.sin(2 * np.pi * 880 * t + 1.0)
         + 0.02 * g.standard_normal(t.shape))
    x *= 0.5 + 0.5 * np.sin(2 * np.pi * 3.0 * t) ** 2
    return x.astype(np.float32)


def test_povey_window_matches():
    for n in (400, 960, 1920):
        np.testing.assert_array_equal(povey(n), jax_povey(n))


@pytest.mark.parametrize("sr,frame_ms,shift_ms", [(16_000, 25.0, 10.0), (24_000, 80.0, 20.0),
                                                  (24_000, 40.0, 20.0)])
def test_kaldi_fbank_matches_jax(sr, frame_ms, shift_ms):
    x = np.stack([_speechlike(1.3, seed=s, sr=sr) for s in (1, 2)])
    want = np.asarray(jax_kaldi_fbank(jnp.asarray(x), sr=sr, frame_length_ms=frame_ms,
                                      frame_shift_ms=shift_ms))
    got = kaldi_fbank(torch.from_numpy(x), sr=sr, frame_length_ms=frame_ms,
                      frame_shift_ms=shift_ms).numpy()
    assert got.shape == want.shape and got.shape[-1] == 80
    # bands within 50 dB of their frame's peak: 1e-4 in the ln domain. The
    # lowest bands sit 60-85 dB down after pre-emphasis, where the f32 DFT's
    # sum cancels to a few f32 roundings of the frame's scale (the JAX
    # version is itself 2e-4 in ln from a float64 DFT there): every band's
    # energy is held to FBANK_PEAK_RTOL of its frame's peak energy.
    peak = want.max(axis=-1, keepdims=True)
    strong = want > peak + np.log(1e-5)
    np.testing.assert_allclose(got[strong], want[strong], atol=FBANK_ATOL, rtol=0)
    assert (np.abs(np.exp(got) - np.exp(want)) <= FBANK_PEAK_RTOL * np.exp(peak)).all()


def test_kaldi_fbank_refuses_dither():
    with pytest.raises(NotImplementedError, match="dither"):
        kaldi_fbank(torch.zeros(4800), dither=1.0)


@pytest.mark.parametrize("n", [16_000, 16_001, 24_117])
def test_resample_16k_to_24k_matches_jax(n):
    x = _speechlike(n / 16_000, seed=3, sr=16_000)[:n]
    want = np.asarray(jax_resample(jnp.asarray(x), 16_000, 24_000))
    got = resample(torch.from_numpy(x), 16_000, 24_000).numpy()
    assert got.shape == want.shape == (-(-n * 3 // 2),)
    np.testing.assert_allclose(got, want, atol=RESAMPLE_ATOL, rtol=0)


@pytest.fixture(scope="module")
def ecapa_pair():
    jp = host_init(jec.init_ecapa, 7, JEC_CFG)
    tree = _np(jp)
    # non-trivial BatchNorm statistics, so the running-stats path is exercised
    g = np.random.default_rng(11)

    def perturb(node):
        if isinstance(node, dict):
            if set(node) == {"scale", "bias", "mean", "var"}:
                n = node["scale"].shape[0]
                node.update(scale=1 + 0.1 * g.standard_normal(n).astype(np.float32),
                            bias=0.1 * g.standard_normal(n).astype(np.float32),
                            mean=0.1 * g.standard_normal(n).astype(np.float32),
                            var=(1 + 0.2 * g.random(n)).astype(np.float32))
            else:
                for v in node.values():
                    perturb(v)
        elif isinstance(node, list):
            for v in node:
                perturb(v)

    tree = jax.tree.map(np.array, tree)
    perturb(tree)
    return jax.tree.map(jnp.asarray, tree), tec.from_jax_params(tree, CPU)


def test_ecapa_embed_audio_matches_jax(ecapa_pair):
    jp, tp = ecapa_pair
    x = np.stack([_speechlike(1.2, seed=s, sr=16_000) for s in (4, 5)])
    want = np.asarray(jec.embed_audio(jp, JEC_CFG, jnp.asarray(x)))
    got = tec.embed_audio(tp, TEC_CFG, torch.from_numpy(x)).numpy()
    assert got.shape == want.shape == (2, JEC_CFG.embed_dim)
    np.testing.assert_allclose(got, want, atol=ECAPA_ATOL, rtol=0)
    np.testing.assert_allclose(np.linalg.norm(got, axis=-1), 1.0, atol=1e-6)
    score = tec.cosine_similarity(torch.from_numpy(got[:1]), torch.from_numpy(got[1:]))
    want_score = jec.cosine_similarity(jnp.asarray(want[:1]), jnp.asarray(want[1:]))
    np.testing.assert_allclose(score.numpy(), np.asarray(want_score), atol=ECAPA_ATOL)


def test_ecapa_masked_frames_are_ignored(ecapa_pair):
    """A padded batch row embeds as its unpadded self (masked mean, SE gate,
    -inf attention mask), as in the JAX model."""
    jp, tp = ecapa_pair
    g = np.random.default_rng(6)
    feats = g.standard_normal((2, 60, 80)).astype(np.float32)
    mask = np.ones((2, 60), bool)
    mask[1, 41:] = False
    want = np.asarray(jec.embed(jp, JEC_CFG, jnp.asarray(feats), jnp.asarray(mask)))
    got = tec.embed(tp, TEC_CFG, torch.from_numpy(feats), torch.from_numpy(mask)).numpy()
    np.testing.assert_allclose(got, want, atol=ECAPA_ATOL, rtol=0)


def test_speech_tokenizer_ids_token_exact():
    jp = host_init(jst.init_speech_tokenizer, 8, JST_CFG)
    tp = tst.from_jax_params(_np(jp), CPU)
    x = _speechlike(2.0, seed=9, sr=24_000)
    want = np.asarray(jst.tokenize_audio(jp, JST_CFG, jnp.asarray(x)))
    got = tst.tokenize_audio(tp, TST_CFG, torch.from_numpy(x)).numpy()
    assert got.shape == want.shape == (50,)
    np.testing.assert_array_equal(got, want)
    assert len(set(got.tolist())) > 1
    # the codes path (training's view of the same forward)
    mel = jax_kaldi_fbank(jnp.asarray(x)[None], sr=24_000, frame_length_ms=40.0,
                          frame_shift_ms=20.0)
    mask = np.ones(mel.shape[:2], bool)
    mask[0, 80:] = False
    jids, jmask, jcodes = jst.encode_with_codes(jp, JST_CFG, mel, jnp.asarray(mask))
    tids, tmask, tcodes = tst.encode_with_codes(tp, TST_CFG, torch.from_numpy(np.array(mel)),
                                                torch.from_numpy(mask))
    np.testing.assert_array_equal(tids.numpy(), np.asarray(jids))
    np.testing.assert_array_equal(tmask.numpy(), np.asarray(jmask))
    np.testing.assert_allclose(tcodes.numpy(), np.asarray(jcodes), atol=1e-5, rtol=0)


@pytest.mark.parametrize("levels", [3, 4, 5])
def test_fsq_and_id_round_trip_match_jax(levels):
    z = np.random.default_rng(levels).standard_normal((6, 8)).astype(np.float32) * 2
    jcodes, jints = jst._fsq(jnp.asarray(z), levels)
    tcodes, tints = tst._fsq(torch.from_numpy(z), levels)
    np.testing.assert_array_equal(tints.numpy(), np.asarray(jints))
    np.testing.assert_allclose(tcodes.numpy(), np.asarray(jcodes), atol=1e-7, rtol=0)
    ids = tst.codes_to_ids(tints, levels)
    np.testing.assert_array_equal(ids.numpy(), np.asarray(jst.codes_to_ids(jints, levels)))
    np.testing.assert_allclose(tst.ids_to_codes(ids, levels=levels, dims=8).numpy(),
                               np.asarray(jst.ids_to_codes(jnp.asarray(ids.numpy()),
                                                           levels=levels, dims=8)), atol=0)


def test_port_inits_have_the_jax_trees_shapes():
    """The port's seeded inits give the same tree and shapes as the JAX
    inits after ``from_jax_params`` (their numbers differ)."""
    for jtree, ttree in (
            (tec.from_jax_params(_np(host_init(jec.init_ecapa, 1, JEC_CFG)), CPU),
             tec.init_ecapa(1, TEC_CFG, CPU)),
            (tst.from_jax_params(_np(host_init(jst.init_speech_tokenizer, 1, JST_CFG)), CPU),
             tst.init_speech_tokenizer(1, TST_CFG, CPU))):
        def shapes(t):
            if isinstance(t, dict):
                return {k: shapes(v) for k, v in t.items()}
            if isinstance(t, list):
                return [shapes(v) for v in t]
            return (tuple(t.shape), t.dtype)
        assert shapes(jtree) == shapes(ttree)
