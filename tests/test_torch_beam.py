"""The port's NLLB beam search against the JAX package's on the CPU.

The same seeded NLLB weights go to both sides (``from_jax_params``); beam
search (HF semantics: ``early_stopping=True``, length normalisation by the
generated length, the min-new-tokens EOS ban on log-softmaxed scores, EOS
candidates finishing only within the top ``num_beams``) must give the same
tokens, through ``generate`` and through the NMT engines. In the "eos2" and
"eos8" cases the EOS row of the tied embedding is scaled 2x and 8x, so
hypotheses finish early and the finished set, not the budget, decides the
result: at 2x an EOS candidate often ranks between ``num_beams`` and
2 ``num_beams`` (where it must not finish), at 8x the EOS ban before
``min_new_tokens`` renormalises each beam differently if it is applied
before the log-softmax.
"""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from expressive_speech_translation_tpu.models import beam as jbm
from expressive_speech_translation_tpu.models import nllb as jnl
from expressive_speech_translation_tpu.pipeline.jax_engines import JaxNllbNmt
from expressive_speech_translation_tpu_torch.models import beam as tbm
from expressive_speech_translation_tpu_torch.models import nllb as tnl
from expressive_speech_translation_tpu_torch.pipeline.languages import nllb_placeholder_lang_ids
from expressive_speech_translation_tpu_torch.pipeline.torch_engines import TorchNllbNmt

NCFG = jnl.NLLBConfig(d_model=64, encoder_layers=2, decoder_layers=2, heads=4, ffn_dim=128,
                      vocab_size=384, max_positions=128)
TNCFG = tnl.NLLBConfig(**{f: getattr(NCFG, f) for f in NCFG.__dataclass_fields__})
MAX_NEW = 16


def _np(tree):
    return jax.tree.map(np.array, tree)


@pytest.fixture(scope="module")
def weights():
    """{"plain", "eos2", "eos8"}: the seeded params, and the same with the
    EOS embedding row scaled 2x and 8x, as numpy trees."""
    plain = _np(jnl.init_nllb(jax.random.PRNGKey(11), NCFG))
    out = {"plain": plain}
    for scale in (2, 8):
        out[f"eos{scale}"] = jax.tree.map(np.array, plain)
        out[f"eos{scale}"]["embed"][NCFG.eos_token] *= scale
    return out


def _src():
    g = np.random.default_rng(21)
    src = np.full((3, 12), NCFG.pad_token, np.int32)
    for row, n in enumerate((12, 7, 4)):
        src[row, :n] = g.integers(3, 380, n)
        src[row, n - 1] = NCFG.eos_token
    return src


def _generate_both(params, **kw):
    src = _src()
    want = np.asarray(jnl.generate(jax.tree.map(jnp.asarray, params), NCFG, jnp.asarray(src), 377,
                                   max_new_tokens=MAX_NEW, **kw))
    got = tnl.generate(tnl.from_jax_params(params, "cpu"), TNCFG, torch.from_numpy(src), 377,
                       max_new_tokens=MAX_NEW, **kw).numpy()
    return got, want


@pytest.mark.parametrize("weights_name", ["plain", "eos2", "eos8"])
@pytest.mark.parametrize("num_beams,length_penalty,min_new_tokens",
                         [(2, 1.0, 0), (4, 1.0, 0), (4, 0.6, 0), (2, 1.7, 5), (4, 1.3, 5)])
def test_beam_search_through_generate_matches_jax(weights, weights_name, num_beams,
                                                  length_penalty, min_new_tokens):
    got, want = _generate_both(weights[weights_name], num_beams=num_beams,
                               length_penalty=length_penalty, min_new_tokens=min_new_tokens)
    assert got.dtype == np.int32 and got.shape == (3, 1 + MAX_NEW)
    np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize("weights_name", ["eos2", "eos8"])
def test_eos_weights_finish_hypotheses_early(weights, weights_name):
    """The "eos" cases exercise the finished set: every row's best
    hypothesis ends with EOS inside the budget (then pads), and none before
    ``min_new_tokens``."""
    got, _ = _generate_both(weights[weights_name], num_beams=4, min_new_tokens=5)
    for row in got:
        ends = np.flatnonzero(row[2:] == NCFG.eos_token)
        assert ends.size and ends[0] + 2 < 1 + MAX_NEW - 1
        assert ends[0] + 1 >= 5                       # generated tokens incl. the forced BOS
        assert (row[ends[0] + 3:] == NCFG.pad_token).all()


def test_one_beam_is_greedy(weights):
    """``num_beams=1`` keeps greedy search: JAX's greedy tokens."""
    got, want = _generate_both(weights["eos2"], num_beams=1, min_new_tokens=3)
    np.testing.assert_array_equal(got, want)
    src = torch.from_numpy(_src())
    tp = tnl.from_jax_params(weights["plain"], "cpu")
    np.testing.assert_array_equal(
        tnl.generate(tp, TNCFG, src, 377, max_new_tokens=MAX_NEW).numpy(),
        tnl.generate(tp, TNCFG, src, 377, num_beams=1, max_new_tokens=MAX_NEW).numpy())


def test_gather_beams_matches_jax():
    """Per-row beam indices reorder every [B*K, ...] leaf, rows kept apart."""
    g = np.random.default_rng(2)
    tree = {"k": g.standard_normal((6, 5, 2)).astype(np.float32),
            "v": [g.standard_normal((6, 3)).astype(np.float32)]}
    idx = np.array([[2, 0, 0], [1, 2, 1]], np.int32)
    want = jbm._gather_beams(jax.tree.map(jnp.asarray, tree), jnp.asarray(idx), 2, 3)
    got = tbm._gather_beams({"k": torch.from_numpy(tree["k"]), "v": [torch.from_numpy(tree["v"][0])]},
                            torch.from_numpy(idx).long(), 2, 3)
    np.testing.assert_array_equal(got["k"].numpy(), np.asarray(want["k"]))
    np.testing.assert_array_equal(got["v"][0].numpy(), np.asarray(want["v"][0]))


@pytest.fixture(scope="module")
def nmt_pair(weights):
    """The engines on weights with the EOS row scaled 1.5x: some beams finish
    early, some run to the budget."""
    lang_ids = nllb_placeholder_lang_ids(NCFG.vocab_size)
    params = jax.tree.map(np.array, weights["plain"])
    params["embed"][NCFG.eos_token] *= 1.5
    jnmt = JaxNllbNmt(NCFG, jax.tree.map(jnp.asarray, params), dtype=jnp.float32, num_beams=4,
                      max_new_tokens=12, lang_code_to_id=lang_ids)
    nmt = TorchNllbNmt(TNCFG, tnl.from_jax_params(params, "cpu"), device="cpu",
                       lang_code_to_id=lang_ids, dtype=torch.float32, num_beams=4,
                       max_new_tokens=12)
    return jnmt, nmt


def test_engine_translate_with_four_beams_matches_jax(nmt_pair):
    jnmt, nmt = nmt_pair
    cases = (("hello there, friend", "eng", "fra"), ("a", "eng", "deu"),
             ("where is the station today", "fra", "eng"))
    got = [nmt.translate(*case) for case in cases]
    assert got == [jnmt.translate(*case) for case in cases] and any(got)


def test_engine_translate_batch_with_four_beams_matches_jax(nmt_pair):
    """Five requests to two targets: two dispatches of padded rows, each
    row's beams kept to its own row."""
    jnmt, nmt = nmt_pair
    texts = ["hello", "good morning to you all", "yes", "the weather is fine today", "no!"]
    requests = [{"text": t, "source_lang": "eng", "target_lang": ("fra", "deu")[i % 2]}
                for i, t in enumerate(texts)]
    got = nmt.translate_batch(requests)
    assert got == jnmt.translate_batch(requests) and any(got)
    assert got == [nmt.translate(r["text"], "eng", r["target_lang"]) for r in requests]
