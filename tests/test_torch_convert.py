"""The port's checkpoint converters and ``.pt`` loaders against the JAX
package's on the CPU: the official CosyVoice2 ``flow.pt``, ``hift.pt`` and
``llm.pt`` (with its HF Qwen2 backbone) state dicts, the port's emitters,
HiFT's weight-norm folding, and ``models/loaders.py``.

The state dicts are written by the JAX package's own emitters from seeded
JAX trees (``flow_matcha.to_flow_state_dict``, ``hift.to_hift_state_dict``),
and the ``llm.pt`` one is built by hand in the Qwen2LM naming. A converter
must give, from the official names, exactly the tree that
``from_jax_params`` gives from the JAX tree (f32, bit for bit).
"""

import dataclasses

import numpy as np
import pytest
import torch

import jax

from expressive_speech_translation_tpu.models import cosyvoice as jcv
from expressive_speech_translation_tpu.models import cosyvoice_official as jco
from expressive_speech_translation_tpu.models import flow_matcha as jfm
from expressive_speech_translation_tpu.models import hift as jhm
from expressive_speech_translation_tpu.models import loaders as jld
from expressive_speech_translation_tpu_torch.models import cosyvoice as tcv
from expressive_speech_translation_tpu_torch.models import cosyvoice_official as tco
from expressive_speech_translation_tpu_torch.models import flow_matcha as tfm
from expressive_speech_translation_tpu_torch.models import hift as thm
from expressive_speech_translation_tpu_torch.models import loaders as tld
from expressive_speech_translation_tpu_torch.models import qwen2 as tq2
from expressive_speech_translation_tpu_torch.models.common import tree_from_numpy

from test_torch_official import JTINY, TINY, _fields

CPU = "cpu"


def _np(tree):
    return jax.tree.map(np.array, tree)


def assert_trees_equal(got, want, path="tree"):
    """Same nesting, same keys, every leaf bit for bit (dtype and shape too)."""
    if isinstance(want, dict):
        assert isinstance(got, dict) and set(got) == set(want), path
        for k in want:
            assert_trees_equal(got[k], want[k], f"{path}.{k}")
    elif isinstance(want, (list, tuple)):
        assert isinstance(got, (list, tuple)) and len(got) == len(want), path
        for i, (g, w) in enumerate(zip(got, want)):
            assert_trees_equal(g, w, f"{path}[{i}]")
    else:
        assert got.dtype == want.dtype and got.shape == want.shape, path
        assert torch.equal(got, want), path


@pytest.fixture(scope="module")
def trees():
    """Seeded JAX flow and HiFT trees of the tiny triple (numpy)."""
    return (_np(jfm.init_official_flow(jax.random.PRNGKey(2), JTINY.flow)),
            _np(jhm.init_hift(jax.random.PRNGKey(1), JTINY.hift)))


def _torch_state(state):
    return {k: torch.from_numpy(np.array(v)) for k, v in state.items()}


def test_flow_state_dict_converts_like_from_jax_params(trees):
    flow, _ = trees
    state = jfm.to_flow_state_dict(flow, JTINY.flow)
    want = tfm.from_jax_params(flow, CPU)
    assert_trees_equal(tfm.from_flow_state_dict(state, TINY.flow, CPU), want)
    assert_trees_equal(tfm.from_flow_state_dict(_torch_state(state), TINY.flow, CPU), want)


def test_hift_state_dict_converts_like_from_jax_params(trees):
    _, hift = trees
    state = jhm.to_hift_state_dict(hift, JTINY.hift)
    want = thm.from_jax_params(hift, CPU)
    assert_trees_equal(thm.from_hift_state_dict(state, TINY.hift, CPU), want)
    assert want["ups"][0]["kernel"].shape == (32, 16, 16)       # [in, out, width]
    assert want["resblocks"][0]["alphas1"][0].shape == (16,)


@pytest.mark.parametrize("model", ["flow", "hift"])
def test_the_port_emitters_write_the_jax_emitters_dicts_and_round_trip(trees, model):
    """The port's emitter writes the JAX emitter's keys and values from the
    converted tree, and its own converter reads them back bit for bit."""
    flow, hift = trees
    jtree, jemit, emit, conv, port, cfg = {
        "flow": (flow, jfm.to_flow_state_dict, lambda p, _: tfm.to_flow_state_dict(p),
                 tfm.from_flow_state_dict, tfm.from_jax_params, TINY.flow),
        "hift": (hift, jhm.to_hift_state_dict, thm.to_hift_state_dict, thm.from_hift_state_dict,
                 thm.from_jax_params, TINY.hift)}[model]
    params = port(jtree, CPU)
    state = emit(params, cfg)
    want = jemit(jtree, cfg)
    assert set(state) == set(want)
    for k, v in want.items():
        assert state[k].device.type == "cpu" and state[k].is_contiguous()
        np.testing.assert_array_equal(state[k].numpy(), v, err_msg=k)
    assert_trees_equal(conv(state, cfg, CPU), params)


def test_hift_weight_norm_pairs_fold_as_jax_folds_them(trees):
    """Every conv and conv-transpose stored as a (weight_g, weight_v) pair:
    g · v/‖v‖ over every axis but 0, within 1e-6 of the JAX fold (numpy's and
    torch's sums of squares round apart), and a plain ``weight`` key beside
    pairs still taken as it is."""
    _, hift = trees
    state = jhm.to_hift_state_dict(hift, JTINY.hift)
    g = np.random.default_rng(0)
    wn = {}
    for k, v in state.items():
        if k.endswith(".weight") and v.ndim == 3 and k != "conv_pre.weight":
            base = k[: -len(".weight")]
            wn[f"{base}.weight_v"] = (v * g.uniform(0.5, 2.0, v.shape)).astype(np.float32)
            wn[f"{base}.weight_g"] = g.uniform(0.1, 1.0, (v.shape[0], 1, 1)).astype(np.float32)
        else:
            wn[k] = v
    want = thm.from_jax_params(_np(jhm.from_hift_state_dict(wn, JTINY.hift)), CPU)
    got = thm.from_hift_state_dict(_torch_state(wn), TINY.hift, CPU)
    flat_g, flat_w = [], []

    def leaves(t, out):
        if isinstance(t, dict):
            for k in sorted(t):
                leaves(t[k], out)
        elif isinstance(t, list):
            for v in t:
                leaves(v, out)
        else:
            out.append(t)

    leaves(got, flat_g)
    leaves(want, flat_w)
    assert len(flat_g) == len(flat_w)
    for a, b in zip(flat_g, flat_w):
        np.testing.assert_allclose(a.numpy(), b.numpy(), rtol=1e-6, atol=1e-7)
    assert torch.equal(got["conv_pre"]["kernel"], torch.from_numpy(state["conv_pre.weight"]))


def _llm_state(cfg: jcv.SpeechLMConfig, prefix="llm.model.model.") -> dict:
    """An official-naming Qwen2LM ``llm.pt`` state dict of random values
    (``llm.model.*`` HF backbone, ``llm_embedding``, ``speech_embedding``,
    ``llm_decoder``), as tests/test_official_tts_bake.py builds it."""
    g = torch.Generator().manual_seed(0)
    b = cfg.backbone
    hd = b.hidden // b.heads

    def r(*shape):
        return torch.randn(*shape, generator=g) * 0.05

    state = {"llm_embedding.weight": r(2, b.hidden),
             "speech_embedding.weight": r(cfg.speech_token_size + 3, b.hidden),
             "llm_decoder.weight": r(cfg.speech_token_size + 3, b.hidden),
             "llm_decoder.bias": r(cfg.speech_token_size + 3),
             f"{prefix}embed_tokens.weight": r(cfg.text_vocab, b.hidden),
             f"{prefix}norm.weight": 1.0 + r(b.hidden)}
    for i in range(b.layers):
        p = f"{prefix}layers.{i}"
        state.update({
            f"{p}.input_layernorm.weight": 1.0 + r(b.hidden),
            f"{p}.post_attention_layernorm.weight": 1.0 + r(b.hidden),
            f"{p}.self_attn.q_proj.weight": r(b.heads * hd, b.hidden),
            f"{p}.self_attn.q_proj.bias": r(b.heads * hd),
            f"{p}.self_attn.k_proj.weight": r(b.kv_heads * hd, b.hidden),
            f"{p}.self_attn.k_proj.bias": r(b.kv_heads * hd),
            f"{p}.self_attn.v_proj.weight": r(b.kv_heads * hd, b.hidden),
            f"{p}.self_attn.v_proj.bias": r(b.kv_heads * hd),
            f"{p}.self_attn.o_proj.weight": r(b.hidden, b.heads * hd),
            f"{p}.mlp.gate_proj.weight": r(b.ffn_dim, b.hidden),
            f"{p}.mlp.up_proj.weight": r(b.ffn_dim, b.hidden),
            f"{p}.mlp.down_proj.weight": r(b.hidden, b.ffn_dim)})
    return state


@pytest.mark.parametrize("prefix", ["llm.model.model.", "llm.model."])
def test_llm_state_dict_converts_like_the_jax_converter(prefix):
    """The Qwen2LM state dict (HF backbone keys with and without the
    ``model.`` level) → the JAX converter's tree through ``tree_from_numpy``,
    bit for bit: the two ``llm_embedding`` rows in the sos/task slots, the
    decoder head transposed."""
    state = _llm_state(JTINY.lm, prefix)
    want = tree_from_numpy(_np(jcv.from_cosyvoice_llm_state_dict(state, JTINY.lm)), CPU)
    got = tcv.from_cosyvoice_llm_state_dict(state, TINY.lm, CPU)
    assert_trees_equal(got, want)
    assert torch.equal(got["speech_embed"][TINY.lm.sos_index], state["llm_embedding.weight"][0])
    assert torch.equal(got["speech_embed"][TINY.lm.task_index], state["llm_embedding.weight"][1])
    backbone = {k[len("llm.model."):]: v for k, v in state.items() if k.startswith("llm.model.")}
    assert_trees_equal(tq2.from_hf_state_dict(backbone, TINY.lm.backbone, CPU), want["backbone"])


def test_llm_converter_refuses_mtp_heads_and_a_wrong_speech_table():
    state = _llm_state(JTINY.lm)
    with pytest.raises(ValueError, match=r"official llm.pt has no MTP heads; use "
                                         r"SpeechLMConfig\(mtp=1\) \(got mtp=3\)"):
        tcv.from_cosyvoice_llm_state_dict(state, dataclasses.replace(TINY.lm, mtp=3), CPU)
    with pytest.raises(ValueError, match="speech_embedding rows 64 != speech_token_size"):
        tcv.from_cosyvoice_llm_state_dict(
            state, dataclasses.replace(TINY.lm, speech_token_size=50), CPU)


def test_loaders_read_torch_saved_checkpoints(tmp_path, trees):
    """flow.pt / hift.pt / llm.pt saved with ``torch.save`` load into the
    converters' trees; ``load_cosyvoice_flow`` infers the tiny structure from
    the tensors as the JAX loader does; the LM loader refuses to infer a
    non-0.5B backbone; a missing path raises WeightsNotFoundError."""
    flow, hift = trees
    torch.save(_torch_state(jfm.to_flow_state_dict(flow, JTINY.flow)), tmp_path / "flow.pt")
    torch.save(_torch_state(jhm.to_hift_state_dict(hift, JTINY.hift)), tmp_path / "hift.pt")
    torch.save(_llm_state(JTINY.lm), tmp_path / "llm.pt")

    params, cfg = tld.load_cosyvoice_flow(tmp_path / "flow.pt", device=CPU)
    _, jcfg = jld.load_cosyvoice_flow(tmp_path / "flow.pt")
    assert _fields(cfg.encoder) == _fields(jcfg.encoder)
    assert _fields(cfg.estimator) == _fields(jcfg.estimator)
    assert {k: v for k, v in _fields(cfg).items() if k not in ("encoder", "estimator")} == \
        {k: v for k, v in _fields(jcfg).items() if k not in ("encoder", "estimator")}
    for f in ("vocab_size", "input_size", "output_size", "spk_embed_dim"):
        assert getattr(cfg, f) == getattr(TINY.flow, f)
    for f in ("size", "heads", "linear_units", "blocks", "up_blocks"):
        assert getattr(cfg.encoder, f) == getattr(TINY.flow.encoder, f)
    for f in ("in_channels", "out_channels", "channels", "n_blocks", "num_mid_blocks"):
        assert getattr(cfg.estimator, f) == getattr(TINY.flow.estimator, f)
    assert_trees_equal(params, tfm.from_jax_params(flow, CPU))

    params, cfg = tld.load_cosyvoice_hift(tmp_path / "hift.pt", TINY.hift, device=CPU)
    assert cfg is TINY.hift
    assert_trees_equal(params, thm.from_jax_params(hift, CPU))

    params, cfg = tld.load_cosyvoice_llm(tmp_path, TINY.lm, device=CPU)
    want, _ = jld.load_cosyvoice_llm(tmp_path, cfg=JTINY.lm)
    assert_trees_equal(params, tree_from_numpy(_np(want), CPU))
    with pytest.raises(ValueError, match="not Qwen2-0.5B"):
        tld.load_cosyvoice_llm(tmp_path, device=CPU)
    with pytest.raises(tld.WeightsNotFoundError, match="does not exist"):
        tld.load_state_dict(tmp_path / "missing")


def test_the_official_tree_converts_in_bf16_and_inits_at_its_shapes():
    """``from_jax_params`` casts the floating leaves; the port's own init
    draws the JAX init's shapes (its numbers differ), MTP heads last."""
    tree = _np(jco.init_official_tts(jax.random.PRNGKey(0), JTINY))
    bf16 = tco.from_jax_params(tree, CPU, torch.bfloat16)
    assert bf16["flow"]["estimator"]["final_proj"]["kernel"].dtype == torch.bfloat16
    mine = tco.init_official_tts(0, TINY, CPU)
    shapes = jax.tree.map(lambda a: tuple(a.shape), tco.from_jax_params(tree, CPU),
                          is_leaf=torch.is_tensor)
    assert jax.tree.map(lambda a: tuple(a.shape), mine, is_leaf=torch.is_tensor) == shapes
    wide = tco.init_official_tts(0, dataclasses.replace(TINY, lm=dataclasses.replace(TINY.lm,
                                                                                     mtp=3)), CPU)
    assert len(wide["lm"]["mtp_heads"]) == 2
    assert torch.equal(wide["hift"]["conv_post"]["kernel"], mine["hift"]["conv_post"]["kernel"])
