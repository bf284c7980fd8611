"""SeamlessM4T-v2 (``models/seamless.py``, its converter, loader, emitter and
bake) against the JAX package on the CPU.

The model runs at ``SeamlessConfig.toy()`` on a tree in JAX's structure and
layouts drawn from a numpy seed (every bias, norm and position scale moved
off its init value), handed to JAX as arrays and carried into the port by
``from_jax_params``. JAX's functions run jitted (the same functions, compiled
once: eager they take ~30 s here). f32 stages are held within F32_RTOL of the
output's peak; token ids, units, durations and lengths exactly. The bf16
path is held by its cast points: the dtypes into and out of every conv,
dense layer, norm and attention, call for call, against JAX's traced by
``jax.eval_shape``.
"""

import dataclasses
import functools
import json

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from expressive_speech_translation_tpu.models import loaders as jld
from expressive_speech_translation_tpu.models import seamless as jsm
from expressive_speech_translation_tpu_torch.models import loaders as tld
from expressive_speech_translation_tpu_torch.models import seamless as tsm
from expressive_speech_translation_tpu_torch.obs import checkpoint_emitters as em

CPU = "cpu"
# f32, port against JAX: max |diff| over the output's peak (measured ≤ 1e-6
# on every stage here)
F32_RTOL = 1e-4
CFG = jsm.SeamlessConfig.toy()
TCFG = tsm.SeamlessConfig.toy()
CHUNKED = dataclasses.replace(CFG, chunk_size=4, left_chunk_num=1)
MAX_UNITS = 32
MAX_CHARS = 48
TEXT_TOKENS = 10
LANGS = {"text": {"eng": 300, "fra": 301}, "vocoder": {"eng": 0, "fra": 1}}


def _port_cfg(cfg):
    return tsm.SeamlessConfig(**dataclasses.asdict(cfg))


def _jax_tree(seed: int = 2, cfg=CFG):
    """JAX's Seamless tree (its structure and layouts, from ``eval_shape``
    of ``init_seamless``) drawn from a numpy seed: kernels N(0, 1/fan_in),
    biases and norm offsets N(0, 0.2²), norm and position scales 1 + N(0,
    0.2²), embeddings N(0, 0.1²), the sinusoid tables exact. Seed 2's decoder
    speaks more than one token a row at 2 beams, and with the EOS row ×4
    (:func:`_eos_favoured`) one row ends at once and the other runs on."""
    g = np.random.default_rng(seed)
    shapes = jax.eval_shape(lambda: jsm.init_seamless(jax.random.PRNGKey(0), cfg))

    def draw(path, s):
        keys = [getattr(k, "key", getattr(k, "idx", None)) for k in path]
        name = keys[-1]
        if name == "pos":
            pad = cfg.pad_token if keys[0] == "text_decoder" else cfg.t2u_pad
            return jsm.m2m100_sinusoids(cfg.max_positions, cfg.hidden, pad)
        if name == "kernel":
            w = g.standard_normal(s.shape) / np.sqrt(np.prod(s.shape[:-1]))
        elif name in ("scale", "pos_alpha", "pos_alpha_char"):
            w = 1.0 + 0.2 * g.standard_normal(s.shape)
        elif name == "bias":
            w = 0.2 * g.standard_normal(s.shape)
        else:                            # embeddings and the rel-pos table
            w = 0.1 * g.standard_normal(s.shape)
        return w.astype(np.float32)

    return jax.tree_util.tree_map_with_path(draw, shapes)


def _np(x):
    return x.detach().cpu().numpy() if torch.is_tensor(x) else np.asarray(x)


def _close(got, want, rtol=F32_RTOL):
    got, want = _np(got), _np(want)
    assert got.shape == want.shape
    peak = np.abs(want).max()
    assert peak > 0 and np.abs(got - want).max() <= rtol * peak, (np.abs(got - want).max(), peak)


def _equal(got, want):
    got, want = _np(got), _np(want)
    assert got.shape == want.shape and np.array_equal(got, want), (got, want)


def assert_trees_equal(got, want, path="tree"):
    if isinstance(want, dict):
        assert isinstance(got, dict) and set(got) == set(want), path
        for k in want:
            assert_trees_equal(got[k], want[k], f"{path}.{k}")
    elif isinstance(want, (list, tuple)):
        assert len(got) == len(want), path
        for i, (g, w) in enumerate(zip(got, want)):
            assert_trees_equal(g, w, f"{path}[{i}]")
    else:
        assert got.dtype == want.dtype and got.shape == want.shape, path
        assert torch.equal(got, want), path


# JAX's functions, jitted once for the module
JIT = {
    "encode": jax.jit(jsm.encode_speech, static_argnums=1),
    "hidden": jax.jit(jsm.text_decoder_hidden, static_argnums=1),
    "logits": jax.jit(jsm.text_decode_full, static_argnums=1),
    "t2u_encode": jax.jit(jsm.t2u_encode, static_argnums=1),
    "nar": jax.jit(jsm.t2u_nar_decode, static_argnums=1, static_argnames="max_units"),
    "units": jax.jit(jsm.units_from_logits, static_argnums=0),
    "vocoder": jax.jit(jsm.code_hifigan, static_argnums=1, static_argnames="max_frames"),
}


@pytest.fixture(scope="module")
def trees():
    """(JAX's tree as arrays, the port's tree from it)."""
    tree = _jax_tree()
    return jax.tree.map(jnp.asarray, tree), tsm.from_jax_params(tree, CPU)


@pytest.fixture(scope="module")
def feats():
    g = np.random.default_rng(1)
    x = (0.5 * g.standard_normal((2, 24, 160))).astype(np.float32)
    mask = np.ones((2, 24), bool)
    mask[1, 15:] = False
    return x, mask


@pytest.fixture(scope="module")
def encoded(trees, feats):
    jt, tp = trees
    x, mask = feats
    return (JIT["encode"](jt, CFG, jnp.asarray(x), jnp.asarray(mask)),
            tsm.encode_speech(tp, TCFG, torch.from_numpy(x), torch.from_numpy(mask)))


@pytest.mark.parametrize("cfg", [CFG, CHUNKED], ids=["plain", "chunked"])
def test_encode_speech_matches_jax(trees, feats, cfg):
    """Padded rows, and (chunked) v2's chunk mask at chunk 4, left 1."""
    jt, tp = trees
    x, mask = feats
    je, jm = JIT["encode"](jt, cfg, jnp.asarray(x), jnp.asarray(mask))
    te, tm = tsm.encode_speech(tp, _port_cfg(cfg), torch.from_numpy(x), torch.from_numpy(mask))
    _equal(tm, jm)
    _close(te, je)


def test_chunk_mask_and_lengths_match_jax():
    for t, chunk, left in ((24, 4, 1), (10, 3, 0), (7, 20_000, 128), (9, 2, -1)):
        assert np.array_equal(tsm._chunk_attend(t, chunk, left), jsm._chunk_attend(t, chunk, left))
    lengths = np.array([1, 7, 24, 500])
    for cfg in (CFG, jsm.SeamlessConfig.v2_large()):
        _equal(tsm.adaptor_out_lengths(_port_cfg(cfg), torch.from_numpy(lengths)),
               jsm.adaptor_out_lengths(cfg, jnp.asarray(lengths)))
        for n in (1, 5, 64):
            assert (tsm.vocoder_output_length(_port_cfg(cfg), n)
                    == int(jsm.vocoder_output_length(cfg, jnp.asarray(n))))


@pytest.mark.parametrize("counts", [[[0, 2, 3, 1, 0]], [[1, 1, 1, 1, 1], [0, 4, 0, 9, 2]]])
def test_hard_upsample_matches_jax(counts):
    """Past sum(counts) the last row holds; a horizon shorter than the sum cuts."""
    counts = np.asarray(counts, np.int32)
    h = np.random.default_rng(2).standard_normal((len(counts), 5, 3)).astype(np.float32)
    for out_len in (4, 9, 20):
        _equal(tsm.hard_upsample(torch.from_numpy(h), torch.from_numpy(counts), out_len),
               jsm.hard_upsample(jnp.asarray(h), jnp.asarray(counts), out_len))


def test_text_decoder_hidden_matches_jax(trees, encoded):
    jt, tp = trees
    (je, jm), (te, tm) = encoded
    tokens = np.array([[3, 300, 17, 250, 9, 3, 0, 0], [3, 301, 44, 12, 99, 200, 101, 7]], np.int32)
    _close(tsm.text_decoder_hidden(tp, TCFG, torch.from_numpy(tokens), te, tm),
           JIT["hidden"](jt, CFG, jnp.asarray(tokens), je, jm))
    _close(tsm.text_decode_full(tp, TCFG, torch.from_numpy(tokens), te, tm),
           JIT["logits"](jt, CFG, jnp.asarray(tokens), je, jm))


def _eos_favoured(trees, scale):
    """Both trees with the shared embedding's EOS row scaled, so EOS wins
    inside the budget and the searches' finishing rules run."""
    jt, tp = trees
    jt = dict(jt, shared=jt["shared"].at[CFG.eos_token].multiply(scale))
    shared = tp["shared"].clone()
    shared[CFG.eos_token] *= scale
    return jt, dict(tp, shared=shared)


@pytest.mark.parametrize("beams", [1, 2])
@pytest.mark.parametrize("eos_scale", [1.0, 4.0], ids=["plain", "eos"])
def test_generate_text_matches_jax(trees, encoded, beams, eos_scale):
    """Greedy and at 2 beams, token-exact, on plain weights and on weights
    whose EOS row is scaled (EOS inside the budget)."""
    jt, tp = _eos_favoured(trees, eos_scale)
    (je, jm), (te, tm) = encoded
    want = np.asarray(jsm.generate_text(jt, CFG, je, jm, 300, num_beams=beams,
                                        max_new_tokens=TEXT_TOKENS))
    got = tsm.generate_text(tp, TCFG, te, tm, 300, num_beams=beams, max_new_tokens=TEXT_TOKENS)
    _equal(got, want)
    if eos_scale > 1:       # one row ends inside the budget, the other runs on
        assert (want[:, 2:] == CFG.eos_token).any(axis=1).tolist() == [True, False]
    else:
        assert len(set(want[:, 2:].ravel().tolist())) > 1


def _char_inputs():
    ids = np.array([[9, 300, 17, 250, 9, 101, 0, 0, 0],
                    [44, 12, 99, 200, 101, 7, 88, 3, 0]], np.int64)
    i2t, c2i = jsm.byte_char_maps(CFG.vocab_size)
    return jsm.char_inputs_for_t2u(ids, i2t, c2i, max_chars=MAX_CHARS)


def test_t2u_nar_decode_matches_jax(trees, encoded):
    """The t2u encoder, the NAR decoder (logits 1e-4; durations, unit lengths
    and the valid mask exact) and the vocoder units, token-exact."""
    jt, tp = trees
    (je, jm), (te, tm) = encoded
    tokens = np.array([[3, 300, 17, 250, 9, 101, 3, 0, 0, 0],
                       [3, 301, 44, 12, 99, 200, 101, 7, 88, 3]], np.int32)
    char_ids, char_counts = _char_inputs()
    tmask = tokens != CFG.pad_token
    jh = JIT["hidden"](jt, CFG, jnp.asarray(tokens), je, jm)
    th = tsm.text_decoder_hidden(tp, TCFG, torch.from_numpy(tokens), te, tm)
    jenc = JIT["t2u_encode"](jt, CFG, jh, jnp.asarray(tmask))
    tenc = tsm.t2u_encode(tp, TCFG, th, torch.from_numpy(tmask))
    _close(tenc, jenc)
    want = JIT["nar"](jt, CFG, jenc, jnp.asarray(char_ids), jnp.asarray(char_counts),
                      max_units=MAX_UNITS)
    got = tsm.t2u_nar_decode(tp, TCFG, tenc, torch.from_numpy(char_ids),
                             torch.from_numpy(char_counts), max_units=MAX_UNITS)
    _close(got["logits"], want["logits"])
    for key in ("padding_mask", "durations", "unit_lengths"):
        _equal(got[key], want[key])
    assert int(_np(want["durations"]).max()) > 1        # the upsample repeats
    _equal(tsm.units_from_logits(TCFG, got["logits"], got["padding_mask"]),
           JIT["units"](CFG, want["logits"], want["padding_mask"]))


def test_code_hifigan_matches_jax(trees):
    """Units with pads, a horizon the durations overrun in one row, speaker
    and language ids; the wave 1e-4, lengths equal (one pad slot's duration
    counted, as HF counts it). The ids span what ``units_from_logits`` can
    give (up to t2u_vocab − offset − 1, past the vocoder's table): JAX's
    gather clamps those to the last row, and so does the port."""
    jt, tp = trees
    top = CFG.t2u_vocab - CFG.vocoder_offset
    assert top > CFG.unit_vocab_vocoder
    units = np.random.default_rng(3).integers(0, top, (2, 12)).astype(np.int32)
    units[0, 7:] = CFG.t2u_pad
    units[1, :2] = top - 1
    for max_frames in (24, 64):
        wave, lengths = JIT["vocoder"](jt, CFG, jnp.asarray(units), 2, 1, max_frames=max_frames)
        got, got_len = tsm.code_hifigan(tp, TCFG, torch.from_numpy(units), 2, 1,
                                        max_frames=max_frames)
        _close(got, wave)
        _equal(got_len.to(torch.int32), np.asarray(lengths, np.int32))
        assert got.shape[1] == max_frames * TCFG.hop_total


def test_char_inputs_and_byte_maps_match_jax():
    """The host glue equal to JAX's: byte maps, subword maps with the space
    mark, punctuation merged into the next word, unknown ids, and a
    max_chars that truncates (counts follow the ids)."""
    for v in (64, CFG.vocab_size):
        assert tsm.byte_char_maps(v) == jsm.byte_char_maps(v)
    i2t = {"4": "▁hel", "5": "lo", "6": ",", "7": "▁wor", "8": "ld", "9": ".", "10": "▁a"}
    c2i = {ch: 2 + i for i, ch in enumerate("▁helowrda,.")}
    ids = np.array([[4, 5, 6, 7, 8, 9, 0], [1, 10, 6, 4, 5, 9, 0], [4, 5, 6, 10, 0, 0, 0]])
    for maps in ((i2t, c2i), jsm.byte_char_maps(16)):
        for max_chars in (None, 5, 40):
            got = tsm.char_inputs_for_t2u(ids % 16 if maps[0] is not i2t else ids, *maps,
                                          max_chars=max_chars)
            want = jsm.char_inputs_for_t2u(ids % 16 if maps[0] is not i2t else ids, *maps,
                                           max_chars=max_chars)
            for a, b in zip(got, want):
                assert a.dtype == b.dtype and np.array_equal(a, b)


def test_translate_s2st_matches_jax(trees, feats, monkeypatch):
    """End to end at 2 beams: the text tokens, units and lengths exact, the
    audio within 1e-4 of its peak. JAX's stages run jitted (patched into its
    module for this test only)."""
    jt, tp = trees
    x, mask = feats
    for name, key in (("encode_speech", "encode"), ("text_decoder_hidden", "hidden"),
                      ("t2u_encode", "t2u_encode"), ("t2u_nar_decode", "nar"),
                      ("code_hifigan", "vocoder")):
        monkeypatch.setattr(jsm, name, JIT[key])
    kw = dict(tgt_lang_token=301, vocoder_lang_id=1, spkr_id=2, num_beams=2,
              max_text_tokens=TEXT_TOKENS, max_chars=MAX_CHARS, max_units=MAX_UNITS)
    want = jsm.translate_s2st(jt, CFG, jnp.asarray(x), jnp.asarray(mask), **kw)
    got = tsm.translate_s2st(tp, TCFG, torch.from_numpy(x), torch.from_numpy(mask), **kw)
    for key in ("text_tokens", "units", "n_units"):
        _equal(got[key].to(torch.int32), np.asarray(want[key], np.int32))
    _equal(got["waveform_lengths"].to(torch.int32), np.asarray(want["waveform_lengths"], np.int32))
    _close(got["audio"], want["audio"])
    assert int(_np(want["n_units"]).min()) > 0


# ------------------------------------------------------------ bf16 cast points


def _spied(module, names, calls, convert):
    """Wrap ``module.<name>`` so each call records (name, the dtypes of its
    tensor arguments, the dtype(s) of its result)."""
    originals = {n: getattr(module, n) for n in names}

    def wrap(name, fn):
        @functools.wraps(fn)
        def spy(*args, **kw):
            out = fn(*args, **kw)
            ins = [convert(a) for a in args if hasattr(a, "dtype") and hasattr(a, "shape")]
            outs = [convert(o) for o in (out if isinstance(out, tuple) else (out,))
                    if hasattr(o, "dtype")]
            calls.append((name, tuple(ins), tuple(outs)))
            return out
        return spy

    return {n: wrap(n, f) for n, f in originals.items()}


def _dt(x) -> str:
    return str(x.dtype).replace("torch.", "")


def test_bf16_casts_follow_jax(trees, feats, encoded, monkeypatch):
    """A bf16 tree (the backend's serving dtype) through the encoder, the
    teacher-forced decoder, the t2u encoder and NAR decoder and the vocoder:
    every conv (JAX's ``_conv1d`` / ``_conv_transpose1d``, the port's ``_conv``
    / ``_conv_transpose``), dense layer, layer norm and attention takes and
    gives the dtypes JAX's does, call for call (JAX's traced by
    ``jax.eval_shape``)."""
    jt, tp = trees
    x, mask = feats
    jt16 = jax.tree.map(lambda a: a.astype(jnp.bfloat16), jt)
    tp16 = jax.tree.map(lambda t: t.to(torch.bfloat16), tp)
    tokens = np.array([[3, 300, 17, 250, 9, 3, 0, 0]], np.int32)
    char_ids, char_counts = _char_inputs()
    char_ids, char_counts = char_ids[:1, :8], np.minimum(char_counts[:1, :8], 1)

    def run(sm, tree, cfg, asarray, bf16):
        enc, emask = sm.encode_speech(tree, cfg, bf16(asarray(x[:1])), asarray(mask[:1]))
        h = sm.text_decoder_hidden(tree, cfg, asarray(tokens), enc, emask)
        t2u = sm.t2u_encode(tree, cfg, h, asarray(tokens != 0))
        nar = sm.t2u_nar_decode(tree, cfg, t2u, asarray(char_ids), asarray(char_counts),
                                max_units=8)
        sm.code_hifigan(tree, cfg, asarray(np.array([[3, 7, 1]], np.int32)), 0, 1,
                        max_frames=6)
        return nar["logits"]

    names = ("dense", "layer_norm", "mha")
    jcalls, tcalls = [], []
    for n, f in _spied(jsm, names + ("_conv1d", "_conv_transpose1d"), jcalls, _dt).items():
        monkeypatch.setattr(jsm, n, f)
    for n, f in _spied(tsm, names + ("_conv", "_conv_transpose"), tcalls, _dt).items():
        monkeypatch.setattr(tsm, n, f)
    jax.eval_shape(lambda t: run(jsm, t, CFG, jnp.asarray, lambda a: a.astype(jnp.bfloat16)),
                   jt16)
    with torch.no_grad():
        run(tsm, tp16, TCFG, torch.from_numpy, lambda a: a.to(torch.bfloat16))
    rename = {"_conv1d": "conv", "_conv": "conv", "_conv_transpose1d": "convT",
              "_conv_transpose": "convT"}
    jseq = [(rename.get(n, n), i, o) for n, i, o in jcalls]
    tseq = [(rename.get(n, n), i, o) for n, i, o in tcalls]
    assert len(jseq) > 80
    assert tseq == jseq
    assert {o for _, _, o in tseq} == {("bfloat16",)}


# -------------------------------------------------- converter, loader, bake


def test_init_seamless_follows_the_jax_tree():
    """The port's seeded init has JAX's structure at the published width,
    each leaf at the port's layout of JAX's shape."""
    cfg = jsm.SeamlessConfig.toy()
    shapes = jax.eval_shape(lambda: jsm.init_seamless(jax.random.PRNGKey(0), cfg))
    want = tsm.from_jax_params(jax.tree.map(lambda s: np.zeros(s.shape, np.float32), shapes),
                               CPU)
    got = tsm.init_seamless(0, TCFG, CPU)
    jax.tree.map(lambda g, w: None, got, want)           # same structure
    for g, w in zip(jax.tree.leaves(got), jax.tree.leaves(want)):
        assert g.shape == w.shape and g.dtype == torch.float32
    assert torch.equal(got["text_decoder"]["pos"], torch.from_numpy(
        jsm.m2m100_sinusoids(cfg.max_positions, cfg.hidden, cfg.pad_token)))


def _emitted(tmp_path, params, shard_bytes):
    return em.write_seamless(tmp_path / "seamless-m4t-v2", params, TCFG,
                             text_lang_ids=LANGS["text"], vocoder_lang_ids=LANGS["vocoder"],
                             shard_bytes=shard_bytes)


def test_the_emitters_state_dict_converts_alike_in_both_packages(trees):
    """The port's tree → HF state dict (the emitter) → each package's
    ``from_hf_state_dict``: the two trees are equal, and equal to the tree
    emitted."""
    _, tp = trees
    state = em.seamless_hf_state_dict(tp, TCFG)
    assert not any(k.endswith(".pos") or "embed_positions" in k for k in state)
    jtree = jsm.from_hf_state_dict(state, CFG)
    assert_trees_equal(tsm.from_jax_params(jax.tree.map(np.asarray, jtree), CPU), tp)
    assert_trees_equal(tsm.from_hf_state_dict(state, TCFG, CPU), tp)


def test_load_seamless_reads_the_sharded_emission_as_jax_does(trees, tmp_path):
    """``write_seamless`` with small shards: the index, config.json and the
    generation config; ``load_seamless`` / ``load_seamless_aux`` agree with
    JAX's on the same directory (the config equal, the tree bit for bit)."""
    _, tp = trees
    root = _emitted(tmp_path, tp, shard_bytes=200_000)
    index = json.loads((root / "model.safetensors.index.json").read_text())
    assert len(set(index["weight_map"].values())) > 2
    params, cfg = tld.load_seamless(root, device=CPU)
    jparams, jcfg = jld.load_seamless(root)
    assert cfg == _port_cfg(jcfg) and cfg == TCFG
    assert_trees_equal(params, tsm.from_jax_params(jax.tree.map(np.asarray, jparams), CPU))
    assert_trees_equal(params, tp)
    aux = tld.load_seamless_aux(root)
    assert aux == jld.load_seamless_aux(root)
    assert aux == {"text_decoder_lang_to_code_id": LANGS["text"],
                   "vocoder_lang_code_to_id": LANGS["vocoder"]}
    assert tld.load_seamless_aux(tmp_path) == jld.load_seamless_aux(tmp_path) == {}


def test_the_seamless_bake_is_served_by_the_backend(trees, tmp_path, monkeypatch):
    """``bake_models(seamless=...)`` and the CLI write ``seamless/``
    (config.json, params.safetensors, generation_maps.json, the copied
    tokenizer.json); ``SeamlessBackend.from_models_dir`` under EST_MODELS_DIR
    serves it with weights "loaded" and the maps' language ids."""
    from expressive_speech_translation_tpu_torch.pipeline.alternate_backends import (
        SeamlessBackend)

    _, tp = trees
    root = _emitted(tmp_path, tp, shard_bytes=2**30)
    (root / "tokenizer.json").write_text("{}")
    tld.bake_models(tmp_path / "bake", seamless=str(root), device=CPU)
    stage = tmp_path / "bake" / "seamless"
    assert {p.name for p in stage.iterdir()} == {"config.json", "params.safetensors",
                                                  "generation_maps.json", "tokenizer.json"}
    baked, cfg = tld.load_converted(stage, tsm.SeamlessConfig, CPU)
    assert cfg == TCFG
    assert_trees_equal(baked, tp)
    assert tld.main(["--seamless", str(root), "--out", str(tmp_path / "cli"),
                     "--device", CPU]) == 0
    assert (tmp_path / "cli" / "seamless" / "params.safetensors").exists()

    (stage / "tokenizer.json").unlink()          # a subword tokenizer needs `tokenizers`
    monkeypatch.setenv("EST_MODELS_DIR", str(tmp_path / "bake"))
    backend = SeamlessBackend.from_models_dir(device=CPU, num_beams=2)
    assert backend.weights_info() == "loaded" and backend.cfg == TCFG
    assert backend._lang_ids("fra") == (301, 1)
    assert_trees_equal(backend._params, tp)
    monkeypatch.delenv("EST_MODELS_DIR")
    assert SeamlessBackend.from_models_dir(device=CPU).weights_info() == "random"
