"""The port's SFT trainer against the JAX package's on the CPU: ``qwen2.forward``,
``lm_loss`` and its gradients, ``flow_matching_loss`` with JAX's draws
injected, the optimizer against optax, the train step, the data pipeline and
``batches_from_samples``, the checkpoints and a resumed run, ``Executor.train``
on JAX's Kaldi fixture, ``SpeechTokenizerFrontend``, ``run.main`` with its
export served, ``prepare_mcv`` / ``plot`` / ``kvlogger`` outputs, and the
item-12 refusals.

Both sides take the same seeded tree (the JAX init through
``tree_from_numpy``) at toy widths (hidden 32-64, two layers). f32 paths are
held within 1e-5 relative (gradients and parameters within 1e-5 of their
tensor's peak); JAX's sides run jitted (op by op they cost 10-20 s a test).
"""

import contextlib
import dataclasses
import functools
import io
import json
import logging
import re
import sys

import numpy as np
import optax
import pytest
import torch

import jax
import jax.numpy as jnp

from expressive_speech_translation_tpu.core.config import TrainConfig as JTrainConfig
from expressive_speech_translation_tpu.models import cosyvoice as jcv
from expressive_speech_translation_tpu.models import qwen2 as jq2
from expressive_speech_translation_tpu.models.common import host_init
from expressive_speech_translation_tpu.obs import kvlogger as jkv
from expressive_speech_translation_tpu.train import data as jdata
from expressive_speech_translation_tpu.train import executor as jexec
from expressive_speech_translation_tpu.train import plot as jplot
from expressive_speech_translation_tpu.train import prepare_mcv as jmcv
from expressive_speech_translation_tpu.train import run as jrun
from expressive_speech_translation_tpu.train import sft as jsft
from expressive_speech_translation_tpu_torch.core.config import TrainConfig
from expressive_speech_translation_tpu_torch.models import cosyvoice as tcv
from expressive_speech_translation_tpu_torch.models import qwen2 as tq2
from expressive_speech_translation_tpu_torch.models import speech_tokenizer as tst
from expressive_speech_translation_tpu_torch.models.common import tree_from_numpy
from expressive_speech_translation_tpu_torch.obs import kvlogger as tkv
from expressive_speech_translation_tpu_torch.parallel import mesh as pmesh
from expressive_speech_translation_tpu_torch.train import checkpoint as tckpt
from expressive_speech_translation_tpu_torch.train import data as tdata
from expressive_speech_translation_tpu_torch.train import executor as texec
from expressive_speech_translation_tpu_torch.train import plot as tplot
from expressive_speech_translation_tpu_torch.train import prepare_mcv as tmcv
from expressive_speech_translation_tpu_torch.train import run as trun
from expressive_speech_translation_tpu_torch.train import sft as tsft

from test_train_e2e import SENTENCES, _write_wav

RTOL = 1e-5


def _fields(cfg):
    return {f: getattr(cfg, f) for f in cfg.__dataclass_fields__}


def _lm_cfgs(mtp=1, hidden=32, speech=20, text=50, max_positions=128):
    jcfg = jcv.SpeechLMConfig(
        backbone=jq2.Qwen2Config(hidden=hidden, layers=2, heads=4, kv_heads=2,
                                 ffn_dim=2 * hidden, max_positions=max_positions),
        text_vocab=text, speech_token_size=speech, mtp=mtp)
    tcfg = tcv.SpeechLMConfig(**{**_fields(jcfg),
                                 "backbone": tq2.Qwen2Config(**_fields(jcfg.backbone))})
    return jcfg, tcfg


def _tree(params):
    return tree_from_numpy(jax.tree.map(np.asarray, params), "cpu", torch.float32)


def _paths(tree, prefix=""):
    """{key path: numpy array} of a nested dict / list tree (dict keys in
    sorted order, as JAX returns its gradient trees)."""
    if isinstance(tree, dict):
        return {k: v for key in sorted(tree) for k, v in _paths(tree[key], f"{prefix}/{key}").items()}
    if isinstance(tree, (list, tuple)):
        return {k: v for i, x in enumerate(tree) for k, v in _paths(x, f"{prefix}/{i}").items()}
    return {prefix: tree.detach().numpy() if torch.is_tensor(tree) else np.asarray(tree)}


def _like(tree, leaves):
    """``tree``'s structure over ``leaves`` (an iterator, in tree_leaves order)."""
    if isinstance(tree, dict):
        return {k: _like(v, leaves) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return [_like(v, leaves) for v in tree]
    return next(leaves)


def assert_trees_close(got, want, rtol=RTOL, noise_atol=None):
    """Each leaf within ``rtol`` of its own peak magnitude. With
    ``noise_atol``, the attention key biases are held within that instead:
    their exact gradient is 0 (the bias shifts a query's logits by one
    constant, which softmax ignores), so each package's is rounding noise,
    which AdamW turns into an update of up to ±lr."""
    g, w = _paths(got), _paths(want)
    assert list(g) == list(w)
    bad = []
    for path in w:
        if noise_atol is not None and path.endswith("/k/bias"):
            np.testing.assert_allclose(g[path], w[path], rtol=0, atol=noise_atol, err_msg=path)
            continue
        peak = float(np.abs(w[path]).max()) or 1.0
        err = float(np.abs(g[path] - w[path]).max())
        if err > rtol * peak:
            bad.append((path, err, peak))
    assert not bad, bad


def _jbatch(b):
    return jsft.SFTBatch(*(jnp.asarray(x) for x in b))


def _ragged_batch(seed, rows=((3, 4), (5, 2), (1, 6)), tt=6, ts=7, text=50, speech=20, accum=None):
    """Rows of (n_text, n_speech) padded into (tt, ts) buckets, int32 + bool."""
    g = np.random.default_rng(seed)
    out = []
    for _ in range(accum or 1):
        tok = np.zeros((len(rows), tt), np.int32)
        tmask = np.zeros((len(rows), tt), bool)
        sp = np.zeros((len(rows), ts), np.int32)
        smask = np.zeros((len(rows), ts), bool)
        for i, (nt, ns) in enumerate(rows):
            tok[i, :nt], tmask[i, :nt] = g.integers(1, text, nt), True
            sp[i, :ns], smask[i, :ns] = g.integers(0, speech, ns), True
        out.append(jsft.SFTBatch(tok, tmask, sp, smask))
    if accum is None:
        return out[0]
    return jsft.SFTBatch(*(np.stack(x) for x in zip(*out)))


# ------------------------------------------------------------------ the model


def test_qwen2_forward_matches_jax():
    jcfg, tcfg = _lm_cfgs(hidden=48)
    params = jax.jit(lambda k: jq2.init_qwen2(k, jcfg.backbone))(jax.random.PRNGKey(0))
    g = np.random.default_rng(0)
    x = g.standard_normal((2, 9, 48)).astype(np.float32)
    keep = np.ones((2, 9), bool)
    keep[1, 6:] = False
    mask = np.tril(np.ones((9, 9), bool))[None, None] & keep[:, None, None, :]
    for m, offset in ((None, 0), (mask, 3)):
        want = jax.jit(lambda p, x, m: jq2.forward(p, jcfg.backbone, x, attn_mask=m,
                                                   pos_offset=offset))(params, x, m)
        got = tq2.forward(_tree(params), tcfg.backbone, torch.from_numpy(x),
                          attn_mask=None if m is None else torch.from_numpy(m),
                          pos_offset=offset)
        np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=RTOL, atol=RTOL)


def _jax_value_and_grad(jcfg, params, batch, dtype=jnp.float32):
    return jax.jit(jax.value_and_grad(
        lambda p, b: jsft.lm_loss(p, jcfg, b, compute_dtype=dtype), has_aux=True))(
            params, _jbatch(batch))


def _port_value_and_grad(tcfg, params, batch, dtype=torch.float32):
    tp = _tree(params)
    leaves = tsft.tree_leaves(tp)
    for leaf in leaves:
        leaf.requires_grad_(True)
    loss, metrics = tsft.lm_loss(tp, tcfg, tsft.batch_to(batch, "cpu"), compute_dtype=dtype)
    return loss, metrics, _like(tp, iter(torch.autograd.grad(loss, leaves)))


@pytest.mark.parametrize("mtp", [1, 3])
def test_lm_loss_and_its_gradients_match_jax(mtp):
    jcfg, tcfg = _lm_cfgs(mtp=mtp)
    params = jax.jit(lambda k: jcv.init_speech_lm(k, jcfg))(jax.random.PRNGKey(mtp))
    batch = _ragged_batch(mtp)
    (jloss, jm), jgrads = _jax_value_and_grad(jcfg, params, batch)
    loss, metrics, grads = _port_value_and_grad(tcfg, params, batch)
    assert set(metrics) == set(jm)
    for k in jm:
        np.testing.assert_allclose(float(metrics[k].detach()), float(jm[k]), rtol=RTOL, err_msg=k)
    np.testing.assert_allclose(float(loss.detach()), float(jloss), rtol=RTOL)
    assert_trees_close(grads, jgrads)
    if mtp > 1:
        assert all(float(np.abs(h["kernel"].numpy()).max()) > 0 for h in grads["mtp_heads"])


@pytest.mark.parametrize("mtp", [1, 2])
def test_lm_loss_is_invariant_to_the_text_padding_bucket(mtp):
    """A row whose text underfills its bucket has its speech block at
    2 + n_valid_text: its loss equals the same row at its exact length, in
    both packages."""
    jcfg, tcfg = _lm_cfgs(mtp=mtp)
    params = jax.jit(lambda k: jcv.init_speech_lm(k, jcfg))(jax.random.PRNGKey(7))
    tp = _tree(params)
    exact = _ragged_batch(3, rows=((3, 5),), tt=3, ts=5)
    padded = jsft.SFTBatch(np.pad(exact.text_tokens, ((0, 0), (0, 5))),
                           np.pad(exact.text_mask, ((0, 0), (0, 5))), *exact[2:])
    key = "mtp_loss" if mtp > 1 else "loss"
    got = [float(tsft.lm_loss(tp, tcfg, tsft.batch_to(b, "cpu"),
                              compute_dtype=torch.float32)[1][key]) for b in (exact, padded)]
    want = float(jax.jit(lambda p, b: jsft.lm_loss(p, jcfg, b, compute_dtype=jnp.float32))(
        params, _jbatch(padded))[1][key])
    np.testing.assert_allclose(got[1], got[0], rtol=RTOL)
    np.testing.assert_allclose(got[1], want, rtol=RTOL)


def test_lm_loss_bf16_policy_casts_the_tree_and_keeps_f32_gradients():
    """bf16 compute as JAX runs it (the f32 tree cast inside the loss): the
    loss within bf16's reach of JAX's, f32 gradients into the f32 tree."""
    jcfg, tcfg = _lm_cfgs()
    params = jax.jit(lambda k: jcv.init_speech_lm(k, jcfg))(jax.random.PRNGKey(2))
    batch = _ragged_batch(2)
    (jloss, _), _ = _jax_value_and_grad(jcfg, params, batch, jnp.bfloat16)
    loss, metrics, grads = _port_value_and_grad(tcfg, params, batch, torch.bfloat16)
    assert loss.dtype == torch.float32 and metrics["acc"].dtype == torch.float32
    assert all(g.dtype == torch.float32 for g in tsft.tree_leaves(grads))
    np.testing.assert_allclose(float(loss.detach()), float(jloss), rtol=1e-2)


def test_lm_loss_refuses_a_batch_past_max_positions():
    _, tcfg = _lm_cfgs(max_positions=16)
    tp = tcv.init_speech_lm(tcv.Init(0, "cpu"), tcfg)
    with pytest.raises(ValueError, match="exceeds backbone max_positions 16"):
        tsft.lm_loss(tp, tcfg, tsft.batch_to(_ragged_batch(0, tt=6, ts=9), "cpu"))


FLOW = dict(token_vocab=23, dim=32, layers=1, heads=2, n_mels=8, spk_embed_dim=12)


@pytest.mark.parametrize("extra_frames", [-1, 1])   # slice and pad the token frames
def test_flow_matching_loss_and_its_gradient_match_jax_with_its_draws(extra_frames):
    jfc = jcv.FlowConfig(**FLOW)
    tfc = tcv.FlowConfig(**FLOW)
    params = jax.jit(lambda k: jcv.init_flow(k, jfc))(jax.random.PRNGKey(1))
    # the adaLN modulation starts at zero: give it weights so every path counts
    params = jax.tree.map(np.asarray, params)
    g = np.random.default_rng(5)
    for blk in params["blocks"]:
        blk["ada"]["kernel"] = (0.05 * g.standard_normal(blk["ada"]["kernel"].shape)
                                ).astype(np.float32)
    b, t_tok = 6, 5
    t_frames = 2 * t_tok + extra_frames
    mel = g.standard_normal((b, t_frames, 8)).astype(np.float32)
    toks = g.integers(0, 20, (b, t_tok)).astype(np.int32)
    tmask = np.ones((b, t_tok), bool)
    tmask[2, 3:] = False
    spk = g.standard_normal((b, 12)).astype(np.float32)
    key = jax.random.PRNGKey(11)
    want, jgrad = jax.jit(jax.value_and_grad(
        lambda p: jcv.flow_matching_loss(p, jfc, key, mel, toks, tmask, spk)))(params)
    # JAX's five draws, rebuilt from its key
    k1, k2, k3, k4, k5 = jax.random.split(key, 5)
    draws = tcv.FlowLossDraws(*(torch.from_numpy(np.array(d)) for d in (
        jax.random.normal(k1, mel.shape, jnp.float32),
        jax.random.uniform(k2, (b,), jnp.float32), jax.random.uniform(k3, (b,)),
        jax.random.uniform(k4, (b,)), jax.random.uniform(k5, (b,)))))
    # the draws take every branch: a prompt prefix, no prefix, a dropped row
    assert (draws.prompt_u < 0.5).any() and (draws.prompt_u >= 0.5).any()
    assert (draws.drop_u < 0.2).any()
    tp = tree_from_numpy(params, "cpu", torch.float32)
    leaves = tsft.tree_leaves(tp)
    for leaf in leaves:
        leaf.requires_grad_(True)
    got = tcv.flow_matching_loss(tp, tfc, draws, torch.from_numpy(mel), torch.from_numpy(toks),
                                 torch.from_numpy(tmask), torch.from_numpy(spk))
    grads = _like(tp, iter(torch.autograd.grad(got, leaves)))
    np.testing.assert_allclose(float(got.detach()), float(want), rtol=RTOL)
    assert_trees_close(grads, jgrad)
    sampled = tcv.FlowLossDraws.sample(torch.Generator().manual_seed(0), mel.shape, "cpu")
    assert sampled.x0.shape == mel.shape and sampled.drop_u.shape == (b,)


# ---------------------------------------------------------------- optimizer


@pytest.mark.parametrize("scheduler", ["constant", "warmup_cosine", "warmuplr"])
def test_three_optimizer_steps_match_optax(scheduler):
    """Three updates of each schedule with weight decay; the second step's
    gradient is over the clip, so optax's clip_by_global_norm scales it;
    warmup_cosine's first update has lr 0 and leaves the tree as it was."""
    kw = dict(grad_clip=1.0, scheduler=scheduler, warmup_steps=2, total_steps=6,
              weight_decay=0.01)
    jopt = jsft.make_optimizer(1e-2, **kw)
    topt = tsft.make_optimizer(1e-2, **kw)
    g = np.random.default_rng(3)
    params = {"a": g.standard_normal((4, 3)).astype(np.float32),
              "b": [g.standard_normal((5,)).astype(np.float32)]}
    grads = [jax.tree.map(lambda x: (s * g.standard_normal(x.shape)).astype(np.float32), params)
             for s in (0.1, 5.0, 0.2)]
    assert float(optax.global_norm(grads[1])) > 1.0 > float(optax.global_norm(grads[0]))
    jstate, jp = jopt.init(params), params
    tp = tree_from_numpy(params, "cpu", torch.float32)
    topt_state = topt.init(tp)
    for count, gr in enumerate(grads):
        upd, jstate = jax.jit(jopt.update)(gr, jstate, jp)
        jp = optax.apply_updates(jp, upd)
        before = [x.clone() for x in tsft.tree_leaves(tp)]
        with torch.no_grad():
            topt.update([torch.from_numpy(x) for x in tsft.tree_leaves(gr)], topt_state, count)
        assert_trees_close(tp, jp)
        if scheduler == "warmup_cosine" and count == 0:
            assert all(torch.equal(a, b) for a, b in zip(before, tsft.tree_leaves(tp)))


def test_warmup_cosine_requires_total_steps_and_unknown_schedulers_raise():
    with pytest.raises(ValueError, match="total_steps"):
        tsft.make_optimizer(1e-4, scheduler="warmup_cosine", warmup_steps=100)
    tsft.make_optimizer(1e-4, scheduler="warmup_cosine", warmup_steps=100, total_steps=1000)
    with pytest.raises(ValueError, match="unknown scheduler"):
        tsft.make_optimizer(1e-4, scheduler="linear")


def test_two_train_steps_match_jax():
    """build_step_fn over 2 microbatches with MTP heads, twice, f32, at the
    published lr 1e-5: loss, acc, mtp_loss and grad_norm, then the updated
    tree (the first step's gradient is clipped). AdamW turns a gradient
    element at rounding level into an update of up to ±lr, so the tree is
    held at an lr whose updates stay within 1e-5 of each tensor's peak."""
    lr = 1e-5
    jcfg, tcfg = _lm_cfgs(mtp=2)
    jopt = jsft.make_optimizer(lr, grad_clip=1.0, weight_decay=0.01)
    topt = tsft.make_optimizer(lr, grad_clip=1.0, weight_decay=0.01)
    jstate = jsft.init_train_state(jax.random.PRNGKey(0), jcfg, jopt)
    tstate = tsft.init_train_state(0, tcfg, topt, params=_tree(jstate.params))
    jstep = jsft.make_train_step(jcfg, jopt, accum_grad=2, compute_dtype=jnp.float32)
    tstep = tsft.make_train_step(tcfg, topt, accum_grad=2, compute_dtype=torch.float32)
    norms = []
    for seed in (0, 1):
        batch = _ragged_batch(seed, accum=2)
        tstate, tm = tstep(tstate, batch)
        jstate, jm = jstep(jstate, _jbatch(batch))
        assert set(tm) == set(jm) == {"loss", "acc", "grad_norm", "mtp_loss"}
        for k in jm:
            np.testing.assert_allclose(float(tm[k]), float(jm[k]), rtol=RTOL, err_msg=k)
        norms.append(float(tm["grad_norm"]))
        assert tstate.step == int(jstate.step)
    assert norms[0] > 1.0
    assert_trees_close(tstate.params, jstate.params, noise_atol=2 * 2 * lr)


def test_make_train_step_and_run_refuse_a_mesh_naming_item_12(tmp_path, monkeypatch, caplog):
    """Both take a mesh now: the data-parallel step over two CPU slots gives
    the one-device step's metrics and parameters, and ``run.main`` with
    ``mesh.coordinator`` set joins a torch.distributed group of one (gloo)
    and trains."""
    import socket

    _, tcfg = _lm_cfgs(mtp=2)
    states, metrics = [], []
    for mesh in (None, pmesh.host_cpu_mesh(2)):
        opt = tsft.make_optimizer(1e-3)
        state = tsft.init_train_state(0, tcfg, opt, device="cpu")
        step = tsft.make_train_step(tcfg, opt, mesh=mesh, accum_grad=2,
                                    compute_dtype=torch.float32)
        for seed in (0, 1):
            state, m = step(state, _ragged_batch(seed, rows=((3, 4), (5, 2), (1, 6), (2, 7)),
                                                 accum=2))
        states.append(state)
        metrics.append(m)
    assert set(metrics[0]) == set(metrics[1]) == {"loss", "acc", "grad_norm", "mtp_loss"}
    for k in metrics[0]:
        np.testing.assert_allclose(float(metrics[1][k]), float(metrics[0][k]), rtol=RTOL,
                                   err_msg=k)
    assert_trees_close(states[1].params, states[0].params, noise_atol=2 * 2 * 1e-3)

    (tmp_path / "text").write_text("u1 kalimera\n")
    (tmp_path / "wav.scp").write_text("u1 /nonexistent/u1.wav\n")
    with socket.socket() as sock:
        sock.bind(("127.0.0.1", 0))
        port = sock.getsockname()[1]
    monkeypatch.setenv("EST_MESH__COORDINATOR", f"127.0.0.1:{port}")
    monkeypatch.setenv("EST_MESH__NUM_PROCESSES", "1")
    monkeypatch.setenv("EST_MESH__PROCESS_ID", "0")
    try:
        with caplog.at_level(logging.INFO):
            assert trun.main(["--data-dir", str(tmp_path), "--device", "cpu", "--tiny",
                              "--max-epochs", "1", "--checkpoint-dir",
                              str(tmp_path / "ck")]) == 0
        assert torch.distributed.is_initialized() and torch.distributed.get_world_size() == 1
        assert "torch.distributed initialized (gloo): process 0/1" in caplog.text
        assert "starting at step 0 on cpu" in caplog.text
    finally:
        if torch.distributed.is_initialized():
            torch.distributed.destroy_process_group()


# --------------------------------------------------------------------- data


def _samples(n=40, seed=0):
    g = np.random.default_rng(seed)
    out = []
    for i in range(n):
        ns = int(g.integers(3, 90))
        out.append({"utt_id": f"u{i}", "text_tokens": g.integers(4, 260, int(g.integers(2, 40))).tolist(),
                    "speech_tokens": g.integers(0, 6561, ns).tolist(), "num_frames": ns})
    return out


def _cfgs(**kw):
    return JTrainConfig(**kw), TrainConfig(**kw)


@pytest.mark.parametrize("accum,rows_multiple", [(1, 1), (2, 1), (3, 2)])
def test_batches_from_samples_form_the_same_arrays(accum, rows_multiple):
    jc, tc = _cfgs(max_frames_in_batch=300, shuffle_buffer=16, sort_buffer=8)
    samples = _samples()
    want = list(jexec.batches_from_samples(iter(samples), jc, accum=accum, seed=5,
                                           rows_multiple=rows_multiple))
    got = list(texec.batches_from_samples(iter(samples), tc, accum=accum, seed=5,
                                          rows_multiple=rows_multiple))
    assert len(got) == len(want) > 2
    for g, w in zip(got, want):
        for a, b in zip(g, w):
            assert a.dtype == b.dtype and a.shape == b.shape and a.shape[0] == accum
            np.testing.assert_array_equal(a, b)


def test_the_data_stages_match_jax():
    samples = [{"num_frames": n, "text_tokens": list(range(n % 5))} for n in range(1, 300)]

    def run(d):
        return [s["num_frames"] for s in d.sort_buffer(d.shuffle_buffer(
            d.filter_samples(samples, max_frames=250), 50, seed=1), 64)]

    assert run(tdata) == run(jdata)
    lens = [{"num_frames": n} for n in (100, 120, 500, 900, 1500, 80, 90, 30)]
    for buckets in (None, (32, 64, 128, 256, 512, 1024, 2048)):
        def frames(d):
            return [[s["num_frames"] for s in b]
                    for b in d.DynamicFrameBatcher(2000, pad_to_bucket=buckets)(lens)]
        assert frames(tdata) == frames(jdata)
    group = [{"speech_tokens": list(range(700))}, {"speech_tokens": [4, 5]}]
    for d in (tdata, jdata):
        assert d.bucket_length(700, (32, 64, 128, 200, 256, 512)) == 1024
    want = jdata.pad_batch(group, ("speech_tokens",), buckets=(32, 512))
    got = tdata.pad_batch(group, ("speech_tokens",), buckets=(32, 512))
    assert got.keys() == want.keys()
    for k in want:
        np.testing.assert_array_equal(got[k], want[k])


def test_pad_batch_refuses_a_width_below_a_sample(monkeypatch):
    """bucket_length doubles past the top bucket, so only a width below the
    sample (a bucket policy that does not cover the data) trips the guard."""
    monkeypatch.setattr(tdata, "bucket_length", lambda n, buckets: 4)
    with pytest.raises(ValueError, match="bucket list does not cover the data"):
        tdata.pad_batch([{"x": [1] * 9}], ("x",), buckets=(4,))


# -------------------------------------------------------------- checkpoints


def _tiny_state(seed=0, lr=1e-2):
    _, tcfg = _lm_cfgs()
    opt = tsft.make_optimizer(lr, weight_decay=0.01)
    return tcfg, opt, tsft.init_train_state(seed, tcfg, opt, device="cpu")


def _leaves_equal(a, b):
    return all(torch.equal(x, y) for x, y in zip(tsft.tree_leaves(a), tsft.tree_leaves(b)))


def test_checkpoint_save_policy_keep_restore_and_meta(tmp_path):
    tcfg, opt, state = _tiny_state()
    step = tsft.make_train_step(tcfg, opt, accum_grad=1, compute_dtype=torch.float32)
    batch = _ragged_batch(0, accum=1)
    mgr = tckpt.CheckpointManager(tmp_path / "ck", keep=2, save_interval_steps=3)
    assert mgr.latest_step() is None and mgr.restore(state) is None
    saved = {}
    for _ in range(7):
        state, m = step(state, batch)
        if mgr.save(state, metrics={"loss": m["loss"]}):
            saved[state.step] = [x.detach().clone() for x in tsft.tree_leaves(state.params)]
    # the first save always, then every third step; two kept
    assert sorted(saved) == [1, 3, 6] and mgr.all_steps() == [3, 6] and mgr.latest_step() == 6
    assert not mgr.save(state)                        # step 7: off the interval
    assert mgr.save(state, force=True) and mgr.all_steps() == [6, 7]
    assert not mgr.save(state, force=True)            # re-saving a step is a no-op
    assert json.loads((tmp_path / "ck" / "6" / "metrics.json").read_text())["loss"] > 0
    assert not list((tmp_path / "ck").glob(".tmp-*"))
    _, _, template = _tiny_state(seed=1)
    restored = mgr.restore(template, step=6)
    assert restored.step == 6
    assert all(torch.equal(a, b) for a, b in zip(tsft.tree_leaves(restored.params), saved[6]))
    restored = mgr.restore(template)
    assert restored.step == 7 and _leaves_equal(restored.params, state.params)
    for p, q in zip(tsft.tree_leaves(state.params), tsft.tree_leaves(restored.params)):
        a, b = state.opt_state.state[p], restored.opt_state.state[q]
        assert torch.equal(a["exp_avg"], b["exp_avg"]) and float(a["step"]) == float(b["step"])
    mgr.save_meta({"epoch": 2, "epoch_start_step": 5})
    assert tckpt.CheckpointManager(tmp_path / "ck").load_meta() == {"epoch": 2,
                                                                    "epoch_start_step": 5}
    (tmp_path / "ck" / "meta.json").write_text("{not json")
    assert mgr.load_meta() == {}


def test_n_steps_equal_k_steps_then_a_resumed_run_bit_for_bit(tmp_path):
    """An uninterrupted 2-epoch Executor.train against one interrupted one
    step into epoch 1 and resumed by a fresh Executor from its checkpoint:
    the same step count and the same tree, bit for bit (the crash-resume
    skip continues epoch 1 instead of replaying epoch 0)."""
    _, tcfg = _lm_cfgs(speech=6561, text=264, max_positions=512)
    tc = TrainConfig(learning_rate=3e-3, accum_grad=1, max_epochs=2, log_interval=100,
                     save_per_step=10_000, max_frames_in_batch=120, shuffle_buffer=8,
                     sort_buffer=4)
    samples = _samples(12, seed=2)

    def epoch_batches(epoch):
        return texec.batches_from_samples(iter(samples), tc, accum=1, seed=tc.seed + epoch)

    ref = texec.Executor(tcfg, tc, checkpoint_dir=False, device="cpu")
    final_ref = ref.train(ref.init_or_resume(), epoch_batches)
    assert final_ref.step >= 4
    ex1 = texec.Executor(tcfg, tc, checkpoint_dir=str(tmp_path / "ck"), device="cpu")
    state = ex1.train(ex1.init_or_resume(), epoch_batches, max_epochs=1)
    ex1.ckpt.save_meta({"epoch": 1, "epoch_start_step": state.step})
    state, _ = ex1.train_step(state, next(iter(epoch_batches(1))))
    assert ex1.ckpt.save(state, force=True)
    ex2 = texec.Executor(tcfg, tc, checkpoint_dir=str(tmp_path / "ck"), device="cpu")
    resumed = ex2.init_or_resume()
    assert resumed.step == state.step and _leaves_equal(resumed.params, state.params)
    final = ex2.train(resumed, epoch_batches)
    assert final.step == final_ref.step
    assert _leaves_equal(final.params, final_ref.params)


# ------------------------------------------------- the executor and the CLI


@pytest.fixture(scope="module")
def kaldi_dir(tmp_path_factory):
    """JAX's 4-utterance real-audio Kaldi fixture (tests/test_train_e2e.py)."""
    root = tmp_path_factory.mktemp("mcv_el")
    clips = root / "clips"
    clips.mkdir()
    with (root / "wav.scp").open("w") as scp, (root / "text").open("w") as txt:
        for i, sentence in enumerate(SENTENCES):
            wav = clips / f"utt{i}.wav"
            _write_wav(wav, 160 + 60 * i, seconds=0.4 + 0.15 * i)
            scp.write(f"spk001_utt{i} {wav}\n")
            txt.write(f"spk001_utt{i} {sentence}\n")
    return root


@pytest.fixture(scope="module")
def st_tree():
    """JAX's fixed-seed speech tokenizer tree, (JAX tree, port tree, cfg)."""
    from expressive_speech_translation_tpu.models import speech_tokenizer as jst

    cfg = jst.SpeechTokenizerConfig()
    params = host_init(jst.init_speech_tokenizer, 1986, cfg)
    tcfg = tst.SpeechTokenizerConfig(**_fields(cfg))
    return params, tst.from_jax_params(jax.tree.map(np.asarray, params), "cpu"), tcfg


def test_speech_tokenizer_frontend_is_token_exact_on_jax_tree(kaldi_dir, st_tree, monkeypatch):
    monkeypatch.delenv("EST_MODELS_DIR", raising=False)
    jfe = jrun.SpeechTokenizerFrontend()
    tfe = trun.SpeechTokenizerFrontend(device="cpu", weights=st_tree[1:])
    wavs = [line.split(" ", 1)[1] for line in (kaldi_dir / "wav.scp").read_text().splitlines()]
    for wav in wavs:
        want = jfe(wav)
        assert want and tfe(wav) == want
    assert tfe("/nonexistent/clip.mp3") is None and tfe.tokenize(np.zeros(100)) is None


def test_load_kaldi_dir_keeps_real_tokens_and_the_crc32_proxy(kaldi_dir, st_tree, tmp_path,
                                                              caplog):
    tfe = trun.SpeechTokenizerFrontend(device="cpu", weights=st_tree[1:])
    with caplog.at_level(logging.INFO):
        got = trun.load_kaldi_dir(kaldi_dir, tokenizer_frontend=tfe)
    assert "4 utterances tokenized from real audio" in caplog.text
    assert [s["speech_tokens"] for s in got] == [tfe(s["wav"]) for s in got]
    (tmp_path / "wav.scp").write_text("u1 /data/el/clips/nope.mp3\nu2 /data/el/clips/b.mp3\n")
    (tmp_path / "text").write_text("u1 kalimera\nu2 ti kanete\n")
    caplog.clear()
    with caplog.at_level(logging.WARNING):
        proxy = trun.load_kaldi_dir(tmp_path, device="cpu")
    assert "2/2 utterances fell back to proxy" in caplog.text
    assert proxy == jrun.load_kaldi_dir(tmp_path)


def _f32_steps(monkeypatch, *modules):
    """Both executors' steps and CV in f32 (their default is bf16)."""
    for mod, sft, dtype in modules:
        monkeypatch.setattr(mod, "make_train_step",
                            functools.partial(sft.make_train_step, compute_dtype=dtype))
        monkeypatch.setattr(mod, "eval_step", functools.partial(sft.eval_step, compute_dtype=dtype))


def _numbers(line):
    return [float(x) for x in re.findall(r"[-+]?\d+\.\d+(?:e[-+]?\d+)?", line)]


def test_executor_train_matches_jax_on_the_kaldi_fixture(kaldi_dir, tmp_path, monkeypatch,
                                                         caplog):
    """Two epochs with CV at a save point and at each epoch end, f32: the
    loss trajectory within 1e-4 of JAX's, the same metric-sink rows and the
    same log lines (the rate aside)."""
    _f32_steps(monkeypatch, (jexec, jsft, jnp.float32), (texec, tsft, torch.float32))
    samples = jrun.load_kaldi_dir(kaldi_dir)
    jcfg, tcfg = _lm_cfgs(hidden=48, speech=6561, text=264, max_positions=512)
    kw = dict(learning_rate=3e-3, accum_grad=1, max_epochs=2, log_interval=1, save_per_step=3,
              max_frames_in_batch=40, shuffle_buffer=8, sort_buffer=4, keep_checkpoints=1)
    jc, tc = _cfgs(**kw)
    jex = jexec.Executor(jcfg, jc, checkpoint_dir=str(tmp_path / "j"))
    jstate = jex.init_or_resume()
    tex = texec.Executor(tcfg, tc, checkpoint_dir=str(tmp_path / "t"), device="cpu")
    tstate = tex.init_or_resume(params=_tree(jstate.params))   # before JAX donates it
    rows = {"jax": [], "torch": []}
    logs = {}
    for name, ex, state, mod in (("jax", jex, jstate, jexec), ("torch", tex, tstate, texec)):
        caplog.clear()
        with caplog.at_level(logging.INFO, logger=mod.__name__):
            ex.train(state, lambda e: mod.batches_from_samples(iter(samples), ex.cfg, accum=1,
                                                               seed=ex.cfg.seed + e),
                     cv_batches=lambda: mod.batches_from_samples(iter(samples[:2]), ex.cfg,
                                                                 accum=1, seed=0),
                     metric_sink=rows[name].append)
        logs[name] = [r.getMessage() for r in caplog.records if r.name == mod.__name__]
    assert len(rows["torch"]) == len(rows["jax"]) > 6
    for got, want in zip(rows["torch"], rows["jax"]):
        assert got.keys() == want.keys()
        for k in want:
            if k == "it_per_s":
                continue
            if isinstance(want[k], float):
                np.testing.assert_allclose(got[k], want[k], rtol=1e-4, err_msg=k)
            else:
                assert got[k] == want[k], k
    assert any(r["phase"] == "cv" and r["step"] % 3 == 0 for r in rows["torch"])
    assert len(logs["torch"]) == len(logs["jax"])
    for got, want in zip(logs["torch"], logs["jax"]):
        strip = lambda s: re.sub(r"\(.*it/s\)", "", re.sub(r"[-+]?\d+\.\d+", "#", s))
        assert strip(got) == strip(want)
        if "it/s" not in want:
            np.testing.assert_allclose(_numbers(got), _numbers(want), rtol=1e-4)
        else:
            np.testing.assert_allclose(_numbers(got)[:3], _numbers(want)[:3], rtol=1e-4)
    assert sorted(p.name for p in (tmp_path / "t").iterdir() if p.name.isdigit()) == \
        [str(max(r["step"] for r in rows["torch"]))]


def test_run_main_tiny_trains_resumes_exports_and_the_export_serves(tmp_path, caplog):
    tsv = tmp_path / "v.tsv"
    lines = ["client_id\tpath\tsentence"]
    lines += [f"c{i}\tclip{i}.mp3\tthis is sentence number {i} for training" for i in range(12)]
    tsv.write_text("\n".join(lines), encoding="utf-8")
    tmcv.prepare_mcv(tsv, tmp_path / "data")
    argv = ["--data-dir", str(tmp_path / "data"), "--checkpoint-dir", str(tmp_path / "ck"),
            "--max-epochs", "1", "--tiny", "--device", "cpu"]
    with caplog.at_level(logging.INFO):
        assert trun.main(argv) == 0
    assert "CV info" in caplog.text and "starting at step 0 on cpu" in caplog.text
    caplog.clear()
    with caplog.at_level(logging.INFO):
        assert trun.main(argv + ["--export-dir", str(tmp_path / "export")]) == 0
    m = re.search(r"starting at step (\d+)", caplog.text)
    assert m and int(m.group(1)) > 0

    from expressive_speech_translation_tpu_torch.models.loaders import load_converted
    from expressive_speech_translation_tpu_torch.pipeline.torch_engines import TorchCosyVoiceTts

    lm, lm_cfg = load_converted(tmp_path / "export" / "tts_llm", tcv.SpeechLMConfig,
                                device="cpu")
    assert lm_cfg == trun.tiny_lm_config()
    cfg = tcv.CosyVoiceConfig(lm=lm_cfg, flow=tcv.FlowConfig(token_vocab=6564, dim=32, layers=1,
                                                            heads=2),
                              vocoder=tcv.VocoderConfig(base_channels=32))
    params = {**tcv.init_cosyvoice(0, dataclasses.replace(cfg, lm=_lm_cfgs()[1]), "cpu"),
              "lm": lm}
    tts = TorchCosyVoiceTts(cfg, params, device="cpu", dtype=torch.float32,
                            seconds_per_char=0.02, noise=lambda i: tcv.GeneratorNoise(7, "cpu"))
    wave = tts.synthesize("kalimera")
    assert wave.size > 0 and np.isfinite(wave).all()


def test_prepare_mcv_and_plot_write_what_jax_writes(tmp_path, monkeypatch):
    tsv = tmp_path / "validated.tsv"
    tsv.write_text("client_id\tpath\tsentence\n"
                   "a\tclip1.mp3\tγειά σου κόσμε\n"
                   "b\tclip2.mp3\tκαλημέρα\n"
                   "c\t\tmissing path\n"
                   "d\tclip4.mp3\tτρίτη\n", encoding="utf-8")
    for max_utts in (0, 1):
        rows = [mod.prepare_mcv(tsv, tmp_path / f"{name}{max_utts}", speaker="spk9",
                                max_utts=max_utts)
                for name, mod in (("j", jmcv), ("t", tmcv))]
        assert rows[0] == rows[1]
        for f in ("wav.scp", "text", "utt2spk"):
            assert ((tmp_path / f"t{max_utts}" / f).read_bytes()
                    == (tmp_path / f"j{max_utts}" / f).read_bytes())
    log = tmp_path / "train.log"
    log.write_text(
        "x INFO TRAIN Batch 0/100 loss 3.500000 acc 0.200000 grad_norm 1.0 (1.8 it/s)\n"
        "x INFO TRAIN Batch 0/200 loss 3.100000 acc 0.240000 grad_norm 1.0 (1.8 it/s)\n"
        "x INFO Epoch 0 Step 250 CV info loss 3.978000 acc 0.224000\n"
        "x INFO TRAIN Batch 1/300 loss 2.500000 acc 0.300000 grad_norm 1.0 (1.8 it/s)\n")
    assert tplot.parse_logs([log]) == jplot.parse_logs([log])
    assert tplot.per_epoch(tplot.parse_logs([log])[0]) == jplot.per_epoch(jplot.parse_logs([log])[0])
    for blocked in (False, True):
        if blocked:   # no matplotlib: both write the CSV
            monkeypatch.setitem(sys.modules, "matplotlib", None)
        outs = [mod.write_outputs(*mod.parse_logs([log]), tmp_path / f"{name}{blocked}.png")
                for name, mod in (("j", jplot), ("t", tplot))]
        assert [o[-4:] for o in outs] == [".csv" if blocked else ".png"] * 2
        with open(outs[0], "rb") as a, open(outs[1], "rb") as b:
            assert a.read() == b.read()
    out = io.StringIO()
    with contextlib.redirect_stdout(out):
        assert tplot.main([str(log), "--out", str(tmp_path / "cli.png")]) == 0
    assert "parsed 3 train lines, 1 cv lines" in out.getvalue()


def test_kvlogger_files_equal_jax(tmp_path):
    def run(mod, d):
        d.mkdir()
        human = io.StringIO()
        logger = mod.make_logger(d, formats=("json", "csv"))
        logger.sinks.append(mod.HumanOutput(human))
        logger.logkv("step", 1)
        logger.logkv_mean("loss", 2.0)
        logger.logkv_mean("loss", 3.0)
        first = logger.dumpkvs()
        logger.logkv("step", 2)
        logger.logkv("acc", np.float32(0.5))
        logger.logkv("extra", "x")
        logger.dumpkvs()

        @logger.profile("f")
        def f():
            return 3

        assert f() == 3
        with logger.profile_kv("g"):
            pass
        assert {"wait_f", "wait_g"} <= set(logger.dumpkvs())
        resumed = mod.CSVOutput(d / "progress.csv")     # a resumed process keeps the columns
        assert resumed.keys[:4] == ["loss", "step", "acc", "extra"]
        return first, human.getvalue().split("| wait_f")[0]

    got = run(tkv, tmp_path / "t")
    want = run(jkv, tmp_path / "j")
    assert got == want
    assert ((tmp_path / "t" / "progress.json").read_text().splitlines()[:2]
            == (tmp_path / "j" / "progress.json").read_text().splitlines()[:2])
    assert ((tmp_path / "t" / "progress.csv").read_text().splitlines()[:3]
            == (tmp_path / "j" / "progress.csv").read_text().splitlines()[:3])
