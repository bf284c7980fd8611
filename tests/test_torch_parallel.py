"""The port's meshes, partition rules, stage placement, sequence-parallel
vocoding and data-parallel training (``parallel/``), against the JAX
package on the CPU.

JAX runs on its 8 virtual CPU devices (``tests/conftest.py``); the port's
meshes are CPU slots (``parallel.mesh.cpu_slots``). Where JAX computes
something of its own (the specs, the meshes and their report, the sharded
loss, ``vocode_sp``, the single-process train step) the port is held to it;
the meshed engines are held to the port's unmeshed engines, which the other
``test_torch_*`` files hold to JAX: TP and DP are layouts, not numerics.
"""

import json
import os
import socket
import subprocess
import sys
import threading
from pathlib import Path

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp
from jax.sharding import NamedSharding, PartitionSpec as P

from expressive_speech_translation_tpu.models import cosyvoice as jcv
from expressive_speech_translation_tpu.models import nllb as jnl
from expressive_speech_translation_tpu.models import qwen2 as jq2
from expressive_speech_translation_tpu.models import whisper as jwh
from expressive_speech_translation_tpu.parallel import mesh as jmesh
from expressive_speech_translation_tpu.parallel import partition as jpart
from expressive_speech_translation_tpu.parallel import stages as jstages
from expressive_speech_translation_tpu.train import sft as jsft
from expressive_speech_translation_tpu_torch.models import cosyvoice as tcv
from expressive_speech_translation_tpu_torch.models import nllb as tnl
from expressive_speech_translation_tpu_torch.models import qwen2 as tq2
from expressive_speech_translation_tpu_torch.models import whisper as twh
from expressive_speech_translation_tpu_torch.models.common import tree_from_numpy
from expressive_speech_translation_tpu_torch.parallel import mesh as tmesh
from expressive_speech_translation_tpu_torch.parallel import partition as tpart
from expressive_speech_translation_tpu_torch.parallel import stages as tstages
from expressive_speech_translation_tpu_torch.parallel.partition import Shards
from expressive_speech_translation_tpu_torch.pipeline.cascaded import CascadedBackend
from expressive_speech_translation_tpu_torch.pipeline.engines import Engines
from expressive_speech_translation_tpu_torch.pipeline.torch_engines import (
    TorchCosyVoiceTts, TorchNllbNmt, TorchWhisperAsr, torch_engines)
from expressive_speech_translation_tpu_torch.serve.batching import (BatchedAsr, BatchedNmt,
                                                                    BatchedTts)
from expressive_speech_translation_tpu_torch.train import sft as tsft

REPO = Path(__file__).resolve().parent.parent
F32 = torch.float32

JLM = jcv.SpeechLMConfig(
    backbone=jq2.Qwen2Config(hidden=64, layers=1, heads=4, kv_heads=2, ffn_dim=128,
                             max_positions=128),
    text_vocab=96, speech_token_size=61)


def _fields(cfg):
    return {f: getattr(cfg, f) for f in cfg.__dataclass_fields__}


def _tlm(jcfg):
    return tcv.SpeechLMConfig(**{**_fields(jcfg),
                                 "backbone": tq2.Qwen2Config(**_fields(jcfg.backbone))})


def _np(tree):
    return jax.tree.map(np.asarray, tree)


def _port_mesh(dp, tp, n=8):
    return tmesh.make_mesh(tmesh.MeshSpec(dp=dp, tp=tp), devices=tmesh.cpu_slots(n))


def _ids(mesh):
    return sorted(d.id for d in mesh.devices.flat)


# ------------------------------------------------------------------- the specs


def _spec_trees():
    """(name, JAX tree of shapes, port tree, JAX rules, port rules) of every
    model the rules cover, float and int8, the speech LMs with MTP heads and
    with a head that tp does not divide. JAX's trees are its inits' shapes
    (``jax.eval_shape``), the port's its own inits: the paths must agree."""
    from expressive_speech_translation_tpu_torch.models.common import Init

    key = jax.random.PRNGKey(0)
    wcfg = jwh.WhisperConfig(n_mels=80, d_model=64, encoder_layers=1, decoder_layers=1,
                             heads=4, ffn_dim=128, vocab_size=96)
    ncfg = jnl.NLLBConfig(d_model=64, encoder_layers=1, decoder_layers=1, heads=4,
                          ffn_dim=128, vocab_size=96)
    jw = jax.eval_shape(lambda k: jwh.init_whisper(k, wcfg), key)
    jn = jax.eval_shape(lambda k: jnl.init_nllb(k, ncfg), key)
    tw = twh.init_whisper(0, twh.WhisperConfig(**_fields(wcfg)), "cpu")
    tn = tnl.init_nllb(0, tnl.NLLBConfig(**_fields(ncfg)), "cpu")
    out = []
    for q in (False, True):
        out.append((f"whisper q={q}", jax.eval_shape(jwh.quantize_whisper_decoder, jw) if q else jw,
                    twh.quantize_whisper_decoder(tw) if q else tw,
                    jwh.whisper_partition_rules("tp"), twh.whisper_partition_rules("tp")))
        out.append((f"nllb q={q}", jax.eval_shape(jnl.quantize_nllb_decoder, jn) if q else jn,
                    tnl.quantize_nllb_decoder(tn) if q else tn,
                    jnl.nllb_partition_rules("tp"), tnl.nllb_partition_rules("tp")))
        for mtp, speech in ((3, 61), (1, 50)):
            cfg = jcv.SpeechLMConfig(backbone=JLM.backbone, text_vocab=96,
                                     speech_token_size=speech, mtp=mtp)
            jl = jax.eval_shape(lambda k: jcv.init_speech_lm(k, cfg), key)
            r = Init(0, "cpu")
            tl = tcv.init_speech_lm(r, _tlm(cfg))
            if mtp > 1:
                tl["mtp_heads"] = tcv.init_mtp_heads(r, _tlm(cfg))
            out.append((f"lm q={q} mtp={mtp} heads={speech + 3}",
                        jax.eval_shape(jcv.quantize_speech_lm, jl) if q else jl,
                        tcv.quantize_speech_lm(tl) if q else tl,
                        jcv.speech_lm_partition_rules("tp"),
                        tcv.speech_lm_partition_rules("tp")))
    return out


@pytest.mark.parametrize("tp", [2, 4])
def test_spec_for_matches_jax_on_every_leaf(tp):
    jm = jmesh.make_mesh(jmesh.MeshSpec(dp=-1, tp=tp))
    tm = _port_mesh(-1, tp)
    sharded = 0
    for name, jtree, ttree, jrules, trules in _spec_trees():
        flat, _ = jpart._flatten_with_paths(jtree)
        want = {path: tuple(jrules.spec_for(path, leaf.shape, jm)) for path, leaf in flat}
        got = {path: trules.spec_for(path, leaf.shape, tm)
               for path, leaf in tpart.tree_paths(ttree)}
        assert got == want, name
        sharded += sum(1 for s in got.values() if s)
        # a 53-way head stays whole at any tp, as JAX's fallback keeps it
        if "heads=53" in name:
            assert got["head/bias"] == () and got["speech_embed"] == (None, "tp")
    assert sharded > 100


def test_placement_splits_by_spec_and_computes_the_same():
    """logical_to_sharding: split leaves become Shards on the group's slots,
    the rest stay whole on its lead; dense / tied head / embedding rows over
    the shards equal the whole tensors' (column and row splits, float and
    int8)."""
    from expressive_speech_translation_tpu_torch.models import common

    mesh = _port_mesh(2, 4)
    g = torch.Generator().manual_seed(0)
    tree = {"blk": {"self_attn": {"q": {"kernel": torch.randn(16, 12, generator=g),
                                        "bias": torch.randn(12, generator=g)},
                                  "o": {"kernel": torch.randn(12, 16, generator=g),
                                        "bias": torch.randn(16, generator=g)}},
                    "mlp_ln": {"scale": torch.ones(16), "bias": torch.zeros(16)}},
            "embed": torch.randn(10, 16, generator=g)}
    tree["embed_q"] = common.quantize_embed_head(tree["embed"])
    tree["blk"]["mlp"] = {"fc1": common.quantize_dense({"kernel": torch.randn(16, 8, generator=g),
                                                        "bias": torch.randn(8, generator=g)}),
                          "fc2": common.quantize_dense({"kernel": torch.randn(8, 16, generator=g)})}
    rules = common.transformer_partition_rules("tp")
    placed = tpart.logical_to_sharding(tree, mesh, rules, group=1)
    q = placed["blk"]["self_attn"]["q"]["kernel"]
    assert isinstance(q, Shards) and q.dim == 1 and q.slots == (4, 5, 6, 7)
    assert tuple(q.shape) == (16, 12) and [tuple(p.shape) for p in q.parts] == [(16, 3)] * 4
    assert placed["blk"]["self_attn"]["o"]["kernel"].dim == 0
    assert torch.is_tensor(placed["blk"]["mlp_ln"]["scale"])
    assert tpart.slot_ids(placed, mesh, 1) == [4, 5, 6, 7]
    specs = tpart.sharding_tree(tree, mesh, rules)
    assert specs["blk"]["self_attn"]["o"]["kernel"].spec == ("tp", None)
    assert specs["blk"]["mlp_ln"]["scale"].spec == () and specs["embed"].mesh is mesh
    x = torch.randn(3, 2, 16, generator=g)
    for name in ("q", "o"):
        h = x if name == "q" else torch.randn(3, 2, 12, generator=g)
        torch.testing.assert_close(common.dense(placed["blk"]["self_attn"][name], h),
                                   common.dense(tree["blk"]["self_attn"][name], h))
    for name, h in (("fc1", x), ("fc2", torch.randn(3, 2, 8, generator=g))):
        torch.testing.assert_close(common.dense(placed["blk"]["mlp"][name], h),
                                   common.dense(tree["blk"]["mlp"][name], h))
    for container in ({}, {"embed_q": None}):
        want_c = {k: tree[k] for k in container}
        got_c = {k: placed[k] for k in container}
        torch.testing.assert_close(common.tied_head_logits(got_c, x, placed["embed"]),
                                   common.tied_head_logits(want_c, x, tree["embed"]))
    ids = torch.tensor([[1, 9, 0], [4, 4, 2]])
    assert torch.equal(common.embed_rows(placed["embed"], ids), tree["embed"][ids])
    assert torch.equal(common.embed_rows(placed["embed"], 3), tree["embed"][3])
    assert tmesh.shard_params(tree, mesh)["embed"] is tree["embed"]   # no rules: whole, on the lead


# ------------------------------------------------------------------ the meshes


def test_mesh_spec_and_meshes_match_jax():
    for spec, n in ((jmesh.MeshSpec(), 8), (jmesh.MeshSpec(tp=2), 8), (jmesh.MeshSpec(dp=2, tp=-1), 8),
                    (jmesh.MeshSpec(dp=2, tp=4), 8), (jmesh.MeshSpec(dp=1, tp=1), 1)):
        port = tmesh.MeshSpec(spec.dp, spec.tp)
        assert port.resolve(n) == spec.resolve(n)
        jm = jmesh.make_mesh(spec, devices=jax.devices()[:n])
        tm = tmesh.make_mesh(port, devices=tmesh.cpu_slots(n))
        assert dict(tm.shape) == dict(jm.shape) and list(tm.shape) == ["dp", "tp"]
        assert [[s.id for s in row] for row in tm.devices] == \
            [[d.id for d in row] for row in jm.devices]
    for spec, n in (((-1, -1), 8), ((3, 1), 8), ((2, 3), 8)):
        with pytest.raises(ValueError) as want:
            jmesh.MeshSpec(*spec).resolve(n)
        with pytest.raises(ValueError) as got:
            tmesh.MeshSpec(*spec).resolve(n)
        assert str(got.value) == str(want.value)
    m = tmesh.host_cpu_mesh(8)
    assert dict(m.shape) == {"dp": 8, "tp": 1} and m.shape.get("tp", 1) == 1
    assert [s.id for s in m.devices.flat] == list(range(8)) and m.local_groups() == list(range(8))
    assert tmesh.data_sharding(m, 3).spec == tuple(jmesh.data_sharding(
        jmesh.host_cpu_mesh(8), 3).spec)
    assert tmesh.replicated(m).spec == tuple(jmesh.replicated(jmesh.host_cpu_mesh(8)).spec)
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="no CUDA device"):
            tmesh.make_mesh()


def test_stage_meshes_and_report_match_jax():
    for n in (1, 2, 8):
        for tp in (1, 2):
            if tp > n:
                with pytest.raises(ValueError) as want:
                    jstages.stage_meshes(devices=jax.devices()[:n], tp=tp)
                with pytest.raises(ValueError) as got:
                    tstages.stage_meshes(devices=tmesh.cpu_slots(n), tp=tp)
                assert str(got.value) == str(want.value)
                continue
            jm = jstages.stage_meshes(devices=jax.devices()[:n], tp=tp)
            tm = tstages.stage_meshes(devices=tmesh.cpu_slots(n), tp=tp)
            assert list(tm) == list(jm) == list(tstages.STAGES)
            for stage in tm:
                assert _ids(tm[stage]) == _ids(jm[stage])
                assert dict(tm[stage].shape) == dict(jm[stage].shape)
            assert tstages.placement_report(tm) == jstages.placement_report(jm)
    # the stages split 8 slots 2/2/4, disjoint
    tm = tstages.stage_meshes(devices=tmesh.cpu_slots(8))
    assert [_ids(tm[s]) for s in tstages.STAGES] == [[0, 1], [2, 3], [4, 5, 6, 7]]
    # capped at one group a stage, the spare slots stay unused
    tm = tstages.stage_meshes(devices=tmesh.cpu_slots(8), max_dp=1)
    assert [_ids(tm[s]) for s in tstages.STAGES] == [[0], [1], [2]]
    tm = tstages.stage_meshes(devices=tmesh.cpu_slots(8), tp=2, max_dp=1)
    assert [_ids(tm[s]) for s in tstages.STAGES] == [[0, 1], [2, 3], [4, 5]]


def test_dp_slices_follow_jax_dp_shard():
    groups = _port_mesh(4, 2).local_groups()
    assert tmesh.dp_slices(groups, 8) == [(0, 0, 2), (1, 2, 4), (2, 4, 6), (3, 6, 8)]
    assert tmesh.dp_slices(groups, 3) == [(0, 0, 3)]          # JAX leaves it replicated
    assert tmesh.dp_slices([0], 8) == tmesh.dp_slices(_port_mesh(1, 2, 2).local_groups(), 8) \
        == [(0, 0, 8)]
    assert tmesh.dp_slices([1, 3], 4) == [(1, 0, 2), (3, 2, 4)]   # a process's own groups
    assert tmesh.run_per_group(lambda a, b: a * b, [(2, 3), (4, 5)]) == [6, 20]


# ------------------------------------------------------------------- the loss


def _sft_batch(b=4, seed=0):
    g = np.random.default_rng(seed)
    smask = np.ones((b, 7), bool)
    smask[1, 4:] = smask[3, 2:] = False
    return (g.integers(0, 96, (b, 5)).astype(np.int32), np.ones((b, 5), bool),
            g.integers(0, 61, (b, 7)).astype(np.int32), smask)


@pytest.mark.parametrize("tp", [2, 4])
def test_lm_loss_under_tp_matches_jax_sharded(tp):
    params = jcv.init_speech_lm(jax.random.PRNGKey(1), JLM)
    batch = _sft_batch()
    jm = jmesh.make_mesh(jmesh.MeshSpec(dp=-1, tp=tp))
    rules = jcv.speech_lm_partition_rules("tp")
    p_sh = jpart.sharding_tree(params, jm, rules)
    data = NamedSharding(jm, P("dp"))
    jbatch = jax.device_put(jsft.SFTBatch(*(jnp.asarray(x) for x in batch)),
                            jsft.SFTBatch(*([data] * 4)))
    want = jax.jit(lambda p, b: jsft.lm_loss(p, JLM, b, compute_dtype=jnp.float32)[0],
                   in_shardings=(p_sh, jsft.SFTBatch(*([data] * 4))))(
        jax.device_put(params, p_sh), jbatch)

    tm = _port_mesh(-1, tp)
    placed = tpart.logical_to_sharding(tree_from_numpy(_np(params), "cpu"), tm,
                                       tcv.speech_lm_partition_rules("tp"))
    assert isinstance(placed["head"]["kernel"], Shards)
    assert isinstance(placed["backbone"]["layers"][0]["down"]["kernel"], Shards)
    got, _ = tsft.lm_loss(placed, _tlm(JLM), tsft.batch_to(tsft.SFTBatch(*batch), "cpu"),
                          compute_dtype=F32)
    np.testing.assert_allclose(float(got), float(want), rtol=2e-5, atol=2e-5)


# ----------------------------------------------------------------- the engines

WCFG = twh.WhisperConfig(n_mels=80, d_model=64, encoder_layers=1, decoder_layers=1, heads=4,
                         ffn_dim=128, vocab_size=365, max_target_positions=32, eos_token=260,
                         bos_token=261, lang_token_start=262, task_transcribe=362,
                         no_timestamps=363, sop_token=364, no_speech_token=360)
NCFG = tnl.NLLBConfig(d_model=64, encoder_layers=1, decoder_layers=1, heads=4, ffn_dim=128,
                      vocab_size=384)
TCFG = tcv.CosyVoiceConfig(
    lm=tcv.SpeechLMConfig(backbone=tq2.Qwen2Config(hidden=32, layers=1, heads=4, kv_heads=2,
                                                   ffn_dim=64, max_positions=512),
                          text_vocab=128, speech_token_size=61),
    flow=tcv.FlowConfig(token_vocab=64, dim=32, layers=1, heads=4, n_steps=2),
    vocoder=tcv.VocoderConfig(base_channels=32))


def _engines(mesh, **tts):
    return (TorchWhisperAsr(WCFG, device="cpu", dtype=F32, max_new_tokens=8,
                            context_buckets=(4,), mesh=mesh),
            TorchNllbNmt(NCFG, device="cpu", dtype=F32, max_new_tokens=8, mesh=mesh),
            TorchCosyVoiceTts(TCFG, device="cpu", dtype=F32, seconds_per_char=0.02, mesh=mesh,
                              noise=lambda i: tcv.GeneratorNoise(7 + i, "cpu"), **tts))


@pytest.fixture(scope="module")
def plain():
    return _engines(None)


def _audio(seed, seconds=2):
    g = np.random.default_rng(seed)
    return (0.2 * g.standard_normal(16_000 * seconds)).astype(np.float32)


def test_asr_and_nmt_under_a_dp4_tp2_mesh_are_token_exact(plain):
    mesh = _port_mesh(4, 2)
    asr, nmt, _ = plain
    masr, mnmt = (TorchWhisperAsr(WCFG, device="cpu", dtype=F32, max_new_tokens=8,
                                  context_buckets=(4,), mesh=mesh),
                  TorchNllbNmt(NCFG, device="cpu", dtype=F32, max_new_tokens=8, mesh=mesh))
    assert isinstance(masr.params["decoder"]["embed"], Shards) and len(masr.groups) == 4
    assert masr.slot_ids == list(range(8)) and masr.groups[3].device == torch.device("cpu")
    assert masr.groups[0] is masr and isinstance(masr.groups[3].params["decoder"]["embed"], Shards)
    audio = _audio(2)
    assert masr.transcribe(audio, language="eng") == asr.transcribe(audio, language="eng")
    text = ("bonjour tout le monde", "eng", "fra")
    assert mnmt.translate(*text) == nmt.translate(*text)
    calls = []
    for grp in masr.groups + mnmt.groups:       # which group runs which rows
        grp.__dict__["params"] = _Spy(grp.params, calls, grp)
    for rows in (4, 3):
        reqs = [{"audio_16k": _audio(3 + i), "language": "eng"} for i in range(rows)]
        assert masr.transcribe_batch(reqs) == asr.transcribe_batch(reqs)
        nreqs = [{"text": t, "source_lang": "eng", "target_lang": "fra"}
                 for t in ("hello there", "how are you", "good morning", "see you")[:rows]]
        assert mnmt.translate_batch(nreqs) == nmt.translate_batch(nreqs)
    used = {id(e) for e in calls}
    assert used == {id(e) for e in masr.groups + mnmt.groups}


class _Spy(dict):
    """A parameter dict that records which group's placement read it."""

    def __init__(self, tree, calls, owner):
        super().__init__(tree)
        self._calls, self._owner = calls, owner

    def __getitem__(self, key):
        self._calls.append(self._owner)
        return super().__getitem__(key)


def test_tts_under_tp_is_token_exact_and_dp_batches_match(plain):
    _, _, tts = plain
    mtts = _engines(_port_mesh(1, 2, 2))[2]
    lm = mtts.params["lm"]
    assert isinstance(lm["head"]["kernel"], Shards) and isinstance(lm["text_embed"], Shards)
    assert not isinstance(mtts.params["vocoder"]["conv_pre"]["kernel"], Shards)
    toks = torch.tensor([[5, 9, 3, 7, 0, 0]], dtype=torch.int32)
    tmask = toks != 0
    psp, psm = torch.zeros((1, 2), dtype=torch.int32), torch.ones((1, 2), dtype=torch.bool)
    spk, pmel = torch.zeros((1, 192)), torch.zeros((1, 4, 80))
    outs = [tcv.synthesize(e.params, TCFG, tcv.GeneratorNoise(3, "cpu"), toks, tmask, psp, psm,
                           spk, pmel, torch.ones((1, 4), dtype=torch.bool), max_new_tokens=64)
            for e in (tts, mtts)]
    assert torch.equal(outs[0]["speech_tokens"], outs[1]["speech_tokens"])
    assert int(outs[0]["token_lengths"][0]) > 2
    torch.testing.assert_close(outs[1]["audio"], outs[0]["audio"], rtol=0, atol=1e-4)
    ref = _audio(5, 1)
    dtts = _engines(_port_mesh(2, 2, 4))[2]
    reqs = [{"text": t, "reference_audio_16k": ref if i % 2 else None, "style_prompt": "",
             "language": "en"} for i, t in enumerate(("one", "two", "three", "four"))]
    for eng in (tts, dtts):
        eng._call_count = 0
    for x, y in zip(tts.synthesize_batch(reqs), dtts.synthesize_batch(reqs)):
        assert x.shape == y.shape and np.abs(x - y).max() <= 1e-4


def test_vocode_sp_matches_jax():
    jmesh8 = jmesh.make_mesh(jmesh.MeshSpec(dp=-1, tp=1))
    cfg = jcv.VocoderConfig(base_channels=32)
    jparams = jcv.init_vocoder(jax.random.PRNGKey(0), cfg)
    tparams = tcv.from_jax_params({"vocoder": _np(jparams)}, "cpu")["vocoder"]
    tcfg = tcv.VocoderConfig(**_fields(cfg))
    assert tcv.vocoder_halo_frames(tcv.VocoderConfig()) == 16
    g = np.random.default_rng(1)
    for t in (64, 101):
        mel = g.standard_normal((1, t, cfg.n_mels)).astype(np.float32)
        want = np.asarray(jcv.vocode_sp(jparams, cfg, jnp.asarray(mel), jmesh8, "dp"))
        got = tcv.vocode_sp(tparams, tcfg, torch.from_numpy(mel), _port_mesh(-1, 1), "dp")
        assert got.shape == want.shape == (1, t * cfg.hop)
        np.testing.assert_allclose(got.numpy(), want, rtol=1e-5, atol=1e-5)
    one = tcv.vocode_sp(tparams, tcfg, torch.from_numpy(mel), tmesh.host_cpu_mesh(1), "dp")
    assert torch.equal(one, tcv.vocode(tparams, tcfg, torch.from_numpy(mel)))


# ------------------------------------------------------------ the cascades


def test_tp_engines_behind_the_batchers_give_the_unsharded_transcripts(plain):
    asr, nmt, tts = plain
    ref = CascadedBackend(Engines(asr=asr, nmt=nmt, tts=tts)).translate_speech(
        _audio(7), "eng", "fra")
    masr, mnmt, mtts = _engines(_port_mesh(1, 2, 2))
    batched = Engines(asr=BatchedAsr(masr, max_wait_ms=30.0), nmt=BatchedNmt(mnmt, max_wait_ms=30.0),
                      tts=BatchedTts(mtts, max_wait_ms=30.0))
    backend = CascadedBackend(batched)
    assert batched.weights_info() == "random"
    results, errors = [None] * 4, []

    def worker(i):
        try:
            results[i] = backend.translate_speech(_audio(7), "eng", "fra")
        except Exception as e:  # noqa: BLE001
            errors.append(e)

    threads = [threading.Thread(target=worker, args=(i,)) for i in range(4)]
    for t in threads:
        t.start()
    for t in threads:
        t.join(timeout=120)
    for stage in (batched.asr, batched.nmt, batched.tts):
        stage.shutdown()
    assert not errors, errors[:1]
    for r in results:
        assert r["transcripts"] == ref["transcripts"]
        assert r["audio"].shape[0] == 1 and np.isfinite(r["audio"]).all() and r["audio"].size


def test_stage_placed_engines_hold_disjoint_slots_and_match(plain):
    meshes = tstages.stage_meshes(devices=tmesh.cpu_slots(8))
    asr, nmt, tts = plain
    placed = torch_engines(stage_meshes=meshes, device="cpu", dtype=F32, asr_cfg=WCFG,
                           nmt_cfg=NCFG, tts_cfg=TCFG, asr_context_buckets=(4,),
                           tts_noise=lambda i: tcv.GeneratorNoise(7 + i, "cpu"))
    placed.asr.max_new_tokens = placed.nmt.max_new_tokens = 8
    placed.tts.seconds_per_char = 0.02
    assert placed.placement_info() == {"asr": [0, 1], "nmt": [2, 3], "tts": [4, 5, 6, 7]}
    assert len(placed.tts.groups) == 4 and placed.tts.mesh is meshes["tts"]
    tts._call_count = 0
    out_p = CascadedBackend(placed).translate_speech(_audio(11, 1), "eng", "fra")
    out_b = CascadedBackend(Engines(asr=asr, nmt=nmt, tts=tts)).translate_speech(
        _audio(11, 1), "eng", "fra")
    assert out_p["transcripts"] == out_b["transcripts"]
    np.testing.assert_allclose(out_p["audio"], out_b["audio"], atol=1e-5)


# --------------------------------------------------------------- two processes


def _free_port() -> int:
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


@pytest.fixture(scope="module")
def two_ranks(tmp_path_factory):
    """Two processes × two CPU slots (dp=2 × tp=2, bootstrapped through
    MeshConfig), each running two SFT steps of JAX's initial tree and then
    placing engines (``tests/_torch_mp_worker.py``) → (each rank's JSON
    report, JAX's single-process metrics of the same two steps, the
    batches). The second batch gives the ranks different real-token
    counts."""
    import optax

    from _mp_common import TINY_LM, make_batch

    tmp_path = tmp_path_factory.mktemp("two_ranks")
    state = jsft.init_train_state(jax.random.PRNGKey(0), TINY_LM,
                                  optax.chain(optax.clip_by_global_norm(5.0), optax.adamw(1e-4)))
    second = [np.array(x) for x in make_batch()]
    second[3][:, 0, 3:] = second[3][:, 1, 5:] = False        # rank 0: fewer speech tokens
    second[2] = np.where(second[3], second[2], 0)
    batches = [make_batch(), tuple(second)]
    arrays = {f"p/{path}": np.asarray(leaf)
              for path, leaf in jpart._flatten_with_paths(state.params)[0]}
    for i, b in enumerate(batches):
        arrays.update({f"b{i}/{k}": np.asarray(v) for k, v in zip(jsft.SFTBatch._fields, b)})
    np.savez(tmp_path / "inputs.npz", **arrays)

    port = _free_port()
    env = {k: v for k, v in os.environ.items() if not k.startswith(("EST_MESH__", "MASTER_"))}
    procs = [subprocess.Popen([sys.executable, str(REPO / "tests" / "_torch_mp_worker.py"),
                               str(port), str(rank), str(tmp_path / "inputs.npz")],
                              stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True, env=env,
                              cwd=str(REPO))
             for rank in (0, 1)]
    step = jsft.make_train_step(TINY_LM, optax.chain(optax.clip_by_global_norm(5.0),
                                                     optax.adamw(1e-4)),
                                accum_grad=2, compute_dtype=jnp.float32)
    want = []
    for b in batches:
        state, m = step(state, jsft.SFTBatch(*(jnp.asarray(x) for x in b)))
        want.append({k: float(v) for k, v in m.items()})
    outs = []
    try:
        for p in procs:
            out, err = p.communicate(timeout=120)
            assert p.returncode == 0, err[-3000:]
            outs.append(json.loads(out.strip().splitlines()[-1]))
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
    return outs, want, batches


def test_two_gloo_processes_train_the_jax_single_process_step(two_ranks):
    """Both ranks' metrics of the two steps are equal and match JAX's
    single-process ``make_train_step`` from the same initial tree, with
    different real-token counts on the two ranks in the second batch."""
    outs, want, batches = two_ranks
    for rank, r in enumerate(outs):
        assert r["rank"] == rank and r["world"] == 2 and r["local_groups"] == [rank]
        assert r["mesh_shape"] == {"dp": 2, "tp": 2} and not r["jax_imported"]
    assert outs[0]["steps"] == outs[1]["steps"]
    for got, ref in zip(outs[0]["steps"], want):
        assert set(got) == set(ref)
        for k in ref:
            assert got[k] == pytest.approx(ref[k], rel=1e-4), k
    tokens = [int(np.asarray(batches[1][3])[:, rows].sum()) for rows in (slice(0, 2), slice(2, 4))]
    assert tokens[0] != tokens[1]


def test_two_processes_place_engines_only_on_their_own_slots(two_ranks):
    """Each rank's engines land on its own slots: stage-parallel engines
    over its two slots (ids 0 and 1 on each rank), engines on the global
    dp=2 × tp=2 mesh on its own dp group only (rank r: slots 2r, 2r + 1),
    and a stage mesh of the other rank's slots is refused."""
    outs, _, _ = two_ranks
    for rank, r in enumerate(outs):
        p = r["placement"]
        assert p["staged"] == {"asr": [0], "nmt": [1], "tts": [0]}
        own = [2 * rank, 2 * rank + 1]
        assert p["meshed"] == {"asr": own, "nmt": own, "tts": own}
        assert p["meshed_groups"] == 1 and p["meshed_q_slots"] == own
        # the global stage layout: asr [0], nmt [1] on rank 0's slots, tts [2, 3] on rank 1's
        assert p["refused"] == {"asr": rank == 1, "nmt": rank == 1, "tts": rank == 0}
