"""diff2lip (the TFG UNet, its converter, the mel condition and the
pipeline) against the JAX package on the CPU.

The UNet runs at ``tests/test_gd_unet_convert.py``'s toy widths on JAX's
init (its biases and GroupNorm affines moved off 0 and 1) carried across by
``from_jax_params``, in f32 with and without the mel and the reference
frame (1e-4 absolute), and in bf16 (the same tree cast on both sides): the
whole forward within BF16_ATOL, every cast point — the dtypes into and out
of each conv, norm, dense, timestep embedding and softmax, in plan order —
equal to JAX's, and the blocks whose rounding the port shares with JAX held
to one bf16 step; the converter's tree from that
file's torch mirror equals ``from_jax_params`` of JAX's converter's (plain,
``module.``-prefixed and without the audio encoder), and the emitter gives
the mirror's state dict back; ``wav2lip_mel`` and its windows within 1e-3
in [−4, 4] units; the forward smoother and the centre crop equal;
``generate`` at ``tests/test_diffusion.py``'s toy config with JAX's draws
injected (its key schedule rebuilt: a split a batch, ``(k_cond, k_sample)``,
the sampler's start and steps), 5 frames in batches of 4 (JAX pads the
tail) and 3 (not padded), self and cross identity: the sampled crops within
1e-4, the frames within one 8-bit level. Then the bake's toy-width chain
and the entry points' device rule.
"""

import dataclasses
import logging

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from expressive_speech_translation_tpu.models import gd_unet as jgd
from expressive_speech_translation_tpu.pipeline import diff2lip as jd2l
from expressive_speech_translation_tpu_torch.models import gd_unet as tgd
from expressive_speech_translation_tpu_torch.models import loaders as tld
from expressive_speech_translation_tpu_torch.models.common import cast_floats
from expressive_speech_translation_tpu_torch.obs import checkpoint_emitters as em
from expressive_speech_translation_tpu_torch.pipeline import diff2lip as td2l

from test_gd_unet_convert import CFG, TorchTFG

CPU = "cpu"
UNET_ATOL = 1e-4
# bf16 forward, port against JAX: 1.6x the largest max |diff| over eight tree
# seeds (0.025 at output peaks of 1.0-1.5). Two sound bf16 forwards differ
# by as much as either differs from f32 (0.010-0.025), so this catches
# gross casts only; test_gd_unet_bf16_casts_follow_jax holds each cast.
BF16_ATOL = 0.04
MEL_ATOL = 1e-3      # normalised [-4, 4] mel units
CROP_ATOL = 1e-4

# tests/test_diffusion.py's pipeline config
PCFG = dict(image_size=32, model_channels=8, channel_mult=(1, 2), attention_ds=(2,), heads=2,
            norm_groups=4, audio_model_channels=8, audio_channel_mult=(1, 2),
            audio_init_spatial=16, diffusion_steps=64, sampling_steps="ddim4")


def _fields(cfg):
    return {f: getattr(cfg, f) for f in cfg.__dataclass_fields__}


def _np(tree):
    return jax.tree.map(np.asarray, tree)


def _nchw(a):
    return torch.from_numpy(np.array(a)).permute(0, 3, 1, 2)


def assert_trees_equal(got, want, path=""):
    if isinstance(want, dict):
        assert isinstance(got, dict) and set(got) == set(want), (path, set(got) ^ set(want))
        for k in want:
            assert_trees_equal(got[k], want[k], f"{path}.{k}")
    elif isinstance(want, list):
        assert isinstance(got, list) and len(got) == len(want), path
        for i, (g, w) in enumerate(zip(got, want)):
            assert_trees_equal(g, w, f"{path}.{i}")
    else:
        assert got.dtype == want.dtype and torch.equal(got, want), path


# ----------------------------------------------------------------------- UNet


def _unet_inputs(cfg, seed=3):
    g = np.random.default_rng(seed)
    s = cfg.image_size
    x, cond, ref = (g.standard_normal((2, s, s, 3)).astype(np.float32) for _ in range(3))
    mel = g.standard_normal((2, cfg.audio_frames, cfg.audio_dim)).astype(np.float32)
    mask = np.zeros((s, s, 1), np.float32)
    mask[s // 2:] = 1.0
    return x, cond, ref, mel, mask, np.asarray([5, 900])


def _both_apply(jp, tp, cfg, *, with_mel, with_ref):
    x, cond, ref, mel, mask, t = _unet_inputs(cfg)
    want = jax.jit(jgd.gd_unet_apply, static_argnums=1)(
        jp, cfg, jnp.asarray(x), jnp.asarray(t), cond_img=jnp.asarray(cond),
        mask=jnp.asarray(mask), ref_img=jnp.asarray(ref) if with_ref else None,
        mel=jnp.asarray(mel) if with_mel else None)
    got = tgd.gd_unet_apply(
        tp, tgd.GDUNetConfig(**_fields(cfg)), _nchw(x), torch.from_numpy(t), cond_img=_nchw(cond),
        mask=torch.from_numpy(mask).permute(2, 0, 1)[None],
        ref_img=_nchw(ref) if with_ref else None, mel=torch.from_numpy(mel) if with_mel else None)
    assert str(got.dtype) == f"torch.{want.dtype}"
    return got.permute(0, 2, 3, 1).float().numpy(), np.asarray(want.astype(jnp.float32))


def _jax_tree(cfg, seed=5):
    """JAX's init with every bias and GroupNorm affine moved by 0.2·N(0, 1)
    (the init leaves them at 0 and 1, where a bias or affine path drops
    out)."""
    g = np.random.default_rng(seed)
    return jax.tree.map(
        lambda a: a + jnp.asarray(0.2 * g.standard_normal(a.shape), a.dtype) if a.ndim == 1
        else a, jgd.init_gd_unet(jax.random.PRNGKey(seed), cfg))


def _bf16(jp):
    """A JAX tree cast to bf16 on both sides, from the same f32 values."""
    return (jax.tree.map(lambda a: a.astype(jnp.bfloat16), jp),
            cast_floats(tgd.from_jax_params(_np(jp), CPU), torch.bfloat16))


@pytest.mark.parametrize("dtype, with_mel, with_ref", [
    pytest.param("f32", True, True, id="True-True"),
    pytest.param("f32", False, True, id="False-True"),
    pytest.param("f32", True, False, id="True-False"),
    pytest.param("bf16", True, True, id="bf16-True-True")])
def test_gd_unet_apply_matches_jax(dtype, with_mel, with_ref):
    cfg = CFG if with_ref else dataclasses.replace(CFG, in_channels=6)
    jp = _jax_tree(cfg)
    jp, tp = _bf16(jp) if dtype == "bf16" else (jp, tgd.from_jax_params(_np(jp), CPU))
    got, want = _both_apply(jp, tp, cfg, with_mel=with_mel, with_ref=with_ref)
    assert got.shape == want.shape == (2, cfg.image_size, cfg.image_size, 3)
    np.testing.assert_allclose(got, want, rtol=0, atol=UNET_ATOL if dtype == "f32" else BF16_ATOL)


def _trace_casts(monkeypatch, module, names, softmax_owner, softmax_name):
    """Spy on a UNet module's conv / norm / dense / timestep-embedding
    functions and on the softmax it calls: each call's (kind, input dtype,
    parameter dtype, output dtype, output size), in call order."""
    calls = []

    def short(dtype):
        return str(dtype).replace("torch.", "")

    def spy(kind, fn):
        def wrapped(*args, **kw):
            x = args[1] if kind in ("conv", "gn", "dense") else args[0]
            out = fn(*args, **kw)
            p = args[0]["kernel"] if kind in ("conv", "dense") else (
                args[0]["scale"] if kind == "gn" else x)
            calls.append((kind, short(x.dtype), short(p.dtype), short(out.dtype),
                          int(np.prod(out.shape))))
            return out
        return wrapped

    for kind, name in names:
        monkeypatch.setattr(module, name, spy(kind, getattr(module, name)))
    monkeypatch.setattr(softmax_owner, softmax_name,
                        spy("softmax", getattr(softmax_owner, softmax_name)))
    return calls


def test_gd_unet_bf16_casts_follow_jax(monkeypatch):
    """Every cast point of the bf16 forward against JAX's: the dtypes into
    and out of each conv, GroupNorm, dense layer, timestep embedding and
    softmax, call for call (the input casts of the convs, the f32 time and
    emb MLPs met by bf16 kernels, emb_out cast to the activations' dtype,
    the f32 norms and logits)."""
    jb, tb = _bf16(_jax_tree(CFG))
    x, cond, ref, mel, mask, t = _unet_inputs(CFG)
    want = _trace_casts(monkeypatch, jgd, [("conv", "_conv2d"), ("conv", "_conv1d"),
                                           ("gn", "_gn"), ("dense", "dense"),
                                           ("temb", "timestep_embedding")], jax.nn, "softmax")
    jax.make_jaxpr(lambda p, *a: jgd.gd_unet_apply(p, CFG, a[0], a[1], cond_img=a[2], mask=a[3],
                                                   ref_img=a[4], mel=a[5]))(
        jb, *map(jnp.asarray, (x, t, cond, mask, ref, mel)))
    got = _trace_casts(monkeypatch, tgd, [("conv", "_conv"), ("gn", "_gn"), ("dense", "dense"),
                                          ("dense", "_dense32"), ("temb", "timestep_embedding")],
                       torch, "softmax")
    tgd.gd_unet_apply(tb, tgd.GDUNetConfig(**_fields(CFG)), _nchw(x), torch.from_numpy(t),
                      cond_img=_nchw(cond), mask=torch.from_numpy(mask).permute(2, 0, 1)[None],
                      ref_img=_nchw(ref), mel=torch.from_numpy(mel))
    assert {c[0] for c in want} == {"conv", "gn", "dense", "temb", "softmax"}
    assert ("conv", "float32", "bfloat16", "bfloat16", 2 * 16 * 16 * 8) in want
    assert got == want


def _within_one_bf16_step(got, want):
    """Every element within one bf16 spacing of JAX's, and at most 1 % of
    them not equal (the two libraries' f32 sums round apart now and then)."""
    got, want = np.asarray(got, np.float32), np.asarray(want, np.float32)
    step = 2.0 ** (np.floor(np.log2(np.maximum(np.abs(want), 2.0 ** -126))) - 7)
    diff = np.abs(got - want)
    assert (diff <= step).all(), float((diff / step).max())
    assert (diff > 0).mean() <= 0.01, float((diff > 0).mean())


@pytest.mark.parametrize("block", ["time_mlp", "conv", "gn", "attn"])
def test_gd_unet_bf16_blocks_match_jax(block):
    """The bf16 blocks whose rounding the port shares with JAX: the time
    MLP (f32 met by bf16 kernels, 1e-6 of its peak), the first conv on its
    f32 input, bias 0 (JAX rounds the product and adds the bias in bf16,
    the port adds it before its one rounding), a GroupNorm and the middle
    attention on bf16 activations, each within one bf16 step. The res
    blocks are not here: JAX's silu is a sigmoid and a product, each
    rounded, where torch rounds once."""
    jb, tb = _bf16(_jax_tree(CFG))
    g = np.random.default_rng(8)
    if block == "time_mlp":
        t = np.asarray([5, 900])
        te = jb["time_embed"]
        want = jgd.dense(te["lin2"], jax.nn.silu(jgd.dense(te["lin1"], jgd.timestep_embedding(
            jnp.asarray(t, jnp.float32), CFG.model_channels))))
        got = tgd._embed_mlp(tb["time_embed"], torch.from_numpy(t), CFG.model_channels)
        assert got.dtype == torch.float32 and want.dtype == jnp.float32
        np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=0,
                                   atol=1e-6 * float(jnp.abs(want).max()))
        return
    if block == "conv":
        x = g.standard_normal((2, 16, 16, CFG.in_channels)).astype(np.float32)
        jc = dict(jb["input"][0]["conv"], bias=jnp.zeros((8,), jnp.bfloat16))
        tc = dict(tb["input"][0]["conv"], bias=torch.zeros(8, dtype=torch.bfloat16))
        want = jgd._conv2d(jc, jnp.asarray(x))
        got = tgd._conv(tc, torch.from_numpy(x).permute(0, 3, 1, 2)).permute(0, 2, 3, 1)
    else:
        c = jb["middle"]["attn"]["q"]["kernel"].shape[0]
        h = jnp.asarray(3.0 * g.standard_normal((2, 4, 4, c)) + 1.0, jnp.bfloat16)
        th = torch.from_numpy(np.array(h.astype(jnp.float32))).permute(0, 3, 1, 2)
        th = th.to(torch.bfloat16)
        if block == "gn":
            want = jgd._gn(jb["middle"]["res1"]["in_norm"], h, CFG.norm_groups)
            got = tgd._gn(tb["middle"]["res1"]["in_norm"], th, CFG.norm_groups)
        else:
            want = jgd._attn(jb["middle"]["attn"], h, CFG.num_heads, CFG.norm_groups)
            got = tgd._attn(tb["middle"]["attn"], th, CFG.num_heads, CFG.norm_groups)
        got = got.permute(0, 2, 3, 1)
    assert got.dtype == torch.bfloat16 and want.dtype == jnp.bfloat16
    _within_one_bf16_step(got.float().numpy(), want.astype(jnp.float32))


@pytest.mark.parametrize("prefix", ["", "module."])
def test_from_tfg_state_dict_matches_jax(prefix):
    torch.manual_seed(3)
    sd = {prefix + k: v for k, v in TorchTFG(CFG).eval().state_dict().items()}
    want = tgd.from_jax_params(_np(jgd.from_tfg_state_dict(sd, CFG)), CPU)
    got = tgd.from_tfg_state_dict(sd, tgd.GDUNetConfig(**_fields(CFG)), CPU)
    assert_trees_equal(got, want)
    assert "audio" in got


def test_a_tree_without_audio_follows_jax():
    """No audio encoder in the checkpoint: no ``audio`` in the tree; the
    forward without mel runs and agrees, with mel it fails as JAX's does."""
    torch.manual_seed(4)
    sd = {k: v for k, v in TorchTFG(CFG).eval().state_dict().items()
          if not k.startswith(("audio_encoder", "audio_encoder_to_style"))}
    jp = jgd.from_tfg_state_dict(sd, CFG)
    tp = tgd.from_tfg_state_dict(sd, tgd.GDUNetConfig(**_fields(CFG)), CPU)
    assert "audio" not in tp and "audio" not in jp
    assert_trees_equal(tp, tgd.from_jax_params(_np(jp), CPU))
    got, want = _both_apply(jp, tp, CFG, with_mel=False, with_ref=True)
    np.testing.assert_allclose(got, want, rtol=0, atol=UNET_ATOL)
    with pytest.raises(KeyError, match="audio"):
        _both_apply(jp, tp, CFG, with_mel=True, with_ref=True)
    with pytest.raises(KeyError, match="audio"):
        x, cond, ref, mel, mask, t = _unet_inputs(CFG)
        tgd.gd_unet_apply(tp, tgd.GDUNetConfig(**_fields(CFG)), _nchw(x), torch.from_numpy(t),
                          cond_img=_nchw(cond), mask=torch.from_numpy(mask).permute(2, 0, 1)[None],
                          ref_img=_nchw(ref), mel=torch.from_numpy(mel))


@pytest.mark.parametrize("audio", [True, False])
def test_the_emitter_gives_the_mirrors_state_dict_back(audio):
    """The emitter re-interleaves qkv head-major: its state dict of the
    converted tree is the mirror's own, key for key and bit for bit."""
    torch.manual_seed(5)
    sd = {k: v for k, v in TorchTFG(CFG).eval().state_dict().items()
          if audio or not k.startswith("audio_encoder")}
    cfg = tgd.GDUNetConfig(**_fields(CFG))
    out = em.diff2lip_tfg_state_dict(tgd.from_tfg_state_dict(sd, cfg, CPU), cfg)
    assert set(out) == set(sd)
    for k, v in sd.items():
        assert torch.equal(out[k], v), k


def _shapes(tree, path=""):
    if isinstance(tree, dict):
        return [x for k in sorted(tree) for x in _shapes(tree[k], f"{path}.{k}")]
    if isinstance(tree, list):
        return [x for i, v in enumerate(tree) for x in _shapes(v, f"{path}.{i}")]
    return [(path, tuple(tree.shape))]


def test_init_gd_unet_is_seeded_and_follows_the_plan():
    cfg = tgd.GDUNetConfig(**_fields(CFG))
    a, b = tgd.init_gd_unet(1, cfg, CPU), tgd.init_gd_unet(1, cfg, CPU)
    assert_trees_equal(a, b)
    assert not torch.equal(tgd.init_gd_unet(2, cfg, CPU)["out"]["conv"]["kernel"],
                           a["out"]["conv"]["kernel"])
    want = tgd.from_jax_params(_np(jgd.init_gd_unet(jax.random.PRNGKey(0), CFG)), CPU)
    assert _shapes(a) == _shapes(want)


# ------------------------------------------------------------ mel and boxes


def _signal(kind, seconds=1.0):
    t = np.arange(int(16_000 * seconds)) / 16_000
    g = np.random.default_rng(7)
    if kind == "sine":
        return (0.3 * np.sin(2 * np.pi * 220 * t)).astype(np.float32)
    if kind == "noise":
        return (0.1 * g.standard_normal(len(t))).astype(np.float32)
    # a chirp with a voiced envelope and a little noise
    env = 0.5 + 0.5 * np.sin(2 * np.pi * 3 * t)
    return (0.2 * env * np.sin(2 * np.pi * (150 + 400 * t) * t)
            + 0.01 * g.standard_normal(len(t))).astype(np.float32)


@pytest.mark.parametrize("kind, seconds", [("sine", 1.0), ("noise", 0.37), ("chirp", 2.0)])
def test_wav2lip_mel_matches_jax(kind, seconds):
    a = _signal(kind, seconds)
    want = jd2l.wav2lip_mel(a)
    got = td2l.wav2lip_mel(a, device=CPU)
    assert got.dtype == np.float32 and got.shape == want.shape
    np.testing.assert_allclose(got, want, rtol=0, atol=MEL_ATOL)
    assert got.min() >= -4.0 and got.max() <= 4.0


def test_wav2lip_mel_of_a_sample_or_none_matches_jax():
    for a in (np.zeros(0, np.float32), np.ones(1, np.float32)):
        np.testing.assert_allclose(td2l.wav2lip_mel(a, device=CPU), jd2l.wav2lip_mel(a),
                                   rtol=0, atol=MEL_ATOL)


@pytest.mark.parametrize("n, fps, window", [(5, 5.0, 16), (25, 25.0, 16), (40, 30.0, 8)])
def test_mel_windows_for_frames_match_jax(n, fps, window):
    a = _signal("chirp", 1.5)
    want = jd2l.mel_windows_for_frames(a, n, fps, window_frames=window)
    got = td2l.mel_windows_for_frames(a, n, fps, window_frames=window, device=CPU)
    assert got.shape == want.shape == (n, window, 80)
    np.testing.assert_allclose(got, want, rtol=0, atol=MEL_ATOL)


@pytest.mark.parametrize("n, window", [(9, 5), (12, 3), (3, 5), (1, 5)])
def test_smooth_boxes_is_equal_to_jax(n, window):
    g = np.random.default_rng(n)
    boxes = [tuple(int(v) for v in g.integers(0, 200, 4)) for _ in range(n)]
    assert td2l.smooth_boxes(boxes, window) == jd2l.smooth_boxes(boxes, window)


@pytest.mark.parametrize("shape", [(64, 64, 3), (360, 640, 3), (101, 37, 3)])
def test_center_face_detector_is_equal_to_jax(shape):
    frame = np.zeros(shape, np.uint8)
    assert td2l.center_face_detector(frame) == jd2l.center_face_detector(frame)


# ------------------------------------------------------------------ generate


def _detector(frame):
    """A deterministic per-frame detector both packages run: a miss on dark
    corners, else a box that moves with the frame's corner pixel."""
    if frame[0, 0, 0] < 60:
        return None
    return (4 + int(frame[0, 0, 1]) % 8, 6 + int(frame[0, 0, 2]) % 6,
            44 + int(frame[0, 1, 0]) % 10, 50)


def _jax_draws(key, batch: int, nhwc, steps: int):
    """JAX generate's draws for batch ``batch``: ``key, k = split(key)`` a
    batch, ``k_cond, k_sample = split(k)``, the conditioning noise from
    k_cond, the sampler's start and steps from k_sample — NCHW."""
    for _ in range(batch + 1):
        key, k = jax.random.split(key)
    k_cond, k_sample = jax.random.split(k)
    cond = jax.random.normal(k_cond, nhwc, jnp.float32)
    k_sample, k0 = jax.random.split(k_sample)
    x_init = jax.random.normal(k0, nhwc)
    noise = []
    for _ in range(steps):
        k_sample, kn = jax.random.split(k_sample)
        noise.append(_nchw(jax.random.normal(kn, nhwc)))
    return td2l.BatchNoise(_nchw(cond), _nchw(x_init), noise)


@pytest.fixture(scope="module")
def pipelines():
    """JAX's toy pipeline (seed 11 weights) and the port's on its tree, with
    the test detector and with the default per-frame boxes."""
    out = {}
    for name, det in (("detector", _detector), ("tracked", None)):
        jp = jd2l.Diff2LipPipeline(jd2l.Diff2LipConfig(**PCFG), detector=det)
        tp = td2l.Diff2LipPipeline(td2l.Diff2LipConfig(**PCFG),
                                   tgd.from_jax_params(_np(jp.params), CPU), detector=det,
                                   device=CPU)
        out[name] = (jp, tp)
    return out


def _frames(n, seed, h=64, w=64):
    return np.random.default_rng(seed).integers(0, 255, (n, h, w, 3)).astype(np.uint8)


@pytest.mark.parametrize("case, n, boxes, identity", [
    ("padded tail, self", 5, "detector", None),
    ("padded tail, cross (a shorter identity clip)", 5, "detector", 3),
    ("one batch, self", 3, "tracked", None),
    ("one batch, cross", 3, "tracked", -1)])
def test_generate_matches_jax_with_its_draws_injected(pipelines, case, n, boxes, identity):
    jp, tp = pipelines[boxes]
    frames = _frames(n, 1)
    ident = None
    if identity == -1:
        ident = frames[::-1].copy()
    elif identity is not None:
        ident = _frames(identity, 2)
    audio = _signal("chirp", 1.0)
    key = jax.random.PRNGKey(9)
    s = PCFG["image_size"]
    steps = tp.diffusion.num_timesteps
    jcrops, tcrops, asked = [], [], []

    jsample = jp._sample

    def jspy(k, crops, ref, mel):
        out = jsample(k, crops, ref, mel)
        jcrops.append(np.asarray(out))
        return out

    tsample = tp.sample

    def tspy(*args, **kwargs):
        out = tsample(*args, **kwargs)
        tcrops.append(out.permute(0, 2, 3, 1).numpy())
        return out

    def noise(b, shape):
        asked.append((b, shape))
        return _jax_draws(key, b, (shape[0], s, s, 3), steps)

    jp._sample, tp.sample = jspy, tspy
    try:
        want = jp.generate(frames, audio, 5.0, identity_frames=ident, key=key, batch_size=4)
        got = tp.generate(frames, audio, 5.0, identity_frames=ident, noise=noise, batch_size=4)
    finally:
        jp._sample = jsample
        del tp.sample
    rows = 4 if n > 4 else n
    assert asked == [(b, (rows, 3, s, s)) for b in range(len(jcrops))]
    assert len(tcrops) == len(jcrops) == -(-n // 4)
    for t_, j_ in zip(tcrops, jcrops):
        assert j_.shape[0] == rows and t_.dtype == np.float32
        np.testing.assert_allclose(t_, j_[:len(t_)], rtol=0, atol=CROP_ATOL)
    assert got.shape == frames.shape and got.dtype == np.uint8
    assert np.abs(got.astype(int) - want.astype(int)).max() <= 1
    assert not np.array_equal(got, frames)


def test_generate_draws_from_a_generator_and_keeps_the_box_outside(pipelines):
    _, tp = pipelines["detector"]
    frames = _frames(3, 4)
    audio = _signal("sine", 0.6)
    runs = [tp.generate(frames, audio, 5.0, generator=torch.Generator().manual_seed(s))
            for s in (1, 1, 2)]
    assert np.array_equal(runs[0], runs[1]) and not np.array_equal(runs[0], runs[2])
    boxes = tp.boxes(frames, 5.0)
    for i, (y0, x0, y1, x1) in enumerate(boxes):
        outside = np.ones(frames.shape[1:3], bool)
        outside[y0:y1, x0:x1] = False
        assert np.array_equal(runs[0][i][outside], frames[i][outside])
        assert not np.array_equal(runs[0][i, y0:y1, x0:x1], frames[i, y0:y1, x0:x1])


def test_a_detector_that_never_finds_a_face_gives_the_centre_crop():
    pipe = td2l.Diff2LipPipeline(td2l.Diff2LipConfig(**PCFG), detector=lambda f: None,
                                 device=CPU)
    frames = _frames(4, 5, 48, 80)
    assert pipe.boxes(frames, 25.0) == [td2l.center_face_detector(frames[0])] * 4


def test_a_bf16_tree_runs_bf16_and_gives_f32_crops(pipelines):
    _, tp = pipelines["detector"]
    pipe = td2l.Diff2LipPipeline(tp.cfg, cast_floats(tp.params, torch.bfloat16), device=CPU)
    crops = pipe.crops(list(_frames(2, 6)), [(4, 4, 40, 44)] * 2)
    mel = torch.from_numpy(td2l.mel_windows_for_frames(_signal("sine", 0.5), 2, 5.0,
                                                       device=CPU))
    seen = []
    conv = tgd._conv

    def spy(p, x, **kw):
        out = conv(p, x, **kw)
        seen.append(out.dtype)
        return out

    tgd._conv = spy
    try:
        got = pipe.sample(crops, crops, mel, generator=torch.Generator().manual_seed(0))
    finally:
        tgd._conv = conv
    want = tp.sample(crops, crops, mel, generator=torch.Generator().manual_seed(0))
    assert set(seen) == {torch.bfloat16} and got.dtype == torch.float32
    # a few pixels flip at the [-1, 1] clip (as JAX's bf16 tree's do); the
    # crop as a whole stays with the f32 one
    assert torch.isfinite(got).all() and float((got - want).abs().mean()) < 1e-2


def test_generate_rejects_empty_frames(pipelines):
    from expressive_speech_translation_tpu_torch.core.errors import MediaError

    _, tp = pipelines["detector"]
    with pytest.raises(MediaError, match="no video frames"):
        tp.generate(np.zeros((0, 64, 64, 3), np.uint8), np.zeros(100, np.float32), 25.0)


def test_the_entry_points_need_the_card_without_device(monkeypatch):
    if torch.cuda.is_available():
        pytest.skip("a card is present: the default device is valid")
    monkeypatch.delenv("EST_MODELS_DIR", raising=False)
    for call in (lambda: td2l.Diff2LipPipeline(),
                 lambda: td2l.Diff2LipPipeline.from_models_dir(),
                 lambda: td2l.wav2lip_mel(np.zeros(1600, np.float32))):
        with pytest.raises(RuntimeError, match="no CUDA device"):
            call()


# ------------------------------------------------------------------ the bake


@dataclasses.dataclass(frozen=True)
class ToyDiff2LipConfig(td2l.Diff2LipConfig):
    image_size: int = 32
    model_channels: int = 8
    channel_mult: tuple = (1, 2)
    attention_ds: tuple = (2,)
    heads: int = 2
    norm_groups: int = 4
    audio_model_channels: int = 8
    audio_channel_mult: tuple = (1, 2)
    audio_init_spatial: int = 16
    diffusion_steps: int = 64
    sampling_steps: str = "ddim4"


def test_the_toy_chain_from_e2e_pt_to_a_render(tmp_path, monkeypatch, caplog):
    """The emitter's ``module.``-prefixed ``e2e.pt`` → ``load_diff2lip`` →
    ``main(["--diff2lip", ...])`` → ``load_converted`` (equal) →
    ``Diff2LipPipeline.from_models_dir`` renders (the published geometry
    patched to the toy one, as the CLI takes no config)."""
    monkeypatch.setattr(td2l, "Diff2LipConfig", ToyDiff2LipConfig)
    cfg = ToyDiff2LipConfig()
    params = td2l.init_diff2lip_unet(3, cfg, CPU)
    em.write_diff2lip(tmp_path / "src" / "e2e.pt", params, cfg.unet)
    state = torch.load(tmp_path / "src" / "e2e.pt", weights_only=True)
    assert all(k.startswith("module.") for k in state)
    loaded, got_cfg = tld.load_diff2lip(tmp_path / "src", device=CPU)
    assert got_cfg == cfg
    assert_trees_equal(loaded, params)
    assert tld.main(["--diff2lip", str(tmp_path / "src"), "--out", str(tmp_path / "bake"),
                     "--device", CPU]) == 0
    baked, baked_cfg = tld.load_converted(tmp_path / "bake" / "diff2lip", td2l.Diff2LipConfig, CPU)
    assert dataclasses.asdict(baked_cfg) == dataclasses.asdict(cfg)
    assert_trees_equal(baked, params)
    monkeypatch.setenv("EST_MODELS_DIR", str(tmp_path / "bake"))
    with caplog.at_level(logging.WARNING):
        pipe = td2l.Diff2LipPipeline.from_models_dir(device=CPU)
    assert "random weights" not in caplog.text
    assert_trees_equal(pipe.params, params)
    frames = _frames(2, 8)
    out = pipe.generate(frames, _signal("sine", 0.4), 5.0)
    assert out.shape == frames.shape and out.dtype == np.uint8 and not np.array_equal(out, frames)
    # no bake: random weights, with JAX's warning
    monkeypatch.setenv("EST_MODELS_DIR", str(tmp_path / "nothing"))
    caplog.clear()
    with caplog.at_level(logging.WARNING):
        td2l.Diff2LipPipeline.from_models_dir(device=CPU)
    assert "Diff2LipPipeline: random weights (no checkpoint supplied)" in caplog.text
