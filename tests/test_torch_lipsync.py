"""MuseTalk lip-sync and the face tracker's tail against the JAX package on
the CPU.

The models run at JAX's toy widths (``tests/test_musetalk_convert.py``'s and
``tests/test_face.py``'s) with JAX's init carried across by
``from_jax_params``, in f32: the VAE, the UNet (timestep 0 and 7), the PE,
the window alignment and ``lipsync_frames`` (5 frames in batches of 2) within
1e-4 of the output's peak; the crop resize against ``jax.image.resize(...,
"linear")`` shrinking and enlarging within 1e-6; the host composite, the box
clamp and the face tail's boxes equal; the HF converters bit for bit for
both attention namings; the whisper condition within 1e-4 (the port's log-mel
is the kernel's plain version); ``MuseTalkPipeline.render`` within one
8-bit level; the release layout, the bake and ``default_lipsync_fn``; and
``main()``'s wiring and ``/process-video`` with lip-sync through both apps.
"""

import dataclasses
import io
import json
import logging
import threading
import time

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from expressive_speech_translation_tpu.core import errors as jerrors
from expressive_speech_translation_tpu.models import musetalk as jmt
from expressive_speech_translation_tpu.models import whisper as jwh
from expressive_speech_translation_tpu.pipeline import face as jface
from expressive_speech_translation_tpu.pipeline import musetalk_pipeline as jmp
from expressive_speech_translation_tpu_torch.core import errors as terrors
from expressive_speech_translation_tpu_torch.models import loaders as tld
from expressive_speech_translation_tpu_torch.models import musetalk as tmt
from expressive_speech_translation_tpu_torch.models import whisper as twh
from expressive_speech_translation_tpu_torch.obs import checkpoint_emitters as em
from expressive_speech_translation_tpu_torch.pipeline import face as tface
from expressive_speech_translation_tpu_torch.pipeline import musetalk_pipeline as tmp

from test_face import fast_pan_clip, synthetic_clip

CPU = "cpu"
RTOL = 1e-4          # max |port - JAX| / max |JAX|, f32
RESIZE_ATOL = 1e-6   # the same f32 weights; the contraction order differs

CFG = jmt.MuseTalkConfig(image_size=32, latent_channels=4, vae_channels=(8, 16), vae_layers=2,
                         unet_channels=(8, 16), unet_layers=2, audio_dim=12, audio_ctx=10,
                         heads=2, norm_groups=4)
# tests/test_face.py's render widths, conditioned on a d_model-48 whisper
RCFG = jmt.MuseTalkConfig(image_size=32, vae_channels=(8, 16, 32), vae_layers=1,
                          unet_channels=(8, 16, 32), unet_layers=1, audio_dim=48, audio_ctx=6,
                          heads=2, norm_groups=4)
WCFG = jwh.WhisperConfig(d_model=48, encoder_layers=1, decoder_layers=1, heads=2, ffn_dim=96,
                         vocab_size=1024)


def _fields(cfg):
    return {f: getattr(cfg, f) for f in cfg.__dataclass_fields__}


def _port_cfg(cfg):
    return (tmt.MuseTalkConfig if isinstance(cfg, jmt.MuseTalkConfig)
            else twh.WhisperConfig)(**_fields(cfg))


def _np(tree):
    return jax.tree.map(np.asarray, tree)


def _close(got, want, rtol=RTOL):
    got, want = np.asarray(got, np.float32), np.asarray(want, np.float32)
    assert got.shape == want.shape
    err = np.abs(got - want).max()
    assert err <= rtol * max(np.abs(want).max(), 1e-6), (err, np.abs(want).max())


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


def _nchw(x):
    return torch.from_numpy(np.array(x)).permute(0, 3, 1, 2)


def _nhwc(x):
    return x.permute(0, 2, 3, 1).numpy()


@pytest.fixture(scope="module")
def toy():
    jp = jmt.init_musetalk(jax.random.PRNGKey(3), CFG)
    return jp, tmt.from_jax_params(_np(jp), CPU)


@pytest.fixture(scope="module")
def render_models():
    """The render widths' MuseTalk and whisper trees, JAX's and the port's."""
    jp = jmt.init_musetalk(jax.random.PRNGKey(3), RCFG)
    jw = jwh.init_whisper(jax.random.PRNGKey(2), WCFG)
    return jp, jw, tmt.from_jax_params(_np(jp), CPU), twh.from_jax_params(_np(jw), CPU)


@pytest.fixture(autouse=True)
def _isolate_learned_detectors():
    jface._reset_learned()
    tface._reset_learned()
    yield
    jface._reset_learned()
    tface._reset_learned()


# ----------------------------------------------------------------- the model


def test_vae_encode_and_decode_match_jax(toy):
    jp, tp = toy
    imgs = np.random.default_rng(0).uniform(-1, 1, (3, 32, 32, 3)).astype(np.float32)
    lat = np.asarray(jax.jit(lambda p, x: jmt.vae_encode(p, CFG, x))(jp["vae"], imgs))
    got = tmt.vae_encode(tp["vae"], _port_cfg(CFG), _nchw(imgs))
    assert got.shape == (3, 4, 16, 16)      # one downsample: two VAE levels
    _close(_nhwc(got), lat)
    rec = np.asarray(jax.jit(lambda p, z: jmt.vae_decode(p, CFG, z))(jp["vae"], lat))
    _close(_nhwc(tmt.vae_decode(tp["vae"], _port_cfg(CFG), _nchw(lat))), rec)


@pytest.mark.parametrize("t", [0.0, 7.0])
def test_unet_matches_jax(toy, t):
    jp, tp = toy
    g = np.random.default_rng(1)
    lat8 = g.standard_normal((2, 16, 16, 8)).astype(np.float32)
    audio = g.standard_normal((2, CFG.audio_ctx, CFG.audio_dim)).astype(np.float32)
    want = jax.jit(lambda p, x, a: jmt.unet_apply(p, CFG, x, a, timestep=t))(jp["unet"], lat8, audio)
    got = tmt.unet_apply(tp["unet"], _port_cfg(CFG), _nchw(lat8), torch.from_numpy(audio), t)
    _close(_nhwc(got), want)


def test_timestep_embedding_is_cos_then_sin():
    t = np.asarray([0.0, 3.0, 250.0], np.float32)
    want = np.asarray(jmt.timestep_embedding(jnp.asarray(t), 16))
    got = tmt.timestep_embedding(torch.from_numpy(t), 16).numpy()
    np.testing.assert_allclose(got, want, atol=1e-6)
    np.testing.assert_array_equal(got[0], np.r_[np.ones(8), np.zeros(8)])


def test_positional_encoding_and_windows_match_jax():
    x = np.random.default_rng(2).standard_normal((3, 7, 12)).astype(np.float32)
    _close(tmt.positional_encoding(torch.from_numpy(x)).numpy(),
           jmt.positional_encoding(jnp.asarray(x)), 1e-7)
    feats = np.random.default_rng(3).standard_normal((53, 12)).astype(np.float32)
    for n, fps, ctx in ((10, 25.0, 6), (40, 30.0, 10), (3, 24.0, 50)):
        np.testing.assert_array_equal(
            tmt.whisper_chunks_for_video(torch.from_numpy(feats), n, fps, ctx=ctx).numpy(),
            np.asarray(jmt.whisper_chunks_for_video(jnp.asarray(feats), n, fps, ctx=ctx)))


def test_lipsync_frames_match_jax_off_the_batch_multiple(toy):
    """5 frames in batches of 2: JAX pads the last batch with a zero frame,
    the port runs it short; the real frames agree."""
    jp, tp = toy
    g = np.random.default_rng(4)
    crops = g.uniform(-1, 1, (5, 32, 32, 3)).astype(np.float32)
    windows = g.standard_normal((5, CFG.audio_ctx, CFG.audio_dim)).astype(np.float32)
    want = jax.jit(lambda p, c, w: jmt.lipsync_frames(p, CFG, c, w, batch_size=2))(
        jp, crops, windows)
    got = tmt.lipsync_frames(tp, _port_cfg(CFG), _nchw(crops), torch.from_numpy(windows),
                             batch_size=2)
    _close(_nhwc(got), want)


@pytest.mark.parametrize("shape", [(20, 45), (60, 70), (300, 256), (31, 400)])
@pytest.mark.parametrize("size", [32, 256])
def test_the_crop_resize_matches_jax_linear(shape, size):
    """Antialiased where an axis shrinks, plain bilinear where it grows."""
    x = np.random.default_rng(5).uniform(-1, 1, (*shape, 3)).astype(np.float32)
    want = np.asarray(jax.image.resize(jnp.asarray(x), (size, size, 3), "linear"))
    got = tmt.resize_linear(torch.from_numpy(x), size, size).numpy()
    np.testing.assert_allclose(got, want, atol=RESIZE_ATOL)


def test_blend_face_matches_jax():
    g = np.random.default_rng(0)
    frame = g.uniform(-1, 1, (40, 48, 3)).astype(np.float32)
    face = g.uniform(-1, 1, (16, 16, 3)).astype(np.float32)
    for box in ((8, 10, 28, 30), (0, 0, 40, 40), (5, 3, 13, 30)):
        want = np.asarray(jmt.blend_face(jnp.asarray(frame), jnp.asarray(face), box))
        got = tmt.blend_face(torch.from_numpy(frame), torch.from_numpy(face), box).numpy()
        np.testing.assert_allclose(got, want, atol=RESIZE_ATOL)


def test_host_composite_and_clamp_are_equal_to_jax():
    g = np.random.default_rng(0)
    frame = g.integers(0, 255, (40, 48, 3), np.uint8)
    face = g.uniform(-1, 1, (16, 16, 3)).astype(np.float32)
    for box in ((8, 10, 28, 30), (0, 0, 40, 48), (30, 2, 38, 45)):
        np.testing.assert_array_equal(tmp.blend_face_np(frame, face, box),
                                      jmp.blend_face_np(frame, face, box))
    for box in ((-5, -3, 20, 25), (35, 35, 60, 60), (10.4, 3.6, 12.2, 9.5), (0, 0, 3, 3)):
        assert tmp.clamp_box(box, 40, 40) == jmp.clamp_box(box, 40, 40)


# ---------------------------------------------------------------- converters


def _legacy(vae_sd):
    """The same VAE state dict in the legacy attention naming (norm / query /
    key / value / proj_attn, the projections stored as 1×1 convs)."""
    out = {}
    for k, v in vae_sd.items():
        if ".mid_block.attentions.0." in k:
            for modern, legacy in (("group_norm", "norm"), ("to_q", "query"), ("to_k", "key"),
                                   ("to_v", "value"), ("to_out.0", "proj_attn")):
                k = k.replace(f".{modern}.", f".{legacy}.")
            if k.endswith("weight") and v.ndim == 2:
                v = v[:, :, None, None]
        out[k] = v
    return out


@pytest.mark.parametrize("naming", ["modern", "legacy"])
def test_the_hf_converters_match_jax(toy, naming):
    """The emitters' diffusers state dicts → the same tree through JAX's
    converter (then ``from_jax_params``) and the port's, bit for bit."""
    _, tp = toy
    vae_sd = em.musetalk_vae_state_dict(tp["vae"], _port_cfg(CFG))
    unet_sd = em.musetalk_unet_state_dict(tp["unet"], _port_cfg(CFG))
    if naming == "legacy":
        vae_sd = _legacy(vae_sd)
        assert "encoder.mid_block.attentions.0.query.weight" in vae_sd
    got = tmt.from_hf_state_dict(vae_sd, unet_sd, _port_cfg(CFG), CPU)
    assert_trees_equal(got, tp)
    assert_trees_equal(tmt.from_jax_params(_np(jmt.from_hf_state_dict(vae_sd, unet_sd, CFG)), CPU),
                       tp)


def test_from_jax_params_drops_the_empty_blocks(toy):
    jp, tp = toy
    assert jp["vae"]["encoder"]["down"][-1]["downsample"] is None
    assert "downsample" not in tp["vae"]["encoder"]["down"][-1]
    assert "attns" not in tp["unet"]["down"][-1] and "attns" not in tp["unet"]["up"][0]
    assert tp["unet"]["conv_in"]["kernel"].shape == (8, 8, 3, 3)      # OIHW


# ---------------------------------------------------------- audio condition


@pytest.mark.parametrize("seconds", [0.5, 3.3, 31.0])
def test_whisper_features_match_jax(render_models, seconds):
    _, jw, _, tw = render_models
    audio = np.random.default_rng(6).standard_normal(int(16_000 * seconds)).astype(np.float32)
    want = np.asarray(jmp.whisper_feature_fn(jw, WCFG, dtype=jnp.float32)(audio))
    got = tmp.whisper_feature_fn(tw, _port_cfg(WCFG), dtype=torch.float32, device=CPU)(audio)
    assert got.shape == (int(np.ceil(seconds * 50)), 48)
    _close(got.numpy(), want)


def test_mel_features_match_jax():
    audio = np.random.default_rng(7).standard_normal(20_000).astype(np.float32)
    for dim in (12, 200):
        _close(tmp._mel_audio_features(audio, dim, CPU).numpy(),
               jmp._mel_audio_features(audio, dim), 1e-5)


def test_the_pipeline_takes_whisper_only_at_the_unet_width(render_models, caplog):
    _, _, tp, tw = render_models
    wcfg = _port_cfg(WCFG)
    pipe = tmp.MuseTalkPipeline(tp, _port_cfg(RCFG), whisper=(tw, wcfg), dtype=torch.float32,
                                device=CPU)
    audio = np.random.default_rng(1).standard_normal(16_000).astype(np.float32)
    _close(pipe.audio_feature_fn(audio).numpy(),
           tmp.whisper_feature_fn(tw, wcfg, dtype=torch.float32, device=CPU)(audio).numpy(), 0)
    narrow = dataclasses.replace(_port_cfg(RCFG), audio_dim=12)
    with caplog.at_level(logging.WARNING):
        pipe = tmp.MuseTalkPipeline(tmt.init_musetalk(0, narrow, CPU), narrow,
                                    whisper=(tw, wcfg), dtype=torch.float32, device=CPU)
    assert any("audio_dim" in r.getMessage() for r in caplog.records)
    _close(pipe.audio_feature_fn(audio).numpy(), jmp._mel_audio_features(audio, 12), 1e-5)


# ------------------------------------------------------------------- render


def test_render_matches_jax(render_models):
    """Detection → crop → re-render → blend on the talking-head clip, the
    condition from the whisper encoder: within one 8-bit level of JAX's,
    and only the face region changes."""
    jp, jw, tp, tw = render_models
    frames = synthetic_clip(n=6)
    t = np.arange(int(16_000 * 6 / 24.0)) / 16_000
    audio = (0.3 * np.sin(2 * np.pi * 220 * t)).astype(np.float32)
    want = jmp.MuseTalkPipeline(jp, RCFG, whisper=(jw, WCFG), batch_size=4,
                                dtype=jnp.float32).render(frames, 24.0, audio)
    got = tmp.MuseTalkPipeline(tp, _port_cfg(RCFG), whisper=(tw, _port_cfg(WCFG)), batch_size=4,
                               dtype=torch.float32, device=CPU).render(frames, 24.0, audio)
    assert got.shape == frames.shape and got.dtype == np.uint8
    diff = np.abs(got.astype(int) - want.astype(int))
    assert diff.max() <= 1 and (diff > 0).mean() < 1e-3
    np.testing.assert_array_equal(got[:, :8, :8], frames[:, :8, :8])
    assert (got != frames).any()


def test_the_lipsync_fn_resamples_like_jax(render_models):
    jp, jw, tp, tw = render_models
    frames = synthetic_clip(n=4)
    audio = np.sin(np.arange(6_000) / 9.0).astype(np.float32)
    want = jmp.musetalk_lipsync_fn(jp, RCFG, whisper=(jw, WCFG), batch_size=4,
                                   dtype=jnp.float32)(frames, 24.0, audio, 24_000)
    fn = tmp.musetalk_lipsync_fn(tp, _port_cfg(RCFG), whisper=(tw, _port_cfg(WCFG)),
                                 batch_size=4, dtype=torch.float32, device=CPU)
    got = fn(frames, 24.0, audio, 24_000)
    assert np.abs(got.astype(int) - want.astype(int)).max() <= 1
    assert fn.pipeline.device == torch.device(CPU)


def test_render_rejects_empty_frames():
    pipe = tmp.MuseTalkPipeline(cfg=_port_cfg(CFG), dtype=torch.float32, device=CPU)
    with pytest.raises(terrors.MediaError, match="no video frames") as e:
        pipe.render(np.zeros((0, 32, 32, 3), np.uint8), 25.0, np.zeros(1600, np.float32))
    assert e.value.to_payload() == jerrors.MediaError(
        "no video frames to lip-sync", user_message="The video contains no frames").to_payload()


def test_the_entry_points_need_the_card_without_device():
    if torch.cuda.is_available():
        pytest.skip("this host has a CUDA device; the default device is valid here")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        tmp.MuseTalkPipeline(cfg=_port_cfg(CFG))
    with pytest.raises(RuntimeError, match="no CUDA device"):
        tmp.default_lipsync_fn()


# ------------------------------------------------------- release layout, bake


def _whisper_dir(root, tw):
    from expressive_speech_translation_tpu_torch.models.safetensors_io import write_safetensors

    root.mkdir(parents=True)
    cfg = _port_cfg(WCFG)
    (root / "config.json").write_text(json.dumps(em.whisper_hf_config(cfg)))
    state = em.whisper_hf_state_dict(tw, cfg)
    state.pop("proj_out.weight")                 # tied: save_pretrained stores it once
    write_safetensors(state, root / "model.safetensors", metadata={"format": "pt"})
    return root


def test_release_layout_bake_and_default_lipsync_fn(render_models, tmp_path, monkeypatch):
    from expressive_speech_translation_tpu.models import loaders as jld

    jp, _, tp, tw = render_models
    cfg = _port_cfg(RCFG)
    release = em.write_musetalk(tmp_path / "release", tp, cfg)
    assert (release / "sd-vae-ft-mse" / "diffusion_pytorch_model.safetensors").exists()
    params, got_cfg = tld.load_musetalk(release, device=CPU)
    # the JSONs hold no crop size or window length: the published 256 and 50
    assert got_cfg == dataclasses.replace(cfg, image_size=256, audio_ctx=50)
    assert_trees_equal(params, tp)
    jparams, jcfg = jld.load_musetalk(release)
    assert _fields(jcfg) == _fields(got_cfg)
    assert_trees_equal(tmt.from_jax_params(_np(jparams), CPU), tp)

    bake = tmp_path / "bake"
    tld.bake_models(bake, musetalk=str(release),
                    musetalk_whisper=str(_whisper_dir(tmp_path / "tiny", tw)), device=CPU)
    params, baked_cfg = tld.load_converted(bake / "musetalk", tmt.MuseTalkConfig, CPU)
    assert baked_cfg == got_cfg
    assert_trees_equal(params, tp)
    wparams, wcfg = tld.load_converted(bake / "musetalk_whisper", twh.WhisperConfig, CPU)
    assert wcfg.d_model == 48
    assert_trees_equal(wparams["encoder"], tw["encoder"])

    monkeypatch.setenv("EST_MODELS_DIR", str(bake))
    fn = tmp.default_lipsync_fn(device=CPU)
    pipe = fn.pipeline
    assert pipe.cfg == got_cfg and pipe.device == torch.device(CPU)
    audio = np.random.default_rng(1).standard_normal(8_000).astype(np.float32)
    cond = tmp.whisper_feature_fn(wparams, wcfg, device=CPU)(audio)
    np.testing.assert_array_equal(pipe.audio_feature_fn(audio).float().numpy(), cond.float().numpy())
    frames = synthetic_clip(n=3)
    out = fn(frames, 24.0, audio, 16_000)
    assert out.shape == frames.shape and (out != frames).any()
    # without a whisper of the UNet's width, the tiled log-mel
    (bake / "musetalk_whisper" / "config.json").rename(bake / "skip.json")
    np.testing.assert_array_equal(
        tmp.default_lipsync_fn(device=CPU).pipeline.audio_feature_fn(audio).numpy(),
        tmp._mel_audio_features(audio, 48, CPU).numpy())


# ---------------------------------------------------------------- face tail


def _tracks(tracks):
    return [None if t is None else (t.face, t.mouth, t.detected) for t in tracks]


def _gap_clip():
    rng = np.random.default_rng(3)

    def face_frame(cx):
        f = rng.integers(0, 40, (64, 64, 3), np.uint8)
        f[20:44, cx:cx + 24] = (200, 140, 120)
        return f

    return [face_frame(10 + i) for i in range(8)] + [
        rng.integers(0, 40, (64, 64, 3), np.uint8) for _ in range(8)]


TAIL_CLIPS = {
    "talking head": (lambda: synthetic_clip(n=60), 25.0),
    "fast pan": (lambda: fast_pan_clip()[0], 25.0),
    "gap": (_gap_clip, 4.0),
    "no face": (lambda: np.random.default_rng(4).integers(0, 40, (30, 64, 64, 3),
                                                          dtype=np.uint8), 15.0),
}


@pytest.mark.parametrize("clip", sorted(TAIL_CLIPS))
def test_the_face_tail_matches_jax(clip):
    make, fps = TAIL_CLIPS[clip]
    frames = make()
    tracks = tface.track_face_windows(frames, fps)
    assert _tracks(tracks) == _tracks(jface.track_face_windows(frames, fps))
    for refine in (True, False):
        assert (tface.per_frame_face_boxes(frames, fps, refine=refine)
                == jface.per_frame_face_boxes(frames, fps, refine=refine))
    anchors = [i for i in range(0, len(frames), 7)]
    boxes = [tuple(int(v) for v in b) for b in jface.per_frame_face_boxes(frames, fps,
                                                                           refine=False)]
    assert (tface.refine_boxes_flow(frames, boxes, anchors)
            == jface.refine_boxes_flow(frames, boxes, anchors))
    assert tface.frames_face_detector(frames) == jface.frames_face_detector(frames)


def test_the_flow_follows_a_fast_pan_and_leaves_a_static_head():
    frames, centers = fast_pan_clip()
    refined = tface.per_frame_face_boxes(frames, fps=25.0, refine=True)
    err = [np.hypot((y0 + y1) / 2 - cy, (x0 + x1) / 2 - cx)
           for (y0, x0, y1, x1), (cy, cx) in zip(refined, centers)]
    assert max(err) <= 16.0
    still = synthetic_clip(n=30)
    assert (tface.per_frame_face_boxes(still, 25.0, refine=True)
            == jface.per_frame_face_boxes(still, 25.0, refine=True))


def test_smooth_boxes_and_patch_shift_match_jax():
    g = np.random.default_rng(8)
    boxes = [tuple(int(v) for v in g.integers(0, 200, 4)) for _ in range(17)]
    for window in (1, 3, 5):
        assert tface.smooth_boxes(boxes, window) == jface.smooth_boxes(boxes, window)
    a = g.uniform(0, 255, (48, 48)).astype(np.float32)
    b = np.roll(a, (3, -5), axis=(0, 1))
    assert tface._phase_shift(a, b) == jface._phase_shift(a, b)
    frame = g.integers(0, 255, (90, 120, 3), np.uint8)
    np.testing.assert_array_equal(tface._gray_patch(frame, (5, -3, 70, 130)),
                                  jface._gray_patch(frame, (5, -3, 70, 130)))


def _drifting_detector():
    calls = []

    def det(frame):
        i = len(calls)
        calls.append(i)
        if i % 5 == 2:
            return None
        return (10 + i, 20 + i, 60 + i, 70 + i)

    det.calls = calls
    return det


@pytest.mark.parametrize("detector", ["drifting", "total miss"])
def test_per_frame_boxes_with_a_learned_detector_match_jax(detector):
    frames = synthetic_clip(n=12)
    make = _drifting_detector if detector == "drifting" else (lambda: lambda f: None)
    tdet, jdet = make(), make()
    tface.provide_learned_detector(tdet)
    jface.provide_learned_detector(jdet)
    got = tface.per_frame_face_boxes(frames, fps=24.0)
    assert got == jface.per_frame_face_boxes(frames, fps=24.0)
    if detector == "drifting":
        assert len(tdet.calls) == 12 and [b[0] for b in got] == sorted(b[0] for b in got)
    else:
        assert all(b[1] < 120 < b[3] for b in got)     # the classical path carried it


def test_frames_face_detector_raises_jax_error_on_no_frames():
    with pytest.raises(terrors.MediaError) as got:
        tface.frames_face_detector([])
    with pytest.raises(jerrors.MediaError) as want:
        jface.frames_face_detector([])
    assert got.value.to_payload() == want.value.to_payload()
    assert str(got.value) == str(want.value)


# ---------------------------------------------------------------- the app


def test_main_wires_the_video_route_with_one_lazy_lipsync(tmp_path, monkeypatch, caplog):
    """``main()`` with the shim: a NativeVideoIO whose lip-sync builds
    ``default_lipsync_fn()`` once under concurrent first calls; without it,
    JAX's warning and no video route."""
    import atexit
    import signal

    import werkzeug.serving

    from expressive_speech_translation_tpu_torch.core import config as tconfig
    from expressive_speech_translation_tpu_torch.media import native
    from expressive_speech_translation_tpu_torch.serve import app as tapp

    cfg = tconfig.load_config(env={"EST_ENGINES__MODE": "fake"}, temp_dir=str(tmp_path))
    served = []
    monkeypatch.setattr(tconfig, "load_config", lambda: cfg)
    monkeypatch.setattr(tapp, "setup_logging", lambda *a, **k: None)
    create_app = tapp.create_app       # main() serves on the card; here, on the CPU
    monkeypatch.setattr(tapp, "create_app", lambda *a, **k: create_app(*a, device=CPU, **k))
    monkeypatch.setattr(signal, "signal", lambda *a: None)
    monkeypatch.setattr(atexit, "register", lambda *a: None)
    monkeypatch.setattr(werkzeug.serving, "run_simple",
                        lambda host, port, app, **kw: served.append((host, port, app, kw)))
    built = []

    def factory():
        built.append(threading.get_ident())
        time.sleep(0.2)
        return lambda frames, fps, audio, sr: frames + 1

    monkeypatch.setattr(tmp, "default_lipsync_fn", factory)
    monkeypatch.setattr(native, "available", lambda: True)
    tapp.main()
    (_, port, app, kw), = served
    assert port == cfg.serve.port and kw == {"threaded": True}
    vio = app.video_processor.video_io
    assert isinstance(vio, native.NativeVideoIO)
    frames = np.zeros((2, 4, 4, 3), np.uint8)
    outs = []
    threads = [threading.Thread(target=lambda: outs.append(vio._lipsync_fn(frames, 25.0, None, 0)))
               for _ in range(4)]
    for t in threads:
        t.start()
    for t in threads:
        t.join()
    assert len(built) == 1 and len(outs) == 4 and all((o == 1).all() for o in outs)

    served.clear()
    monkeypatch.setattr(native, "available", lambda: False)
    with caplog.at_level(logging.WARNING):
        tapp.main()
    assert served[0][2].video_processor is None
    assert any("/process-video disabled" in r.getMessage() for r in caplog.records)


def test_process_video_with_lipsync_through_both_apps(render_models, tmp_path):
    """/process-video with apply_lip_sync=true over fake engines, each app on
    its own shim and MuseTalk (the same toy weights): both deliver an MP4 of
    the same frame count and audio length, lip-synced (no mux fallback)."""
    from werkzeug.test import Client

    from expressive_speech_translation_tpu.media import native as jnative
    from expressive_speech_translation_tpu.serve import app as japp
    from expressive_speech_translation_tpu_torch.media import native
    from expressive_speech_translation_tpu_torch.serve import app as tapp

    from test_torch_serve import _configs, _frames

    tools = native.toolchain()
    if tools["g++"] is None or not all(tools["headers"].values()):
        pytest.skip("g++ or libav's headers are missing here")
    native.build()
    jp, jw, tp, tw = render_models
    src = tmp_path / "clip.mp4"
    t = np.arange(16_000) / 16_000
    native.encode_video(src, synthetic_clip(n=24), fps=24.0,
                        audio=(0.3 * np.sin(2 * np.pi * 220 * t)).astype(np.float32))
    jcfg, tcfg = _configs(tmp_path)
    jvio = jnative.NativeVideoIO(lipsync_fn=jmp.musetalk_lipsync_fn(
        jp, RCFG, whisper=(jw, WCFG), batch_size=4, dtype=jnp.float32))
    tvio = native.NativeVideoIO(lipsync_fn=tmp.musetalk_lipsync_fn(
        tp, _port_cfg(RCFG), whisper=(tw, _port_cfg(WCFG)), batch_size=4, dtype=torch.float32,
        device=CPU))
    results = []
    for client in (Client(japp.create_app(config=jcfg, video_io=jvio)),
                   Client(tapp.create_app(config=tcfg, video_io=tvio, device=CPU))):
        r = client.post("/process-video", data={
            "file": (io.BytesIO(src.read_bytes()), "clip.mp4"), "target_language": "fra",
            "apply_lip_sync": "true"})
        frames = _frames(r)
        assert [f["progress"] for f in frames] == [10, 20, 30, 55, 60, 90, 100], frames[-1]
        out = tmp_path / f"out{len(results)}.mp4"
        import base64

        out.write_bytes(base64.b64decode(frames[-1]["result"]["video"]))
        video, fps = native.decode_video(out)
        audio, _ = native.decode_audio(out, target_rate=16_000, target_channels=1)
        results.append((video.shape, round(fps, 3), len(audio)))
    assert results[0] == results[1]
    assert results[1][0][0] >= 20
