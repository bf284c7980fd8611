"""Full-frame MuseTalk lip-sync: detection → crop → re-render → blend.

The port of the JAX package's ``pipeline/musetalk_pipeline.py``: the host
orchestration around ``models/musetalk.py``. Per-frame face boxes come from
``pipeline/face.py`` (the role DWPose plays for the reference's MuseTalk
container), the crops are resized to 256×256 and re-rendered in batches of 8
on the card, and the jaw region is blended back into the frames on the host.
The audio condition is 50 Hz whisper encoder states, through the log-mel
kernel (``ops/cuda_mel.py``) and ``models/whisper.py`` ``encode``; without a
width-matched whisper it is log-mel frames tiled to the UNet's audio width.

``musetalk_lipsync_fn`` adapts the pipeline to ``media.native.NativeVideoIO``'s
``lipsync_fn(frames, fps, audio, sr) → frames`` seam, which the video route
consumes. Everything runs on the card unless the caller passes
``device="cpu"``.
"""

from __future__ import annotations

import logging
from typing import Callable, Optional

import numpy as np
import torch

from ..core.device import resolve_device
from ..core.errors import MediaError
from ..models import musetalk as mtm
from ..models.common import cast_floats
from .face import per_frame_face_boxes

log = logging.getLogger(__name__)

AudioFeatureFn = Callable[[np.ndarray], torch.Tensor]


# ------------------------------------------------------------ host compositing
#
# Blending runs per frame over potentially thousands of frames, so it stays
# on the host in numpy, with the alpha mask cached per box geometry
# (models/musetalk.blend_face's math).

_ALPHA_CACHE: dict = {}


def _blend_alpha(h: int, w: int, feather: int = 16, jaw_only: bool = True) -> np.ndarray:
    key = (h, w, feather, jaw_only)
    alpha = _ALPHA_CACHE.get(key)
    if alpha is None:
        yy = np.arange(h)[:, None].astype(np.float32)
        xx = np.arange(w)[None, :].astype(np.float32)
        edge = np.minimum(np.minimum(yy + 1, h - yy),
                          np.minimum(xx + 1, w - xx)) / max(feather, 1)
        alpha = np.clip(edge, 0.0, 1.0)
        if jaw_only:
            jaw = np.clip((yy - h * 0.45) / (h * 0.1), 0.0, 1.0)
            alpha = alpha * jaw
        alpha = alpha[..., None]
        if len(_ALPHA_CACHE) > 256:   # per-frame boxes vary slightly
            _ALPHA_CACHE.clear()
        _ALPHA_CACHE[key] = alpha
    return alpha


def _resize_bilinear_np(img: np.ndarray, h: int, w: int) -> np.ndarray:
    """[S, S, C] float → [h, w, C] bilinear, no antialiasing (the host
    composite's resize)."""
    s0, s1 = img.shape[:2]
    ys = (np.arange(h) + 0.5) * s0 / h - 0.5
    xs = (np.arange(w) + 0.5) * s1 / w - 0.5
    y0 = np.clip(np.floor(ys).astype(int), 0, s0 - 1)
    x0 = np.clip(np.floor(xs).astype(int), 0, s1 - 1)
    y1 = np.clip(y0 + 1, 0, s0 - 1)
    x1 = np.clip(x0 + 1, 0, s1 - 1)
    wy = np.clip(ys - y0, 0.0, 1.0)[:, None, None]
    wx = np.clip(xs - x0, 0.0, 1.0)[None, :, None]
    top = img[y0][:, x0] * (1 - wx) + img[y0][:, x1] * wx
    bot = img[y1][:, x0] * (1 - wx) + img[y1][:, x1] * wx
    return top * (1 - wy) + bot * wy


def blend_face_np(frame_u8: np.ndarray, face: np.ndarray, bbox) -> np.ndarray:
    """Composite a re-rendered [-1, 1] crop into a uint8 frame at ``bbox``
    (models/musetalk.blend_face's jaw-mode math, on the host)."""
    y0, x0, y1, x1 = bbox
    h, w = y1 - y0, x1 - x0
    alpha = _blend_alpha(h, w)
    face_resized = _resize_bilinear_np(np.asarray(face, np.float32), h, w)
    out = frame_u8.copy()
    region = out[y0:y1, x0:x1].astype(np.float32) / 127.5 - 1.0
    blended = region * (1 - alpha) + face_resized * alpha
    out[y0:y1, x0:x1] = np.clip((blended + 1.0) * 127.5, 0, 255).astype(np.uint8)
    return out


def clamp_box(box, h: int, w: int, *, min_size: int = 8):
    """Clamp a (smoothed, flow-refined or learned-detector) box to the frame
    with a minimum size: negative or out-of-frame coordinates would wrap
    numpy slices into empty or wrong-region crops."""
    y0, x0, y1, x1 = (int(round(v)) for v in box)
    y0 = max(0, min(y0, h - min_size))
    x0 = max(0, min(x0, w - min_size))
    y1 = max(y0 + min_size, min(y1, h))
    x1 = max(x0 + min_size, min(x1, w))
    return (y0, x0, y1, x1)


# -------------------------------------------------------------- audio condition


def _mel_audio_features(audio_16k: np.ndarray, audio_dim: int, device=None) -> torch.Tensor:
    """The condition when no whisper encoder is available: log-mel frames
    at 50 features/s, tiled to ``audio_dim``. → [T, audio_dim] f32."""
    from ..ops.mel import mel_filterbank
    from ..ops.stft import spectrogram

    dev = resolve_device(device)
    x = torch.as_tensor(np.asarray(audio_16k, np.float32), device=dev)
    power = spectrogram(x, 400, 320, center=True, power=2.0)   # 16k / 320 = 50 Hz
    fb = torch.as_tensor(mel_filterbank(16_000, 400, 80), device=dev)
    feats = torch.log10(torch.clamp_min(power @ fb, 1e-10))   # [T, 80]
    reps = -(-audio_dim // feats.shape[-1])
    return feats.repeat(1, reps)[:, :audio_dim]


def whisper_feature_fn(params, cfg, *, dtype=torch.bfloat16, device=None) -> AudioFeatureFn:
    """50 Hz Whisper ENCODER states as the UNet's audio condition (the
    reference's: a resident WhisperModel encodes the dub audio). ``params`` /
    ``cfg`` are a ``models/whisper`` tree (whisper-tiny for the published
    MuseTalk UNet: cross_attention_dim 384 == tiny's d_model).

    The audio is encoded in whisper's 30 s windows, each window's log-mel
    from the log-mel kernel on the card (its plain version on the CPU), and
    the feature stream cut to ceil(duration · 50): one encoder state per
    20 ms, the rate ``whisper_chunks_for_video`` assumes."""
    from ..models import whisper as wm
    from ..ops.cuda_mel import whisper_log_mel_fused

    dev = resolve_device(device)
    params = cast_floats(params, dtype)
    chunk = 30 * 16_000

    def fn(audio_16k: np.ndarray) -> torch.Tensor:
        audio = np.asarray(audio_16k, np.float32).reshape(-1)
        n_feat = max(int(np.ceil(len(audio) / 16_000.0 * 50.0)), 1)
        outs = []
        for start in range(0, max(len(audio), 1), chunk):
            seg = np.zeros(chunk, np.float32)
            piece = audio[start:start + chunk]
            seg[:len(piece)] = piece
            mel = whisper_log_mel_fused(torch.from_numpy(seg).to(dev), n_mels=cfg.n_mels,
                                        chunk_samples=chunk)
            with torch.inference_mode():
                outs.append(wm.encode(params, cfg, mel[None].to(dtype))[0])   # [1500, d_model]
        return torch.cat(outs, dim=0)[:n_feat]

    return fn


# ------------------------------------------------------------------- pipeline


class MuseTalkPipeline:
    def __init__(self, params=None, cfg: Optional[mtm.MuseTalkConfig] = None, *,
                 audio_feature_fn: Optional[AudioFeatureFn] = None, whisper=None,
                 batch_size: int = 8, dtype=torch.bfloat16, device=None):
        """``params``: a MuseTalk tree (random weights when None); ``whisper``:
        (whisper params, WhisperConfig), the default condition when its
        d_model equals the UNet's audio width; ``batch_size`` frames a UNet
        pass, as the reference batches them."""
        self.cfg = cfg or mtm.MuseTalkConfig()
        self.device = resolve_device(device)
        if params is None:
            log.warning("MuseTalkPipeline: random weights (no checkpoint supplied)")
            params = mtm.init_musetalk(7, self.cfg, self.device)
        self.params = cast_floats(params, dtype)
        self.dtype = dtype
        if audio_feature_fn is None and whisper is not None:
            w_params, w_cfg = whisper
            if w_cfg.d_model != self.cfg.audio_dim:
                log.warning(
                    "MuseTalkPipeline: whisper d_model %d != UNet audio_dim %d "
                    "— falling back to tiled log-mel features (the published "
                    "MuseTalk UNet conditions on whisper-TINY states)",
                    w_cfg.d_model, self.cfg.audio_dim)
            else:
                audio_feature_fn = whisper_feature_fn(w_params, w_cfg, dtype=dtype,
                                                      device=self.device)
        self.audio_feature_fn = audio_feature_fn or (
            lambda a: _mel_audio_features(a, self.cfg.audio_dim, self.device))
        self.batch_size = batch_size

    def crops(self, frames: np.ndarray, boxes) -> torch.Tensor:
        """The face crops [N, 3, S, S] in [-1, 1], each box resized to S×S as
        ``jax.image.resize(..., "linear")`` resizes it, in the pipeline's dtype."""
        s = self.cfg.image_size
        return torch.stack([
            mtm.resize_linear(torch.from_numpy(np.ascontiguousarray(frames[i, b[0]:b[2], b[1]:b[3]]))
                              .to(self.device, torch.float32) / 127.5 - 1.0, s, s)
            for i, b in enumerate(boxes)]).permute(0, 3, 1, 2).to(self.dtype)

    def render(self, frames: np.ndarray, fps: float, audio_16k: np.ndarray) -> np.ndarray:
        """Lip-sync full frames [N, H, W, 3] uint8 to the audio; returns
        uint8 frames."""
        n = frames.shape[0]
        if n == 0:
            raise MediaError("no video frames to lip-sync",
                             user_message="The video contains no frames")
        h, w = frames.shape[1:3]
        # per-frame boxes: a single clip-level box paints the synthesized jaw
        # onto background the moment the speaker moves or the shot cuts
        boxes = [clamp_box(b, h, w) for b in per_frame_face_boxes(frames, fps)]
        feats = self.audio_feature_fn(np.asarray(audio_16k, np.float32))
        windows = mtm.whisper_chunks_for_video(feats, n_frames=n, fps=fps,
                                               ctx=self.cfg.audio_ctx).to(self.dtype)
        with torch.inference_mode():
            rendered = mtm.lipsync_frames(self.params, self.cfg, self.crops(frames, boxes),
                                          windows, batch_size=self.batch_size)
            rendered = rendered.permute(0, 2, 3, 1).float().cpu().numpy()
        out = frames.copy()
        for i, b in enumerate(boxes):
            out[i] = blend_face_np(out[i], rendered[i], b)
        return out


def musetalk_lipsync_fn(params=None, cfg: Optional[mtm.MuseTalkConfig] = None, **kwargs
                        ) -> Callable[[np.ndarray, float, np.ndarray, int], np.ndarray]:
    """The ``NativeVideoIO(lipsync_fn=...)`` adapter: resamples the dub audio
    to 16 kHz (``ops/resample.py`` on the pipeline's device) and renders.
    ``kwargs`` go to :class:`MuseTalkPipeline` (``device=`` among them)."""
    from ..ops.resample import resample

    pipe = MuseTalkPipeline(params, cfg, **kwargs)

    def fn(frames: np.ndarray, fps: float, audio: np.ndarray, sr: int) -> np.ndarray:
        wave = np.asarray(audio, np.float32).reshape(-1)
        if sr != 16_000:
            wave = resample(torch.from_numpy(wave).to(pipe.device), sr, 16_000).cpu().numpy()
        return pipe.render(np.asarray(frames), fps, wave)

    fn.pipeline = pipe
    return fn


def default_lipsync_fn(device=None) -> Callable[[np.ndarray, float, np.ndarray, int], np.ndarray]:
    """The lip-sync fn with baked-weight discovery: the MuseTalk tree from
    ``EST_MODELS_DIR/musetalk`` and a width-matched whisper encoder from
    ``musetalk_whisper`` (else ``asr``) for the 50 Hz condition. Random
    weights and the tiled log-mel otherwise."""
    import json
    import os
    from pathlib import Path

    params = mt_cfg = whisper = None
    root = os.environ.get("EST_MODELS_DIR")
    if root:
        from ..models import whisper as wm
        from ..models.loaders import load_converted

        if (Path(root) / "musetalk" / "config.json").exists():
            params, mt_cfg = load_converted(Path(root) / "musetalk", mtm.MuseTalkConfig, device)
        audio_dim = (mt_cfg or mtm.MuseTalkConfig()).audio_dim
        for sub in ("musetalk_whisper", "asr"):
            config = Path(root) / sub / "config.json"
            # the width is read before the tree, so a wider ASR bake is not loaded
            if config.exists() and json.loads(config.read_text())["d_model"] == audio_dim:
                whisper = load_converted(Path(root) / sub, wm.WhisperConfig, device)
                break
    return musetalk_lipsync_fn(params, mt_cfg, whisper=whisper, device=device)
