"""diff2lip: diffusion lip-sync (the reference's legacy path, before MuseTalk).

The port of the JAX package's ``pipeline/diff2lip.py``: the wav2lip-family
mel condition the published checkpoints were trained on (80 Hz mel,
16-step windows aligned to the video's frames), per-frame face boxes, the
hidden-mouth conditioning (the bottom ``face_hide_percentage`` of the crop
is hidden and re-synthesised, the visible region pasted back after
sampling), DDIM (default) or DDPM sampling over the TFG UNet
(``models/gd_unet.py``, ``models/diffusion.py``), the jaw-mode blend back
into the frames, and cross-identity dubbing (``identity_frames``).

Face boxes, the mel's filterbank product and the blend run on the host, as
in JAX; the STFT, the crops and the sampling run on the card unless the
caller passes ``device="cpu"``. The pipeline's dtype follows its
parameters: a bf16 tree runs the UNet in bf16, the sampler's arithmetic
stays f32 (as JAX's promotion keeps it) and the sampled crops are f32.

Randomness is explicit. ``generate`` draws from a ``torch.Generator``
(seed 0 unless one is given), or takes each batch's draws from ``noise``:
``noise(batch_index, shape) → BatchNoise`` at the batch's shape as JAX
draws it (a tail padded to ``batch_size`` when there are more frames than
one batch); the port runs a short tail as it is and takes the first rows.
"""

from __future__ import annotations

import dataclasses
import logging
from typing import Callable, List, NamedTuple, Optional, Sequence, Tuple

import numpy as np
import torch

from ..core.device import resolve_device
from ..core.errors import MediaError
from ..models import gd_unet
from ..models.common import Params
from ..models.diffusion import DiffusionConfig, GaussianDiffusion, space_timesteps
from ..models.musetalk import resize_linear
from .face import per_frame_face_boxes
from .musetalk_pipeline import blend_face_np, clamp_box

log = logging.getLogger(__name__)

Box = Tuple[int, int, int, int]


# ------------------------------------------------------------- mel windowing


def wav2lip_mel(audio_16k: np.ndarray, *, n_mels: int = 80, device=None) -> np.ndarray:
    """The mel family the published diff2lip/wav2lip checkpoints were
    trained on (audio/audio.py melspectrogram + hparams.py): pre-emphasis
    0.97 → |STFT| (n_fft 800, hop 200 → 80 Hz, Hann, centred; on
    ``device``) → Slaney mel 55-7600 Hz → 20·log10(max(1e-5, ·)) − 20 →
    the symmetric [−4, 4] normalisation. → [T_mel, n_mels] float32."""
    from ..ops.mel import mel_filterbank
    from ..ops.stft import stft

    x = np.asarray(audio_16k, np.float32).reshape(-1)
    if len(x) < 2:
        x = np.zeros(2, np.float32)
    pre = np.concatenate([x[:1], x[1:] - 0.97 * x[:-1]])  # lfilter([1, -k], [1])
    real, imag = stft(torch.from_numpy(pre).to(resolve_device(device)), 800, 200, center=True)
    mag = torch.sqrt(real**2 + imag**2).cpu().numpy()        # [T, 401]
    fb = mel_filterbank(16_000, 800, n_mels, fmin=55.0, fmax=7600.0, htk=False, norm="slaney")
    s_db = 20.0 * np.log10(np.maximum(1e-5, mag @ fb)) - 20.0   # ref_level_db
    # symmetric_mels: [-4, 4] against min_level_db = -100
    return np.clip(8.0 * ((s_db + 100.0) / 100.0) - 4.0, -4.0, 4.0).astype(np.float32)


def mel_windows_for_frames(audio_16k: np.ndarray, n_frames: int, fps: float, *,
                           window_frames: int = 16, n_mels: int = 80, device=None) -> np.ndarray:
    """Per-video-frame mel crops (generate.py's crop_audio_window: 80 Hz
    mel, the window of frame i starting at its timestamp) →
    [n_frames, window_frames, n_mels]."""
    feats = wav2lip_mel(audio_16k, n_mels=n_mels, device=device)
    t_mel = feats.shape[0]
    starts = (np.arange(n_frames) / fps * 80.0).astype(np.int64)
    starts = np.clip(starts, 0, max(t_mel - window_frames, 0))
    idx = np.clip(starts[:, None] + np.arange(window_frames)[None, :], 0, t_mel - 1)
    return feats[idx]


# ------------------------------------------------------------ face detection


def smooth_boxes(boxes: Sequence[Box], window: int = 5) -> List[Box]:
    """diff2lip's get_smoothened_boxes (T=5): a FORWARD window with in-place
    feedback — boxes[i] is overwritten before the tail's windows read it.
    ``pipeline/face.py``'s centred ``smooth_boxes`` (MuseTalk's) has other
    semantics; both stay."""
    arr = np.asarray(boxes, np.float32)
    n = len(arr)
    for i in range(n):
        win = arr[n - window:] if i + window > n else arr[i: i + window]
        arr[i] = win.mean(axis=0)
    return [tuple(int(round(v)) for v in row) for row in arr]


def center_face_detector(frame: np.ndarray) -> Box:
    """The centred square (the middle 60% of the frame) used when no face
    is found."""
    h, w = frame.shape[:2]
    size = int(min(h, w) * 0.6)
    y0 = (h - size) // 2
    x0 = (w - size) // 2
    return (y0, x0, y0 + size, x0 + size)


# --------------------------------------------------------------------- config


@dataclasses.dataclass(frozen=True)
class Diff2LipConfig:
    """The published Diff2Lip e2e checkpoint's geometry by default
    (generate.py defaults + script_util.py: image 128, 128 base channels,
    mult (1, 1, 2, 3, 4), attention at ds 8/16, 4 heads, scale-shift norm,
    use_ref + audio-as-style)."""

    image_size: int = 128
    model_channels: int = 128
    channel_mult: Tuple[int, ...] = (1, 1, 2, 3, 4)
    attention_ds: Tuple[int, ...] = (8, 16)
    heads: int = 4
    norm_groups: int = 32
    mel_window: int = 16
    n_mels: int = 80
    audio_model_channels: int = 32
    audio_channel_mult: Tuple[int, ...] = (1, 2, 3, 4)
    audio_init_spatial: int = 64
    face_hide_percentage: float = 0.5     # generate.py:372
    diffusion_steps: int = 1000
    sampling_steps: str = "ddim25"   # respaced sampling (timestep_respacing)
    schedule: str = "linear"

    @property
    def unet(self) -> gd_unet.GDUNetConfig:
        return gd_unet.GDUNetConfig(
            image_size=self.image_size, in_channels=9, out_channels=3,
            model_channels=self.model_channels, channel_mult=self.channel_mult,
            attention_ds=self.attention_ds, num_heads=self.heads,
            norm_groups=self.norm_groups,
            audio_dim=self.n_mels, audio_frames=self.mel_window,
            audio_model_channels=self.audio_model_channels,
            audio_channel_mult=self.audio_channel_mult,
            audio_init_spatial=self.audio_init_spatial,
        )


def init_diff2lip_unet(seed: int, cfg: Diff2LipConfig, device) -> Params:
    return gd_unet.init_gd_unet(seed, cfg.unet, device)


# ------------------------------------------------------------------ pipeline


class BatchNoise(NamedTuple):
    """One batch's draws, NCHW [rows, 3, S, S]: the hidden region's
    conditioning noise, the sampler's start and one draw a sampler step."""

    cond: torch.Tensor
    x_init: torch.Tensor
    steps: Sequence[torch.Tensor]


NoiseFn = Callable[[int, Tuple[int, ...]], BatchNoise]


class Diff2LipPipeline:
    def __init__(self, cfg: Diff2LipConfig = Diff2LipConfig(), params: Optional[Params] = None,
                 *, detector: Optional[Callable[[np.ndarray], Optional[Box]]] = None,
                 use_ddim: bool = True, device=None):
        """``params``: a TFG tree on ``device`` (random f32 weights when
        None). ``detector``: an optional per-frame face detector returning
        Optional[(y0, x0, y1, x1)] — misses carry the previous detection
        forward, and a clip with none gets the centre crop. Without one,
        ``face.per_frame_face_boxes`` gives the boxes."""
        self.cfg = cfg
        self.device = resolve_device(device)
        if params is None:
            log.warning("Diff2LipPipeline: random weights (no checkpoint supplied)")
            params = init_diff2lip_unet(11, cfg, self.device)
        self.params = params
        self.detector = detector
        self.use_ddim = use_ddim
        self.diffusion = GaussianDiffusion(
            DiffusionConfig(steps=cfg.diffusion_steps, schedule=cfg.schedule),
            use_timesteps=space_timesteps(cfg.diffusion_steps, cfg.sampling_steps))
        s = cfg.image_size
        mask = torch.zeros((1, 1, s, 1), device=self.device)
        mask[:, :, int(s * (1.0 - cfg.face_hide_percentage)):] = 1.0   # the hidden mouth
        self.mask = mask

    @classmethod
    def from_models_dir(cls, root: Optional[str] = None, **kw) -> "Diff2LipPipeline":
        """The baked TFG weights from ``{root|EST_MODELS_DIR}/diff2lip``
        (written by the bake's ``--diff2lip``) when present, else random
        weights."""
        import os
        from pathlib import Path

        root = root or os.environ.get("EST_MODELS_DIR")
        if root:
            d = Path(root) / "diff2lip"
            if (d / "config.json").exists():
                from ..models.loaders import load_converted

                params, cfg = load_converted(d, Diff2LipConfig, kw.get("device"))
                log.info("Diff2LipPipeline: baked weights from %s", d)
                return cls(cfg, params, **kw)
        return cls(**kw)

    def _model_fn(self, x_t, t, *, cond_img, ref_img, mel):
        return gd_unet.gd_unet_apply(self.params, self.cfg.unet, x_t, t, cond_img=cond_img,
                                     mask=self.mask, ref_img=ref_img, mel=mel)

    def sample(self, crops: torch.Tensor, ref: torch.Tensor, mel: torch.Tensor, *,
               noise: Optional[BatchNoise] = None,
               generator: Optional[torch.Generator] = None) -> torch.Tensor:
        """One batch: crops and reference crops [B, 3, S, S] in [-1, 1]
        (f32), mel windows [B, T, n_mels] → the sampled crops, f32, the
        visible region the crops' own."""
        with torch.inference_mode():
            shape = tuple(crops.shape)
            if noise is None:
                cond_noise = torch.randn(shape, generator=generator, device=self.device)
                draws = {"generator": generator, "device": self.device}
            else:
                cond_noise = noise.cond
                draws = {"x_init": noise.x_init, "step_noise": noise.steps}
            # cond = the visible region of the target + noise in the hidden one
            cond = crops * (1.0 - self.mask) + self.mask * cond_noise
            sampler = (self.diffusion.ddim_sample_loop if self.use_ddim
                       else self.diffusion.p_sample_loop)
            x = sampler(self._model_fn, shape, cond_img=cond, ref_img=ref, mel=mel, **draws)
            # only the hidden region is generated (generate.py:272-273)
            return (x * self.mask + (1.0 - self.mask) * crops).float()

    def crops(self, frames: Sequence[np.ndarray], boxes: Sequence[Box]) -> torch.Tensor:
        """Each frame's box resized to S×S as ``jax.image.resize(...,
        "linear")`` resizes it, in [-1, 1] → [N, 3, S, S] f32 on the card."""
        s = self.cfg.image_size
        return torch.stack([
            resize_linear(torch.from_numpy(np.ascontiguousarray(f[y0:y1, x0:x1]))
                          .to(self.device, torch.float32) / 127.5 - 1.0, s, s)
            for f, (y0, x0, y1, x1) in zip(frames, boxes)]).permute(0, 3, 1, 2)

    def boxes(self, seq: np.ndarray, fps: float) -> List[Box]:
        """The clamped per-frame face boxes of a clip."""
        hh, ww = seq.shape[1:3]
        if self.detector is not None:
            raw, last = [], None
            for f in seq:
                b = self.detector(f)
                if b is not None:       # misses carry the previous detection forward
                    last = b
                raw.append(last)
            if last is None:
                raw = [center_face_detector(seq[0])] * len(seq)
            else:
                first = next(b for b in raw if b is not None)
                raw = [b if b is not None else first for b in raw]
            raw = smooth_boxes(raw)
        else:
            # per-frame tracking: one clip-level box paints the jaw onto
            # background once the head moves
            raw = per_frame_face_boxes(seq, fps)
        return [clamp_box(b, hh, ww) for b in raw]

    def generate(self, frames: np.ndarray, audio_16k: np.ndarray, fps: float, *,
                 identity_frames: Optional[np.ndarray] = None,
                 generator: Optional[torch.Generator] = None, noise: Optional[NoiseFn] = None,
                 batch_size: int = 8) -> np.ndarray:
        """Re-render the mouths of frames [N, H, W, 3] uint8 to the 16 kHz
        audio; returns uint8 frames. ``identity_frames`` switches to
        cross-identity dubbing (``--sample_mode cross``): the reference
        crops come from that clip, its own boxes, its index wrapped."""
        if len(frames) == 0:
            raise MediaError("no video frames to lip-sync",
                             user_message="The video contains no frames")
        n = len(frames)
        if noise is None and generator is None:
            generator = torch.Generator(device=self.device).manual_seed(0)
        boxes = self.boxes(frames, fps)
        if identity_frames is not None:
            # the identity clip has its own face geometry and may be shorter
            identity, id_boxes = identity_frames, self.boxes(identity_frames, fps)
        else:
            identity, id_boxes = frames, boxes
        n_id = len(identity)
        mels = mel_windows_for_frames(audio_16k, n, fps, window_frames=self.cfg.mel_window,
                                      n_mels=self.cfg.n_mels, device=self.device)
        # JAX pads a short tail to batch_size when there is more than one batch
        rows = batch_size if n > batch_size else n
        out = frames.copy()
        for b, start in enumerate(range(0, n, batch_size)):
            idx = list(range(start, min(start + batch_size, n)))
            ids = [i % n_id for i in idx]
            crops = self.crops([frames[i] for i in idx], [boxes[i] for i in idx])
            ref = self.crops([identity[j] for j in ids], [id_boxes[j] for j in ids])
            mel = torch.from_numpy(np.ascontiguousarray(mels[idx])).to(self.device)
            draws = None
            if noise is not None:
                full, k = noise(b, (rows, 3, self.cfg.image_size, self.cfg.image_size)), len(idx)
                draws = BatchNoise(full.cond[:k], full.x_init[:k], [d[:k] for d in full.steps])
            rendered = self.sample(crops, ref, mel, noise=draws, generator=generator)
            rendered = rendered.permute(0, 2, 3, 1).cpu().numpy()
            for j, i in enumerate(idx):
                out[i] = blend_face_np(out[i], rendered[j], boxes[i])
        return out
