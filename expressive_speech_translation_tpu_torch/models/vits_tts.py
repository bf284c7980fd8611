"""VITS-style single-speaker text-to-speech (the ESPnet kan-bayashi_ljspeech_vits
family), the model behind the reference's per-language ESPnet TTS path.

The port of the JAX package's ``models/vits_tts.py``. Inference (VITS,
arXiv:2106.06103, the deterministic-duration variant):

  char ids → transformer text encoder → prior stats (m_p, logs_p)
           → duration prior → hard upsample to the frame rate
           → z_p = m_p + exp(logs_p)·ε·noise_scale → inverse normalizing flow
           → HiFi-GAN decoder → waveform at 22.05 kHz

The flow and the decoder are the VITS modules of the OpenVoice converter
(``models/openvoice.py``: ``flow_inverse``, ``generator_decode``; OpenVoice is
a VITS derivative); the hard upsample is ``models/seamless.py``'s. The
generator's resblocks compute ``fused_resblock_stage``'s function in plain
``F.conv1d``, as the JAX package does in plain XLA.

ε is injectable: :func:`synthesize` takes ``eps`` (the standard-normal draw
[B, max_frames, inter]); the JAX package draws it from ``PRNGKey(0)`` on every
call, and the port without ``eps`` from a generator seeded 0 on every call, so
each instance stays deterministic.
"""

from __future__ import annotations

import dataclasses
import math
import zlib
from typing import Optional, Tuple

import numpy as np
import torch
import torch.nn.functional as F

from ..core.device import resolve_device
from .common import (AttnConfig, Init, Params, dense, layer_norm, mha, mlp,
                     permute_conv_kernels, sinusoid_position_embedding, tree_from_numpy)
from .openvoice import (OpenVoiceConfig, _init_coupling, _init_generator, flow_inverse,
                        generator_decode)
from .seamless import hard_upsample


@dataclasses.dataclass(frozen=True)
class VitsTTSConfig:
    vocab: int = 256                    # byte-level text ids
    hidden: int = 96
    layers: int = 2
    heads: int = 4
    ffn: int = 192
    inter_channels: int = 96            # flow / prior channels
    max_positions: int = 512
    frames_per_char: float = 4.0        # duration prior at 86 fps (hop 256)
    sample_rate: int = 22_050

    @property
    def attn(self) -> AttnConfig:
        return AttnConfig(self.hidden, self.heads, k_bias=True)

    @property
    def ov(self) -> OpenVoiceConfig:
        # the flow and HiFi-GAN geometry of the OpenVoice converter's modules,
        # with a narrower decoder trunk (the per-language ESPnet path)
        return OpenVoiceConfig(inter_channels=self.inter_channels, hidden=self.inter_channels,
                               se_dim=32, upsample_initial=128)


def init_vits(seed: int, cfg: VitsTTSConfig = VitsTTSConfig(), device=None) -> Params:
    """Seeded random parameters (f32) on ``device`` (the card unless
    ``device="cpu"``): the JAX package's tree at the port's layouts."""
    r = Init(seed, resolve_device(device))
    return {
        "embed": r.normal((cfg.vocab, cfg.hidden), 0.02),
        "pos": torch.as_tensor(sinusoid_position_embedding(cfg.max_positions, cfg.hidden),
                               device=r.device),
        "encoder": {"layers": [r.pre_ln_block(cfg.attn, cfg.hidden, cfg.ffn, cross=False)
                               for _ in range(cfg.layers)],
                    "ln": r.layer_norm(cfg.hidden)},
        "prior_proj": r.dense(cfg.hidden, 2 * cfg.inter_channels),
        "dur_proj": r.dense(cfg.hidden, 1),
        "se": r.normal((1, cfg.ov.se_dim), 0.1),
        # flow_inverse reads params["flow"]: coupling layers as in the converter
        "flow": [_init_coupling(r, cfg.ov) for _ in range(cfg.ov.n_flows)],
        "decoder": _init_generator(r, cfg.ov),
    }


def from_jax_params(tree, device, dtype=torch.float32) -> Params:
    """The JAX package's VITS tree → the port's: conv kernels [k, in, out] →
    [out, in, k]; the decoder's ``ups`` kernels, stored flipped as
    [k, in, out], → torch's [in, out, k] unflipped; dense kernels as they are."""
    p = tree_from_numpy(tree, device, dtype)
    ups = p["decoder"].pop("ups")
    permute_conv_kernels(p, (2, 1, 0))
    p["decoder"]["ups"] = [{"kernel": u["kernel"].permute(1, 2, 0).flip(-1).contiguous(),
                            "bias": u["bias"]} for u in ups]
    return p


def encode_text(params: Params, cfg: VitsTTSConfig, tokens: torch.Tensor,
                mask: torch.Tensor) -> torch.Tensor:
    """tokens [B, T] (mask True = valid) → encoder states [B, T, hidden]."""
    x = params["embed"][tokens.long()] + params["pos"][: tokens.shape[1]][None]
    attend = mask[:, None, None, :]
    for blk in params["encoder"]["layers"]:
        h = layer_norm(blk["self_attn_ln"], x)
        x = x + mha(blk["self_attn"], cfg.attn, h, h, mask=attend)
        h = layer_norm(blk["mlp_ln"], x)
        x = x + mlp(blk["mlp"], h)
    return layer_norm(params["encoder"]["ln"], x)


def synthesize(params: Params, cfg: VitsTTSConfig, tokens: torch.Tensor, mask: torch.Tensor,
               *, max_frames: int, noise_scale: float = 0.667,
               eps: Optional[torch.Tensor] = None) -> Tuple[torch.Tensor, torch.Tensor]:
    """[B, T] char ids → (waveform [B, max_frames·hop], valid samples [B]).
    ``eps`` is the prior's standard-normal draw [B, max_frames, inter]; without
    it one is drawn from a generator seeded 0 (every call alike, as the JAX
    package draws from ``PRNGKey(0)``)."""
    h = encode_text(params, cfg, tokens, mask)
    m_p, logs_p = dense(params["prior_proj"], h).chunk(2, dim=-1)

    log_dur = dense(params["dur_proj"], h)[..., 0]
    # a softplus centred so that a zero-weight predictor still speaks at
    # frames_per_char: weightless instances give audio whose length scales
    # with the text
    dur = F.softplus(log_dur) + cfg.frames_per_char - math.log(2.0)
    dur = torch.where(mask, torch.clamp_min(torch.round(dur), 1.0),
                      torch.zeros((), dtype=dur.dtype, device=dur.device)).to(torch.int32)

    m_up = hard_upsample(m_p, dur, max_frames)
    logs_up = hard_upsample(logs_p, dur, max_frames)
    n_frames = dur.sum(dim=1)
    frame_mask = torch.arange(max_frames, device=tokens.device)[None, :] < n_frames[:, None]

    if eps is None:
        generator = torch.Generator(device=m_up.device).manual_seed(0)
        eps = torch.randn(m_up.shape, generator=generator, device=m_up.device)
    z_p = m_up + torch.exp(logs_up) * eps.to(m_up.dtype) * noise_scale
    z_p = torch.where(frame_mask[..., None], z_p, torch.zeros((), dtype=z_p.dtype,
                                                              device=z_p.device))

    # the OpenVoice modules take latents [B, T, C] and the SE [B, se_dim]
    se = params["se"].expand(tokens.shape[0], params["se"].shape[1])
    z = flow_inverse(params, cfg.ov, z_p, se)
    wave = generator_decode(params["decoder"], cfg.ov, z, se)
    hop = int(np.prod(cfg.ov.upsample_rates))
    return wave.reshape(tokens.shape[0], -1), n_frames * hop


class VitsTTSModel:
    """An ESPnet-TTS-shaped wrapper: ``synthesize(text, language=...) ->
    wave`` at 22 050 Hz, one instance per language (the ESPnet backend's
    cache unit). No checkpoint path exists for this family, so an instance is
    always random: seeded from ``zlib.crc32(f"vits:{language}")`` as the JAX
    package seeds it (deterministic per language; torch's numbers, not
    JAX's), cast to bf16, and ``weightless`` (``/available-backends`` labels
    the backend "random")."""

    def __init__(self, language: str, cfg: VitsTTSConfig = VitsTTSConfig(), *,
                 max_chars: int = 256, max_frames: int = 1024, device=None):
        from . import common

        self.language = language
        self.cfg = cfg
        self.sample_rate = cfg.sample_rate
        self.weightless = True
        self.max_chars = max_chars
        self.max_frames = max_frames
        self.device = resolve_device(device)
        seed = zlib.crc32(f"vits:{language}".encode()) & 0x7FFFFFFF
        self.params = common.cast_floats(init_vits(seed, cfg, self.device), torch.bfloat16)

    def synthesize(self, text: str, language: Optional[str] = None) -> np.ndarray:
        """UTF-8 bytes (at most ``max_chars``) → f32 waveform, trimmed to its
        valid samples and peak-limited to 0.95; ε from a generator seeded 0,
        every call alike."""
        ids = np.frombuffer(text.encode("utf-8")[: self.max_chars], np.uint8).astype(np.int64)
        n = max(len(ids), 1)
        tokens = torch.zeros((1, self.max_chars), dtype=torch.int64)
        tokens[0, :len(ids)] = torch.from_numpy(ids)
        mask = torch.zeros((1, self.max_chars), dtype=torch.bool)
        mask[0, :n] = True
        with torch.no_grad():
            wave, n_samples = synthesize(self.params, self.cfg, tokens.to(self.device),
                                         mask.to(self.device), max_frames=self.max_frames)
        m = int(np.clip(int(n_samples[0]), 1, wave.shape[1]))
        out = wave[0, :m].float().cpu().numpy()
        peak = float(np.abs(out).max()) or 1.0
        return (0.95 * out / max(peak, 0.95)).astype(np.float32)
