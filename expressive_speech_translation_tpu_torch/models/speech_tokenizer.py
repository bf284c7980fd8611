"""Speech tokenizer: mel → discrete 25 Hz speech tokens (FSQ, 6561 codes).

Port of the JAX package's ``models/speech_tokenizer.py``, CosyVoice2's
supervised speech tokenizer as a first-class model:

  mel 24 kHz (50 Hz frames) → conv stride 2 (→ 25 Hz) → tanh-gelu →
  pre-LN transformer encoder → linear to 8 dims → FSQ → token id

FSQ bounds each dimension with tanh and rounds it to ``levels`` values (3
levels × 8 dims = 3⁸ = 6561 ids), read in base ``levels``. The parameters
stay f32 whatever the serving dtype, as in the JAX package.
"""

from __future__ import annotations

import dataclasses
from typing import Tuple

import torch
import torch.nn.functional as F

from ..ops.mel import kaldi_fbank
from .common import AttnConfig, Init, Params, dense, layer_norm, mha, mlp, tree_from_numpy


@dataclasses.dataclass(frozen=True)
class SpeechTokenizerConfig:
    n_mels: int = 80
    dim: int = 256
    layers: int = 4
    heads: int = 4
    fsq_dims: int = 8
    fsq_levels: int = 3            # 3^8 = 6561
    downsample: int = 2            # 50 Hz mel frames → 25 Hz tokens

    @property
    def vocab_size(self) -> int:
        return self.fsq_levels ** self.fsq_dims

    @property
    def attn(self) -> AttnConfig:
        return AttnConfig(self.dim, self.heads, k_bias=True)


CONV_WIDTH = 5


def init_speech_tokenizer(seed: int, cfg: SpeechTokenizerConfig, device) -> Params:
    """Seeded random parameters (f32) on ``device``; the input conv kernel
    is ``[dim, n_mels, 5]``."""
    r = Init(seed, device)
    blocks = [{"attn": r.attention(cfg.attn), "attn_ln": r.layer_norm(cfg.dim),
               "mlp": r.mlp(cfg.dim, 4 * cfg.dim), "mlp_ln": r.layer_norm(cfg.dim)}
              for _ in range(cfg.layers)]
    return {"conv_in": {"kernel": r.uniform((cfg.dim, cfg.n_mels, CONV_WIDTH),
                                            1.0 / (cfg.n_mels * CONV_WIDTH) ** 0.5),
                        "bias": r.zeros((cfg.dim,))},
            "blocks": blocks,
            "ln_out": r.layer_norm(cfg.dim),
            "to_fsq": r.dense(cfg.dim, cfg.fsq_dims),
            "from_fsq": r.dense(cfg.fsq_dims, cfg.dim)}


def from_jax_params(tree, device) -> Params:
    """The JAX package's tree (numpy leaves) → the port's, in f32: the input
    conv kernel ``[5, n_mels, dim]`` → ``[dim, n_mels, 5]``; dense kernels
    keep ``[in, out]``."""
    p = tree_from_numpy(tree, device, torch.float32)
    p["conv_in"]["kernel"] = p["conv_in"]["kernel"].permute(2, 1, 0).contiguous()
    return p


def _fsq(z: torch.Tensor, levels: int) -> Tuple[torch.Tensor, torch.Tensor]:
    """Finite scalar quantisation of z [..., D] → (codes scaled to [-1, 1]
    with a straight-through gradient, integer levels 0..levels-1)."""
    half = (levels - 1) / 2.0
    # even level counts live on a half-integer grid (L=4 → {±0.5, ±1.5})
    offset = 0.5 if levels % 2 == 0 else 0.0
    bounded = torch.tanh(z) * half
    quantised = torch.round(bounded - offset) + offset     # half to even, as jnp.round
    codes = bounded + (quantised - bounded).detach()
    ints = torch.round(quantised + half).to(torch.int32)
    return codes / half, ints


def codes_to_ids(ints: torch.Tensor, levels: int) -> torch.Tensor:
    """[..., D] base-``levels`` digits → int32 token ids."""
    weights = torch.tensor([levels ** i for i in range(ints.shape[-1])], dtype=torch.int32,
                           device=ints.device)
    return (ints * weights).sum(dim=-1).to(torch.int32)


def ids_to_codes(ids: torch.Tensor, *, levels: int = 3, dims: int = 8) -> torch.Tensor:
    """Inverse of :func:`codes_to_ids` → normalised codes in [-1, 1]."""
    digits = []
    rem = ids
    for _ in range(dims):
        digits.append(rem % levels)
        rem = rem // levels
    half = (levels - 1) / 2.0
    return (torch.stack(digits, dim=-1).float() - half) / half


def encode_with_codes(params: Params, cfg: SpeechTokenizerConfig, mel: torch.Tensor,
                      mask: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """mel [B, T, n_mels] (50 Hz frames) + mask [B, T] → (token ids
    [B, T // downsample], token mask, decoded codes [B, T // downsample, dim])."""
    x = mel * mask[..., None].to(mel.dtype)
    x = F.conv1d(x.transpose(1, 2), params["conv_in"]["kernel"], params["conv_in"]["bias"],
                 stride=cfg.downsample, padding=CONV_WIDTH // 2).transpose(1, 2)
    x = F.gelu(x, approximate="tanh")     # jax.nn.gelu's default; the blocks' mlp is exact erf
    tok_mask = mask[:, ::cfg.downsample][:, :x.shape[1]]
    attn_mask = tok_mask[:, None, None, :]
    for blk in params["blocks"]:
        h = layer_norm(blk["attn_ln"], x)
        x = x + mha(blk["attn"], cfg.attn, h, h, mask=attn_mask)
        h = layer_norm(blk["mlp_ln"], x)
        x = x + mlp(blk["mlp"], h)
    z = dense(params["to_fsq"], layer_norm(params["ln_out"], x))
    codes, ints = _fsq(z, cfg.fsq_levels)
    ids = codes_to_ids(ints, cfg.fsq_levels)
    return torch.where(tok_mask, ids, 0), tok_mask, dense(params["from_fsq"], codes)


def encode(params: Params, cfg: SpeechTokenizerConfig, mel: torch.Tensor,
           mask: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """Inference: (token ids, token mask) of :func:`encode_with_codes`."""
    ids, tok_mask, _ = encode_with_codes(params, cfg, mel, mask)
    return ids, tok_mask


def tokenize_audio(params: Params, cfg: SpeechTokenizerConfig,
                   audio_24k: torch.Tensor) -> torch.Tensor:
    """[T] 24 kHz waveform → [n_tokens] ids at 25 Hz (40 ms / 20 ms fbank)."""
    mel = kaldi_fbank(audio_24k[None], sr=24_000, frame_length_ms=40.0,
                      frame_shift_ms=20.0, n_mels=cfg.n_mels)
    mask = torch.ones(mel.shape[:2], dtype=torch.bool, device=mel.device)
    ids, _ = encode(params, cfg, mel, mask)
    return ids[0]
