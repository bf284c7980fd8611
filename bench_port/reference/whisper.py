"""Whisper in plain PyTorch: a frozen copy of the port's ``models/whisper.py``
(config, seeded init, encoder, the cached decoder step with its
cross-attention alignment); the reference the ASR is judged against."""

from __future__ import annotations

import dataclasses
from typing import Callable, Tuple

import numpy as np
import torch
import torch.nn.functional as F

from .common import (AttnConfig, Init, Params, dense, embed_rows, gelu, init_decoder_kv_cache, layer_norm, merge_heads, mha, mha_step, mlp, precompute_layer_cross_kv, sinusoid_position_embedding, split_heads, tied_head_logits)

GumbelFn = Callable[[int, Tuple[int, ...]], torch.Tensor]


@dataclasses.dataclass(frozen=True)
class WhisperConfig:
    n_mels: int = 80
    d_model: int = 384
    encoder_layers: int = 4
    decoder_layers: int = 4
    heads: int = 6
    ffn_dim: int = 1536
    vocab_size: int = 51865
    max_source_positions: int = 1500
    max_target_positions: int = 448
    bos_token: int = 50258           # <|startoftranscript|>
    eos_token: int = 50257           # <|endoftext|>
    task_transcribe: int = 50359
    task_translate: int = 50358
    no_timestamps: int = 50363
    no_speech_token: int = 50362     # <|nospeech|>
    sop_token: int = 50361           # <|startofprev|>
    lang_token_start: int = 50259    # <|en|>; 99 consecutive language tokens
    n_langs: int = 99

    @property
    def attn(self) -> AttnConfig:
        return AttnConfig(self.d_model, self.heads, k_bias=False)

    @classmethod
    def tiny(cls):
        return cls(d_model=384, encoder_layers=4, decoder_layers=4, heads=6, ffn_dim=1536)

    @classmethod
    def base(cls):
        return cls(d_model=512, encoder_layers=6, decoder_layers=6, heads=8, ffn_dim=2048)

    @classmethod
    def small(cls):
        return cls(d_model=768, encoder_layers=12, decoder_layers=12, heads=12, ffn_dim=3072)

    @classmethod
    def medium(cls):
        return cls(d_model=1024, encoder_layers=24, decoder_layers=24, heads=16, ffn_dim=4096)


# ------------------------------------------------------------------ parameters


def init_whisper(seed: int, cfg: WhisperConfig, device) -> Params:
    """Seeded random parameters (f32) on ``device``."""
    r = Init(seed, device)
    return {
        "encoder": {
            "conv1": {"kernel": r.uniform((cfg.d_model, cfg.n_mels, 3), 1.0 / np.sqrt(cfg.n_mels * 3)),
                      "bias": r.zeros((cfg.d_model,))},
            "conv2": {"kernel": r.uniform((cfg.d_model, cfg.d_model, 3), 1.0 / np.sqrt(cfg.d_model * 3)),
                      "bias": r.zeros((cfg.d_model,))},
            "pos": torch.as_tensor(sinusoid_position_embedding(cfg.max_source_positions, cfg.d_model),
                                   device=r.device),
            "layers": [r.pre_ln_block(cfg.attn, cfg.d_model, cfg.ffn_dim, cross=False)
                       for _ in range(cfg.encoder_layers)],
            "ln_post": r.layer_norm(cfg.d_model),
        },
        "decoder": {
            "embed": r.normal((cfg.vocab_size, cfg.d_model), 0.02),
            "pos": r.normal((cfg.max_target_positions, cfg.d_model), 0.02),
            "layers": [r.pre_ln_block(cfg.attn, cfg.d_model, cfg.ffn_dim, cross=True)
                       for _ in range(cfg.decoder_layers)],
            "ln": r.layer_norm(cfg.d_model),
        },
    }


# --------------------------------------------------------------------- encoder


def encode(params: Params, cfg: WhisperConfig, mel: torch.Tensor) -> torch.Tensor:
    """mel [B, n_mels, frames] → encoder states [B, frames / 2, D]."""
    enc = params["encoder"]
    x = mel.to(enc["conv1"]["kernel"].dtype)
    x = gelu(F.conv1d(x, enc["conv1"]["kernel"], enc["conv1"]["bias"], padding=1))
    x = gelu(F.conv1d(x, enc["conv2"]["kernel"], enc["conv2"]["bias"], stride=2, padding=1))
    x = x.transpose(1, 2)
    x = x + enc["pos"][: x.shape[1]]
    for block in enc["layers"]:
        h = layer_norm(block["self_attn_ln"], x)
        x = x + mha(block["self_attn"], cfg.attn, h, h)
        h = layer_norm(block["mlp_ln"], x)
        x = x + mlp(block["mlp"], h)
    return layer_norm(enc["ln_post"], x)


# --------------------------------------------------------------------- decoder


def precompute_cross_kv(params: Params, cfg: WhisperConfig, enc_out: torch.Tensor):
    return precompute_layer_cross_kv(params["decoder"]["layers"], cfg.attn, enc_out)


def init_kv_cache(cfg: WhisperConfig, batch: int, dtype, device, max_len: int):
    """Cache sized to the decode budget (prompt + max_new), not the 448
    ceiling: every step reads the whole (masked) cache."""
    return init_decoder_kv_cache(cfg.decoder_layers, batch, max_len, cfg.heads,
                                 cfg.d_model // cfg.heads, dtype, device)


def decode_step_with_attn(params: Params, cfg: WhisperConfig, token: torch.Tensor, pos: int,
                          kv_cache, cross_kv) -> Tuple[torch.Tensor, torch.Tensor]:
    """One decoder step → (logits [B, vocab], alignment [B, T_enc]): the
    head-mean cross-attention weights averaged over the upper half of the
    layers (whisper's alignment heads convention)."""
    dec = params["decoder"]
    x = embed_rows(dec["embed"], token)[:, None, :] + dec["pos"][pos][None, None, :]
    attn_maps = []
    for block, cache, (ck, cv) in zip(dec["layers"], kv_cache, cross_kv):
        h = layer_norm(block["self_attn_ln"], x)
        x = x + mha_step(block["self_attn"], cfg.attn, h, cache, pos)
        h = layer_norm(block["cross_attn_ln"], x)
        q = split_heads(dense(block["cross_attn"]["q"], h), cfg.heads) * (cfg.attn.head_dim ** -0.5)
        logits = torch.einsum("bqhd,bkhd->bhqk", q, ck)
        weights = torch.softmax(logits.float(), dim=-1)
        attn_maps.append(weights[:, :, 0, :].mean(dim=1))
        out = torch.einsum("bhqk,bkhd->bqhd", weights.to(h.dtype), cv)
        x = x + dense(block["cross_attn"]["o"], merge_heads(out))
        h = layer_norm(block["mlp_ln"], x)
        x = x + mlp(block["mlp"], h)
    x = layer_norm(dec["ln"], x)
    logits = tied_head_logits(dec, x[:, 0, :], dec["embed"])
    half = len(attn_maps) // 2
    return logits, torch.stack(attn_maps[half:]).mean(dim=0)


