"""NLLB-200 in plain PyTorch: a frozen copy of the port's ``models/nllb.py``
(config, seeded init, encoder, the cached decoder step); the reference the
NMT is judged against."""

from __future__ import annotations

import dataclasses
import functools

import numpy as np
import torch

from .common import (AttnConfig, Init, Params, embed_rows, layer_norm, mha, mha_step, mlp, tied_head_logits)

_mlp = functools.partial(mlp, activation=torch.relu)


@dataclasses.dataclass(frozen=True)
class NLLBConfig:
    d_model: int = 1024
    encoder_layers: int = 12
    decoder_layers: int = 12
    heads: int = 16
    ffn_dim: int = 4096
    vocab_size: int = 256_206
    max_positions: int = 1024
    pad_token: int = 1
    bos_token: int = 0
    eos_token: int = 2
    decoder_start_token: int = 2  # M2M100 starts decoding from </s>

    @property
    def attn(self) -> AttnConfig:
        return AttnConfig(self.d_model, self.heads, k_bias=True)

    @classmethod
    def distilled_600m(cls):
        return cls()


def m2m100_sinusoids(num_positions: int, dim: int, padding_idx: int = 1) -> np.ndarray:
    """M2M100SinusoidalPositionalEmbedding table [num_positions + 2, dim]."""
    num_embeddings = num_positions + 2
    half_dim = dim // 2
    emb = np.log(10000.0) / (half_dim - 1)
    emb = np.exp(np.arange(half_dim) * -emb)
    emb = np.arange(num_embeddings)[:, None] * emb[None, :]
    table = np.concatenate([np.sin(emb), np.cos(emb)], axis=1)
    if dim % 2 == 1:
        table = np.concatenate([table, np.zeros((num_embeddings, 1))], axis=1)
    table[padding_idx, :] = 0
    return table.astype(np.float32)


def position_ids_from_tokens(tokens: torch.Tensor, pad_token: int) -> torch.Tensor:
    """HF create_position_ids_from_input_ids: cumsum over non-pad + padding_idx."""
    mask = (tokens != pad_token).to(torch.int64)
    return torch.cumsum(mask, dim=1) * mask + pad_token


def init_nllb(seed: int, cfg: NLLBConfig, device) -> Params:
    r = Init(seed, device)
    return {
        "embed": r.normal((cfg.vocab_size, cfg.d_model), 0.02),
        "pos": torch.as_tensor(m2m100_sinusoids(cfg.max_positions, cfg.d_model, cfg.pad_token),
                               device=r.device),
        "encoder": {"layers": [r.pre_ln_block(cfg.attn, cfg.d_model, cfg.ffn_dim, cross=False)
                               for _ in range(cfg.encoder_layers)],
                    "ln": r.layer_norm(cfg.d_model)},
        "decoder": {"layers": [r.pre_ln_block(cfg.attn, cfg.d_model, cfg.ffn_dim, cross=True)
                               for _ in range(cfg.decoder_layers)],
                    "ln": r.layer_norm(cfg.d_model)},
    }


def encode(params: Params, cfg: NLLBConfig, tokens: torch.Tensor) -> torch.Tensor:
    """tokens [B, T] (pad = cfg.pad_token) → encoder states [B, T, D]."""
    max_pos_id = tokens.shape[1] + cfg.pad_token
    if max_pos_id >= params["pos"].shape[0]:
        raise ValueError(
            f"source length {tokens.shape[1]} needs position id {max_pos_id} "
            f"but the position table has {params['pos'].shape[0]} rows "
            f"(max_positions={cfg.max_positions})")
    scale = float(np.sqrt(cfg.d_model))
    pos_ids = position_ids_from_tokens(tokens, cfg.pad_token)
    x = embed_rows(params["embed"], tokens) * scale + params["pos"][pos_ids]
    pad_mask = (tokens != cfg.pad_token)[:, None, None, :]
    for block in params["encoder"]["layers"]:
        h = layer_norm(block["self_attn_ln"], x)
        x = x + mha(block["self_attn"], cfg.attn, h, h, mask=pad_mask)
        h = layer_norm(block["mlp_ln"], x)
        x = x + _mlp(block["mlp"], h)
    return layer_norm(params["encoder"]["ln"], x)


def decode_step(params: Params, cfg: NLLBConfig, token: torch.Tensor, pos: int, kv_cache,
                cross_kv, enc_pad_mask: torch.Tensor) -> torch.Tensor:
    """One cached decoder step → logits [B, vocab]. Generated tokens are never
    pad, so the position id is pos + 1 + padding_idx."""
    scale = float(np.sqrt(cfg.d_model))
    x = (embed_rows(params["embed"], token)[:, None, :] * scale
         + params["pos"][pos + 1 + cfg.pad_token][None, None, :])
    for block, cache, (ck, cv) in zip(params["decoder"]["layers"], kv_cache, cross_kv):
        h = layer_norm(block["self_attn_ln"], x)
        x = x + mha_step(block["self_attn"], cfg.attn, h, cache, pos)
        h = layer_norm(block["cross_attn_ln"], x)
        x = x + mha(block["cross_attn"], cfg.attn, h, None, precomputed_kv=(ck, cv),
                    mask=enc_pad_mask)
        h = layer_norm(block["mlp_ln"], x)
        x = x + _mlp(block["mlp"], h)
    x = layer_norm(params["decoder"]["ln"], x)
    return tied_head_logits(params, x[:, 0, :], params["embed"])


