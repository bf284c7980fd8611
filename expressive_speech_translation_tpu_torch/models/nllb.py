"""NLLB-200 (M2M100 architecture) NMT.

The port of the JAX package's ``models/nllb.py`` (``encode`` with its
position guards, ``generate`` greedy or by beam search with the forced BOS
as a runtime argument, and ``quantize_nllb_decoder``): shared embeddings
scaled by sqrt(d), M2M100 sinusoidal positions (offset-2 table,
padding-aware ids), pre-LN blocks with every projection biased, ReLU MLPs,
final encoder/decoder layer norms, tied head. :func:`from_hf_state_dict`
reads an HF M2M100 checkpoint.
"""

from __future__ import annotations

import dataclasses
import functools

import numpy as np
import torch

from ..core.device import resolve_device
from .beam import BeamConfig, beam_search, greedy_search
from .common import (AttnConfig, Init, Params, cast_floats, embed_rows, hf_pre_ln_block,
                     hf_state_getter,
                     init_decoder_kv_cache, layer_norm, mha, mha_step, mlp,
                     precompute_layer_cross_kv, quantize_embed_head, quantize_transformer_blocks,
                     state_tensor, tied_head_logits, tree_from_numpy)

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


def from_jax_params(tree, device, dtype=torch.float32) -> Params:
    """The JAX package's NLLB parameter tree → the port's (same layout)."""
    return tree_from_numpy(tree, device, dtype)


def from_hf_state_dict(state, cfg: NLLBConfig, device=None, dtype=torch.float32) -> Params:
    """An HF ``M2M100ForConditionalGeneration`` state dict (``model.``-rooted
    or bare; any float dtype) → the port's tree on ``device``, floating
    leaves in ``dtype``: the shared embedding (also the tied head), every
    dense weight [out, in] → kernel [in, out], and the sinusoidal position
    table, which the checkpoint does not hold, from
    :func:`m2m100_sinusoids` (the JAX package's ``from_hf_state_dict``)."""
    dev = resolve_device(device)
    g = hf_state_getter(state)

    def stack(side, n, cross):
        return {"layers": [hf_pre_ln_block(g, f"{side}.layers.{i}", dev, cross=cross, k_bias=True)
                           for i in range(n)],
                "ln": {"scale": state_tensor(g(f"{side}.layer_norm.weight"), dev),
                       "bias": state_tensor(g(f"{side}.layer_norm.bias"), dev)}}

    params = {"embed": state_tensor(g("shared.weight"), dev),
              "pos": torch.as_tensor(m2m100_sinusoids(cfg.max_positions, cfg.d_model,
                                                      cfg.pad_token), device=dev),
              "encoder": stack("encoder", cfg.encoder_layers, False),
              "decoder": stack("decoder", cfg.decoder_layers, True)}
    return cast_floats(params, dtype)


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


def generate(params: Params, cfg: NLLBConfig, src_tokens: torch.Tensor, forced_bos_token: int,
             *, num_beams: int = 1, max_new_tokens: int = 200, min_new_tokens: int = 0,
             length_penalty: float = 1.0) -> torch.Tensor:
    """Translation, greedy or by beam search (``num_beams`` > 1): [B, 1 +
    max_new_tokens] int32 token ids (``</s> <lang> ...`` — the forced-BOS
    language token counts as the first generated token, HF layout)."""
    b = src_tokens.shape[0]
    dev = src_tokens.device
    if max_new_tokens < 0:
        raise ValueError(f"max_new_tokens must be >= 0, got {max_new_tokens}")
    if max_new_tokens == 0:
        return torch.full((b, 1), cfg.decoder_start_token, dtype=torch.int32, device=dev)
    max_len = 1 + max_new_tokens
    max_pos_id = (max_len - 2) + 1 + cfg.pad_token
    if max_pos_id >= params["pos"].shape[0]:
        raise ValueError(
            f"max_new_tokens={max_new_tokens} needs position id {max_pos_id} "
            f"but the position table has {params['pos'].shape[0]} rows "
            f"(max_positions={cfg.max_positions})")
    enc_out = encode(params, cfg, src_tokens)
    enc_pad_mask = (src_tokens != cfg.pad_token)[:, None, None, :]
    cross_kv = precompute_layer_cross_kv(params["decoder"]["layers"], cfg.attn, enc_out)
    prompt = torch.tensor([[cfg.decoder_start_token, int(forced_bos_token)]] * b,
                          dtype=torch.int32, device=dev)

    def step_fn(token, pos, cache, beam_state):
        cross, pad_mask = beam_state
        return decode_step(params, cfg, token, pos, cache, cross, pad_mask)

    bc = BeamConfig(eos_token=cfg.eos_token, pad_token=cfg.pad_token, max_len=max_len,
                    num_beams=num_beams, length_penalty=length_penalty,
                    min_new_tokens=min_new_tokens)
    rows = b * num_beams if num_beams > 1 else b
    cache = init_decoder_kv_cache(cfg.decoder_layers, rows, max_len, cfg.heads,
                                  cfg.d_model // cfg.heads, enc_out.dtype, dev)
    search = beam_search if num_beams > 1 else greedy_search
    return search(step_fn, prompt, cache, (cross_kv, enc_pad_mask), bc)


def quantize_nllb_decoder(params: Params) -> Params:
    """int8 weights for the decode path: the decoder blocks' dense layers and
    a per-row int8 copy of the shared embedding for the logits (``embed_q``);
    the encoder and the float embedding (for the gathers) stay as they are."""
    dec = dict(params["decoder"])
    dec["layers"] = quantize_transformer_blocks(dec["layers"])
    return {**params, "decoder": dec, "embed_q": quantize_embed_head(params["embed"])}


def nllb_partition_rules(tp_axis: str = "tp"):
    """TP rules for NLLB/M2M100: the same shared-block Megatron layout
    (``common.transformer_partition_rules``); sinusoid positions and norms
    replicate. Requires heads % tp == 0."""
    from .common import transformer_partition_rules

    return transformer_partition_rules(tp_axis)
