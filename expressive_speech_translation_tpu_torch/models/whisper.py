"""Whisper-family ASR: encoder + KV-cached autoregressive decoder.

The port of the JAX package's ``models/whisper.py`` (``encode``,
``decode_with_alignment``, ``detect_language``, ``dtw_token_times``,
``quantize_whisper_decoder``):
conv1d×2 frontend (stride 2), fixed sinusoidal encoder positions, pre-LN
blocks, learned decoder positions, cross-attention over precomputed encoder
K/V, tied output head, no bias on k. Decoding is a Python loop over one decoder step with early exit
at EOT; the prompt is teacher-forced through the same step.

Layouts: dense kernels [in, out] as in the JAX package; the two conv kernels
are stored in torch's [out, in, width] (:func:`from_jax_params` converts;
:func:`from_hf_state_dict` reads an HF checkpoint straight into them).
"""

from __future__ import annotations

import dataclasses
from typing import Callable, Optional, Sequence, Tuple

import numpy as np
import torch
import torch.nn.functional as F

from ..core.device import resolve_device
from .common import (AttnConfig, Init, Params, cast_floats, dense, embed_rows, gelu,
                     hf_pre_ln_block,
                     hf_state_getter, init_decoder_kv_cache, layer_norm, merge_heads, mha,
                     mha_step, mlp,
                     precompute_layer_cross_kv, quantize_embed_head,
                     quantize_transformer_blocks, sinusoid_position_embedding,
                     split_heads, state_tensor, tied_head_logits, tree_from_numpy)

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


def from_jax_params(tree, device, dtype=torch.float32) -> Params:
    """The JAX package's whisper parameter tree (nested dicts/lists of numpy
    arrays) → the port's; conv kernels [width, in, out] → [out, in, width]."""
    p = tree_from_numpy(tree, device, dtype)
    for name in ("conv1", "conv2"):
        conv = p["encoder"][name]
        conv["kernel"] = conv["kernel"].permute(2, 1, 0).contiguous()
    return p


def from_hf_state_dict(state, cfg: WhisperConfig, device=None, dtype=torch.float32) -> Params:
    """An HF ``WhisperForConditionalGeneration`` / ``WhisperModel`` state dict
    (``model.``-rooted or bare; torch tensors or numpy arrays, any float
    dtype) → the port's tree on ``device``, floating leaves in ``dtype``:
    dense weights [out, in] → kernels [in, out], the conv kernels kept in
    torch's [out, in, width], the tied head read from the decoder's
    embedding (the JAX package's ``from_hf_state_dict``)."""
    dev = resolve_device(device)
    g = hf_state_getter(state)

    def t(name):
        return state_tensor(g(name), dev)

    def block(base, cross):
        return hf_pre_ln_block(g, base, dev, cross=cross, k_bias=False)

    params = {
        "encoder": {
            "conv1": {"kernel": t("encoder.conv1.weight"), "bias": t("encoder.conv1.bias")},
            "conv2": {"kernel": t("encoder.conv2.weight"), "bias": t("encoder.conv2.bias")},
            "pos": t("encoder.embed_positions.weight"),
            "layers": [block(f"encoder.layers.{i}", False) for i in range(cfg.encoder_layers)],
            "ln_post": {"scale": t("encoder.layer_norm.weight"),
                        "bias": t("encoder.layer_norm.bias")},
        },
        "decoder": {
            "embed": t("decoder.embed_tokens.weight"),
            "pos": t("decoder.embed_positions.weight"),
            "layers": [block(f"decoder.layers.{i}", True) for i in range(cfg.decoder_layers)],
            "ln": {"scale": t("decoder.layer_norm.weight"), "bias": t("decoder.layer_norm.bias")},
        },
    }
    return cast_floats(params, dtype)


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


def _id_mask(ids: Sequence[int], vocab: int, device) -> Optional[torch.Tensor]:
    """Bool [vocab] mask of the in-range ids (out-of-range ids are dropped)."""
    keep = [i for i in ids if 0 <= i < vocab]
    if not keep:
        return None
    mask = torch.zeros((vocab,), dtype=torch.bool, device=device)
    mask[torch.as_tensor(keep, device=device)] = True
    return mask


def uniform_gumbel(generator: torch.Generator) -> GumbelFn:
    """Gumbel noise ``-log(-log(u))``, u ~ U[1e-9, 1), from ``generator``."""
    def draw(step: int, shape) -> torch.Tensor:
        u = torch.rand(shape, generator=generator, device=generator.device)
        return -torch.log(-torch.log(u * (1.0 - 1e-9) + 1e-9))
    return draw


def decode_with_alignment(
    params: Params,
    cfg: WhisperConfig,
    mel: torch.Tensor,
    prompt: torch.Tensor,
    *,
    max_new_tokens: int = 224,
    min_new_tokens: int = 0,
    temperature: float = 0.0,
    gumbel: Optional[GumbelFn] = None,
    suppress_tokens: Tuple[int, ...] = (),
    suppress_first_tokens: Tuple[int, ...] = (),
    sot_index: int = 0,
):
    """Decode with per-token cross-attention alignments and log-probs.

    ``temperature`` 0 is greedy; above 0 each generated token is
    ``argmax(logits / T + g)`` with Gumbel noise ``g = gumbel(pos, [B, V])``
    (:func:`uniform_gumbel` over a generator). Sampling without a noise
    source raises: a fixed fallback would make every fallback rung redraw
    the same noise.

    Returns (tokens [B, P+max_new] int32, alignments [B, P+max_new, T_enc],
    sum_logprob [B] over generated tokens incl. EOS, n_generated [B],
    no_speech_prob [B] — P(<|nospeech|>) from the pre-suppression logits at
    the ``sot_index`` step).
    """
    b, p_len = prompt.shape
    if p_len + max_new_tokens > cfg.max_target_positions:
        raise ValueError(
            f"prompt ({p_len}) + max_new_tokens ({max_new_tokens}) exceeds "
            f"max_target_positions ({cfg.max_target_positions})")
    if temperature > 0 and gumbel is None:
        raise ValueError("temperature > 0 sampling needs an explicit noise source "
                         "(a per-request generator)")
    dev = mel.device
    enc_out = encode(params, cfg, mel)
    cross_kv = precompute_cross_kv(params, cfg, enc_out)
    total = p_len + max_new_tokens
    cache = init_kv_cache(cfg, b, enc_out.dtype, dev, total)
    tokens = torch.full((b, total), cfg.eos_token, dtype=torch.int32, device=dev)
    tokens[:, :p_len] = prompt.to(torch.int32)
    aligns = torch.zeros((b, total, enc_out.shape[1]), dtype=torch.float32, device=dev)
    done = torch.zeros((b,), dtype=torch.bool, device=dev)
    slp = torch.zeros((b,), dtype=torch.float32, device=dev)
    ngen = torch.zeros((b,), dtype=torch.int32, device=dev)
    nsp = torch.zeros((b,), dtype=torch.float32, device=dev)
    nsp_tok = min(cfg.no_speech_token, cfg.vocab_size - 1)
    eos_idx = min(cfg.eos_token, cfg.vocab_size - 1)
    suppress = _id_mask(suppress_tokens, cfg.vocab_size, dev)
    suppress_first = _id_mask(suppress_first_tokens, cfg.vocab_size, dev)
    neg = -1e9

    for pos in range(total):
        if pos + 1 >= p_len and bool(done.all()):
            break
        logits, alignment = decode_step_with_attn(params, cfg, tokens[:, pos], pos, cache, cross_kv)
        aligns[:, pos] = alignment
        logits32 = logits.float()
        if pos == sot_index:
            nsp = torch.softmax(logits32, dim=-1)[:, nsp_tok]
        if pos + 1 < p_len or pos + 1 >= total:
            continue  # prompt step, or the last step (alignment row only)
        if min_new_tokens and pos + 1 < p_len + min_new_tokens:
            logits32[:, eos_idx] = neg
        if suppress is not None:
            logits32 = torch.where(suppress, neg, logits32)
        if suppress_first is not None and pos + 1 == p_len:
            logits32 = torch.where(suppress_first, neg, logits32)
        if temperature > 0:
            nxt = torch.argmax(logits32 / max(temperature, 1e-6)
                               + gumbel(pos, tuple(logits32.shape)), dim=-1)
        else:
            nxt = torch.argmax(logits32, dim=-1)
        step_lp = torch.log_softmax(logits32, dim=-1).gather(1, nxt[:, None])[:, 0]
        nxt = torch.where(done, cfg.eos_token, nxt.to(torch.int32))
        counts = ~done
        slp = slp + torch.where(counts, step_lp, 0.0)
        ngen = ngen + counts.to(torch.int32)
        tokens[:, pos + 1] = nxt
        done = done | (nxt == cfg.eos_token)
    return tokens, aligns, slp, ngen, nsp


def detect_language(params: Params, cfg: WhisperConfig,
                    mel: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """Whisper language identification: one decoder pass from
    ``<|startoftranscript|>`` over the encoder output, the logits restricted
    to the language-token block (clamped for tiny vocabularies that lack it).
    mel [B, n_mels, frames] → (language token ids [B], probabilities
    [B, n_langs] f32).

    The JAX function runs the teacher-forced ``decode_full`` over the one
    token; here one :func:`decode_step_with_attn` at position 0 over a fresh
    cache computes the same logits."""
    enc_out = encode(params, cfg, mel)
    cross_kv = precompute_cross_kv(params, cfg, enc_out)
    b = mel.shape[0]
    cache = init_kv_cache(cfg, b, enc_out.dtype, mel.device, 1)
    sot = torch.full((b,), cfg.bos_token, dtype=torch.int32, device=mel.device)
    logits, _ = decode_step_with_attn(params, cfg, sot, 0, cache, cross_kv)
    start = min(cfg.lang_token_start, max(cfg.vocab_size - 1, 0))
    width = max(1, min(cfg.n_langs, cfg.vocab_size - start))
    lang_logits = logits[:, start:start + width]
    probs = torch.softmax(lang_logits.float(), dim=-1)
    return start + torch.argmax(lang_logits, dim=-1), probs


def quantize_whisper_decoder(params: Params) -> Params:
    """int8 weights for the decode path: the decoder blocks' dense layers and
    a per-row int8 copy of the tied output head (``decoder/embed_q``); the
    encoder and the float embedding (for the gathers) stay as they are."""
    dec = dict(params["decoder"])
    dec["layers"] = quantize_transformer_blocks(dec["layers"])
    dec["embed_q"] = quantize_embed_head(dec["embed"])
    return {**params, "decoder": dec}


def dtw_token_times(alignment: np.ndarray, n_tokens: int, audio_seconds: float) -> np.ndarray:
    """Monotonic DTW over -log(attention) → per-token start times in seconds
    (openai-whisper find_alignment parity; host numpy).

    alignment: [T_tokens, T_enc] attention rows for the generated tokens."""
    a = np.asarray(alignment[:n_tokens], np.float64)
    if a.size == 0:
        return np.zeros(0)
    a = a / np.maximum(a.sum(axis=-1, keepdims=True), 1e-9)
    cost = -np.log(np.maximum(a, 1e-9))
    n, m = cost.shape
    acc = np.full((n + 1, m + 1), np.inf)
    acc[0, 0] = 0.0
    for i in range(1, n + 1):
        # moves: diagonal (i-1,j-1), vertical (i-1,j), horizontal (i,j-1):
        # acc[i][j] = c[j] + min(p[j-1], p[j], f[j-1]) expands to
        # f[j] = S[j] + min_{k<=j}(q[k] - S[k-1]) with q[k] = min(p[k-1], p[k])
        # and S = cumsum(c): one cumsum and one running min per row
        c = cost[i - 1]
        prev = acc[i - 1]
        s = np.concatenate(([0.0], np.cumsum(c)))
        q = np.minimum(prev[:m], prev[1:])
        run = np.minimum.accumulate(q - s[:m])
        acc[i, 0] = np.inf
        acc[i, 1:] = s[1:] + run
    # backtrack from the full-path corner; diagonal wins ties, then vertical
    j = m
    i = n
    first_frame = np.full(n, j - 1)
    while i > 0 and j > 0:
        first_frame[i - 1] = j - 1
        move = int(np.argmin([acc[i - 1, j - 1], acc[i - 1, j], acc[i, j - 1]]))
        if move == 0:
            i -= 1
            j -= 1
        elif move == 1:
            i -= 1
        else:
            j -= 1
    frames_per_second = (m / 30.0) if audio_seconds <= 0 else m / max(audio_seconds, 1e-6)
    return first_frame / frames_per_second


def whisper_partition_rules(tp_axis: str = "tp"):
    """TP rules for whisper: the shared-block Megatron layout
    (``common.transformer_partition_rules``); the conv stem, positions and
    norms replicate. Requires heads % tp == 0."""
    from .common import transformer_partition_rules

    return transformer_partition_rules(tp_axis)
