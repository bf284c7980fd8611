"""SeamlessM4T-v2 direct speech-to-speech translation.

The port of the JAX package's ``models/seamless.py``: the reference's
alternate backend, ``facebook/seamless-m4t-v2-large`` direct S2ST with
``num_beams=5``. The module is weight-compatible with the HF checkpoint
(:func:`from_hf_state_dict` reads ``SeamlessM4Tv2ForSpeechToSpeech`` state
dicts; HF ``modeling_seamless_m4t_v2.py`` is the behavioural spec):

  speech encoder   conformer: fbank×2-stack (160) → feature projection →
                   N× [½ffn → rel-pos self-attn (chunked) → causal depthwise
                   conv → ½ffn → LN] → ½intermediate-ffn → conv adaptor
                   (k8/s8 GLU pooling + attention) → LN
  text decoder     M2M100 family: scaled tied embeddings, offset-2 sinusoids,
                   pre-LN blocks, greedy or beam decode over ``models/beam.py``
  t2u model        NAR text-to-unit: a transformer encoder over the text
                   decoder's states → char upsample → duration predictor →
                   hard upsample → post-LN FFT conv blocks → unit logits
  unit vocoder     code HiFi-GAN: unit embeddings → duration predictor →
                   hard upsample → [lang|units|spkr] channels → HiFi-GAN

The NAR upsamplings keep the JAX package's static horizons (``max_chars``,
``max_units``, ``max_frames``) with valid-length masks: :func:`hard_upsample`
is a ``searchsorted`` gather, not ``repeat_interleave``.

Layouts: activations [B, T, C] at the public functions (the vocoder runs
[B, C, T] inside); conv kernels as torch stores them, [out, in/groups, k],
the transposed convs [in, out, k] (torch's own padding, so no flip); dense
kernels [in, out]. :func:`from_jax_params` carries the JAX package's HIO tree
across. Every conv adds its bias after the product, as the JAX package does.

The JAX package runs this model outside any Pallas kernel (its fbank is
plain, and its HiFi-GAN resblocks are plain convolutions), and so does the
port: ``F.conv1d``, ``torch.matmul`` and softmax. The vocoder's stages with
C ≤ 128 compute ``fused_resblock_stage``'s function (leaky 0.1, kernels
3/7/11, dilations 1/3/5); they stay plain, as in JAX.
"""

from __future__ import annotations

import dataclasses
import functools
import math
from typing import Any, Dict, List, Optional, Tuple

import numpy as np
import torch
import torch.nn.functional as F

from ..core.device import resolve_device
from .beam import BeamConfig, beam_search, greedy_search
from .common import (AttnConfig, Init, Params, attention_kv, cast_floats, dense,
                     init_decoder_kv_cache, layer_norm, linear_from_state, mha, mha_step, mlp,
                     permute_conv_kernels, state_tensor, tree_from_numpy)
from .nllb import m2m100_sinusoids, position_ids_from_tokens

_relu_mlp = functools.partial(mlp, activation=torch.relu)
_swish_mlp = functools.partial(mlp, activation=F.silu)


@dataclasses.dataclass(frozen=True)
class SeamlessConfig:
    """Defaults mirror facebook/seamless-m4t-v2-large (HF SeamlessM4Tv2Config)."""

    hidden: int = 1024
    # --- speech encoder (wav2vec2-BERT-style conformer)
    feat_dim: int = 160                   # 80-mel fbank × 2-frame stack
    speech_layers: int = 24
    speech_heads: int = 16
    speech_ffn: int = 4096
    depthwise_kernel: int = 31
    left_max_pos: int = 64                # relative_key distance clamp
    right_max_pos: int = 8
    chunk_size: Optional[int] = 20_000    # speech_encoder_chunk_size
    left_chunk_num: int = 128
    adaptor_kernel: int = 8
    adaptor_stride: int = 8
    adapter_layers: int = 1
    # --- text decoder (M2M100 family)
    vocab_size: int = 256_102
    decoder_layers: int = 24
    decoder_heads: int = 16
    decoder_ffn: int = 8192
    max_positions: int = 4096
    pad_token: int = 0
    bos_token: int = 2
    eos_token: int = 3
    decoder_start_token: int = 3
    # --- t2u (NAR text-to-unit)
    t2u_vocab: int = 10_082
    t2u_encoder_layers: int = 6
    t2u_decoder_layers: int = 6
    t2u_ffn: int = 8192
    t2u_heads: int = 16
    char_vocab: int = 10_943
    t2u_pad: int = 1
    t2u_eos: int = 2
    var_embed_dim: int = 1024             # t2u_variance_predictor_embed_dim
    var_hidden_dim: int = 256             # t2u_variance_predictor_hidden_dim
    var_kernel: int = 3
    # --- unit vocoder (code HiFi-GAN)
    unit_vocab_vocoder: int = 10_000      # unit_hifi_gan_vocab_size
    unit_embed_dim: int = 1280
    lang_embed_dim: int = 256
    spkr_embed_dim: int = 256
    num_langs: int = 36
    num_spkrs: int = 200
    vocoder_offset: int = 4
    upsample_rates: Tuple[int, ...] = (5, 4, 4, 2, 2)
    upsample_kernels: Tuple[int, ...] = (11, 8, 8, 4, 4)
    upsample_initial_channel: int = 512
    resblock_kernels: Tuple[int, ...] = (3, 7, 11)
    resblock_dilations: Tuple[Tuple[int, ...], ...] = ((1, 3, 5),) * 3
    leaky_slope: float = 0.1
    sample_rate_out: int = 16_000

    @property
    def speech_attn(self) -> AttnConfig:
        return AttnConfig(self.hidden, self.speech_heads, k_bias=True)

    @property
    def text_attn(self) -> AttnConfig:
        return AttnConfig(self.hidden, self.decoder_heads, k_bias=True)

    @property
    def t2u_attn(self) -> AttnConfig:
        return AttnConfig(self.hidden, self.t2u_heads, k_bias=True)

    @property
    def head_dim(self) -> int:
        return self.hidden // self.speech_heads

    @property
    def hop_total(self) -> int:
        return int(np.prod(self.upsample_rates))

    @classmethod
    def v2_large(cls) -> "SeamlessConfig":
        return cls()

    @classmethod
    def toy(cls) -> "SeamlessConfig":
        """Small config for weightless serving and tests (same graph)."""
        return cls(
            hidden=64, speech_layers=2, speech_heads=4, speech_ffn=128,
            depthwise_kernel=7, chunk_size=None, adaptor_kernel=4,
            adaptor_stride=2, vocab_size=384, decoder_layers=2,
            decoder_heads=4, decoder_ffn=128, max_positions=512,
            t2u_vocab=48, t2u_encoder_layers=2, t2u_decoder_layers=2,
            t2u_ffn=128, t2u_heads=4, char_vocab=300,
            var_embed_dim=64, var_hidden_dim=32,
            unit_vocab_vocoder=40, unit_embed_dim=64, lang_embed_dim=16,
            spkr_embed_dim=16, num_langs=4, num_spkrs=3,
            upsample_rates=(4, 4), upsample_kernels=(8, 8),
            upsample_initial_channel=64, resblock_kernels=(3,),
            resblock_dilations=((1, 3),),
        )


# --------------------------------------------------------------------- convs


def _conv(p: Params, x: torch.Tensor, *, stride: int = 1, pad=0, dilation: int = 1,
          groups: int = 1) -> torch.Tensor:
    """Conv over [B, C, T]; kernel [out, in/groups, k]; ``pad`` an int (both
    sides) or "same" (dilation·(k − 1) split left-heavy on the right, as the
    JAX package splits it); the bias added after the product."""
    k = p["kernel"]
    if pad == "same":
        total = dilation * (k.shape[-1] - 1)
        left, right = total // 2, total - total // 2
    else:
        left = right = pad
    x = x.to(k.dtype)
    if left != right:
        x, left = F.pad(x, (left, right)), 0
    y = F.conv1d(x, k, None, stride=stride, padding=left, dilation=dilation, groups=groups)
    return y + p["bias"][:, None] if "bias" in p else y


def _conv1d(p: Params, x: torch.Tensor, **kw) -> torch.Tensor:
    """:func:`_conv` over [B, T, C] (the JAX package's NHC convention)."""
    return _conv(p, x.transpose(1, 2), **kw).transpose(1, 2)


def _conv_transpose(p: Params, x: torch.Tensor, stride: int) -> torch.Tensor:
    """torch ConvTranspose1d(stride, padding=(k − s)//2) over [B, C, T] →
    T·stride samples for even k − s. For odd k − s the JAX package's
    input-dilated conv ends one sample sooner, so that sample is dropped."""
    k = p["kernel"]
    width = k.shape[-1]
    y = F.conv_transpose1d(x.to(k.dtype), k, None, stride=stride, padding=(width - stride) // 2)
    if (width - stride) % 2:
        y = y[..., :-1]
    return y + p["bias"][:, None]


def _init_conv(r: Init, width: int, in_ch: int, out_ch: int, *, bias=True,
               groups: int = 1) -> Params:
    scale = 1.0 / np.sqrt((in_ch // groups) * width)
    p = {"kernel": r.uniform((out_ch, in_ch // groups, width), scale)}
    if bias:
        p["bias"] = r.zeros((out_ch,))
    return p


def _glu(h: torch.Tensor) -> torch.Tensor:
    a, b = h.chunk(2, dim=-1)
    return a * torch.sigmoid(b)


# ------------------------------------------------------------ mask utilities


def lengths_mask(lengths: torch.Tensor, max_len: int) -> torch.Tensor:
    """HF _compute_new_attention_mask: [B] lengths → bool [B, max_len]."""
    return torch.arange(max_len, device=lengths.device)[None, :] < lengths[:, None]


def _chunk_attend(t: int, chunk: int, left_num: int) -> np.ndarray:
    """Bool [t, t]: True where attention is allowed under v2 chunking."""
    idx = np.arange(t)
    ci = idx // chunk
    start = np.maximum(ci - left_num, 0) * chunk if left_num >= 0 else np.zeros_like(ci)
    end = np.minimum((ci + 1) * chunk, t)
    j = idx[None, :]
    return (j >= start[:, None]) & (j < end[:, None])


def adaptor_out_lengths(cfg: SeamlessConfig, lengths: torch.Tensor) -> torch.Tensor:
    """Per-layer conv subsampling of valid lengths (HF
    _compute_sub_sample_lengths_from_attention_mask, once per adapter layer)."""
    pad = cfg.adaptor_kernel // 2
    out = lengths
    for _ in range(cfg.adapter_layers):
        out = (out + 2 * pad - cfg.adaptor_kernel) // cfg.adaptor_stride + 1
    return out


def hard_upsample(h: torch.Tensor, counts: torch.Tensor, out_len: int) -> torch.Tensor:
    """torch ``repeat_interleave`` at a static output length: position j maps
    to the first segment whose cumulative count exceeds j; positions past
    sum(counts) hold the last row (callers mask by valid length)."""
    ends = torch.cumsum(counts.to(torch.int64), dim=1).contiguous()   # counts ≥ 0: ascending
    j = torch.arange(out_len, device=h.device).expand(h.shape[0], out_len).contiguous()
    idx = torch.searchsorted(ends, j, right=True).clamp_max(h.shape[1] - 1)
    return torch.take_along_dim(h, idx[..., None], dim=1)


def _durations(log_dur: torch.Tensor) -> torch.Tensor:
    """round(expm1(log-durations)) floored at 1, in the predictor's dtype."""
    return torch.clamp_min(torch.round(torch.expm1(log_dur)), 1.0).to(torch.int32)


# ------------------------------------------------------------- speech encoder


def _init_conformer_layer(r: Init, cfg: SeamlessConfig) -> Params:
    h = cfg.hidden
    n_pos = cfg.left_max_pos + cfg.right_max_pos + 1
    return {
        "ffn1_ln": r.layer_norm(h),
        "ffn1": r.mlp(h, cfg.speech_ffn),
        "attn_ln": r.layer_norm(h),
        "attn": r.attention(cfg.speech_attn),
        "dist_embed": r.normal((n_pos, cfg.head_dim), 0.02),
        "conv_ln": r.layer_norm(h),
        "pw1": _init_conv(r, 1, h, 2 * h, bias=False),
        "dw": _init_conv(r, cfg.depthwise_kernel, h, h, bias=False, groups=h),
        "dw_ln": r.layer_norm(h),
        "pw2": _init_conv(r, 1, h, h, bias=False),
        "ffn2_ln": r.layer_norm(h),
        "ffn2": r.mlp(h, cfg.speech_ffn),
        "final_ln": r.layer_norm(h),
    }


def _init_adapter_layer(r: Init, cfg: SeamlessConfig) -> Params:
    h = cfg.hidden
    return {
        "residual_ln": r.layer_norm(h),
        "residual_conv": _init_conv(r, cfg.adaptor_kernel, h, 2 * h),
        "attn_ln": r.layer_norm(h),
        "attn_conv": _init_conv(r, cfg.adaptor_kernel, h, 2 * h),
        "attn": r.attention(cfg.speech_attn),
        "ffn_ln": r.layer_norm(h),
        "ffn": r.mlp(h, cfg.speech_ffn),
    }


def _rel_pos_scores(q: torch.Tensor, dist_embed: torch.Tensor, left: int,
                    right: int) -> torch.Tensor:
    """The relative_key attention term: q [B, T, H, Dh] → [B, H, Tq, Tk]."""
    tq = q.shape[1]
    distance = np.clip(np.arange(tq)[None, :] - np.arange(tq)[:, None], -left, right) + left
    pos_emb = dist_embed[torch.as_tensor(distance, device=q.device)]     # [Tq, Tk, Dh]
    return torch.einsum("blhd,lrd->bhlr", q, pos_emb.to(q.dtype))


def _split(p: Params, a: AttnConfig, x: torch.Tensor):
    shape = (x.shape[0], x.shape[1], a.heads, a.head_dim)
    return (dense(p["q"], x).reshape(shape), dense(p["k"], x).reshape(shape),
            dense(p["v"], x).reshape(shape))


def _attend(scores: torch.Tensor, attend: Optional[torch.Tensor], v: torch.Tensor,
            dtype) -> torch.Tensor:
    """Masked scores (the dtype's minimum) → softmax in f32 → the weights in
    ``dtype`` over v → [B, T, H·Dh]."""
    if attend is not None:
        scores = torch.where(attend, scores, torch.finfo(scores.dtype).min)
    w = torch.softmax(scores.float(), dim=-1).to(dtype)
    out = torch.einsum("bhqk,bkhd->bqhd", w, v)
    return out.reshape(out.shape[0], out.shape[1], -1)


def _conformer_attention(p: Params, cfg: SeamlessConfig, x: torch.Tensor,
                         attend: Optional[torch.Tensor]) -> torch.Tensor:
    """Rel-pos self-attention; attend bool [B, 1, T, T] or None. HF scales
    the scores by 1/sqrt(dh) after the qk product and adds the rel-pos term
    at the same scale."""
    a = cfg.speech_attn
    q, k, v = _split(p["attn"], a, x)
    scale = 1.0 / math.sqrt(a.head_dim)
    scores = torch.einsum("bqhd,bkhd->bhqk", q, k) * scale
    scores = scores + _rel_pos_scores(q, p["dist_embed"], cfg.left_max_pos,
                                      cfg.right_max_pos) * scale
    return dense(p["attn"]["o"], _attend(scores, attend, v, x.dtype))


def _conformer_conv(p: Params, cfg: SeamlessConfig, x: torch.Tensor,
                    pad_mask: Optional[torch.Tensor]) -> torch.Tensor:
    """The causal depthwise conv module (left-padded by k − 1)."""
    h = layer_norm(p["conv_ln"], x)
    if pad_mask is not None:
        h = torch.where(pad_mask[..., None], h, torch.zeros((), dtype=h.dtype, device=h.device))
    h = _glu(_conv1d(p["pw1"], h))                             # [B, T, H], GLU over channels
    h = F.pad(h, (0, 0, cfg.depthwise_kernel - 1, 0))
    h = _conv1d(p["dw"], h, groups=cfg.hidden)
    h = layer_norm(p["dw_ln"], h)
    return _conv1d(p["pw2"], F.silu(h))


def encode_speech(params: Params, cfg: SeamlessConfig, feats: torch.Tensor,
                  feat_mask: Optional[torch.Tensor] = None) -> Tuple[torch.Tensor, torch.Tensor]:
    """feats [B, T, feat_dim] (and their valid mask, True = valid) → (the
    encoder states [B, T', H] after the adaptor, their valid mask [B, T'])."""
    enc = params["speech_encoder"]
    b, t, _ = feats.shape
    dev = feats.device
    x = dense(enc["fp"]["proj"], layer_norm(enc["fp"]["ln"], feats))
    zero = torch.zeros((), dtype=x.dtype, device=dev)

    attend = None
    if feat_mask is not None:
        x = torch.where(feat_mask[..., None], x, zero)
        attend = feat_mask[:, None, None, :].expand(b, 1, t, t)
    if cfg.chunk_size is not None:
        chunk = torch.as_tensor(_chunk_attend(t, cfg.chunk_size, cfg.left_chunk_num),
                                device=dev)[None, None]
        attend = chunk if attend is None else attend & chunk

    for layer in enc["layers"]:
        x = x + 0.5 * _swish_mlp(layer["ffn1"], layer_norm(layer["ffn1_ln"], x))
        x = x + _conformer_attention(layer, cfg, layer_norm(layer["attn_ln"], x), attend)
        x = x + _conformer_conv(layer, cfg, x, feat_mask)
        x = x + 0.5 * _swish_mlp(layer["ffn2"], layer_norm(layer["ffn2_ln"], x))
        x = layer_norm(layer["final_ln"], x)
    x = layer_norm(enc["ln"], x)

    # the intermediate ffn: relu, no pre-LN (SpeechEncoder.forward)
    x = x + 0.5 * _relu_mlp(enc["intermediate_ffn"], x)

    lengths = (feat_mask.to(torch.int32).sum(dim=1, dtype=torch.int32) if feat_mask is not None
               else torch.full((b,), t, dtype=torch.int32, device=dev))
    a = cfg.speech_attn
    for layer in enc["adapter"]:
        residual = layer_norm(layer["residual_ln"], x)
        residual = _glu(_conv1d(layer["residual_conv"], residual, stride=cfg.adaptor_stride,
                                pad=cfg.adaptor_stride // 2))
        h = layer_norm(layer["attn_ln"], x)
        h = _glu(_conv1d(layer["attn_conv"], h, stride=cfg.adaptor_stride,
                         pad=cfg.adaptor_stride // 2))

        pad = cfg.adaptor_kernel // 2
        lengths = (lengths + 2 * pad - cfg.adaptor_kernel) // cfg.adaptor_stride + 1
        attend_sub = lengths_mask(lengths, h.shape[1])[:, None, None, :]
        q, k, v = _split(layer["attn"], a, h)
        scores = torch.einsum("bqhd,bkhd->bhqk", q, k) / math.sqrt(a.head_dim)
        h = dense(layer["attn"]["o"], _attend(scores, attend_sub, v, h.dtype)) + residual

        x = h + _relu_mlp(layer["ffn"], layer_norm(layer["ffn_ln"], h))

    x = layer_norm(enc["inner_ln"], x)
    return x, lengths_mask(lengths, x.shape[1])


# --------------------------------------------------------------- text decoder


def _init_text_block(r: Init, cfg: SeamlessConfig) -> Params:
    return {
        "self_attn": r.attention(cfg.text_attn),
        "self_attn_ln": r.layer_norm(cfg.hidden),
        "cross_attn": r.attention(cfg.text_attn),
        "cross_attn_ln": r.layer_norm(cfg.hidden),
        "mlp": r.mlp(cfg.hidden, cfg.decoder_ffn),
        "mlp_ln": r.layer_norm(cfg.hidden),
    }


def text_decoder_hidden(params: Params, cfg: SeamlessConfig, tokens: torch.Tensor,
                        enc: torch.Tensor, enc_mask: torch.Tensor) -> torch.Tensor:
    """The teacher-forced decoder pass → last hidden states [B, T, H]
    (SeamlessM4Tv2Decoder: scaled embeddings + padding-aware sinusoids, pre-LN)."""
    dec = params["text_decoder"]
    scale = math.sqrt(cfg.hidden)
    t = tokens.shape[1]
    tokens = tokens.long()
    pos_ids = position_ids_from_tokens(tokens, cfg.pad_token)
    x = params["shared"][tokens] * scale + dec["pos"][pos_ids]
    causal = torch.tril(torch.ones((t, t), dtype=torch.bool, device=tokens.device))[None, None]
    enc_attend = enc_mask[:, None, None, :]
    for block in dec["layers"]:
        h = layer_norm(block["self_attn_ln"], x)
        x = x + mha(block["self_attn"], cfg.text_attn, h, h, mask=causal)
        h = layer_norm(block["cross_attn_ln"], x)
        x = x + mha(block["cross_attn"], cfg.text_attn, h, enc, mask=enc_attend)
        h = layer_norm(block["mlp_ln"], x)
        x = x + _relu_mlp(block["mlp"], h)
    return layer_norm(dec["ln"], x)


def text_decode_full(params: Params, cfg: SeamlessConfig, tokens: torch.Tensor,
                     enc: torch.Tensor, enc_mask: torch.Tensor) -> torch.Tensor:
    """Teacher-forced logits [B, T, vocab] (the head tied to the shared embedding)."""
    return text_decoder_hidden(params, cfg, tokens, enc, enc_mask) @ params["shared"].T


def generate_text(params: Params, cfg: SeamlessConfig, enc: torch.Tensor,
                  enc_mask: torch.Tensor, tgt_lang_token, *, num_beams: int = 5,
                  max_new_tokens: int = 256) -> torch.Tensor:
    """Greedy (``num_beams`` ≤ 1) or beam text decoding. The prompt is
    ``[decoder_start, tgt_lang]`` (HF prepends decoder_start_token_id to the
    forced language id). → [B, 2 + max_new_tokens] int32 ids, pad-filled
    after EOS."""
    b = enc.shape[0]
    dev = enc.device
    dec = params["text_decoder"]
    cross = [attention_kv(blk["cross_attn"], cfg.text_attn, enc) for blk in dec["layers"]]
    enc_attend = enc_mask[:, None, None, :]
    scale = math.sqrt(cfg.hidden)

    def step(token, pos, cache, beam_state):
        cross_kv, attend = beam_state
        pos_id = pos + 1 + cfg.pad_token
        x = (params["shared"][token.long()][:, None, :] * scale
             + dec["pos"][pos_id][None, None, :])
        for block, c, (ck, cv) in zip(dec["layers"], cache, cross_kv):
            h = layer_norm(block["self_attn_ln"], x)
            x = x + mha_step(block["self_attn"], cfg.text_attn, h, c, pos)
            h = layer_norm(block["cross_attn_ln"], x)
            x = x + mha(block["cross_attn"], cfg.text_attn, h, None,
                        precomputed_kv=(ck, cv), mask=attend)
            h = layer_norm(block["mlp_ln"], x)
            x = x + _relu_mlp(block["mlp"], h)
        x = layer_norm(dec["ln"], x)
        return x[:, 0, :] @ params["shared"].T

    prompt = torch.tensor([[cfg.decoder_start_token, int(tgt_lang_token)]] * b,
                          dtype=torch.int32, device=dev)
    max_len = 2 + max_new_tokens
    bc = BeamConfig(eos_token=cfg.eos_token, pad_token=cfg.pad_token, max_len=max_len,
                    num_beams=num_beams)
    rows = b * num_beams if num_beams > 1 else b
    cache = init_decoder_kv_cache(cfg.decoder_layers, rows, max_len, cfg.decoder_heads,
                                  cfg.hidden // cfg.decoder_heads, enc.dtype, dev)
    search = beam_search if num_beams > 1 else greedy_search
    return search(step, prompt, cache, (cross, enc_attend), bc)


# ------------------------------------------------------------------ t2u model


def _init_t2u_enc_block(r: Init, cfg: SeamlessConfig) -> Params:
    return {
        "self_attn": r.attention(cfg.t2u_attn),
        "self_attn_ln": r.layer_norm(cfg.hidden),
        "mlp": r.mlp(cfg.hidden, cfg.t2u_ffn),
        "mlp_ln": r.layer_norm(cfg.hidden),
    }


def _init_t2u_dec_layer(r: Init, cfg: SeamlessConfig) -> Params:
    return {
        "attn": r.attention(cfg.t2u_attn),
        "attn_ln": r.layer_norm(cfg.hidden),
        "conv1": _init_conv(r, 7, cfg.hidden, cfg.hidden),
        "conv2": _init_conv(r, 7, cfg.hidden, cfg.hidden),
        "conv_ln": r.layer_norm(cfg.hidden),
    }


def _init_variance_predictor(r: Init, embed: int, hidden: int, kernel: int) -> Params:
    return {
        "conv1": _init_conv(r, kernel, embed, hidden),
        "ln1": r.layer_norm(hidden),
        "conv2": _init_conv(r, kernel, hidden, hidden),
        "ln2": r.layer_norm(hidden),
        "proj": r.dense(hidden, 1),
    }


def _masked(x: torch.Tensor, mask: Optional[torch.Tensor]) -> torch.Tensor:
    if mask is None:
        return x
    return torch.where(mask[..., None], x, torch.zeros((), dtype=x.dtype, device=x.device))


def _variance_predictor(p: Params, x: torch.Tensor,
                        pad_mask: Optional[torch.Tensor]) -> torch.Tensor:
    """[B, T, C] → log-durations [B, T] (SeamlessM4Tv2VariancePredictor)."""
    x = _masked(x, pad_mask)
    x = layer_norm(p["ln1"], torch.relu(_conv1d(p["conv1"], x, pad="same")))
    x = _masked(x, pad_mask)
    x = layer_norm(p["ln2"], torch.relu(_conv1d(p["conv2"], x, pad="same")))
    return dense(p["proj"], x)[..., 0]


def t2u_encode(params: Params, cfg: SeamlessConfig, embeds: torch.Tensor,
               mask: Optional[torch.Tensor]) -> torch.Tensor:
    """The t2u encoder over the text decoder's states (no embeddings or
    positions: SeamlessM4Tv2Encoder with is_t2u_encoder=True)."""
    enc = params["t2u"]["encoder"]
    attend = None if mask is None else mask[:, None, None, :]
    x = embeds
    for block in enc["layers"]:
        h = layer_norm(block["self_attn_ln"], x)
        x = x + mha(block["self_attn"], cfg.t2u_attn, h, h, mask=attend)
        h = layer_norm(block["mlp_ln"], x)
        x = x + _relu_mlp(block["mlp"], h)
    return layer_norm(enc["ln"], x)


def t2u_nar_decode(params: Params, cfg: SeamlessConfig, enc_hidden: torch.Tensor,
                   char_ids: torch.Tensor, char_counts: torch.Tensor, *,
                   max_units: int) -> Dict[str, torch.Tensor]:
    """NAR unit decoding (SeamlessM4Tv2TextToUnitDecoder.forward):
    enc_hidden [B, T_text, H], char_ids [B, C], char_counts [B, T_text] →
    unit logits [B, max_units, t2u_vocab], the units' valid mask, the
    per-char durations and the unit lengths."""
    dec = params["t2u"]["decoder"]
    dev = enc_hidden.device
    scale = math.sqrt(cfg.hidden)
    n_chars = char_ids.shape[1]
    char_mask = lengths_mask(char_counts.sum(dim=1), n_chars)

    char_hidden = hard_upsample(enc_hidden, char_counts, n_chars)
    # sequential position ids from padding_idx + 1 (the inputs_embeds path)
    pos_ids = torch.arange(cfg.t2u_pad + 1, n_chars + cfg.t2u_pad + 1, device=dev)
    char_pos = dec["pos_alpha_char"] * dec["pos"][pos_ids][None]
    char_hidden = dec["embed_char"][char_ids.long()] * scale + char_pos + char_hidden

    dur = _durations(_variance_predictor(dec["dur"], char_hidden, char_mask))
    dur = torch.where(char_mask, dur, torch.zeros_like(dur))

    x = hard_upsample(char_hidden, dur, max_units)
    upos = torch.arange(cfg.t2u_pad + 1, max_units + cfg.t2u_pad + 1, device=dev)
    x = x + dec["pos_alpha"] * dec["pos"][upos][None]

    unit_lengths = dur.sum(dim=1, dtype=torch.int32)
    pad_mask = lengths_mask(unit_lengths, max_units)
    attend = pad_mask[:, None, None, :]
    for layer in dec["layers"]:
        # the post-LN FFT block (TextToUnitDecoderLayer.forward)
        x = layer_norm(layer["attn_ln"], x + mha(layer["attn"], cfg.t2u_attn, x, x, mask=attend))
        residual = x
        h = _conv1d(layer["conv1"], _masked(x, pad_mask), pad="same")
        h = _conv1d(layer["conv2"], torch.relu(_masked(h, pad_mask)), pad="same")
        x = layer_norm(layer["conv_ln"], residual + h)
    x = layer_norm(dec["ln"], x)
    logits = x @ dec["embed"].T                       # lm_head tied to embed_tokens
    return {"logits": logits, "padding_mask": pad_mask, "durations": dur,
            "unit_lengths": unit_lengths}


def units_from_logits(cfg: SeamlessConfig, logits: torch.Tensor,
                      pad_mask: torch.Tensor) -> torch.Tensor:
    """argmax units → vocoder ids: EOS and padding → t2u_pad, then the
    control-symbol offset subtracted from real units (ForSpeechToSpeech.
    generate); units below the offset are clamped at 0, so random-weight
    runs stay valid where torch's reference would index out of range."""
    unit_ids = torch.argmax(logits, dim=-1)
    replace = (unit_ids == cfg.t2u_eos) | ~pad_mask
    unit_ids = torch.where(replace, torch.full_like(unit_ids, cfg.t2u_pad), unit_ids)
    return torch.where(unit_ids == cfg.t2u_pad, unit_ids,
                       torch.clamp_min(unit_ids - cfg.vocoder_offset, 0)).to(torch.int32)


# --------------------------------------------------------------- unit vocoder


def _init_hifigan(r: Init, cfg: SeamlessConfig) -> Params:
    in_dim = cfg.unit_embed_dim + cfg.lang_embed_dim + cfg.spkr_embed_dim
    ch = cfg.upsample_initial_channel
    p: Params = {"conv_pre": _init_conv(r, 7, in_dim, ch), "ups": [], "res": []}
    for i, kw in enumerate(cfg.upsample_kernels):
        in_ch, out_ch = ch // (2 ** i), ch // (2 ** (i + 1))
        scale = 1.0 / np.sqrt(in_ch * kw)
        p["ups"].append({"kernel": r.uniform((in_ch, out_ch, kw), scale),
                         "bias": r.zeros((out_ch,))})
        p["res"].append([[{"c1": _init_conv(r, k, out_ch, out_ch),
                           "c2": _init_conv(r, k, out_ch, out_ch)} for _ in dils]
                         for k, dils in zip(cfg.resblock_kernels, cfg.resblock_dilations)])
    p["conv_post"] = _init_conv(r, 7, ch // (2 ** len(cfg.upsample_rates)), 1)
    return p


def _hifigan(params: Params, cfg: SeamlessConfig, x: torch.Tensor) -> torch.Tensor:
    """[B, T, in_dim] → waveform [B, T × hop]. The inner leaky slope is the
    config's (0.1); the last one, before conv_post, torch's default 0.01
    (SeamlessM4Tv2HifiGan.forward)."""
    x = _conv(params["conv_pre"], x.transpose(1, 2), pad=3)
    for up, stage, rate in zip(params["ups"], params["res"], cfg.upsample_rates):
        x = _conv_transpose(up, F.leaky_relu(x, cfg.leaky_slope), rate)
        acc = None
        for block, dils in zip(stage, cfg.resblock_dilations):
            h = x
            for unit, d in zip(block, dils):
                y = _conv(unit["c1"], F.leaky_relu(h, cfg.leaky_slope), pad="same", dilation=d)
                y = _conv(unit["c2"], F.leaky_relu(y, cfg.leaky_slope), pad="same")
                h = h + y
            acc = h if acc is None else acc + h
        x = acc / len(stage)
    x = torch.tanh(_conv(params["conv_post"], F.leaky_relu(x, 0.01), pad=3))
    return x[:, 0]


def vocoder_output_length(cfg: SeamlessConfig, n):
    """The HiFi-GAN conv stack's length map (HF _get_output_hifigan_lengths):
    with the standard odd-kernel geometry every stage but the upsamplers
    keeps the length, so this is n × prod(rates); kept as the explicit
    per-stage recurrence to match HF on unusual configs."""
    def conv_out(length, k, s, p, d=1):
        return (length + 2 * p - d * (k - 1) - 1) // s + 1

    n = conv_out(n, 7, 1, 3)
    for r, k in zip(cfg.upsample_rates, cfg.upsample_kernels):
        n = (n - 1) * r - 2 * ((k - r) // 2) + (k - 1) + 1
    for _ in cfg.upsample_rates:
        for k, dils in zip(cfg.resblock_kernels, cfg.resblock_dilations):
            for d in dils:
                n = conv_out(n, k, 1, (k - 1) * d // 2, d)
            for _ in dils:
                n = conv_out(n, k, 1, (k - 1) // 2, 1)
    return conv_out(n, 7, 1, 3)


def code_hifigan(params: Params, cfg: SeamlessConfig, unit_ids: torch.Tensor, spkr_id,
                 lang_id, *, max_frames: int) -> Tuple[torch.Tensor, torch.Tensor]:
    """SeamlessM4Tv2CodeHifiGan.forward: unit ids [B, T] (pad = t2u_pad) →
    duration-upsampled unit embeddings with the speaker and language
    channels → (waveform [B, max_frames × hop], lengths [B])."""
    voc = params["vocoder"]
    b, t = unit_ids.shape
    dev = unit_ids.device
    # the t2u head has more rows past the offset than the vocoder's table
    # (10,078 against 10,000 at the published widths): JAX's gather clamps
    # such an id to the last row, where torch's indexing would raise
    table = voc["unit_embed"]
    ue = table[unit_ids.long().clamp(0, table.shape[0] - 1)]    # [B, T, unit_dim]
    dur = _durations(_variance_predictor(voc["dur"], ue, None))
    x = hard_upsample(ue, dur, max_frames)

    spkr = voc["spkr_embed"][torch.as_tensor(spkr_id, device=dev).long().expand(b)]
    lang = voc["lang_embed"][torch.as_tensor(lang_id, device=dev).long().expand(b)]
    x = torch.cat([lang[:, None, :].expand(b, max_frames, -1), x,
                   spkr[:, None, :].expand(b, max_frames, -1)], dim=-1)
    wave = _hifigan(voc["hifi"], cfg, x)

    # HF's length contract: cumsum(dur) gathered at the (clamped) non-pad
    # unit count, so it counts one pad slot's duration (_get_dur_output_lengths)
    unit_len = (unit_ids != cfg.t2u_pad).sum(dim=1).clamp(0, t - 1)
    frame_len = torch.take_along_dim(torch.cumsum(dur, dim=1), unit_len[:, None], dim=1)[:, 0]
    return wave, vocoder_output_length(cfg, frame_len)


# ---------------------------------------------------------------- host: chars


def char_inputs_for_t2u(
    t2u_input_ids: np.ndarray,
    id_to_text: Dict[str, str],
    char_to_id: Dict[str, int],
    *,
    pad_token_id: int = 0,
    unk_token_id: int = 1,
    max_chars: Optional[int] = None,
) -> Tuple[np.ndarray, np.ndarray]:
    """Host-side char preparation, the HF generate glue
    (_indices_to_subwords → _count_character_length_in_subword
    (merge_space_with_prev_subword=False) → zero-pad both ends →
    _get_char_input_ids). → (char_ids [B, C], char_counts [B, T + 2])."""
    ids = np.asarray(t2u_input_ids)
    batch, seq = ids.shape
    space = "▁"

    subwords_batch: List[List[str]] = [
        [str(id_to_text.get(str(int(ids[b, i])))) for i in range(seq)]
        for b in range(batch)
    ]
    counts = np.zeros_like(ids)
    for b in range(batch):
        n = int((ids[b] != pad_token_id).sum())
        subs = subwords_batch[b][:n]
        next_space = [len(subs[i + 1]) > 1 and subs[i + 1][0] == space
                      if i < len(subs) - 1 else False for i in range(len(subs))]
        is_punc = [len(s) == 1 and not s.isalpha() and not s.isnumeric() and s != space
                   for s in subs]
        for i in range(n):
            if ids[b, i] == pad_token_id:
                break
            if ids[b, i] == unk_token_id:
                clen = 1
            else:
                clen = len(subs[i])
                if is_punc[i] and next_space[i]:
                    clen += 1
                elif i > 0 and is_punc[i - 1] and next_space[i - 1]:
                    clen -= 1
            counts[b, i] = clen

    total = counts.sum(1)
    c = int(total.max()) if max_chars is None else max_chars
    if max_chars is not None:
        # counts follow the char-id truncation below: a row whose subword
        # chars overflow max_chars reports no counts for dropped ids, or the
        # duration predictor and hard_upsample would align units to padding
        for b in range(batch):
            cum = 0
            for i in range(seq):
                take = min(int(counts[b, i]), max(0, c - cum))
                counts[b, i] = take
                cum += take
    char_ids = np.full((batch, c), pad_token_id, np.int32)
    for b in range(batch):
        n = int((ids[b] != pad_token_id).sum())
        pos = 0
        for i in range(n):
            if ids[b, i] == unk_token_id:
                cid = [unk_token_id]
            else:
                cid = [char_to_id.get(ch, unk_token_id) for ch in subwords_batch[b][i]]
            take = cid[: max(0, c - pos)]
            if take:
                char_ids[b, pos:pos + len(take)] = np.asarray(take, np.int32)
            pos += len(cid)
    zero = np.zeros((batch, 1), counts.dtype)
    char_counts = np.concatenate([zero, counts, zero], axis=1)
    return char_ids, char_counts


def byte_char_maps(vocab_size: int) -> Tuple[Dict[str, str], Dict[str, int]]:
    """The weightless fallback maps: token id → a 2-char pseudo-subword over
    'a'-'p' (hex nibbles), so the whole S2ST graph runs without the real
    tokenizer's generation-config maps."""
    alphabet = "abcdefghijklmnop"
    id_to_text = {str(i): alphabet[(i >> 4) & 15] + alphabet[i & 15]
                  for i in range(vocab_size)}
    char_to_id = {ch: 2 + i for i, ch in enumerate(alphabet)}
    return id_to_text, char_to_id


def t2u_char_inputs(cfg: SeamlessConfig, sequences: torch.Tensor, id_to_text, char_to_id,
                    max_chars: int) -> Tuple[np.ndarray, np.ndarray]:
    """The generated sequences [B, 2 + n] → the t2u's char inputs: the
    start and language tokens and the last column dropped, EOS → pad."""
    t2u_ids = sequences.cpu().numpy()[:, 2:-1].copy()
    t2u_ids[t2u_ids == cfg.eos_token] = cfg.pad_token
    return char_inputs_for_t2u(t2u_ids, id_to_text, char_to_id, pad_token_id=cfg.pad_token,
                               max_chars=max_chars)


def speech_from_text(params: Params, cfg: SeamlessConfig, sequences: torch.Tensor,
                     enc: torch.Tensor, enc_mask: torch.Tensor, char_ids, char_counts,
                     voc_lang, *, spkr_id: int = 0,
                     max_units: int) -> Tuple[torch.Tensor, torch.Tensor, Dict[str, Any]]:
    """The text decoder's states over the sequences (the last column
    dropped) → t2u encoder → NAR units → code HiFi-GAN at 2 × max_units
    frames. → (waveform, lengths, the NAR outputs with the vocoder's unit ids
    under "units")."""
    dev = enc.device
    dec_in = sequences[:, :-1]
    hidden = text_decoder_hidden(params, cfg, dec_in, enc, enc_mask)
    seq_lens = (dec_in != cfg.pad_token).sum(dim=1)
    t2u_enc = t2u_encode(params, cfg, hidden, lengths_mask(seq_lens, dec_in.shape[1]))
    nar = t2u_nar_decode(params, cfg, t2u_enc, torch.as_tensor(char_ids, device=dev),
                         torch.as_tensor(char_counts, device=dev), max_units=max_units)
    nar["units"] = units_from_logits(cfg, nar["logits"], nar["padding_mask"])
    wave, lengths = code_hifigan(params, cfg, nar["units"], spkr_id, voc_lang,
                                 max_frames=max_units * 2)
    return wave, lengths, nar


# ----------------------------------------------------------------- end-to-end


def translate_s2st(
    params: Params,
    cfg: SeamlessConfig,
    feats: torch.Tensor,
    feat_mask: Optional[torch.Tensor] = None,
    *,
    tgt_lang_token: int = 0,
    vocoder_lang_id: int = 0,
    spkr_id: int = 0,
    num_beams: int = 5,
    max_text_tokens: int = 64,
    max_chars: int = 256,
    max_units: int = 512,
    id_to_text: Optional[Dict[str, str]] = None,
    char_to_id: Optional[Dict[str, int]] = None,
) -> Dict[str, Any]:
    """Direct S2ST (ForSpeechToSpeech.generate's shape): speech → text beam
    decode → host char alignment → NAR t2u → code HiFi-GAN. The host syncs
    once, at the text ids → chars step."""
    if id_to_text is None or char_to_id is None:
        id_to_text, char_to_id = byte_char_maps(cfg.vocab_size)

    enc, enc_mask = encode_speech(params, cfg, feats, feat_mask)
    sequences = generate_text(params, cfg, enc, enc_mask, tgt_lang_token,
                              num_beams=num_beams, max_new_tokens=max_text_tokens)
    char_ids, char_counts = t2u_char_inputs(cfg, sequences, id_to_text, char_to_id, max_chars)
    wave, lengths, nar = speech_from_text(params, cfg, sequences, enc, enc_mask, char_ids,
                                          char_counts, vocoder_lang_id, spkr_id=spkr_id,
                                          max_units=max_units)
    return {"audio": wave, "waveform_lengths": lengths, "text_tokens": sequences,
            "units": nar["units"], "n_units": nar["unit_lengths"]}


# ------------------------------------------------------------------------ init


def init_seamless(seed: int, cfg: SeamlessConfig = SeamlessConfig(), device=None) -> Params:
    """Seeded random parameters (f32) on ``device`` (the card unless
    ``device="cpu"``): the JAX package's tree structure at the port's
    layouts, torch's numbers."""
    r = Init(seed, resolve_device(device))
    pos_table = torch.as_tensor(m2m100_sinusoids(cfg.max_positions, cfg.hidden, cfg.pad_token),
                                device=r.device)
    t2u_pos = torch.as_tensor(m2m100_sinusoids(cfg.max_positions, cfg.hidden, cfg.t2u_pad),
                              device=r.device)
    return {
        "speech_encoder": {
            "fp": {"ln": r.layer_norm(cfg.feat_dim), "proj": r.dense(cfg.feat_dim, cfg.hidden)},
            "layers": [_init_conformer_layer(r, cfg) for _ in range(cfg.speech_layers)],
            "ln": r.layer_norm(cfg.hidden),
            "intermediate_ffn": r.mlp(cfg.hidden, cfg.speech_ffn),
            "adapter": [_init_adapter_layer(r, cfg) for _ in range(cfg.adapter_layers)],
            "inner_ln": r.layer_norm(cfg.hidden),
        },
        "shared": r.normal((cfg.vocab_size, cfg.hidden), 0.02),
        "text_decoder": {
            "pos": pos_table,
            "layers": [_init_text_block(r, cfg) for _ in range(cfg.decoder_layers)],
            "ln": r.layer_norm(cfg.hidden),
        },
        "t2u": {
            "encoder": {
                "layers": [_init_t2u_enc_block(r, cfg) for _ in range(cfg.t2u_encoder_layers)],
                "ln": r.layer_norm(cfg.hidden),
            },
            "decoder": {
                "embed": r.normal((cfg.t2u_vocab, cfg.hidden), 0.02),
                "embed_char": r.normal((cfg.char_vocab, cfg.hidden), 0.02),
                "pos": t2u_pos,
                "pos_alpha": r.ones((1,)),
                "pos_alpha_char": r.ones((1,)),
                "dur": _init_variance_predictor(r, cfg.var_embed_dim, cfg.var_hidden_dim,
                                                cfg.var_kernel),
                "layers": [_init_t2u_dec_layer(r, cfg) for _ in range(cfg.t2u_decoder_layers)],
                "ln": r.layer_norm(cfg.hidden),
            },
        },
        "vocoder": {
            "dur": _init_variance_predictor(r, cfg.unit_embed_dim, cfg.unit_embed_dim,
                                            cfg.var_kernel),
            "unit_embed": r.normal((cfg.unit_vocab_vocoder, cfg.unit_embed_dim), 0.02),
            "spkr_embed": r.normal((cfg.num_spkrs, cfg.spkr_embed_dim), 0.02),
            "lang_embed": r.normal((cfg.num_langs, cfg.lang_embed_dim), 0.02),
            "hifi": _init_hifigan(r, cfg),
        },
    }


# ------------------------------------------------------------------ converters


def from_jax_params(tree, device, dtype=torch.float32) -> Params:
    """The JAX package's Seamless tree → the port's: conv kernels HIO
    [k, in/groups, out] → [out, in/groups, k]; the vocoder's transposed-conv
    kernels, stored unflipped as [k, in, out], → torch's [in, out, k]; dense
    kernels as they are."""
    p = tree_from_numpy(tree, device, dtype)
    hifi = p["vocoder"]["hifi"]
    ups = hifi.pop("ups")
    permute_conv_kernels(p, (2, 1, 0))
    hifi["ups"] = [{"kernel": u["kernel"].permute(1, 2, 0).contiguous(), "bias": u["bias"]}
                   for u in ups]
    return p


def from_hf_state_dict(state: Dict[str, Any], cfg: SeamlessConfig, device=None,
                       dtype=torch.float32) -> Params:
    """A ``SeamlessM4Tv2ForSpeechToSpeech`` state dict (any float dtype) →
    the port's tree on ``device``, floating leaves in ``dtype``. Conv
    weights keep torch's layouts; the sinusoid tables, which the checkpoint
    does not hold, come from :func:`~.nllb.m2m100_sinusoids`."""
    dev = resolve_device(device)

    def t(name):
        return state_tensor(state[name], dev)

    def ln(name) -> Params:
        return {"scale": t(f"{name}.weight"), "bias": t(f"{name}.bias")}

    def linear(name) -> Params:
        return linear_from_state(state[f"{name}.weight"], state[f"{name}.bias"], dev)

    def conv(name, *, bias=True) -> Params:
        p = {"kernel": t(f"{name}.weight")}
        if bias:
            p["bias"] = t(f"{name}.bias")
        return p

    def ffn(name) -> Params:          # SeamlessM4Tv2ConformerFeedForward
        return {"fc1": linear(f"{name}.intermediate_dense"), "fc2": linear(f"{name}.output_dense")}

    def conformer_attn(name) -> Params:
        return {ours: linear(f"{name}.linear_{hf}")
                for ours, hf in (("q", "q"), ("k", "k"), ("v", "v"), ("o", "out"))}

    def bart_attn(name) -> Params:
        return {ours: linear(f"{name}.{hf}_proj")
                for ours, hf in (("q", "q"), ("k", "k"), ("v", "v"), ("o", "out"))}

    def vp(name) -> Params:
        return {"conv1": conv(f"{name}.conv1"), "ln1": ln(f"{name}.ln1"),
                "conv2": conv(f"{name}.conv2"), "ln2": ln(f"{name}.ln2"),
                "proj": linear(f"{name}.proj")}

    def conformer_layer(base: str) -> Params:
        return {
            "ffn1_ln": ln(f"{base}.ffn1_layer_norm"),
            "ffn1": ffn(f"{base}.ffn1"),
            "attn_ln": ln(f"{base}.self_attn_layer_norm"),
            "attn": conformer_attn(f"{base}.self_attn"),
            "dist_embed": t(f"{base}.self_attn.distance_embedding.weight"),
            "conv_ln": ln(f"{base}.conv_module.layer_norm"),
            "pw1": conv(f"{base}.conv_module.pointwise_conv1", bias=False),
            "dw": conv(f"{base}.conv_module.depthwise_conv", bias=False),
            "dw_ln": ln(f"{base}.conv_module.depthwise_layer_norm"),
            "pw2": conv(f"{base}.conv_module.pointwise_conv2", bias=False),
            "ffn2_ln": ln(f"{base}.ffn2_layer_norm"),
            "ffn2": ffn(f"{base}.ffn2"),
            "final_ln": ln(f"{base}.final_layer_norm"),
        }

    def adapter_layer(base: str) -> Params:
        return {
            "residual_ln": ln(f"{base}.residual_layer_norm"),
            "residual_conv": conv(f"{base}.residual_conv"),
            "attn_ln": ln(f"{base}.self_attn_layer_norm"),
            "attn_conv": conv(f"{base}.self_attn_conv"),
            "attn": conformer_attn(f"{base}.self_attn"),
            "ffn_ln": ln(f"{base}.ffn_layer_norm"),
            "ffn": ffn(f"{base}.ffn"),
        }

    def mlp_of(base: str) -> Params:
        return {"fc1": linear(f"{base}.ffn.fc1"), "fc2": linear(f"{base}.ffn.fc2")}

    def text_block(base: str) -> Params:
        return {"self_attn": bart_attn(f"{base}.self_attn"),
                "self_attn_ln": ln(f"{base}.self_attn_layer_norm"),
                "cross_attn": bart_attn(f"{base}.cross_attention"),
                "cross_attn_ln": ln(f"{base}.cross_attention_layer_norm"),
                "mlp": mlp_of(base), "mlp_ln": ln(f"{base}.ffn_layer_norm")}

    def t2u_enc_block(base: str) -> Params:
        return {"self_attn": bart_attn(f"{base}.self_attn"),
                "self_attn_ln": ln(f"{base}.self_attn_layer_norm"),
                "mlp": mlp_of(base), "mlp_ln": ln(f"{base}.ffn_layer_norm")}

    def t2u_dec_layer(base: str) -> Params:
        return {"attn": bart_attn(f"{base}.self_attn"),
                "attn_ln": ln(f"{base}.self_attn_layer_norm"),
                "conv1": conv(f"{base}.conv1"), "conv2": conv(f"{base}.conv2"),
                "conv_ln": ln(f"{base}.conv_layer_norm")}

    se, t2u, hifi = "speech_encoder", "t2u_model.model", "vocoder.hifi_gan"
    n_k = len(cfg.resblock_kernels)
    params = {
        "speech_encoder": {
            "fp": {"ln": ln(f"{se}.feature_projection.layer_norm"),
                   "proj": linear(f"{se}.feature_projection.projection")},
            "layers": [conformer_layer(f"{se}.encoder.layers.{i}")
                       for i in range(cfg.speech_layers)],
            "ln": ln(f"{se}.encoder.layer_norm"),
            "intermediate_ffn": ffn(f"{se}.intermediate_ffn"),
            "adapter": [adapter_layer(f"{se}.adapter.layers.{i}")
                        for i in range(cfg.adapter_layers)],
            "inner_ln": ln(f"{se}.inner_layer_norm"),
        },
        "shared": t("shared.weight"),
        "text_decoder": {
            "pos": torch.as_tensor(m2m100_sinusoids(cfg.max_positions, cfg.hidden,
                                                    cfg.pad_token), device=dev),
            "layers": [text_block(f"text_decoder.layers.{i}") for i in range(cfg.decoder_layers)],
            "ln": ln("text_decoder.layer_norm"),
        },
        "t2u": {
            "encoder": {
                "layers": [t2u_enc_block(f"{t2u}.encoder.layers.{i}")
                           for i in range(cfg.t2u_encoder_layers)],
                "ln": ln(f"{t2u}.encoder.layer_norm"),
            },
            "decoder": {
                "embed": t(f"{t2u}.decoder.embed_tokens.weight"),
                "embed_char": t(f"{t2u}.decoder.embed_char.weight"),
                "pos": torch.as_tensor(m2m100_sinusoids(cfg.max_positions, cfg.hidden,
                                                        cfg.t2u_pad), device=dev),
                "pos_alpha": t(f"{t2u}.decoder.pos_emb_alpha"),
                "pos_alpha_char": t(f"{t2u}.decoder.pos_emb_alpha_char"),
                "dur": vp(f"{t2u}.decoder.duration_predictor"),
                "layers": [t2u_dec_layer(f"{t2u}.decoder.layers.{i}")
                           for i in range(cfg.t2u_decoder_layers)],
                "ln": ln(f"{t2u}.decoder.layer_norm"),
            },
        },
        "vocoder": {
            "dur": vp("vocoder.dur_predictor"),
            "unit_embed": t("vocoder.unit_embedding.weight"),
            "spkr_embed": t("vocoder.speaker_embedding.weight"),
            "lang_embed": t("vocoder.language_embedding.weight"),
            "hifi": {
                "conv_pre": conv(f"{hifi}.conv_pre"),
                "ups": [conv(f"{hifi}.upsampler.{i}") for i in range(len(cfg.upsample_rates))],
                "res": [[[{"c1": conv(f"{hifi}.resblocks.{i * n_k + j}.convs1.{d}"),
                           "c2": conv(f"{hifi}.resblocks.{i * n_k + j}.convs2.{d}")}
                          for d in range(len(cfg.resblock_dilations[j]))]
                         for j in range(n_k)]
                        for i in range(len(cfg.upsample_rates))],
                "conv_post": conv(f"{hifi}.conv_post"),
            },
        },
    }
    return cast_floats(params, dtype)
