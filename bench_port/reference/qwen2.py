"""The Qwen2 backbone in plain PyTorch: a frozen copy of the port's
``models/qwen2.py`` (config, seeded init, the full-sequence forward and the
cached steps); the speech LM's reference."""

from __future__ import annotations

import dataclasses
import functools
from typing import Optional, Tuple

import numpy as np
import torch

from .common import Init, Params, dense


@dataclasses.dataclass(frozen=True)
class Qwen2Config:
    hidden: int = 896
    layers: int = 24
    heads: int = 14
    kv_heads: int = 2
    ffn_dim: int = 4864
    rope_theta: float = 1_000_000.0
    norm_eps: float = 1e-6
    max_positions: int = 4096

    @property
    def head_dim(self) -> int:
        return self.hidden // self.heads

    @classmethod
    def qwen2_05b(cls):
        return cls()


@functools.lru_cache(maxsize=8)
def rope_table(cfg: Qwen2Config) -> Tuple[np.ndarray, np.ndarray]:
    """cos/sin [max_positions, head_dim] (HF layout: halves repeated)."""
    inv_freq = 1.0 / (cfg.rope_theta ** (np.arange(0, cfg.head_dim, 2) / cfg.head_dim))
    t = np.arange(cfg.max_positions)
    freqs = np.outer(t, inv_freq)
    emb = np.concatenate([freqs, freqs], axis=-1)
    return np.cos(emb).astype(np.float32), np.sin(emb).astype(np.float32)


@functools.lru_cache(maxsize=8)
def _rope_tensors(cfg: Qwen2Config, device: torch.device):
    return tuple(torch.as_tensor(a, device=device) for a in rope_table(cfg))


def rotate_half(x: torch.Tensor) -> torch.Tensor:
    half = x.shape[-1] // 2
    return torch.cat([-x[..., half:], x[..., :half]], dim=-1)


def apply_rope(x: torch.Tensor, cos: torch.Tensor, sin: torch.Tensor) -> torch.Tensor:
    """x [B, T, H, Dh]; cos/sin [T, Dh] (shared) or [B, T, Dh] (per row)."""
    if cos.ndim == 2:
        cos, sin = cos[None, :, None, :], sin[None, :, None, :]
    else:
        cos, sin = cos[:, :, None, :], sin[:, :, None, :]
    return x * cos + rotate_half(x) * sin


def init_qwen2(r: Init, cfg: Qwen2Config) -> Params:
    h, hd = cfg.hidden, cfg.head_dim
    return {
        "layers": [{
            "input_ln": {"scale": r.ones((h,))},
            "q": r.dense(h, cfg.heads * hd),
            "k": r.dense(h, cfg.kv_heads * hd),
            "v": r.dense(h, cfg.kv_heads * hd),
            "o": r.dense(cfg.heads * hd, h, bias=False),
            "post_ln": {"scale": r.ones((h,))},
            "gate": r.dense(h, cfg.ffn_dim, bias=False),
            "up": r.dense(h, cfg.ffn_dim, bias=False),
            "down": r.dense(cfg.ffn_dim, h, bias=False),
        } for _ in range(cfg.layers)],
        "ln_f": {"scale": r.ones((cfg.hidden,))},
    }


def _rms(p: Params, x: torch.Tensor, eps: float) -> torch.Tensor:
    x32 = x.float()
    var = (x32 * x32).mean(dim=-1, keepdim=True)
    return (x32 * torch.rsqrt(var + eps)).to(x.dtype) * p["scale"]


def _repeat_kv(x: torch.Tensor, n: int) -> torch.Tensor:
    """[B, T, Hkv, Dh] → [B, T, Hkv*n, Dh]."""
    b, t, h, d = x.shape
    return x[:, :, :, None, :].expand(b, t, h, n, d).reshape(b, t, h * n, d)


def _attend(cfg: Qwen2Config, q, k, v, mask, dtype) -> torch.Tensor:
    """q/k leave RoPE in f32 (the f32 tables promote them, as in the JAX
    package); a bf16 cache is promoted to meet them."""
    groups = cfg.heads // cfg.kv_heads
    k = _repeat_kv(k.to(q.dtype), groups)
    logits = torch.einsum("bqhd,bkhd->bhqk", q, k) / np.sqrt(cfg.head_dim)
    logits = torch.where(mask, logits, torch.finfo(logits.dtype).min)
    w = torch.softmax(logits.float(), dim=-1).to(dtype)
    out = torch.einsum("bhqk,bkhd->bqhd", w, _repeat_kv(v, groups))
    return out.reshape(q.shape[0], q.shape[1], -1)


def _mlp(layer: Params, h: torch.Tensor) -> torch.Tensor:
    return dense(layer["down"], torch.nn.functional.silu(dense(layer["gate"], h)) * dense(layer["up"], h))


def forward(params: Params, cfg: Qwen2Config, x: torch.Tensor, *,
            attn_mask: Optional[torch.Tensor] = None, pos_offset: int = 0) -> torch.Tensor:
    """Full-sequence pass x [B, T, hidden] → final hidden states [B, T,
    hidden], no cache. ``attn_mask`` [B, 1, T, T] (True = attend) defaults
    to causal; RoPE positions start at ``pos_offset``."""
    b, t, _ = x.shape
    cos_t, sin_t = _rope_tensors(cfg, x.device)
    cos, sin = cos_t[pos_offset: pos_offset + t], sin_t[pos_offset: pos_offset + t]
    if attn_mask is None:
        attn_mask = torch.ones((t, t), dtype=torch.bool, device=x.device).tril()[None, None]
    for layer in params["layers"]:
        h = _rms(layer["input_ln"], x, cfg.norm_eps)
        q = apply_rope(dense(layer["q"], h).reshape(b, t, cfg.heads, cfg.head_dim), cos, sin)
        k = apply_rope(dense(layer["k"], h).reshape(b, t, cfg.kv_heads, cfg.head_dim), cos, sin)
        v = dense(layer["v"], h).reshape(b, t, cfg.kv_heads, cfg.head_dim)
        x = x + dense(layer["o"], _attend(cfg, q, k, v, attn_mask, x.dtype))
        x = x + _mlp(layer, _rms(layer["post_ln"], x, cfg.norm_eps))
    return _rms(params["ln_f"], x, cfg.norm_eps)


def init_kv_cache(cfg: Qwen2Config, batch: int, max_len: int, dtype, device):
    shape = (batch, max_len, cfg.kv_heads, cfg.head_dim)
    return [{"k": torch.zeros(shape, dtype=dtype, device=device),
             "v": torch.zeros(shape, dtype=dtype, device=device)} for _ in range(cfg.layers)]


def prefill(params: Params, cfg: Qwen2Config, x: torch.Tensor, kv_cache, *,
            length_mask: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Run the prompt x [B, T, hidden], filling the caches at [0, T).
    ``length_mask`` [B, T] marks valid positions of right-padded prompts.
    Returns the final hidden states [B, T, hidden]."""
    b, t, _ = x.shape
    cos_t, sin_t = _rope_tensors(cfg, x.device)
    cos, sin = cos_t[:t], sin_t[:t]
    causal = torch.ones((t, t), dtype=torch.bool, device=x.device).tril()[None, None]
    if length_mask is not None:
        causal = causal & length_mask[:, None, None, :]
    for layer, cache in zip(params["layers"], kv_cache):
        h = _rms(layer["input_ln"], x, cfg.norm_eps)
        q = apply_rope(dense(layer["q"], h).reshape(b, t, cfg.heads, cfg.head_dim), cos, sin)
        k = apply_rope(dense(layer["k"], h).reshape(b, t, cfg.kv_heads, cfg.head_dim), cos, sin)
        v = dense(layer["v"], h).reshape(b, t, cfg.kv_heads, cfg.head_dim)
        cache["k"][:, :t] = k.to(cache["k"].dtype)
        cache["v"][:, :t] = v.to(cache["v"].dtype)
        x = x + dense(layer["o"], _attend(cfg, q, k, v, causal, x.dtype))
        x = x + _mlp(layer, _rms(layer["post_ln"], x, cfg.norm_eps))
    return _rms(params["ln_f"], x, cfg.norm_eps)


def decode_step(params: Params, cfg: Qwen2Config, x: torch.Tensor, pos: int, kv_cache, *,
                rope_pos: Optional[torch.Tensor] = None,
                prompt_len: Optional[torch.Tensor] = None,
                prompt_capacity: int = 0) -> torch.Tensor:
    """One cached decode step x [B, 1, hidden] → hidden [B, 1, hidden],
    writing cache slot ``pos``: :func:`decode_span` at S = 1.

    Right-padded batched prompts: ``prompt_len``/``prompt_capacity`` mask the
    pad slots [prompt_len_b, prompt_capacity) out of attention, and
    ``rope_pos`` [B] gives each row its true continuation position."""
    return decode_span(params, cfg, x, pos, kv_cache, rope_pos=rope_pos,
                       prompt_len=prompt_len, prompt_capacity=prompt_capacity)


def decode_span(params: Params, cfg: Qwen2Config, x: torch.Tensor, pos: int, kv_cache, *,
                rope_pos: Optional[torch.Tensor] = None,
                prompt_len: Optional[torch.Tensor] = None,
                prompt_capacity: int = 0) -> torch.Tensor:
    """S new positions x [B, S, hidden] in one pass → hidden [B, S, hidden],
    writing cache slots [pos, pos + S): the weights are read once for all S
    (multi-token prediction ingests its K tokens this way). Query s attends
    to the cache slots ≤ pos + s (causal over absolute positions), rotates
    at ``rope_pos + s`` (per row; ``pos + s`` without ``rope_pos``), and the
    pad slots are masked as in :func:`decode_step`."""
    b, s_len, _ = x.shape
    cos_t, sin_t = _rope_tensors(cfg, x.device)
    if rope_pos is None:
        cos, sin = cos_t[pos:pos + s_len], sin_t[pos:pos + s_len]
    else:
        idx = rope_pos[:, None] + torch.arange(s_len, device=x.device)[None, :]
        cos, sin = cos_t[idx], sin_t[idx]
    max_len = kv_cache[0]["k"].shape[1]
    positions = torch.arange(max_len, device=x.device)[None, None, None, :]
    query_abs = pos + torch.arange(s_len, device=x.device)[None, None, :, None]
    mask = positions <= query_abs
    if prompt_len is not None:
        keep = (positions < prompt_len[:, None, None, None]) | (positions >= prompt_capacity)
        mask = mask & keep
    for layer, cache in zip(params["layers"], kv_cache):
        h = _rms(layer["input_ln"], x, cfg.norm_eps)
        q = apply_rope(dense(layer["q"], h).reshape(b, s_len, cfg.heads, cfg.head_dim), cos, sin)
        k = apply_rope(dense(layer["k"], h).reshape(b, s_len, cfg.kv_heads, cfg.head_dim),
                       cos, sin)
        v = dense(layer["v"], h).reshape(b, s_len, cfg.kv_heads, cfg.head_dim)
        cache["k"][:, pos:pos + s_len] = k.to(cache["k"].dtype)
        cache["v"][:, pos:pos + s_len] = v.to(cache["v"].dtype)
        x = x + dense(layer["o"], _attend(cfg, q, cache["k"], cache["v"], mask, x.dtype))
        x = x + _mlp(layer, _rms(layer["post_ln"], x, cfg.norm_eps))
    return _rms(params["ln_f"], x, cfg.norm_eps)


# --------------------------------------------------------------- parallelism


