"""Qwen2-style decoder-only backbone (RoPE, GQA, RMSNorm, SwiGLU): the LM
inside CosyVoice2's speech-token generator.

The port of the JAX package's ``models/qwen2.py`` ``rope_table``,
``forward`` (the full-sequence pass training runs), ``prefill``,
``decode_step`` and ``decode_span``. KV caches are
preallocated; the functions write into them in place. GQA K/V heads are
repeated at compute time.
"""

from __future__ import annotations

import dataclasses
import functools
from typing import Optional, Tuple

import numpy as np
import torch

from ..core.device import resolve_device
from ..parallel.partition import PartitionRules
from .common import Init, Params, dense, linear_from_state, state_tensor, tree_from_numpy


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


def from_jax_params(tree, device, dtype=torch.float32) -> Params:
    """The JAX package's qwen2 parameter tree → the port's (same layout)."""
    return tree_from_numpy(tree, device, dtype)


def from_hf_state_dict(state, cfg: Qwen2Config, device=None) -> Params:
    """An HF Qwen2Model / Qwen2ForCausalLM state dict (``model.``-prefixed or
    not; torch tensors or numpy arrays) → the port's backbone tree on
    ``device``, its dtype kept: dense weights [out, in] turn into kernels
    [in, out]. The backbone only; the wrapping speech LM takes the
    embeddings and the head."""
    dev = resolve_device(device)

    def g(name):
        for prefix in ("model.", ""):
            if prefix + name in state:
                return state[prefix + name]
        raise KeyError(name)

    def lin(name, bias=False):
        return linear_from_state(g(f"{name}.weight"), g(f"{name}.bias") if bias else None, dev)

    layers = []
    for i in range(cfg.layers):
        a, m = f"layers.{i}.self_attn", f"layers.{i}.mlp"
        layers.append({
            "input_ln": {"scale": state_tensor(g(f"layers.{i}.input_layernorm.weight"), dev)},
            "q": lin(f"{a}.q_proj", bias=True), "k": lin(f"{a}.k_proj", bias=True),
            "v": lin(f"{a}.v_proj", bias=True), "o": lin(f"{a}.o_proj"),
            "post_ln": {"scale": state_tensor(g(f"layers.{i}.post_attention_layernorm.weight"),
                                              dev)},
            "gate": lin(f"{m}.gate_proj"), "up": lin(f"{m}.up_proj"), "down": lin(f"{m}.down_proj"),
        })
    return {"layers": layers, "ln_f": {"scale": state_tensor(g("norm.weight"), dev)}}


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


def partition_rules(tp_axis: str = "tp") -> PartitionRules:
    """Megatron-style tensor-parallel layout of the backbone:
    column-parallel q/k/v/gate/up (output features split over ``tp_axis``)
    and row-parallel o/down (input features split). ``kernel(_q)`` covers
    the float and the weight-only int8 layouts; the per-output-channel
    scale [1, out] splits with the columns. Head math is local when
    heads % tp == 0 and kv_heads % tp == 0; otherwise the gathered columns
    are reshaped into heads on the lead, which is the same function."""
    return PartitionRules(rules=(
        (r"/(q|k|v|gate|up)/kernel(_q)?$", (None, tp_axis)),
        (r"/(q|k|v|gate|up)/scale$", (None, tp_axis)),
        (r"/(q|k|v)/bias$", (tp_axis,)),
        (r"/(o|down)/kernel(_q)?$", (tp_axis, None)),
    ))
