"""Shared transformer building blocks over parameter dicts of tensors.

The port of the JAX package's ``models/common.py``: models are nested dicts
of tensors plus plain functions. Layouts follow the JAX package so that its
parameter trees carry over unchanged (:func:`tree_from_numpy`):

- activations [B, T, D]; attention heads folded as [B, T, H, Dh];
- dense kernels [in, out] (``x @ kernel``);
- KV caches preallocated [B, max_T, H, Dh]. Unlike the JAX package's pure
  functions, the decode steps write the new K/V into the cache in place,
  which saves a cache copy per step;
- weight-only int8 decode (``quantize_*``): int8 codes with per-channel f32
  scales, multiplied in the activations' dtype by ``torch.matmul``, as the
  JAX package leaves the convert to XLA (no kernel of its own);
- tensor parallelism: a leaf placed by ``parallel/partition.py`` may be a
  ``Shards`` split over a group's cards; :func:`dense`,
  :func:`tied_head_logits` and :func:`embed_rows` compute over its parts and
  return to the activations' device (:func:`transformer_partition_rules`).
"""

from __future__ import annotations

import dataclasses
import math
from typing import Any, Dict, List, Optional, Tuple

import numpy as np
import torch
import torch.nn.functional as F

from ..parallel.partition import PartitionRules, Shards, matmul, whole

Params = Dict[str, Any]


# ------------------------------------------------------------------ parameters


def tree_from_numpy(tree, device, dtype=None):
    """Nested dicts/lists of numpy arrays → the same nesting of tensors on
    ``device``; floating leaves cast to ``dtype`` when given."""
    if isinstance(tree, dict):
        return {k: tree_from_numpy(v, device, dtype) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return [tree_from_numpy(v, device, dtype) for v in tree]
    t = torch.as_tensor(np.array(tree), device=device)
    if dtype is not None and t.is_floating_point():
        t = t.to(dtype)
    return t


def tree_to(tree, device):
    """A nested dict/list tree of tensors on ``device`` (a tensor already
    there is kept, not copied)."""
    if isinstance(tree, dict):
        return {k: tree_to(v, device) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return [tree_to(v, device) for v in tree]
    return tree.to(device) if torch.is_tensor(tree) else tree


def state_tensor(value, device) -> torch.Tensor:
    """A checkpoint state-dict value (a torch tensor or a numpy array) as a
    contiguous tensor on ``device``, its dtype kept."""
    t = value.detach() if torch.is_tensor(value) else torch.from_numpy(np.array(value))
    return t.to(device).contiguous()


def linear_from_state(weight, bias, device) -> Params:
    """A torch Linear's weight [out, in] (and bias, or None) → a dense layer
    {"kernel" [in, out], "bias"}."""
    p = {"kernel": state_tensor(weight, device).T.contiguous()}
    if bias is not None:
        p["bias"] = state_tensor(bias, device)
    return p


def hf_state_getter(state):
    """name → ``state["model." + name]``, else ``state[name]``: an HF
    ``...ForConditionalGeneration`` state dict is rooted at ``model.``, the
    bare model's is not."""
    def g(name):
        for prefix in ("model.", ""):
            if prefix + name in state:
                return state[prefix + name]
        raise KeyError(name)
    return g


def hf_pre_ln_block(g, base: str, device, *, cross: bool, k_bias: bool) -> Params:
    """One encoder or decoder layer of an HF Whisper / M2M100 state dict
    (``g`` from :func:`hf_state_getter`) → a pre-LN block of the port's
    layout, the checkpoint's dtype kept."""
    def attn(name):
        return {ours: linear_from_state(g(f"{name}.{hf}_proj.weight"),
                                        g(f"{name}.{hf}_proj.bias") if ours != "k" or k_bias
                                        else None, device)
                for ours, hf in (("q", "q"), ("k", "k"), ("v", "v"), ("o", "out"))}

    def ln(name):
        return {"scale": state_tensor(g(f"{name}.weight"), device),
                "bias": state_tensor(g(f"{name}.bias"), device)}

    p = {"self_attn": attn(f"{base}.self_attn"), "self_attn_ln": ln(f"{base}.self_attn_layer_norm"),
         "mlp": {fc: linear_from_state(g(f"{base}.{fc}.weight"), g(f"{base}.{fc}.bias"), device)
                 for fc in ("fc1", "fc2")},
         "mlp_ln": ln(f"{base}.final_layer_norm")}
    if cross:
        p["cross_attn"] = attn(f"{base}.encoder_attn")
        p["cross_attn_ln"] = ln(f"{base}.encoder_attn_layer_norm")
    return p


def permute_conv_kernels(tree, order):
    """Every 3-D ``kernel`` leaf of a nested tree permuted by ``order``, in
    place (the JAX package's conv kernels [width, in, out] → torch's);
    2-D dense kernels are left as they are."""
    if isinstance(tree, dict):
        for key, value in tree.items():
            if key == "kernel" and torch.is_tensor(value) and value.ndim == 3:
                tree[key] = value.permute(*order).contiguous()
            else:
                permute_conv_kernels(value, order)
    elif isinstance(tree, list):
        for value in tree:
            permute_conv_kernels(value, order)
    return tree


def promoted(*xs: torch.Tensor) -> List[torch.Tensor]:
    """The tensors in their common promoted dtype: JAX promotes the mixed
    operands of a product or a concatenation, torch asks for one dtype."""
    dt = xs[0].dtype
    for x in xs[1:]:
        dt = torch.promote_types(dt, x.dtype)
    return [x.to(dt) for x in xs]


def cast_floats(tree, dtype):
    """Cast floating leaves of a parameter tree (the bf16 serving policy)."""
    if isinstance(tree, dict):
        return {k: cast_floats(v, dtype) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return [cast_floats(v, dtype) for v in tree]
    if torch.is_tensor(tree) and tree.is_floating_point():
        return tree.to(dtype)
    if isinstance(tree, Shards) and tree.dtype.is_floating_point:
        return tree.map(lambda t: t.to(dtype))
    return tree


class Init:
    """Seeded random parameters, drawn on ``device`` from one generator (the
    port's counterpart of the JAX inits; its numbers differ from
    ``jax.random``'s)."""

    def __init__(self, seed: int, device):
        self.device = torch.device(device)
        self.gen = torch.Generator(device=self.device).manual_seed(seed)

    def uniform(self, shape, scale: float) -> torch.Tensor:
        u = torch.rand(shape, generator=self.gen, device=self.device)
        return u * (2 * scale) - scale

    def normal(self, shape, std: float) -> torch.Tensor:
        return torch.randn(shape, generator=self.gen, device=self.device) * std

    def zeros(self, shape) -> torch.Tensor:
        return torch.zeros(shape, device=self.device)

    def ones(self, shape) -> torch.Tensor:
        return torch.ones(shape, device=self.device)

    def dense(self, in_dim: int, out_dim: int, *, bias: bool = True) -> Params:
        p = {"kernel": self.uniform((in_dim, out_dim), 1.0 / math.sqrt(in_dim))}
        if bias:
            p["bias"] = self.zeros((out_dim,))
        return p

    def layer_norm(self, dim: int) -> Params:
        return {"scale": self.ones((dim,)), "bias": self.zeros((dim,))}

    def attention(self, cfg: "AttnConfig") -> Params:
        return {"q": self.dense(cfg.dim, cfg.dim),
                "k": self.dense(cfg.dim, cfg.dim, bias=cfg.k_bias),
                "v": self.dense(cfg.dim, cfg.dim),
                "o": self.dense(cfg.dim, cfg.dim)}

    def mlp(self, dim: int, hidden: int) -> Params:
        return {"fc1": self.dense(dim, hidden), "fc2": self.dense(hidden, dim)}

    def pre_ln_block(self, attn_cfg: "AttnConfig", d_model: int, ffn_dim: int, *,
                     cross: bool) -> Params:
        p: Params = {
            "self_attn": self.attention(attn_cfg),
            "self_attn_ln": self.layer_norm(d_model),
            "mlp": self.mlp(d_model, ffn_dim),
            "mlp_ln": self.layer_norm(d_model),
        }
        if cross:
            p["cross_attn"] = self.attention(attn_cfg)
            p["cross_attn_ln"] = self.layer_norm(d_model)
        return p


# ---------------------------------------------------------------------- layers


def dense(p: Params, x: torch.Tensor) -> torch.Tensor:
    """``x @ kernel + bias``; a weight-only int8 layer (``kernel_q``, see
    :func:`quantize_dense`) multiplies by its codes in x's dtype and applies
    the per-output-channel scale after the product. A sharded kernel
    computes on its cards and returns to x's (``parallel.partition.matmul``);
    a sharded scale or bias is applied whole there."""
    if "kernel_q" in p:
        y = matmul(x, p["kernel_q"]) * whole(p["scale"]).to(x.dtype)
    else:
        y = matmul(x, p["kernel"])
    if "bias" in p:
        y = y + whole(p["bias"])
    return y


def quantize_dense(p: Params) -> Params:
    """Symmetric per-output-channel int8 weights of a dense layer ({"kernel"
    [in, out], "bias"?} → {"kernel_q" int8, "scale" f32 [1, out], "bias"?}).
    The scale is reckoned in the kernel's dtype and stored in f32."""
    k = p["kernel"]
    scale = torch.clamp(k.abs().amax(dim=0, keepdim=True), min=1e-8) / 127.0
    q = torch.clamp(torch.round(k / scale), -127, 127).to(torch.int8)
    out: Params = {"kernel_q": q, "scale": scale.float()}
    if "bias" in p:
        out["bias"] = p["bias"]
    return out


def quantize_transformer_blocks(blocks) -> list:
    """int8 weights for the attention (``self_attn``, ``cross_attn``) and
    ``mlp`` dense layers of pre-LN blocks; the norms stay float."""
    out = []
    for blk in blocks:
        q = dict(blk)
        for key in ("self_attn", "cross_attn", "mlp"):
            if key in blk:
                q[key] = {n: quantize_dense(p) for n, p in blk[key].items()}
        out.append(q)
    return out


def quantize_embed_head(embed: torch.Tensor) -> Params:
    """A per-vocabulary-row int8 copy of a tied embedding [vocab, d] for the
    output product; the float table stays for the gathers."""
    scale = torch.clamp(embed.abs().amax(dim=1), min=1e-8) / 127.0
    q = torch.clamp(torch.round(embed / scale[:, None]), -127, 127).to(torch.int8)
    return {"q": q, "scale": scale.float()}


def tied_head_logits(container: Params, x: torch.Tensor, embed: torch.Tensor) -> torch.Tensor:
    """``x @ embed.T`` (x: [..., d] → logits [..., vocab]), through the int8
    copy when ``container`` holds ``embed_q`` (:func:`quantize_embed_head`)."""
    if "embed_q" in container:
        eq = container["embed_q"]
        return matmul(x, eq["q"], transpose=True) * whole(eq["scale"]).to(x.dtype)
    return matmul(x, embed, transpose=True)


def embed_rows(table, ids) -> torch.Tensor:
    """``table[ids]``; rows of a hidden-sharded table (split along dim 1)
    are gathered on every slot and concatenated on the lead."""
    if not isinstance(table, Shards):
        return table[ids.long() if torch.is_tensor(ids) else ids]
    if table.dim != 1:
        raise ValueError(f"embedding rows of a table split along dim {table.dim}")
    rows = [p[ids.to(p.device).long() if torch.is_tensor(ids) else ids] for p in table.parts]
    return torch.cat([r.to(table.device) for r in rows], dim=-1)


def layer_norm(p: Params, x: torch.Tensor, *, eps: float = 1e-5) -> torch.Tensor:
    mean = x.mean(dim=-1, keepdim=True)
    var = x.var(dim=-1, keepdim=True, unbiased=False)
    y = (x - mean) * torch.rsqrt(var + eps)
    return y * p["scale"] + p["bias"]


def rms_norm(p: Params, x: torch.Tensor, *, eps: float = 1e-6) -> torch.Tensor:
    var = (x * x).mean(dim=-1, keepdim=True)
    return x * torch.rsqrt(var + eps) * p["scale"]


def gelu(x: torch.Tensor) -> torch.Tensor:
    """Exact (erf) GELU."""
    return F.gelu(x, approximate="none")


def sinusoid_position_embedding(length: int, dim: int, *, max_timescale: float = 10000.0) -> np.ndarray:
    """Whisper-style sinusoids: [length, dim] = concat(sin, cos)."""
    assert dim % 2 == 0
    log_timescale = math.log(max_timescale) / (dim // 2 - 1)
    inv_timescales = np.exp(-log_timescale * np.arange(dim // 2))
    scaled = np.arange(length)[:, None] * inv_timescales[None, :]
    return np.concatenate([np.sin(scaled), np.cos(scaled)], axis=1).astype(np.float32)


def mlp(p: Params, x: torch.Tensor, *, activation=gelu) -> torch.Tensor:
    return dense(p["fc2"], activation(dense(p["fc1"], x)))


# ------------------------------------------------------------------- attention


@dataclasses.dataclass(frozen=True)
class AttnConfig:
    dim: int
    heads: int
    k_bias: bool = False  # whisper: no bias on k; NLLB: bias everywhere

    @property
    def head_dim(self) -> int:
        return self.dim // self.heads


def split_heads(x: torch.Tensor, heads: int) -> torch.Tensor:
    b, t, d = x.shape
    return x.reshape(b, t, heads, d // heads)


def merge_heads(x: torch.Tensor) -> torch.Tensor:
    b, t, h, dh = x.shape
    return x.reshape(b, t, h * dh)


def masked_softmax(logits: torch.Tensor, mask: Optional[torch.Tensor], dtype) -> torch.Tensor:
    """softmax in f32 over the last axis, masked positions at the dtype's
    minimum (the JAX package's convention), cast back to ``dtype``."""
    if mask is not None:
        logits = torch.where(mask, logits, torch.finfo(logits.dtype).min)
    return torch.softmax(logits.float(), dim=-1).to(dtype)


def mha(p: Params, cfg: AttnConfig, x_q: torch.Tensor, x_kv: Optional[torch.Tensor], *,
        mask: Optional[torch.Tensor] = None,
        precomputed_kv: Optional[Tuple[torch.Tensor, torch.Tensor]] = None) -> torch.Tensor:
    """Full (non-cached) multi-head attention. mask: broadcastable to
    [B, H, Tq, Tk], True = attend."""
    q = split_heads(dense(p["q"], x_q), cfg.heads) * (cfg.head_dim ** -0.5)
    if precomputed_kv is None:
        k, v = attention_kv(p, cfg, x_kv)
    else:
        k, v = precomputed_kv
    logits = torch.einsum("bqhd,bkhd->bhqk", q, k)
    weights = masked_softmax(logits, mask, x_q.dtype)
    out = torch.einsum("bhqk,bkhd->bqhd", weights, v)
    return dense(p["o"], merge_heads(out))


def attention_kv(p: Params, cfg: AttnConfig, x_kv: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """Precompute K/V (e.g. encoder outputs for cross-attention)."""
    return (split_heads(dense(p["k"], x_kv), cfg.heads),
            split_heads(dense(p["v"], x_kv), cfg.heads))


def mha_step(p: Params, cfg: AttnConfig, x_q: torch.Tensor, cache: Dict[str, torch.Tensor],
             pos: int) -> torch.Tensor:
    """One autoregressive self-attention step: writes this step's K/V into
    ``cache`` at ``pos`` (in place) and attends over positions <= pos.
    x_q [B, 1, D] → [B, 1, D]."""
    q = split_heads(dense(p["q"], x_q), cfg.heads) * (cfg.head_dim ** -0.5)
    cache["k"][:, pos] = split_heads(dense(p["k"], x_q), cfg.heads)[:, 0].to(cache["k"].dtype)
    cache["v"][:, pos] = split_heads(dense(p["v"], x_q), cfg.heads)[:, 0].to(cache["v"].dtype)
    logits = torch.einsum("bqhd,bkhd->bhqk", q, cache["k"])
    positions = torch.arange(cache["k"].shape[1], device=x_q.device)
    weights = masked_softmax(logits, positions <= pos, x_q.dtype)
    out = torch.einsum("bhqk,bkhd->bqhd", weights, cache["v"])
    return dense(p["o"], merge_heads(out))


# ---------------------------------------------------------- decoder plumbing


def precompute_layer_cross_kv(layers, attn_cfg: AttnConfig, enc_out: torch.Tensor):
    """Per-layer encoder K/V for cross-attention (once per utterance)."""
    return [attention_kv(b["cross_attn"], attn_cfg, enc_out) for b in layers]


def init_decoder_kv_cache(n_layers: int, batch: int, max_len: int, heads: int,
                          head_dim: int, dtype, device) -> List[Dict[str, torch.Tensor]]:
    shape = (batch, max_len, heads, head_dim)
    return [{"k": torch.zeros(shape, dtype=dtype, device=device),
             "v": torch.zeros(shape, dtype=dtype, device=device)} for _ in range(n_layers)]


# ------------------------------------------------------------------ parallelism


def transformer_partition_rules(tp_axis: str = "tp") -> PartitionRules:
    """Megatron-style TP layout of the shared pre-LN blocks (whisper and
    NLLB share these paths): column-parallel q/k/v and fc1, row-parallel o
    and fc2, a hidden-sharded tied embedding whose logit product contracts
    over the shards and sums. int8 layouts (``kernel_q`` and per-channel
    ``scale``) shard with their columns; row-parallel scales replicate."""
    return PartitionRules(rules=(
        (r"/(self_attn|cross_attn)/(q|k|v)/kernel(_q)?$", (None, tp_axis)),
        (r"/(self_attn|cross_attn)/(q|k|v)/scale$", (None, tp_axis)),
        (r"/(self_attn|cross_attn)/(q|k|v)/bias$", (tp_axis,)),
        (r"/(self_attn|cross_attn)/o/kernel(_q)?$", (tp_axis, None)),
        (r"/mlp/fc1/kernel(_q)?$", (None, tp_axis)),
        (r"/mlp/fc1/scale$", (None, tp_axis)),
        (r"/mlp/fc1/bias$", (tp_axis,)),
        (r"/mlp/fc2/kernel(_q)?$", (tp_axis, None)),
        (r"embed_q/q$", (None, tp_axis)),
        (r"(^|/)embed$", (None, tp_axis)),
    ))
