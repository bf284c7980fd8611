"""Greedy and beam search for encoder-decoder LMs (the JAX package's
``models/beam.py``).

``step_fn(token [N], pos, cache, beam_state) -> logits [N, V]`` is the only
model-specific piece; it advances ``cache`` in place. The prompt is
teacher-forced through the same step, and the loop stops once every row has
produced EOS (greedy) or filled its finished set (beam search), as HF
``generate`` does. Each loop is a ``decode`` span: ``steps`` counts the
calls of ``step_fn``, the prompt's included, ``rows`` the rows each takes.
"""

from __future__ import annotations

import dataclasses
from typing import Any, Callable

import torch

from ..obs import spans

NEG_INF = -1.0e9

StepFn = Callable[..., torch.Tensor]


@dataclasses.dataclass(frozen=True)
class BeamConfig:
    eos_token: int
    pad_token: int
    max_len: int
    num_beams: int = 1
    length_penalty: float = 1.0
    # length normalisation divides by generated_len = cur_len - decoder_prompt_len
    # (the forced BOS counts as generated, as in HF)
    decoder_prompt_len: int = 1
    # EOS is banned while the token being produced (sequence index pos+1) is
    # < decoder_prompt_len + min_new_tokens (HF MinNewTokensLengthLogitsProcessor);
    # beam search bans it on the log-softmaxed scores, where HF's processors run
    min_new_tokens: int = 0


def greedy_search(step_fn: StepFn, prompt: torch.Tensor, cache, beam_state: Any,
                  cfg: BeamConfig) -> torch.Tensor:
    """Greedy decode; returns [B, cfg.max_len] int32, pad-filled after EOS."""
    b, p_len = prompt.shape
    total = cfg.max_len
    tokens = torch.full((b, total), cfg.pad_token, dtype=torch.int32, device=prompt.device)
    tokens[:, :p_len] = prompt.to(torch.int32)
    done = torch.zeros((b,), dtype=torch.bool, device=prompt.device)
    steps = total - 1
    with spans.span("decode", rows=b) as loop:
        for pos in range(total - 1):
            if pos + 1 >= p_len and bool(done.all()):
                steps = pos
                break
            logits = step_fn(tokens[:, pos], pos, cache, beam_state)
            if pos + 1 < p_len:
                continue  # teacher-forced prompt step: only the cache advances
            if cfg.min_new_tokens and pos + 1 < cfg.decoder_prompt_len + cfg.min_new_tokens:
                logits = logits.clone()
                logits[:, cfg.eos_token] = NEG_INF
            nxt = torch.argmax(logits, dim=-1).to(torch.int32)
            nxt = torch.where(done, torch.full_like(nxt, cfg.pad_token), nxt)
            tokens[:, pos + 1] = nxt
            done = done | (nxt == cfg.eos_token)
        loop.attrs["steps"] = steps
    return tokens


def _top_k(x: torch.Tensor, k: int):
    """The k largest along the last axis, ties to the lower index (as XLA's
    top_k orders them)."""
    values, indices = torch.sort(x, dim=-1, descending=True, stable=True)
    return values[..., :k], indices[..., :k]


def _tree_map(fn, tree):
    if isinstance(tree, dict):
        return {k: _tree_map(fn, v) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return type(tree)(_tree_map(fn, v) for v in tree)
    return fn(tree)


def _gather_beams(tree, indices: torch.Tensor, batch: int, beams: int):
    """Reorder the [B*K, ...] leaves of ``tree`` by per-row beam indices [B, K]."""
    flat = (torch.arange(batch, device=indices.device)[:, None] * beams + indices).reshape(-1)
    return _tree_map(lambda x: x.index_select(0, flat), tree)


def _len_norm(gen_len: int, cfg: BeamConfig, dev) -> torch.Tensor:
    """generated_len ** length_penalty, raised in f32 as the scores are."""
    return torch.tensor(float(gen_len), dtype=torch.float32, device=dev) ** cfg.length_penalty


def beam_search(step_fn: StepFn, prompt: torch.Tensor, cache, beam_state: Any,
                cfg: BeamConfig) -> torch.Tensor:
    """HF-compatible beam search with ``early_stopping=True``: the best
    hypothesis a row, [B, cfg.max_len] int32, pad-filled.

    ``cache`` is allocated for B*K rows; ``beam_state`` leaves with a leading
    batch dim B are repeated to B*K, each row's K beams contiguous. A row is
    done once K hypotheses have finished, and its finished set is then
    frozen. Only an EOS candidate ranked within the top K of a step may
    finish, its score normalised by ``generated_len ** length_penalty``."""
    b, p_len = prompt.shape
    k = cfg.num_beams
    total = cfg.max_len
    dev = prompt.device
    beam_state = _tree_map(lambda x: x.repeat_interleave(k, dim=0)
                           if torch.is_tensor(x) and x.ndim >= 1 and x.shape[0] == b else x,
                           beam_state)
    tokens = torch.full((b, k, total), cfg.pad_token, dtype=torch.int32, device=dev)
    tokens[:, :, :p_len] = prompt[:, None, :].to(torch.int32)
    live_scores = torch.tensor([0.0] + [NEG_INF] * (k - 1), device=dev).repeat(b, 1)
    fin_tokens = torch.full((b, k, total), cfg.pad_token, dtype=torch.int32, device=dev)
    fin_scores = torch.full((b, k), NEG_INF, device=dev)
    rank_ok = torch.arange(2 * k, device=dev)[None, :] < k
    pos = 0
    with spans.span("decode", rows=b * k) as loop:
        while pos < total - 1:
            batch_done = (fin_scores > NEG_INF / 2).all(dim=1)
            if bool(batch_done.all()):
                break
            logits = step_fn(tokens[:, :, pos].reshape(b * k), pos, cache, beam_state)
            if pos + 1 < p_len:     # teacher-forced prompt step: only the cache advances
                pos += 1
                continue
            logp = torch.log_softmax(logits.float(), dim=-1).reshape(b, k, -1)
            if cfg.min_new_tokens and pos + 1 < cfg.decoder_prompt_len + cfg.min_new_tokens:
                logp[:, :, cfg.eos_token] = NEG_INF
            vocab = logp.shape[-1]
            top_scores, top_idx = _top_k((live_scores[:, :, None] + logp).reshape(b, k * vocab),
                                         2 * k)
            parent = top_idx // vocab
            token_id = (top_idx % vocab).to(torch.int32)
            is_eos = token_id == cfg.eos_token
            cand_tokens = torch.take_along_dim(tokens, parent[:, :, None], dim=1)
            cand_tokens[:, :, pos + 1] = token_id

            # finished set: EOS candidates within the top K, normalised now
            norm = top_scores / _len_norm(pos + 2 - cfg.decoder_prompt_len, cfg, dev)
            eos_scores = torch.where(is_eos & rank_ok & ~batch_done[:, None], norm,
                                     torch.full_like(norm, NEG_INF))
            fin_scores, fin_sel = _top_k(torch.cat([fin_scores, eos_scores], dim=1), k)
            fin_tokens = torch.take_along_dim(torch.cat([fin_tokens, cand_tokens], dim=1),
                                              fin_sel[:, :, None], dim=1)
            # live set: the best K candidates that are not EOS
            live_scores, live_sel = _top_k(
                torch.where(is_eos, torch.full_like(top_scores, NEG_INF), top_scores), k)
            tokens = torch.take_along_dim(cand_tokens, live_sel[:, :, None], dim=1)
            cache = _gather_beams(cache, torch.take_along_dim(parent, live_sel, dim=1), b, k)
            pos += 1
        loop.attrs["steps"] = pos

    # rows not done: their live beams, normalised at the final length,
    # compete with the finished set
    batch_done = (fin_scores > NEG_INF / 2).all(dim=1)
    live_norm = live_scores / _len_norm(max(pos + 1 - cfg.decoder_prompt_len, 1), cfg, dev)
    live_norm = torch.where(batch_done[:, None], torch.full_like(live_norm, NEG_INF), live_norm)
    best = torch.argmax(torch.cat([fin_scores, live_norm], dim=1), dim=1)
    all_tokens = torch.cat([fin_tokens, tokens], dim=1)
    return torch.take_along_dim(all_tokens, best[:, None, None], dim=1)[:, 0]
