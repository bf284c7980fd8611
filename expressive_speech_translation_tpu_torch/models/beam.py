"""Greedy search for encoder-decoder LMs (the JAX package's
``models/beam.py`` ``greedy_search``; beam search is not ported yet).

``step_fn(token [N], pos, cache, beam_state) -> logits [N, V]`` is the only
model-specific piece; it advances ``cache`` in place. The prompt is
teacher-forced through the same step, and the loop stops once every row has
produced EOS (HF ``generate`` semantics).
"""

from __future__ import annotations

import dataclasses
from typing import Any, Callable

import torch

NEG_INF = -1.0e9

StepFn = Callable[..., torch.Tensor]


@dataclasses.dataclass(frozen=True)
class BeamConfig:
    eos_token: int
    pad_token: int
    max_len: int
    decoder_prompt_len: int = 1
    # EOS is banned while the token being produced (sequence index pos+1) is
    # < decoder_prompt_len + min_new_tokens (HF MinNewTokensLengthLogitsProcessor)
    min_new_tokens: int = 0


def greedy_search(step_fn: StepFn, prompt: torch.Tensor, cache, beam_state: Any,
                  cfg: BeamConfig) -> torch.Tensor:
    """Greedy decode; returns [B, cfg.max_len] int32, pad-filled after EOS."""
    b, p_len = prompt.shape
    total = cfg.max_len
    tokens = torch.full((b, total), cfg.pad_token, dtype=torch.int32, device=prompt.device)
    tokens[:, :p_len] = prompt.to(torch.int32)
    done = torch.zeros((b,), dtype=torch.bool, device=prompt.device)
    for pos in range(total - 1):
        if pos + 1 >= p_len and bool(done.all()):
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
    return tokens
