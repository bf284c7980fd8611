"""CosyVoice speech-LM SFT: the training step (the port of the JAX package's
``train/sft.py``).

Reproduces the reference's Greek SFT semantics (train_greek.sh:13-28,
greek_sft.yaml:94-103): AdamW lr 1e-5 constant, grad accumulation 4, global
clip 5, mixed precision, per-step loss/accuracy metrics, save every 1000 steps.

- Mixed precision is the JAX package's policy, not ``torch.autocast``: the
  loss casts the f32 parameter tree to bf16 (``cast_floats``) and runs the
  forward there; the gradient flows back through the casts into the f32
  parameters, and the AdamW moments stay f32. No loss scaling.
- ``accum_grad`` microbatches ride the leading dimension of one batch: their
  gradients are summed, divided by ``accum_grad``, clipped and applied in one
  update, as the JAX package's ``lax.scan`` step does.
- The optimizer is ``torch.optim.AdamW`` driven to match optax's
  ``chain(clip_by_global_norm, adamw)`` (:class:`Optimizer`).
- One card: a ``mesh`` (the JAX package's data-parallel pjit step) is
  ROADMAP Queue 1 item 12 and raises.

The trained objective is the speech-token LM (``--model llm``): next-token
cross-entropy over ``[sos] text [task] speech…eos`` with loss masked to the
speech segment, plus token accuracy (the metrics the reference logs as "TRAIN
Batch … loss … acc", training_log.txt).
"""

from __future__ import annotations

from typing import Any, Callable, Dict, List, NamedTuple, Tuple

import numpy as np
import torch

from ..core.device import resolve_device
from ..models import cosyvoice as cv
from ..models import qwen2 as q2
from ..models.common import Init, cast_floats


class SFTBatch(NamedTuple):
    """One (micro)batch of numpy arrays or tensors. Leading dim may be
    [accum, batch, ...] for a step's microbatches."""

    text_tokens: Any     # [B, Tt] int32
    text_mask: Any       # [B, Tt] bool
    speech_tokens: Any   # [B, Ts] int32
    speech_mask: Any     # [B, Ts] bool


class TrainState(NamedTuple):
    """``step`` counts the updates applied; ``params`` is the f32 tree whose
    leaves the optimizer ``opt_state`` (a ``torch.optim.AdamW``) updates in
    place."""

    step: int
    params: Any
    opt_state: Any


def tree_leaves(tree) -> List[torch.Tensor]:
    """The tensors of a nested dict / list tree, depth first in key order."""
    if isinstance(tree, dict):
        return [t for v in tree.values() for t in tree_leaves(v)]
    if isinstance(tree, (list, tuple)):
        return [t for v in tree for t in tree_leaves(v)]
    return [tree]


def batch_to(batch: SFTBatch, device) -> SFTBatch:
    """A batch of numpy arrays (or tensors) as tensors on ``device``: token
    ids int64, masks bool."""
    return SFTBatch(*(torch.as_tensor(np.asarray(x) if not torch.is_tensor(x) else x,
                                      device=device).to(dtype)
                      for x, dtype in zip(batch, (torch.int64, torch.bool) * 2)))


def _gather_rows(x: torch.Tensor, pos: torch.Tensor) -> torch.Tensor:
    """x [B, L, D] at per-row positions pos [B, P] → [B, P, D]."""
    return torch.gather(x, 1, pos[..., None].expand(-1, -1, x.shape[-1]))


def _masked_nll(logits: torch.Tensor, targets: torch.Tensor, mask: torch.Tensor) -> torch.Tensor:
    """Σ of the f32 token NLL over ``mask``, divided by max(Σ mask, 1)."""
    logp = torch.log_softmax(logits.float(), dim=-1)
    nll = -torch.gather(logp, -1, targets[..., None])[..., 0]
    return (nll * mask).sum() / torch.clamp(mask.sum(), min=1)


def lm_loss(params: Any, cfg: cv.SpeechLMConfig, batch: SFTBatch, *,
            compute_dtype=torch.bfloat16) -> Tuple[torch.Tensor, Dict[str, torch.Tensor]]:
    """Teacher-forced next-token CE over the speech segment (+ EOS) of a
    batch of tensors (:func:`batch_to`). → (loss, {"loss", "acc"[,
    "mtp_loss"]}), each an f32 scalar tensor."""
    b, ts = batch.speech_tokens.shape
    seq_len = 2 + batch.text_tokens.shape[1] + ts
    if seq_len > cfg.backbone.max_positions:
        # past the RoPE table the forward would fail with an opaque shape
        # error mid-epoch (bucketed lengths can double past the top bucket)
        raise ValueError(
            f"batch sequence length {seq_len} (2 + text {batch.text_tokens.shape[1]}"
            f" + speech {ts}) exceeds backbone max_positions "
            f"{cfg.backbone.max_positions}")
    p = cast_floats(params, compute_dtype) if compute_dtype != torch.float32 else params
    dev = batch.speech_tokens.device

    # input [sos] text [task] speech, compacted to a contiguous prefix per row
    emb, mask = cv.build_prompt_embeddings(p, cfg, batch.text_tokens, batch.text_mask,
                                           batch.speech_tokens, batch.speech_mask)
    causal = torch.ones((emb.shape[1],) * 2, dtype=torch.bool, device=dev).tril()[None, None]
    hidden = q2.forward(p["backbone"], cfg.backbone, emb,
                        attn_mask=causal & mask[:, None, None, :])
    logits = hidden @ p["head"]["kernel"] + p["head"]["bias"]            # [B, L, V]

    # compaction puts each row's speech block at 2 + n_t: speech token i is
    # predicted from position 1 + n_t + i (the task slot for i = 0), and EOS
    # from the last speech slot
    n_t = batch.text_mask.sum(dim=1)                                     # [B]
    pred_pos = (1 + n_t)[:, None] + torch.arange(ts + 1, device=dev)[None, :]
    speech_logits = _gather_rows(logits, pred_pos)                       # [B, Ts+1, V]
    lengths = batch.speech_mask.sum(dim=1)
    idx = torch.arange(ts + 1, device=dev)[None, :]
    eos_col = torch.full((b, 1), cfg.eos_speech, dtype=torch.int64, device=dev)
    targets = torch.cat([batch.speech_tokens, eos_col], dim=1)
    tgt_mask = idx <= lengths[:, None]
    targets = torch.where(idx == lengths[:, None], cfg.eos_speech, targets)

    loss = _masked_nll(speech_logits, targets, tgt_mask)
    denom = torch.clamp(tgt_mask.sum(), min=1)
    acc = ((speech_logits.argmax(dim=-1) == targets) & tgt_mask).sum() / denom
    metrics = {"loss": loss, "acc": acc}

    # multi-token-prediction heads: head j predicts token t+2+j from the
    # hidden state at t, trained jointly with the main head
    if "mtp_heads" in p:
        speech_hidden = _gather_rows(hidden, pred_pos)                   # [B, Ts+1, H]
        mtp_total = torch.zeros((), dtype=torch.float32, device=dev)
        for j, head in enumerate(p["mtp_heads"]):
            shift = j + 1
            logits_j = speech_hidden[:, : ts + 1 - shift] @ head["kernel"] + head["bias"]
            mtp_total = mtp_total + _masked_nll(logits_j, targets[:, shift:],
                                                tgt_mask[:, shift:])
        mtp_loss = mtp_total / len(p["mtp_heads"])
        metrics["mtp_loss"] = mtp_loss
        loss = loss + mtp_loss
        metrics["loss"] = loss
    return loss, metrics


# ------------------------------------------------------------------ optimizer


def _f32(x) -> np.float32:
    return np.float32(x)


def lr_schedule(learning_rate: float, scheduler: str, warmup_steps: int,
                total_steps: int) -> Callable[[int], float]:
    """step count → learning rate, optax's schedules in f32: ``constant``;
    ``warmup_cosine`` (``warmup_cosine_decay_schedule(0, lr, warmup,
    total)``: linear from 0, then a cosine to 0); ``warmuplr`` (ESPnet:
    lr·min(s^-0.5, s·w^-1.5)·w^0.5 with s = max(step, 1))."""
    if scheduler == "constant":
        return lambda count: learning_rate
    if scheduler == "warmup_cosine":
        if total_steps <= warmup_steps:
            # a decay of length ≤ 0 collapses the LR to ~0 right after
            # warmup: a config that "trains" while making no progress
            raise ValueError(
                "scheduler='warmup_cosine' requires total_steps > "
                f"warmup_steps (got total_steps={total_steps}, "
                f"warmup_steps={warmup_steps}); set train.total_steps")
        peak, decay = _f32(learning_rate), total_steps - warmup_steps

        def warmup_cosine(count: int) -> float:
            if count < warmup_steps:
                frac = _f32(1) - _f32(count) / _f32(warmup_steps)
                return float(-peak * frac + peak)
            c = _f32(min(count - warmup_steps, decay))
            return float(peak * (_f32(0.5) * (_f32(1) + np.cos(_f32(np.pi) * c / _f32(decay)))))

        return warmup_cosine
    if scheduler == "warmuplr":
        w = _f32(max(warmup_steps, 1))

        def warmuplr(count: int) -> float:
            s = _f32(max(count, 1))
            return float(_f32(learning_rate) * min(s ** _f32(-0.5), s * w ** _f32(-1.5))
                         * w ** _f32(0.5))

        return warmuplr
    raise ValueError(f"unknown scheduler {scheduler!r}")


def global_norm(tensors: List[torch.Tensor]) -> torch.Tensor:
    """sqrt(Σ over tensors of Σ x²) as an f32 scalar (optax.global_norm)."""
    return torch.sqrt(sum(torch.sum(t.float() * t.float()) for t in tensors))


class Optimizer:
    """AdamW (b1 0.9, b2 0.999, eps 1e-8) behind a global-norm clip, with a
    learning-rate schedule: optax's ``chain(clip_by_global_norm(clip),
    adamw(schedule, ...))``. :meth:`init` gives the ``torch.optim.AdamW``
    over a tree's leaves; :meth:`update` applies one step in place.

    As in optax, the clip scales by ``max_norm / g_norm`` only when
    ``g_norm ≥ max_norm`` (``clip_grad_norm_`` adds 1e-6 to the norm), and
    the schedule reads the step count before it increments, so a warmup
    from 0 makes the first update a no-op."""

    def __init__(self, schedule: Callable[[int], float], *, grad_clip: float,
                 weight_decay: float):
        self.schedule, self.grad_clip, self.weight_decay = schedule, grad_clip, weight_decay

    def init(self, params) -> torch.optim.AdamW:
        return torch.optim.AdamW(tree_leaves(params), lr=0.0, betas=(0.9, 0.999), eps=1e-8,
                                 weight_decay=self.weight_decay)

    def update(self, grads: List[torch.Tensor], opt: torch.optim.AdamW, count: int) -> None:
        """Clip ``grads`` (one per leaf, in the order :meth:`init` took) and
        apply the update of step ``count`` to the leaves."""
        g_norm = global_norm(grads)
        trigger = g_norm < self.grad_clip
        leaves = opt.param_groups[0]["params"]
        for p, g in zip(leaves, grads):
            p.grad = torch.where(trigger, g, g / g_norm * self.grad_clip)
        opt.param_groups[0]["lr"] = self.schedule(count)
        opt.step()
        for p in leaves:
            p.grad = None


def make_optimizer(learning_rate: float = 1e-5, *, grad_clip: float = 5.0,
                   scheduler: str = "constant", warmup_steps: int = 0, total_steps: int = 0,
                   weight_decay: float = 0.0) -> Optimizer:
    """AdamW + global-norm clip (greek_sft.yaml:94-103 'constantlr', clip 5)."""
    return Optimizer(lr_schedule(learning_rate, scheduler, warmup_steps, total_steps),
                     grad_clip=grad_clip, weight_decay=weight_decay)


# ----------------------------------------------------------------- the step


def init_train_state(seed: int, cfg: cv.SpeechLMConfig, optimizer: Optimizer, *,
                     device=None, params=None) -> TrainState:
    """Step 0: the speech LM's seeded f32 parameters on ``device`` (the card
    unless ``"cpu"``; MTP heads when ``cfg.mtp`` > 1), or ``params`` when
    given (a tree of f32 tensors, e.g. ``cosyvoice.from_jax_params``), and
    fresh AdamW moments."""
    if params is None:
        r = Init(seed, resolve_device(device))
        params = cv.init_speech_lm(r, cfg)
        if cfg.mtp > 1:
            params["mtp_heads"] = cv.init_mtp_heads(r, cfg)
    for leaf in tree_leaves(params):
        leaf.requires_grad_(True)
    return TrainState(0, params, optimizer.init(params))


def build_step_fn(cfg: cv.SpeechLMConfig, optimizer: Optimizer, *, accum_grad: int = 4,
                  compute_dtype=torch.bfloat16):
    """The train step ``(state, batch) → (state, metrics)``: ``batch``'s
    leaves are [accum, B, ...]; the microbatches' gradients are summed,
    divided by ``accum_grad`` and applied in one update of the state's
    parameters, in place. ``grad_norm`` is the norm of that averaged gradient
    before clipping; the other metrics average over the microbatches."""
    has_mtp = cfg.mtp > 1

    def step_fn(state: TrainState, batch: SFTBatch):
        leaves = tree_leaves(state.params)
        dev = leaves[0].device
        grads = None
        loss_sum = acc_sum = mtp_sum = 0.0
        for i in range(len(batch.text_tokens)):
            mb = batch_to(SFTBatch(*(x[i] for x in batch)), dev)
            loss, metrics = lm_loss(state.params, cfg, mb, compute_dtype=compute_dtype)
            g = torch.autograd.grad(loss, leaves, allow_unused=True)
            g = [torch.zeros_like(p) if gi is None else gi for p, gi in zip(leaves, g)]
            grads = g if grads is None else [a.add_(b) for a, b in zip(grads, g)]
            loss_sum = loss_sum + loss.detach()
            acc_sum = acc_sum + metrics["acc"]
            if has_mtp:
                mtp_sum = mtp_sum + metrics["mtp_loss"].detach()
        grads = [g / accum_grad for g in grads]
        gnorm = global_norm(grads)
        with torch.no_grad():
            optimizer.update(grads, state.opt_state, state.step)
        out = {"loss": loss_sum / accum_grad, "acc": acc_sum / accum_grad, "grad_norm": gnorm}
        if has_mtp:
            out["mtp_loss"] = mtp_sum / accum_grad
        return TrainState(state.step + 1, state.params, state.opt_state), out

    return step_fn


def make_train_step(cfg: cv.SpeechLMConfig, optimizer: Optimizer, mesh=None, *,
                    accum_grad: int = 4, compute_dtype=torch.bfloat16):
    """The train step of :func:`build_step_fn` on one device. A ``mesh`` (the
    JAX package's data-parallel step) is not ported yet and raises."""
    if mesh is not None:
        from ..pipeline.torch_engines import _not_ported

        raise _not_ported("make_train_step(mesh=...)", 12)
    return build_step_fn(cfg, optimizer, accum_grad=accum_grad, compute_dtype=compute_dtype)


def eval_step(cfg: cv.SpeechLMConfig, *, compute_dtype=torch.bfloat16):
    """CV metrics (the reference's ``CV info`` lines): ``fn(params, batch)``
    → lm_loss's metrics, without gradients."""

    def fn(params, batch: SFTBatch) -> Dict[str, torch.Tensor]:
        dev = tree_leaves(params)[0].device
        with torch.no_grad():
            _, metrics = lm_loss(params, cfg, batch_to(batch, dev), compute_dtype=compute_dtype)
        return metrics

    return fn

