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
- Data parallel (``make_train_step(mesh=...)``, the JAX package's pjit step
  over a (dp, tp) mesh) is the same step: the parameters are replicated on
  every dp group's lead, each group takes its share of the B rows, and the
  gradients are reduced onto the state's device and, across processes,
  all-reduced with ``torch.distributed``. The loss is the global batch's:
  each share's NLL sum over the global token count, so ranks holding
  different token counts give the one-device step.

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
from ..models.common import Init, cast_floats, dense
from ..parallel.mesh import make_mesh, run_per_group


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


def _masked_nll(logits: torch.Tensor, targets: torch.Tensor, mask: torch.Tensor,
                count: torch.Tensor) -> torch.Tensor:
    """Σ of the f32 token NLL over ``mask``, divided by max(count, 1)."""
    logp = torch.log_softmax(logits.float(), dim=-1)
    nll = -torch.gather(logp, -1, targets[..., None])[..., 0]
    return (nll * mask).sum() / torch.clamp(count, min=1)


def _target_mask(batch: SFTBatch) -> torch.Tensor:
    """[B, Ts + 1]: the speech tokens and the EOS after them."""
    ts = batch.speech_tokens.shape[1]
    idx = torch.arange(ts + 1, device=batch.speech_tokens.device)[None, :]
    return idx <= batch.speech_mask.sum(dim=1)[:, None]


def token_counts(batch: SFTBatch, cfg: cv.SpeechLMConfig) -> torch.Tensor:
    """The loss's denominators of a batch of tensors, int64 [1 + MTP heads]:
    the target tokens of the main head, then of MTP head j (targets from
    position j + 1 on)."""
    m = _target_mask(batch)
    return torch.stack([m.sum()] + [m[:, j + 1:].sum() for j in range(max(cfg.mtp - 1, 0))])


def lm_loss(params: Any, cfg: cv.SpeechLMConfig, batch: SFTBatch, *,
            compute_dtype=torch.bfloat16,
            counts: Any = None) -> Tuple[torch.Tensor, Dict[str, torch.Tensor]]:
    """Teacher-forced next-token CE over the speech segment (+ EOS) of a
    batch of tensors (:func:`batch_to`). → (loss, {"loss", "acc"[,
    "mtp_loss"]}), each an f32 scalar tensor. ``counts``
    (:func:`token_counts` of a larger batch this one is a share of)
    replaces the batch's own denominators, so the shares' losses add up to
    the whole batch's."""
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
    logits = dense(p["head"], hidden)                                    # [B, L, V]

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
    tgt_mask = _target_mask(batch)
    targets = torch.where(idx == lengths[:, None], cfg.eos_speech, targets)
    counts = token_counts(batch, cfg) if counts is None else counts.to(dev)

    loss = _masked_nll(speech_logits, targets, tgt_mask, counts[0])
    denom = torch.clamp(counts[0], min=1)
    acc = ((speech_logits.argmax(dim=-1) == targets) & tgt_mask).sum() / denom
    metrics = {"loss": loss, "acc": acc}

    # multi-token-prediction heads: head j predicts token t+2+j from the
    # hidden state at t, trained jointly with the main head
    if "mtp_heads" in p:
        speech_hidden = _gather_rows(hidden, pred_pos)                   # [B, Ts+1, H]
        mtp_total = torch.zeros((), dtype=torch.float32, device=dev)
        for j, head in enumerate(p["mtp_heads"]):
            shift = j + 1
            logits_j = dense(head, speech_hidden[:, : ts + 1 - shift])
            mtp_total = mtp_total + _masked_nll(logits_j, targets[:, shift:],
                                                tgt_mask[:, shift:], counts[shift])
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


def build_step_fn(cfg: cv.SpeechLMConfig, optimizer: Optimizer, mesh=None, *,
                  accum_grad: int = 4, compute_dtype=torch.bfloat16):
    """The train step ``(state, batch) → (state, metrics)``: ``batch``'s
    leaves are [accum, B, ...]; the microbatches' gradients are summed,
    divided by ``accum_grad`` and applied in one update of the state's
    parameters, in place. ``grad_norm`` is the norm of that averaged gradient
    before clipping; the other metrics average over the microbatches.

    Data parallel over ``mesh``'s dp groups (the JAX package's step with
    replicated parameters and the batch's B dimension split over dp; its tp
    axis only replicates); without a mesh, one group on the state's device.
    Every process passes the global batch; dp group g takes rows
    [g·B/dp, (g + 1)·B/dp) of each microbatch, and a process runs the groups
    it owns, one thread a group, each on its replica of the parameters: the
    state's own on the state's device, elsewhere a copy kept from step to
    step and refreshed in place. Each share's loss is its NLL sum over the
    whole microbatch's token counts, so the shares' gradients add up to the
    one-device step's: each group sums its microbatches on its card, the
    groups' sums are reduced onto the state's device (NCCL between cards)
    and, when the mesh spans processes, all-reduced with
    ``torch.distributed``. Every process then applies the same update to
    its replicated state."""
    has_mtp = cfg.mtp > 1
    copies: Dict[int, List[torch.Tensor]] = {}

    def replica(g: int, leaves: List[torch.Tensor], dev, own: bool) -> List[torch.Tensor]:
        if own:
            return leaves
        held = copies.get(g)
        if held is None or [t.shape for t in held] != [p.shape for p in leaves]:
            held = copies[g] = [torch.empty_like(p, device=dev).requires_grad_(True)
                                for p in leaves]
        with torch.no_grad():
            for t, p in zip(held, leaves):
                t.copy_(p)
        return held

    def step_fn(state: TrainState, batch: SFTBatch):
        leaves = tree_leaves(state.params)
        home = leaves[0].device
        m = mesh if mesh is not None else make_mesh(devices=[home])
        dp, groups = m.shape["dp"], m.local_groups()
        if not groups:
            raise ValueError(f"no dp group of {m} belongs to this process")
        b = len(batch.text_tokens[0])
        if b % dp:
            raise ValueError(f"batch rows {b} do not split over dp={dp}")
        share = b // dp
        micro = [SFTBatch(*(x[i] for x in batch)) for i in range(len(batch.text_tokens))]
        counts = [token_counts(batch_to(mb, home), cfg) for mb in micro]

        def group_grads(g: int):
            dev = m.lead(g)
            params = replica(g, leaves, dev, g == groups[0] and dev == home)
            tree = _like(state.params, iter(params))
            grads, stats = None, None
            for mb, n in zip(micro, counts):
                rows = batch_to(SFTBatch(*(x[g * share:(g + 1) * share] for x in mb)), dev)
                loss, metrics = lm_loss(tree, cfg, rows, compute_dtype=compute_dtype, counts=n)
                got = torch.autograd.grad(loss, params, allow_unused=True)
                got = [torch.zeros_like(p) if gi is None else gi for p, gi in zip(params, got)]
                grads = got if grads is None else [a.add_(c) for a, c in zip(grads, got)]
                now = [loss.detach(), metrics["acc"].detach().float()]
                if has_mtp:
                    now.append(metrics["mtp_loss"].detach())
                stats = now if stats is None else [a + c for a, c in zip(stats, now)]
            return grads + stats

        sums = _reduce_to(run_per_group(group_grads, [(g,) for g in groups]), home)
        if len(groups) < dp:
            sums = _all_reduce(sums)
        grads, totals = sums[:len(leaves)], sums[len(leaves):]
        grads = [g / accum_grad for g in grads]
        gnorm = global_norm(grads)
        with torch.no_grad():
            optimizer.update(grads, state.opt_state, state.step)
        out = {"loss": totals[0] / accum_grad, "acc": totals[1] / accum_grad,
               "grad_norm": gnorm}
        if has_mtp:
            out["mtp_loss"] = totals[2] / accum_grad
        return TrainState(state.step + 1, state.params, state.opt_state), out

    return step_fn


def make_train_step(cfg: cv.SpeechLMConfig, optimizer: Optimizer, mesh=None, *,
                    accum_grad: int = 4, compute_dtype=torch.bfloat16):
    """The train step of :func:`build_step_fn`: on the state's device, or
    data-parallel over ``mesh``."""
    return build_step_fn(cfg, optimizer, mesh, accum_grad=accum_grad,
                         compute_dtype=compute_dtype)


def _reduce_to(parts: List[List[torch.Tensor]], home) -> List[torch.Tensor]:
    """Σ over the groups of each group's tensors (``parts[i][j]``: group
    i's tensor j, on its card), on ``home``: one group's are moved; the
    groups' on distinct cards, ``home`` among them, are reduced by NCCL
    (``torch.cuda.comm``), others copied and added."""
    if len(parts) == 1:
        return [t.to(home) for t in parts[0]]
    devices = [p[0].device for p in parts]
    if home in devices and home.type == "cuda" and all(d.type == "cuda" for d in devices) \
            and len(set(devices)) == len(devices):
        from torch.cuda import comm

        return list(comm.reduce_add_coalesced(parts, destination=home.index))
    return [sum(t.to(home) for t in ts) for ts in zip(*parts)]


def _all_reduce(tensors: List[torch.Tensor]) -> List[torch.Tensor]:
    """Σ over the processes of ``torch.distributed``, one flat f32 buffer
    for all the tensors."""
    flat = torch.cat([t.reshape(-1).float() for t in tensors])
    torch.distributed.all_reduce(flat)
    out, at = [], 0
    for t in tensors:
        out.append(flat[at:at + t.numel()].view_as(t).to(t.dtype))
        at += t.numel()
    return out


def _like(tree, leaves):
    """``tree``'s nesting with its leaves taken in order from ``leaves``."""
    if isinstance(tree, dict):
        return {k: _like(v, leaves) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return [_like(v, leaves) for v in tree]
    return next(leaves)


def eval_step(cfg: cv.SpeechLMConfig, *, compute_dtype=torch.bfloat16):
    """CV metrics (the reference's ``CV info`` lines): ``fn(params, batch)``
    → lm_loss's metrics, without gradients."""

    def fn(params, batch: SFTBatch) -> Dict[str, torch.Tensor]:
        dev = tree_leaves(params)[0].device
        with torch.no_grad():
            _, metrics = lm_loss(params, cfg, batch_to(batch, dev), compute_dtype=compute_dtype)
        return metrics

    return fn

