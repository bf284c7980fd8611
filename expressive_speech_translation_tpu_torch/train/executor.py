"""Training executor: the epoch/step loop gluing data, step fn, CV, checkpoints
(the port of the JAX package's ``train/executor.py``; one device, the card
unless ``device="cpu"``).

Behavioural parity with the CosyVoice executor the reference drives through
``torchrun … cosyvoice/bin/train.py`` (train_greek.sh:13, SURVEY.md §3.4):
"TRAIN Batch E/S loss … acc … grad_norm" lines every ``log_interval`` steps,
CV at each epoch end + every ``save_per_step`` steps, checkpoint per CV point,
deterministic resume from the latest checkpoint.
"""

from __future__ import annotations

import logging
import time
from typing import Callable, Iterable, Iterator, Optional

import numpy as np
import torch

from ..core.buckets import bucket_size
from ..core.config import TrainConfig
from ..core.device import resolve_device
from ..models import cosyvoice as cv
from .checkpoint import CheckpointManager
from .data import DynamicFrameBatcher, filter_samples, pad_batch, shuffle_buffer, sort_buffer
from .sft import SFTBatch, TrainState, eval_step, init_train_state, make_optimizer, make_train_step

log = logging.getLogger(__name__)

# The two ladders below bound the JAX package's compiles; the port keeps them
# so both packages form the same batches from the same samples.
#
# Sequence-length ladder: covers the filter's 2000-frame admission ceiling
# with intermediate rungs (768/1536) so 20-80 s utterances pack in pairs
# (768×2 = 1536 ≤ the 2000-frame budget) instead of doubling straight to a
# one-sample 1024/2048 batch that is mostly padding.
LENGTH_BUCKETS = (32, 64, 128, 200, 256, 512, 768, 1024, 1536, 2048)
# Batch-row ladder: group sizes from the dynamic batcher vary with sort-block
# boundaries and epoch tails; every distinct B would otherwise recompile the
# whole scanned pjit step. Rows are cycled up to the next rung (mean-reduced
# loss → duplicates only reweight slightly, the rows_multiple tradeoff);
# ~max 33% row overhead from the 3/6/12/24 intermediate rungs.
BATCH_ROW_BUCKETS = (1, 2, 3, 4, 6, 8, 12, 16, 24, 32, 48, 64)


def batches_from_samples(
    samples: Iterable[dict],
    cfg: TrainConfig,
    *,
    accum: int,
    seed: int,
    rows_multiple: int = 1,
) -> Iterator[SFTBatch]:
    """samples (dicts with text_tokens / speech_tokens) → padded SFTBatches with
    a leading accum dim, mirroring the yaml pipeline stages (shuffle → sort →
    dynamic batch → padding)."""
    stream = filter_samples(
        samples, max_frames=cfg.max_frames_in_batch, token_max_length=cfg.token_max_length,
    )
    stream = shuffle_buffer(stream, cfg.shuffle_buffer, seed=seed)
    stream = sort_buffer(stream, cfg.sort_buffer)
    batcher = DynamicFrameBatcher(cfg.max_frames_in_batch, pad_to_bucket=LENGTH_BUCKETS)

    # Microbatches inside one step share shapes (a step stacks them), so
    # accumulate per shape signature and emit once `accum` of one shape exist.
    by_shape: dict = {}
    for group in batcher(stream):
        # round rows up to the batch ladder and the dp multiple
        target = bucket_size(len(group), BATCH_ROW_BUCKETS)
        if target % rows_multiple:
            target += rows_multiple - target % rows_multiple
        if target > len(group):
            # repeat samples cyclically (loss is mean-reduced, so duplicates
            # only reweight slightly — same tradeoff as the dp round-up)
            deficit = target - len(group)
            group = group + [group[i % len(group)] for i in range(deficit)]
        arrays = pad_batch(group, ("text_tokens", "speech_tokens"), buckets=LENGTH_BUCKETS)
        mb = SFTBatch(
            text_tokens=arrays["text_tokens"].astype(np.int32),
            text_mask=arrays["text_tokens_mask"],
            speech_tokens=arrays["speech_tokens"].astype(np.int32),
            speech_mask=arrays["speech_tokens_mask"],
        )
        sig = mb.text_tokens.shape + mb.speech_tokens.shape
        by_shape.setdefault(sig, []).append(mb)
        if len(by_shape[sig]) == accum:
            yield SFTBatch(*[np.stack(x) for x in zip(*by_shape.pop(sig))])
    # flush leftovers: CYCLE the real microbatches up to `accum` so small
    # datasets and epoch tails still train with evenly weighted gradients
    # (indexing by the growing length repeated micros[0] only, tripling its
    # gradient weight at every epoch tail)
    for sig, micros in by_shape.items():
        n_real = len(micros)
        while len(micros) < accum:
            micros.append(micros[len(micros) % n_real])
        yield SFTBatch(*[np.stack(x) for x in zip(*micros[:accum])])


class Executor:
    """Minimal, deterministic epoch loop."""

    def __init__(
        self,
        lm_cfg: cv.SpeechLMConfig,
        train_cfg: TrainConfig,
        *,
        mesh=None,
        checkpoint_dir: Optional[str] = None,
        device=None,
    ):
        self.lm_cfg = lm_cfg
        self.device = resolve_device(device)
        self.cfg = train_cfg
        self.optimizer = make_optimizer(
            train_cfg.learning_rate,
            grad_clip=train_cfg.grad_clip,
            scheduler=train_cfg.scheduler,
            warmup_steps=train_cfg.warmup_steps,
            total_steps=train_cfg.total_steps,
        )
        self.train_step = make_train_step(
            lm_cfg, self.optimizer, mesh, accum_grad=train_cfg.accum_grad
        )
        # across processes every rank keeps the same replicated state; rank 0
        # alone writes the checkpoints
        dist = torch.distributed
        self.writes = not (dist.is_available() and dist.is_initialized() and dist.get_rank())
        self.eval_fn = eval_step(lm_cfg)
        self.ckpt = CheckpointManager(
            checkpoint_dir or train_cfg.checkpoint_dir,
            keep=train_cfg.keep_checkpoints,
            save_interval_steps=train_cfg.save_per_step,
        ) if checkpoint_dir is not False else None

    def init_or_resume(self, params=None) -> TrainState:
        """The seeded init (``train.seed``), or ``params`` when given (an f32
        tree on the executor's device), then the latest checkpoint over it."""
        state = init_train_state(self.cfg.seed, self.lm_cfg, self.optimizer,
                                 device=self.device, params=params)
        self._resume_meta: dict = {}
        if self.ckpt is not None:
            restored = self.ckpt.restore(state)
            if restored is not None:
                # data-schedule position for train(): which epoch the run
                # died in and the step count at that epoch's start, so the
                # resumed run continues instead of replaying from epoch 0
                self._resume_meta = self.ckpt.load_meta()
                return restored
        return state

    def cv(self, state: TrainState, cv_batches: Iterable[SFTBatch]) -> dict:
        totals, n = {}, 0
        for batch in cv_batches:
            flat = SFTBatch(*[x.reshape(-1, *x.shape[2:]) if x.ndim > 2 else x for x in batch])
            m = self.eval_fn(state.params, flat)
            for k, v in m.items():
                totals[k] = totals.get(k, 0.0) + float(v)
            n += 1
        return {k: v / max(n, 1) for k, v in totals.items()}

    def train(
        self,
        state: TrainState,
        epoch_batches: Callable[[int], Iterable[SFTBatch]],
        *,
        cv_batches: Callable[[], Iterable[SFTBatch]] = lambda: (),
        max_epochs: Optional[int] = None,
        metric_sink: Optional[Callable[[dict], None]] = None,
    ) -> TrainState:
        """``metric_sink``: optional per-log-interval structured-metrics hook
        (an ``obs.kvlogger`` output's ``writekvs``) — the stand-in
        for the reference executor's TensorBoard writer (cosyvoice
        train_utils); receives train rows tagged ``phase="train"`` and CV
        rows tagged ``phase="cv"``."""
        max_epochs = max_epochs or self.cfg.max_epochs
        t_last = time.perf_counter()
        # crash-resume: continue from the interrupted epoch, skipping the
        # batches it already trained (the per-epoch stream is seeded, so the
        # skip is deterministic); completed epochs are never replayed
        resume = getattr(self, "_resume_meta", {}) or {}
        start_epoch = int(resume.get("epoch", 0))
        skip_first = max(int(state.step) - int(resume.get("epoch_start_step",
                                                          state.step)), 0)
        if start_epoch or skip_first:
            log.info("resuming at epoch %d (+%d batches already trained)",
                     start_epoch, skip_first)
        self._resume_meta = {}
        for epoch in range(start_epoch, max_epochs):
            if self.ckpt is not None and self.writes:
                self.ckpt.save_meta({"epoch": epoch,
                                     "epoch_start_step": int(state.step) - skip_first})
            to_skip = skip_first
            skip_first = 0
            for batch in epoch_batches(epoch):
                if to_skip:
                    to_skip -= 1
                    continue
                state, metrics = self.train_step(state, batch)
                step = int(state.step)
                if step % self.cfg.log_interval == 0:
                    rate = self.cfg.log_interval / max(time.perf_counter() - t_last, 1e-9)
                    t_last = time.perf_counter()
                    log.info(
                        "TRAIN Batch %d/%d loss %.6f acc %.6f grad_norm %.4f (%.2f it/s)",
                        epoch, step, float(metrics["loss"]), float(metrics["acc"]),
                        float(metrics["grad_norm"]), rate,
                    )
                    if metric_sink is not None:
                        metric_sink({
                            "phase": "train", "epoch": epoch, "step": step,
                            "loss": float(metrics["loss"]),
                            "acc": float(metrics["acc"]),
                            "grad_norm": float(metrics["grad_norm"]),
                            "it_per_s": round(rate, 3),
                        })
                if (self.ckpt is not None and self.writes
                        and step % self.cfg.save_per_step == 0):
                    cvm = self.cv(state, cv_batches())
                    if cvm:
                        log.info(
                            "Epoch %d Step %d CV info loss %.6f acc %.6f",
                            epoch, step, cvm.get("loss", float("nan")), cvm.get("acc", float("nan")),
                        )
                        if metric_sink is not None:
                            metric_sink({"phase": "cv", "epoch": epoch,
                                         "step": step, **cvm})
                    self.ckpt.save(state, metrics=cvm)
            cvm = self.cv(state, cv_batches())
            if cvm:
                log.info(
                    "Epoch %d Step %d CV info loss %.6f acc %.6f",
                    epoch, int(state.step), cvm.get("loss", float("nan")), cvm.get("acc", float("nan")),
                )
                if metric_sink is not None:
                    metric_sink({"phase": "cv", "epoch": epoch,
                                 "step": int(state.step), **cvm})
            if self.ckpt is not None and self.writes:
                self.ckpt.save(state, metrics=cvm, force=True)
        if self.ckpt is not None:
            self.ckpt.wait()
        return state
