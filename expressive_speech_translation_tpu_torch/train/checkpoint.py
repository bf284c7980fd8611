"""Training checkpoints in the port's safetensors format, with deterministic
resume (the port of the JAX package's ``train/checkpoint.py``, whose orbax
the card's machine does not have).

Replaces the reference's ``epoch_N_whole.pt`` torch saves (training_log.txt:6,
save_per_step 1000, greek_sft.yaml:103), including surviving the recorded
crash-resume story (the reference's first run died mid-save with ENOSPC and
was resumed from the last complete checkpoint, SURVEY.md §5.4): each step is
written to a temporary directory and renamed into place, so a killed save can
never corrupt the latest complete step.

Layout: ``<dir>/<step>/state.safetensors`` holds the f32 parameters under
``params.<path>``, the AdamW moments under ``mu.<path>`` / ``nu.<path>``
(``<path>`` the tree's ``.``-joined key path, as the bake flattens it) and
the step; ``<dir>/<step>/metrics.json`` the metrics. The save policy is
orbax's: the first save always, then one at every ``save_interval_steps``-th
step after the latest, any step when forced; ``max_to_keep`` keeps the
highest steps.
"""

from __future__ import annotations

import json
import logging
import os
import shutil
from pathlib import Path
from typing import List, Optional

import torch

from ..models.loaders import _flatten
from ..models.safetensors_io import read_safetensors, write_safetensors
from .sft import TrainState

log = logging.getLogger(__name__)

STATE_FILE = "state.safetensors"


class CheckpointManager:
    def __init__(self, directory: str | Path, *, keep: int = 10, save_interval_steps: int = 1000):
        self.directory = Path(directory).absolute()
        self.directory.mkdir(parents=True, exist_ok=True)
        self.keep = keep
        self.save_interval_steps = save_interval_steps

    def all_steps(self) -> List[int]:
        """The complete checkpoints' steps, ascending."""
        return sorted(int(p.name) for p in self.directory.iterdir()
                      if p.name.isdigit() and (p / STATE_FILE).exists())

    def latest_step(self) -> Optional[int]:
        steps = self.all_steps()
        return steps[-1] if steps else None

    def _should_save(self, step: int) -> bool:
        latest = self.latest_step()
        if latest is None:
            return True
        return step > latest and step % self.save_interval_steps == 0

    def save(self, state: TrainState, *, metrics: Optional[dict] = None,
             force: bool = False) -> bool:
        step = int(state.step)
        if step in self.all_steps():  # re-saving a step is a no-op
            return False
        if not force and not self._should_save(step):
            return False
        tensors = {"step": torch.tensor(step, dtype=torch.int64)}
        opt = state.opt_state.state
        for path, p in _flatten(state.params, "", {}).items():
            moments = opt.get(p, {})
            tensors[f"params.{path}"] = p
            tensors[f"mu.{path}"] = moments.get("exp_avg", torch.zeros_like(p))
            tensors[f"nu.{path}"] = moments.get("exp_avg_sq", torch.zeros_like(p))
        tmp = self.directory / f".tmp-{step}"
        shutil.rmtree(tmp, ignore_errors=True)
        tmp.mkdir()
        write_safetensors(tensors, tmp / STATE_FILE)
        (tmp / "metrics.json").write_text(
            json.dumps({k: float(v) for k, v in (metrics or {}).items()}))
        os.replace(tmp, self.directory / str(step))
        for old in self.all_steps()[:-self.keep]:
            shutil.rmtree(self.directory / str(old))
        log.info("saved checkpoint step %d -> %s", step, self.directory)
        return True

    # ------------------------------------------------------- resume position
    #
    # The checkpoint carries params/moments/step but not WHERE in the data
    # schedule the run was: without (epoch, epoch_start_step) a crash-resume
    # restarts `for epoch in range(max_epochs)` from 0 and re-trains every
    # completed epoch a second time — double the configured budget and a
    # silently shifted LR schedule. The position rides a tiny JSON sidecar
    # (atomic rename, same crash posture as the checkpoint writes).

    def save_meta(self, meta: dict) -> None:
        tmp = self.directory / ".meta.json.tmp"
        tmp.write_text(json.dumps(meta))
        os.replace(tmp, self.directory / "meta.json")

    def load_meta(self) -> dict:
        path = self.directory / "meta.json"
        if not path.exists():
            return {}
        try:
            return json.loads(path.read_text())
        except ValueError:
            log.warning("unreadable checkpoint meta at %s — resuming from epoch 0", path)
            return {}

    def restore(self, template: TrainState, step: Optional[int] = None) -> Optional[TrainState]:
        """The checkpoint of ``step`` (default: the latest) copied into
        ``template``'s parameters and optimizer, bit for bit; None when there
        is no checkpoint."""
        target = step if step is not None else self.latest_step()
        if target is None:
            return None
        saved = read_safetensors(self.directory / str(target) / STATE_FILE)
        restored = int(saved["step"])
        opt = template.opt_state
        with torch.no_grad():
            for path, p in _flatten(template.params, "", {}).items():
                p.copy_(saved[f"params.{path}"])
                opt.state[p] = {} if restored == 0 else {
                    "step": torch.tensor(float(restored)),
                    "exp_avg": saved[f"mu.{path}"].to(p.device),
                    "exp_avg_sq": saved[f"nu.{path}"].to(p.device)}
        log.info("restored checkpoint step %d from %s", target, self.directory)
        return TrainState(restored, template.params, opt)

    def wait(self):
        """Saves are synchronous; kept for the JAX package's interface."""

    def close(self):
        """Nothing to release; kept for the JAX package's interface."""
