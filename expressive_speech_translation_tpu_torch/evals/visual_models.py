"""Learned-model seam for the visual eval battery (the port's copy of the
JAX package's ``evals/visual_models.py``; a TorchScript member runs on the
card unless the registry is asked for ``device="cpu"``).

The reference's battery runs real learned models — DeepFace visual emotion,
ArcFace identity embeddings, DFDC deepfake classifier
(Evaluation/analyze_outputs.py:177-426). In a weightless environment the
battery falls back to the classical proxies in :mod:`.visual_metrics`
(ordering-valid only); this module is the discovery seam that swaps the real
models in when weights are mounted — the exact pattern the semantic scorers
already have (evals/semantic.py:39-62: checkpoint under ``$EST_MODELS_DIR``,
proxy/NaN otherwise).

Discovery: each battery member looks for a mounted checkpoint directory

  ``$EST_MODELS_DIR/arcface``         → face-identity embedder
  ``$EST_MODELS_DIR/visual_emotion``  → per-clip emotion classifier
  ``$EST_MODELS_DIR/deepfake``        → per-clip fake probability

Each directory must hold a ``config.json`` with a ``"format"`` key naming a
registered loader:

  ``{"format": "torchscript", "file": "model.pt", ...}``
      → ``torch.jit.load`` onto the registry's device; the scripted module
        maps a float32 tensor
        (identity: [1,3,S,S] face crop; emotion/deepfake: [1,T,H,W,3] clip)
        to an embedding / logits over ``config["labels"]`` / a scalar logit.
  ``{"format": "hf_image_classification"}``
      → a local HF image-classification pipeline (emotion only).

Callers never touch this module's internals: :mod:`.visual_metrics` asks
:func:`registry` for a member and uses the proxy when it is ``None``. Tests
and downstream users with bespoke models can also inject callables directly
via :meth:`VisualModels.provide` — proving the dispatch without weights.
"""

from __future__ import annotations

import json
import logging
import os
from dataclasses import dataclass, field
from pathlib import Path
from typing import Callable, Dict, Optional

import numpy as np
import torch

from ..core.device import resolve_device

log = logging.getLogger(__name__)

# member name → EST_MODELS_DIR subdir
MEMBERS = ("arcface", "visual_emotion", "deepfake")


def _load_torchscript(d: Path, cfg: dict, member: str, device: torch.device) -> Callable:
    mod = torch.jit.load(str(d / cfg.get("file", "model.pt")), map_location=device)
    mod.eval()
    labels = cfg.get("labels")

    def fn(x: np.ndarray):
        with torch.no_grad():
            t = torch.from_numpy(np.ascontiguousarray(x, dtype=np.float32)).to(device)
            if member == "arcface":
                # contract is [1,3,S,S] (NCHW — what real ArcFace exports
                # take); the battery hands crops as [S,S,3]
                t = t.permute(2, 0, 1)
            out = mod(t[None]).squeeze(0).cpu().numpy()
        if member == "arcface":
            return np.asarray(out, np.float32).reshape(-1)
        if member == "visual_emotion":
            idx = int(np.argmax(np.asarray(out).reshape(-1)))
            return labels[idx] if labels else str(idx)
        # deepfake: scalar logit → probability
        v = float(np.asarray(out).reshape(-1)[0])
        return float(1.0 / (1.0 + np.exp(-v)))

    return fn


def _load_hf_image_classification(d: Path, cfg: dict, member: str,
                                  device: torch.device) -> Callable:
    if member != "visual_emotion":
        raise ValueError("hf_image_classification only backs visual_emotion")
    from transformers import pipeline

    pipe = pipeline("image-classification", model=str(d), device=device)

    def fn(frames: np.ndarray) -> str:
        # classify the middle frame (DeepFace samples frames the same way —
        # analyze_outputs.py:186-196 takes per-frame dominant emotions)
        from PIL import Image

        mid = np.asarray(frames[len(frames) // 2], np.uint8)
        return pipe(Image.fromarray(mid))[0]["label"]

    return fn


_LOADERS: Dict[str, Callable[[Path, dict, str, torch.device], Callable]] = {
    "torchscript": _load_torchscript,
    "hf_image_classification": _load_hf_image_classification,
}


@dataclass
class VisualModels:
    """Resolved battery members. ``None`` → classical proxy is used.

    - ``identity(crop [S,S,3] float32 [0,1]) -> embedding [D]``
    - ``emotion(frames [T,H,W,3] uint8) -> label``
    - ``deepfake(frames [T,H,W,3] uint8) -> probability in [0,1]``
    """

    identity: Optional[Callable[[np.ndarray], np.ndarray]] = None
    emotion: Optional[Callable[[np.ndarray], str]] = None
    deepfake: Optional[Callable[[np.ndarray], float]] = None
    _provided: Dict[str, bool] = field(default_factory=dict)

    def provide(self, member: str, fn: Optional[Callable]) -> None:
        """Inject a learned model directly (tests / bespoke deployments)."""
        attr = {"arcface": "identity", "visual_emotion": "emotion",
                "deepfake": "deepfake"}[member]
        setattr(self, attr, fn)
        self._provided[member] = fn is not None

    def sources(self) -> Dict[str, str]:
        """'learned' vs 'proxy' per member — surfaced as the CSV's
        ``visual_battery_sources`` column so downstream analysis can never
        mistake a proxy ordering for a learned absolute score."""
        return {
            "identity": "learned" if self.identity else "proxy",
            "emotion": "learned" if self.emotion else "proxy",
            "deepfake": "learned" if self.deepfake else "proxy",
        }


_registry: Optional[VisualModels] = None


def registry(device=None) -> VisualModels:
    """Singleton with lazy checkpoint discovery (one disk scan per process);
    mounted members load onto ``device`` (the card unless ``device="cpu"``)
    at the first call."""
    global _registry
    if _registry is None:
        _registry = _discover(device)
    return _registry


def _reset() -> None:
    """Drop the cached registry (tests re-discover after env changes)."""
    global _registry
    _registry = None


def _discover(device=None) -> VisualModels:
    models = VisualModels()
    root = os.environ.get("EST_MODELS_DIR")
    if not root:
        return models
    for member in MEMBERS:
        d = Path(root) / member
        cfg_path = d / "config.json"
        if not cfg_path.exists():
            continue
        # resolved outside the try: a missing card raises, it never reads
        # as a member that failed to load
        dev = resolve_device(device)
        try:
            cfg = json.loads(cfg_path.read_text())
            fmt = cfg.get("format", "")
            if fmt not in _LOADERS:
                raise ValueError(f"unknown visual-model format {fmt!r}")
            models.provide(member, _LOADERS[fmt](d, cfg, member, dev))
            log.info("visual battery: learned %s from %s (%s)", member, d, fmt)
        except Exception as e:  # noqa: BLE001 — battery degrades to the proxy
            log.warning("visual battery: %s load failed (%s); using proxy",
                        member, e)
    return models
