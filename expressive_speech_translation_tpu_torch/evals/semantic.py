"""Checkpoint-backed semantic scorers: sonar_score + bert_score_f1 (the
port's ``evals/semantic.py``, over the port's NLLB encoder on the card).

The reference's linguistic evaluation uses SONAR sentence similarity and
BERTScore (Evaluation/analyze_outputs.py:92-109). Both need model weights —
and SONAR's text encoder is itself an NLLB-derived transformer, so the same
baked NLLB checkpoint that serves translation (``EST_MODELS_DIR/nmt``, the
port's bake) can back both scores locally:

- ``sonar_score(a, b)`` — cosine similarity of mask-mean-pooled NLLB encoder
  sentence embeddings (the SONAR recipe: pooled encoder states).
- ``bert_score_f1(cand, ref)`` — BERTScore F1 over the contextual token
  embeddings: greedy max-cosine matching candidate→reference (precision) and
  reference→candidate (recall), F1 of the two (Zhang et al. 2020, computed
  with a local encoder instead of HF roberta).

No checkpoint mounted → ``available() is False`` and the analysis emits NaN.
The device is resolved when the scorer is built, apart from the weight
discovery, so a missing card raises instead of reading as "no weights".
"""

from __future__ import annotations

import logging
import os
from pathlib import Path
from typing import List, Optional

import numpy as np
import torch

from ..core.device import resolve_device

log = logging.getLogger(__name__)


class SemanticScorer:
    """NLLB-encoder-backed sentence/token embedding scorer on ``device`` (the
    card unless ``device="cpu"``).

    ``params/cfg/tokenizer`` may be supplied directly (``params`` on
    ``device``); by default the baked checkpoint at ``$EST_MODELS_DIR/nmt``
    is loaded lazily, matching the serving path's weight discovery."""

    def __init__(self, params=None, cfg=None, tokenizer=None,
                 models_dir: Optional[str] = None, *, device=None):
        self.device = resolve_device(device)
        self._params, self._cfg = params, cfg
        self._tok = tokenizer
        self._models_dir = models_dir
        self._tried = params is not None

    def _try_load(self) -> None:
        if self._tried:
            return
        self._tried = True
        root = self._models_dir or os.environ.get("EST_MODELS_DIR")
        if not root:
            return
        try:
            from ..models import nllb as nlm
            from ..models.loaders import load_converted

            self._params, self._cfg = load_converted(Path(root) / "nmt", nlm.NLLBConfig,
                                                     self.device)
            log.info("semantic scorer: NLLB encoder from %s/nmt", root)
        except Exception as e:  # noqa: BLE001 — scorer stays unavailable
            log.info("semantic scorer unavailable: %s", e)

    def available(self) -> bool:
        self._try_load()
        return self._params is not None

    @property
    def tokenizer(self):
        if self._tok is None:
            from ..pipeline.tokenizer import load_tokenizer

            # EST_TOKENIZER (SentencePiece/HF dir) when mounted, bytes otherwise
            self._tok = load_tokenizer(os.environ.get("EST_TOKENIZER"))
        return self._tok

    def _token_states(self, texts: List[str]):
        """texts → (states [N, T, D] float32, mask [N, T])."""
        from ..models import nllb as nlm

        ids = [self.tokenizer.encode(t)[:128] or [self._cfg.eos_token]
               for t in texts]
        width = max(8, max(len(i) for i in ids))
        toks = np.full((len(ids), width), self._cfg.pad_token, np.int64)
        for r, seq in enumerate(ids):
            toks[r, : len(seq)] = np.asarray(seq) % self._cfg.vocab_size
        with torch.inference_mode():
            states = nlm.encode(self._params, self._cfg,
                                torch.from_numpy(toks).to(self.device))
            states = states.float().cpu().numpy()
        mask = toks != self._cfg.pad_token
        return states, mask

    def embed_sentences(self, texts: List[str]) -> np.ndarray:
        """Mask-mean-pooled, L2-normalised sentence embeddings [N, D]."""
        states, mask = self._token_states(texts)
        pooled = (states * mask[..., None]).sum(1) / np.maximum(
            mask.sum(1, keepdims=True), 1)
        return pooled / np.maximum(
            np.linalg.norm(pooled, axis=-1, keepdims=True), 1e-9)

    def sonar_score(self, a: str, b: str) -> float:
        if not self.available():
            return float("nan")
        e = self.embed_sentences([a, b])
        return float(np.dot(e[0], e[1]))

    def bert_score_f1(self, candidate: str, reference: str) -> float:
        if not self.available():
            return float("nan")
        states, mask = self._token_states([candidate, reference])
        c = states[0][mask[0]]
        r = states[1][mask[1]]
        if not len(c) or not len(r):
            return float("nan")
        c = c / np.maximum(np.linalg.norm(c, axis=-1, keepdims=True), 1e-9)
        r = r / np.maximum(np.linalg.norm(r, axis=-1, keepdims=True), 1e-9)
        sim = c @ r.T                                    # [Tc, Tr]
        precision = float(sim.max(axis=1).mean())
        recall = float(sim.max(axis=0).mean())
        if precision + recall <= 0:
            return 0.0
        return 2 * precision * recall / (precision + recall)


_default_scorer: Optional[SemanticScorer] = None


def default_scorer(device=None) -> SemanticScorer:
    """The process's scorer on ``device`` (the card unless ``device="cpu"``),
    built again when asked for another device."""
    global _default_scorer
    if _default_scorer is None or _default_scorer.device != resolve_device(device):
        _default_scorer = SemanticScorer(device=device)
    return _default_scorer
