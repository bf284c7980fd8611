"""What the timed path produced, caught where it is produced: each batched
dispatch of a stage (its requests, its results, the decode's tokens) and,
while a trace runs, the shapes handed to the resblock kernel's function.

The hooks wrap the port's public entry points: the engines'
``transcribe_batch`` / ``translate_batch`` / ``synthesize_batch`` (which the
micro-batchers call) and the model functions they call
(``whisper.decode_with_alignment``, ``nllb.generate``,
``cosyvoice.synthesize``, ``cosyvoice_official.synthesize_official``,
``cuda_vocoder.fused_resblock_stage``). A wrapper keeps references and
timestamps only; nothing is copied off the card inside the window.

For the judge, a few dispatches a stage drawn from the seed (:meth:`pick`)
also keep the logits of a few rows at every decode step
(``whisper.decode_step_with_attn``, ``nllb.decode_step``,
``cosyvoice._sample_from_logits``): one device copy of those rows a step."""

from __future__ import annotations

import dataclasses
import functools
import threading
import time
from typing import Any, Dict, List, Optional

import torch


@dataclasses.dataclass
class Dispatch:
    stage: str
    t0: float
    t0_ns: int
    items: List[Dict[str, Any]]
    t1: float = 0.0
    t1_ns: int = 0
    results: Any = None
    outputs: List[Dict[str, Any]] = dataclasses.field(default_factory=list)
    noise: Any = None
    rows: Optional[List[int]] = None       # the rows whose logits are kept, if any
    rows_index: Any = None                 # the same on the logits' device
    logits: List[Any] = dataclasses.field(default_factory=list)   # a step each: [rows, V]


class Recorder:
    """Installs the hooks (:meth:`install`, undone by :meth:`uninstall`) and
    keeps the dispatches made while :attr:`active`."""

    def __init__(self, seed: int = 0):
        self.seed = seed
        self.active = False
        self.dispatches: List[Dispatch] = []
        self.resblock_calls: List[tuple] = []   # (B, C, T, element bytes) while tracing
        self.tracing = False
        self._tls = threading.local()
        self._undo: List[tuple] = []
        self._picks: Dict[str, set] = {}
        self._rng: Dict[str, Any] = {}
        self._rows = 1
        self._count: Dict[str, int] = {}
        self.started: List[tuple] = []          # (stage, rows) of every dispatch begun
        self.last_items: Dict[str, list] = {}   # stage → the requests of its latest dispatch

    def pick(self, from_dispatches: int, rows: int) -> None:
        """Draw from :attr:`seed` which dispatches of each stage keep logits:
        the window's first and one more of its first ``from_dispatches``,
        each keeping ``rows`` rows, one drawn from each of ``rows`` equal
        blocks of its batch (:meth:`rows_of`)."""
        from .traffic import rng

        stages = ("asr", "nmt", "tts")
        self._rng = {stage: rng(self.seed, 4, k) for k, stage in enumerate(stages)}
        self._rows = int(rows)
        self._count = {}
        self._picks = {stage: {0, int(self._rng[stage].integers(1, max(from_dispatches, 2)))}
                       for stage in stages}

    def rows_of(self, stage: str, n: int) -> List[int]:
        """One row drawn from each of ``min(rows, n)`` equal blocks of ``n``."""
        k = min(self._rows, n)
        edges = [round(i * n / k) for i in range(k + 1)]
        return [int(self._rng[stage].integers(lo, hi)) for lo, hi in zip(edges, edges[1:])]

    # --------------------------------------------------------------- hooks

    def _patch(self, owner, name: str, make) -> None:
        orig = getattr(owner, name)
        self._undo.append((owner, name, orig))
        setattr(owner, name, functools.wraps(orig)(make(orig)))

    def current(self) -> Optional[Dispatch]:
        return getattr(self._tls, "dispatch", None)

    def _stage(self, stage: str):
        def make(orig):
            def wrapper(engine, requests):
                d = Dispatch(stage, time.perf_counter(), time.time_ns(), list(requests))
                self.started.append((stage, len(requests)))
                self.last_items[stage] = d.items
                if self.active:
                    ordinal = self._count.get(stage, 0)
                    self._count[stage] = ordinal + 1
                    if ordinal in self._picks.get(stage, ()):
                        d.rows = self.rows_of(stage, len(requests))
                self._tls.dispatch = d
                try:
                    d.results = orig(engine, requests)
                finally:
                    self._tls.dispatch = None
                d.t1, d.t1_ns = time.perf_counter(), time.time_ns()
                if self.active:
                    self.dispatches.append(d)
                return d.results
            return wrapper
        return make

    def _output(self, keep):
        def make(orig):
            def wrapper(*args, **kwargs):
                out = orig(*args, **kwargs)
                d = self.current()
                if d is not None:
                    d.outputs.append(keep(out))
                return out
            return wrapper
        return make

    def _logits(self, index: int, pick=lambda out: out):
        """Keep a copy of the picked rows of the logits argument ``index``
        (or of the return value, ``index`` None)."""
        def make(orig):
            def wrapper(*args, **kwargs):
                out = orig(*args, **kwargs)
                d = self.current()
                if d is not None and d.rows is not None:
                    logits = pick(out) if index is None else args[index]
                    if d.rows_index is None:
                        d.rows_index = torch.tensor(d.rows, device=logits.device)
                    d.logits.append(logits.index_select(0, d.rows_index))
                return out
            return wrapper
        return make

    def _resblock(self, orig):
        def wrapper(x, *args, **kwargs):
            if self.tracing:
                b, t, c = x.shape
                self.resblock_calls.append((b, c, t, x.element_size()))
            return orig(x, *args, **kwargs)
        return wrapper

    def noise_factory(self, device):
        """The engine's ``noise(call_index)``: a :class:`~.noise.BenchNoise`
        of the run's :attr:`seed`, kept on the dispatch that asked for it."""
        from .noise import BenchNoise

        def make(call: int):
            noise = BenchNoise(self.seed, call, device)
            d = self.current()
            if d is not None:
                d.noise = noise
            return noise
        return make

    def install(self) -> "Recorder":
        from expressive_speech_translation_tpu_torch.models import cosyvoice as cvm
        from expressive_speech_translation_tpu_torch.models import cosyvoice_official as com
        from expressive_speech_translation_tpu_torch.models import nllb as nlm
        from expressive_speech_translation_tpu_torch.models import whisper as wm
        from expressive_speech_translation_tpu_torch.ops import cuda_vocoder
        from expressive_speech_translation_tpu_torch.pipeline import torch_engines as te

        self._patch(te.TorchWhisperAsr, "transcribe_batch", self._stage("asr"))
        self._patch(te.TorchNllbNmt, "translate_batch", self._stage("nmt"))
        self._patch(te.TorchCosyVoiceTts, "synthesize_batch", self._stage("tts"))
        self._patch(wm, "decode_with_alignment",
                    self._output(lambda out: {"tokens": out[0], "aligns": out[1],
                                              "generated": out[3]}))
        self._patch(nlm, "generate", self._output(lambda out: {"tokens": out}))
        speech = self._output(lambda out: {"tokens": out["speech_tokens"],
                                           "lengths": out["token_lengths"]})
        self._patch(cvm, "synthesize", speech)
        self._patch(com, "synthesize_official", speech)
        self._patch(cuda_vocoder, "fused_resblock_stage", self._resblock)
        self._patch(wm, "decode_step_with_attn", self._logits(None, lambda out: out[0]))
        self._patch(nlm, "decode_step", self._logits(None))
        self._patch(cvm, "_sample_from_logits", self._logits(2))
        return self

    def uninstall(self) -> None:
        while self._undo:
            owner, name, orig = self._undo.pop()
            setattr(owner, name, orig)
