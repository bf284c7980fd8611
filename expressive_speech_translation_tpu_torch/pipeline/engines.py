"""Stage engines: the seam between the cascade orchestrator and the models
(the JAX package's ``pipeline/engines.py``).

Two assemblies exist: :func:`~.torch_engines.torch_engines`, the port's
models, and :func:`fake_engines` (this module), deterministic fakes that make
the orchestrator and the serve layer testable without weights.
"""

from __future__ import annotations

import dataclasses
from typing import Any, Dict, List, Optional, Protocol

import numpy as np
import torch


class AsrEngine(Protocol):
    def transcribe(self, audio_16k: np.ndarray, language: Optional[str] = None) -> Dict[str, Any]:
        """→ {"text": str, "words": [{"word","start","end"}], "language": str}"""


class NmtEngine(Protocol):
    def translate(self, text: str, source_lang: str, target_lang: str) -> str: ...


class TtsEngine(Protocol):
    def synthesize(
        self, text: str, *, style_prompt: str = "", reference_audio_16k: Optional[np.ndarray] = None,
        language: str = "en",
    ) -> np.ndarray:
        """→ waveform float32 at self.sample_rate"""

    sample_rate: int


def _stages(engines: "Engines"):
    """(stage name, engine) with the serving micro-batchers unwrapped."""
    for stage, e in (("asr", engines.asr), ("nmt", engines.nmt), ("tts", engines.tts)):
        yield stage, getattr(e, "engine", e)


def _cuda_indices(tree, out: set) -> None:
    """Add the CUDA device index of every tensor in a nested tree to ``out``."""
    if isinstance(tree, (dict, list, tuple)):
        for v in (tree.values() if isinstance(tree, dict) else tree):
            _cuda_indices(v, out)
    elif torch.is_tensor(tree) and tree.is_cuda:
        out.add(tree.device.index)


@dataclasses.dataclass
class Engines:
    asr: AsrEngine
    nmt: NmtEngine
    tts: TtsEngine

    def weights_info(self) -> str:
        """"loaded" | "random" | "fake", surfaced in /health/model and the
        /translate response so that serving random weights is never silent."""
        kinds = []
        for _, e in _stages(self):
            wl = getattr(e, "weightless", None)
            kinds.append("fake" if wl is None else ("random" if wl else "loaded"))
        if all(k == "loaded" for k in kinds):
            return "loaded"
        if any(k == "random" for k in kinds):
            return "random"
        return "fake"

    def placement_info(self) -> Dict[str, List[int]]:
        """The devices each stage's parameter tensors live on, surfaced in
        /health/model: a stage placed on a mesh lists the ids of the mesh
        slots its trees occupy (``slot_ids``; on the card a slot's id is its
        CUDA index), any other the CUDA indices of its tensors. A stage with
        no parameters (a fake) or whose tensors are all on the CPU lists
        none: the JAX package on the CPU lists its CPU device, ``[0]``.
        Placement is fixed once the engines are built, so the walk runs once
        and is cached."""
        cached = getattr(self, "_placement_cache", None)
        if cached is not None:
            return cached
        out: Dict[str, List[int]] = {}
        for stage, e in _stages(self):
            ids = getattr(e, "slot_ids", None)
            if ids is None:
                devices: set = set()
                _cuda_indices(getattr(e, "params", None), devices)
                ids = sorted(devices)
            out[stage] = list(ids)
        self._placement_cache = out
        return out

    def decode_info(self) -> Dict[str, str]:
        """Each stage's decode configuration, one short string a stage
        ("default" when nothing is set): int8 weights, the ASR's context
        buckets, MTP or speculative decode with its width, and random
        conditioning under loaded main weights (cloning then carries no
        speaker identity)."""
        out: Dict[str, str] = {}
        for stage, e in _stages(self):
            bits = []
            if getattr(e, "quantized", False):
                bits.append("int8")
            buckets = getattr(e, "context_buckets", None)
            if buckets is not None:
                bits.append("ctx=" + ("exact" if tuple(buckets) == (30,)
                                      else str(tuple(buckets))))
            lm = getattr(getattr(e, "cfg", None), "lm", None)
            if lm is not None and getattr(lm, "mtp", 1) > 1:
                bits.append(("spec" if getattr(lm, "spec_decode", False)
                             else "mtp") + f"K{lm.mtp}")
            if (getattr(e, "conditioning_weightless", False)
                    and not getattr(e, "weightless", True)):
                bits.append("cond=random")
            out[stage] = ",".join(bits) if bits else "default"
        return out


# ----------------------------------------------------------------- fake stages


class FakeAsr:
    """Deterministic ASR fake: the text's words spread evenly over the audio."""

    def __init__(self, text: str = "hello world this is a test"):
        self.text = text

    def transcribe(self, audio_16k: np.ndarray, language: Optional[str] = None) -> Dict[str, Any]:
        audio = np.asarray(audio_16k).reshape(-1)
        duration = len(audio) / 16_000.0
        words = self.text.split()
        step = duration / max(len(words), 1)
        return {
            "text": self.text,
            "language": language or "eng",
            "words": [
                {"word": w, "start": round(i * step, 3), "end": round((i + 0.8) * step, 3)}
                for i, w in enumerate(words)
            ],
        }


class FakeNmt:
    def translate(self, text: str, source_lang: str, target_lang: str) -> str:
        return f"[{target_lang}] {text}"


class FakeTts:
    """A sine at a pitch picked by the text's hash, its length proportional
    to the text's (``hash`` of a str is stable within one process only)."""

    sample_rate = 24_000

    def synthesize(
        self, text: str, *, style_prompt: str = "",
        reference_audio_16k: Optional[np.ndarray] = None, language: str = "en",
    ) -> np.ndarray:
        seconds = max(0.5, min(len(text) * 0.06, 30.0))
        freq = 200 + (hash(text) % 200)
        t = np.arange(int(self.sample_rate * seconds)) / self.sample_rate
        envelope = 0.5 + 0.5 * np.sin(2 * np.pi * 2.5 * t) ** 2
        return (0.3 * envelope * np.sin(2 * np.pi * freq * t)).astype(np.float32)

    def synthesize_streaming(
        self, text: str, *, style_prompt: str = "",
        reference_audio_16k: Optional[np.ndarray] = None, language: str = "en",
        chunk_samples: int = 24_000,
    ):
        """The waveform of :meth:`synthesize` in chunks."""
        wave = self.synthesize(text, style_prompt=style_prompt,
                               reference_audio_16k=reference_audio_16k,
                               language=language)
        for i in range(0, len(wave), chunk_samples):
            yield wave[i:i + chunk_samples]


def fake_engines(text: str = "hello world this is a test") -> Engines:
    return Engines(asr=FakeAsr(text), nmt=FakeNmt(), tts=FakeTts())
