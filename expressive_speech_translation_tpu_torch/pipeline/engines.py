"""Stage engines: the seam between the cascade orchestrator and the models
(host copy of the JAX package's pipeline/engines.py protocols)."""

from __future__ import annotations

import dataclasses
from typing import Any, Dict, Optional, Protocol

import numpy as np


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


@dataclasses.dataclass
class Engines:
    asr: AsrEngine
    nmt: NmtEngine
    tts: TtsEngine
