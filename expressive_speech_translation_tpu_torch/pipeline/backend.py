"""Backend abstraction (the JAX package's ``pipeline/backend.py``).

- :class:`TranslationBackend`: ``initialize``, ``translate_speech(audio,
  source_lang, target_lang)``, ``is_language_supported``,
  ``get_supported_languages`` and a ``cleanup`` hook.
- :class:`TranslationManager`: a registry of backends with a default, the
  fallback to it for an unknown name, lazy initialisation, and the
  initialisation-free probes the health and metadata routes read.
- :class:`TranslationStrategy`: ``speech_with_music`` when music detection's
  confidence exceeds 0.15, else ``speech_only``.
"""

from __future__ import annotations

import abc
import logging
from typing import Any, Dict, List, Optional

import numpy as np

from ..core.errors import BackendUnavailableError

log = logging.getLogger(__name__)


class TranslationBackend(abc.ABC):
    """A speech-to-speech translation engine."""

    initialized: bool = False

    @abc.abstractmethod
    def initialize(self) -> None:
        """Load and warm everything needed to serve requests."""

    @abc.abstractmethod
    def translate_speech(
        self,
        audio: np.ndarray,            # [T] or [1, T] float32 at 16 kHz
        source_lang: str,
        target_lang: str,
        **kwargs: Any,
    ) -> Dict[str, Any]:
        """→ {"audio": np.ndarray [1, T'] @16 kHz, "transcripts": {source, target}}."""

    @abc.abstractmethod
    def is_language_supported(self, lang: str) -> bool: ...

    @abc.abstractmethod
    def get_supported_languages(self) -> List[str]: ...

    def cleanup(self) -> None:
        """Graceful-shutdown hook."""


class TranslationManager:
    """Backend registry with a default, fallback to it, and lazy initialisation."""

    def __init__(self) -> None:
        self._backends: Dict[str, TranslationBackend] = {}
        self._default: Optional[str] = None

    def register_backend(
        self, name: str, backend: TranslationBackend, is_default: bool = False
    ) -> None:
        self._backends[name] = backend
        if is_default or self._default is None:
            self._default = name
        log.info("registered backend %r (default=%s)", name, self._default == name)

    def get_backend(self, name: Optional[str] = None) -> TranslationBackend:
        if not self._backends:
            raise BackendUnavailableError("no translation backends registered")
        key = name if name in self._backends else self._default
        backend = self._backends[key]
        if not backend.initialized:
            log.info("lazily initializing backend %r", key)
            backend.initialize()
            backend.initialized = True
        return backend

    def available_backends(self) -> List[str]:
        return list(self._backends)

    def peek_backend(self, name: str) -> Optional[TranslationBackend]:
        """The registered backend without initialising it (health and
        metadata probes must neither pay for nor hide an engine build)."""
        return self._backends.get(name)

    def backend_weights(self) -> Dict[str, str]:
        """Each backend's weight provenance ("loaded" | "random" | "fake" |
        "unknown"), without initialising it."""
        return {name: getattr(b, "weights_info", lambda: "unknown")()
                for name, b in self._backends.items()}

    def backend_decode(self) -> Dict[str, Dict[str, str]]:
        """Each backend's decode modes by stage (``Engines.decode_info``),
        without initialising it."""
        return {name: getattr(b, "decode_info", dict)()
                for name, b in self._backends.items()}

    @property
    def default_backend(self) -> Optional[str]:
        return self._default

    def select_backend_for_language(self, lang: str) -> TranslationBackend:
        """The first registered backend that supports the language, else the
        default."""
        for name, backend in self._backends.items():
            if backend.is_language_supported(lang):
                return self.get_backend(name)
        return self.get_backend()

    def cleanup(self) -> None:
        for name, backend in self._backends.items():
            try:
                backend.cleanup()
            except Exception:   # noqa: BLE001 — best-effort shutdown
                log.exception("cleanup failed for backend %r", name)


class TranslationStrategy:
    """Content-aware choice of the processing strategy."""

    MUSIC_CONFIDENCE_THRESHOLD = 0.15

    @staticmethod
    def select_strategy(audio_analysis: Dict[str, Any]) -> str:
        music = audio_analysis.get("music_detection", {})
        if music.get("confidence", 0.0) > TranslationStrategy.MUSIC_CONFIDENCE_THRESHOLD:
            return "speech_with_music"
        return "speech_only"
