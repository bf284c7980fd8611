"""The alternate translation backends and the model lifecycle manager.

The port of the JAX package's ``pipeline/alternate_backends.py``, the
reference's services beside the cascade:

- :class:`SeamlessBackend`: direct S2ST (``facebook/seamless-m4t-v2-large``,
  ``models/seamless.py``) with ``translate_speech.py``'s behaviours: the
  80–7500 Hz bandpass pre-filter, ``num_beams=5``, tanh limiting;
- :class:`ESPnetBackend`: per-language ASR and TTS loaded on demand and
  cached, with a fallback text when the ASR hears nothing;
- :class:`ModelManager`: the singleton model lifecycle with inactivity
  reload ("Model inactive for too long, reloading…");
- :class:`TranslationEnvironment`: content-aware generation parameters
  (speech_focused / mixed_content / general → beams, temperature, penalty).

Both backends run on ``device``, the card unless ``device="cpu"``. The
ESPnet backend's default ASR is the port's Whisper engine, whose log-mel runs
through the log-mel kernel on the card; Seamless's fbank is plain PyTorch, as
in JAX.
"""

from __future__ import annotations

import json
import logging
import os
import threading
import time
from pathlib import Path
from typing import Any, Callable, Dict, List, Optional

import numpy as np
import torch

from ..core.device import resolve_device
from ..ops.mel import kaldi_fbank
from ..ops.resample import resample
from .backend import TranslationBackend
from .languages import NLLB_LANGUAGES, supported_languages
from .tokenizer import ByteTokenizer, Tokenizer

log = logging.getLogger(__name__)


# -------------------------------------------------------------- environments


class TranslationEnvironment:
    """Content-aware generation parameter selection."""

    PARAMS = {
        "speech_focused": {"num_beams": 5, "temperature": 0.7, "repetition_penalty": 1.2},
        "mixed_content": {"num_beams": 4, "temperature": 0.8, "repetition_penalty": 1.3},
        "general": {"num_beams": 3, "temperature": 1.0, "repetition_penalty": 1.0},
    }

    @classmethod
    def classify(cls, audio_analysis: Dict[str, Any]) -> str:
        music = audio_analysis.get("music_detection", {}).get("confidence", 0.0)
        if music < 0.15:
            return "speech_focused"
        if music < 0.4:
            return "mixed_content"
        return "general"

    @classmethod
    def generation_params(cls, audio_analysis: Dict[str, Any]) -> Dict[str, Any]:
        return dict(cls.PARAMS[cls.classify(audio_analysis)])


# -------------------------------------------------------------- model manager


class ModelManager:
    """The singleton lifecycle manager with inactivity reload (the
    reference's ModelManager: __new__ / _initialize / _verify_model /
    _load_model / get_model_components / cleanup)."""

    _instance: Optional["ModelManager"] = None
    _lock = threading.Lock()
    INACTIVITY_SECONDS = 1800.0

    def __new__(cls, *args, **kwargs):
        with cls._lock:
            if cls._instance is None:
                cls._instance = super().__new__(cls)
                cls._instance._initialized = False
            return cls._instance

    def __init__(self, loader: Optional[Callable[[], Any]] = None):
        if self._initialized and loader is None:
            return
        self._initialize(loader)

    def _initialize(self, loader: Optional[Callable[[], Any]]):
        self._loader = loader
        self._components: Any = None
        self._last_used = 0.0
        self._initialized = True

    def _load_model(self):
        if self._loader is None:
            raise RuntimeError("ModelManager has no loader configured")
        log.info("ModelManager: loading model components")
        self._components = self._loader()
        self._last_used = time.monotonic()

    def _verify_model(self) -> bool:
        return self._components is not None

    def get_model_components(self):
        now = time.monotonic()
        if self._verify_model() and now - self._last_used > self.INACTIVITY_SECONDS:
            log.info("Model inactive for too long, reloading…")
            self._components = None
        if not self._verify_model():
            self._load_model()
        self._last_used = now
        return self._components

    def cleanup(self):
        log.info("ModelManager cleanup")
        self._components = None

    def __del__(self):  # pragma: no cover — the interpreter's shutdown path
        try:
            self.cleanup()
        except Exception:  # noqa: BLE001
            pass

    @classmethod
    def reset_singleton(cls):
        """Test hook."""
        with cls._lock:
            cls._instance = None


# ------------------------------------------------------------- seamless (S2ST)


def bandpass_80_7500(audio: np.ndarray, sr: int = 16_000) -> np.ndarray:
    """The FFT-domain bandpass 80–7500 Hz (translate_speech.py's pre-filter), on the host."""
    x = np.asarray(audio, np.float32).reshape(-1)
    spec = np.fft.rfft(x)
    freqs = np.fft.rfftfreq(len(x), 1.0 / sr)
    spec[(freqs < 80) | (freqs > 7500)] = 0
    return np.fft.irfft(spec, n=len(x)).astype(np.float32)


def seamless_features(audio: np.ndarray, *, max_frames: Optional[int] = None, device=None):
    """The HF SeamlessM4TFeatureExtractor frontend: an 80-mel kaldi fbank at
    16 kHz (25 ms / 10 ms, povey, pre-emphasis 0.97) on ``device``, per-bin
    CMVN over the utterance on the host (ddof=1; the 2^15 int16 scale cancels
    under CMVN), 2-frame stacking → ([1, T//2, 160] f32, bool mask)."""
    x = np.asarray(audio, np.float32).reshape(-1)
    # 2-frame stacking needs ≥ 2 fbank frames (≥ ~35 ms): shorter clips are
    # padded with silence, not given an all-False mask that NaNs the softmax
    min_samples = int(16_000 * 0.035) + 1
    if x.size < min_samples:
        x = np.pad(x, (0, min_samples - x.size))
    dev = resolve_device(device)
    fb = kaldi_fbank(torch.from_numpy(x[None]).to(dev), sr=16_000, n_mels=80,
                     frame_length_ms=25.0, frame_shift_ms=10.0, fmin=20.0)[0].cpu().numpy()
    # ddof=1 is 0/0 for a single frame: ddof=0 there
    ddof = 1 if fb.shape[0] > 1 else 0
    fb = (fb - fb.mean(0, keepdims=True)) / np.sqrt(fb.var(0, ddof=ddof, keepdims=True) + 1e-7)
    t = fb.shape[0] - fb.shape[0] % 2
    feats = fb[:t].reshape(1, t // 2, 160)
    n = feats.shape[1]
    if max_frames is not None:
        if n < max_frames:
            feats = np.pad(feats, ((0, 0), (0, max_frames - n), (0, 0)))
        else:
            feats, n = feats[:, :max_frames], max_frames
    mask = np.zeros((1, feats.shape[1]), bool)
    mask[:, :n] = True
    return feats.astype(np.float32), mask


class SeamlessBackend(TranslationBackend):
    """The direct S2ST backend over the HF-weight-compatible SeamlessM4T-v2
    (``models/seamless.py``) on ``device``. Without weights it runs the same
    graph at the toy config with byte-level char maps; with baked weights
    (``python -m expressive_speech_translation_tpu_torch.models.loaders
    --seamless DIR --out DIR``) the checkpoint's generation maps drive the
    t2u alignment."""

    def __init__(self, params=None, cfg=None, tokenizer: Optional[Tokenizer] = None, *,
                 num_beams: int = 5, aux_maps: Optional[Dict[str, Any]] = None,
                 max_text_tokens: int = 64, max_chars: int = 256, max_units: int = 512,
                 device=None):
        from ..models import seamless as sm

        self.device = resolve_device(device)
        self.cfg = cfg or (sm.SeamlessConfig.v2_large() if params is not None
                           else sm.SeamlessConfig.toy())
        self._params = params
        self.tokenizer = tokenizer or ByteTokenizer()
        self.num_beams = num_beams
        self.aux = aux_maps or {}
        self.max_text_tokens = max_text_tokens
        self.max_chars = max_chars
        self.max_units = max_units
        self.weightless = params is None
        self.initialized = False

    def weights_info(self) -> str:
        """"loaded" | "random", the contract of ``Engines.weights_info``, so
        ``/available-backends`` never offers a random backend as loaded."""
        return "random" if self.weightless else "loaded"

    @classmethod
    def from_models_dir(cls, root: Optional[str] = None, *, device=None,
                        **kw) -> "SeamlessBackend":
        """Baked weights from ``{root|EST_MODELS_DIR}/seamless`` (the bake's
        ``config.json`` + ``params.safetensors``, ``generation_maps.json`` and
        a ``tokenizer.json`` when present) on ``device``; else the weightless
        toy instance."""
        root = root or os.environ.get("EST_MODELS_DIR")
        if root:
            d = Path(root) / "seamless"
            if (d / "config.json").exists():
                from ..models import seamless as sm
                from ..models.loaders import load_converted

                params, cfg = load_converted(d, sm.SeamlessConfig, device)
                maps = d / "generation_maps.json"
                aux = json.loads(maps.read_text()) if maps.exists() else {}
                tok = None
                if (d / "tokenizer.json").exists():
                    from .tokenizer import SubwordTokenizer

                    tok = SubwordTokenizer(d / "tokenizer.json")
                log.info("SeamlessBackend: baked weights from %s (aux: %s)",
                         d, sorted(aux) or "none")
                return cls(params=params, cfg=cfg, tokenizer=tok, aux_maps=aux, device=device,
                           **kw)
        return cls(device=device, **kw)

    def initialize(self) -> None:
        from ..models import seamless as sm
        from ..models.common import cast_floats

        if self._params is None:
            log.warning("SeamlessBackend: random weights (no checkpoint supplied)")
            self._params = sm.init_seamless(7, self.cfg, self.device)
        self._params = cast_floats(self._params, torch.bfloat16)
        self.initialized = True

    def is_language_supported(self, lang: str) -> bool:
        return lang in NLLB_LANGUAGES

    def get_supported_languages(self) -> List[str]:
        return sorted(NLLB_LANGUAGES)

    @staticmethod
    def _map_lookup(mapping: Dict[str, Any], lang: str, what: str) -> int:
        """A language in a checkpoint map, keyed bare ("fra") or token-styled
        ("__fra__"). With real maps an unknown language raises rather than
        becoming token 0 (pad), which would decode an arbitrary language."""
        if not mapping:
            return 0
        for key in (lang, f"__{lang}__"):
            if key in mapping:
                return int(mapping[key])
        raise ValueError(
            f"target language {lang!r} not in the checkpoint's {what} map "
            f"({len(mapping)} languages)")

    def _lang_ids(self, target_lang: str):
        return (self._map_lookup(self.aux.get("text_decoder_lang_to_code_id") or {},
                                 target_lang, "text_decoder_lang_to_code_id"),
                self._map_lookup(self.aux.get("vocoder_lang_code_to_id") or {},
                                 target_lang, "vocoder_lang_code_to_id"))

    def translate_speech(self, audio, source_lang: str, target_lang: str,
                         **kw) -> Dict[str, Any]:
        from ..models import seamless as sm

        cfg, params = self.cfg, self._params
        x = bandpass_80_7500(np.asarray(audio, np.float32).reshape(-1))
        feats, mask = seamless_features(x, device=self.device)
        text_tok, voc_lang = self._lang_ids(target_lang)
        # the features enter in bf16 whatever the tree's dtype, as the JAX
        # backend hands them over (an f32 tree promotes them at its first norm)
        feats_t = torch.from_numpy(feats).to(self.device, torch.bfloat16)
        with torch.no_grad():
            enc, enc_mask = sm.encode_speech(params, cfg, feats_t,
                                             torch.from_numpy(mask).to(self.device))
            seq = sm.generate_text(params, cfg, enc, enc_mask, text_tok,
                                   num_beams=self.num_beams, max_new_tokens=self.max_text_tokens)
            id_to_text, char_to_id = self.aux.get("id_to_text"), self.aux.get("char_to_id")
            if id_to_text is None or char_to_id is None:
                id_to_text, char_to_id = sm.byte_char_maps(cfg.vocab_size)
            char_ids, char_counts = sm.t2u_char_inputs(cfg, seq, id_to_text, char_to_id,
                                                       self.max_chars)
            wave, lengths, _ = sm.speech_from_text(params, cfg, seq, enc, enc_mask, char_ids,
                                                   char_counts, voc_lang,
                                                   max_units=self.max_units)
        n = int(np.clip(int(lengths[0]), 0, wave.shape[1]))
        out = np.tanh(wave[0, :n].float().cpu().numpy())        # translate_speech.py's limiter
        text_ids = [int(t) for t in seq[0].tolist()
                    if t not in (cfg.pad_token, cfg.eos_token, cfg.decoder_start_token)]
        return {"audio": out.reshape(1, -1),
                "transcripts": {"source": "", "target": self.tokenizer.decode(text_ids)}}


# --------------------------------------------------------------- espnet-style


class ESPnetBackend(TranslationBackend):
    """Per-language ASR and TTS loaded on demand and cached (the reference's
    ESPnetBackend: _load_asr_model / _load_tts_model per language), with a
    fallback text when the ASR hears nothing. The default factories build on
    ``device``: the port's Whisper engine (the bake's ``asr/`` under
    ``EST_MODELS_DIR``, else a random ``WhisperConfig.tiny()``) and a
    :class:`~..models.vits_tts.VitsTTSModel` per language."""

    FALLBACK_TEXT = "Hello, this is a test."

    def __init__(self, asr_factory: Optional[Callable[[str], Any]] = None,
                 tts_factory: Optional[Callable[[str], Any]] = None, *, device=None):
        self.device = resolve_device(device)

        def default_tts(lang: str):
            from ..models.vits_tts import VitsTTSModel

            return VitsTTSModel(lang, device=self.device)

        def default_asr(lang: str):
            from ..models import whisper as wm
            from .torch_engines import TorchWhisperAsr

            root = os.environ.get("EST_MODELS_DIR")
            if root and (Path(root) / "asr" / "config.json").exists():
                from ..models.loaders import load_converted

                params, cfg = load_converted(Path(root) / "asr", wm.WhisperConfig, self.device)
                return TorchWhisperAsr(cfg, params, device=self.device)
            return TorchWhisperAsr(wm.WhisperConfig.tiny(), device=self.device)

        self._asr_factory = asr_factory or default_asr
        self._tts_factory = tts_factory or default_tts
        self._asr_models: Dict[str, Any] = {}
        self._tts_models: Dict[str, Any] = {}
        self.initialized = False

    def initialize(self) -> None:
        self.initialized = True

    def weights_info(self) -> str:
        """"loaded" | "random" from the cached per-language models: any random
        one makes the backend "random", and so does an empty cache (the
        default VITS has no checkpoint path; injected loaded factories flip
        this once their first models are cached)."""
        models = list(self._asr_models.values()) + list(self._tts_models.values())
        flags = [getattr(m, "weightless", True) for m in models]
        if flags:
            return "random" if any(flags) else "loaded"
        return "random"

    def _load_asr_model(self, lang: str):
        if lang not in self._asr_models:
            log.info("ESPnetBackend: loading ASR model for %s", lang)
            self._asr_models[lang] = self._asr_factory(lang)
        return self._asr_models[lang]

    def _load_tts_model(self, lang: str):
        if lang not in self._tts_models:
            log.info("ESPnetBackend: loading TTS model for %s", lang)
            self._tts_models[lang] = self._tts_factory(lang)
        return self._tts_models[lang]

    def is_language_supported(self, lang: str) -> bool:
        return lang in supported_languages()

    def get_supported_languages(self) -> List[str]:
        return supported_languages()

    def translate_speech(self, audio, source_lang: str, target_lang: str,
                         **kw) -> Dict[str, Any]:
        x = np.asarray(audio, np.float32).reshape(-1)
        asr = self._load_asr_model(source_lang)
        result = asr.transcribe(x, language=source_lang)
        text = (result.get("text") or "").strip() or self.FALLBACK_TEXT
        tts = self._load_tts_model(target_lang)
        wave = tts.synthesize(text, language=target_lang)
        sr = getattr(tts, "sample_rate", 16_000)
        if sr != 16_000:
            wave = resample(torch.as_tensor(np.asarray(wave, np.float32), device=self.device),
                            sr, 16_000).cpu().numpy()
        return {"audio": np.asarray(wave, np.float32).reshape(1, -1),
                "transcripts": {"source": text, "target": text}}
