"""CascadedBackend — the ASR → NMT → TTS pipeline over the port's engines.

Port of the JAX package's ``pipeline/cascaded.py`` ``initialize``,
``translate_speech``, ``translate_speech_streaming``, ``translate_text``,
``extract_pauses``, ``reference_audio_for_cloning``, the language queries and
the temporal mapping: ASR with word timestamps, NMT, TTS (cloning the source
voice unless ``use_voice_cloning=False``), host resampling to 16 kHz, then
the visual-guided mapping into the speech segments of the request's video
frames, or the natural-flow mapping onto the source's timing, and loudness
toward -23 LUFS. Engines stay resident; stage boundaries are in-process
arrays.
"""

from __future__ import annotations

import functools
import logging
from typing import Any, Dict, List, Optional

import numpy as np

from ..core.config import AppConfig
from ..core.errors import ValidationError
from ..obs import spans
from ..obs.logging_setup import new_request_id
from ..obs.perf import StageTimer
from ..ops.host_dsp import loudness_normalize_np, resample_np
from .audio_processor import AudioProcessor
from .backend import TranslationBackend
from .engines import Engines
from .languages import COSYVOICE_LANGUAGES, NLLB_LANGUAGES, supported_languages
from .temporal_mapper import TemporalMapper
from .visual_speech_detector import VisualSpeechDetector
from .visual_temporal_mapper import VisualTemporalMapper

log = logging.getLogger(__name__)

PAUSE_THRESHOLD_SECONDS = 0.25
CLONE_REFERENCE_SECONDS = 25.0
TARGET_LUFS = -23.0


class CascadedBackend(TranslationBackend):
    def __init__(self, engines: Engines, config: Optional[AppConfig] = None):
        self.engines = engines
        self.config = config or AppConfig()
        self.temporal_mapper = TemporalMapper()
        self.visual_mapper = VisualTemporalMapper()
        self.initialized = False

    @functools.cached_property
    def audio_processor(self) -> AudioProcessor:
        """The request front end (a server runs it before ``translate_speech``),
        built at first use on the ASR engine's device: a backend over CPU
        engines or fakes constructs on a host with no card, and an engine
        that names no device gets the card's processor."""
        asr = getattr(self.engines.asr, "engine", self.engines.asr)
        return AudioProcessor(self.config.audio, device=getattr(asr, "device", None))

    def initialize(self) -> None:
        """Warm-up: the visual mapper, then 1 s of silence through ASR with no
        language (so language detection warms too), a short sentence through
        NMT, and the sentence through TTS with the silence as the cloning
        reference, so the voice-prompt conditioning warms too."""
        self.visual_mapper.initialize()
        silence = np.zeros(16_000, np.float32)
        self.engines.asr.transcribe(silence)
        self.engines.nmt.translate("Hello world.", "eng", "fra")
        self.engines.tts.synthesize("Hello world.", reference_audio_16k=silence)
        self.initialized = True
        log.info("CascadedBackend initialized")

    def weights_info(self) -> str:
        return self.engines.weights_info()

    def placement_info(self):
        return self.engines.placement_info()

    def decode_info(self):
        return self.engines.decode_info()

    def is_language_supported(self, lang: str) -> bool:
        return lang in COSYVOICE_LANGUAGES and lang in NLLB_LANGUAGES

    def get_supported_languages(self) -> List[str]:
        return supported_languages()

    @staticmethod
    def extract_pauses(words: List[Dict[str, float]]) -> List[Dict[str, float]]:
        """Inter-word pauses > 250 ms."""
        pauses = []
        for prev, cur in zip(words, words[1:]):
            gap = float(cur["start"]) - float(prev["end"])
            if gap > PAUSE_THRESHOLD_SECONDS:
                pauses.append({"start": float(prev["end"]), "end": float(cur["start"]),
                               "duration": gap})
        return pauses

    def reference_audio_for_cloning(self, audio_16k: np.ndarray) -> np.ndarray:
        """The first ≤ 25 s of the source."""
        n = int(CLONE_REFERENCE_SECONDS * 16_000)
        return np.asarray(audio_16k, np.float32).reshape(-1)[:n]

    def translate_speech(self, audio: np.ndarray, source_lang: str, target_lang: str, *,
                         original_video_frames: Optional[list] = None, video_fps: float = 25.0,
                         use_voice_cloning: bool = True, **kwargs: Any) -> Dict[str, Any]:
        """16 kHz speech → {"audio": [1, T] f32 at 16 kHz, "transcripts":
        {"source", "target"}, "process_id", "stage_summary"}. ``process_id``
        is the request's id, carried by its spans (``obs/spans.py``); the
        ``post`` stage is all of the host's work after the TTS, the resample
        to 16 kHz included. ``use_voice_cloning=False`` synthesizes without
        the source-audio reference. With ``original_video_frames`` (at ``video_fps``) the
        translation is placed into the speech segments the frames show;
        without them ``video_fps`` changes nothing, nor does any other
        keyword (the JAX backend's signature)."""
        process_id = new_request_id()
        if not self.is_language_supported(target_lang):
            raise ValidationError(f"Unsupported target language: {target_lang}")
        if not self.is_language_supported(source_lang):
            raise ValidationError(f"Unsupported source language: {source_lang}")
        x = np.asarray(audio, np.float32).reshape(-1)
        timer = StageTimer(audio_seconds=len(x) / 16_000.0)
        log.info("[%s] translate_speech %s→%s (%.1fs audio)", process_id, source_lang,
                 target_lang, timer.audio_seconds)
        with spans.request(process_id), spans.span("request", request=process_id,
                                                    audio_s=timer.audio_seconds):
            with timer.stage("asr"):
                asr = self.engines.asr.transcribe(x, language=source_lang)
            source_text = asr.get("text", "")
            words = asr.get("words", [])

            with timer.stage("nmt"):
                target_text = self.engines.nmt.translate(
                    source_text, NLLB_LANGUAGES.get(source_lang, source_lang),
                    NLLB_LANGUAGES.get(target_lang, target_lang))
            # an empty translation fails only when an engine declares real weights
            if not target_text.strip() and getattr(self.engines.nmt, "weightless", True) is False:
                raise RuntimeError("Translation result was empty.")

            reference = self.reference_audio_for_cloning(x) if use_voice_cloning else None
            with timer.stage("tts"):
                tts_audio = self.engines.tts.synthesize(
                    target_text, style_prompt=source_text, reference_audio_16k=reference,
                    language=COSYVOICE_LANGUAGES.get(target_lang, "en"))

            with timer.stage("post"):
                tts_sr = getattr(self.engines.tts, "sample_rate", 24_000)
                if tts_sr != 16_000:
                    tts_audio = resample_np(np.asarray(tts_audio), tts_sr, 16_000)
                out = self._apply_natural_temporal_mapping(
                    tts_audio, x, words, original_video_frames=original_video_frames,
                    video_fps=video_fps)
                out = loudness_normalize_np(out, TARGET_LUFS)

        summary = timer.summary()
        log.info("[%s] done: %s", process_id, {k: round(v["xrt"], 4) for k, v in summary.items()})
        return {"audio": out.reshape(1, -1).astype(np.float32),
                "transcripts": {"source": source_text, "target": target_text},
                "process_id": process_id,
                "stage_summary": summary}

    def translate_text(self, text: str, source_lang: str, target_lang: str, *,
                       synthesize: bool = False) -> Dict[str, Any]:
        """text → NLLB → optional TTS: {"source_text", "target_text"} plus
        {"audio" [1, T] at 16 kHz} when ``synthesize``."""
        if not text.strip():
            raise ValidationError("text is required")
        if not self.is_language_supported(target_lang):
            raise ValidationError(f"Unsupported target language: {target_lang}")
        target_text = self.engines.nmt.translate(
            text, NLLB_LANGUAGES.get(source_lang, source_lang),
            NLLB_LANGUAGES.get(target_lang, target_lang))
        if not target_text.strip() and getattr(self.engines.nmt, "weightless", True) is False:
            raise RuntimeError("Translation result was empty.")
        out: Dict[str, Any] = {"source_text": text, "target_text": target_text}
        if synthesize:
            wave = self.engines.tts.synthesize(
                target_text, language=COSYVOICE_LANGUAGES.get(target_lang, "en"))
            wave = np.asarray(wave, np.float32).reshape(-1)
            tts_sr = getattr(self.engines.tts, "sample_rate", 24_000)
            if tts_sr != 16_000:
                wave = resample_np(wave, tts_sr, 16_000)
            out["audio"] = wave.reshape(1, -1).astype(np.float32)
        return out

    def translate_speech_streaming(self, audio: np.ndarray, source_lang: str, target_lang: str):
        """Streaming speech translation, pipelined by ASR window: with an ASR
        that streams, each window goes ASR → NMT → streaming TTS as soon as
        it is decoded, so the first audio waits for one window and one TTS
        chunk, not the whole utterance. Yields a ``"transcripts"`` event a
        window (the text accumulated so far and the ``"window"`` [start,
        end]) and then that window's ``"audio"`` events (16 kHz chunks).
        Without a streaming ASR: one ASR+NMT pass, then the TTS chunks; a TTS
        without ``synthesize_streaming`` gives one offline chunk. Temporal
        mapping and loudness are offline-only and skipped here."""
        if not self.is_language_supported(target_lang):
            raise ValidationError(f"Unsupported target language: {target_lang}")
        x = np.asarray(audio, np.float32).reshape(-1)
        src_nllb = NLLB_LANGUAGES.get(source_lang, source_lang)
        tgt_nllb = NLLB_LANGUAGES.get(target_lang, target_lang)
        tts = self.engines.tts
        tts_sr = getattr(tts, "sample_rate", 24_000)
        # gate on the unwrapped engines (a micro-batch facade's ``engine``),
        # so a facade and its engine give the same events
        tts_inner = getattr(tts, "engine", tts)
        asr_inner = getattr(self.engines.asr, "engine", self.engines.asr)
        tts_streams = hasattr(tts_inner, "synthesize_streaming")

        def tts_events(text: str, style: str, reference):
            kw = dict(style_prompt=style, reference_audio_16k=reference,
                      language=COSYVOICE_LANGUAGES.get(target_lang, "en"))
            chunks = (tts_inner.synthesize_streaming(text, **kw) if tts_streams
                      else iter([tts.synthesize(text, **kw)]))
            for chunk in chunks:
                c = np.asarray(chunk, np.float32)
                if tts_sr != 16_000:
                    c = resample_np(c, tts_sr, 16_000)
                yield {"type": "audio", "chunk": c, "sample_rate": 16_000}

        if hasattr(asr_inner, "transcribe_streaming"):
            reference = self.reference_audio_for_cloning(x)
            src_parts: List[str] = []
            tgt_parts: List[str] = []
            asr_weightless = getattr(asr_inner, "weightless", True)
            for seg in asr_inner.transcribe_streaming(x, language=source_lang):
                seg_text = seg.get("text", "").strip()
                # with real weights a silent window stays silent; random
                # weights decode empty text, and the path still runs whole
                if not seg_text and asr_weightless is False:
                    continue
                seg_target = self.engines.nmt.translate(seg_text, src_nllb, tgt_nllb)
                src_parts.append(seg_text)
                tgt_parts.append(seg_target)
                yield {"type": "transcripts",
                       "source": " ".join(p for p in src_parts if p),
                       "target": " ".join(p for p in tgt_parts if p),
                       "window": [seg.get("start", 0.0), seg.get("end", 0.0)]}
                yield from tts_events(seg_target, seg_text, reference)
            if not src_parts:   # silence in, structured empty out
                yield {"type": "transcripts", "source": "", "target": ""}
            return

        asr = self.engines.asr.transcribe(x, language=source_lang)
        source_text = asr.get("text", "")
        target_text = self.engines.nmt.translate(source_text, src_nllb, tgt_nllb)
        yield {"type": "transcripts", "source": source_text, "target": target_text}
        yield from tts_events(target_text, source_text, self.reference_audio_for_cloning(x))

    def _apply_natural_temporal_mapping(self, translated: np.ndarray, source: np.ndarray,
                                        words: List[Dict[str, float]], *,
                                        original_video_frames: Optional[list] = None,
                                        video_fps: float = 25.0) -> np.ndarray:
        """With video frames, place the translation into the speech segments
        the frames show; with none, or no segment, or a failure there (logged,
        as in the JAX backend), map it onto the source's timing (pauses come
        from the word timestamps inside the timing profile). Best effort: on
        a failure of that too the audio is returned unmapped."""
        if original_video_frames:
            try:
                # a preset detector serves only a request at its own frame
                # clock: segment times scale with frame_skip / fps
                detector = self.visual_mapper.detector
                if detector is None or getattr(detector, "fps", video_fps) != video_fps:
                    detector = VisualSpeechDetector(fps=video_fps)
                segments = detector.detect_speech_segments(original_video_frames)
                if segments:
                    total = len(original_video_frames) / video_fps
                    return self.visual_mapper.distribute_audio(
                        translated, segments, total, source_audio=source)
                log.info("no visual speech segments; falling back to natural flow")
            except Exception:  # noqa: BLE001 — the visual mapping never fails the request
                log.exception("visual mapping failed; falling back to natural flow")
        try:
            profile = self.temporal_mapper.timing_profile(source, words or None)
            return self.temporal_mapper.apply_temporal_guidance(translated, source, profile)
        except Exception:  # noqa: BLE001 — temporal mapping never fails the request
            log.exception("temporal mapping failed; returning unmapped audio")
            return np.asarray(translated, np.float32).reshape(-1)

    def cleanup(self) -> None:
        log.info("CascadedBackend cleanup")
