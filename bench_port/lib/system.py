"""The system under test: the port's engines for one configuration behind
its micro-batchers and ``CascadedBackend``, with the traffic's pinned decode
lengths and the configuration's weight edits applied."""

from __future__ import annotations

import dataclasses
from typing import Any, Dict

import torch

from .record import Recorder
from .spec import build_config

DTYPES = {"bfloat16": torch.bfloat16, "float32": torch.float32}
TEXT_FRAME_RATE = 25        # speech tokens a second (the TTS engine's budget rule)


@dataclasses.dataclass
class System:
    backend: Any
    engines: Any
    stages: Dict[str, Any]      # stage → its micro-batcher facade
    recorder: Recorder

    def inner(self, stage: str):
        return self.stages[stage].engine

    def shutdown(self) -> None:
        for facade in self.stages.values():
            facade.shutdown()


def port_configs(config: Dict[str, Any]) -> Dict[str, Any]:
    """The port's config objects the file states."""
    from expressive_speech_translation_tpu_torch.models import cosyvoice as cvm
    from expressive_speech_translation_tpu_torch.models import cosyvoice_official as com
    from expressive_speech_translation_tpu_torch.models import ecapa as ecm
    from expressive_speech_translation_tpu_torch.models import nllb as nlm
    from expressive_speech_translation_tpu_torch.models import speech_tokenizer as stm
    from expressive_speech_translation_tpu_torch.models import whisper as wm

    tts_cls = com.OfficialTtsConfig if config["tts"]["chain"] == "official" else cvm.CosyVoiceConfig
    return {"asr": build_config(wm.WhisperConfig, config["asr"]),
            "nmt": build_config(nlm.NLLBConfig, config["nmt"]),
            "tts": build_config(tts_cls, config["tts"]["config"]),
            "ecapa": build_config(ecm.EcapaConfig, config["ecapa"]),
            "speech_tokenizer": build_config(stm.SpeechTokenizerConfig,
                                             config["speech_tokenizer"])}


def tts_seconds_per_char(pins: Dict[str, int]) -> float:
    """The TTS engine's ``seconds_per_char`` that gives the pinned speech
    tokens over the text the NMT's pinned tokens spell: one letter a token
    after the forced language token."""
    return pins["tts_speech_tokens"] / (TEXT_FRAME_RATE * (pins["nmt_max_new_tokens"] - 1))


def _set(engine, name: str, value) -> None:
    if not hasattr(engine, name):
        raise AttributeError(f"{type(engine).__name__} has no {name!r}: the pin cannot be set")
    setattr(engine, name, value)


def _speak_letters(container: Dict[str, Any], table: str, letters: Dict[str, Any]) -> None:
    """Scale the embedding rows of the letters (their byte-tokenizer ids),
    and the rows of an int8 head copy, so a random tied head spells them."""
    lo, hi = letters["rows"]
    with torch.no_grad():
        container[table][lo:hi] *= letters["scale"]
        if "embed_q" in container:
            container["embed_q"]["scale"][lo:hi] *= letters["scale"]


def build(config: Dict[str, Any], traffic: Dict[str, Any], device, recorder: Recorder, *,
          quantize: bool = False) -> System:
    """Engines for ``config`` on ``device`` (``torch_engines`` with the three
    micro-batchers), the traffic's pins and batcher settings, the noise of
    the recorder's seed, and ``CascadedBackend`` over them. ``quantize`` serves the port's
    int8 decode path (the control)."""
    from expressive_speech_translation_tpu_torch.models import cosyvoice_official as com
    from expressive_speech_translation_tpu_torch.models import ecapa as ecm
    from expressive_speech_translation_tpu_torch.models import speech_tokenizer as stm
    from expressive_speech_translation_tpu_torch.pipeline.cascaded import CascadedBackend
    from expressive_speech_translation_tpu_torch.pipeline.torch_engines import torch_engines

    cfgs = port_configs(config)
    seeds, edits = config["seeds"], config["edits"]
    kwargs: Dict[str, Any] = dict(
        asr_cfg=cfgs["asr"], nmt_cfg=cfgs["nmt"], dtype=DTYPES[config["dtype"]],
        tts_ecapa=(ecm.init_ecapa(seeds["ecapa"], cfgs["ecapa"], device), cfgs["ecapa"]),
        tts_speech_tokenizer=(stm.init_speech_tokenizer(seeds["speech_tokenizer"],
                                                        cfgs["speech_tokenizer"], device),
                              cfgs["speech_tokenizer"]),
        tts_noise=recorder.noise_factory(device))
    eos_offset = edits["speech_eos_logit_offset"]
    if config["tts"]["chain"] == "official":
        params = com.init_official_tts(seeds["tts"], cfgs["tts"], device)
        params["lm"]["head"]["bias"][cfgs["tts"].lm.eos_speech] -= eos_offset
        kwargs["tts_official"] = (params, cfgs["tts"])
    else:
        kwargs["tts_cfg"] = cfgs["tts"]
    batch = traffic["batch"]
    engines = torch_engines(scale="reference", device=device, batch_asr=True, batch_nmt=True,
                            batch_tts=True, max_batch=batch["max_batch"],
                            batch_wait_ms=batch["batch_wait_ms"], quantize=quantize, **kwargs)
    stages = {"asr": engines.asr, "nmt": engines.nmt, "tts": engines.tts}
    asr, nmt, tts = (stages[s].engine for s in ("asr", "nmt", "tts"))
    pins = traffic["pins"]
    _set(asr, "max_new_tokens", pins["asr_max_new_tokens"])
    _set(nmt, "max_new_tokens", pins["nmt_max_new_tokens"])
    _set(tts, "seconds_per_char", tts_seconds_per_char(pins))
    _speak_letters(asr.params["decoder"], "embed", edits["letters"])
    _speak_letters(nmt.params, "embed", edits["letters"])
    if config["tts"]["chain"] != "official":
        with torch.no_grad():
            tts.params["lm"]["head"]["bias"][cfgs["tts"].lm.eos_speech] -= eos_offset
    return System(backend=CascadedBackend(engines), engines=engines, stages=stages,
                  recorder=recorder)
