"""The official CosyVoice2 chain's config and seeded init: a frozen copy of
the port's ``models/cosyvoice_official.py`` (the speech LM of
``cosyvoice.py``, the matcha flow of ``flow_matcha.py``, HiFT of
``hift.py``)."""

from __future__ import annotations

import dataclasses


from .device import resolve_device
from . import cosyvoice as cv
from . import flow_matcha as fm
from . import hift as hm
from . import qwen2 as q2
from .common import Init, Params


@dataclasses.dataclass(frozen=True)
class OfficialTtsConfig:
    lm: cv.SpeechLMConfig = dataclasses.field(default_factory=cv.SpeechLMConfig)
    flow: fm.OfficialFlowConfig = dataclasses.field(default_factory=fm.OfficialFlowConfig)
    hift: hm.HiFTConfig = dataclasses.field(default_factory=hm.HiFTConfig)
    sample_rate: int = 24_000

    @classmethod
    def tiny(cls) -> "OfficialTtsConfig":
        return cls(
            lm=cv.SpeechLMConfig(
                backbone=q2.Qwen2Config(hidden=32, layers=1, heads=4, kv_heads=2, ffn_dim=64,
                                        max_positions=512),
                text_vocab=128, speech_token_size=61),
            flow=dataclasses.replace(fm.OfficialFlowConfig.tiny(), vocab_size=64, output_size=8),
            hift=hm.HiFTConfig.tiny(),
        )


def init_official_tts(seed: int, cfg: OfficialTtsConfig, device=None) -> Params:
    """Seeded random {"lm", "flow", "hift"} (f32) on ``device``; with
    ``cfg.lm.mtp`` > 1 the LM's MTP heads, drawn last."""
    r = Init(seed, resolve_device(device))
    params = {"lm": cv.init_speech_lm(r, cfg.lm), "flow": fm.init_official_flow(r, cfg.flow),
              "hift": hm.init_hift(r, cfg.hift)}
    if cfg.lm.mtp > 1:
        params["lm"]["mtp_heads"] = cv.init_mtp_heads(r, cfg.lm)
    return params


# ================================================================ streaming


