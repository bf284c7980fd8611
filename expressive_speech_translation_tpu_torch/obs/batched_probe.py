"""Whether a second set of reference-width engines held on the card changes
``chip_smoke.py``'s batched phase (the e2e phase's engines stay resident
through it for the streaming phase): ``chip_smoke.batched_phase`` four times
in one process, in turns, with reference-width engines initialised and held
("resident") and with none ("freed"): resident, freed, freed, resident.

    python3 -m expressive_speech_translation_tpu_torch.obs.batched_probe

Run from the repository root (it imports ``chip_smoke``). Prints each turn's
requests per second, wall, peak memory and a request's stage split, and
writes ``chiprun_out/batched_probe.json``. Needs a card and nvcc.
"""

from __future__ import annotations

import gc
import json
import math
import os
import sys

import torch

import chip_smoke
from expressive_speech_translation_tpu_torch.models import ecapa
from expressive_speech_translation_tpu_torch.models import speech_tokenizer as stm
from expressive_speech_translation_tpu_torch.obs.perf import card_line
from expressive_speech_translation_tpu_torch.ops import build
from expressive_speech_translation_tpu_torch.pipeline.cascaded import CascadedBackend
from expressive_speech_translation_tpu_torch.pipeline.torch_engines import torch_engines

TURNS = ("resident", "freed", "freed", "resident")


def main() -> int:
    if not torch.cuda.is_available():
        print("batched_probe: no CUDA device", file=sys.stderr)
        return 1
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    dev = torch.device("cuda")
    card = card_line()
    print(card, flush=True)
    build.build()
    no_serial = {"requests": [{"audio_s": chip_smoke.BATCH_SECONDS, "wall_s": math.nan}]}
    rows = []
    for turn in TURNS:
        held = None
        if turn == "resident":
            ecfg, scfg = ecapa.EcapaConfig(), stm.SpeechTokenizerConfig()
            held = CascadedBackend(torch_engines(
                scale="reference", tts_ecapa=(ecapa.init_ecapa(3, ecfg, dev), ecfg),
                tts_speech_tokenizer=(stm.init_speech_tokenizer(4, scfg, dev), scfg)))
            held.initialize()
        b = chip_smoke.batched_phase(dev, {}, card, no_serial)
        rows.append({"turn": turn, "requests_per_s": b["requests_per_s"], "wall_s": b["wall_s"],
                     "peak_memory_gib": b["peak_memory_gib"],
                     "resident_before_gib": b["resident_before_gib"],
                     "request_stages_s": b["requests"][0]["stages_s"]})
        print(f"TURN {turn}: {b['requests_per_s']:.4f} requests/s, wall {b['wall_s']:.3f} s, "
              f"a request's stages {rows[-1]['request_stages_s']}  [{card}]", flush=True)
        del held, b
        gc.collect()
        torch.cuda.empty_cache()
    os.makedirs(chip_smoke.OUT_DIR, exist_ok=True)
    with open(os.path.join(chip_smoke.OUT_DIR, "batched_probe.json"), "w") as f:
        json.dump({"card": card, "turns": rows}, f, indent=1)
    return 0


if __name__ == "__main__":
    sys.exit(main())
