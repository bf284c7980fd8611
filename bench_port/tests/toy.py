"""Toy-width cells for the CPU tests: the configurations' structure at
widths a test run holds, the traffic with a short window."""

from __future__ import annotations

import copy
import json

from bench_port.lib.spec import BENCH, Cell


def _config(name: str) -> dict:
    return json.loads((BENCH / "configs" / f"{name}.json").read_text())


def toy_config(chain: str = "native") -> dict:
    cfg = _config("mcf-official" if chain == "official" else "mcf-native")
    cfg["dtype"] = "float32"
    cfg["asr"].update(d_model=64, encoder_layers=2, decoder_layers=2, heads=4, ffn_dim=128)
    cfg["nmt"].update(d_model=64, encoder_layers=2, decoder_layers=2, heads=4, ffn_dim=128,
                      vocab_size=384)
    cfg["ecapa"].update(channels=128, bottleneck=64, attn_channels=64, mfa_out=384)
    cfg["speech_tokenizer"].update(dim=64, layers=1, heads=4)
    tts = cfg["tts"]["config"]
    tts["lm"]["backbone"].update(hidden=64, layers=2, heads=4, kv_heads=2, ffn_dim=128,
                                 max_positions=2048)
    tts["lm"].update(text_vocab=384, speech_token_size=512)
    if chain == "official":
        from expressive_speech_translation_tpu_torch.models import cosyvoice_official as com
        import dataclasses
        tiny = dataclasses.asdict(com.OfficialTtsConfig.tiny())
        tts["flow"] = tiny["flow"]
        tts["flow"].update(vocab_size=512, output_size=80, spk_embed_dim=192)
        tts["flow"]["estimator"].update(in_channels=320, out_channels=80)
        tts["hift"] = tiny["hift"]
        tts["hift"].update(in_channels=80)
    else:
        tts["flow"].update(token_vocab=515, dim=64, layers=2, heads=4)
        tts["vocoder"].update(base_channels=64)
    cfg["kernels"] = []
    return cfg


def toy_cell(chain: str = "native", loop: str = "closed") -> Cell:
    traffic = copy.deepcopy(json.loads((BENCH / "traffic" / "c16-10s.json").read_text()))
    traffic["batch"]["max_batch"] = 4
    traffic["clients"] = 4
    if loop == "open":
        del traffic["clients"]
        traffic.update(loop="open", rate_per_s=2.0, uploaders=8, inputs=4)
    traffic["utterance_seconds"] = 2.0
    spec = json.loads((BENCH.parent / "BENCHMARK.json").read_text())
    e2e = spec["end_to_end"]
    per = [m for m in spec["per_layer"]]
    return Cell(name="toy", chips=1, config=toy_config(chain), traffic=traffic,
                end_to_end=e2e, per_layer=per)
