"""Local checkpoint loading: torch / safetensors state dicts → the port's trees.

The port of the JAX package's ``models/loaders.py`` ``.pt`` loaders:
:func:`load_state_dict` reads a file or an HF-style model directory (never
the network), and ``load_cosyvoice_{llm,flow,hift}`` compose it with the
official CosyVoice2 converters. ``safetensors`` is imported only inside the
function that reads such a file.

Not ported yet (ROADMAP Queue 1 item 8): the Whisper / NLLB loaders and the
baked-model helpers (``save_converted``, ``load_converted``,
``bake_models``, ``load_official_tts``), which read and write orbax trees.
"""

from __future__ import annotations

import dataclasses
import json
import logging
from pathlib import Path
from typing import Any, Dict, Union

import torch

log = logging.getLogger(__name__)


class WeightsNotFoundError(FileNotFoundError):
    pass


def _load_safetensors(path: Path) -> Dict[str, Any]:
    from safetensors.torch import load_file

    return load_file(str(path))


def _load_torch(path: Path) -> Dict[str, Any]:
    """A pickled checkpoint: a strict ``weights_only`` load first, a legacy
    pickle after it; a module or a {"state_dict": ...} wrapper unwrapped."""
    try:
        state = torch.load(str(path), map_location="cpu", weights_only=True)
    except Exception:  # noqa: BLE001 — a legacy pickle
        log.warning("weights_only load failed for %s; retrying legacy pickle", path)
        state = torch.load(str(path), map_location="cpu", weights_only=False)
    if hasattr(state, "state_dict"):
        state = state.state_dict()
    if isinstance(state, dict) and "state_dict" in state:
        state = state["state_dict"]
    return state


def load_state_dict(path: Union[str, Path]) -> Dict[str, Any]:
    """A state dict from a file or an HF-style model directory (sharded
    safetensors through their index, or the first checkpoint file found)."""
    p = Path(path)
    if p.is_file():
        return _load_safetensors(p) if p.suffix == ".safetensors" else _load_torch(p)
    if not p.is_dir():
        raise WeightsNotFoundError(f"{p} does not exist — place the model checkpoint there "
                                   "(no network downloads in this environment)")
    index = p / "model.safetensors.index.json"
    if index.exists():
        shards = sorted({v for v in json.loads(index.read_text())["weight_map"].values()})
        state: Dict[str, Any] = {}
        for shard in shards:
            state.update(_load_safetensors(p / shard))
        return state
    for candidate in ("model.safetensors", "pytorch_model.bin", "model.pt", "llm.pt",
                      "diffusion_pytorch_model.safetensors", "diffusion_pytorch_model.bin",
                      "unet.pth"):
        if (p / candidate).exists():
            return load_state_dict(p / candidate)
    raise WeightsNotFoundError(
        f"no checkpoint found under {p} (looked for model.safetensors[.index.json], "
        "pytorch_model.bin, model.pt, llm.pt, diffusion_pytorch_model.*, unet.pth)")


def load_cosyvoice_llm(path: Union[str, Path], cfg=None, device=None):
    """Official CosyVoice2 ``llm.pt`` (or a directory holding ``llm.pt`` /
    ``model.pt``) → (speech-LM params on ``device``, SpeechLMConfig). Without
    ``cfg`` the dims come from the tensors, and a backbone other than
    Qwen2-0.5B needs an explicit cfg (head counts are not in the shapes)."""
    from . import cosyvoice as cv
    from . import qwen2 as q2

    p = Path(path)
    if p.is_dir():
        for candidate in ("llm.pt", "model.pt"):
            if (p / candidate).exists():
                p = p / candidate
                break
    state = load_state_dict(p)
    if cfg is None:
        hidden = state["llm_decoder.weight"].shape[1]
        n_layers = 1 + max(int(k.split(".")[4]) for k in state
                           if k.startswith("llm.model.model.layers."))
        base = q2.Qwen2Config.qwen2_05b()
        if hidden != base.hidden or n_layers != base.layers:
            raise ValueError(f"checkpoint dims (hidden {hidden}, layers {n_layers}) are not "
                             "Qwen2-0.5B — pass an explicit SpeechLMConfig")
        text = state.get("llm.model.model.embed_tokens.weight")
        cfg = cv.SpeechLMConfig(backbone=base,
                                text_vocab=text.shape[0] if text is not None else 151_936,
                                speech_token_size=state["speech_embedding.weight"].shape[0] - 3)
    return cv.from_cosyvoice_llm_state_dict(state, cfg, device), cfg


def load_cosyvoice_flow(path: Union[str, Path], cfg=None, device=None):
    """Official CosyVoice2 ``flow.pt`` → (params on ``device``,
    OfficialFlowConfig). Without ``cfg`` the widths and block counts come
    from the tensors (the conformer's heads from ``pos_bias_u`` [heads,
    head_dim]); the estimator's heads follow cosyvoice2.yaml, as they are not
    in the shapes."""
    from . import flow_matcha as fm

    state = load_state_dict(path)
    if cfg is None:
        vocab, input_size = state["input_embedding.weight"].shape
        n_mels, spk_dim = state["spk_embed_affine_layer.weight"].shape

        def count(prefix, segment):
            return 1 + max(int(k.split(".")[segment]) for k in state if k.startswith(prefix))

        base = fm.OfficialFlowConfig()
        cfg = dataclasses.replace(
            base, vocab_size=int(vocab), input_size=int(input_size), output_size=int(n_mels),
            spk_embed_dim=int(spk_dim),
            encoder=dataclasses.replace(
                base.encoder, size=int(input_size),
                blocks=count("encoder.encoders.", 2), up_blocks=count("encoder.up_encoders.", 2),
                heads=int(state["encoder.encoders.0.self_attn.pos_bias_u"].shape[0]),
                linear_units=int(state["encoder.encoders.0.feed_forward.w_1.weight"].shape[0])),
            estimator=dataclasses.replace(
                base.estimator,
                in_channels=int(state["decoder.estimator.time_mlp.linear_1.weight"].shape[1]),
                out_channels=int(n_mels),
                channels=int(state["decoder.estimator.final_proj.weight"].shape[1]),
                # decoder.estimator.mid_blocks.{i}.{0 | 1.{j}}.…: the block index is
                # segment 3, the transformer block's segment 5
                num_mid_blocks=count("decoder.estimator.mid_blocks.", 3),
                n_blocks=count("decoder.estimator.mid_blocks.0.1.", 5)),
        )
    return fm.from_flow_state_dict(state, cfg, device), cfg


def load_cosyvoice_hift(path: Union[str, Path], cfg=None, device=None):
    """Official CosyVoice2 ``hift.pt`` → (params on ``device``, HiFTConfig)."""
    from . import hift as hm

    cfg = cfg or hm.HiFTConfig()
    return hm.from_hift_state_dict(load_state_dict(path), cfg, device), cfg
