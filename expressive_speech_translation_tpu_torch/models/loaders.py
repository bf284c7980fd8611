"""Local checkpoint loading and the baked-model layout.

The port of the JAX package's ``models/loaders.py``, with torch alone:

- :func:`load_state_dict` reads a file or an HF-style model directory (never
  the network): safetensors through the port's own reader
  (``safetensors_io``), pickled ``.pt`` / ``.bin`` through ``torch.load``;
- ``load_whisper`` / ``load_nllb`` / ``load_ecapa`` / ``load_qwen2_backbone``,
  ``load_cosyvoice_{llm,flow,hift}``, ``load_musetalk`` and ``load_diff2lip``
  compose it with each model's converter, the dims read from
  ``config.json`` or the tensors;
- the bake: :func:`bake_models` (and the CLI, :func:`main`) converts
  checkpoints once into stage directories (``asr/``, ``nmt/``, ``ecapa/``,
  ``speech_tokenizer/``, ``tts_llm/``, ``tts_flow/``, ``tts_hift/``,
  ``musetalk/``, ``musetalk_whisper/``, ``diff2lip/``), each
  a ``config.json`` (the JAX package's schema, ``dataclasses.asdict`` of the
  config) and a ``params.safetensors`` holding the port's tree flattened to
  ``.``-joined key paths, list indices as numbers. The JAX package bakes
  orbax trees, which torch cannot read; :func:`load_converted` refuses such
  a directory. ``torch_engines`` serves the bake under ``EST_MODELS_DIR``::

      python -m expressive_speech_translation_tpu_torch.models.loaders \\
          --asr DIR --nmt DIR --tts DIR --ecapa DIR [--musetalk DIR]
          [--musetalk-whisper DIR] [--diff2lip CKPT] --out DIR [--device cpu]
"""

from __future__ import annotations

import dataclasses
import json
import logging
import typing
from pathlib import Path
from typing import Any, Dict, Optional, Union

import torch

from ..core.device import resolve_device
from .common import cast_floats
from .safetensors_io import read_safetensors, write_safetensors

log = logging.getLogger(__name__)

PathLike = Union[str, Path]


class WeightsNotFoundError(FileNotFoundError):
    pass


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


def load_state_dict(path: PathLike) -> Dict[str, Any]:
    """A state dict from a file or an HF-style model directory (sharded
    safetensors through their index, or the first checkpoint file found)."""
    p = Path(path)
    if p.is_file():
        return read_safetensors(p) if p.suffix == ".safetensors" else _load_torch(p)
    if not p.is_dir():
        raise WeightsNotFoundError(f"{p} does not exist — place the model checkpoint there "
                                   "(no network downloads in this environment)")
    index = p / "model.safetensors.index.json"
    if index.exists():
        shards = sorted({v for v in json.loads(index.read_text())["weight_map"].values()})
        state: Dict[str, Any] = {}
        for shard in shards:
            state.update(read_safetensors(p / shard))
        return state
    for candidate in ("model.safetensors", "pytorch_model.bin", "model.pt", "llm.pt",
                      "diffusion_pytorch_model.safetensors", "diffusion_pytorch_model.bin",
                      "unet.pth"):
        if (p / candidate).exists():
            return load_state_dict(p / candidate)
    raise WeightsNotFoundError(
        f"no checkpoint found under {p} (looked for model.safetensors[.index.json], "
        "pytorch_model.bin, model.pt, llm.pt, diffusion_pytorch_model.*, unet.pth)")


# ------------------------------------------------------------- HF checkpoints


def load_whisper(path: PathLike, cfg=None, device=None):
    """A local HF Whisper directory → (params on ``device``, WhisperConfig),
    the dims and special ids from ``config.json``. English-only (``.en``,
    vocabulary 51,864) checkpoints, whose special-token layout the
    multilingual prompt does not speak, are refused; large-v3 (51,866) adds
    one language token, so every special id after the language block moves
    up by one."""
    from . import whisper as wm

    p = Path(path)
    if cfg is None and (p / "config.json").exists():
        hf = json.loads((p / "config.json").read_text())
        if hf["vocab_size"] == 51_864:
            raise WeightsNotFoundError(
                f"whisper checkpoint at {p} has the English-only (.en) vocab layout (51864): "
                "unsupported — use a multilingual checkpoint")
        v3 = hf["vocab_size"] == 51_866
        shift = 1 if v3 else 0
        cfg = wm.WhisperConfig(
            n_mels=hf.get("num_mel_bins", 80), d_model=hf["d_model"],
            encoder_layers=hf["encoder_layers"], decoder_layers=hf["decoder_layers"],
            heads=hf["encoder_attention_heads"], ffn_dim=hf["encoder_ffn_dim"],
            vocab_size=hf["vocab_size"],
            max_source_positions=hf.get("max_source_positions", 1500),
            max_target_positions=hf.get("max_target_positions", 448),
            bos_token=hf.get("decoder_start_token_id", 50258),
            eos_token=hf.get("eos_token_id", 50257),
            n_langs=100 if v3 else 99,
            task_translate=50_358 + shift, task_transcribe=50_359 + shift,
            sop_token=50_361 + shift, no_speech_token=50_362 + shift,
            no_timestamps=50_363 + shift)
    cfg = cfg or wm.WhisperConfig.medium()
    return wm.from_hf_state_dict(load_state_dict(p), cfg, device), cfg


def load_nllb(path: PathLike, cfg=None, device=None):
    """A local HF NLLB (M2M100) directory → (params on ``device``,
    NLLBConfig), the dims from ``config.json``."""
    from . import nllb as nlm

    p = Path(path)
    if cfg is None and (p / "config.json").exists():
        hf = json.loads((p / "config.json").read_text())
        cfg = nlm.NLLBConfig(
            d_model=hf["d_model"], encoder_layers=hf["encoder_layers"],
            decoder_layers=hf["decoder_layers"], heads=hf["encoder_attention_heads"],
            ffn_dim=hf["encoder_ffn_dim"], vocab_size=hf["vocab_size"],
            max_positions=hf.get("max_position_embeddings", 1024))
    cfg = cfg or nlm.NLLBConfig.distilled_600m()
    return nlm.from_hf_state_dict(load_state_dict(p), cfg, device), cfg


def load_ecapa(path: PathLike, cfg=None, device=None):
    """speechbrain ``spkrec-ecapa-voxceleb``'s ``embedding_model.ckpt`` (or a
    directory holding it) → (params on ``device``, EcapaConfig). Without
    ``cfg`` the widths come from the tensors (``spkrec-ecapa-voxceleb``'s
    give ``EcapaConfig()``)."""
    from . import ecapa as ecm

    p = Path(path)
    if p.is_dir():
        for candidate in ("embedding_model.ckpt", "embedding_model.pt", "model.ckpt"):
            if (p / candidate).exists():
                p = p / candidate
                break
    state = {k.removeprefix("embedding_model."): v for k, v in load_state_dict(p).items()}
    if cfg is None:
        channels, n_mels, _ = state["blocks.0.conv.conv.weight"].shape
        cfg = ecm.EcapaConfig(
            n_mels=int(n_mels), channels=int(channels),
            mfa_out=int(state["mfa.conv.conv.weight"].shape[0]),
            bottleneck=int(state["blocks.1.se_block.conv1.conv.weight"].shape[0]),
            scale=1 + len({k.split(".")[4] for k in state
                           if k.startswith("blocks.1.res2net_block.blocks.")}),
            embed_dim=int(state["fc.conv.weight"].shape[0]),
            attn_channels=int(state["asp.tdnn.conv.conv.weight"].shape[0]))
    return ecm.from_speechbrain_state_dict(state, cfg, device), cfg


def load_qwen2_backbone(path: PathLike, cfg=None, device=None):
    """A local HF Qwen2 directory → (backbone params on ``device``,
    Qwen2Config), the dims from ``config.json``."""
    from . import qwen2 as q2

    p = Path(path)
    if cfg is None and (p / "config.json").exists():
        hf = json.loads((p / "config.json").read_text())
        cfg = q2.Qwen2Config(
            hidden=hf["hidden_size"], layers=hf["num_hidden_layers"],
            heads=hf["num_attention_heads"], kv_heads=hf["num_key_value_heads"],
            ffn_dim=hf["intermediate_size"], rope_theta=hf.get("rope_theta", 1_000_000.0),
            max_positions=hf.get("max_position_embeddings", 4096))
    cfg = cfg or q2.Qwen2Config.qwen2_05b()
    return q2.from_hf_state_dict(load_state_dict(p), cfg, device), cfg


# -------------------------------------------------------- official CosyVoice2


def load_cosyvoice_llm(path: PathLike, cfg=None, device=None):
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


def load_cosyvoice_flow(path: PathLike, cfg=None, device=None):
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


def load_cosyvoice_hift(path: PathLike, cfg=None, device=None):
    """Official CosyVoice2 ``hift.pt`` → (params on ``device``, HiFTConfig)."""
    from . import hift as hm

    cfg = cfg or hm.HiFTConfig()
    return hm.from_hift_state_dict(load_state_dict(path), cfg, device), cfg


# ------------------------------------------------------------------- MuseTalk


def load_musetalk(path: PathLike, cfg=None, device=None):
    """The MuseTalk release layout → ({"vae", "unet"} params on ``device``,
    MuseTalkConfig): ``sd-vae-ft-mse/`` (or ``vae/``, or the root) holding a
    diffusers AutoencoderKL, and ``musetalk/pytorch_model.bin`` (or
    ``unet.pth``) with ``musetalk.json``. Without ``cfg`` the dims are read
    from the two JSONs."""
    from . import musetalk as mtm

    root = Path(path)
    vae_dir = next((d for d in (root / "sd-vae-ft-mse", root / "vae", root)
                    if (d / "config.json").exists()
                    and any((d / f).exists() for f in (
                        "diffusion_pytorch_model.safetensors", "diffusion_pytorch_model.bin",
                        "model.safetensors", "pytorch_model.bin"))), None)
    unet_file = next((f for f in (root / "musetalk" / "pytorch_model.bin",
                                  root / "musetalk" / "unet.pth", root / "unet.pth",
                                  root / "pytorch_model.bin") if f.exists()), None)
    if vae_dir is None or unet_file is None:
        raise WeightsNotFoundError(
            f"MuseTalk checkpoints not found under {root} — expected "
            "sd-vae-ft-mse/ (diffusers AutoencoderKL) and musetalk/"
            "pytorch_model.bin (+ musetalk.json)")
    if cfg is None:
        vae_hf = json.loads((vae_dir / "config.json").read_text())
        kwargs: Dict[str, Any] = dict(
            vae_channels=tuple(vae_hf.get("block_out_channels", (128, 256, 512, 512))),
            vae_layers=vae_hf.get("layers_per_block", 2),
            latent_channels=vae_hf.get("latent_channels", 4),
            image_size=256,
            norm_groups=vae_hf.get("norm_num_groups", 32))
        unet_json = next((f for f in (unet_file.parent / "musetalk.json", root / "musetalk.json")
                          if f.exists()), None)
        if unet_json is not None:
            u = json.loads(unet_json.read_text())
            kwargs.update(
                unet_channels=tuple(u.get("block_out_channels", (320, 640, 1280, 1280))),
                unet_layers=u.get("layers_per_block", 2),
                audio_dim=u.get("cross_attention_dim", 384),
                heads=u.get("attention_head_dim", 8))
        cfg = mtm.MuseTalkConfig(**kwargs)
    params = mtm.from_hf_state_dict(load_state_dict(vae_dir), load_state_dict(unet_file), cfg,
                                    device)
    return params, cfg


def load_diff2lip(path: PathLike, cfg=None, device=None):
    """diff2lip's pickled TFGModel checkpoint (a file, or a directory
    holding ``checkpoint.pt``, ``model.pt``, ``e2e.pt`` or ``data.pkl``) →
    (params on ``device``, Diff2LipConfig; the published e2e geometry
    unless ``cfg`` is given)."""
    from . import gd_unet
    from ..pipeline.diff2lip import Diff2LipConfig

    p = Path(path)
    if p.is_dir():
        for candidate in ("checkpoint.pt", "model.pt", "e2e.pt", "data.pkl"):
            if (p / candidate).exists():
                p = p / candidate
                break
    cfg = cfg or Diff2LipConfig()
    return gd_unet.from_tfg_state_dict(load_state_dict(p), cfg.unet, device), cfg


# ------------------------------------------------------------------ the bake


def _flatten(tree, prefix: str, out: Dict[str, torch.Tensor]) -> Dict[str, torch.Tensor]:
    """Nested dicts / lists of tensors → {``.``-joined key path: tensor}, list
    indices as numbers. Refuses what :func:`_unflatten` could not rebuild: an
    empty container, a key with a dot, a dict key that is a number."""
    if isinstance(tree, (dict, list, tuple)):
        items = tree.items() if isinstance(tree, dict) else enumerate(tree)
        if not tree:
            raise ValueError(f"empty container at {prefix or '<root>'}: the flat layout "
                             "cannot hold it")
        for key, value in items:
            if isinstance(tree, dict) and ("." in key or key.isdigit()):
                raise ValueError(f"key {key!r} at {prefix or '<root>'}: the flat layout "
                                 "joins keys with dots and reads numbers as list indices")
            _flatten(value, f"{prefix}.{key}" if prefix else str(key), out)
    elif torch.is_tensor(tree):
        out[prefix] = tree
    else:
        raise TypeError(f"leaf at {prefix} is a {type(tree).__name__}, not a tensor")
    return out


def _unflatten(flat: Dict[str, torch.Tensor]):
    """The inverse of :func:`_flatten`: a node whose keys are 0..n-1 is a list."""
    root: Dict[str, Any] = {}
    for path, value in flat.items():
        node = root
        *parents, leaf = path.split(".")
        for key in parents:
            node = node.setdefault(key, {})
        node[leaf] = value

    def lists(node):
        if not isinstance(node, dict):
            return node
        out = {k: lists(v) for k, v in node.items()}
        if all(k.isdigit() for k in out):
            if sorted(int(k) for k in out) != list(range(len(out))):
                raise ValueError(f"list indices {sorted(out)} are not 0..{len(out) - 1}")
            return [out[str(i)] for i in range(len(out))]
        return out

    return lists(root)


def save_converted(params, cfg, out_dir: PathLike) -> None:
    """Write a converted tree and its config as a stage directory:
    ``config.json`` (``dataclasses.asdict``, as the JAX package writes it)
    and ``params.safetensors`` (the tree flattened)."""
    out = Path(out_dir)
    out.mkdir(parents=True, exist_ok=True)
    write_safetensors(_flatten(params, "", {}), out / "params.safetensors",
                      metadata={"format": "pt"})
    (out / "config.json").write_text(json.dumps(dataclasses.asdict(cfg), indent=2))


def _cfg_from_dict(cfg_cls, raw: Dict[str, Any]):
    """Rebuild a (possibly nested) frozen-dataclass config from asdict()
    output; lists come back as the tuples the dataclasses declare."""
    hints = typing.get_type_hints(cfg_cls)
    kwargs = {}
    for f in dataclasses.fields(cfg_cls):
        if f.name not in raw:
            continue
        v = raw[f.name]
        ftype = hints.get(f.name, f.type)
        if dataclasses.is_dataclass(ftype) and isinstance(v, dict):
            v = _cfg_from_dict(ftype, v)
        elif isinstance(v, list):
            v = tuple(tuple(e) if isinstance(e, list) else e for e in v)
        kwargs[f.name] = v
    return cfg_cls(**kwargs)


def load_converted(out_dir: PathLike, cfg_cls, device=None, dtype=None):
    """A stage directory written by :func:`save_converted` → (params on
    ``device``, floating leaves in ``dtype`` or as stored; the config).
    A directory holding the JAX package's orbax tree (``params/``) and no
    ``params.safetensors`` is refused: torch cannot read orbax."""
    out = Path(out_dir)
    if not (out / "config.json").exists():
        raise WeightsNotFoundError(f"no converted checkpoint at {out}")
    if not (out / "params.safetensors").exists():
        if (out / "params").is_dir():
            raise WeightsNotFoundError(
                f"{out} holds an orbax tree (params/, the JAX package's bake), which the port "
                "cannot read; bake the checkpoints for the port: python -m "
                "expressive_speech_translation_tpu_torch.models.loaders --asr DIR --nmt DIR "
                "--tts DIR --ecapa DIR --out DIR")
        raise WeightsNotFoundError(f"{out} has config.json but no params.safetensors")
    cfg = _cfg_from_dict(cfg_cls, json.loads((out / "config.json").read_text()))
    dev = resolve_device(device)
    params = _unflatten({k: v.to(dev) for k, v in
                         read_safetensors(out / "params.safetensors").items()})
    return (cast_floats(params, dtype) if dtype is not None else params), cfg


def load_official_tts(models_root: PathLike, device=None, dtype=None):
    """Baked ``tts_llm/``, ``tts_flow/`` and ``tts_hift/`` → ({"lm", "flow",
    "hift"} params, OfficialTtsConfig). Raises WeightsNotFoundError unless
    all three are there: the official chain needs the whole triple."""
    from . import cosyvoice as cv
    from . import cosyvoice_official as com
    from . import flow_matcha as fm
    from . import hift as hm

    root = Path(models_root)
    lm, lm_cfg = load_converted(root / "tts_llm", cv.SpeechLMConfig, device, dtype)
    flow, flow_cfg = load_converted(root / "tts_flow", fm.OfficialFlowConfig, device, dtype)
    hift, hift_cfg = load_converted(root / "tts_hift", hm.HiFTConfig, device, dtype)
    return ({"lm": lm, "flow": flow, "hift": hift},
            com.OfficialTtsConfig(lm=lm_cfg, flow=flow_cfg, hift=hift_cfg))


_NOT_PORTED = ("openvoice", "seamless")


def bake_models(out_root: PathLike, *, asr: Optional[str] = None, nmt: Optional[str] = None,
                tts: Optional[str] = None, ecapa: Optional[str] = None,
                musetalk: Optional[str] = None, musetalk_whisper: Optional[str] = None,
                diff2lip: Optional[str] = None, openvoice: Optional[str] = None,
                seamless: Optional[str] = None, tts_llm_cfg=None, tts_flow_cfg=None,
                tts_hift_cfg=None, device=None) -> None:
    """Convert checkpoints into stage directories under ``out_root``:
    ``asr/`` (HF Whisper), ``nmt/`` (HF NLLB), ``ecapa/`` (speechbrain),
    ``musetalk/`` (the MuseTalk release layout, :func:`load_musetalk`),
    ``musetalk_whisper/`` (HF whisper-tiny, MuseTalk's audio condition),
    ``diff2lip/`` (a TFGModel checkpoint, :func:`load_diff2lip`) and from a
    CosyVoice2 directory ``tts_llm/``, ``tts_flow/``, ``tts_hift/``
    (whichever of ``llm.pt`` / ``model.pt``, ``flow.pt``, ``hift.pt`` it
    holds). The trees are converted on ``device``. The JAX package's other
    families (OpenVoice, Seamless) are not ported."""
    asked = [name for name, path in zip(_NOT_PORTED, (openvoice, seamless)) if path]
    if asked:
        raise NotImplementedError(f"baking {', '.join(asked)} is not ported yet: ROADMAP.md "
                                  "Queue 1 item 13 (the alternate backends, training)")
    out = Path(out_root)
    if musetalk:
        save_converted(*load_musetalk(musetalk, device=device), out / "musetalk")
        log.info("baked MuseTalk %s -> %s", musetalk, out / "musetalk")
    if musetalk_whisper:
        # the conditioning encoder (whisper-tiny for the published UNet),
        # apart from the ASR bake, whose scale is Whisper-medium
        save_converted(*load_whisper(musetalk_whisper, device=device), out / "musetalk_whisper")
        log.info("baked MuseTalk whisper %s -> %s", musetalk_whisper, out / "musetalk_whisper")
    if diff2lip:
        save_converted(*load_diff2lip(diff2lip, device=device), out / "diff2lip")
        log.info("baked diff2lip %s -> %s", diff2lip, out / "diff2lip")
    if ecapa:
        save_converted(*load_ecapa(ecapa, device=device), out / "ecapa")
        log.info("baked ECAPA %s -> %s", ecapa, out / "ecapa")
    if asr:
        save_converted(*load_whisper(asr, device=device), out / "asr")
        log.info("baked ASR %s -> %s", asr, out / "asr")
    if nmt:
        save_converted(*load_nllb(nmt, device=device), out / "nmt")
        log.info("baked NMT %s -> %s", nmt, out / "nmt")
    if tts:
        p = Path(tts)
        baked = []
        if p.is_file() or (p / "llm.pt").exists() or (p / "model.pt").exists():
            save_converted(*load_cosyvoice_llm(tts, tts_llm_cfg, device), out / "tts_llm")
            baked.append("llm")
        if p.is_dir() and (p / "flow.pt").exists():
            save_converted(*load_cosyvoice_flow(p / "flow.pt", tts_flow_cfg, device),
                           out / "tts_flow")
            baked.append("flow")
        if p.is_dir() and (p / "hift.pt").exists():
            save_converted(*load_cosyvoice_hift(p / "hift.pt", tts_hift_cfg, device),
                           out / "tts_hift")
            baked.append("hift")
        if not baked:
            raise WeightsNotFoundError(f"no CosyVoice checkpoints under {p} (looked for "
                                       "llm.pt/model.pt, flow.pt, hift.pt)")
        log.info("baked TTS submodels %s from %s -> %s", baked, tts, out)


def main(argv=None) -> int:
    """Bake checkpoints for the port:
    python -m expressive_speech_translation_tpu_torch.models.loaders
    --asr DIR --nmt DIR --tts DIR --ecapa DIR [--diff2lip CKPT] --out DIR"""
    import argparse

    ap = argparse.ArgumentParser(description=main.__doc__)
    ap.add_argument("--asr", help="HF Whisper checkpoint dir")
    ap.add_argument("--nmt", help="HF NLLB checkpoint dir")
    ap.add_argument("--tts", help="CosyVoice2 checkpoint dir (llm.pt, flow.pt, hift.pt)")
    ap.add_argument("--ecapa", help="speechbrain ECAPA checkpoint (file or dir)")
    ap.add_argument("--musetalk", help="MuseTalk release dir (sd-vae-ft-mse/ + musetalk/)")
    ap.add_argument("--musetalk-whisper", help="HF whisper-tiny dir (MuseTalk's audio condition)")
    ap.add_argument("--diff2lip", help="diff2lip TFG checkpoint (file, or dir with e2e.pt etc.)")
    for name in _NOT_PORTED:
        ap.add_argument(f"--{name.replace('_', '-')}", help="not ported (ROADMAP Queue 1 item 13)")
    ap.add_argument("--out", required=True, help="output root for the stage directories")
    ap.add_argument("--device", help="where the trees are converted (default: the card; "
                                     "'cpu' on a machine without one)")
    args = ap.parse_args(argv)
    bake_models(args.out, asr=args.asr, nmt=args.nmt, tts=args.tts, ecapa=args.ecapa,
                musetalk=args.musetalk, musetalk_whisper=args.musetalk_whisper,
                diff2lip=args.diff2lip, device=args.device,
                **{name: getattr(args, name) for name in _NOT_PORTED})
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
