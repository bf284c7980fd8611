"""The port's trees written back in the published checkpoints' naming.

``chip_smoke.py``'s checkpoints phase writes seeded random trees at the
published widths in the published formats and loads them back through
``models/loaders.py``; these emitters are the inverse of the converters:

- :func:`whisper_hf_state_dict` / :func:`whisper_hf_config`: HF
  ``WhisperForConditionalGeneration`` (``model.safetensors`` + ``config.json``);
- :func:`nllb_hf_state_dict` / :func:`nllb_hf_config`: HF
  ``M2M100ForConditionalGeneration`` (``pytorch_model.bin`` + ``config.json``);
- :func:`ecapa_speechbrain_state_dict`: speechbrain's ``ECAPA_TDNN``
  (``embedding_model.ckpt``);
- :func:`cosyvoice_llm_state_dict`: the official CosyVoice2 ``Qwen2LM``
  (``llm.pt``);
- :func:`musetalk_vae_state_dict` / :func:`musetalk_unet_state_dict` and
  :func:`write_musetalk`: the MuseTalk release layout (a diffusers
  ``AutoencoderKL`` directory, ``sd-vae-ft-mse/``, and the UNet's
  ``musetalk/pytorch_model.bin`` with ``musetalk.json``);
- :func:`diff2lip_tfg_state_dict` and :func:`write_diff2lip`: diff2lip's
  pickled TFGModel (``e2e.pt``), the attention's qkv re-interleaved
  head-major as the legacy checkpoints hold it.

Tied weights are one tensor under each of their names, as ``state_dict()``
gives them; every other value is a contiguous copy on the host.
"""

from __future__ import annotations

import json
from pathlib import Path
from typing import Dict

import torch

State = Dict[str, torch.Tensor]


def _host(t: torch.Tensor) -> torch.Tensor:
    return t.detach().to("cpu").contiguous()


def _linear(out: State, name: str, p, *, bias: bool = True) -> None:
    out[f"{name}.weight"] = _host(p["kernel"].T)
    if bias:
        out[f"{name}.bias"] = _host(p["bias"])


def _ln(out: State, name: str, p) -> None:
    out[f"{name}.weight"] = _host(p["scale"])
    out[f"{name}.bias"] = _host(p["bias"])


def _pre_ln_block(out: State, base: str, p, *, k_bias: bool) -> None:
    """The inverse of ``common.hf_pre_ln_block``."""
    attns = [("self_attn", "self_attn")]
    if "cross_attn" in p:
        attns.append(("cross_attn", "encoder_attn"))
    for ours, hf in attns:
        for proj, name in (("q", "q"), ("k", "k"), ("v", "v"), ("o", "out")):
            _linear(out, f"{base}.{hf}.{name}_proj", p[ours][proj], bias=proj != "k" or k_bias)
        _ln(out, f"{base}.{hf}_layer_norm", p[f"{ours}_ln"])
    _linear(out, f"{base}.fc1", p["mlp"]["fc1"])
    _linear(out, f"{base}.fc2", p["mlp"]["fc2"])
    _ln(out, f"{base}.final_layer_norm", p["mlp_ln"])


def whisper_hf_config(cfg) -> dict:
    """``config.json`` of an HF Whisper checkpoint of ``cfg``'s dims."""
    return {"model_type": "whisper", "architectures": ["WhisperForConditionalGeneration"],
            "vocab_size": cfg.vocab_size, "num_mel_bins": cfg.n_mels, "d_model": cfg.d_model,
            "encoder_layers": cfg.encoder_layers, "decoder_layers": cfg.decoder_layers,
            "encoder_attention_heads": cfg.heads, "decoder_attention_heads": cfg.heads,
            "encoder_ffn_dim": cfg.ffn_dim, "decoder_ffn_dim": cfg.ffn_dim,
            "max_source_positions": cfg.max_source_positions,
            "max_target_positions": cfg.max_target_positions,
            "decoder_start_token_id": cfg.bos_token, "bos_token_id": cfg.eos_token,
            "eos_token_id": cfg.eos_token, "pad_token_id": cfg.eos_token,
            "torch_dtype": "float32"}


def whisper_hf_state_dict(params, cfg) -> State:
    """The port's Whisper tree → ``WhisperForConditionalGeneration``'s state
    dict (``proj_out.weight`` is the decoder's embedding)."""
    enc, dec = params["encoder"], params["decoder"]
    out: State = {}
    for conv in ("conv1", "conv2"):
        out[f"model.encoder.{conv}.weight"] = _host(enc[conv]["kernel"])
        out[f"model.encoder.{conv}.bias"] = _host(enc[conv]["bias"])
    out["model.encoder.embed_positions.weight"] = _host(enc["pos"])
    for i, block in enumerate(enc["layers"]):
        _pre_ln_block(out, f"model.encoder.layers.{i}", block, k_bias=False)
    _ln(out, "model.encoder.layer_norm", enc["ln_post"])
    out["model.decoder.embed_tokens.weight"] = embed = _host(dec["embed"])
    out["model.decoder.embed_positions.weight"] = _host(dec["pos"])
    for i, block in enumerate(dec["layers"]):
        _pre_ln_block(out, f"model.decoder.layers.{i}", block, k_bias=False)
    _ln(out, "model.decoder.layer_norm", dec["ln"])
    out["proj_out.weight"] = embed
    return out


def nllb_hf_config(cfg) -> dict:
    """``config.json`` of an HF NLLB (M2M100) checkpoint of ``cfg``'s dims."""
    return {"model_type": "m2m_100", "architectures": ["M2M100ForConditionalGeneration"],
            "vocab_size": cfg.vocab_size, "d_model": cfg.d_model,
            "encoder_layers": cfg.encoder_layers, "decoder_layers": cfg.decoder_layers,
            "encoder_attention_heads": cfg.heads, "decoder_attention_heads": cfg.heads,
            "encoder_ffn_dim": cfg.ffn_dim, "decoder_ffn_dim": cfg.ffn_dim,
            "max_position_embeddings": cfg.max_positions, "pad_token_id": cfg.pad_token,
            "bos_token_id": cfg.bos_token, "eos_token_id": cfg.eos_token,
            "decoder_start_token_id": cfg.decoder_start_token, "scale_embedding": True,
            "activation_function": "relu", "torch_dtype": "float32"}


def nllb_hf_state_dict(params, cfg) -> State:
    """The port's NLLB tree → ``M2M100ForConditionalGeneration``'s state
    dict (the shared embedding under its four tied names; the sinusoidal
    positions are a buffer the checkpoint does not hold)."""
    out: State = {}
    embed = _host(params["embed"])
    for name in ("model.shared.weight", "model.encoder.embed_tokens.weight",
                 "model.decoder.embed_tokens.weight", "lm_head.weight"):
        out[name] = embed
    for side in ("encoder", "decoder"):
        for i, block in enumerate(params[side]["layers"]):
            _pre_ln_block(out, f"model.{side}.layers.{i}", block, k_bias=True)
        _ln(out, f"model.{side}.layer_norm", params[side]["ln"])
    return out


def ecapa_speechbrain_state_dict(params, cfg) -> State:
    """The port's ECAPA tree → speechbrain ``ECAPA_TDNN``'s state dict
    (``…conv.conv`` / ``…norm.norm``; each BatchNorm's
    ``num_batches_tracked`` 0)."""
    out: State = {}

    def conv(name, p):
        out[f"{name}.weight"] = _host(p["kernel"])
        out[f"{name}.bias"] = _host(p["bias"])

    def bn(name, p):
        for ours, sb in (("scale", "weight"), ("bias", "bias"), ("mean", "running_mean"),
                         ("var", "running_var")):
            out[f"{name}.{sb}"] = _host(p[ours])
        out[f"{name}.num_batches_tracked"] = torch.zeros((), dtype=torch.int64)

    def tdnn(name, p):
        conv(f"{name}.conv.conv", p["conv"])
        bn(f"{name}.norm.norm", p["bn"])

    tdnn("blocks.0", params["block0"])
    for b, block in enumerate(params["blocks"], start=1):
        tdnn(f"blocks.{b}.tdnn1", block["tdnn1"])
        for i, unit in enumerate(block["res2"]):
            tdnn(f"blocks.{b}.res2net_block.blocks.{i}", unit)
        tdnn(f"blocks.{b}.tdnn2", block["tdnn2"])
        conv(f"blocks.{b}.se_block.conv1.conv", block["se_conv1"])
        conv(f"blocks.{b}.se_block.conv2.conv", block["se_conv2"])
    tdnn("mfa", params["mfa"])
    tdnn("asp.tdnn", params["asp_tdnn"])
    conv("asp.conv.conv", params["asp_conv"])
    bn("asp_bn.norm", params["asp_bn"])
    conv("fc.conv", params["fc"])
    return out


def cosyvoice_llm_state_dict(params, cfg) -> State:
    """The port's speech-LM tree (no MTP heads) → the official ``Qwen2LM``'s
    ``llm.pt`` state dict: the HF Qwen2 backbone under ``llm.model.model.``,
    ``speech_embedding`` with the sos / task rows also in ``llm_embedding``,
    the head as ``llm_decoder``."""
    speech = _host(params["speech_embed"])
    out: State = {"llm_embedding.weight": speech[[cfg.sos_index, cfg.task_index]].contiguous(),
                  "speech_embedding.weight": speech}
    _linear(out, "llm_decoder", params["head"], bias="bias" in params["head"])
    pre = "llm.model.model"
    out[f"{pre}.embed_tokens.weight"] = _host(params["text_embed"])
    backbone = params["backbone"]
    out[f"{pre}.norm.weight"] = _host(backbone["ln_f"]["scale"])
    for i, layer in enumerate(backbone["layers"]):
        base = f"{pre}.layers.{i}"
        out[f"{base}.input_layernorm.weight"] = _host(layer["input_ln"]["scale"])
        out[f"{base}.post_attention_layernorm.weight"] = _host(layer["post_ln"]["scale"])
        for proj in ("q", "k", "v"):
            _linear(out, f"{base}.self_attn.{proj}_proj", layer[proj])
        _linear(out, f"{base}.self_attn.o_proj", layer["o"], bias=False)
        for proj in ("gate", "up", "down"):
            _linear(out, f"{base}.mlp.{proj}_proj", layer[proj], bias=False)
    return out


def _conv(out: State, name: str, p) -> None:
    out[f"{name}.weight"] = _host(p["kernel"])
    out[f"{name}.bias"] = _host(p["bias"])


def _resnet(out: State, name: str, p) -> None:
    """The inverse of ``musetalk._res_p``: a diffusers ResnetBlock2D."""
    _ln(out, f"{name}.norm1", p["norm1"])
    _conv(out, f"{name}.conv1", p["conv1"])
    _ln(out, f"{name}.norm2", p["norm2"])
    _conv(out, f"{name}.conv2", p["conv2"])
    if "temb" in p:
        _linear(out, f"{name}.time_emb_proj", p["temb"])
    if "shortcut" in p:
        _conv(out, f"{name}.conv_shortcut", p["shortcut"])


def musetalk_vae_config(cfg) -> dict:
    """``config.json`` of a diffusers AutoencoderKL of ``cfg``'s VAE dims."""
    n = len(cfg.vae_channels)
    return {"_class_name": "AutoencoderKL", "in_channels": 3, "out_channels": 3,
            "block_out_channels": list(cfg.vae_channels), "layers_per_block": cfg.vae_layers,
            "latent_channels": cfg.latent_channels, "norm_num_groups": cfg.norm_groups,
            "sample_size": cfg.image_size, "act_fn": "silu",
            "down_block_types": ["DownEncoderBlock2D"] * n,
            "up_block_types": ["UpDecoderBlock2D"] * n}


def musetalk_vae_state_dict(params, cfg) -> State:
    """The port's VAE tree → diffusers ``AutoencoderKL``'s state dict (the
    modern attention names: group_norm, to_q / to_k / to_v, to_out.0)."""
    out: State = {}

    def mid(side, p):
        _resnet(out, f"{side}.mid_block.resnets.0", p["res1"])
        _resnet(out, f"{side}.mid_block.resnets.1", p["res2"])
        a = f"{side}.mid_block.attentions.0"
        _ln(out, f"{a}.group_norm", p["attn"]["gn"])
        for ours, hf in (("q", "to_q"), ("k", "to_k"), ("v", "to_v"), ("o", "to_out.0")):
            _linear(out, f"{a}.{hf}", p["attn"][ours])

    enc, dec = params["encoder"], params["decoder"]
    _conv(out, "encoder.conv_in", enc["conv_in"])
    for i, block in enumerate(enc["down"]):
        for j, res in enumerate(block["resnets"]):
            _resnet(out, f"encoder.down_blocks.{i}.resnets.{j}", res)
        if "downsample" in block:
            _conv(out, f"encoder.down_blocks.{i}.downsamplers.0.conv", block["downsample"])
    mid("encoder", enc["mid"])
    _ln(out, "encoder.conv_norm_out", enc["norm_out"])
    _conv(out, "encoder.conv_out", enc["conv_out"])
    _conv(out, "decoder.conv_in", dec["conv_in"])
    mid("decoder", dec["mid"])
    for i, block in enumerate(dec["up"]):
        for j, res in enumerate(block["resnets"]):
            _resnet(out, f"decoder.up_blocks.{i}.resnets.{j}", res)
        if "upsample" in block:
            _conv(out, f"decoder.up_blocks.{i}.upsamplers.0.conv", block["upsample"])
    _ln(out, "decoder.conv_norm_out", dec["norm_out"])
    _conv(out, "decoder.conv_out", dec["conv_out"])
    _conv(out, "quant_conv", params["quant_conv"])
    _conv(out, "post_quant_conv", params["post_quant_conv"])
    return out


def musetalk_unet_config(cfg) -> dict:
    """``musetalk.json``: the UNet2DConditionModel's dims."""
    n = len(cfg.unet_channels)
    return {"_class_name": "UNet2DConditionModel", "in_channels": 2 * cfg.latent_channels,
            "out_channels": cfg.latent_channels, "sample_size": cfg.image_size // 8,
            "block_out_channels": list(cfg.unet_channels), "layers_per_block": cfg.unet_layers,
            "cross_attention_dim": cfg.audio_dim, "attention_head_dim": cfg.heads,
            "norm_num_groups": cfg.norm_groups, "flip_sin_to_cos": True, "freq_shift": 0,
            "down_block_types": ["CrossAttnDownBlock2D"] * (n - 1) + ["DownBlock2D"],
            "up_block_types": ["UpBlock2D"] + ["CrossAttnUpBlock2D"] * (n - 1)}


def musetalk_unet_state_dict(params, cfg) -> State:
    """The port's UNet tree → diffusers ``UNet2DConditionModel``'s state
    dict."""
    out: State = {}

    def transformer(name, p):
        _ln(out, f"{name}.norm", p["gn"])
        _conv(out, f"{name}.proj_in", p["proj_in"])
        _conv(out, f"{name}.proj_out", p["proj_out"])
        tb = f"{name}.transformer_blocks.0"
        for k in ("norm1", "norm2", "norm3"):
            _ln(out, f"{tb}.{k}", p[k])
        for attn in ("attn1", "attn2"):
            for ours, hf in (("q", "to_q"), ("k", "to_k"), ("v", "to_v")):
                _linear(out, f"{tb}.{attn}.{hf}", p[attn][ours], bias=False)
            _linear(out, f"{tb}.{attn}.to_out.0", p[attn]["o"])
        _linear(out, f"{tb}.ff.net.0.proj", p["ff_proj"])
        _linear(out, f"{tb}.ff.net.2", p["ff_out"])

    _conv(out, "conv_in", params["conv_in"])
    _linear(out, "time_embedding.linear_1", params["time_mlp"]["lin1"])
    _linear(out, "time_embedding.linear_2", params["time_mlp"]["lin2"])
    for side, sampler in (("down", "downsample"), ("up", "upsample")):
        for i, block in enumerate(params[side]):
            for j, res in enumerate(block["resnets"]):
                _resnet(out, f"{side}_blocks.{i}.resnets.{j}", res)
            for j, attn in enumerate(block.get("attns", [])):
                transformer(f"{side}_blocks.{i}.attentions.{j}", attn)
            if sampler in block:
                _conv(out, f"{side}_blocks.{i}.{sampler}rs.0.conv", block[sampler])
    _resnet(out, "mid_block.resnets.0", params["mid"]["res1"])
    transformer("mid_block.attentions.0", params["mid"]["attn"])
    _resnet(out, "mid_block.resnets.1", params["mid"]["res2"])
    _ln(out, "conv_norm_out", params["norm_out"])
    _conv(out, "conv_out", params["conv_out"])
    return out


def write_musetalk(root, params, cfg) -> Path:
    """Write a MuseTalk tree in the release layout under ``root``:
    ``sd-vae-ft-mse/`` (``config.json`` and
    ``diffusion_pytorch_model.safetensors``) and ``musetalk/``
    (``musetalk.json`` and ``pytorch_model.bin``). → ``root``."""
    from ..models.safetensors_io import write_safetensors

    root = Path(root)
    vae, unet = root / "sd-vae-ft-mse", root / "musetalk"
    vae.mkdir(parents=True, exist_ok=True)
    unet.mkdir(parents=True, exist_ok=True)
    (vae / "config.json").write_text(json.dumps(musetalk_vae_config(cfg), indent=2))
    write_safetensors(musetalk_vae_state_dict(params["vae"], cfg),
                      vae / "diffusion_pytorch_model.safetensors", metadata={"format": "pt"})
    (unet / "musetalk.json").write_text(json.dumps(musetalk_unet_config(cfg), indent=2))
    torch.save(musetalk_unet_state_dict(params["unet"], cfg), unet / "pytorch_model.bin")
    return root


def _tfg_res(out: State, name: str, p) -> None:
    """The inverse of ``gd_unet._res_p``: a guided-diffusion ResBlock."""
    _ln(out, f"{name}.in_layers.0", p["in_norm"])
    _conv(out, f"{name}.in_layers.2", p["in_conv"])
    _linear(out, f"{name}.emb_layers.1", p["emb"])
    _ln(out, f"{name}.out_layers.0", p["out_norm"])
    _conv(out, f"{name}.out_layers.3", p["out_conv"])
    if "skip" in p:
        _conv(out, f"{name}.skip_connection", p["skip"])


def _tfg_attn(out: State, name: str, p, heads: int) -> None:
    """The inverse of ``gd_unet._attn_p``: per-head q / k / v back into one
    qkv 1×1 conv [3C, C, 1] ordered head-major [h0: q|k|v, h1: q|k|v, …]."""
    c = p["q"]["kernel"].shape[0]
    w = torch.stack([p[n]["kernel"].T.reshape(heads, c // heads, c) for n in "qkv"], dim=1)
    b = torch.stack([p[n]["bias"].reshape(heads, c // heads) for n in "qkv"], dim=1)
    _ln(out, f"{name}.norm", p["norm"])
    out[f"{name}.qkv.weight"] = _host(w.reshape(3 * c, c, 1))
    out[f"{name}.qkv.bias"] = _host(b.reshape(3 * c))
    out[f"{name}.proj_out.weight"] = _host(p["o"]["kernel"].T[:, :, None])
    out[f"{name}.proj_out.bias"] = _host(p["o"]["bias"])


def diff2lip_tfg_state_dict(params, cfg) -> State:
    """The port's TFG tree (``models/gd_unet.py``) and its ``GDUNetConfig``
    → diff2lip's TFGModel state dict, the inverse of
    ``gd_unet.from_tfg_state_dict`` (a tree without ``audio`` gives no
    audio encoder)."""
    from ..models.gd_unet import _audio_plan, _plan

    out: State = {}

    def block(prefix, desc, p):
        if desc["kind"] == "conv":
            _conv(out, f"{prefix}.0", p["conv"])
        elif desc["kind"] == "down":
            _conv(out, f"{prefix}.0.op", p["down"])
        else:
            _tfg_res(out, f"{prefix}.0", p["res"])
            j = 1
            if "attn" in p:
                _tfg_attn(out, f"{prefix}.{j}", p["attn"], cfg.num_heads)
                j += 1
            if "up" in p:
                _conv(out, f"{prefix}.{j}.conv", p["up"])

    inputs, _, outputs = _plan(cfg)
    _linear(out, "time_embed.0", params["time_embed"]["lin1"])
    _linear(out, "time_embed.2", params["time_embed"]["lin2"])
    for i, (desc, p) in enumerate(zip(inputs, params["input"])):
        block(f"input_blocks.{i}", desc, p)
    _tfg_res(out, "middle_block.0", params["middle"]["res1"])
    _tfg_attn(out, "middle_block.1", params["middle"]["attn"], cfg.num_heads)
    _tfg_res(out, "middle_block.2", params["middle"]["res2"])
    for i, (desc, p) in enumerate(zip(outputs, params["output"])):
        block(f"output_blocks.{i}", desc, p)
    _ln(out, "out.0", params["out"]["norm"])
    _conv(out, "out.2", params["out"]["conv"])
    if "audio" in params:
        a = params["audio"]
        _linear(out, "audio_encoder.time_embed.0", a["time_embed"]["lin1"])
        _linear(out, "audio_encoder.time_embed.2", a["time_embed"]["lin2"])
        _conv(out, "audio_encoder.input_block.0", a["in_conv"])
        _ln(out, "audio_encoder.input_block.1", a["in_norm"])
        for i, (desc, p) in enumerate(zip(_audio_plan(cfg)[0], a["blocks"])):
            block(f"audio_encoder.encoder_blocks.{i}", desc, p)
        _tfg_res(out, "audio_encoder.middle_block.0", a["mid_res"])
        _ln(out, "audio_encoder_to_style.0", a["style_norm"])
        _conv(out, "audio_encoder_to_style.3", a["style_conv"])
    return out


def write_diff2lip(path, params, cfg) -> Path:
    """diff2lip's pickled checkpoint of a TFG tree at ``path`` (``e2e.pt``),
    its keys ``module.``-prefixed as the published e2e checkpoint's
    DDP-wrapped model saved them. → ``path``."""
    path = Path(path)
    path.parent.mkdir(parents=True, exist_ok=True)
    torch.save({"module." + k: v for k, v in diff2lip_tfg_state_dict(params, cfg).items()}, path)
    return path
