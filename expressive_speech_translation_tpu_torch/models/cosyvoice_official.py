"""The official CosyVoice2 TTS chain: speech LM → matcha flow → HiFT.

The port of the JAX package's ``models/cosyvoice_official.py``, the path
that serves the pretrained CosyVoice2-0.5B triple (``llm.pt`` /
``flow.pt`` / ``hift.pt``; converters: ``cosyvoice.
from_cosyvoice_llm_state_dict``, ``flow_matcha.from_flow_state_dict``,
``hift.from_hift_state_dict``; loaders in ``models/loaders.py``).
:func:`synthesize_official` is the official inference chain: speech tokens
from the generator ``cosyvoice.select_generator`` picks (single-token RAS,
MTP or speculative) → the prompt-conditioned conformer/CFM mel → the NSF
iSTFT waveform. :func:`synthesize_streaming_official` streams it chunk by
chunk. The native DiT-flow / HiFi-GAN chain of ``models/cosyvoice.py``
stays the path that runs without weights.

Randomness comes from a ``cosyvoice.NoiseSource``: the LM's Gumbel draws,
the flow's x_0 (``flow_x0``; a stream's ``flow_x0_prefix`` by prefix
bucket) and the HiFT source (``hift_source``).
"""

from __future__ import annotations

import dataclasses
import functools
from typing import Dict, Optional

import numpy as np
import torch

from ..core.device import resolve_device
from ..obs import spans
from . import cosyvoice as cv
from . import flow_matcha as fm
from . import hift as hm
from . import qwen2 as q2
from .common import Init, Params, tree_from_numpy


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


def from_jax_params(tree, device, dtype=torch.float32) -> Params:
    """The JAX package's official tree → the port's: the LM as it is, the
    flow's and the HiFT's conv kernels into torch's layouts."""
    return {"lm": tree_from_numpy(tree["lm"], device, dtype),
            "flow": fm.from_jax_params(tree["flow"], device, dtype),
            "hift": hm.from_jax_params(tree["hift"], device, dtype)}


def synthesize_official(params: Params, cfg: OfficialTtsConfig, noise: cv.NoiseSource,
                        text_tokens: torch.Tensor, text_mask: torch.Tensor,
                        prompt_speech_tokens: torch.Tensor, prompt_speech_mask: torch.Tensor,
                        spk_embedding: torch.Tensor, prompt_mel: torch.Tensor, *,
                        max_new_tokens: int = 512, min_new_tokens: int = 2,
                        deterministic_source: bool = False) -> Dict[str, torch.Tensor]:
    """Zero-shot TTS through the official chain: speech tokens → the flow
    (prompt tokens and prompt mel [B, ratio·T_ptok, n_mels] as the
    continuation's context, CFG Euler) → HiFT over the flow's frame mask.
    → {"audio" [B, ratio·T_tok·hop] at 24 kHz of the new speech only,
    "mel", "speech_tokens", "token_lengths", "frame_mask"}."""
    gen = cv.select_generator(cfg.lm, text_tokens.shape[0])
    tokens, lengths = gen(params["lm"], cfg.lm, noise, text_tokens, text_mask,
                          prompt_speech_tokens, prompt_speech_mask,
                          max_new_tokens=max_new_tokens, min_new_tokens=min_new_tokens)
    token_mask = torch.arange(tokens.shape[1], device=tokens.device)[None, :] < lengths[:, None]
    rows = tokens.shape[0]
    with spans.span("tts.flow", rows=rows):
        mel, frame_mask = fm.flow_inference(
            params["flow"], cfg.flow, noise.flow_x0, torch.where(token_mask, tokens, 0),
            token_mask, torch.where(prompt_speech_mask, prompt_speech_tokens, 0),
            prompt_speech_mask, prompt_mel, spk_embedding)
    with spans.span("tts.vocoder", rows=rows):
        audio = hm.hift_inference(params["hift"], cfg.hift, noise, mel,
                                  deterministic=deterministic_source, frame_mask=frame_mask)
    return {"audio": audio, "mel": mel, "speech_tokens": tokens, "token_lengths": lengths,
            "frame_mask": frame_mask}


# ================================================================ streaming


def _hift_chunk(hift_params: Params, cfg: hm.HiFTConfig, noise: cv.NoiseSource,
                cache_mel: torch.Tensor, cache_source: torch.Tensor, use_cache: bool,
                new_mel: torch.Tensor, *, deterministic: bool):
    """One streamed HiFT pass, the official ``hift_cache`` recipe: the cached
    mel tail [1, Cm, n_mels] is re-vocoded ahead of the new frames
    [1, F, n_mels], and once a cache exists the previous pass's source
    [1, Cm·hop, 1] is spliced over the cached span so the sine source does
    not restart its phase at the join. → (the waveform [1, (Cm + F)·hop],
    the mel cache, the source cache)."""
    mel_in = torch.cat([cache_mel, new_mel], dim=1)
    f0 = hm.f0_predict(hift_params, cfg, mel_in)
    src = hm.harmonic_source(hift_params, cfg, noise, f0, deterministic=deterministic)
    src = src.to(torch.promote_types(src.dtype, cache_source.dtype))
    n_cache = cache_mel.shape[1] * cfg.hop
    if use_cache:
        src = torch.cat([cache_source.to(src.dtype), src[:, n_cache:]], dim=1)
    wave = hm.hift_decode(hift_params, cfg, mel_in, src)
    return wave, mel_in[:, -cache_mel.shape[1]:], src[:, -n_cache:]


def synthesize_streaming_official(params: Params, cfg: OfficialTtsConfig,
                                  noise: cv.NoiseSource, text_tokens: torch.Tensor,
                                  text_mask: torch.Tensor, prompt_speech_tokens: torch.Tensor,
                                  prompt_speech_mask: torch.Tensor, spk_embedding: torch.Tensor,
                                  prompt_mel: torch.Tensor, *, chunk_tokens: int = 25,
                                  mel_cache_frames: int = 20, fade_samples: int = 1024,
                                  max_new_tokens: int = 512, min_new_tokens: int = 2,
                                  deterministic_source: bool = False):
    """Incremental zero-shot TTS through the official chain (B == 1): yields
    24 kHz np.float32 chunks.

    A chunk: the LM emits ``chunk_tokens`` tokens from its resumable state
    (``noise.chunk(ci, n_chunks)`` its source); the flow re-runs on the token
    prefix padded to a bucket (``chunk_tokens`` doubled until it covers the
    budget; its attention is global, so the prefix is recomputed, and the
    prefix's x_0 is ``noise.flow_x0_prefix(bucket)``) and the new frames are
    sliced out; HiFT re-vocodes ``mel_cache_frames`` of cached mel ahead of
    them (:func:`_hift_chunk`), and consecutive emissions crossfade over
    ``fade_samples`` (the tail is held back and yielded last). The LM runs
    whole chunks, so the stream may emit up to a chunk more tokens than
    ``max_new_tokens``, as the JAX package's does."""
    if text_tokens.shape[0] != 1:
        raise ValueError("streaming synthesis is single-stream (batch == 1); "
                         "use synthesize_official for batched offline TTS")
    r, hop, n_mels = cfg.flow.token_mel_ratio, cfg.hift.hop, cfg.flow.output_size
    c, cm = chunk_tokens, mel_cache_frames
    dev = text_tokens.device
    n_chunks = -(-max_new_tokens // c)
    total_tok = n_chunks * c
    buckets = [c]
    while buckets[-1] < total_tok:
        buckets.append(min(buckets[-1] * 2, total_tok))

    lm_state = cv.lm_stream_start(params["lm"], cfg.lm, text_tokens, text_mask,
                                  prompt_speech_tokens, prompt_speech_mask,
                                  max_new_tokens=total_tok)
    p_len = 2 + text_tokens.shape[1] + prompt_speech_tokens.shape[1]
    safe_prompt = torch.where(prompt_speech_mask, prompt_speech_tokens, 0)

    prefix = np.zeros((1, total_tok), np.int32)
    count = 0
    cache_mel = torch.zeros((1, cm, n_mels), device=dev)
    cache_src = torch.zeros((1, cm * hop, 1), device=dev)
    use_cache = False
    held: Optional[np.ndarray] = None
    for ci in range(n_chunks):
        chunk_noise = noise.chunk(ci, n_chunks)
        tokens, lm_state = cv.lm_stream_chunk(params["lm"], cfg.lm, chunk_noise, lm_state,
                                              chunk_tokens=c, min_new_tokens=min_new_tokens,
                                              p_len=p_len)
        tok_np = tokens[0].cpu().numpy()
        eos_hits = tok_np == cfg.lm.eos_speech
        n_valid = int(np.argmax(eos_hits)) if eos_hits.any() else c
        if n_valid == 0:
            break
        prev, count = count, count + n_valid
        prefix[0, prev:count] = tok_np[:n_valid]

        p_b = next(b for b in buckets if count <= b)
        mel, _ = fm.flow_inference(
            params["flow"], cfg.flow, functools.partial(noise.flow_x0_prefix, p_b),
            torch.from_numpy(prefix[:, :p_b]).to(dev),
            torch.from_numpy((np.arange(p_b) < count)[None, :]).to(dev),
            safe_prompt, prompt_speech_mask, prompt_mel, spk_embedding)
        new_mel = mel[0, r * prev: r * count].float().cpu().numpy()
        nm = np.zeros((1, r * c, n_mels), np.float32)
        nm[0, : len(new_mel)] = new_mel

        wave, cache_mel, cache_src = _hift_chunk(
            params["hift"], cfg.hift, chunk_noise, cache_mel, cache_src, use_cache,
            torch.from_numpy(nm).to(dev), deterministic=deterministic_source)
        use_cache = True
        wav = wave[0].float().cpu().numpy()
        start, end = cm * hop, (cm + len(new_mel)) * hop
        fade = min(fade_samples, cm * hop, end - start)
        out = wav[start:end]
        if held is not None and fade > 0:
            ramp = np.linspace(0.0, 1.0, len(held), dtype=np.float32)
            out = np.concatenate([held * (1 - ramp) + wav[start - len(held):start] * ramp, out])
        if fade > 0:
            held = out[len(out) - fade:]
            out = out[: len(out) - fade]
        if len(out):
            yield out
        if n_valid < c:
            break
    if held is not None and len(held):
        yield held
