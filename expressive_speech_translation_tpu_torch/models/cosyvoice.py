"""CosyVoice2-style TTS: speech-token LM → flow matching → HiFi-GAN vocoder.

The port of the JAX package's ``models/cosyvoice.py`` native chain:
``build_prompt_embeddings``, RAS sampling and the three speech-token
generators over the Qwen2 backbone (single-token
``generate_speech_tokens``; multi-token prediction, accept-all
``generate_speech_tokens_mtp`` and lossless speculative
``generate_speech_tokens_spec``; ``select_generator`` picks one); the DiT
``flow_estimator`` and ``tokens_to_mel`` (Euler steps, batched CFG); the
HiFi-GAN ``vocode`` whose narrow stages run the fused resblock kernel
(``ops/cuda_vocoder.py``); the flow's training objective
``flow_matching_loss``; ``synthesize``; the chunked
``synthesize_streaming`` (resumable LM ``lm_stream_start`` /
``lm_stream_chunk``, then ``flow_vocode_chunk`` a chunk; single-token, as
in the JAX package); and ``quantize_speech_lm`` (int8 weights).

Randomness enters through a :class:`NoiseSource`: Gumbel noise for the two
categorical draws of each RAS step (``categorical(logits) ==
argmax(logits + gumbel)``) and each MTP (pass, head), the flow's x_0, and
the official chain's HiFT source and prefix-bucket flow x_0
(``models/cosyvoice_official.py``); a stream takes one source a chunk
(``NoiseSource.chunk``).
:class:`GeneratorNoise` makes each draw a function of its index; tests
inject the JAX key schedule's noise.

Layouts: dense kernels [in, out]; vocoder conv kernels torch's
[out, in, width] and conv-transpose kernels [in, out, width]
(:func:`from_jax_params` converts from the JAX package's [width, in, out]).
"""

from __future__ import annotations

import dataclasses
from typing import Dict, NamedTuple, Optional, Protocol, Tuple

import numpy as np
import torch
import torch.nn.functional as F

from ..core.device import resolve_device
from ..ops import cuda_vocoder
from . import qwen2 as q2
from ..parallel.partition import PartitionRules
from .common import (AttnConfig, Init, Params, dense, embed_rows, layer_norm, linear_from_state,
                     merge_heads, mlp, quantize_dense, split_heads, state_tensor, tree_from_numpy,
                     tree_to)


# ===================================================================== noise


class NoiseSource(Protocol):
    def ras_gumbel(self, step: int, shape: Tuple[int, ...]) -> Tuple[torch.Tensor, torch.Tensor]:
        """Gumbel noise for RAS step ``step``: (nucleus draw, resample draw).
        Equal steps must give equal noise: the speculative decoder draws each
        position twice, for its draft and for its verifier."""

    def mtp_gumbel(self, pass_index: int, head: int,
                   shape: Tuple[int, ...]) -> Tuple[torch.Tensor, torch.Tensor]:
        """Gumbel noise of head ``head`` (0 the main head, j the j-th MTP head)
        in multi-token pass ``pass_index``: (nucleus draw, resample draw)."""

    def flow_x0(self, shape: Tuple[int, ...]) -> torch.Tensor:
        """The flow's starting point x_0 ~ N(0, I)."""

    def chunk(self, index: int, count: int) -> "NoiseSource":
        """The source of chunk ``index`` of a stream of ``count`` chunks: its
        ``ras_gumbel`` takes the step's index inside the chunk, its
        ``flow_x0`` gives that chunk's flow noise."""

    def hift_source(self, phase_shape: Tuple[int, ...],
                    noise_shape: Tuple[int, ...]) -> Tuple[torch.Tensor, torch.Tensor]:
        """The HiFT source's draws (``hift.harmonic_source``): harmonic phases
        uniform in [−π, π) and the additive noise ~ N(0, 1)."""

    def flow_x0_prefix(self, bucket: int, shape: Tuple[int, ...]) -> torch.Tensor:
        """The official stream's flow x_0 for a token prefix padded to
        ``bucket``: chunks whose prefixes share a bucket share it."""


# the kinds of draw, mixed into each draw's seed
_RAS, _MTP, _FLOW, _CHUNK, _HIFT, _FLOW_PREFIX = range(6)


def _mix(*index: int) -> int:
    """One 64-bit seed from a tuple of non-negative integers."""
    return int(np.random.SeedSequence(list(index)).generate_state(1, np.uint64)[0])


class GeneratorNoise:
    """Every draw a function of its index: the draw of a RAS step, of an MTP
    (pass, head) or of the flow's x_0 comes from a ``torch.Generator`` on
    ``device`` seeded with the source's seed mixed with that index. Asking
    twice for a step gives the same noise, and the order of the asks changes
    nothing, so the speculative decoder's drafts and verifier take the draws
    the single-token loop takes. A stream's chunk is a source of its own,
    its seed mixed from the chunk's index (its steps count from 0 again)."""

    def __init__(self, seed: int, device):
        self.seed = int(seed)
        self.device = torch.device(device)

    def _generator(self, *index: int) -> torch.Generator:
        return torch.Generator(device=self.device).manual_seed(_mix(self.seed, *index))

    def _gumbel_pair(self, gen: torch.Generator, shape) -> Tuple[torch.Tensor, torch.Tensor]:
        tiny = torch.finfo(torch.float32).tiny

        def gumbel():
            u = torch.rand(shape, generator=gen, device=self.device)
            return -torch.log(-torch.log(u * (1.0 - tiny) + tiny))

        return gumbel(), gumbel()

    def ras_gumbel(self, step, shape):
        return self._gumbel_pair(self._generator(_RAS, step), shape)

    def mtp_gumbel(self, pass_index, head, shape):
        return self._gumbel_pair(self._generator(_MTP, pass_index, head), shape)

    def flow_x0(self, shape):
        return torch.randn(shape, generator=self._generator(_FLOW), device=self.device)

    def chunk(self, index, count):
        return GeneratorNoise(_mix(self.seed, _CHUNK, index, count), self.device)

    def hift_source(self, phase_shape, noise_shape):
        gen = self._generator(_HIFT)
        phase = torch.rand(phase_shape, generator=gen, device=self.device) * (2 * np.pi) - np.pi
        return phase, torch.randn(noise_shape, generator=gen, device=self.device)

    def flow_x0_prefix(self, bucket, shape):
        return torch.randn(shape, generator=self._generator(_FLOW_PREFIX, bucket),
                           device=self.device)


# ======================================================================== LM


@dataclasses.dataclass(frozen=True)
class SpeechLMConfig:
    backbone: q2.Qwen2Config = dataclasses.field(default_factory=q2.Qwen2Config.qwen2_05b)
    text_vocab: int = 151_936
    speech_token_size: int = 6561
    top_p: float = 0.8
    top_k: int = 25
    win_size: int = 10
    tau_r: float = 0.1
    max_tokens: int = 2048
    # multi-token prediction: K tokens a backbone pass, the main head and
    # K - 1 extra heads read off the newest hidden state (1 = single-token)
    mtp: int = 1
    # lossless speculative decoding over the MTP heads (B = 1): the drafts are
    # verified by the single-token sampler, whose stream comes out unchanged
    spec_decode: bool = False

    @property
    def eos_speech(self) -> int:
        return self.speech_token_size

    @property
    def sos_index(self) -> int:
        return self.speech_token_size + 1

    @property
    def task_index(self) -> int:
        return self.speech_token_size + 2


def build_prompt_embeddings(params: Params, cfg: SpeechLMConfig, text_tokens: torch.Tensor,
                            text_mask: torch.Tensor, prompt_speech: torch.Tensor,
                            prompt_speech_mask: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """``[sos] text [task] prompt_speech`` embeddings, right-padded: valid
    entries are compacted to a contiguous prefix per row by a stable sort on
    the mask, so a text shorter than its bucket leaves no hole."""
    b = text_tokens.shape[0]
    emb_table = params["speech_embed"]
    sos = embed_rows(emb_table, cfg.sos_index)[None, None, :].expand(b, 1, -1)
    task = embed_rows(emb_table, cfg.task_index)[None, None, :].expand(b, 1, -1)
    text_e = embed_rows(params["text_embed"], text_tokens) * text_mask[..., None]
    sp_e = embed_rows(emb_table, prompt_speech) * prompt_speech_mask[..., None]
    emb = torch.cat([sos, text_e, task, sp_e], dim=1)
    ones = torch.ones((b, 1), dtype=torch.bool, device=emb.device)
    mask = torch.cat([ones, text_mask, ones, prompt_speech_mask], dim=1)
    order = torch.argsort((~mask).to(torch.int32), dim=1, stable=True)
    emb = torch.take_along_dim(emb, order[..., None], dim=1)
    mask = torch.take_along_dim(mask, order, dim=1)
    return emb, mask


def _ras_sample(logits: torch.Tensor, recent: torch.Tensor, cfg: SpeechLMConfig,
                g1: torch.Tensor, g2: torch.Tensor) -> torch.Tensor:
    """Repetition-aware sampling: a nucleus (top-k ∩ top-p) draw; when the
    candidate's share of the trailing window is ≥ τ_r, a plain top-k draw
    instead. logits [B, V]; recent [B, win]; g1/g2 Gumbel noise [B, k]."""
    k_eff = min(cfg.top_k, logits.shape[-1])
    topv, topi = torch.topk(logits, k_eff, dim=-1)
    logp = torch.log_softmax(topv, dim=-1)
    probs = torch.exp(logp)
    csum = torch.cumsum(probs, dim=-1)
    keep = (csum - probs) < cfg.top_p
    nucleus = torch.where(keep, topv, -torch.inf)
    cand_in_k = torch.argmax(g1.to(logits.dtype) + nucleus, dim=-1)
    cand = topi.gather(1, cand_in_k[:, None])[:, 0]
    rep = (recent == cand[:, None]).float().mean(dim=-1)
    res_in_k = torch.argmax(g2.to(logits.dtype) + topv, dim=-1)
    resampled = topi.gather(1, res_in_k[:, None])[:, 0]
    return torch.where(rep >= cfg.tau_r, resampled, cand).to(torch.int32)


def _mask_control_logits(logits: torch.Tensor, cfg: SpeechLMConfig, step: int,
                         min_new_tokens: int) -> torch.Tensor:
    """Forbid the sos/task control tokens always and EOS before
    ``min_new_tokens``."""
    neg = torch.finfo(logits.dtype).min
    logits = logits.clone()
    logits[:, cfg.sos_index] = neg
    logits[:, cfg.task_index] = neg
    if step < min_new_tokens:
        logits[:, cfg.eos_speech] = neg
    return logits


def _sample_from_logits(cfg: SpeechLMConfig, noise: NoiseSource, logits: torch.Tensor,
                        recent: torch.Tensor, done: torch.Tensor, step: int,
                        min_new_tokens: int, draw: Optional[int] = None):
    """The single-token sample from head logits [B, V]: control masking, the
    EOS gate, RAS with the noise of ``draw`` (default ``step``), EOS held for
    finished rows, the window rolled → (nxt [B], recent, done). ``step``
    counts generated tokens. Split from :func:`_sample_next` so the
    speculative verifier can run one head product over its K positions."""
    logits = _mask_control_logits(logits, cfg, step, min_new_tokens)
    k_eff = min(cfg.top_k, logits.shape[-1])
    g1, g2 = noise.ras_gumbel(step if draw is None else draw, (logits.shape[0], k_eff))
    nxt = _ras_sample(logits, recent, cfg, g1, g2)
    nxt = torch.where(done, cfg.eos_speech, nxt)
    recent = torch.cat([recent[:, 1:], nxt[:, None]], dim=1)
    return nxt, recent, done | (nxt == cfg.eos_speech)


def _sample_next(params: Params, cfg: SpeechLMConfig, noise: NoiseSource, h: torch.Tensor,
                 recent: torch.Tensor, done: torch.Tensor, step: int, min_new_tokens: int,
                 draw: Optional[int] = None):
    """One single-token decode sample, shared by the batch and streaming
    loops. h [B, 1, H] → (nxt [B], recent, done)."""
    return _sample_from_logits(cfg, noise, dense(params["head"], h[:, 0, :]), recent, done,
                               step, min_new_tokens, draw)


def _prefill_prompt(params: Params, cfg: SpeechLMConfig, text_tokens, text_mask, prompt_speech,
                    prompt_speech_mask, generated: int):
    """The prompt through the backbone into a cache with room for
    ``generated`` more slots → (cache, p_len, last_idx [B], the hidden state
    at each row's last valid prompt position [B, 1, H])."""
    emb, mask = build_prompt_embeddings(params, cfg, text_tokens, text_mask,
                                        prompt_speech, prompt_speech_mask)
    b, p_len, _ = emb.shape
    cache = q2.init_kv_cache(cfg.backbone, b, p_len + generated, emb.dtype, emb.device)
    hidden = q2.prefill(params["backbone"], cfg.backbone, emb, cache, length_mask=mask)
    last_idx = mask.to(torch.int64).sum(dim=1) - 1
    return cache, p_len, last_idx, torch.take_along_dim(hidden, last_idx[:, None, None], dim=1)


def generate_speech_tokens(params: Params, cfg: SpeechLMConfig, noise: NoiseSource,
                           text_tokens: torch.Tensor, text_mask: torch.Tensor,
                           prompt_speech: torch.Tensor, prompt_speech_mask: torch.Tensor, *,
                           max_new_tokens: int = 512, min_new_tokens: int = 2):
    """Autoregressive speech tokens with RAS sampling → (tokens
    [B, max_new_tokens] int32 padded with EOS, lengths [B])."""
    cache, p_len, last_idx, h = _prefill_prompt(params, cfg, text_tokens, text_mask,
                                                prompt_speech, prompt_speech_mask, max_new_tokens)
    b, dev = h.shape[0], h.device
    tokens = torch.full((b, max_new_tokens), cfg.eos_speech, dtype=torch.int32, device=dev)
    recent = torch.full((b, cfg.win_size), -1, dtype=torch.int32, device=dev)
    done = torch.zeros((b,), dtype=torch.bool, device=dev)
    for i in range(max_new_tokens):
        nxt, recent, done = _sample_next(params, cfg, noise, h, recent, done, i, min_new_tokens)
        tokens[:, i] = nxt
        if i == max_new_tokens - 1 or bool(done.all()):
            break
        # the cache slot is the shared p_len + i; each row attends to its
        # valid prompt K/V only and rotates at its true continuation position
        h = q2.decode_step(params["backbone"], cfg.backbone,
                           embed_rows(params["speech_embed"], nxt)[:, None, :], p_len + i, cache,
                           rope_pos=last_idx + 1 + i, prompt_len=last_idx + 1,
                           prompt_capacity=p_len)
    lengths = (tokens != cfg.eos_speech).to(torch.int32).sum(dim=1)
    return tokens, lengths


def generate_speech_tokens_mtp(params: Params, cfg: SpeechLMConfig, noise: NoiseSource,
                               text_tokens: torch.Tensor, text_mask: torch.Tensor,
                               prompt_speech: torch.Tensor, prompt_speech_mask: torch.Tensor, *,
                               max_new_tokens: int = 512, min_new_tokens: int = 2):
    """Multi-token prediction, accept-all: each backbone pass emits K =
    ``cfg.mtp`` tokens from the newest hidden state (the main head, then the
    K − 1 MTP heads, each a RAS draw against a window rolled locally over
    the draws before it), puts everything after a block's first EOS to EOS,
    and ingests the K tokens in one :func:`qwen2.decode_span`. The noise of
    head j in pass i is ``noise.mtp_gumbel(i, j, ...)``. → (tokens
    [B, max_new_tokens] int32 padded with EOS, lengths [B])."""
    k_mtp = cfg.mtp
    if k_mtp <= 1:
        raise ValueError("generate_speech_tokens_mtp needs cfg.mtp > 1; "
                         "use generate_speech_tokens")
    n_iters = -(-max_new_tokens // k_mtp)
    cache, p_len, last_idx, h = _prefill_prompt(params, cfg, text_tokens, text_mask,
                                                prompt_speech, prompt_speech_mask,
                                                n_iters * k_mtp)
    h = h[:, 0, :]
    b, dev = h.shape[0], h.device
    heads = [params["head"]] + list(params["mtp_heads"][: k_mtp - 1])
    tokens = torch.full((b, n_iters * k_mtp), cfg.eos_speech, dtype=torch.int32, device=dev)
    recent = torch.full((b, cfg.win_size), -1, dtype=torch.int32, device=dev)
    done = torch.zeros((b,), dtype=torch.bool, device=dev)
    for i in range(n_iters):
        local, drawn = recent, []
        for j, head in enumerate(heads):
            # the heads' logits in f32, as the JAX package casts them
            logits = _mask_control_logits(dense(head, h).float(), cfg, i * k_mtp + j,
                                          min_new_tokens)
            g1, g2 = noise.mtp_gumbel(i, j, (b, min(cfg.top_k, logits.shape[-1])))
            nxt = _ras_sample(logits, local, cfg, g1, g2)
            local = torch.cat([local[:, 1:], nxt[:, None]], dim=1)
            drawn.append(nxt)
        new = torch.stack(drawn, dim=1)                                    # [B, K]
        is_eos = (new == cfg.eos_speech).to(torch.int32)
        after_eos = (torch.cumsum(is_eos, dim=1) - is_eos) > 0
        new = torch.where(after_eos | done[:, None], cfg.eos_speech, new)
        tokens[:, i * k_mtp:(i + 1) * k_mtp] = new
        done = done | (new == cfg.eos_speech).any(dim=1)
        # the persistent window holds the tokens emitted, not the local draws
        recent = torch.cat([recent, new], dim=1)[:, -cfg.win_size:]
        if i == n_iters - 1 or bool(done.all()):
            break
        h = q2.decode_span(params["backbone"], cfg.backbone,
                           embed_rows(params["speech_embed"], new),
                           p_len + i * k_mtp, cache, rope_pos=last_idx + 1 + i * k_mtp,
                           prompt_len=last_idx + 1, prompt_capacity=p_len)[:, -1, :]
    tokens = tokens[:, :max_new_tokens]
    lengths = (tokens != cfg.eos_speech).to(torch.int32).sum(dim=1)
    return tokens, lengths


def generate_speech_tokens_spec(params: Params, cfg: SpeechLMConfig, noise: NoiseSource,
                                text_tokens: torch.Tensor, text_mask: torch.Tensor,
                                prompt_speech: torch.Tensor, prompt_speech_mask: torch.Tensor, *,
                                max_new_tokens: int = 512, min_new_tokens: int = 2,
                                with_stats: bool = False):
    """Lossless speculative decoding over the MTP heads (B = 1): the stream
    of :func:`generate_speech_tokens` on the same noise, in fewer backbone
    passes.

    x_0 is the single-token loop's step 0. A pass drafts positions
    n .. n + K − 2 with ``mtp_heads[j − 1]`` on the last accepted hidden
    state, each through the same sampler and the same noise
    (``noise.ras_gumbel(position)``) as the single-token loop; one
    :func:`qwen2.decode_span` ingests [pending, drafts] at cache slot
    p_len + n − 1; one head product over its K hidden states gives the
    verifier's logits, and the verifier samples each position as the
    single-token loop would on the true prefix. The pass emits up to the
    first draft the verifier disagrees with (that position gets the
    verifier's token), or all K when every draft matched. Accepted tokens
    fill consecutive slots, so the next pass overwrites exactly the slots of
    rejected drafts. → (tokens [1, max_new_tokens], lengths [1]), and with
    ``with_stats`` {"backbone_passes", "emitted"}."""
    k_mtp = cfg.mtp
    if k_mtp <= 1:
        raise ValueError("speculative decoding needs MTP heads (cfg.mtp > 1)")
    if text_tokens.shape[0] != 1:
        raise ValueError("generate_speech_tokens_spec is the B=1 latency path; use "
                         "generate_speech_tokens(_mtp) for batched synthesis")
    cache, p_len, last_idx, h = _prefill_prompt(params, cfg, text_tokens, text_mask,
                                                prompt_speech, prompt_speech_mask,
                                                max_new_tokens + k_mtp)
    dev, eos = h.device, cfg.eos_speech
    tokens = torch.full((1, max_new_tokens + k_mtp), eos, dtype=torch.int32, device=dev)
    recent = torch.full((1, cfg.win_size), -1, dtype=torch.int32, device=dev)
    pending, recent, done = _sample_next(params, cfg, noise, h, recent,
                                         torch.zeros((1,), dtype=torch.bool, device=dev), 0,
                                         min_new_tokens)
    tokens[:, 0] = pending
    n, passes = 1, 0
    while n < max_new_tokens and not bool(done.all()):
        local, drafts = recent, []
        for j in range(1, k_mtp):
            pos = n - 1 + j
            logits = _mask_control_logits(dense(params["mtp_heads"][j - 1], h[:, 0, :]), cfg,
                                          pos, min_new_tokens)
            g1, g2 = noise.ras_gumbel(pos, (1, min(cfg.top_k, logits.shape[-1])))
            d = _ras_sample(logits, local, cfg, g1, g2)
            local = torch.cat([local[:, 1:], d[:, None]], dim=1)
            drafts.append(d)
        span = torch.stack([pending] + drafts, dim=1)                      # [1, K]
        h_span = q2.decode_span(params["backbone"], cfg.backbone,
                                embed_rows(params["speech_embed"], span), p_len + n - 1, cache,
                                rope_pos=last_idx + n, prompt_len=last_idx + 1,
                                prompt_capacity=p_len)
        verifier = dense(params["head"], h_span)                          # [1, K, V]
        acc, rec, dn = ~done, recent, done
        samples, flags = [], []
        for j in range(1, k_mtp + 1):
            s, rec, dn = _sample_from_logits(cfg, noise, verifier[:, j - 1, :], rec, dn,
                                             n - 1 + j, min_new_tokens)
            samples.append(s)
            flags.append(acc)
            if j < k_mtp:
                acc = acc & (s == drafts[j - 1]) & (s != eos)
        s_vec, flag_vec = torch.stack(samples, dim=1), torch.stack(flags, dim=1)
        e = int(flag_vec.sum())                                           # ≥ 1
        emitted = torch.where(flag_vec, s_vec, eos)
        tokens[:, n:n + k_mtp] = emitted
        done = done | (flag_vec & (s_vec == eos)).any(dim=1)
        recent = torch.cat([recent, emitted], dim=1)[:, e:e + cfg.win_size]
        pending, h = emitted[:, e - 1], h_span[:, e - 1:e]
        n, passes = n + e, passes + 1
    tokens = tokens[:, :max_new_tokens]
    lengths = (tokens != eos).to(torch.int32).sum(dim=1)
    if with_stats:
        return tokens, lengths, {"backbone_passes": passes, "emitted": min(n, max_new_tokens)}
    return tokens, lengths


def select_generator(lm_cfg: SpeechLMConfig, batch_size: int):
    """The decode function for a config and batch size: lossless speculative
    for B = 1 when asked for, accept-all MTP when the config has heads,
    single-token otherwise."""
    if lm_cfg.mtp > 1 and lm_cfg.spec_decode and batch_size == 1:
        return generate_speech_tokens_spec
    if lm_cfg.mtp > 1:
        return generate_speech_tokens_mtp
    return generate_speech_tokens


# ============================================================ flow matching


@dataclasses.dataclass(frozen=True)
class FlowConfig:
    token_vocab: int = 6561 + 3
    dim: int = 512
    layers: int = 6
    heads: int = 8
    n_mels: int = 80
    token_mel_ratio: int = 2
    spk_embed_dim: int = 192
    n_steps: int = 10
    cfg_rate: float = 0.7
    sigma_min: float = 1e-6


def _time_embedding(t: torch.Tensor, dim: int) -> torch.Tensor:
    """Sinusoidal flow-time embedding. t [B] in [0, 1] → [B, dim] (f32)."""
    half = dim // 2
    freqs = torch.exp(-np.float32(np.log(10000.0))
                      * torch.arange(half, dtype=torch.float32, device=t.device) / half)
    ang = t.float()[:, None] * freqs[None, :] * 1000.0
    return torch.cat([torch.cos(ang), torch.sin(ang)], dim=-1)


def _flow_rope(t_frames: int, head_dim: int, dtype, device):
    inv = 1.0 / (10_000.0 ** (np.arange(0, head_dim, 2) / head_dim))
    fr = np.outer(np.arange(t_frames), inv)
    emb = np.concatenate([fr, fr], axis=-1)
    return (torch.as_tensor(np.cos(emb).astype(np.float32), device=device).to(dtype),
            torch.as_tensor(np.sin(emb).astype(np.float32), device=device).to(dtype))


def _flow_rope_mha(p: Params, heads: int, x: torch.Tensor, mask: torch.Tensor) -> torch.Tensor:
    """Self-attention with RoPE on q/k: the estimator's only temporal signal."""
    head_dim = x.shape[-1] // heads
    cos, sin = _flow_rope(x.shape[1], head_dim, x.dtype, x.device)
    q = q2.apply_rope(split_heads(dense(p["q"], x), heads), cos, sin)
    k = q2.apply_rope(split_heads(dense(p["k"], x), heads), cos, sin)
    v = split_heads(dense(p["v"], x), heads)
    logits = torch.einsum("bqhd,bkhd->bhqk", q * (head_dim ** -0.5), k)
    logits = torch.where(mask, logits, torch.finfo(logits.dtype).min)
    w = torch.softmax(logits.float(), dim=-1).to(x.dtype)
    return dense(p["o"], merge_heads(torch.einsum("bhqk,bkhd->bqhd", w, v)))


def flow_estimator(params: Params, cfg: FlowConfig, x_t: torch.Tensor, t: torch.Tensor,
                   token_cond: torch.Tensor, spk: torch.Tensor, mel_cond: torch.Tensor,
                   mask: torch.Tensor) -> torch.Tensor:
    """DiT estimator v(x_t, t | tokens, speaker, prompt mel) → [B, T, n_mels]."""
    h = dense(params["in_proj"], torch.cat([x_t, mel_cond], dim=-1))
    h = h + token_cond + dense(params["spk_proj"], spk)[:, None, :]
    temb = mlp(params["time_mlp"], _time_embedding(t, cfg.dim).to(h.dtype))
    attn_mask = mask[:, None, None, :]
    for blk in params["blocks"]:
        mod = dense(blk["ada"], F.silu(temb))[:, None, :]
        s1, b1, g1, s2, b2, g2 = torch.chunk(mod, 6, dim=-1)
        a_in = layer_norm(blk["ln1"], h) * (1 + s1) + b1
        h = h + g1 * _flow_rope_mha(blk["attn"], cfg.heads, a_in, attn_mask)
        m_in = layer_norm(blk["ln2"], h) * (1 + s2) + b2
        h = h + g2 * mlp(blk["mlp"], m_in)
    return dense(params["out_proj"], layer_norm(params["ln_out"], h)) * mask[..., None]


def tokens_to_mel(params: Params, cfg: FlowConfig, noise: NoiseSource,
                  speech_tokens: torch.Tensor, token_mask: torch.Tensor,
                  spk_embedding: torch.Tensor, prompt_mel: torch.Tensor,
                  prompt_mel_mask: torch.Tensor, prompt_tokens: Optional[torch.Tensor] = None,
                  prompt_token_mask: Optional[torch.Tensor] = None):
    """OT-CFM inference: Euler-integrate dx/dt = v(x, t | c) from x_0 ~ N(0, I)
    with batched classifier-free guidance. The prompt mel (and its tokens)
    condition the first frames. Returns (mel [B, T_prompt + r T_tok, n_mels],
    frame_mask)."""
    b, t_tok = speech_tokens.shape
    r = cfg.token_mel_ratio
    tok = params["token_embed"][speech_tokens.long()] * token_mask[..., None]
    up = torch.repeat_interleave(tok, r, dim=1)
    up_mask = torch.repeat_interleave(token_mask, r, dim=1)
    t_prompt = prompt_mel.shape[1]
    if prompt_tokens is not None:
        ptok = params["token_embed"][prompt_tokens.long()] * prompt_token_mask[..., None]
        pup = torch.repeat_interleave(ptok, r, dim=1)
        if pup.shape[1] < t_prompt:
            pup = F.pad(pup, (0, 0, 0, t_prompt - pup.shape[1]))
        else:
            pup = pup[:, :t_prompt]
        prompt_cond = pup * prompt_mel_mask[..., None]
    else:
        prompt_cond = torch.zeros((b, t_prompt, cfg.dim), dtype=up.dtype, device=up.device)
    token_cond = torch.cat([prompt_cond, up], dim=1)
    frame_mask = torch.cat([prompt_mel_mask, up_mask], dim=1)
    total_frames = t_prompt + r * t_tok
    mel_cond = torch.cat([prompt_mel * prompt_mel_mask[..., None],
                          torch.zeros((b, r * t_tok, cfg.n_mels), dtype=prompt_mel.dtype,
                                      device=prompt_mel.device)], dim=1)
    x = noise.flow_x0((b, total_frames, cfg.n_mels)).to(prompt_mel.dtype)
    dt = 1.0 / cfg.n_steps
    if cfg.cfg_rate > 0:
        token_cond2 = torch.cat([token_cond, torch.zeros_like(token_cond)])
        spk2 = torch.cat([spk_embedding, torch.zeros_like(spk_embedding)])
        mel_cond2 = torch.cat([mel_cond, torch.zeros_like(mel_cond)])
        mask2 = torch.cat([frame_mask, frame_mask])
    for i in range(cfg.n_steps):
        t = torch.full((b,), float(np.float32(i) * np.float32(dt)), dtype=x.dtype, device=x.device)
        if cfg.cfg_rate > 0:
            v2 = flow_estimator(params, cfg, torch.cat([x, x]), torch.cat([t, t]),
                                token_cond2, spk2, mel_cond2, mask2)
            v = (1 + cfg.cfg_rate) * v2[:b] - cfg.cfg_rate * v2[b:]
        else:
            v = flow_estimator(params, cfg, x, t, token_cond, spk_embedding, mel_cond, frame_mask)
        x = (x + dt * v).to(x.dtype)
    return x * frame_mask[..., None], frame_mask


class FlowLossDraws(NamedTuple):
    """The five random draws of one :func:`flow_matching_loss` call: the
    flow's start ``x0`` [B, T, n_mels] ~ N(0, 1), and four [B] uniforms on
    [0, 1): the flow time ``t``, the prompt coin ``prompt_u``, the prefix
    fraction ``frac_u`` and the conditioning drop ``drop_u``."""

    x0: torch.Tensor
    t: torch.Tensor
    prompt_u: torch.Tensor
    frac_u: torch.Tensor
    drop_u: torch.Tensor

    @classmethod
    def sample(cls, gen: torch.Generator, mel_shape: Tuple[int, ...], device) -> "FlowLossDraws":
        b = mel_shape[0]
        return cls(torch.randn(mel_shape, generator=gen, device=device),
                   *(torch.rand((b,), generator=gen, device=device) for _ in range(4)))


def flow_matching_loss(params: Params, cfg: FlowConfig, draws: FlowLossDraws, mel: torch.Tensor,
                       speech_tokens: torch.Tensor, token_mask: torch.Tensor,
                       spk_embedding: torch.Tensor) -> torch.Tensor:
    """OT-CFM training loss E_t ||v(x_t, t) - (x_1 - (1 - sigma_min) x_0)||^2
    over the valid frames, with the official flow training's conditioning:
    per row, with p = 0.5, a prefix of at most 30 % of the valid frames of
    the target mel is exposed as ``mel_cond``, and all conditioning drops on
    rows whose ``drop_u`` < 0.2 (matcha's training_cfg_rate), so the
    unconditional mode CFG extrapolates against is trained."""
    b, t_frames, _ = mel.shape
    x0 = draws.x0.to(mel.dtype)
    t = draws.t.to(mel.dtype)
    x_t = (1 - (1 - cfg.sigma_min) * t[:, None, None]) * x0 + t[:, None, None] * mel
    target = mel - (1 - cfg.sigma_min) * x0

    tok = params["token_embed"][speech_tokens.long()] * token_mask[..., None]
    up = torch.repeat_interleave(tok, cfg.token_mel_ratio, dim=1)
    up_mask = torch.repeat_interleave(token_mask, cfg.token_mel_ratio, dim=1)
    # STFT framing can give a frame more or less than token_mel_ratio * T_tok
    if up.shape[1] < t_frames:
        up = F.pad(up, (0, 0, 0, t_frames - up.shape[1]))
        up_mask = F.pad(up_mask, (0, t_frames - up_mask.shape[1]))
    else:
        up, up_mask = up[:, :t_frames], up_mask[:, :t_frames]

    n_valid = up_mask.sum(dim=1)
    use_prompt = draws.prompt_u < 0.5
    prefix = (draws.frac_u * 0.3 * n_valid).to(torch.int32) * use_prompt.to(torch.int32)
    pos = torch.arange(t_frames, device=mel.device)[None, :]
    mel_cond = torch.where((pos < prefix[:, None])[..., None], mel, 0.0)
    keep = (draws.drop_u >= 0.2).to(mel.dtype)
    v = flow_estimator(params, cfg, x_t, t, up * keep[:, None, None], spk_embedding * keep[:, None],
                       mel_cond * keep[:, None, None], up_mask)
    sq = ((v - target) ** 2).sum(dim=-1) * up_mask
    return sq.sum() / (up_mask.sum() * cfg.n_mels + 1e-8)


# ================================================================== vocoder


@dataclasses.dataclass(frozen=True)
class VocoderConfig:
    n_mels: int = 80
    base_channels: int = 512
    upsample_rates: Tuple[int, ...] = (8, 6, 10)     # 480 = 24 kHz / 50 Hz frames
    upsample_kernels: Tuple[int, ...] = (16, 12, 20)
    resblock_kernels: Tuple[int, ...] = (3, 7, 11)
    resblock_dilations: Tuple[Tuple[int, ...], ...] = ((1, 3, 5),) * 3

    @property
    def hop(self) -> int:
        out = 1
        for r in self.upsample_rates:
            out *= r
        return out


def _lrelu(x: torch.Tensor) -> torch.Tensor:
    return F.leaky_relu(x, 0.1)


def _conv1d(p: Params, x: torch.Tensor, *, dilation: int = 1) -> torch.Tensor:
    """'same' conv on [B, C, T]; x is cast to the kernel's dtype first."""
    width = p["kernel"].shape[-1]
    return F.conv1d(x.to(p["kernel"].dtype), p["kernel"], p["bias"],
                    padding=dilation * (width - 1) // 2, dilation=dilation)


def _conv_transpose1d(p: Params, x: torch.Tensor, stride: int) -> torch.Tensor:
    """torch ConvTranspose1d(stride=s, padding=(k−s)//2) trimmed to
    in_len × s, the JAX package's asymmetric padding (HiFi-GAN's length
    contract)."""
    width = p["kernel"].shape[-1]
    y = F.conv_transpose1d(x, p["kernel"], p["bias"], stride=stride,
                           padding=(width - stride) // 2)
    return y[..., : x.shape[-1] * stride]


def vocode(params: Params, cfg: VocoderConfig, mel: torch.Tensor) -> torch.Tensor:
    """mel [B, T, n_mels] → waveform [B, T * hop] at 24 kHz. Stages with
    C ≤ 128 and C % 8 == 0 run the fused resblock kernel."""
    x = _conv1d(params["conv_pre"], mel.transpose(1, 2))
    for up, stage, rate in zip(params["ups"], params["res"], cfg.upsample_rates):
        x = _conv_transpose1d(up, _lrelu(x), rate)
        ch = x.shape[1]
        if ch <= 128 and ch % 8 == 0:
            weights = cuda_vocoder.stage_weights_flat(stage, cfg.resblock_kernels,
                                                      cfg.resblock_dilations)
            x = cuda_vocoder.fused_resblock_stage(
                x.transpose(1, 2), weights, kernels=tuple(cfg.resblock_kernels),
                dilations=tuple(tuple(d) for d in cfg.resblock_dilations)).transpose(1, 2)
            continue
        acc = None
        for block, dils in zip(stage, cfg.resblock_dilations):
            h = x
            for unit, d in zip(block, dils):
                y = _conv1d(unit["c1"], _lrelu(h), dilation=d)
                y = _conv1d(unit["c2"], _lrelu(y))
                h = h + y
            acc = h if acc is None else acc + h
        x = acc / len(stage)
    x = torch.tanh(_conv1d(params["conv_post"], _lrelu(x)))
    return x[:, 0, :]


def vocoder_halo_frames(cfg: VocoderConfig, pre_width: int = 7, post_width: int = 7) -> int:
    """The vocoder's receptive field in mel frames, one side: how far a
    frame reaches into the waveform of its neighbours. Worked back from the
    output: ``conv_post``'s reach, then per stage (last first) the widest
    resblock branch's (Σ over its dilations d of d·(k − 1)/2 for the
    dilated conv plus (k − 1)/2 for the plain one), carried through the
    transposed conv to its input rate (⌈(reach + kernel) / rate⌉ + 1), then
    ``conv_pre``'s. 16 frames at the default :class:`VocoderConfig`
    (kernels 16/12/20, rates 8/6/10, resblock kernels 3/7/11 at dilations
    1/3/5, 7-wide pre and post convs)."""
    reach = (post_width - 1) // 2
    for rate, kernel in zip(reversed(cfg.upsample_rates), reversed(cfg.upsample_kernels)):
        reach += max(sum(d * (k - 1) // 2 + (k - 1) // 2 for d in dils)
                     for k, dils in zip(cfg.resblock_kernels, cfg.resblock_dilations))
        reach = -(-(reach + kernel) // rate) + 1
    return reach + (pre_width - 1) // 2


def vocode_sp(params: Params, cfg: VocoderConfig, mel: torch.Tensor, mesh,
              axis: str) -> torch.Tensor:
    """Sequence-parallel vocoding: the mel's time axis cut into ``n =
    mesh.shape[axis]`` windows, one a device (the leads of the dp groups
    for ``axis="dp"``, the slots of group 0 for ``"tp"``), each with a halo
    of :func:`vocoder_halo_frames` frames on either side; each window is
    vocoded on its device by :func:`vocode` (its narrow stages launch the
    resblock kernel on that card), the halos trimmed, the windows
    concatenated on the first device. This process must own those slots.

    As the JAX package's ``vocode_sp``: T is zero-padded to a multiple of n
    and the waveform trimmed to T·hop, so the padded frames reach into the
    trailing receptive field exactly as they do there; with T divisible by
    n the result is :func:`vocode`'s. The long-audio path: the vocoder is
    the only stage whose cost is a pure function of audio length."""
    from ..parallel.mesh import owned, run_per_group

    slots = owned(mesh.devices[:, 0] if axis == "dp" else mesh.devices[0, :])
    n = mesh.shape[axis]
    t = mel.shape[1]
    pad = (-t) % n
    if pad:
        mel = F.pad(mel, (0, 0, 0, pad))
    width, halo, hop = mel.shape[1] // n, vocoder_halo_frames(cfg), cfg.hop
    lead = slots[0].device

    def window(i: int) -> torch.Tensor:
        dev = slots[i].device
        lo, hi = max(i * width - halo, 0), min((i + 1) * width + halo, mel.shape[1])
        wave = vocode(tree_to(params, dev), cfg, mel[:, lo:hi].to(dev))
        keep = (i * width - lo) * hop
        return wave[:, keep: keep + width * hop].to(lead)

    wave = torch.cat(run_per_group(window, [(i,) for i in range(n)]), dim=1)
    return wave[:, : t * hop] if pad else wave


# ============================================================== full model


@dataclasses.dataclass(frozen=True)
class CosyVoiceConfig:
    lm: SpeechLMConfig = dataclasses.field(default_factory=SpeechLMConfig)
    flow: FlowConfig = dataclasses.field(default_factory=FlowConfig)
    vocoder: VocoderConfig = dataclasses.field(default_factory=VocoderConfig)
    sample_rate: int = 24_000


def init_speech_lm(r: Init, cfg: SpeechLMConfig) -> Params:
    """Seeded random speech-LM parameters (no MTP heads: see
    :func:`init_mtp_heads`)."""
    h = cfg.backbone.hidden
    return {"backbone": q2.init_qwen2(r, cfg.backbone),
            "text_embed": r.normal((cfg.text_vocab, h), 0.02),
            "speech_embed": r.normal((cfg.speech_token_size + 3, h), 0.02),
            "head": r.dense(h, cfg.speech_token_size + 3)}


def init_mtp_heads(r: Init, cfg: SpeechLMConfig) -> list:
    """The K − 1 MTP heads of ``cfg.mtp`` = K, dense [hidden,
    speech_token_size + 3]. A model's init draws them last, so every other
    tensor is the same at any MTP width."""
    return [r.dense(cfg.backbone.hidden, cfg.speech_token_size + 3) for _ in range(cfg.mtp - 1)]


def init_cosyvoice(seed: int, cfg: CosyVoiceConfig, device) -> Params:
    """Seeded random parameters (f32) on ``device``, the JAX init's shapes and
    scales; adaLN modulation zero-initialised (adaLN-Zero); with
    ``cfg.lm.mtp`` > 1 the LM's ``mtp_heads``, K − 1 dense heads
    [hidden, speech_token_size + 3]."""
    r = Init(seed, device)
    lm, fl, vc = cfg.lm, cfg.flow, cfg.vocoder

    def conv(width, in_ch, out_ch):
        return {"kernel": r.uniform((out_ch, in_ch, width), 1.0 / np.sqrt(in_ch * width)),
                "bias": r.zeros((out_ch,))}

    ch = vc.base_channels
    ups, res = [], []
    for i, (rate, kw) in enumerate(zip(vc.upsample_rates, vc.upsample_kernels)):
        in_ch, out_ch = ch // (2 ** i), ch // (2 ** (i + 1))
        ups.append({"kernel": r.uniform((in_ch, out_ch, kw), 1.0 / np.sqrt(in_ch * kw)),
                    "bias": r.zeros((out_ch,))})
        res.append([[{"c1": conv(k, out_ch, out_ch), "c2": conv(k, out_ch, out_ch)}
                     for _ in dils]
                    for k, dils in zip(vc.resblock_kernels, vc.resblock_dilations)])
    attn = AttnConfig(fl.dim, fl.heads, k_bias=True)
    params = {
        "lm": init_speech_lm(r, lm),
        "flow": {
            "token_embed": r.normal((fl.token_vocab, fl.dim), 0.02),
            "spk_proj": r.dense(fl.spk_embed_dim, fl.dim),
            "in_proj": r.dense(fl.n_mels * 2, fl.dim),
            "time_mlp": r.mlp(fl.dim, fl.dim),
            "blocks": [{"ln1": r.layer_norm(fl.dim), "attn": r.attention(attn),
                        "ln2": r.layer_norm(fl.dim), "mlp": r.mlp(fl.dim, fl.dim * 4),
                        "ada": {"kernel": r.zeros((fl.dim, 6 * fl.dim)),
                                "bias": r.zeros((6 * fl.dim,))}}
                       for _ in range(fl.layers)],
            "ln_out": r.layer_norm(fl.dim),
            "out_proj": r.dense(fl.dim, fl.n_mels),
        },
        "vocoder": {
            "conv_pre": conv(7, vc.n_mels, ch),
            "ups": ups,
            "res": res,
            "conv_post": conv(7, ch // (2 ** len(vc.upsample_rates)), 1),
        },
    }
    if lm.mtp > 1:
        params["lm"]["mtp_heads"] = init_mtp_heads(r, lm)
    return params


def from_jax_params(tree, device, dtype=torch.float32) -> Params:
    """The JAX package's cosyvoice parameter tree → the port's: vocoder conv
    kernels [width, in, out] → [out, in, width], conv-transpose kernels →
    [in, out, width]; everything else keeps its layout."""
    p = tree_from_numpy(tree, device, dtype)
    voc = p["vocoder"]

    def conv(c):
        c["kernel"] = c["kernel"].permute(2, 1, 0).contiguous()

    conv(voc["conv_pre"])
    conv(voc["conv_post"])
    for up in voc["ups"]:
        up["kernel"] = up["kernel"].permute(1, 2, 0).contiguous()
    for stage in voc["res"]:
        for block in stage:
            for unit in block:
                conv(unit["c1"])
                conv(unit["c2"])
    return p


def from_cosyvoice_llm_state_dict(state, cfg: SpeechLMConfig, device=None) -> Params:
    """An official CosyVoice2 ``llm.pt`` (``cosyvoice.llm.llm.Qwen2LM``) state
    dict → the port's speech-LM tree on ``device``, its dtype kept.

    ``llm.model.*`` is the HF Qwen2 backbone, whose ``embed_tokens`` becomes
    ``text_embed``; ``speech_embedding`` is the speech table, whose sos and
    task slots take the two ``llm_embedding`` rows; ``llm_decoder`` is the
    head (EOS at index speech_token_size on both sides). The checkpoint has
    no MTP heads, so a config with ``mtp`` > 1 is refused."""
    if cfg.mtp > 1:
        raise ValueError("official llm.pt has no MTP heads; use SpeechLMConfig(mtp=1) "
                         f"(got mtp={cfg.mtp})")
    dev = resolve_device(device)
    backbone_state = {k[len("llm.model."):]: v for k, v in state.items()
                      if k.startswith("llm.model.")}
    text_key = next((k for k in ("model.embed_tokens.weight", "embed_tokens.weight")
                     if k in backbone_state), None)
    if text_key is None:
        raise KeyError("embed_tokens.weight")
    speech_embed = state_tensor(state["speech_embedding.weight"], dev).clone()
    if speech_embed.shape[0] != cfg.speech_token_size + 3:
        raise ValueError(f"speech_embedding rows {speech_embed.shape[0]} != "
                         f"speech_token_size+3 ({cfg.speech_token_size + 3}) — config mismatch")
    llm_embedding = state_tensor(state["llm_embedding.weight"], dev)
    speech_embed[cfg.sos_index] = llm_embedding[0]
    speech_embed[cfg.task_index] = llm_embedding[1]
    return {"backbone": q2.from_hf_state_dict(backbone_state, cfg.backbone, dev),
            "text_embed": state_tensor(backbone_state[text_key], dev),
            "speech_embed": speech_embed,
            "head": linear_from_state(state["llm_decoder.weight"], state.get("llm_decoder.bias"),
                                      dev)}


def speech_lm_partition_rules(tp_axis: str = "tp") -> PartitionRules:
    """TP rules for the whole speech LM: the backbone's
    (``qwen2.partition_rules``), hidden-split embedding tables and a
    vocab-parallel output head; the MTP heads are extra [H, V] heads,
    vocab-parallel like the main one (paths ``mtp_heads/0/kernel``)."""
    return PartitionRules(rules=q2.partition_rules(tp_axis).rules + (
        (r"(text_embed|speech_embed)$", (None, tp_axis)),
        (r"head/kernel(_q)?$", (None, tp_axis)),
        (r"head/scale$", (None, tp_axis)),
        (r"head/bias$", (tp_axis,)),
        (r"mtp_heads/\d+/kernel(_q)?$", (None, tp_axis)),
        (r"mtp_heads/\d+/scale$", (None, tp_axis)),
        (r"mtp_heads/\d+/bias$", (tp_axis,)),
    ))


def quantize_speech_lm(params: Params) -> Params:
    """int8 weights for the speech LM's decode: every backbone dense layer,
    the head and the MTP heads; the embedding tables and norms stay float."""
    backbone = dict(params["backbone"])
    backbone["layers"] = [{**layer, **{n: quantize_dense(layer[n]) for n in
                                       ("q", "k", "v", "o", "gate", "up", "down")}}
                          for layer in backbone["layers"]]
    out = {**params, "backbone": backbone, "head": quantize_dense(params["head"])}
    if "mtp_heads" in params:
        out["mtp_heads"] = [quantize_dense(h) for h in params["mtp_heads"]]
    return out


def synthesize(params: Params, cfg: CosyVoiceConfig, noise: NoiseSource,
               text_tokens: torch.Tensor, text_mask: torch.Tensor,
               prompt_speech_tokens: torch.Tensor, prompt_speech_mask: torch.Tensor,
               spk_embedding: torch.Tensor, prompt_mel: torch.Tensor,
               prompt_mel_mask: torch.Tensor, *, max_new_tokens: int = 512,
               min_new_tokens: int = 2) -> Dict[str, torch.Tensor]:
    """Text + voice prompt → 24 kHz waveform of the new speech only
    ({"audio", "mel", "speech_tokens", "token_lengths"})."""
    gen = select_generator(cfg.lm, text_tokens.shape[0])
    tokens, lengths = gen(
        params["lm"], cfg.lm, noise, text_tokens, text_mask, prompt_speech_tokens,
        prompt_speech_mask, max_new_tokens=max_new_tokens, min_new_tokens=min_new_tokens)
    token_mask = torch.arange(tokens.shape[1], device=tokens.device)[None, :] < lengths[:, None]
    safe_tokens = torch.where(token_mask, tokens, 0)
    mel, _ = tokens_to_mel(
        params["flow"], cfg.flow, noise, safe_tokens, token_mask, spk_embedding, prompt_mel,
        prompt_mel_mask, prompt_tokens=torch.where(prompt_speech_mask, prompt_speech_tokens, 0),
        prompt_token_mask=prompt_speech_mask)
    gen_mel = mel[:, prompt_mel.shape[1]:]
    audio = vocode(params["vocoder"], cfg.vocoder, gen_mel)
    return {"audio": audio, "mel": gen_mel, "speech_tokens": tokens, "token_lengths": lengths}


# ========================================================= streaming synthesis


@dataclasses.dataclass(frozen=True)
class StreamConfig:
    chunk_tokens: int = 25       # speech tokens a chunk: 1 s at 25 Hz
    flow_context: int = 16       # mel frames of left context re-fed to the flow
    vocoder_context: int = 12    # mel frames re-vocoded to warm the left edge
    fade_samples: int = 1024     # crossfade at chunk joins (~43 ms at 24 kHz)


def lm_stream_start(params: Params, cfg: SpeechLMConfig, text_tokens: torch.Tensor,
                    text_mask: torch.Tensor, prompt_speech: torch.Tensor,
                    prompt_speech_mask: torch.Tensor, *, max_new_tokens: int = 512) -> dict:
    """Prefill the speech LM → a resumable decode state whose cache holds the
    prompt and ``max_new_tokens`` generated tokens."""
    cache, _, last_idx, h = _prefill_prompt(params, cfg, text_tokens, text_mask, prompt_speech,
                                            prompt_speech_mask, max_new_tokens)
    b, dev = h.shape[0], h.device
    return {"h": h, "cache": cache,
            "recent": torch.full((b, cfg.win_size), -1, dtype=torch.int32, device=dev),
            "done": torch.zeros((b,), dtype=torch.bool, device=dev),
            "step": 0, "last_idx": last_idx}


def lm_stream_chunk(params: Params, cfg: SpeechLMConfig, noise: NoiseSource, state: dict, *,
                    chunk_tokens: int, min_new_tokens: int, p_len: int):
    """Decode ``chunk_tokens`` more speech tokens from a stream state →
    (tokens [B, chunk_tokens], the state, advanced). A fixed trip count:
    rows at EOS keep emitting EOS, and every sample, the chunk's last
    included, is followed by a decode step whose ``h`` the next chunk
    resumes from. ``noise`` is the chunk's source, indexed by the step
    inside the chunk."""
    h, cache, recent, done = state["h"], state["cache"], state["recent"], state["done"]
    step, last_idx = state["step"], state["last_idx"]
    b = recent.shape[0]
    tokens = torch.full((b, chunk_tokens), cfg.eos_speech, dtype=torch.int32, device=h.device)
    for j in range(chunk_tokens):
        nxt, recent, done = _sample_next(params, cfg, noise, h, recent, done, step,
                                         min_new_tokens, draw=j)
        tokens[:, j] = nxt
        h = q2.decode_step(params["backbone"], cfg.backbone,
                           embed_rows(params["speech_embed"], nxt)[:, None, :], p_len + step, cache,
                           rope_pos=last_idx + 1 + step, prompt_len=last_idx + 1,
                           prompt_capacity=p_len)
        step += 1
    return tokens, {"h": h, "cache": cache, "recent": recent, "done": done, "step": step,
                    "last_idx": last_idx}


def flow_vocode_chunk(params: Params, flow_cfg: FlowConfig, voc_cfg: VocoderConfig,
                      noise: NoiseSource, tokens: torch.Tensor, n_valid: int,
                      spk: torch.Tensor, ctx_mel: torch.Tensor, ctx_mask: torch.Tensor,
                      ctx_tok: torch.Tensor, ctx_tok_mask: torch.Tensor,
                      voc_hist: torch.Tensor):
    """One streamed chunk, tokens → waveform. ``params`` holds ``"flow"`` and
    ``"vocoder"``; tokens [1, C] (EOS-padded, ``n_valid`` before EOS); the
    flow's left context ctx_mel [1, F, n_mels] / ctx_mask [1, F] with the
    tokens behind it ctx_tok / ctx_tok_mask [1, F // r]; voc_hist
    [1, V, n_mels] the vocoder's warm-up frames. → (the chunk's mel
    [1, r C, n_mels], its frames past r·n_valid zeroed; the waveform of
    voc_hist and that mel [1, (V + r C) hop])."""
    c = tokens.shape[1]
    # the host-side context buffers arrive f32: cast them to the flow's
    # dtype, or a bf16 flow would run every chunk in f32
    pdtype = params["flow"]["in_proj"]["kernel"].dtype
    ctx_mel = ctx_mel.to(pdtype)
    spk = spk.to(pdtype)
    tok_mask = torch.arange(c, device=tokens.device)[None, :] < n_valid
    safe = torch.where(tok_mask, tokens, 0)
    mel, _ = tokens_to_mel(params["flow"], flow_cfg, noise, safe, tok_mask, spk, ctx_mel,
                           ctx_mask, prompt_tokens=ctx_tok, prompt_token_mask=ctx_tok_mask)
    gen = mel[:, ctx_mel.shape[1]:]
    r = flow_cfg.token_mel_ratio
    gen = gen * (torch.arange(gen.shape[1], device=gen.device)[None, :] < r * n_valid)[..., None]
    wav = vocode(params["vocoder"], voc_cfg, torch.cat([voc_hist.to(gen.dtype), gen], dim=1))
    return gen, wav


def synthesize_streaming(params: Params, cfg: CosyVoiceConfig, noise: NoiseSource,
                         text_tokens: torch.Tensor, text_mask: torch.Tensor,
                         prompt_speech_tokens: torch.Tensor, prompt_speech_mask: torch.Tensor,
                         spk_embedding: torch.Tensor, prompt_mel: torch.Tensor,
                         prompt_mel_mask: torch.Tensor, *, stream: StreamConfig = StreamConfig(),
                         max_new_tokens: int = 512, min_new_tokens: int = 2):
    """Chunked zero-shot TTS of one stream (B == 1): yields 24 kHz waveform
    chunks (np.float32). A chunk: the LM emits ``chunk_tokens`` tokens from
    its resumable state; the flow makes their mel, conditioned on the last
    ``flow_context`` frames (and their tokens) as its prompt; the vocoder
    re-renders ``vocoder_context`` frames of history plus the new ones, and
    consecutive chunks are crossfaded over ``fade_samples`` (the tail is held
    back and yielded last). ``noise.chunk(ci, n_chunks)`` is chunk ci's
    noise. The budget ``max_new_tokens`` is honoured exactly."""
    if text_tokens.shape[0] != 1:
        raise ValueError("streaming synthesis is single-stream (batch == 1); "
                         "use synthesize() for batched offline TTS")
    r = cfg.flow.token_mel_ratio
    hop = cfg.vocoder.hop
    c_tok = stream.chunk_tokens
    n_chunks = -(-max_new_tokens // c_tok)
    dev = text_tokens.device
    lm_state = lm_stream_start(params["lm"], cfg.lm, text_tokens, text_mask,
                               prompt_speech_tokens, prompt_speech_mask,
                               max_new_tokens=n_chunks * c_tok)
    p_len = 2 + text_tokens.shape[1] + prompt_speech_tokens.shape[1]

    # the flow's context: the last flow_context mel frames, right-aligned,
    # seeded from the prompt's tail
    f_ctx = stream.flow_context
    if f_ctx % r:
        # the token buffer covers f_ctx // r tokens: a non-multiple would leave
        # the newest context frames without their tokens
        raise ValueError(f"StreamConfig.flow_context={f_ctx} must be a multiple of "
                         f"token_mel_ratio={r}")
    n_mels = cfg.flow.n_mels
    ctx_mel = np.zeros((1, f_ctx, n_mels), np.float32)
    ctx_mask = np.zeros((1, f_ctx), bool)
    pm_valid = prompt_mel[0].float().cpu().numpy()[prompt_mel_mask[0].cpu().numpy().astype(bool)]
    take = min(len(pm_valid), f_ctx)
    if take:
        ctx_mel[0, f_ctx - take:] = pm_valid[len(pm_valid) - take:]
        ctx_mask[0, f_ctx - take:] = True
    # the tokens behind the context frames (one token a r frames), likewise
    w_tok = max(f_ctx // r, 1)
    ctx_tok = np.zeros((1, w_tok), np.int32)
    ctx_tok_mask = np.zeros((1, w_tok), bool)
    psp_valid = prompt_speech_tokens[0].cpu().numpy()[
        prompt_speech_mask[0].cpu().numpy().astype(bool)]
    tk = min(len(psp_valid), w_tok)
    if tk:
        ctx_tok[0, w_tok - tk:] = psp_valid[len(psp_valid) - tk:]
        ctx_tok_mask[0, w_tok - tk:] = True

    # the vocoder's warm-up history and the crossfade's held tail
    v_ctx = stream.vocoder_context
    voc_hist = np.zeros((v_ctx, n_mels), np.float32)
    held: Optional[np.ndarray] = None

    def dev_t(a):
        return torch.from_numpy(np.ascontiguousarray(a)).to(dev)

    fv_params = {"flow": params["flow"], "vocoder": params["vocoder"]}
    for ci in range(n_chunks):
        chunk_noise = noise.chunk(ci, n_chunks)
        tokens, lm_state = lm_stream_chunk(params["lm"], cfg.lm, chunk_noise, lm_state,
                                           chunk_tokens=c_tok, min_new_tokens=min_new_tokens,
                                           p_len=p_len)
        tok_np = tokens[0].cpu().numpy()
        is_eos = tok_np == cfg.lm.eos_speech
        n_valid = int(np.argmax(is_eos)) if is_eos.any() else c_tok
        # the last chunk may be short: the stream emits no more than synthesize()
        n_valid = min(n_valid, max_new_tokens - ci * c_tok)
        if n_valid <= 0:
            break
        gen, wav = flow_vocode_chunk(fv_params, cfg.flow, cfg.vocoder, chunk_noise, tokens,
                                     n_valid, spk_embedding, dev_t(ctx_mel), dev_t(ctx_mask),
                                     dev_t(ctx_tok), dev_t(ctx_tok_mask), dev_t(voc_hist[None]))
        gen_valid = gen[0, : r * n_valid].float().cpu().numpy()
        wav = wav[0].float().cpu().numpy()

        # roll the flow's context and its tokens on the host
        full = np.concatenate([ctx_mel[0][ctx_mask[0]], gen_valid], axis=0)
        if len(full) >= f_ctx:
            ctx_mel[0] = full[-f_ctx:]
            ctx_mask[0] = True
        else:
            ctx_mel[0] = np.concatenate([np.zeros((f_ctx - len(full), n_mels), np.float32),
                                         full])
            ctx_mask[0] = np.arange(f_ctx) >= f_ctx - len(full)
        tok_full = np.concatenate([ctx_tok[0][ctx_tok_mask[0]],
                                   tok_np[:n_valid].astype(np.int32)])
        if len(tok_full) >= w_tok:
            ctx_tok[0] = tok_full[-w_tok:]
            ctx_tok_mask[0] = True
        else:
            ctx_tok[0] = np.concatenate([np.zeros(w_tok - len(tok_full), np.int32), tok_full])
            ctx_tok_mask[0] = np.arange(w_tok) >= w_tok - len(tok_full)

        start, end = v_ctx * hop, (v_ctx + len(gen_valid)) * hop
        fade = min(stream.fade_samples, v_ctx * hop, end - start)
        out = wav[start:end]
        if held is not None and fade > 0:
            ramp = np.linspace(0.0, 1.0, len(held), dtype=np.float32)
            out = np.concatenate([held * (1 - ramp) + wav[start - len(held):start] * ramp, out])
        if fade > 0:
            held = out[len(out) - fade:]
            out = out[: len(out) - fade]
        voc_hist = np.concatenate([voc_hist, gen_valid], axis=0)[-v_ctx:]
        if len(out):
            yield out
        if n_valid < c_tok:
            break
    if held is not None and len(held):
        yield held
