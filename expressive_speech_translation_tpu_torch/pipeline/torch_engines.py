"""The stage engines backed by the port's models, on the card by default.

Port of the JAX package's ``pipeline/jax_engines.py`` single-request path:

- :class:`TorchWhisperAsr` — fused log-mel kernel → Whisper encode + KV-cached
  decode with context buckets, the temperature-fallback ladder and its gates,
  ``condition_on_previous_text``, SuppressBlank, DTW word timestamps, and
  language detection when the caller names no language; ``transcribe`` is
  ``transcribe_streaming`` (one result a window) aggregated;
- :class:`TorchNllbNmt` — NLLB greedy or beam-search generate with the forced
  target-language BOS over bucketed source lengths;
- :class:`TorchCosyVoiceTts` — CosyVoice synthesis, offline or streamed in
  chunks, cloning the voice of a reference through voice-prompt conditioning
  (ECAPA speaker embedding, Kaldi-fbank prompt mel, FSQ prompt speech tokens);
  the native DiT-flow / HiFi-GAN chain, or with ``official=`` the official
  CosyVoice2 chain (matcha flow, HiFT) that serves converted checkpoints;
  ``mtp``/``spec`` select multi-token or lossless speculative speech-token
  decoding, reconciled with the heads the tree carries as JAX does.

Every engine takes ``quantize=True`` for int8 decode weights (after the
dtype cast, as in JAX), and ``mesh=`` (``parallel/mesh.py``) to serve from
a (dp, tp) group of cards: ASR and NMT under their partition rules, the TTS
speech LM under the speech-LM rules, everything else on each group's lead;
batched dispatches spread their rows over the dp groups
(:func:`~..parallel.mesh.dp_slices`). ``torch_engines(stage_parallel=True)``
gives each stage a disjoint group (``parallel/stages.py``).

Each engine also serves a batch of requests in one device pass
(``transcribe_batch``, ``translate_batch``, ``synthesize_batch``), padded to
the buckets of ``core/buckets.py``; ``torch_engines(batch_*=True)`` puts the
micro-batchers of ``serve/batching.py`` in front of them.

Without checkpoints every model runs on seeded random weights ("weightless"),
as the JAX engines do. ``EST_MODELS_DIR`` names a directory baked by
``models/loaders.py`` (``bake_models``), whose stage directories
``torch_engines`` serves as ``jax_engines`` serves its own bake.
"""

from __future__ import annotations

import dataclasses
import logging
import os
import types
import zlib
from pathlib import Path
from typing import Any, Callable, Dict, List, Optional, Tuple

import numpy as np
import torch

from ..core.buckets import bucket_batch, bucket_size, row_slices
from ..core.device import resolve_device
from ..models import cosyvoice as cvm
from ..models import cosyvoice_official as com
from ..models import ecapa as ecm
from ..models import nllb as nlm
from ..models import qwen2 as q2
from ..models import speech_tokenizer as stm
from ..models import whisper as wm
from ..models.common import cast_floats
from ..obs import spans
from ..ops.cuda_mel import whisper_log_mel_fused
from ..ops.mel import kaldi_fbank, whisper_log_mel
from ..ops.resample import resample
from ..parallel.mesh import TP_AXIS, dp_slices, run_per_group, shard_params
from ..parallel.partition import slot_ids
from ..serve.batching import BatchedAsr, BatchedNmt, BatchedTts
from .engines import Engines
from .languages import (NLLB_LANGUAGES, nllb_placeholder_lang_ids, whisper_lang_index,
                        whisper_token_to_app)
from .tokenizer import ByteTokenizer, Tokenizer, nllb_lang_ids

log = logging.getLogger(__name__)

TEXT_BUCKETS = (16, 32, 64, 128, 256)
TTS_BUDGET_BUCKETS = (64, 128, 256, 512, 768)


def _bucket_capped(n: int, buckets) -> int:
    """Smallest bucket ≥ n, clamped to the top bucket (only for budgets with
    an intended ceiling)."""
    return min(bucket_size(n, buckets), buckets[-1])


def _fit_vocab(ids, vocab_size: int, weightless: bool, label: str) -> np.ndarray:
    """Random-weight mode may wrap ids into the toy vocab; a real config must
    never silently corrupt tokenizer output."""
    arr = np.asarray(ids, np.int32)
    if weightless:
        return arr % vocab_size
    if arr.size and int(arr.max()) >= vocab_size:
        raise ValueError(f"{label} token id {int(arr.max())} out of range for vocab "
                         f"{vocab_size} — tokenizer/config mismatch")
    return arr


def _home(mesh, device) -> torch.device:
    """The device an engine makes its tensors on: under a mesh the lead of
    the first dp group this process owns, else ``device`` resolved."""
    if mesh is None:
        return resolve_device(device)
    local = mesh.local_groups()
    if not local:
        raise ValueError(f"no dp group of {mesh} belongs to this process")
    return mesh.lead(local[0])


class _Placed:
    """Mesh placement shared by the engines. ``mesh=None`` serves from one
    device. Under a mesh the engine's trees are placed on every dp group
    this process owns (``parallel.mesh.shard_params``): the first group's
    are the engine's own, on its ``device``. ``groups`` holds one placement
    a group, each with ``device`` and the placed trees: the engine itself
    for the first, a namespace for each further one. A batched dispatch
    hands each group's placement its share of the rows (:meth:`_per_group`);
    every setting is read from the engine."""

    mesh = None

    @property
    def groups(self) -> list:
        return self.__dict__.get("_groups", [self])

    def _place(self, mesh, trees: Callable[[int], Dict[str, Any]]) -> None:
        """``trees(group)`` → {attribute: that group's placed tree}."""
        local = mesh.local_groups()
        placed = {g: trees(g) for g in local}
        groups = [self] + [types.SimpleNamespace(device=mesh.lead(g)) for g in local[1:]]
        for entry, g in zip(groups, local):
            for name, tree in placed[g].items():
                setattr(entry, name, tree)
        self.mesh, self._groups = mesh, groups
        self.slot_ids = sorted({i for g, attrs in placed.items() for tree in attrs.values()
                                for i in slot_ids(tree, mesh, g)})

    def _per_group(self, rows: int, fn: Callable[[Any, int, int], Any]) -> list:
        """``fn(group, lo, hi)`` for each group's share of ``rows`` batch
        rows, one thread a group, the results in row order; a row count
        the groups do not divide runs whole on the first."""
        groups = self.groups
        return run_per_group(fn, [(groups[i], lo, hi)
                                  for i, lo, hi in dp_slices(range(len(groups)), rows)])


# ========================================================================= ASR


class TorchWhisperAsr(_Placed):
    """ASR engine: fused log-mel kernel → Whisper decode with alignments."""

    def __init__(
        self,
        cfg: Optional[wm.WhisperConfig] = None,
        params=None,
        tokenizer: Optional[Tokenizer] = None,
        *,
        device=None,
        dtype=torch.bfloat16,
        max_new_tokens: int = 224,
        quantize: bool = False,
        context_buckets: tuple = (30,),
        temperatures: Optional[tuple] = None,
        compression_ratio_threshold: float = 2.4,
        logprob_threshold: float = -1.0,
        no_speech_threshold: float = 0.6,
        suppress_tokens: tuple = (),
        suppress_blank: bool = True,
        condition_on_previous_text: bool = True,
        mesh=None,
    ):
        """``context_buckets``: encoder windows in seconds (even, ascending,
        at most 30); an utterance chunk is padded to the smallest that holds
        it. ``temperatures``: the fallback ladder; random weights always fail
        the logprob gate, so weightless mode defaults to greedy only.
        ``quantize``: int8 decoder weights and tied head
        (``whisper.quantize_whisper_decoder``, after the dtype cast).
        ``mesh``: serve from its groups (``whisper_partition_rules``); the
        engine's device is then its first group's lead."""
        self.device = _home(mesh, device)
        self.cfg = cfg or wm.WhisperConfig(d_model=512, encoder_layers=6, decoder_layers=6,
                                           heads=8, ffn_dim=2048)
        self.weightless = params is None
        if params is None:
            log.warning("TorchWhisperAsr: random weights (no checkpoint supplied)")
            params = wm.init_whisper(0, self.cfg, self.device)
        self.params = cast_floats(params, dtype)
        self.quantized = quantize
        if quantize:
            self.params = wm.quantize_whisper_decoder(self.params)
        self.dtype = dtype
        self.tokenizer = tokenizer or ByteTokenizer()
        self.max_new_tokens = max_new_tokens
        buckets = tuple(sorted(int(b) for b in context_buckets))
        if not buckets or buckets[-1] > 30 or any(b % 2 or b <= 0 for b in buckets):
            raise ValueError(f"context_buckets must be even seconds in (0, 30], got {context_buckets}")
        self.context_buckets = buckets
        if temperatures is None:
            temperatures = (0.0,) if self.weightless else (0.0, 0.2, 0.4, 0.6, 0.8, 1.0)
        self.temperatures = tuple(temperatures) or (0.0,)
        self.compression_ratio_threshold = compression_ratio_threshold
        self.logprob_threshold = logprob_threshold
        self.no_speech_threshold = no_speech_threshold
        suppress_first: tuple = ()
        if suppress_blank:
            suppress_first = tuple(self.tokenizer.encode(" ")) + (self.cfg.eos_token,)
        self._suppress = (tuple(suppress_tokens), suppress_first)
        self.condition_on_previous_text = condition_on_previous_text
        self.PREV_CTX_BUCKETS = (8, 16, 32)
        self._seed = 0
        if mesh is not None:
            rules = wm.whisper_partition_rules(TP_AXIS)
            self._place(mesh, lambda g: {"params": shard_params(self.params, mesh, rules,
                                                                group=g)})

    def _prompt_row(self, language: Optional[str]) -> List[int]:
        try:
            idx = whisper_lang_index(language or "eng")
        except (KeyError, ValueError):
            idx = whisper_lang_index("eng")
        return [self.cfg.bos_token, self.cfg.lang_token_start + idx,
                self.cfg.task_transcribe, self.cfg.no_timestamps]

    @property
    def _special_floor(self) -> int:
        """Ids at or above the lowest special token are dropped from text."""
        return min(self.cfg.eos_token, self.cfg.bos_token, self.cfg.lang_token_start)

    def _pad_to_bucket(self, seg: np.ndarray) -> tuple:
        """Pad a chunk to its context bucket → (padded, bucket_seconds)."""
        bucket_s = next((b for b in self.context_buckets if len(seg) <= 16_000 * b),
                        self.context_buckets[-1])
        padded = np.zeros(16_000 * bucket_s, np.float32)
        padded[: len(seg)] = seg[: 16_000 * bucket_s]
        return padded, bucket_s

    def _decode_chunk_host(self, tokens: np.ndarray, aligns: np.ndarray, p_len: int,
                           chunk_offset: float, chunk_seconds: float,
                           window_seconds: Optional[float] = None) -> tuple:
        """DTW token times over the cross-attention alignment and word
        splitting for one decoded chunk → (text, words, kept_token_ids)."""
        gen = tokens[p_len:]
        keep = [(i, int(t)) for i, t in enumerate(gen)
                if t != self.cfg.eos_token and t < self._special_floor]
        if not keep:
            return "", [], []
        token_aligns = aligns[p_len:][[i for i, _ in keep]]
        token_times = wm.dtw_token_times(token_aligns, len(keep), window_seconds or chunk_seconds)
        token_times = np.minimum(token_times, chunk_seconds)
        chunk_text = self.tokenizer.decode([t for _, t in keep]).strip()
        words: List[Dict[str, Any]] = []
        current: List[int] = []
        word_start = float(token_times[0]) if len(token_times) else 0.0
        for (i, tok), t_sec in zip(keep, token_times):
            piece = self.tokenizer.decode([tok])
            # a word boundary is a whitespace piece or a piece that begins
            # with whitespace (byte-level BPE " hello" tokens)
            boundary = piece == "" or piece.isspace() or piece[:1].isspace()
            if boundary and current:
                words.append({"word": self.tokenizer.decode(current).strip(),
                              "start": round(chunk_offset + word_start, 3),
                              "end": round(chunk_offset + float(t_sec), 3)})
                current = []
                word_start = float(t_sec)
            if piece != "" and not piece.isspace():
                if not current:
                    word_start = float(t_sec)
                current.append(tok)
        if current:
            words.append({"word": self.tokenizer.decode(current).strip(),
                          "start": round(chunk_offset + word_start, 3),
                          "end": round(chunk_offset + chunk_seconds, 3)})
        return chunk_text, [w for w in words if w["word"]], [t for _, t in keep]

    def _mel(self, padded: np.ndarray) -> torch.Tensor:
        """Log-mel [n_mels, frames] of one bucket-padded chunk, by the
        log-mel kernel on the card, in the serving dtype."""
        audio = torch.from_numpy(padded).to(self.device)
        return whisper_log_mel_fused(audio, n_mels=self.cfg.n_mels,
                                     chunk_samples=len(padded)).to(self.dtype)

    def _mel_b(self, audio: np.ndarray, device=None) -> torch.Tensor:
        """Log-mel [N, n_mels, frames] of zero-padded rows [N, samples] on
        ``device`` (default the engine's). The plain ``ops/mel.py`` version,
        as the JAX batched programs take XLA's mel and not the Pallas kernel
        (which takes one waveform)."""
        return whisper_log_mel(torch.from_numpy(audio).to(device or self.device),
                               n_mels=self.cfg.n_mels,
                               chunk_samples=audio.shape[-1]).to(self.dtype)

    def _lang_code(self, token: int) -> str:
        """A detected language token → app code, read in the standard
        50259-based block (a tiny vocabulary places the block elsewhere)."""
        return whisper_token_to_app(token - self.cfg.lang_token_start + 50_259)

    def detect_language(self, audio_16k: np.ndarray) -> str:
        """The spoken language of the first 30 s as an app code (whisper
        ``detect_language``): the chunk padded to its context bucket, the
        log-mel kernel, one decoder pass over the language tokens."""
        x = np.asarray(audio_16k, np.float32).reshape(-1)[: 16_000 * 30]
        padded, _ = self._pad_to_bucket(x)
        ids, _ = wm.detect_language(self.params, self.cfg, self._mel(padded)[None])
        return self._lang_code(int(ids[0]))

    def _decode(self, padded: np.ndarray, prompt_row: List[int], temperature: float):
        """One decode of a bucket-padded chunk → host (tokens, aligns, slp,
        ngen, nsp) of row 0."""
        self._seed += 1
        gumbel = None
        if temperature > 0:
            gumbel = wm.uniform_gumbel(
                torch.Generator(device=self.device).manual_seed(self._seed))
        prompt = torch.tensor([prompt_row], dtype=torch.int32, device=self.device)
        out = wm.decode_with_alignment(
            self.params, self.cfg, self._mel(padded)[None], prompt,
            max_new_tokens=self.max_new_tokens, temperature=temperature, gumbel=gumbel,
            suppress_tokens=self._suppress[0], suppress_first_tokens=self._suppress[1],
            # the prompt row always ends [sot, lang, task, no_timestamps]
            sot_index=len(prompt_row) - 4)
        return [t[0].cpu().numpy() for t in out]

    def _gates_pass(self, text: str, avg_logprob: float) -> bool:
        """whisper.transcribe's compression-ratio and avg-logprob gates."""
        raw = text.encode("utf-8")
        compression_ratio = (len(raw) / len(zlib.compress(raw))) if raw else 0.0
        ok = (compression_ratio <= self.compression_ratio_threshold
              and avg_logprob >= self.logprob_threshold)
        if not ok:
            log.info("temperature fallback: rejected (compression %.2f, avg_logprob %.2f)",
                     compression_ratio, avg_logprob)
        return ok

    def _no_speech(self, no_speech_prob: float, avg_logprob: float, offset_s: float) -> bool:
        """whisper's no-speech gate: a chunk likely silent and decoded with
        low confidence gives no text."""
        if no_speech_prob > self.no_speech_threshold and avg_logprob < self.logprob_threshold:
            log.info("no-speech gate: chunk at %.1fs suppressed (p=%.2f, avg_logprob=%.2f)",
                     offset_s, no_speech_prob, avg_logprob)
            return True
        return False

    def _decode_chunk_fallback(self, padded, prompt_row, offset_s, chunk_s, bucket_s,
                               bare_row=None, temperatures=None):
        """whisper.transcribe's temperature-fallback ladder: decode at each
        temperature until the compression-ratio and avg-logprob gates pass;
        the last rung is accepted as is. Rungs above 0.5 drop the
        previous-text prompt. ``temperatures`` replaces ``self.temperatures``
        (the batch path starts above the greedy rung its dispatch ran)."""
        temperatures = self.temperatures if temperatures is None else temperatures
        for i, temp in enumerate(temperatures):
            row = bare_row if (temp > 0.5 and bare_row is not None) else prompt_row
            tokens, aligns, slp, ngen, nsp = self._decode(padded, row, temp)
            text, words, kept = self._decode_chunk_host(tokens, aligns, len(row), offset_s,
                                                        chunk_s, window_seconds=bucket_s)
            avg_logprob = float(slp) / max(int(ngen), 1)
            if self._no_speech(float(nsp), avg_logprob, offset_s):
                return "", [], [], temp
            if i == len(temperatures) - 1 or self._gates_pass(text, avg_logprob):
                return text, words, kept, temp
        return text, words, kept, temp

    def transcribe_streaming(self, audio_16k: np.ndarray, language: Optional[str] = None):
        """Yield one {"text", "words", "start", "end", "language"} a window of
        the top context bucket, as each decodes. Without a ``language`` it is
        detected first (:meth:`detect_language`). Each window's prompt carries
        the previous windows' tokens (truncated to a bucket) unless a rung
        above 0.5 reset it."""
        x = np.asarray(audio_16k, np.float32).reshape(-1)
        if language is None:
            language = self.detect_language(x)
        base_row = self._prompt_row(language)
        chunk = 16_000 * self.context_buckets[-1]
        prev_ids: List[int] = []
        for start in range(0, max(len(x), 1), chunk):
            seg = x[start:start + chunk]
            padded, bucket_s = self._pad_to_bucket(seg)
            ctx = 0
            if self.condition_on_previous_text and prev_ids:
                ctx = max((b for b in self.PREV_CTX_BUCKETS if b <= len(prev_ids)), default=0)
            if ctx:
                row = [self.cfg.sop_token] + prev_ids[-ctx:] + base_row
                text, seg_words, kept, used_t = self._decode_chunk_fallback(
                    padded, row, start / 16_000.0, len(seg) / 16_000.0, bucket_s,
                    bare_row=base_row)
            else:
                text, seg_words, kept, used_t = self._decode_chunk_fallback(
                    padded, base_row, start / 16_000.0, len(seg) / 16_000.0, bucket_s)
            prev_ids = [] if used_t > 0.5 else prev_ids + kept
            yield {"text": text, "words": seg_words, "start": start / 16_000.0,
                   "end": (start + len(seg)) / 16_000.0, "language": language or "eng"}

    def transcribe(self, audio_16k: np.ndarray, language: Optional[str] = None) -> Dict[str, Any]:
        """→ {"text", "language", "words": [{"word", "start", "end"}]}:
        :meth:`transcribe_streaming`'s windows, aggregated."""
        texts: List[str] = []
        words: List[Dict[str, Any]] = []
        language_out = language or "eng"
        for seg in self.transcribe_streaming(audio_16k, language=language):
            if seg["text"]:
                texts.append(seg["text"])
            words.extend(seg["words"])
            language_out = seg["language"]
        return {"text": " ".join(texts), "language": language_out, "words": words}

    def _gated_chunk(self, tokens, aligns, p_len, offset_s, chunk_s, bucket_s, *,
                     avg_logprob, no_speech_prob, seg, prompt_row) -> tuple:
        """The single path's gates on one batch-decoded row → (text, words):
        the no-speech gate, then the compression/logprob gates; a failing row
        re-runs through the single path's ladder from ``temperatures[1:]``."""
        text, words, _ = self._decode_chunk_host(tokens, aligns, p_len, offset_s, chunk_s,
                                                 window_seconds=bucket_s)
        if self._no_speech(no_speech_prob, avg_logprob, offset_s):
            return "", []
        if len(self.temperatures) <= 1 or self._gates_pass(text, avg_logprob):
            return text, words
        padded, pb = self._pad_to_bucket(np.asarray(seg, np.float32))
        text, words, _, _ = self._decode_chunk_fallback(
            padded, prompt_row, offset_s, chunk_s, pb, temperatures=self.temperatures[1:])
        return text, words

    def transcribe_batch(self, requests: List[Dict[str, Any]]) -> List[Dict[str, Any]]:
        """Batched ASR: ``requests`` [{"audio_16k", "language" (None to
        detect)}] → what :meth:`transcribe` gives each.

        Windows of the top context bucket are flattened across requests (a
        70 s request gives 3 rows), at most 32 rows a dispatch, zero-padded to
        the dispatch's one context bucket (its longest row's), the row count
        to a bucket of (1, 2, 4, 8, 16, 32). Every row decodes greedily from
        the bare 4-token prompt, with the single path's token suppression and
        no-speech probability; :meth:`_gated_chunk` gates each row. Unlike
        :meth:`transcribe`, a request's windows decode independently: no
        previous-text prompts. Rows without a language are detected first,
        in one pass padded to a batch bucket."""
        if not requests:
            return []
        chunk = 16_000 * self.context_buckets[-1]
        langs = [r.get("language") for r in requests]
        need = [i for i, lang in enumerate(langs) if lang is None]
        if need:
            det = np.zeros((bucket_batch(len(need)), 16_000 * 30), np.float32)
            for j, i in enumerate(need):
                seg = np.asarray(requests[i]["audio_16k"], np.float32).reshape(-1)[: 16_000 * 30]
                det[j, : len(seg)] = seg
            with spans.span("asr.detect", rows=len(need), padded=len(det)):
                ids, _ = wm.detect_language(self.params, self.cfg, self._mel_b(det))
                for j, i in enumerate(need):
                    langs[i] = self._lang_code(int(ids[j]))

        specs = []   # (request index, window offset s, window s)
        rows: List[np.ndarray] = []
        prompts: List[List[int]] = []
        for i, r in enumerate(requests):
            x = np.asarray(r["audio_16k"], np.float32).reshape(-1)
            prow = self._prompt_row(langs[i])
            for start in range(0, max(len(x), 1), chunk):
                seg = x[start:start + chunk]
                rows.append(seg)
                prompts.append(prow)
                specs.append((i, start / 16_000.0, len(seg) / 16_000.0))
        longest = max(len(r) for r in rows)
        window_s = next((b for b in self.context_buckets if longest <= 16_000 * b),
                        self.context_buckets[-1])
        results = [{"text": [], "words": []} for _ in requests]
        for lo, hi in row_slices(len(rows), 32):
            nb = bucket_batch(hi - lo, (1, 2, 4, 8, 16, 32))
            audio = np.zeros((nb, 16_000 * window_s), np.float32)
            for j, row in enumerate(rows[lo:hi]):
                audio[j, : len(row)] = row[: 16_000 * window_s]
            prompt = np.tile(np.asarray(prompts[lo], np.int32), (nb, 1))
            prompt[: hi - lo] = np.asarray(prompts[lo:hi], np.int32)
            real = hi - lo

            def decode(grp, lo, hi):
                with spans.span("asr.mel", rows=real, padded=nb):
                    mel = self._mel_b(audio[lo:hi], grp.device)
                out = wm.decode_with_alignment(
                    grp.params, self.cfg, mel, torch.from_numpy(prompt[lo:hi]).to(grp.device),
                    max_new_tokens=self.max_new_tokens, suppress_tokens=self._suppress[0],
                    suppress_first_tokens=self._suppress[1], sot_index=0)
                with spans.span("asr.to_host", rows=hi - lo):
                    return [t.cpu().numpy() for t in out]

            tokens, aligns, slp, ngen, nsp = (
                np.concatenate(parts) for parts in zip(*self._per_group(nb, decode)))
            with spans.span("asr.gate", rows=real):
                for row, (ri, offset, seconds) in enumerate(specs[lo:hi]):
                    text, words = self._gated_chunk(
                        tokens[row], aligns[row], prompt.shape[1], offset, seconds, window_s,
                        avg_logprob=float(slp[row]) / max(int(ngen[row]), 1),
                        no_speech_prob=float(nsp[row]), seg=rows[lo + row],
                        prompt_row=prompts[lo + row])
                    if text:
                        results[ri]["text"].append(text)
                    results[ri]["words"].extend(words)
        return [{"text": " ".join(res["text"]), "language": langs[i] or "eng",
                 "words": res["words"]}
                for i, res in enumerate(results)]


# ========================================================================= NMT


class TorchNllbNmt(_Placed):
    """NMT engine: NLLB generate (greedy, or beam search at ``num_beams`` > 1)
    over bucketed source lengths."""

    def __init__(
        self,
        cfg: Optional[nlm.NLLBConfig] = None,
        params=None,
        tokenizer: Optional[Tokenizer] = None,
        *,
        device=None,
        lang_code_to_id: Optional[Dict[str, int]] = None,
        dtype=torch.bfloat16,
        num_beams: int = 1,
        max_new_tokens: int = 200,
        quantize: bool = False,
        mesh=None,
    ):
        """``quantize``: int8 decoder weights and tied head
        (``nllb.quantize_nllb_decoder``, after the dtype cast). ``mesh``:
        serve from its groups (``nllb_partition_rules``); the engine's
        device is then its first group's lead."""
        self.device = _home(mesh, device)
        self.cfg = cfg or nlm.NLLBConfig(d_model=512, encoder_layers=6, decoder_layers=6,
                                         heads=8, ffn_dim=2048, vocab_size=384)
        self.weightless = params is None
        if params is None:
            log.warning("TorchNllbNmt: random weights (no checkpoint supplied)")
            params = nlm.init_nllb(1, self.cfg, self.device)
        self.params = cast_floats(params, dtype)
        self.quantized = quantize
        if quantize:
            self.params = nlm.quantize_nllb_decoder(self.params)
        self.tokenizer = tokenizer or ByteTokenizer()
        if lang_code_to_id is None and hasattr(self.tokenizer, "token_to_id"):
            # language tokens resolve through the tokenizer's vocab, as the
            # JAX engine resolves FLORES codes
            lang_code_to_id = nllb_lang_ids(self.tokenizer)
        self.lang_code_to_id = lang_code_to_id or {}
        if not self.lang_code_to_id and self.weightless:
            self.lang_code_to_id = nllb_placeholder_lang_ids(self.cfg.vocab_size)
        self.num_beams = num_beams
        self.max_new_tokens = max_new_tokens
        if mesh is not None:
            rules = nlm.nllb_partition_rules(TP_AXIS)
            self._place(mesh, lambda g: {"params": shard_params(self.params, mesh, rules,
                                                                group=g)})

    def _lang_id(self, code: str) -> int:
        for key in (code, NLLB_LANGUAGES.get(code, "")):
            if key in self.lang_code_to_id:
                return self.lang_code_to_id[key]
        raise KeyError(f"language {code!r} has no token id — supply lang_code_to_id or a "
                       "tokenizer whose vocab contains the FLORES language tokens")

    def _src_bucket(self, n: int) -> int:
        """Source width: the smallest text bucket ≥ n (doubling above the
        top), clamped to the encoder's positions."""
        return min(bucket_size(n, TEXT_BUCKETS), self.cfg.max_positions)

    def _encode_src(self, text: str, source_lang: str) -> List[int]:
        """NLLB source layout: ``[src_lang] tokens … [eos]``."""
        ids = self.tokenizer.encode(text)[: self.cfg.max_positions - 2]
        try:
            return [self._lang_id(source_lang)] + ids + [self.cfg.eos_token]
        except KeyError:
            return ids + [self.cfg.eos_token]

    def _generate(self, srcs: List[List[int]], forced_bos: int, rows: int) -> List[str]:
        """Generate (``num_beams``) of source rows padded to their shared
        bucket and to ``rows`` rows → each source's text, pad and EOS
        stripped."""
        padded = np.full((rows, self._src_bucket(max(len(s) for s in srcs))), self.cfg.pad_token,
                         np.int32)
        for row, src in enumerate(srcs):
            padded[row, : len(src)] = _fit_vocab(src, self.cfg.vocab_size, self.weightless, "NMT")

        def generate(grp, lo, hi):
            out = nlm.generate(grp.params, self.cfg, torch.from_numpy(padded[lo:hi]).to(grp.device),
                               forced_bos, num_beams=self.num_beams,
                               max_new_tokens=self.max_new_tokens)
            with spans.span("nmt.to_host", rows=len(srcs), padded=rows):
                return out.cpu().numpy()

        out = np.concatenate(self._per_group(rows, generate))
        return [self.tokenizer.decode([int(t) for t in out[row, 2:]
                                       if t not in (self.cfg.eos_token, self.cfg.pad_token)])
                for row in range(len(srcs))]

    def translate(self, text: str, source_lang: str, target_lang: str) -> str:
        return self._generate([self._encode_src(text, source_lang)], self._lang_id(target_lang),
                              1)[0]

    def translate_batch(self, requests: List[Dict[str, Any]]) -> List[str]:
        """Batched NMT: ``requests`` [{"text", "source_lang", "target_lang"}]
        → each translation. Requests sharing a target language (the forced
        BOS) ride one dispatch of at most 16 rows, padded to a batch
        bucket."""
        if not requests:
            return []
        if len(requests) > 16:
            out: List[str] = []
            for lo, hi in row_slices(len(requests), 16):
                out.extend(self.translate_batch(requests[lo:hi]))
            return out
        results: List[str] = [""] * len(requests)
        by_target: Dict[int, List[int]] = {}
        for i, r in enumerate(requests):
            by_target.setdefault(self._lang_id(r["target_lang"]), []).append(i)
        for forced_bos, idxs in by_target.items():
            srcs = [self._encode_src(requests[i]["text"], requests[i]["source_lang"])
                    for i in idxs]
            for i, text in zip(idxs, self._generate(srcs, forced_bos, bucket_batch(len(idxs)))):
                results[i] = text
        return results


# ========================================================================= TTS


def _reconcile_mtp(cfg_mtp: int, forced: int, params) -> int:
    """The MTP width the parameters can serve: the forced width when set
    (≥ 1; 1 pins single-token decode), else the config's, up to the heads
    the tree carries. ``params=None`` (random weights to be drawn at the
    width) honours the request as it is; a tree without heads decodes
    single-token, and a width other than the tree's takes the tree's, each
    with a warning."""
    wanted = forced if forced >= 1 else cfg_mtp
    if wanted <= 1:
        return 1
    if params is None:
        return wanted
    heads = params.get("lm", {}).get("mtp_heads")
    have = (len(heads) + 1) if heads else 1
    if have == 1:
        log.warning("mtp=%d requested but the params carry no mtp_heads — "
                    "falling back to single-token decode", wanted)
    elif have != wanted:
        log.warning("mtp=%d requested but the checkpoint carries %d MTP head(s) — "
                    "using mtp=%d", wanted, have - 1, have)
    return have


def _reconcile_spec(forced: bool, cfg_spec: bool, width: int) -> bool:
    """Lossless speculative decoding when the caller or the config asks for
    it, and only at an MTP width > 1; asked for at width 1 it is off, with a
    warning."""
    wanted = forced or cfg_spec
    if wanted and width <= 1:
        log.warning("tts_spec requested but the effective MTP width is 1 (no trained "
                    "heads / no tts_mtp) — serving standard single-token decode")
        return False
    return wanted


def _reconciled(cfg, mtp: int, spec: bool, params):
    """``cfg`` (a CosyVoice or official TTS config) with its LM's MTP width and
    speculative decoding reconciled with the request and the tree's heads;
    ``cfg`` itself when nothing changes."""
    want = _reconcile_mtp(cfg.lm.mtp, mtp, params)
    want_spec = _reconcile_spec(spec, cfg.lm.spec_decode, want)
    if (want, want_spec) == (cfg.lm.mtp, cfg.lm.spec_decode):
        return cfg
    return dataclasses.replace(cfg, lm=dataclasses.replace(cfg.lm, mtp=want,
                                                           spec_decode=want_spec))


class _RowNoise:
    """Rows [lo, lo + b) of a dispatch of ``rows`` rows: every draw is the
    whole dispatch's draw, cut to these rows and moved to ``device``, so a
    dp group's share samples as its rows do in one dispatch. A
    :class:`cosyvoice.GeneratorNoise` (each draw a function of its seed and
    index) is redrawn on ``device`` itself, so no draw crosses cards."""

    def __init__(self, base: cvm.NoiseSource, lo: int, rows: int, device):
        if isinstance(base, cvm.GeneratorNoise):
            base = cvm.GeneratorNoise(base.seed, device)
        self.base, self.lo, self.rows, self.device = base, lo, rows, device

    def _whole(self, shape) -> Tuple[int, ...]:
        return (self.rows,) + tuple(shape[1:])

    def _cut(self, t: torch.Tensor, shape) -> torch.Tensor:
        return t[self.lo:self.lo + shape[0]].to(self.device)

    def ras_gumbel(self, step, shape):
        return tuple(self._cut(t, shape) for t in self.base.ras_gumbel(step, self._whole(shape)))

    def mtp_gumbel(self, pass_index, head, shape):
        return tuple(self._cut(t, shape)
                     for t in self.base.mtp_gumbel(pass_index, head, self._whole(shape)))

    def flow_x0(self, shape):
        return self._cut(self.base.flow_x0(self._whole(shape)), shape)

    def chunk(self, index, count):
        return _RowNoise(self.base.chunk(index, count), self.lo, self.rows, self.device)

    def hift_source(self, phase_shape, noise_shape):
        phase, noise = self.base.hift_source(self._whole(phase_shape), self._whole(noise_shape))
        return self._cut(phase, phase_shape), self._cut(noise, noise_shape)

    def flow_x0_prefix(self, bucket, shape):
        return self._cut(self.base.flow_x0_prefix(bucket, self._whole(shape)), shape)


class TorchCosyVoiceTts(_Placed):
    """TTS engine: CosyVoice synthesis (speech-token LM → flow → vocoder)
    with speaker conditioning from the reference audio; the native chain, or
    the official one (``official=``)."""

    sample_rate = 24_000

    def __init__(
        self,
        cfg: Optional[cvm.CosyVoiceConfig] = None,
        params=None,
        tokenizer: Optional[Tokenizer] = None,
        *,
        device=None,
        dtype=torch.bfloat16,
        seconds_per_char: float = 0.08,
        noise: Optional[Callable[[int], cvm.NoiseSource]] = None,
        quantize: bool = False,
        official=None,
        mtp: int = 0,
        spec: bool = False,
        ecapa_weights=None,
        speech_tokenizer_weights=None,
        mesh=None,
    ):
        """``noise(call_index)`` gives each synthesis its noise source
        (default: :class:`cosyvoice.GeneratorNoise` seeded with the call
        index). ``quantize``: int8 weights for the speech LM's decode
        (``cosyvoice.quantize_speech_lm``, after the dtype cast).
        ``official``: ``(params, OfficialTtsConfig)``, a converted
        llm.pt/flow.pt/hift.pt triple (the port's tree); synthesis then runs
        the official chain (``cosyvoice_official``) instead of the native
        flow and vocoder, and ``cfg``/``params`` are not used. ``mtp``:
        the multi-token width (0 defers to the config; 1 pins single-token;
        K > 1 is honoured when the tree has K − 1 heads, or when random
        weights are drawn at that width); ``spec``: lossless speculative
        decoding of B = 1 requests (False defers to the config), off with a
        warning at width 1. Batched requests take accept-all MTP.
        ``ecapa_weights`` / ``speech_tokenizer_weights``: optional
        ``(params, cfg)`` of the conditioning models (the port's f32 trees);
        without them both run on seeded random weights, which carry no
        speaker identity (``conditioning_weightless``). ``mesh``: serve from
        its groups, the speech LM under ``speech_lm_partition_rules`` and the
        rest (flow, vocoder, conditioning) on each group's lead; the
        engine's device is then its first group's lead."""
        self.device = _home(mesh, device)
        self.official = official
        if official is not None:
            params, ocfg = official
            ocfg = self.official_cfg = _reconciled(ocfg, mtp, spec, params)
            # a config view for the shared conditioning and bucketing code
            self.cfg = cvm.CosyVoiceConfig(
                lm=ocfg.lm, flow=cvm.FlowConfig(
                    token_vocab=ocfg.flow.vocab_size + 3, n_mels=ocfg.flow.output_size,
                    spk_embed_dim=ocfg.flow.spk_embed_dim,
                    token_mel_ratio=ocfg.flow.token_mel_ratio))
            self.weightless = False
        else:
            self.cfg = _reconciled(cfg or cvm.CosyVoiceConfig(
                lm=cvm.SpeechLMConfig(
                    backbone=q2.Qwen2Config(hidden=256, layers=4, heads=8, kv_heads=2,
                                            ffn_dim=1024, max_positions=2048),
                    text_vocab=384, speech_token_size=512),
                flow=cvm.FlowConfig(token_vocab=515, dim=256, layers=4, heads=8),
                vocoder=cvm.VocoderConfig(base_channels=256)), mtp, spec, params)
            self.weightless = params is None
            if params is None:
                log.warning("TorchCosyVoiceTts: random weights (no checkpoint supplied)")
                params = cvm.init_cosyvoice(2, self.cfg, self.device)
        self.params = cast_floats(params, dtype)
        self.quantized = quantize
        if quantize:
            self.params = {**self.params, "lm": cvm.quantize_speech_lm(self.params["lm"])}
        self.dtype = dtype
        self.tokenizer = tokenizer or ByteTokenizer()
        self.seconds_per_char = seconds_per_char
        self._noise = noise or (lambda n: cvm.GeneratorNoise(n, self.device))
        # the conditioning models stay f32 in a bf16 engine (as in the JAX
        # package); only their outputs are cast to the serving dtype
        if ecapa_weights is not None:
            self._ecapa, self._ecapa_cfg = ecapa_weights
        else:
            self._ecapa_cfg = ecm.EcapaConfig(channels=128, bottleneck=64, attn_channels=64)
            self._ecapa = ecm.init_ecapa(3, self._ecapa_cfg, self.device)
        if speech_tokenizer_weights is not None:
            self._st, self._st_cfg = speech_tokenizer_weights
        else:
            self._st_cfg = stm.SpeechTokenizerConfig(dim=128, layers=2, heads=4)
            self._st = stm.init_speech_tokenizer(4, self._st_cfg, self.device)
        self.conditioning_weightless = ecapa_weights is None
        if not self.weightless and self.conditioning_weightless:
            log.warning("TorchCosyVoiceTts: main TTS weights are loaded but the ECAPA "
                        "conditioning model is random: cloned voices carry no speaker identity")
        # the voice-prompt window: mel frames == token_mel_ratio * tokens, or
        # the flow's prompt strip mis-slices the generated frames
        ratio = self.cfg.flow.token_mel_ratio
        self._prompt_tokens = 50                 # 2 s of FSQ tokens at 25 Hz
        self._prompt_frames = self._prompt_tokens * ratio
        self._noref_tokens = 2                   # live zero prompt slots without a reference
        self._noref_frames = self._noref_tokens * ratio
        self._call_count = 0
        if mesh is not None:
            rules = cvm.speech_lm_partition_rules(TP_AXIS)
            self._place(mesh, lambda g: {
                "params": {k: shard_params(v, mesh, rules if k == "lm" else None, group=g)
                           for k, v in self.params.items()},
                "_ecapa": shard_params(self._ecapa, mesh, group=g),
                "_st": shard_params(self._st, mesh, group=g)})

    @staticmethod
    def _ref_usable(reference_audio_16k) -> bool:
        """A reference engages voice cloning above 0.1 s (1600 samples)."""
        return (reference_audio_16k is not None
                and np.asarray(reference_audio_16k).reshape(-1).size > 1600)

    def _text_ids(self, text: str, style_prompt: str, reference_audio_16k) -> List[int]:
        """With a cloning reference the prompt transcription precedes the tts
        text (inference_zero_shot layout), capped so the text is never starved."""
        ids = self.tokenizer.encode(text)[:256]
        if style_prompt and self._ref_usable(reference_audio_16k):
            room = 256 - len(ids)
            ids = self.tokenizer.encode(style_prompt)[: min(room, 128)] + ids
        return ids

    def _samples_per_token(self) -> int:
        """Samples a speech token from the vocoder that runs: HiFT's hop in
        the official chain (the config view keeps the native vocoder's
        default, whose hop need not match), the native vocoder's otherwise."""
        hop = self.official_cfg.hift.hop if self.official is not None else self.cfg.vocoder.hop
        return self.cfg.flow.token_mel_ratio * hop

    def _synthesize(self, noise, toks, tmask, psp, psm, spk, pmel, pmm, max_new: int,
                    params=None):
        """One synthesis through the chain the engine serves, with
        ``params`` (default the engine's) → (audio [B, T], token lengths
        [B])."""
        params = self.params if params is None else params
        if self.official is not None:
            out = com.synthesize_official(params, self.official_cfg, noise, toks, tmask,
                                          psp, psm, spk, pmel, max_new_tokens=max_new)
        else:
            out = cvm.synthesize(params, self.cfg, noise, toks, tmask, psp, psm, spk, pmel,
                                 pmm, max_new_tokens=max_new)
        return out["audio"], out["token_lengths"]

    def _cond_b(self, ref16: np.ndarray, has_ref: np.ndarray, grp=None):
        """Voice-prompt conditioning of N 10 s 16 kHz references [N, 160000]
        in one pass, by the conditioning models of placement ``grp``
        (default the engine's own, :attr:`groups`) → (speaker embeddings
        [N, spk_dim] and prompt mels [N, 2 s of frames, n_mels] in the
        serving dtype, prompt speech tokens [N, 50] int32, their mask
        [N, 50]). Rows whose ``has_ref`` is 0 are zeroed and keep
        ``_noref_tokens`` live token slots."""
        grp = grp or self
        dev = grp.device
        x = torch.from_numpy(np.ascontiguousarray(ref16, np.float32)).to(dev)
        spk = ecm.embed_audio(grp._ecapa, self._ecapa_cfg, x)
        ref24 = resample(x, 16_000, 24_000)
        pmel = kaldi_fbank(ref24, sr=24_000)[:, : self._prompt_frames].to(self.dtype)
        st_mel = kaldi_fbank(ref24, sr=24_000, frame_length_ms=40.0, frame_shift_ms=20.0,
                             n_mels=self._st_cfg.n_mels)
        ids, _ = stm.encode(grp._st, self._st_cfg, st_mel,
                            torch.ones(st_mel.shape[:2], dtype=torch.bool, device=dev))
        psp = (ids[:, : self._prompt_tokens] % self.cfg.lm.speech_token_size).to(torch.int32)
        hr32 = torch.from_numpy(np.asarray(has_ref, np.float32)).to(dev)
        # the multiplier in the serving dtype: an f32 one would promote spk and
        # the prompt mel, so these rows would run at another precision
        hr = hr32.to(self.dtype)
        spk = spk.to(self.dtype) * hr[:, None]
        pmel = pmel * hr[:, None, None]
        psp = psp * hr32.to(torch.int32)[:, None]
        psm = (hr[:, None] != 0) | (torch.arange(psp.shape[1], device=dev)[None, :]
                                    < self._noref_tokens)
        return spk, pmel, psp, psm

    def _cond(self, ref16: np.ndarray):
        """Voice-prompt conditioning of one 10 s 16 kHz reference → (speaker
        embedding [1, spk_dim], prompt mel [1, 2 s of frames, n_mels] in the
        serving dtype, prompt speech tokens [1, 50] int32)."""
        spk, pmel, psp, _ = self._cond_b(np.asarray(ref16, np.float32)[None], np.ones(1))
        return spk, pmel, psp

    def _prepare_conditioning(self, text: str, reference_audio_16k, style_prompt: str = ""):
        ids = self._text_ids(text, style_prompt, reference_audio_16k)
        bucket = _bucket_capped(max(len(ids), 1), TEXT_BUCKETS)
        toks = np.zeros((1, bucket), np.int32)
        toks[0, : len(ids)] = _fit_vocab(ids, self.cfg.lm.text_vocab, self.weightless, "text")
        tmask = np.zeros((1, bucket), bool)
        tmask[0, : len(ids)] = True
        dev = self.device
        if self._ref_usable(reference_audio_16k):
            # a fixed 10 s window; a shorter reference is tiled (np.resize)
            ref = np.asarray(reference_audio_16k, np.float32).reshape(-1)[: 16_000 * 10]
            spk, pmel, psp = self._cond(np.resize(ref, 16_000 * 10))
        else:
            spk = torch.zeros((1, self.cfg.flow.spk_embed_dim), dtype=self.dtype, device=dev)
            pmel = torch.zeros((1, self._noref_frames, self.cfg.flow.n_mels), dtype=self.dtype,
                               device=dev)
            psp = torch.zeros((1, self._noref_tokens), dtype=torch.int32, device=dev)
        pmm = torch.ones(pmel.shape[:2], dtype=torch.bool, device=dev)
        seconds = float(np.clip(len(text) * self.seconds_per_char, 0.6, 30.0))
        max_new = _bucket_capped(int(seconds * 25), TTS_BUDGET_BUCKETS)
        return (torch.from_numpy(toks).to(dev), torch.from_numpy(tmask).to(dev),
                spk, pmel, pmm, psp, max_new)

    def synthesize(self, text: str, *, style_prompt: str = "",
                   reference_audio_16k: Optional[np.ndarray] = None,
                   language: str = "en") -> np.ndarray:
        """→ float32 waveform at 24 kHz, trimmed to the EOS-determined length."""
        toks, tmask, spk, pmel, pmm, psp, max_new = self._prepare_conditioning(
            text, reference_audio_16k, style_prompt)
        self._call_count += 1
        audio, lengths = self._synthesize(self._noise(self._call_count), toks, tmask, psp,
                                          torch.ones_like(psp, dtype=torch.bool), spk, pmel, pmm,
                                          max_new)
        n = max(int(lengths[0]), 1) * self._samples_per_token()
        return audio[0, :n].float().cpu().numpy()

    def synthesize_streaming(self, text: str, *, style_prompt: str = "",
                             reference_audio_16k: Optional[np.ndarray] = None,
                             language: str = "en"):
        """Yield float32 waveform chunks at 24 kHz as each is made
        (:func:`cosyvoice.synthesize_streaming`): the conditioning of
        :meth:`synthesize`, and the call's noise source, chunk by chunk."""
        toks, tmask, spk, pmel, pmm, psp, max_new = self._prepare_conditioning(
            text, reference_audio_16k, style_prompt)
        self._call_count += 1
        noise, psm = self._noise(self._call_count), torch.ones_like(psp, dtype=torch.bool)
        if self.official is not None:
            yield from com.synthesize_streaming_official(
                self.params, self.official_cfg, noise, toks, tmask, psp, psm, spk, pmel,
                max_new_tokens=max_new)
            return
        yield from cvm.synthesize_streaming(self.params, self.cfg, noise, toks, tmask, psp, psm,
                                            spk, pmel, pmm, max_new_tokens=max_new)

    def synthesize_batch(self, requests: List[Dict[str, Any]]) -> List[np.ndarray]:
        """Batched synthesis: ``requests`` [{"text", "reference_audio_16k"
        (or None), "style_prompt", "language"}] → each float32 waveform at
        24 kHz, trimmed to its EOS-determined length.

        At most 16 rows a dispatch, padded to a batch bucket; the text to the
        longest row's text bucket; the decode budget to the longest text's.
        One conditioning pass for the batch (:meth:`_cond_b`): rows with a
        reference attend over the whole prompt mel, rows without over
        ``_noref_frames`` frames, as :meth:`synthesize` conditions them. One
        noise source a dispatch (``noise(call_index)``). The native vocoder's
        narrow stages run the resblock kernel on the whole batch; the official
        chain compacts each row's prompt and masks HiFT to each row's frames.
        Under a mesh whose owned dp groups divide the padded rows, each
        group conditions and synthesizes its share with its placement
        (:attr:`groups`), the dispatch's noise cut to its rows
        (:class:`_RowNoise`)."""
        if not requests:
            return []
        n = len(requests)
        if n > 16:
            outs: List[np.ndarray] = []
            for lo, hi in row_slices(n, 16):
                outs.extend(self.synthesize_batch(requests[lo:hi]))
            return outs
        nb = bucket_batch(n)
        enc = [self._text_ids(r["text"], r.get("style_prompt", ""), r.get("reference_audio_16k"))
               for r in requests]
        width = _bucket_capped(max(max(len(e) for e in enc), 1), TEXT_BUCKETS)
        toks = np.zeros((nb, width), np.int32)
        tmask = np.zeros((nb, width), bool)
        for i, e in enumerate(enc):
            toks[i, : len(e)] = _fit_vocab(e, self.cfg.lm.text_vocab, self.weightless, "text")
            tmask[i, : len(e)] = True
        refs = np.zeros((nb, 16_000 * 10), np.float32)
        has_ref = np.zeros((nb,), np.float32)
        for i, r in enumerate(requests):
            ra = r.get("reference_audio_16k")
            if self._ref_usable(ra):
                refs[i] = np.resize(np.asarray(ra, np.float32).reshape(-1)[: 16_000 * 10],
                                    16_000 * 10)
                has_ref[i] = 1.0
        seconds = max(float(np.clip(len(r["text"]) * self.seconds_per_char, 0.6, 30.0))
                      for r in requests)
        max_new = _bucket_capped(int(seconds * 25), TTS_BUDGET_BUCKETS)
        self._call_count += 1
        noise = self._noise(self._call_count)

        def synth(grp, lo, hi):
            dev = grp.device
            with spans.span("tts.cond", rows=n, padded=nb):
                spk, pmel, psp, psm = self._cond_b(refs[lo:hi], has_ref[lo:hi], grp)
            frames = torch.arange(pmel.shape[1], device=dev)[None, :]
            pmm = torch.from_numpy(has_ref[lo:hi] > 0).to(dev)[:, None] | (
                frames < self._noref_frames)
            rows = noise if hi - lo == nb else _RowNoise(noise, lo, nb, dev)
            audio, lengths = self._synthesize(
                rows, torch.from_numpy(toks[lo:hi]).to(dev), torch.from_numpy(tmask[lo:hi]).to(dev),
                psp, psm, spk, pmel, pmm, max_new, params=grp.params)
            with spans.span("tts.to_host", rows=hi - lo):
                return audio.float().cpu().numpy(), lengths.cpu().numpy()

        audio, lengths = (np.concatenate(parts) for parts in zip(*self._per_group(nb, synth)))
        spt = self._samples_per_token()
        return [audio[i, : max(int(lengths[i]), 1) * spt] for i in range(n)]


# ===================================================================== wiring


def reference_scale_configs() -> Dict[str, Any]:
    """The reference deployment's model scales: Whisper-medium ASR,
    NLLB-200-distilled-600M NMT, CosyVoice2-0.5B TTS."""
    return {"asr_cfg": wm.WhisperConfig.medium(),
            "nmt_cfg": nlm.NLLBConfig.distilled_600m(),
            "tts_cfg": cvm.CosyVoiceConfig()}


# The keys of the JAX factory that ``torch_engines`` passes on from
# ``**kwargs``; any other key raises TypeError.
_PASSED_KEYS = frozenset((
    "asr_cfg", "asr_params", "asr_context_buckets", "asr_tokenizer", "nmt_cfg", "nmt_params",
    "nmt_tokenizer", "lang_code_to_id", "tts_cfg", "tts_params", "tts_tokenizer", "tts_noise",
    "tts_mtp", "tts_spec", "tts_ecapa", "tts_speech_tokenizer", "tts_official", "tokenizer",
    "dtype", "mesh", "stage_meshes"))


# The dp cap of ``stage_parallel`` placement: a stage's dp groups run in
# threads of one process, and two TTS groups served slower than one card
# (PERF.md §6), so each stage gets one group and spare cards stay idle.
STAGE_MAX_DP = 1


def _stage_meshes(stage_parallel: bool, stage_tp: int, per_stage) -> Optional[Dict[str, Any]]:
    """The per-stage meshes the factory serves from: explicit
    ``stage_meshes``, else with ``stage_parallel`` one disjoint group of
    the host's cards a stage (``parallel.stages.stage_meshes(tp=stage_tp,
    max_dp=STAGE_MAX_DP)``), else none. ``stage_tp`` without
    ``stage_parallel`` (or beside explicit meshes) is ignored with a
    warning, as in the JAX factory."""
    if stage_tp > 1 and (not stage_parallel or per_stage is not None):
        log.warning(
            "stage_tp=%d ignored: %s — set stage_parallel=True "
            "(EST_ENGINES__STAGE_PARALLEL=1) and drop explicit stage_meshes "
            "for per-stage tensor parallelism", stage_tp,
            "explicit stage_meshes given" if per_stage is not None
            else "stage_parallel is off")
    if stage_parallel and per_stage is None:
        from ..parallel.stages import placement_report, stage_meshes

        per_stage = stage_meshes(tp=stage_tp, max_dp=STAGE_MAX_DP)
        log.info("stage-parallel placement: %s", placement_report(per_stage))
    return per_stage


def _load_baked(kwargs: Dict[str, Any], dev) -> None:
    """Fill the factory's keys from ``EST_MODELS_DIR``'s stage directories,
    as ``jax_engines`` reads its bake: ``asr/`` and ``nmt/`` give weights and
    config, ``tts_llm/`` + ``tts_flow/`` + ``tts_hift/`` the official chain
    (only all three, and only without ``tts_params``), ``ecapa/`` and
    ``speech_tokenizer/`` the voice-prompt conditioning. An explicit key
    wins; a directory without ``config.json`` is skipped, so a missing or
    empty directory serves random weights. A stage directory holding the
    JAX package's orbax bake raises (``load_converted``)."""
    models_dir = os.environ.get("EST_MODELS_DIR")
    if not models_dir:
        return
    from ..models.loaders import load_converted, load_official_tts

    root = Path(models_dir)

    def baked(stage: str) -> bool:
        return (root / stage / "config.json").exists()

    if baked("asr") and "asr_params" not in kwargs:
        kwargs["asr_params"], kwargs["asr_cfg"] = load_converted(root / "asr", wm.WhisperConfig,
                                                                 dev)
        log.info("loaded baked ASR weights from %s", root / "asr")
    if baked("nmt") and "nmt_params" not in kwargs:
        kwargs["nmt_params"], kwargs["nmt_cfg"] = load_converted(root / "nmt", nlm.NLLBConfig,
                                                                 dev)
        log.info("loaded baked NMT weights from %s", root / "nmt")
    if ("tts_official" not in kwargs and "tts_params" not in kwargs
            and all(baked(s) for s in ("tts_llm", "tts_flow", "tts_hift"))):
        kwargs["tts_official"] = load_official_tts(root, dev)
        log.info("loaded baked official CosyVoice triple from %s", root)
    if baked("ecapa") and "tts_ecapa" not in kwargs:
        kwargs["tts_ecapa"] = load_converted(root / "ecapa", ecm.EcapaConfig, dev)
        log.info("loaded baked ECAPA conditioning from %s", root / "ecapa")
    if baked("speech_tokenizer") and "tts_speech_tokenizer" not in kwargs:
        kwargs["tts_speech_tokenizer"] = load_converted(root / "speech_tokenizer",
                                                        stm.SpeechTokenizerConfig, dev)
        log.info("loaded baked FSQ speech tokenizer from %s", root / "speech_tokenizer")


def torch_engines(*, scale: str = "toy", device=None, batch_tts: bool = False,
                  batch_asr: bool = False, batch_nmt: bool = False, max_batch: int = 8,
                  batch_wait_ms: float = 20.0, quantize: bool = False,
                  stage_parallel: bool = False, stage_tp: int = 1, **kwargs) -> Engines:
    """Engines wired to the port's models (random weights unless supplied),
    on the card unless ``device="cpu"``.

    ``scale="reference"`` serves Whisper-medium / NLLB-600M / CosyVoice-0.5B
    dims; ``"toy"`` the small structure-test dims. ``batch_tts/asr/nmt=True``
    put a micro-batcher (``serve/batching.py``, up to ``max_batch`` requests
    gathered for up to ``batch_wait_ms``) in front of the stage, so
    concurrent requests share its batched dispatches, as in the JAX factory.
    ``quantize=True`` gives every engine int8 decode weights.
    ``asr_cfg``/``asr_params``/``asr_context_buckets`` (default ``(30,)``),
    ``nmt_cfg``/``nmt_params``/``lang_code_to_id``, ``tts_cfg``/
    ``tts_params``/``tts_noise``/``tts_ecapa``/``tts_speech_tokenizer``
    (each ``(params, cfg)``), ``tts_official`` (``(params,
    OfficialTtsConfig)``: the TTS engine serves the official CosyVoice2
    chain), ``tts_mtp``/``tts_spec`` (the TTS engine's ``mtp``/``spec``) and
    ``dtype`` pass through to the engines; ``asr_tokenizer``/
    ``nmt_tokenizer``/``tts_tokenizer`` override the shared ``tokenizer``.
    ``mesh`` serves every stage from one (dp, tp) mesh
    (``parallel/mesh.py``); ``stage_parallel=True`` gives each stage a
    disjoint group of the host's cards with ``stage_tp``-way tensor
    parallelism inside it (``parallel/stages.py``); an explicit
    ``stage_meshes={"asr": Mesh, ...}`` overrides both per stage. A stage
    on a mesh makes its tensors on its group's lead, whatever ``device``
    says. A set ``EST_MODELS_DIR`` serves the port's bake over the scale's
    configs (:func:`_load_baked`)."""
    for key in kwargs:
        if key not in _PASSED_KEYS:
            raise TypeError(f"torch_engines() got an unexpected keyword argument {key!r}")
    per_stage = _stage_meshes(stage_parallel, stage_tp, kwargs.get("stage_meshes"))

    def mesh(stage: str):
        if per_stage is not None and stage in per_stage:
            return per_stage[stage]
        return kwargs.get("mesh")

    dev = resolve_device(device)
    if scale == "reference":
        for k, v in reference_scale_configs().items():
            kwargs.setdefault(k, v)
    elif scale != "toy":
        raise ValueError(f"unknown scale {scale!r} (toy|reference)")
    _load_baked(kwargs, dev)
    dtype = kwargs.get("dtype", torch.bfloat16)
    tok = kwargs.get("tokenizer")
    asr: Any = TorchWhisperAsr(kwargs.get("asr_cfg"), kwargs.get("asr_params"),
                               kwargs.get("asr_tokenizer", tok), device=dev, dtype=dtype,
                               quantize=quantize,
                               context_buckets=kwargs.get("asr_context_buckets", (30,)),
                               mesh=mesh("asr"))
    nmt: Any = TorchNllbNmt(kwargs.get("nmt_cfg"), kwargs.get("nmt_params"),
                            kwargs.get("nmt_tokenizer", tok), device=dev,
                            lang_code_to_id=kwargs.get("lang_code_to_id"), dtype=dtype,
                            quantize=quantize, mesh=mesh("nmt"))
    tts: Any = TorchCosyVoiceTts(kwargs.get("tts_cfg"), kwargs.get("tts_params"),
                                 kwargs.get("tts_tokenizer", tok), device=dev,
                                 dtype=dtype, noise=kwargs.get("tts_noise"), quantize=quantize,
                                 official=kwargs.get("tts_official"),
                                 mtp=kwargs.get("tts_mtp", 0),
                                 spec=kwargs.get("tts_spec", False),
                                 ecapa_weights=kwargs.get("tts_ecapa"),
                                 speech_tokenizer_weights=kwargs.get("tts_speech_tokenizer"),
                                 mesh=mesh("tts"))
    batching = dict(max_batch=max_batch, max_wait_ms=batch_wait_ms)
    if batch_tts:
        tts = BatchedTts(tts, **batching)
    if batch_asr:
        asr = BatchedAsr(asr, **batching)
    if batch_nmt:
        nmt = BatchedNmt(nmt, **batching)
    return Engines(asr=asr, nmt=nmt, tts=tts)
