"""The comparison that decides ``correct``.

Once the window has closed and the program is freed, the plain reference
(``reference/``, float32, TF32 off, its weights drawn again from the
configuration's seeds with the configuration's edits) reads what the timed
path produced:

- ``tokens_off``: rows of every dispatch of the window whose decoded token
  count differs from the traffic's pins (exact: limit 0);
- ``asr_logit_err`` / ``nmt_logit_err`` / ``lm_logit_err``: for the rows the
  recorder picked from the seed (:data:`ROWS` rows, one from each of as many
  equal blocks of the batch, of the window's first dispatch of each stage
  and of one more of its first :data:`FROM_DISPATCHES`), the relative L2 error of
  the logits the decode loop computed at every step against the reference's,
  teacher-forced on the row's prompt and served tokens (largest over the
  rows). ASR rows are the window's audio through the log-mel, encoder and
  decoder; NMT rows the ASR's text; TTS rows the NMT's text after the ASR's,
  the voice prompt worked out again from the request's audio;
- ``audio_err``: for the same TTS rows, the relative L2 error of the served
  waveform against the reference's flow and vocoder over the served tokens
  and the same seeded draws (largest over the rows).

Beside each (``control=True``) the control: the same number for the
reference computed in fp8 (:class:`Fp8Compute`) in the program's place, at
the same prompts and tokens, under ``<name>.control``; :func:`control_numbers`
puts those in the numbers' place, so the control is judged by the same
limits (and has to come out not correct). The widest gap of a served token's logit below
the reference's best is printed for each decoder too (``*_gap``), not
compared: the control does not separate it from sound runs (PERF.md)."""

from __future__ import annotations

import contextlib
import sys
import time
from typing import Any, Dict, List, Tuple

import numpy as np
import torch
from torch.overrides import TorchFunctionMode

from .noise import RowNoise
from .record import Dispatch
from .spec import build_config

NEG = -1e9
FP8_MAX = 448.0
FROM_DISPATCHES = 8     # a stage's second sampled dispatch is drawn from the window's first 8
ROWS = 4                # rows a sampled dispatch keeps: one from each quarter of its batch
CONTROLLED = ("asr_logit_err", "nmt_logit_err", "lm_logit_err", "audio_err")


def control_numbers(numbers: Dict[str, float]) -> Dict[str, float]:
    """The numbers with the control's readings in the program's place."""
    return {**numbers, **{k: numbers[f"{k}.control"] for k in CONTROLLED
                          if f"{k}.control" in numbers}}


def _fp8(t: torch.Tensor) -> torch.Tensor:
    """``t`` rounded through float8 e4m3 at one scale (largest |t| → 448)."""
    scale = torch.clamp(t.detach().abs().max(), min=1e-30) / FP8_MAX
    return (t / scale).to(torch.float8_e4m3fn).to(t.dtype) * scale


class Fp8Compute(TorchFunctionMode):
    """Every product (matmul, einsum, linear, conv) takes its operands of two
    or more dims rounded through fp8 e4m3, one scale a tensor, as an fp8
    GEMM does; sums, norms and softmax stay float32. Inside it the
    reference computes in fp8: the control."""

    PRODUCTS = frozenset(("matmul", "__matmul__", "mm", "bmm", "addmm", "baddbmm", "einsum",
                          "linear", "conv1d", "conv_transpose1d"))

    def __torch_function__(self, func, types, args=(), kwargs=None):
        kwargs = kwargs or {}
        if getattr(func, "__name__", None) in self.PRODUCTS:
            args = tuple(_fp8(a) if torch.is_tensor(a) and a.is_floating_point() and a.ndim >= 2
                         else a for a in args)
        return func(*args, **kwargs)


def _gap(ref_logits: torch.Tensor, chosen: torch.Tensor) -> float:
    """max over positions of (the reference's best − its logit of the chosen
    token); logits [N, V], chosen [N]."""
    best = ref_logits.max(dim=-1).values
    picked = ref_logits.gather(-1, chosen[:, None].long())[:, 0]
    return float((best - picked).max())


def _rel_err(got: torch.Tensor, want: torch.Tensor) -> float:
    """The largest relative L2 error of a row of ``got`` against ``want``
    (rows along dim 0)."""
    diff = torch.linalg.vector_norm((got - want).flatten(1), dim=1)
    return float((diff / torch.linalg.vector_norm(want.flatten(1), dim=1)).max())


def _picked(dispatches: List[Dispatch], stage: str) -> List[Tuple[Dispatch, int, int]]:
    """(dispatch, row, its place in the kept block) of every row whose
    logits the recorder kept."""
    return [(d, j, i) for d in dispatches if d.stage == stage and d.rows is not None and d.logits
            for i, j in enumerate(d.rows)]


def _served_logits(d: Dispatch, i: int) -> torch.Tensor:
    """The kept logits of block row ``i`` at every step [steps, V], float32."""
    return torch.stack([step[i] for step in d.logits]).float()


class _Flops:
    """FLOPs of the reference's computation of one row (``FlopCounterMode``),
    the model work a served row needs."""

    def __init__(self):
        self.per_row: Dict[str, float] = {}

    @contextlib.contextmanager
    def count(self, stage: str, rows: int):
        """Count what runs inside over ``rows`` rows, once a stage."""
        if stage in self.per_row:
            yield
            return
        from torch.utils.flop_counter import FlopCounterMode

        mode = FlopCounterMode(display=False)
        with mode:
            yield
        self.per_row[stage] = mode.get_total_flops() / rows


def token_counts(dispatches: List[Dispatch], pins: Dict[str, int], pad_nmt: int) -> Dict[str, Any]:
    """Decoded tokens of every real row of every dispatch against the pins."""
    want = {"asr": pins["asr_max_new_tokens"], "nmt": pins["nmt_max_new_tokens"],
            "tts": pins["tts_decoded_tokens"]}
    off, seen = 0, {"asr": [], "nmt": [], "tts": []}
    for d in dispatches:
        n = len(d.items)
        got: List[int] = []
        for out in d.outputs:
            if d.stage == "asr":
                got += out["generated"].cpu().tolist()
            elif d.stage == "nmt":
                got += (out["tokens"][:, 1:] != pad_nmt).sum(dim=1).cpu().tolist()
            else:
                got += out["lengths"].cpu().tolist()
        got = got[:n]
        if len(got) != n:
            off += n - len(got)
        off += sum(1 for g in got if g != want[d.stage])
        seen[d.stage] += got
    return {"tokens_off": off, "counts": {k: sorted(set(v)) for k, v in seen.items()}}


class Judge:
    """The reference's readings of one run's dispatches (:meth:`run`)."""

    def __init__(self, config: Dict[str, Any], traffic: Dict[str, Any], seed: int, device,
                 control: bool = False):
        from ..reference import cosyvoice as rcv
        from ..reference import cosyvoice_official as rco
        from ..reference import ecapa as rec
        from ..reference import nllb as rnl
        from ..reference import speech_tokenizer as rst
        from ..reference import whisper as rwh

        self.config, self.traffic, self.seed = config, traffic, seed
        self.device = torch.device(device)
        self.control = control
        self.flops = _Flops()
        tts_cls = rco.OfficialTtsConfig if config["tts"]["chain"] == "official" else rcv.CosyVoiceConfig
        self.cfg = {"asr": build_config(rwh.WhisperConfig, config["asr"]),
                    "nmt": build_config(rnl.NLLBConfig, config["nmt"]),
                    "tts": build_config(tts_cls, config["tts"]["config"]),
                    "ecapa": build_config(rec.EcapaConfig, config["ecapa"]),
                    "speech_tokenizer": build_config(rst.SpeechTokenizerConfig,
                                                     config["speech_tokenizer"])}
        if self.device.type == "cuda":
            torch.backends.cuda.matmul.allow_tf32 = False
            torch.backends.cudnn.allow_tf32 = False

    # -------------------------------------------------------------- weights

    def _letters(self, table: torch.Tensor) -> None:
        lo, hi = self.config["edits"]["letters"]["rows"]
        table[lo:hi] *= self.config["edits"]["letters"]["scale"]

    def _asr_params(self):
        from ..reference import whisper as rwh
        p = rwh.init_whisper(self.config["seeds"]["asr"], self.cfg["asr"], self.device)
        self._letters(p["decoder"]["embed"])
        return p

    def _nmt_params(self):
        from ..reference import nllb as rnl
        p = rnl.init_nllb(self.config["seeds"]["nmt"], self.cfg["nmt"], self.device)
        self._letters(p["embed"])
        return p

    def _tts_params(self):
        from ..reference import cosyvoice as rcv
        from ..reference import cosyvoice_official as rco
        seed, cfg = self.config["seeds"]["tts"], self.cfg["tts"]
        if self.config["tts"]["chain"] == "official":
            p = rco.init_official_tts(seed, cfg, self.device)
        else:
            p = rcv.init_cosyvoice(seed, cfg, self.device)
        p["lm"]["head"]["bias"][cfg.lm.eos_speech] -= self.config["edits"]["speech_eos_logit_offset"]
        return p

    # ------------------------------------------------------------------ ASR

    def _asr_logits(self, params, mel: torch.Tensor, tokens: torch.Tensor) -> torch.Tensor:
        """Teacher-forced decoder logits at every step [k, total, V], as the
        decode loop computes them."""
        from ..reference import whisper as rwh
        cfg = self.cfg["asr"]
        enc = rwh.encode(params, cfg, mel)
        cross = rwh.precompute_cross_kv(params, cfg, enc)
        total = tokens.shape[1]
        cache = rwh.init_kv_cache(cfg, tokens.shape[0], enc.dtype, enc.device, total)
        steps = [rwh.decode_step_with_attn(params, cfg, tokens[:, pos], pos, cache, cross)[0]
                 for pos in range(total)]
        return torch.stack(steps, dim=1).float()

    def asr(self, dispatches: List[Dispatch]) -> Dict[str, float]:
        from ..reference import mel as rmel
        rows = _picked(dispatches, "asr")
        if not rows:
            return {}
        p_len, window = 4, 16_000 * 30
        audio = np.zeros((len(rows), window), np.float32)
        for r, (d, j, _) in enumerate(rows):
            x = np.asarray(d.items[j]["audio_16k"], np.float32).reshape(-1)[:window]
            audio[r, : len(x)] = x
        tokens = torch.stack([d.outputs[0]["tokens"][j] for d, j, _ in rows]).to(self.device)
        served = torch.stack([_served_logits(d, i) for d, _, i in rows]).to(self.device)
        params = self._asr_params()
        with self.flops.count("asr", len(rows)):
            mel = rmel.whisper_log_mel(torch.from_numpy(audio).to(self.device),
                                       n_mels=self.cfg["asr"].n_mels, chunk_samples=window)
            ref = self._asr_logits(params, mel, tokens)
        # the generated tokens' logits, with the decode's first-step masks (blank, end)
        gen = ref[:, p_len - 1:-1].clone()
        gen[:, 0, [36, self.cfg["asr"].eos_token]] = NEG
        v = ref.shape[-1]
        out = {"asr_logit_err": _rel_err(served, ref),
               "asr_gap": _gap(gen.reshape(-1, v), tokens[:, p_len:].reshape(-1))}
        if self.control:
            with Fp8Compute():
                low = self._asr_logits(params, mel, tokens)
            out["asr_logit_err.control"] = _rel_err(low, ref)
        return out

    # ------------------------------------------------------------------ NMT

    def _nmt_logits(self, params, src: torch.Tensor, tokens: torch.Tensor) -> torch.Tensor:
        """Teacher-forced decoder logits at every step [k, total − 1, V]."""
        from ..reference import common as rcm
        from ..reference import nllb as rnl
        cfg = self.cfg["nmt"]
        enc = rnl.encode(params, cfg, src)
        pad_mask = (src != cfg.pad_token)[:, None, None, :]
        cross = rcm.precompute_layer_cross_kv(params["decoder"]["layers"], cfg.attn, enc)
        total = tokens.shape[1]
        cache = rcm.init_decoder_kv_cache(cfg.decoder_layers, tokens.shape[0], total, cfg.heads,
                                          cfg.d_model // cfg.heads, enc.dtype, enc.device)
        steps = [rnl.decode_step(params, cfg, tokens[:, pos], pos, cache, cross, pad_mask)
                 for pos in range(total - 1)]
        return torch.stack(steps, dim=1).float()

    def nmt(self, dispatches: List[Dispatch]) -> Dict[str, float]:
        from ..reference.languages import NLLB_LANGUAGES, nllb_placeholder_lang_ids
        from ..reference.text import ByteTokenizer
        rows = _picked(dispatches, "nmt")
        if not rows:
            return {}
        cfg, tok = self.cfg["nmt"], ByteTokenizer()
        lang = nllb_placeholder_lang_ids(cfg.vocab_size)
        srcs = []
        for d, j, _ in rows:
            item = d.items[j]
            head = lang.get(item["source_lang"],
                            lang.get(NLLB_LANGUAGES.get(item["source_lang"], "")))
            ids = tok.encode(item["text"])[: cfg.max_positions - 2]
            srcs.append(([head] if head is not None else []) + ids + [cfg.eos_token])
        src = torch.full((len(srcs), max(len(x) for x in srcs)), cfg.pad_token, dtype=torch.int64)
        for r, x in enumerate(srcs):
            src[r, : len(x)] = torch.tensor(x) % cfg.vocab_size
        src = src.to(self.device)
        tokens = torch.stack([d.outputs[0]["tokens"][j] for d, j, _ in rows]).to(self.device)
        served = torch.stack([_served_logits(d, i) for d, _, i in rows]).to(self.device)
        params = self._nmt_params()
        with self.flops.count("nmt", len(rows)):
            ref = self._nmt_logits(params, src, tokens)
        v = ref.shape[-1]
        out = {"nmt_logit_err": _rel_err(served, ref),
               "nmt_gap": _gap(ref[:, 1:].reshape(-1, v), tokens[:, 2:].reshape(-1))}
        if self.control:
            with Fp8Compute():
                low = self._nmt_logits(params, src, tokens)
            out["nmt_logit_err.control"] = _rel_err(low, ref)
        return out

    # ------------------------------------------------------------------ TTS

    def _conditioning(self, ref16: np.ndarray):
        """The voice prompt of a 10 s 16 kHz reference, worked out again:
        (speaker embedding [1, spk], prompt mel [1, 2 s of frames, n_mels],
        prompt speech tokens [1, 50])."""
        from ..reference import ecapa as rec
        from ..reference import speech_tokenizer as rst
        from ..reference.mel import kaldi_fbank
        from ..reference.resample import resample
        seeds, dev = self.config["seeds"], self.device
        ecfg, scfg = self.cfg["ecapa"], self.cfg["speech_tokenizer"]
        x = torch.from_numpy(np.ascontiguousarray(ref16, np.float32))[None].to(dev)
        spk = rec.embed_audio(rec.init_ecapa(seeds["ecapa"], ecfg, dev), ecfg, x)
        ref24 = resample(x, 16_000, 24_000)
        ratio = self.cfg["tts"].flow.token_mel_ratio
        pmel = kaldi_fbank(ref24, sr=24_000)[:, : 50 * ratio]
        st_mel = kaldi_fbank(ref24, sr=24_000, frame_length_ms=40.0, frame_shift_ms=20.0,
                             n_mels=scfg.n_mels)
        ids, _ = rst.encode(rst.init_speech_tokenizer(seeds["speech_tokenizer"], scfg, dev), scfg,
                            st_mel, torch.ones(st_mel.shape[:2], dtype=torch.bool, device=dev))
        psp = ids[:, :50] % self.cfg["tts"].lm.speech_token_size
        return spk, pmel, psp

    def _lm_logits(self, lm, text: torch.Tensor, psp: torch.Tensor,
                   served: torch.Tensor) -> torch.Tensor:
        """Teacher-forced head logits [n, V] of the served speech tokens."""
        from ..reference import cosyvoice as rcv
        from ..reference import qwen2 as rq
        from ..reference.common import dense
        cfg = self.cfg["tts"].lm
        ones = torch.ones_like(text, dtype=torch.bool)
        emb, _ = rcv.build_prompt_embeddings(lm, cfg, text, ones, psp,
                                             torch.ones_like(psp, dtype=torch.bool))
        x = torch.cat([emb, lm["speech_embed"][served[None, :-1].long()]], dim=1)
        h = rq.forward(lm["backbone"], cfg.backbone, x)
        return dense(lm["head"], h[0, emb.shape[1] - 1:]).float()

    def _masked(self, logits: torch.Tensor) -> torch.Tensor:
        """The sampler's masks: sos and task always, end before the second
        token."""
        cfg = self.cfg["tts"].lm
        out = logits.clone()
        out[:, [cfg.sos_index, cfg.task_index]] = NEG
        out[:2, cfg.eos_speech] = NEG
        return out

    def _audio(self, params, tokens, spk, pmel, psp, noise):
        """The reference's waveform [T] of the served tokens."""
        from ..reference import cosyvoice as rcv
        from ..reference import flow_matcha as rfm
        from ..reference import hift as rhf
        cfg = self.cfg["tts"]
        mask = torch.ones_like(tokens, dtype=torch.bool)
        pmask = torch.ones_like(psp, dtype=torch.bool)
        if self.config["tts"]["chain"] == "official":
            mel, fmask = rfm.flow_inference(params["flow"], cfg.flow, noise.flow_x0, tokens, mask,
                                            psp, pmask, pmel, spk)
            return rhf.hift_inference(params["hift"], cfg.hift, noise, mel, frame_mask=fmask)[0]
        pmm = torch.ones(pmel.shape[:2], dtype=torch.bool, device=pmel.device)
        mel, _ = rcv.tokens_to_mel(params["flow"], cfg.flow, noise, tokens, mask, spk, pmel, pmm,
                                   prompt_tokens=psp, prompt_token_mask=pmask)
        return rcv.vocode(params["vocoder"], cfg.vocoder, mel[:, pmel.shape[1]:])[0]

    def tts(self, dispatches: List[Dispatch]) -> Dict[str, float]:
        from ..reference.text import ByteTokenizer
        rows = _picked(dispatches, "tts")
        if not rows:
            return {}
        tok, lm_cfg = ByteTokenizer(), self.cfg["tts"].lm
        params = self._tts_params()
        out: Dict[str, List[float]] = {}

        def keep(name: str, value: float) -> None:
            out.setdefault(name, []).append(value)

        for d, j, i in rows:
            item = d.items[j]
            ref_audio = item.get("reference_audio_16k")
            if ref_audio is None or np.asarray(ref_audio).size <= 1600:
                raise ValueError("the benchmark's TTS rows clone the speaker's voice")
            with self.flops.count("tts", 1):
                ids = tok.encode(item["text"])[:256]
                if item.get("style_prompt"):
                    ids = tok.encode(item["style_prompt"])[: min(256 - len(ids), 128)] + ids
                ref16 = np.resize(np.asarray(ref_audio, np.float32).reshape(-1)[:160_000], 160_000)
                spk, pmel, psp = self._conditioning(ref16)
                text = (torch.tensor([ids]) % lm_cfg.text_vocab).to(self.device)
                n = int(d.outputs[0]["lengths"][j])
                served = d.outputs[0]["tokens"][j, :n].to(self.device)
                ref = self._lm_logits(params["lm"], text, psp, served)
                noise = RowNoise(d.noise.seed, d.noise.call, d.noise.shapes, j, self.device)
                wave = self._audio(params, served[None], spk, pmel, psp, noise)
            got_logits = _served_logits(d, i)[:n].to(self.device)
            keep("lm_logit_err", _rel_err(got_logits[None], ref[None]))
            keep("lm_gap", _gap(self._masked(ref), served))
            got = torch.from_numpy(np.asarray(d.results[j], np.float32)).to(self.device)
            want = wave[: got.shape[0]].float()
            keep("audio_err", _rel_err(got[None], want[None]))
            if self.control:
                with Fp8Compute():
                    low = self._lm_logits(params["lm"], text, psp, served)
                    low_wave = self._audio(params, served[None], spk, pmel, psp, noise)
                keep("lm_logit_err.control", _rel_err(low[None], ref[None]))
                keep("audio_err.control",
                     _rel_err(low_wave[: got.shape[0]].float()[None], want[None]))
        return {name: max(values) for name, values in out.items()}

    def run(self, dispatches: List[Dispatch]) -> Dict[str, float]:
        out: Dict[str, float] = {}
        for stage in (self.asr, self.nmt, self.tts):
            t = time.perf_counter()
            out.update(stage(dispatches))
            if self.device.type == "cuda":
                torch.cuda.empty_cache()
            print(f"  judge {stage.__name__}: {len(_picked(dispatches, stage.__name__))} rows, "
                  f"{time.perf_counter() - t:.3f} s", file=sys.stderr, flush=True)
        return out
