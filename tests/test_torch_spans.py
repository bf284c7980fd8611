"""The port's spans (``obs/spans.py``) on the CPU, with fake engines and toy
widths: a request's id through the orchestrator and the micro-batchers, the
queue wait beside the dispatch, ``stage.post`` around the resample, the
decode loops' steps, the profiler annotation and the ring's drops."""

import threading
import time

import numpy as np
import pytest
import torch

from expressive_speech_translation_tpu_torch.models import cosyvoice as tcv
from expressive_speech_translation_tpu_torch.models import nllb as tnl
from expressive_speech_translation_tpu_torch.models import qwen2 as tq2
from expressive_speech_translation_tpu_torch.models import whisper as twh
from expressive_speech_translation_tpu_torch.models.common import Init
from expressive_speech_translation_tpu_torch.obs import spans
from expressive_speech_translation_tpu_torch.pipeline import cascaded
from expressive_speech_translation_tpu_torch.pipeline.engines import Engines
from expressive_speech_translation_tpu_torch.serve.batching import (BatchedAsr, BatchedNmt,
                                                                    BatchedTts)

STAGES = ("asr", "nmt", "tts")


def _key(n_samples: int) -> str:
    return f"len{n_samples}"


class _Asr:
    def __init__(self):
        self.calls = []

    def transcribe_batch(self, requests):
        keys = [_key(len(r["audio_16k"])) for r in requests]
        self.calls.append(keys)
        return [{"text": k, "language": "eng", "words": []} for k in keys]


class _Nmt:
    def __init__(self):
        self.calls = []

    def translate_batch(self, requests):
        self.calls.append([r["text"] for r in requests])
        return [r["text"] for r in requests]


class _Tts:
    sample_rate = 24_000

    def __init__(self):
        self.calls = []

    def synthesize_batch(self, requests):
        self.calls.append([r["text"] for r in requests])
        return [np.full(4_800, 0.1, np.float32) for _ in requests]


@pytest.fixture(scope="module")
def served():
    """Two concurrent ``translate_speech`` calls through real micro-batchers
    over fake engines (a 24 kHz TTS), the resample's calls timed."""
    engines = {"asr": _Asr(), "nmt": _Nmt(), "tts": _Tts()}
    facades = Engines(asr=BatchedAsr(engines["asr"], max_wait_ms=100),
                      nmt=BatchedNmt(engines["nmt"], max_wait_ms=100),
                      tts=BatchedTts(engines["tts"], max_wait_ms=100))
    backend = cascaded.CascadedBackend(facades)
    resamples = []
    real = cascaded.resample_np

    def timed(*args, **kwargs):
        t0 = time.time_ns()
        out = real(*args, **kwargs)
        resamples.append((threading.get_ident(), t0, time.time_ns()))
        return out

    with spans.span("test.mark") as mark:
        pass
    results, errors = {}, []
    barrier = threading.Barrier(2)

    def client(n):
        try:
            barrier.wait(timeout=10)
            out = backend.translate_speech(np.zeros(n, np.float32), "eng", "fra",
                                           use_voice_cloning=False)
            results[_key(n)] = out["process_id"]
        except Exception as e:  # noqa: BLE001 — asserted below
            errors.append(e)

    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(cascaded, "resample_np", timed)
        threads = [threading.Thread(target=client, args=(n,)) for n in (16_000, 24_000)]
        for t in threads:
            t.start()
        for t in threads:
            t.join(timeout=30)
    for f in (facades.asr, facades.nmt, facades.tts):
        f.shutdown()
    assert not any(t.is_alive() for t in threads) and not errors, errors
    held = [s for s in spans.RING.snapshot() if s.id > mark.id]
    return {"held": held, "ids": results, "engines": engines, "resamples": resamples}


def _stage_span(held, request, stage):
    (found,) = [s for s in held if s.name == f"stage.{stage}" and s.attrs["request"] == request]
    return found


def test_each_request_s_stage_spans_carry_its_own_id(served):
    held = served["held"]
    for request in served["ids"].values():
        (top,) = [s for s in held if s.name == "request" and s.attrs["request"] == request]
        for stage in STAGES + ("post",):
            s = _stage_span(held, request, stage)
            assert s.parent == top.id and s.thread == top.thread
            assert top.start_ns <= s.start_ns <= s.end_ns <= top.end_ns


def test_each_dispatch_lists_the_ids_it_carried_and_waits_fit_the_stage(served):
    held, ids = served["held"], served["ids"]
    for stage in STAGES:
        dispatches = sorted((s for s in held if s.name == f"dispatch.{stage}"),
                            key=lambda s: s.start_ns)
        calls = served["engines"][stage].calls
        assert len(dispatches) == len(calls) >= 1
        for d, keys in zip(dispatches, calls):
            assert d.attrs["requests"] == [ids[k] for k in keys] and d.attrs["rows"] == len(keys)
            for request, submitted in zip(d.attrs["requests"], d.attrs["submitted_ns"]):
                own = _stage_span(held, request, stage)
                assert own.start_ns <= submitted
                assert 0 <= d.start_ns - submitted <= own.end_ns - own.start_ns
                assert d.thread != own.thread


def test_the_post_stage_encloses_the_resample(served):
    held = served["held"]
    assert len(served["resamples"]) == 2
    for thread, t0, t1 in served["resamples"]:
        (post,) = [s for s in held if s.name == "stage.post" and s.thread == thread]
        assert post.start_ns <= t0 <= t1 <= post.end_ns


BUDGET = 6


def _whisper():
    cfg = twh.WhisperConfig(d_model=64, encoder_layers=1, decoder_layers=1, heads=4, ffn_dim=128)
    params = twh.init_whisper(1, cfg, "cpu")
    prompt = torch.tensor([[cfg.bos_token, cfg.lang_token_start, cfg.task_transcribe,
                            cfg.no_timestamps]] * 2, dtype=torch.int32)
    tokens, _, _, ngen, _ = twh.decode_with_alignment(
        params, cfg, torch.randn(2, cfg.n_mels, 64), prompt, max_new_tokens=BUDGET,
        min_new_tokens=BUDGET)
    assert ngen.tolist() == [BUDGET, BUDGET]
    return tokens.shape[1], 2      # every position through the decoder, the prompt's too


def _nllb(num_beams):
    cfg = tnl.NLLBConfig(d_model=64, encoder_layers=1, decoder_layers=1, heads=4, ffn_dim=128,
                         vocab_size=384, max_positions=64)
    params = tnl.init_nllb(1, cfg, "cpu")
    src = torch.tensor([[5, 6, 7, cfg.eos_token]] * 2, dtype=torch.int32)
    out = tnl.generate(params, cfg, src, 300, num_beams=num_beams, max_new_tokens=BUDGET,
                       min_new_tokens=BUDGET)
    assert not (out[:, 1:] == cfg.eos_token).any()
    return out.shape[1] - 1, 2 * num_beams   # the tokens after the decoder start


def _speech_lm():
    cfg = tcv.SpeechLMConfig(backbone=tq2.Qwen2Config(hidden=64, layers=1, heads=4, kv_heads=2,
                                                      ffn_dim=128, max_positions=256),
                             text_vocab=384, speech_token_size=512)
    params = tcv.init_speech_lm(Init(1, "cpu"), cfg)
    gen = torch.Generator().manual_seed(2)
    text = torch.randint(0, 384, (2, 8), generator=gen)
    prompt = torch.randint(0, 512, (2, 4), generator=gen)
    tokens, lengths = tcv.generate_speech_tokens(
        params, cfg, tcv.GeneratorNoise(3, "cpu"), text, torch.ones_like(text, dtype=torch.bool),
        prompt, torch.ones_like(prompt, dtype=torch.bool), max_new_tokens=BUDGET,
        min_new_tokens=BUDGET)
    assert lengths.tolist() == [BUDGET, BUDGET]
    return BUDGET, 2


@pytest.mark.parametrize("loop", ["whisper", "nllb_greedy", "nllb_beam", "speech_lm"])
def test_a_decode_span_counts_the_steps_decoded_at_a_pinned_budget(loop):
    with spans.span("test.loop") as outer:
        steps, rows = {"whisper": _whisper, "nllb_greedy": lambda: _nllb(1),
                       "nllb_beam": lambda: _nllb(2), "speech_lm": _speech_lm}[loop]()
    (decode,) = [s for s in spans.RING.snapshot() if s.name == "decode" and s.parent == outer.id]
    assert decode.attrs == {"rows": rows, "steps": steps} and steps >= BUDGET


def test_a_span_is_annotated_only_under_a_profiler(monkeypatch):
    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CPU]) as prof:
        with spans.span("test.first"):      # the process's first record_function sets up
            pass
        with spans.span("test.annotated") as s:
            time.sleep(0.002)
    (event,) = [e for e in prof.profiler.kineto_results.events() if e.name() == "test.annotated"]
    assert abs(event.start_ns() - s.start_ns) < 1_000_000

    def entered(name):
        raise AssertionError(f"record_function({name!r}) entered with no profiler")

    monkeypatch.setattr(torch.profiler, "record_function", entered)
    with spans.span("test.quiet") as quiet:
        pass
    assert quiet.end_ns >= quiet.start_ns > 0


def test_the_ring_drops_the_oldest_spans_and_counts_them(monkeypatch):
    monkeypatch.setattr(spans, "RING", spans.Ring(4))
    with spans.span("outer", request="r1") as outer:
        for k in range(5):
            with spans.span(f"inner{k}"):
                pass
    held = spans.RING.snapshot()
    assert [s.name for s in held] == ["inner2", "inner3", "inner4", "outer"]
    assert all(s.parent == outer.id for s in held[:3]) and outer.attrs == {"request": "r1"}
    assert spans.RING.recorded == 6 and spans.RING.dropped == 2
