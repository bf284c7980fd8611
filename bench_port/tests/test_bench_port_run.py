"""Whole runs of a toy-width cell on the CPU: the pinned lengths applied and
counted, the result's format, the judge's readings, and a run with the timed
path broken underneath coming out not correct."""

from __future__ import annotations

import json
import subprocess
import sys
import time

import numpy as np
import pytest
import torch

from bench_port import run as run_cli
from bench_port.lib import runner, system
from bench_port.lib.record import Recorder
from bench_port.lib.spec import ROOT, load_cell
from bench_port.tests.toy import toy_cell

SEED = 2**31 + 12345


def _run(cell, traced=False, seconds=3.0, control=False):
    torch.manual_seed(0)
    return runner.run(cell, SEED, seconds, traced, time.perf_counter(), device="cpu",
                      control=control)


@pytest.fixture(scope="module")
def result():
    return _run(toy_cell("native", "closed"), traced=True)


def test_a_toy_run_is_correct_and_reports_the_cells_metrics(result):
    assert result["correct"] and result["failed"] == 0 and result["attempted"] >= 4
    checks = result["checks"]
    assert list(result)[-1] == "checks"
    assert checks["tokens_off"] == {"value": 0, "limit": 0}
    assert set(checks) == {"tokens_off", "asr_logit_err", "nmt_logit_err", "lm_logit_err",
                           "audio_err"}
    # float32 program against the float32 reference: the same arithmetic
    for name in ("asr_logit_err", "nmt_logit_err", "lm_logit_err", "audio_err"):
        assert checks[name]["value"] < 1e-5, name
    assert result["readings"]["asr_gap"] == 0 and result["readings"]["lm_gap"] == 0
    assert set(result["device"]) >= {"platform", "kind", "count", "memory_peak_bytes", "busy_s",
                                     "window_s"}
    assert {"batch_rows.asr", "batch_rows.tts"} <= set(result["metrics"])
    assert set(result["breakdown"]) == {"device_ops", "idle_gaps"}
    json.loads(json.dumps(result))


def test_the_pins_are_set_on_the_engines_and_counted():
    cell = toy_cell()
    rec = Recorder(1).install()
    try:
        sut = system.build(cell.config, cell.traffic, "cpu", rec)
        pins = cell.traffic["pins"]
        assert sut.inner("asr").max_new_tokens == pins["asr_max_new_tokens"] == 48
        assert sut.inner("nmt").max_new_tokens == pins["nmt_max_new_tokens"] == 64
        # 63 letters after the language token × seconds_per_char × 25 → 250 → bucket 256
        assert int(63 * sut.inner("tts").seconds_per_char * 25 + 1e-6) == 250
        sut.shutdown()
    finally:
        rec.uninstall()
    bad = dict(cell.config)
    with pytest.raises(KeyError):
        system.port_configs({**bad, "asr": {**bad["asr"], "no_such_width": 1}})


def test_every_cell_of_the_benchmark_loads():
    spec = json.loads((ROOT / "BENCHMARK.json").read_text())
    for w in spec["workloads"]:
        cell = load_cell(w["name"])
        assert cell.config["name"] == w["config"] and cell.per_layer
        assert {m["name"] for m in cell.end_to_end} == {"requests_per_s", "setup_s"}


def test_the_command_refuses_to_run_without_a_card(capsys):
    if torch.cuda.is_available():
        pytest.skip("this host has a card")
    assert run_cli.main(["--workload", "native.c16-10s", "--seed", "1", "--seconds", "1"]) == 3
    out = capsys.readouterr()
    assert out.out == "" and "CUDA" in out.err


def _faulty(monkeypatch, fault: str):
    from expressive_speech_translation_tpu_torch.models import cosyvoice, qwen2, whisper
    if fault == "state":
        # the speech LM's decode step hands back the state it was given
        monkeypatch.setattr(qwen2, "decode_step", lambda params, cfg, x, *a, **k: x)
    elif fault == "token":
        orig = whisper.decode_with_alignment

        def altered(*a, **k):
            out = orig(*a, **k)
            out[0][0, 10] = 5          # one served token replaced where it is made
            return out
        monkeypatch.setattr(whisper, "decode_with_alignment", altered)
    elif fault == "half_batch":
        orig = cosyvoice.synthesize

        def half(*a, **k):
            out = orig(*a, **k)
            b = out["audio"].shape[0]
            keep = max(b // 2, 1)
            # the second half of the rows left out, the first half's served in their place
            out["audio"][keep:] = out["audio"][:keep].repeat(-(-(b - keep) // keep), 1)[: b - keep]
            return out
        monkeypatch.setattr(cosyvoice, "synthesize", half)


@pytest.mark.parametrize("fault", ["token", "half_batch", "state"])
def test_a_broken_timed_path_is_not_correct(monkeypatch, fault):
    cell = toy_cell()
    _faulty(monkeypatch, fault)
    res = _run(cell)
    assert res["correct"] is False
    failed = {k for k, c in res["checks"].items() if c["value"] > c["limit"]}
    assert {"token": "asr_logit_err", "half_batch": "audio_err",
            "state": "lm_logit_err"}[fault] in failed


def test_the_control_reads_above_the_program():
    """The control at a size a test run holds: a bfloat16 toy program judged
    beside the reference in fp8 put in its place."""
    from bench_port.lib import drive, judge
    from bench_port.lib import traffic as traffic_mod
    from bench_port.lib.judge import Judge

    cell = toy_cell()
    cell.config["dtype"] = "bfloat16"
    rec = Recorder(SEED).install()
    try:
        sut = system.build(cell.config, cell.traffic, "cpu", rec)
        inputs = traffic_mod.requests(cell.traffic, SEED)
        rec.pick(judge.FROM_DISPATCHES, judge.ROWS)
        rec.active = True
        drive.run_window(sut.backend, cell.traffic, inputs, SEED, 2.0)
        rec.active = False
        sut.shutdown()
    finally:
        rec.uninstall()
    out = Judge(cell.config, cell.traffic, SEED, "cpu", control=True).run(rec.dispatches)
    for name in ("asr_logit_err", "nmt_logit_err", "lm_logit_err", "audio_err"):
        assert out[f"{name}.control"] > 3 * out[name], name
    for name in ("asr_logit_err", "nmt_logit_err", "lm_logit_err", "audio_err"):
        assert np.isfinite(out[name]) and np.isfinite(out[f"{name}.control"])


def test_a_control_run_is_not_correct():
    """The control through the run's own checks: a bfloat16 toy program,
    judged with the reference in fp8 in its place, comes out not correct."""
    cell = toy_cell()
    cell.config["dtype"] = "bfloat16"
    res = _run(cell, control=True)
    assert res["correct"] is False
    assert any(c["value"] > c["limit"] for c in res["checks"].values())
    assert res["readings"]["asr_logit_err.control"] == res["checks"]["asr_logit_err"]["value"]


def test_the_judge_samples_rows_from_every_block_of_a_batch():
    from bench_port.lib import judge
    rec = Recorder(SEED)
    rec.pick(judge.FROM_DISPATCHES, judge.ROWS)
    for stage in ("asr", "nmt", "tts"):
        assert 0 in rec._picks[stage] and max(rec._picks[stage]) < judge.FROM_DISPATCHES
    rows = rec.rows_of("tts", 16)
    assert [r // 4 for r in rows] == [0, 1, 2, 3]
    assert rec.rows_of("asr", 3) == [0, 1, 2]
    again = Recorder(SEED)
    again.pick(judge.FROM_DISPATCHES, judge.ROWS)
    assert again.rows_of("tts", 16) == rows and again._picks == rec._picks


def test_nothing_loads_jax_or_the_jax_package():
    """The harness, the reference and the port's serving path, imported in a
    process of their own, leave no top-level module named jax, jaxlib, flax
    or expressive_speech_translation_tpu (compared whole)."""
    code = """
import sys
sys.path.insert(0, %r)
import bench_port.run, bench_port.control
from bench_port.lib import runner, system, judge, trace, readers
from bench_port.reference import (common, whisper, nllb, qwen2, cosyvoice,
    cosyvoice_official, flow_matcha, hift, ecapa, speech_tokenizer, mel, stft, windows,
    resample, languages, text, plain_vocoder)
from expressive_speech_translation_tpu_torch.pipeline import torch_engines, cascaded
print(runner.forbidden_modules())
sys.modules["jax.numpy"] = object()
print(runner.forbidden_modules())
""" % str(ROOT)
    out = subprocess.run([sys.executable, "-c", code], capture_output=True, text=True,
                         timeout=120, cwd=ROOT)
    assert out.returncode == 0, out.stderr
    lines = out.stdout.strip().splitlines()
    assert lines[-2] == "[]" and lines[-1] == "['jax']"
