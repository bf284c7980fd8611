"""The port's tools against the JAX package's on the CPU: the component
registry, ``num_frames`` / ``hamming``, ``performance_logger`` /
``profiler_trace``, the evaluation battery (text metrics, SER, the NLLB
semantic scorer, the visual metrics and their learned-model seam, the
per-job analysis, the BASELINE verify-quality harness and its OpenVoice tone
converter) and the batch runner. The CLI is held in ``test_torch_cli.py``.

Each function takes the same seeded inputs in both packages. Pure-Python and
numpy metrics agree within 1e-6 (most bit for bit); the model-backed ones run
on one shared tree (JAX's init carried across by ``from_jax_params``): the
NLLB encoder's embeddings and scores within 1e-5, the tone converter within
1e-4 of its output's peak with JAX's ``PRNGKey(0)`` draw injected. Reports
and rows are compared NaN-aware, with paths and run times masked. A
verify-quality report's scores come from audio through each package's own
cascade, which differs by the natural-flow mapping's phase vocoder
(tests/test_torch_audio.py holds it at 2e-2); they are held within one step
of the report's 4-decimal rounding (FakeTts takes its pitch from the
process's string hash, so in some processes a score lies at a rounding
boundary and the two packages round it 1e-4 apart).
"""

import functools
import json
import logging
import math
import os

import jax
import numpy as np
import pytest
import torch

from expressive_speech_translation_tpu.batch import manifest as jmanifest
from expressive_speech_translation_tpu.batch import runner as jrunner
from expressive_speech_translation_tpu.core import registry as jregistry
from expressive_speech_translation_tpu.evals import analyze as janalyze
from expressive_speech_translation_tpu.evals import semantic as jsemantic
from expressive_speech_translation_tpu.evals import ser as jser
from expressive_speech_translation_tpu.evals import text_metrics as jtext
from expressive_speech_translation_tpu.evals import verify_quality as jvq
from expressive_speech_translation_tpu.evals import visual_metrics as jvm
from expressive_speech_translation_tpu.evals import visual_models as jvmod
from expressive_speech_translation_tpu.evals.acoustic_metrics import (
    speaker_similarity as jspeaker_similarity)
from expressive_speech_translation_tpu.media import wavio as jwavio
from expressive_speech_translation_tpu.models import ecapa as jec
from expressive_speech_translation_tpu.models import nllb as jnl
from expressive_speech_translation_tpu.models import openvoice as jov
from expressive_speech_translation_tpu.ops import windows as jwindows
from expressive_speech_translation_tpu.pipeline import engines as jengines
from expressive_speech_translation_tpu_torch.batch import manifest as tmanifest
from expressive_speech_translation_tpu_torch.batch import runner as trunner
from expressive_speech_translation_tpu_torch.core import registry as tregistry
from expressive_speech_translation_tpu_torch.evals import analyze as tanalyze
from expressive_speech_translation_tpu_torch.evals import semantic as tsemantic
from expressive_speech_translation_tpu_torch.evals import ser as tser
from expressive_speech_translation_tpu_torch.evals import text_metrics as ttext
from expressive_speech_translation_tpu_torch.evals import verify_quality as tvq
from expressive_speech_translation_tpu_torch.evals import visual_metrics as tvm
from expressive_speech_translation_tpu_torch.evals import visual_models as tvmod
from expressive_speech_translation_tpu_torch.evals.acoustic_metrics import (
    speaker_similarity as tspeaker_similarity)
from expressive_speech_translation_tpu_torch.media import wavio as twavio
from expressive_speech_translation_tpu_torch.models import ecapa as tec
from expressive_speech_translation_tpu_torch.models import nllb as tnl
from expressive_speech_translation_tpu_torch.models import openvoice as tov
from expressive_speech_translation_tpu_torch.obs import perf as tperf
from expressive_speech_translation_tpu_torch.ops import stft as tstft
from expressive_speech_translation_tpu_torch.ops import windows as twindows
from expressive_speech_translation_tpu_torch.pipeline import engines as tengines

from test_face import synthetic_clip
from test_torch_openvoice import SPEC_CFG

import importlib

jstft = importlib.import_module("expressive_speech_translation_tpu.ops.stft")

CPU = "cpu"
METRIC_ATOL = 1e-6       # numpy/pure-Python metrics, port against JAX
ENCODER_ATOL = 1e-5      # the shared NLLB encoder's embeddings and scores
TONE_RTOL = 1e-4         # the tone converter, over its output's peak
OWN_CASCADE_ATOL = 1.5e-4  # one 4-decimal rounding step of a report's score, with float slack

NCFG = jnl.NLLBConfig(d_model=64, encoder_layers=2, decoder_layers=1, heads=4, ffn_dim=128,
                      vocab_size=384)
ECFG = jec.EcapaConfig(channels=16, mfa_out=48, bottleneck=8)
SENTENCES = ("the quick brown fox", "the quick brown fox jumps", "zzz qqq completely other",
             "the cat sat on the mat", "quantum flux harmonics", "")


def _fields(cfg):
    return {f: getattr(cfg, f) for f in cfg.__dataclass_fields__}


def _np(tree):
    return jax.tree.map(np.asarray, tree)


def _same(got, want, atol=METRIC_ATOL, path="value"):
    """NaN-aware equality of nested results: numbers within ``atol``,
    everything else equal."""
    if isinstance(want, dict):
        assert isinstance(got, dict) and set(got) == set(want), (path, set(got) ^ set(want))
        for k in want:
            _same(got[k], want[k], atol, f"{path}.{k}")
    elif isinstance(want, (list, tuple)):
        assert len(got) == len(want), path
        for i, (g, w) in enumerate(zip(got, want)):
            _same(g, w, atol, f"{path}[{i}]")
    elif isinstance(want, (float, np.floating)) and not isinstance(want, bool):
        assert isinstance(got, (float, int, np.floating)), (path, got, want)
        if math.isnan(want):
            assert math.isnan(got), (path, got)
        else:
            assert got == pytest.approx(want, abs=atol), (path, got, want)
    else:
        assert got == want, (path, got, want)


def tone(freq=220.0, seconds=2.0, sr=16000, am=3.0):
    t = np.arange(int(sr * seconds)) / sr
    x = 0.4 * np.sin(2 * np.pi * freq * t) * (0.55 + 0.45 * np.sin(2 * np.pi * am * t) ** 2)
    return (x + 0.005 * np.random.default_rng(0).standard_normal(len(t))).astype(np.float32)


# ----------------------------------------------------------- the small gaps


def test_registry_behaves_as_jax():
    def drive(mod):
        r = mod.Registry("backend")
        out = [r.default_name]
        with pytest.raises(KeyError, match="no backend registered"):
            r.get()
        r.register("a", 1)
        r.decorator("b", is_default=True)(2)
        r.register("c", 3)
        with pytest.raises(ValueError, match="already registered"):
            r.register("a", 9)
        out += [r.get(), r.get("a"), r.get("missing"), r.names(), list(r), "c" in r,
                "z" in r, r.default_name]
        return out

    assert drive(tregistry) == drive(jregistry)


@pytest.mark.parametrize("n,n_fft,hop,center", [
    (16_000, 400, 160, True), (16_000, 400, 160, False), (399, 400, 160, False),
    (0, 512, 128, True), (22_050, 1024, 256, False), (1, 4, 1, True)])
def test_num_frames_matches_jax(n, n_fft, hop, center):
    assert tstft.num_frames(n, n_fft, hop, center=center) == \
        jstft.num_frames(n, n_fft, hop, center=center)


@pytest.mark.parametrize("n,periodic", [(1, True), (2, False), (400, True), (401, False),
                                        (1024, True)])
def test_hamming_matches_jax(n, periodic):
    got = twindows.hamming(n, periodic=periodic)
    want = jwindows.hamming(n, periodic=periodic)
    assert got.dtype == want.dtype and np.array_equal(got, want)
    if n > 1:   # torch's own window, the periodic default it names
        ref = torch.hamming_window(n, periodic=periodic, dtype=torch.float64).numpy()
        np.testing.assert_allclose(got, ref, atol=1e-6)


def test_profiler_trace_writes_a_trace_and_none_is_a_noop(tmp_path, caplog):
    with tperf.profiler_trace(str(tmp_path / "trace")):
        torch.ones(64).sum()
    traces = list((tmp_path / "trace").glob("*.pt.trace.json"))
    assert len(traces) == 1 and json.loads(traces[0].read_text())["traceEvents"]
    with tperf.profiler_trace(None):
        pass
    assert not (tmp_path / "None").exists()

    @tperf.performance_logger
    def work(x):
        return x * 2

    with caplog.at_level(logging.INFO, logger=tperf.__name__):
        assert work(21) == 42
    assert "work took" in caplog.text and "RSS delta" in caplog.text


# -------------------------------------------------------- text metrics, SER


TEXT_CASES = [("the cat sat on the mat", ["the cat sat on the mat"]),
              ("the cat sat on a mat", ["the cat sat on the mat", "a cat is on the mat"]),
              ("zebra xylophone", ["the cat sat"]), ("", ["anything"]),
              ("bonjour le monde entier", ["bonjour tout le monde"]),
              ("a b c d e f g", ["g f e d c b a"])]


@pytest.mark.parametrize("hyp,refs", TEXT_CASES)
def test_text_metrics_match_jax(hyp, refs):
    for fn, args in ((ttext.sentence_bleu, (hyp, refs)), (ttext.chrf, (hyp, refs[0])),
                     (ttext.token_f1, (hyp, refs[0]))):
        want = getattr(jtext, fn.__name__)(*args)
        assert fn(*args) == pytest.approx(want, abs=METRIC_ATOL)
    hyps = [h for h, _ in TEXT_CASES]
    refs_list = [r for _, r in TEXT_CASES]
    assert ttext.corpus_bleu(hyps, refs_list) == pytest.approx(
        jtext.corpus_bleu(hyps, refs_list), abs=METRIC_ATOL)
    assert ttext.corpus_bleu(hyps, refs_list, max_n=2) == pytest.approx(
        jtext.corpus_bleu(hyps, refs_list, max_n=2), abs=METRIC_ATOL)


def _stimuli():
    sr = 16000
    t = np.arange(sr * 2) / sr
    vib = 1.0 + 0.4 * np.sin(2 * np.pi * 3.0 * t)
    return {"happy": (0.5 * np.sin(2 * np.pi * 280.0 * vib * t)).astype(np.float32),
            "sad": (0.05 * np.sin(2 * np.pi * 110.0 * t)).astype(np.float32),
            "silence": np.zeros(sr, np.float32), "tone": tone(),
            "noise": 0.2 * np.random.default_rng(5).standard_normal(sr).astype(np.float32)}


@pytest.mark.parametrize("name", sorted(_stimuli()))
def test_ser_matches_jax(name, monkeypatch):
    monkeypatch.delenv("EST_SER_MODEL", raising=False)
    for mod in (jser, tser):
        monkeypatch.setattr(mod, "_hf_pipeline", None)
        monkeypatch.setattr(mod, "_hf_tried", False)
    x = _stimuli()[name]
    _same(tser.emotion_features(x), jser.emotion_features(x))
    assert tser.classify_audio_emotion(x) == jser.classify_audio_emotion(x)
    assert tser.hf_ser_pipeline() is None and tser.LABELS == jser.LABELS


def test_ser_takes_a_mounted_pipeline_as_jax(monkeypatch):
    class FakePipe:
        def __call__(self, inputs):
            assert inputs["sampling_rate"] == 16000
            return [{"label": "hap", "score": 0.9}]

    audio = 0.2 * np.sin(np.arange(16000) * 0.1).astype(np.float32)
    for mod in (jser, tser):
        monkeypatch.setattr(mod, "_hf_pipeline", FakePipe())
        monkeypatch.setattr(mod, "_hf_tried", True)
    assert tser.classify_audio_emotion(audio) == jser.classify_audio_emotion(audio) == "hap"


# ----------------------------------------------------------- semantic scorer


@pytest.fixture(scope="module")
def nllb_tree():
    tree = _np(jnl.init_nllb(jax.random.PRNGKey(0), NCFG))
    return tree, tnl.from_jax_params(tree, CPU), tnl.NLLBConfig(**_fields(NCFG))


def _scorers(nllb_tree):
    tree, ttree, tcfg = nllb_tree
    return (jsemantic.SemanticScorer(params=tree, cfg=NCFG),
            tsemantic.SemanticScorer(params=ttree, cfg=tcfg, device=CPU))


def test_semantic_scorer_matches_jax(nllb_tree):
    js, ts = _scorers(nllb_tree)
    got = ts.embed_sentences(list(SENTENCES))
    want = js.embed_sentences(list(SENTENCES))
    assert got.shape == want.shape
    np.testing.assert_allclose(got, want, atol=ENCODER_ATOL)
    for a in SENTENCES[:4]:
        for b in SENTENCES:
            assert ts.sonar_score(a, b) == pytest.approx(js.sonar_score(a, b), abs=ENCODER_ATOL)
            _same(ts.bert_score_f1(a, b), js.bert_score_f1(a, b), ENCODER_ATOL)
    assert ts.sonar_score("hello world", "hello world") == pytest.approx(1.0, abs=1e-5)


def test_semantic_scorer_is_nan_without_weights_and_loads_the_bake(nllb_tree, tmp_path,
                                                                    monkeypatch):
    from expressive_speech_translation_tpu_torch.models.loaders import save_converted

    monkeypatch.delenv("EST_MODELS_DIR", raising=False)
    js, ts = jsemantic.SemanticScorer(), tsemantic.SemanticScorer(device=CPU)
    assert not ts.available() and not js.available()
    for fn in ("sonar_score", "bert_score_f1"):
        assert np.isnan(getattr(ts, fn)("a", "b")) and np.isnan(getattr(js, fn)("a", "b"))
    _, ttree, tcfg = nllb_tree
    save_converted(ttree, tcfg, tmp_path / "nmt")
    baked = tsemantic.SemanticScorer(models_dir=str(tmp_path), device=CPU)
    js_ref = _scorers(nllb_tree)[0]
    assert baked.available()
    assert baked.sonar_score(*SENTENCES[:2]) == pytest.approx(
        js_ref.sonar_score(*SENTENCES[:2]), abs=ENCODER_ATOL)
    assert tsemantic.default_scorer(CPU) is tsemantic.default_scorer("cpu")


@pytest.mark.skipif(torch.cuda.is_available(), reason="this host has a CUDA device")
def test_scorers_need_the_card_unless_asked_for_the_cpu(tmp_path):
    """No card reads as an error, never as "no weights": the device is
    resolved before any weight discovery."""
    for make in (lambda: tsemantic.SemanticScorer(models_dir=str(tmp_path)),
                 lambda: tvq.SpeakerScorer.from_models_dir(None),
                 lambda: tvq.default_tone_convert(None),
                 lambda: tvq.run_verify_quality(out_dir=tmp_path / "vq", engines_mode="fake")):
        with pytest.raises(RuntimeError, match="no CUDA device"):
            make()
    wav = tmp_path / "in.wav"
    twavio.write_wav(wav, tone(), 16000)
    # the runner reports every failure in a .error file, this one too
    assert trunner.run_batch_job(wav, tmp_path, job_id="j")["status"] == "error"
    assert "no CUDA device" in (tmp_path / "j.error").read_text()


# --------------------------------------------------------- visual battery


@pytest.fixture()
def fresh_visual_registries():
    jvmod._reset()
    tvmod._reset()
    yield
    jvmod._reset()
    tvmod._reset()


def _clip_audio(n, fps=24.0, sr=16000):
    t = np.arange(int(sr * n / fps)) / sr
    return (0.3 * np.sin(2 * np.pi * 220 * t) * (0.5 + 0.5 * np.sin(2 * np.pi * 2 * t))
            ).astype(np.float32)


def test_visual_metrics_match_jax(fresh_visual_registries, monkeypatch):
    monkeypatch.delenv("EST_MODELS_DIR", raising=False)
    frames = synthetic_clip(n=36)
    other = (synthetic_clip(n=36) * np.array([0.4, 0.9, 0.6])).astype(np.uint8)
    audio = _clip_audio(36)
    _same(tvm.video_metrics(frames, 24.0, audio, source_frames=other, device=CPU),
          jvm.video_metrics(frames, 24.0, audio, source_frames=other), 1e-5)
    _same(tvm.action_units(other), jvm.action_units(other), 1e-5)
    for fn in ("head_pose_std", "deepfake_artifact_score", "classify_visual_emotion"):
        _same(getattr(tvm, fn)(other), getattr(jvm, fn)(other), 1e-5)
    assert tvm.visual_identity_distance(frames, other) == pytest.approx(
        jvm.visual_identity_distance(frames, other), abs=1e-5)
    assert tvm.mouth_audio_correlation(frames, 24.0, audio) == pytest.approx(
        jvm.mouth_audio_correlation(frames, 24.0, audio), abs=1e-5)
    blank = np.full((12, 64, 64, 3), 30, np.uint8)    # no face: the NaN / label paths
    _same(tvm.video_metrics(blank, 24.0, audio[:8000], source_frames=blank, device=CPU),
          jvm.video_metrics(blank, 24.0, audio[:8000], source_frames=blank), 1e-5)


def test_visual_models_discover_a_torchscript_member_as_jax(tmp_path, monkeypatch,
                                                            fresh_visual_registries):
    class Embedder(torch.nn.Module):
        def forward(self, x):          # [1, 3, S, S] NCHW crop → [1, 12]
            return x.mean(dim=(2, 3)).repeat(1, 4) * torch.arange(1, 13, dtype=x.dtype)

    class Emotion(torch.nn.Module):
        def forward(self, x):          # [1, T, H, W, 3] clip → [1, 3] logits
            m = x.mean()
            return torch.stack([m, 2 * m, -m]).reshape(1, 3)

    for name, mod, extra in (("arcface", Embedder(), {}),
                             ("visual_emotion", Emotion(), {"labels": ["a", "b", "c"]})):
        d = tmp_path / name
        d.mkdir()
        torch.jit.script(mod).save(str(d / "model.pt"))
        (d / "config.json").write_text(json.dumps({"format": "torchscript", **extra}))
    (tmp_path / "deepfake").mkdir()
    (tmp_path / "deepfake" / "config.json").write_text(json.dumps({"format": "onnx-nope"}))
    monkeypatch.setenv("EST_MODELS_DIR", str(tmp_path))
    reg = tvmod.registry(device=CPU)
    assert reg.sources() == jvmod.registry().sources() == {
        "identity": "learned", "emotion": "learned", "deepfake": "proxy"}
    frames = synthetic_clip(n=16)
    other = (synthetic_clip(n=16) * np.array([0.5, 0.8, 0.7])).astype(np.uint8)
    assert tvm.visual_identity_distance(frames, other) == pytest.approx(
        jvm.visual_identity_distance(frames, other), abs=1e-6)
    assert tvm.classify_visual_emotion(frames) == jvm.classify_visual_emotion(frames) == "b"
    if not torch.cuda.is_available():
        tvmod._reset()
        with pytest.raises(RuntimeError, match="no CUDA device"):
            tvmod.registry()


# ------------------------------------------------------------- analysis


@pytest.fixture(scope="module")
def ecapa_tree():
    tree = _np(jec.init_ecapa(jax.random.PRNGKey(5), ECFG))
    return tree, tec.from_jax_params(tree, CPU), tec.EcapaConfig(**_fields(ECFG))


@pytest.fixture()
def jitted_jax_ecapa(monkeypatch):
    """JAX's ECAPA runs op by op where the JAX package calls it (~3 s a
    call here, compiling each op); jitted, one compile serves each length."""
    monkeypatch.setattr(jec, "embed_audio", jax.jit(jec.embed_audio, static_argnums=1))


def test_analyze_outputs_matches_jax(tmp_path, monkeypatch, ecapa_tree, nllb_tree,
                                     fresh_visual_registries, jitted_jax_ecapa):
    """Two audio jobs with reference transcripts and audio, one video job
    (the visual battery and the AV-sync column), an errored and a missing
    job; ECAPA and the semantic scorer on shared trees."""
    from expressive_speech_translation_tpu_torch.media import native

    monkeypatch.delenv("EST_MODELS_DIR", raising=False)
    jtree, ttree, tcfg = ecapa_tree
    monkeypatch.setattr(janalyze, "speaker_similarity",
                        functools.partial(jspeaker_similarity, params=jtree, cfg=ECFG))
    monkeypatch.setattr(tanalyze, "speaker_similarity",
                        functools.partial(tspeaker_similarity, params=ttree, cfg=tcfg))
    js, ts = _scorers(nllb_tree)
    monkeypatch.setattr(jsemantic, "_default_scorer", js)
    monkeypatch.setattr(tsemantic, "_default_scorer", ts)
    sys_dir, ref_dir = tmp_path / "sys", tmp_path / "ref"
    sys_dir.mkdir(), ref_dir.mkdir()
    manifest = []
    for i, (freq, text) in enumerate([(200, "bonjour le monde"), (260, "salut tout le monde")]):
        jid = f"job{i}"
        manifest.append({"job_id": jid})
        twavio.write_wav(sys_dir / f"{jid}.wav", tone(freq), 16000)
        (sys_dir / f"{jid}_transcripts.json").write_text(json.dumps({"target": text}))
        twavio.write_wav(ref_dir / f"{jid}.wav", tone(freq + 5), 16000)
        (ref_dir / f"{jid}_transcripts.json").write_text(
            json.dumps({"target": "bonjour le monde"}))
    frames = synthetic_clip(n=24)
    audio = tone(220, seconds=1.0)
    twavio.write_wav(sys_dir / "vjob.wav", audio, 16000)
    native.encode_video(sys_dir / "vjob.mp4", frames, fps=24.0, audio=audio, audio_rate=16000)
    (sys_dir / "vjob_transcripts.json").write_text(json.dumps({"target": "hello"}))
    (sys_dir / "bad.error").write_text("boom")
    manifest += [{"job_id": "vjob"}, {"job_id": "bad"}, {"job_id": "gone"}]

    src = tone(180)
    want = janalyze.analyze_outputs(manifest, sys_dir, ref_dir, out_csv=tmp_path / "j.csv",
                                    source_audio=src)
    got = tanalyze.analyze_outputs(manifest, sys_dir, ref_dir, out_csv=tmp_path / "t.csv",
                                   source_audio=src, device=CPU)
    _same(got, want, ENCODER_ATOL)
    assert np.isfinite(got[0]["sonar_score"]) and "av_sync_confidence" in got[2]
    assert [r["status"] for r in got] == ["ok", "ok", "ok", "error", "missing"]
    assert (tmp_path / "t.csv").read_text().splitlines()[0] == \
        (tmp_path / "j.csv").read_text().splitlines()[0]


# ---------------------------------------------------------------- batch


def test_manifest_matches_jax(tmp_path):
    d1, d2 = tmp_path / "voxceleb", tmp_path / "ted"
    d1.mkdir(), d2.mkdir()
    for i in range(7):
        twavio.write_wav(d1 / f"a{i}.wav", tone(200 + i, 0.1), 16000)
    for i in range(3):
        twavio.write_wav(d2 / f"b{i}.flac", tone(300 + i, 0.1), 16000)
    (d2 / "notes.txt").write_text("skip me")
    dirs = {"voxceleb": d1, "ted": d2, "empty": tmp_path / "nothing"}
    (tmp_path / "nothing").mkdir()
    want = jmanifest.create_manifest(dirs, tmp_path / "j.csv", per_dataset=4, seed=3)
    got = tmanifest.create_manifest(dirs, tmp_path / "t.csv", per_dataset=4, seed=3)
    strip = lambda rows: [{k: v for k, v in r.items() if k != "job_id"} for r in rows]  # noqa: E731
    assert strip(got) == strip(want) and len(got) == 7
    assert all(len(r["job_id"]) == 32 for r in got)
    assert tmanifest.read_manifest(tmp_path / "t.csv") == got
    assert tmanifest.manifest_row(tmp_path / "t.csv", 7) == got[6]
    for bad in (0, 8, -1):
        with pytest.raises(ValueError) as te:
            tmanifest.manifest_row(tmp_path / "t.csv", bad)
        with pytest.raises(ValueError) as je:
            jmanifest.manifest_row(tmp_path / "j.csv", bad)
        assert str(te.value) == str(je.value) and "1-based" in str(te.value)


def test_run_batch_job_matches_jax(tmp_path, capsys):
    wav = tmp_path / "in.wav"
    twavio.write_wav(wav, tone(), 16000)
    jout, tout = tmp_path / "j", tmp_path / "t"
    want = jrunner.run_batch_job(wav, jout, job_id="job1", target_lang="fra")
    got = trunner.run_batch_job(wav, tout, job_id="job1", target_lang="fra", device=CPU)
    assert got == want == {"job_id": "job1", "status": "ok"}
    assert (tout / "job1_transcripts.json").read_text() == \
        (jout / "job1_transcripts.json").read_text()
    ta, tsr = twavio.read_wav(tout / "job1.wav")
    ja, jsr = jwavio.read_wav(jout / "job1.wav")
    assert tsr == jsr == 16000 and ta.shape == ja.shape
    np.testing.assert_allclose(ta, ja, atol=2e-2)

    want = jrunner.run_batch_job(tmp_path / "missing.wav", jout, job_id="job2")
    got = trunner.run_batch_job(tmp_path / "missing.wav", tout, job_id="job2", device=CPU)
    assert got == want and got["status"] == "error"
    assert (tout / "job2.error").read_text().split("\n")[0] == \
        (jout / "job2.error").read_text().split("\n")[0]

    tmanifest.create_manifest({"d": tmp_path}, tmp_path / "m.csv", per_dataset=1)
    rc = trunner.main([str(tmp_path / "out"), "--manifest", str(tmp_path / "m.csv"),
                       "--row", "1", "--lang", "deu", "--device", CPU])
    assert rc == 0 and json.loads(capsys.readouterr().out.strip())["status"] == "ok"
    assert trunner.main([str(tmp_path / "missing.wav"), str(tmp_path / "out"),
                         "--device", CPU]) == 1
    assert json.loads(capsys.readouterr().out.strip())["status"] == "error"


# ------------------------------------------------------- verify-quality


def _embed(audio_16k):
    """tests/test_verify_quality.py's deterministic speaker embedding."""
    x = np.asarray(audio_16k, np.float32).reshape(-1)[: 16000 * 4]
    spec = np.abs(np.fft.rfft(x, n=8192))
    return np.log1p(spec[:4096].reshape(32, -1).mean(axis=1))


def _rig(engines_mod, wavio):
    """tests/test_verify_quality.py's rig for one package: loaded-weight
    fakes, the injected scorer, a WAV-backed VideoIO and tone converter."""
    loaded = {n: type(f"Loaded{n}", (getattr(engines_mod, f"Fake{n}"),), {"weightless": False})
              for n in ("Asr", "Nmt", "Tts")}

    class FakeVideoIO:
        def extract_audio(self, video_path):
            return wavio.read_wav(video_path)

        def mux(self, video_path, audio, sr, out_path):
            wavio.write_wav(out_path, np.asarray(audio, np.float32).reshape(-1), sr)

        lipsync = mux

    return {"engines": engines_mod.Engines(asr=loaded["Asr"](), nmt=loaded["Nmt"](),
                                           tts=loaded["Tts"]()),
            "video_io": FakeVideoIO(), "tone_convert": lambda src, tgt: np.resize(tgt, src.shape)}


def _vq_tone(freq, seconds, sr=16_000, am=0.0):
    t = np.arange(int(sr * seconds)) / sr
    return (0.3 * (1.0 + am * np.sin(2 * np.pi * 3.0 * t)) * np.sin(2 * np.pi * freq * t)
            ).astype(np.float32)


@pytest.fixture()
def vq_fixtures(tmp_path):
    fixtures = {"harvard": str(tmp_path / "harvard.wav"),
                "short_audio": str(tmp_path / "short.wav"),
                "short_video": str(tmp_path / "video.mp4")}
    twavio.write_wav(fixtures["harvard"], _vq_tone(440, 3.0), 16_000)
    twavio.write_wav(fixtures["short_audio"], _vq_tone(220, 2.0, am=0.5), 16_000)
    twavio.write_wav(fixtures["short_video"], _vq_tone(330, 2.0, am=0.3), 16_000)
    return fixtures


def _masked(report, root):
    """The report with its run time dropped and its paths made relative."""
    def walk(v):
        if isinstance(v, dict):
            return {k: walk(x) for k, x in v.items() if k != "elapsed_s"}
        if isinstance(v, list):
            return [walk(x) for x in v]
        if isinstance(v, str) and v.startswith(str(root)):
            return v[len(str(root)):]
        return v

    return walk(report)


PACKAGES = ((jvq, jengines, jwavio, {}), (tvq, tengines, twavio, {"device": CPU}))


def _base(tmp_path, mod):
    """Each package's runs and reference set live under a directory of its own."""
    return tmp_path / ("port" if mod is tvq else "jax")


def _run_both(tmp_path, fixtures, name, with_ref=False, configs=(1, 2, 3, 4, 5)):
    out = []
    for mod, eng, wavio, kw in PACKAGES:
        rig = _rig(eng, wavio)
        base = _base(tmp_path, mod)
        report = mod.run_verify_quality(
            out_dir=base / name, reference_dir=str(base / "ref") if with_ref else None,
            configs=configs, engines=rig["engines"],
            scorer=mod.SpeakerScorer(_embed, source="test-embed"), video_io=rig["video_io"],
            tone_convert=rig["tone_convert"], fixtures=fixtures, max_seconds=4.0, **kw)
        saved = json.loads((base / name / "report.json").read_text())
        assert saved["overall"] == report["overall"]
        out.append((report, _masked(report, base)))
    (jrep, jmasked), (trep, tmasked) = out
    _same(tmasked, jmasked, OWN_CASCADE_ATOL)
    return jrep, trep


def test_verify_quality_matches_jax_and_gates_a_promoted_reference(tmp_path, vq_fixtures):
    """All five configs on JAX's rig: structure-only without references; the
    run promoted into a reference set passes every gate on a rerun, and a
    reference whose translation and speaker diverge fails them."""
    jrep, trep = _run_both(tmp_path, vq_fixtures, "seed")
    assert trep["mode"] == "structure-only" == trep["overall"]
    assert all(c["ran"] for c in trep["configs"].values()), trep
    for (mod, eng, wavio, _), rep in zip(PACKAGES, (jrep, trep)):
        written = mod.promote_reference(rep, _base(tmp_path, mod) / "ref",
                                        video_io=_rig(eng, wavio)["video_io"])
        assert set(written) == set(rep["configs"])
    jrep, trep = _run_both(tmp_path, vq_fixtures, "rerun", with_ref=True)
    assert trep["mode"] == "quality-parity" and trep["overall"] == "pass", trep
    for key in ("2_s2st_clone", "4_video_lipsync", "5_mcv_greek_batch"):
        assert trep["configs"][key]["gates"] == {"bleu": "pass", "spk_sim": "pass"}

    for mod, *_ in PACKAGES:
        ref = _base(tmp_path, mod) / "ref"
        (ref / "config2.json").write_text(json.dumps({
            "target_text": "entirely different sentence with no overlap",
            "audio": "config2.wav"}))
        twavio.write_wav(ref / "config5.wav", _vq_tone(1200, 2.0), 16_000)
    jrep, trep = _run_both(tmp_path, vq_fixtures, "diverge", with_ref=True, configs=(2, 5))
    assert trep["configs"]["2_s2st_clone"]["gates"]["bleu"] == "fail"
    assert trep["configs"]["5_mcv_greek_batch"]["gates"]["spk_sim"] == "fail"
    assert trep["overall"] == "fail"


def test_verify_quality_reports_a_failed_config_as_jax(tmp_path, vq_fixtures):
    vq_fixtures["harvard"] = str(tmp_path / "missing.wav")
    jrep, trep = _run_both(tmp_path, vq_fixtures, "broken", configs=(1, 5))
    assert trep["configs"]["1_asr_nmt"]["ran"] is False and trep["overall"] == "incomplete"
    for mod, kw in ((jvq, {}), (tvq, {"device": CPU})):
        with pytest.raises(ValueError, match="unknown config number"):
            mod.run_verify_quality(out_dir=tmp_path / "bad", configs=(1, 6),
                                   engines=_rig(tengines, twavio)["engines"],
                                   scorer=mod.SpeakerScorer(_embed), **kw)


def test_speaker_scorer_reads_the_ecapa_bake(tmp_path, ecapa_tree, jitted_jax_ecapa):
    from expressive_speech_translation_tpu_torch.models.loaders import save_converted

    jtree, ttree, tcfg = ecapa_tree
    assert not tvq.SpeakerScorer.from_models_dir(None, device=CPU).available
    assert not tvq.SpeakerScorer.from_models_dir(str(tmp_path), device=CPU).available
    save_converted(ttree, tcfg, tmp_path / "ecapa")
    scorer = tvq.SpeakerScorer.from_models_dir(str(tmp_path), device=CPU)
    assert scorer.available and scorer.source == str(tmp_path / "ecapa")
    a, b = tone(180), tone(260, am=5.0)
    want = jvq.SpeakerScorer(lambda x: np.asarray(jec.embed_audio(
        jtree, ECFG, np.asarray(x, np.float32)[None]))[0])
    assert scorer.similarity(a, b) == pytest.approx(want.similarity(a, b), abs=1e-5)


def test_default_tone_convert_matches_jax(monkeypatch):
    """The toy OpenVoice tree in both packages (unbaked, so each package's
    random-tree branch serves it; the flow's zero-initialised post convs
    drawn, so the flow is no identity) with JAX's ``PRNGKey(0)`` draw
    injected. JAX's stages are jitted (op by op they take ~15 s here)."""
    from expressive_speech_translation_tpu import ops as jops
    from expressive_speech_translation_tpu.models import common as jcommon

    tree = _np(jov.init_openvoice(jax.random.PRNGKey(3), SPEC_CFG))
    g = np.random.default_rng(4)
    for layer in tree["flow"]:
        layer["post"]["kernel"] = g.normal(0, 0.3, layer["post"]["kernel"].shape
                                           ).astype(np.float32)
    ttree = tov.from_jax_params(tree, CPU)
    tcfg = tov.OpenVoiceConfig(**_fields(SPEC_CFG))
    monkeypatch.setattr(jov, "OpenVoiceConfig", lambda: SPEC_CFG)
    monkeypatch.setattr(jcommon, "host_init", lambda fn, seed, cfg: tree)
    monkeypatch.setattr(tov, "OpenVoiceConfig", lambda: tcfg)
    monkeypatch.setattr(tov, "init_openvoice", lambda seed, cfg, dev: ttree)
    for name in ("extract_se", "spectrogram_22k", "convert_tone"):
        monkeypatch.setattr(jov, name, jax.jit(getattr(jov, name), static_argnums=1))
    monkeypatch.setattr(jops, "resample", jax.jit(jops.resample, static_argnums=(1, 2)))
    draws = []

    def eps(shape):
        draws.append(shape)
        return np.asarray(jax.random.normal(jax.random.PRNGKey(0), shape, np.float32))

    jfn, jweightless = jvq.default_tone_convert(None)
    tfn, tweightless = tvq.default_tone_convert(None, device=CPU, eps=eps)
    assert jweightless is tweightless is True
    src, tgt = tone(180, 0.5), tone(300, 0.4, am=5.0)
    want = jfn(src, tgt)
    got = tfn(src, tgt)
    assert got.dtype == np.float32 and got.shape == want.shape
    assert np.abs(got - want).max() <= TONE_RTOL * np.abs(want).max()
    assert draws == [(1, draws[0][1], SPEC_CFG.inter_channels)]
    # the default draw: the seeded generator, the same on every call
    fn, _ = tvq.default_tone_convert(None, device=CPU)
    np.testing.assert_array_equal(fn(src, tgt), fn(src, tgt))
