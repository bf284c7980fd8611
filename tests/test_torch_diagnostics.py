"""The port's diagnostics suite and debug analyzer against the JAX package's
on the CPU: each analyzer's dict, ``AudioDiagnostics.analyze_translation``'s
report and narrative, ``visualization_data``'s arrays and
``AudioDebugAnalyzer.analyze`` / ``compare``, on seeded audio and on the JAX
test's phonetic signals (French nasal, Spanish trill, German vowel length).

The STFT-derived floats (the spectral analyzer, the quality scores and the
artefact measures, which run on the port's ``ops``) are held within 1e-4
relative; the rest is the JAX package's numpy and must be equal. One
exception: the two noiseless synthetic vowels (``nasal``, ``oral``) have no
energy above ~2 kHz but the f32 DFT's rounding, so their flatness (~6e-10)
and metallic resonance are statistics of rounding noise: there JAX's
flatness is 4.0e-3 and the port's 1.3e-4 from a float64 DFT, and the two
packages' metallic resonance differ by 3.8e-4. On those two the STFT-derived
floats are held within FLOOR_RTOL, and the port's flatness to float64 within
1e-3.
"""

import json
import logging
import math

import jax
import numpy as np
import pytest

from expressive_speech_translation_tpu import ops as jops
from expressive_speech_translation_tpu.pipeline import debug_analyzer as jdbg
from expressive_speech_translation_tpu.pipeline import diagnostics as jdiag
from expressive_speech_translation_tpu.pipeline.diagnostics import visualize as jvis
from expressive_speech_translation_tpu_torch.pipeline import debug_analyzer as tdbg
from expressive_speech_translation_tpu_torch.pipeline import diagnostics as tdiag
from expressive_speech_translation_tpu_torch.pipeline.diagnostics import languages as tlang
from expressive_speech_translation_tpu_torch.pipeline.diagnostics import neural as tneural
from expressive_speech_translation_tpu_torch.pipeline.diagnostics import visualize as tvis

from test_diagnostics import TestLanguagePhonetics, speechish

STFT_RTOL = 1e-4
STFT_SECTIONS = ("quality", "spectral", "artifacts")
FLOOR_SIGNALS = ("nasal", "oral")
FLOOR_RTOL = 1e-2


def assert_same(got, want, rel=None, path=""):
    """Equal, or with ``rel`` floats within it (NaN equal to NaN)."""
    if isinstance(want, dict):
        assert list(got) == list(want), path
        for k in want:
            assert_same(got[k], want[k], rel, f"{path}/{k}")
    elif isinstance(want, (list, tuple)):
        assert len(got) == len(want), path
        for i, (a, b) in enumerate(zip(got, want)):
            assert_same(a, b, rel, f"{path}/{i}")
    elif isinstance(want, np.ndarray):
        np.testing.assert_array_equal(got, want, err_msg=path)
    elif isinstance(want, float) and math.isnan(want):
        assert math.isnan(got), path
    elif rel is not None and isinstance(want, float):
        assert got == pytest.approx(want, rel=rel, abs=1e-12), path
    else:
        assert got == want and type(got) is type(want), path


def assert_report_same(got, want):
    for k in want:
        assert_same(got[k], want[k], STFT_RTOL if k in STFT_SECTIONS else None, k)
    assert list(got) == list(want)


def _phonetic_signals():
    v = TestLanguagePhonetics()
    sr = v.sr
    plain = v._vowel(seconds=1.0)
    t = np.arange(len(plain)) / sr
    trilled = (plain * (0.55 + 0.45 * np.sign(np.sin(2 * np.pi * 28.0 * t)))).astype(np.float32)

    def sequence(durs):
        parts = []
        for i, d in enumerate(durs):
            parts.append(v._vowel(seconds=d, f0=110 + 10 * (i % 3)))
            parts.append(np.zeros(int(0.12 * sr), np.float32))
        return np.concatenate(parts)

    return {
        "speechish": speechish(),
        "nasal": v._vowel(formants=((280, 1.0), (700, 0.5), (1200, 0.15))),
        "oral": v._vowel(formants=((700, 1.0), (1200, 0.8))),
        "trill": trilled,
        "german_contrast": sequence([0.08, 0.30, 0.08, 0.32, 0.09, 0.28, 0.08, 0.30]),
        "german_uniform": sequence([0.18] * 8),
    }


SIGNALS = _phonetic_signals()
# the language analyzers each signal is held on (all of them on speechish)
LANGUAGES = {"speechish": ("fra", "deu", "ita", "por", "spa", "xx"), "nasal": ("fra",),
             "oral": ("fra",), "trill": ("spa",), "german_contrast": ("deu",),
             "german_uniform": ("deu",)}


@pytest.fixture(scope="module", autouse=True)
def jitted_jax_ops():
    """JAX's diagnostics call its ops eagerly; jitted, each signal length
    compiles once instead of primitive by primitive."""
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(jops, "stft", jax.jit(jops.stft, static_argnums=(1, 2)))
        mp.setattr(jops, "spectral_flatness", jax.jit(jops.spectral_flatness))
        mp.setattr(jops, "spectral_centroid_rolloff", jax.jit(
            jops.spectral_centroid_rolloff, static_argnames=("sr", "n_fft", "hop")))
        mp.setattr(jops, "energy_envelope", jax.jit(jops.energy_envelope))
        yield


@pytest.mark.parametrize("name", sorted(SIGNALS))
def test_each_analyzer_matches_jax(name):
    x = SIGNALS[name]
    rel = FLOOR_RTOL if name in FLOOR_SIGNALS else STFT_RTOL
    assert_same(tdiag.SpectralAnalyzer(device="cpu").analyze(x),
                jdiag.SpectralAnalyzer().analyze(x), rel)
    assert_same(tdiag.TemporalAnalyzer().analyze(x), jdiag.TemporalAnalyzer().analyze(x))
    tq, jq = tdiag.QualityMetrics(device="cpu"), jdiag.QualityMetrics()
    assert_same(tq.score(x), jq.score(x), rel)
    assert_same(tq.analyze_neural_synthesis_artifacts(x), jq.analyze_neural_synthesis_artifacts(x),
                rel)
    assert_same(tneural.analyze_neural_synthesis_artifacts(x, 16_000),
                jdiag.analyze_neural_synthesis_artifacts(x, 16_000))
    assert_same(tneural.measure_metallic_resonance(x, 16_000),
                jdiag.measure_metallic_resonance(x, 16_000))
    for lang in LANGUAGES[name]:
        assert_same(tdiag.analyze_language(x, lang), jdiag.analyze_language(x, lang))
        assert_same(tdiag.detail_language(x, lang), jdiag.detail_language(x, lang))


@pytest.mark.parametrize("name", FLOOR_SIGNALS)
def test_flatness_below_the_f32_floor_holds_to_a_float64_dft(name):
    from expressive_speech_translation_tpu_torch.ops.stft import hann

    x = SIGNALS[name]
    got = tdiag.SpectralAnalyzer(device="cpu").analyze(x)["flatness"]
    xp = np.pad(x.astype(np.float64), 512, mode="reflect")
    frames = np.lib.stride_tricks.sliding_window_view(xp, 1024)[::256] * hann(1024)
    power = np.abs(np.fft.rfft(frames, axis=-1)) ** 2 + 1e-10
    want = float(np.median(np.exp(np.log(power).mean(-1)) / power.mean(-1)))
    assert want < 1e-8
    assert got == pytest.approx(want, rel=1e-3)


def test_the_phonetic_probes_separate_the_contrasts_as_in_jax():
    fr, es, de = (cls(16_000) for cls in (tlang.FrenchAnalyzer, tlang.SpanishAnalyzer,
                                          tlang.GermanAnalyzer))
    assert fr.nasal_murmur_ratio(SIGNALS["nasal"]) > fr.nasal_murmur_ratio(SIGNALS["oral"]) + 0.2
    assert es.trill_strength(SIGNALS["trill"]) > es.trill_strength(SIGNALS["oral"][:16_000]) + 0.2
    assert (de.vowel_length_contrast(SIGNALS["german_contrast"])
            > de.vowel_length_contrast(SIGNALS["german_uniform"]) + 0.15)


@pytest.mark.parametrize("language,with_source", [("fra", True), ("deu", False),
                                                   ("spa", True), ("default", True)])
def test_analyze_translation_report_and_narrative_match_jax(language, with_source):
    translated = SIGNALS["german_contrast"] if language == "deu" else speechish(2.0, seed=1)
    source = speechish(2.5, seed=3) if with_source else None
    got = tdiag.AudioDiagnostics(device="cpu").analyze_translation(translated, source,
                                                                  language=language)
    want = jdiag.AudioDiagnostics().analyze_translation(translated, source, language=language)
    assert_report_same(got, want)
    assert got["narrative"] == want["narrative"]
    assert (tdiag.AudioDiagnostics(device="cpu").diagnose_translation_quality(translated)
            == jdiag.AudioDiagnostics().diagnose_translation_quality(translated))


def test_visualization_data_matches_jax():
    g = np.random.default_rng(7)
    src = (0.2 * g.standard_normal(16000)).astype(np.float32)
    tr = (0.2 * g.standard_normal(20000)).astype(np.float32)
    tr[4000:6000] = 0.0
    report = jdiag.AudioDiagnostics().analyze_translation(tr, src, language="fra")
    assert_same(tvis.visualization_data(src, tr, report=report),
                jvis.visualization_data(src, tr, report=report))


def test_debug_analyzer_matches_jax():
    x = np.concatenate([np.zeros(8000, np.float32), speechish(1.0), np.zeros(4000, np.float32),
                        speechish(0.5, seed=2)])
    t, j = tdbg.AudioDebugAnalyzer(), jdbg.AudioDebugAnalyzer()
    for audio in (x, np.zeros(100, np.float32), SIGNALS["trill"]):
        assert_same(t.analyze(audio, "t"), j.analyze(audio, "t"))
    longer = np.concatenate([x, np.zeros(16000, np.float32)])
    assert_same(t.compare(x, longer), j.compare(x, longer))


def test_saved_report_renders_the_png_and_survives_a_failed_figure(tmp_path, monkeypatch,
                                                                   caplog):
    g = np.random.default_rng(8)
    src = (0.2 * g.standard_normal(16000)).astype(np.float32)
    tr = (0.2 * g.standard_normal(16000)).astype(np.float32)
    diag = tdiag.AudioDiagnostics(output_dir=tmp_path / "ok", device="cpu")
    report = diag.analyze_translation(tr, src, language="fra", save=True)
    saved = list((tmp_path / "ok").rglob("diagnostics.json"))
    assert len(saved) == 1
    assert json.loads(saved[0].read_text())["narrative"] == report["narrative"]
    try:
        import matplotlib  # noqa: F401
    except ImportError:
        matplotlib = None
    pngs = list((tmp_path / "ok").rglob("diagnostics.png"))
    if matplotlib is not None:
        assert len(pngs) == 1 and pngs[0].stat().st_size > 20_000
    else:
        assert not pngs

    def broken(*args, **kwargs):
        raise RuntimeError("no figure")

    monkeypatch.setattr(tvis, "render_report_png", broken)
    with caplog.at_level(logging.ERROR):
        tdiag.AudioDiagnostics(output_dir=tmp_path / "bad", device="cpu").analyze_translation(
            tr, src, language="fra", save=True)
    assert "diagnostic figure rendering failed" in caplog.text
    assert len(list((tmp_path / "bad").rglob("diagnostics.json"))) == 1
    assert not list((tmp_path / "bad").rglob("diagnostics.png"))


def test_the_spectral_passes_need_the_card_unless_asked_for_the_cpu():
    import torch

    if torch.cuda.is_available():
        pytest.skip("this host has a CUDA device; the default device is valid here")
    for make in (tdiag.AudioDiagnostics, tdiag.QualityMetrics, tdiag.SpectralAnalyzer):
        with pytest.raises(RuntimeError, match="no CUDA device"):
            make()
