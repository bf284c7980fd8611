"""The port's CLI (``expressive_speech_translation_tpu_torch.cli``) against
the JAX package's on the CPU: the same nine subcommands with the same flags
and defaults (the port adds ``--device`` to each), and each subcommand
through ``main([...])`` with ``--engines fake`` (where it takes engines) and
``--device cpu`` printing the JSON JAX's prints. Times (``stage_xrt``) and
paths are masked; audio through each package's own cascade differs by the
natural-flow mapping's phase vocoder (tests/test_torch_audio.py holds it at
2e-2). ``doctor`` on a host without a card reports the card's checks not ok
and returns 1; every subcommand raises there unless asked for the CPU.
"""

import argparse
import json

import jax
import numpy as np
import pytest
import torch

from expressive_speech_translation_tpu import cli as jcli
from expressive_speech_translation_tpu.media import wavio as jwavio
from expressive_speech_translation_tpu.models import ecapa as jec
from expressive_speech_translation_tpu.models import loaders as jld
from expressive_speech_translation_tpu_torch import cli as tcli
from expressive_speech_translation_tpu_torch.media import wavio as twavio
from expressive_speech_translation_tpu_torch.models import ecapa as tec
from expressive_speech_translation_tpu_torch.models import loaders as tld
from expressive_speech_translation_tpu_torch.pipeline.watermark import WaterMark, make_payload

CPU = ["--device", "cpu"]
OWN_CASCADE_ATOL = 2e-2
EMBED_ATOL = 1e-5
ECFG = jec.EcapaConfig(channels=16, mfa_out=48, bottleneck=8)


@pytest.fixture()
def wav_file(tmp_path):
    t = np.arange(16000 * 2) / 16000
    x = (0.4 * np.sin(2 * np.pi * 220 * t) * (0.5 + 0.5 * np.sin(2 * np.pi * 3 * t) ** 2)
         + 0.01 * np.random.default_rng(0).standard_normal(len(t))).astype(np.float32)
    p = tmp_path / "in.wav"
    twavio.write_wav(p, x, 16000)
    return p


def _subparsers(parser):
    action = next(a for a in parser._actions if isinstance(a, argparse._SubParsersAction))
    return action.choices


def _options(p):
    return sorted((tuple(a.option_strings), a.dest, a.default, a.required, a.nargs,
                   tuple(a.choices) if a.choices else None, a.type)
                  for a in p._actions if a.dest not in ("help", "device"))


def test_the_parser_has_jax_subcommands_flags_and_defaults():
    want, got = _subparsers(jcli.build_parser()), _subparsers(tcli.build_parser())
    assert list(got) == list(want) and len(got) == 9
    for name in want:
        assert _options(got[name]) == _options(want[name]), name
        assert got[name].get_default("device") is None
        assert got[name].get_default("fn").__name__ == want[name].get_default("fn").__name__


def _both(capsys, args, tmp_path=None, jax_args=None):
    """(rc, JSON) from each package's main; JAX's first."""
    out = []
    for main, argv in ((jcli.main, jax_args or args), (tcli.main, [*args, *CPU])):
        rc = main(argv)
        text = capsys.readouterr().out
        out.append((rc, json.loads(text)))
    return out


def test_translate_prints_jax_json(tmp_path, wav_file, capsys):
    (jrc, want), (trc, got) = _both(
        capsys, ["translate", str(wav_file), str(tmp_path / "t.wav"), "--target-lang", "fra",
                 "--engines", "fake"],
        jax_args=["translate", str(wav_file), str(tmp_path / "j.wav"), "--target-lang", "fra",
                  "--engines", "fake"])
    assert jrc == trc == 0
    assert got["transcripts"] == want["transcripts"]
    assert got["transcripts"]["target"].startswith("[fra_Latn]")
    assert set(got["stage_xrt"]) == set(want["stage_xrt"])
    ta, tsr = twavio.read_wav(tmp_path / "t.wav")
    ja, jsr = jwavio.read_wav(tmp_path / "j.wav")
    assert tsr == jsr == 16000 and ta.shape == ja.shape
    np.testing.assert_allclose(ta, ja, atol=OWN_CASCADE_ATOL)


def test_simple_tts_prints_jax_json(tmp_path, capsys):
    (jrc, want), (trc, got) = _both(
        capsys, ["simple-tts", "hello there", str(tmp_path / "t.wav"), "--target-lang", "deu",
                 "--engines", "fake"],
        jax_args=["simple-tts", "hello there", str(tmp_path / "j.wav"), "--target-lang",
                  "deu", "--engines", "fake"])
    assert jrc == trc == 0 and got["translated"] == want["translated"]
    ta, tsr = twavio.read_wav(tmp_path / "t.wav")
    ja, jsr = jwavio.read_wav(tmp_path / "j.wav")
    assert tsr == jsr and np.array_equal(ta, ja)


def test_verify_watermark_prints_jax_json(wav_file, capsys):
    (jrc, want), (trc, got) = _both(capsys, ["verify-watermark", str(wav_file)])
    assert jrc == trc == 1 and got == want == {"watermarked": False}
    WaterMark.add_watermark(wav_file, make_payload("req42"))
    (jrc, want), (trc, got) = _both(capsys, ["verify-watermark", str(wav_file)])
    assert jrc == trc == 0 and got == want and got["payload"]["req_id"] == "req42"
    (jrc, want), (trc, got) = _both(capsys, ["verify-watermark", str(wav_file) + ".gone"])
    assert jrc == trc == 1 and got == want and not got["watermarked"]


def test_ab_test_prints_jax_json(tmp_path, wav_file, capsys):
    """The JSON JAX's ab-test prints, built from its LANGUAGE_PARAMS, and each
    variant's audio the port's enhancement of the front end's output (JAX
    compiles its enhancement once a language, ~9 s each here;
    tests/test_torch_audio.py holds the two enhancements equal)."""
    from expressive_speech_translation_tpu.pipeline import audio_processor as jap
    from expressive_speech_translation_tpu_torch.pipeline import audio_processor as tap

    assert tcli.main(["ab-test", str(wav_file), str(tmp_path / "t"), *CPU]) == 0
    got = json.loads(capsys.readouterr().out)
    want = {"results": [
        {"variant": lang, "path": str(tmp_path / "t" / f"test_{i}_{lang}.wav"),
         "params": {"compression_ratio": p.compression_ratio}}
        for i, (lang, p) in enumerate(sorted(jap.LANGUAGE_PARAMS.items()))]}
    assert got == want
    proc = tap.AudioProcessor(device="cpu")
    x = proc.process_audio(*twavio.read_wav(wav_file))
    for r in got["results"][:3]:
        np.testing.assert_allclose(twavio.read_wav(r["path"])[0],
                                   proc.apply_spectral_enhancement(x, r["variant"]),
                                   atol=2 / 32768)   # the WAV's PCM16 round trip


def test_embed_from_an_ecapa_bake_matches_jax(tmp_path, wav_file, capsys):
    """The port's embed of its bake prints what JAX's prints for its own bake
    of the same tree, and the embedding JAX's computes (JAX's ECAPA jitted;
    JAX's bake needs orbax, whose import alone takes ~10 s here). Without a
    bake the port warns and draws random weights."""
    tree = jax.tree.map(np.asarray, jax.jit(jec.init_ecapa, static_argnums=1)(
        jax.random.PRNGKey(6), ECFG))
    tld.save_converted(tec.from_jax_params(tree, "cpu"),
                       tec.EcapaConfig(**{f: getattr(ECFG, f) for f in
                                          ECFG.__dataclass_fields__}),
                       tmp_path / "ecapa")
    out = tmp_path / "t.npy"
    assert tcli.main(["embed", str(wav_file), str(out), "--weights", str(tmp_path), *CPU]) == 0
    assert json.loads(capsys.readouterr().out) == {"output": str(out), "dim": 192,
                                                    "weightless": False}
    audio, _ = jwavio.read_wav(wav_file)
    want = jax.jit(jec.embed_audio, static_argnums=1)(
        tree, ECFG, np.asarray(audio, np.float32).reshape(1, -1))[0]
    np.testing.assert_allclose(np.load(out), np.asarray(want), atol=EMBED_ATOL)
    assert tcli.main(["embed", str(wav_file), str(tmp_path / "r.npy"), *CPU]) == 0
    out = capsys.readouterr()
    assert json.loads(out.out)["weightless"] and "RANDOM weights" in out.err
    assert np.isfinite(np.load(tmp_path / "r.npy")).all()


def test_verify_quality_prints_jax_json_and_promotes(tmp_path, wav_file, capsys):
    common = ["--engines", "fake", "--configs", "1,5", "--harvard", str(wav_file),
              "--short-audio", str(wav_file), "--max-seconds", "2"]
    (jrc, want), (trc, got) = _both(
        capsys, ["verify-quality", "--out", str(tmp_path / "t"), "--promote-reference",
                 str(tmp_path / "tref"), *common],
        jax_args=["verify-quality", "--out", str(tmp_path / "j"), "--promote-reference",
                  str(tmp_path / "jref"), *common])
    assert jrc == trc == 0
    assert got["mode"] == want["mode"] == "structure-only" and got["weights"] == "fake"
    assert got["promoted"] == want["promoted"]
    assert got["configs"]["1_asr_nmt"] == want["configs"]["1_asr_nmt"]
    assert got["configs"]["5_mcv_greek_batch"]["outputs"]["transcripts"] == \
        want["configs"]["5_mcv_greek_batch"]["outputs"]["transcripts"]
    (jrc, want), (trc, got) = _both(
        capsys, ["verify-quality", "--out", str(tmp_path / "t2"), "--reference-outputs",
                 str(tmp_path / "tref"), *common],
        jax_args=["verify-quality", "--out", str(tmp_path / "j2"), "--reference-outputs",
                  str(tmp_path / "jref"), *common])
    assert jrc == trc == 0
    for key in ("1_asr_nmt", "5_mcv_greek_batch"):
        assert got["configs"][key]["metrics"] == want["configs"][key]["metrics"]
        assert got["configs"][key]["gates"]["bleu"] == "pass"


def test_bake_passes_every_family_through(tmp_path, monkeypatch):
    seen = {}
    families = ("asr", "nmt", "tts", "musetalk", "musetalk_whisper", "diff2lip",
                "openvoice", "ecapa", "seamless")
    monkeypatch.setattr(jld, "bake_models", lambda out, **kw: seen.setdefault("jax", (out, kw)))
    monkeypatch.setattr(tld, "bake_models", lambda out, **kw: seen.setdefault("port", (out, kw)))
    argv = ["bake", "--out", str(tmp_path)]
    for f in families:
        argv += [f"--{f.replace('_', '-')}", f"/ckpt/{f}"]
    assert jcli.main(argv) == 0 and tcli.main([*argv, *CPU]) == 0
    jout, jkw = seen["jax"]
    tout, tkw = seen["port"]
    assert tout == jout and tkw.pop("device") == "cpu" and tkw == jkw
    assert sorted(tkw) == sorted(families)


def test_s2st_runs_the_toy_seamless(tmp_path, wav_file, capsys):
    assert tcli.main(["s2st", str(wav_file), str(tmp_path / "s.wav"), "--target-lang", "fra",
                      "--num-beams", "2", *CPU]) == 0
    body = json.loads(capsys.readouterr().out)
    assert body["output"] == str(tmp_path / "s.wav") and set(body["transcripts"]) == {
        "source", "target"}
    audio, sr = twavio.read_wav(tmp_path / "s.wav")
    assert sr == 16000 and audio.size > 0 and np.isfinite(audio).all()


def test_doctor_reports_the_card_checks(capsys, monkeypatch):
    monkeypatch.delenv("EST_MODELS_DIR", raising=False)
    assert jcli.main(["doctor"]) in (0, 1)
    want = json.loads(capsys.readouterr().out)
    rc = tcli.main(["doctor"])
    got = json.loads(capsys.readouterr().out)
    assert set(got) == {"ok", "checks"} and list(got["checks"]) == [
        "cuda_devices", "kernel_builds", "cuda_kernel", "native_media_shim", "weights",
        "tts_triple", "secondary_models"]
    for name in ("native_media_shim", "weights", "tts_triple", "secondary_models"):
        assert got["checks"][name] == want["checks"][name], name
    if not torch.cuda.is_available():
        assert rc == 1 and not got["ok"]
        for name in ("cuda_devices", "cuda_kernel"):
            assert got["checks"][name] == {"ok": False, "detail": "RuntimeError: no CUDA device"}
        assert not got["checks"]["kernel_builds"]["ok"]


@pytest.mark.skipif(torch.cuda.is_available(), reason="this host has a CUDA device")
@pytest.mark.parametrize("argv", [
    ["translate", "IN", "OUT", "--target-lang", "fra", "--engines", "fake"],
    ["simple-tts", "hi", "OUT", "--target-lang", "fra"],
    ["ab-test", "IN", "OUTDIR"],
    ["embed", "IN", "OUT.npy"],
    ["s2st", "IN", "OUT", "--target-lang", "fra"],
    ["verify-quality", "--out", "OUTDIR", "--engines", "fake", "--configs", "1"],
])
def test_subcommands_need_the_card_unless_asked_for_the_cpu(argv, tmp_path, wav_file):
    argv = [str(wav_file) if a == "IN" else str(tmp_path / a) if a.startswith("OUT") else a
            for a in argv]
    with pytest.raises(RuntimeError, match="no CUDA device"):
        tcli.main(argv)
