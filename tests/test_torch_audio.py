"""The port's audio front end against the JAX package's on the CPU.

``ops/dsp.py`` and ``ops/stft.istft``, ``AudioProcessor`` and ``load_config``
on the same numpy-seeded inputs. Tolerances, f32 throughout:

- 1e-5 absolute for the STFT round trips, the gates and the processor's
  outputs (peaks ~1): the same matmuls summed in another order, a few ulps;
- the phase vocoder 2e-2: its accumulated phase reaches ~1e5 rad over a
  second, where one f32 ulp is 7.8e-3 rad, and ``torch.atan2`` differs from
  XLA's by one ulp in about a sixth of the bins, which flips roundings of the
  running sum;
- the music features 1e-5 relative (host numpy over device magnitudes).

The processor's inputs stay inside the 5 s length bucket, so the JAX jits
stay few and small.
"""

import dataclasses
import importlib

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from expressive_speech_translation_tpu.core import config as jconfig
from expressive_speech_translation_tpu.core.errors import ValidationError as JaxValidationError
from expressive_speech_translation_tpu.pipeline.audio_processor import (
    AudioProcessor as JaxAudioProcessor)
from expressive_speech_translation_tpu_torch.core import config as tconfig
from expressive_speech_translation_tpu_torch.core.errors import ValidationError
from expressive_speech_translation_tpu_torch.ops import dsp, stft as tstft
from expressive_speech_translation_tpu_torch.pipeline.audio_processor import AudioProcessor

# ``expressive_speech_translation_tpu.ops`` re-exports functions under the
# modules' names, so the modules come by path
jdsp = importlib.import_module("expressive_speech_translation_tpu.ops.dsp")
jstft = importlib.import_module("expressive_speech_translation_tpu.ops.stft")

ATOL = 1e-5
PV_ATOL = 2e-2
SR = 16_000


def _speech(seconds, seed, sr=SR, pitch=140.0):
    """Voiced harmonics under a syllable-rate envelope, pauses and a noise floor."""
    g = np.random.default_rng(seed)
    t = np.arange(int(sr * seconds)) / sr
    f0 = pitch + 20 * np.sin(2 * np.pi * 0.7 * t)
    phase = 2 * np.pi * np.cumsum(f0) / sr
    voiced = sum(np.sin(k * phase) / k for k in range(1, 6))
    env = np.clip(np.sin(2 * np.pi * 2.5 * t), 0, None) ** 2
    return (0.3 * voiced * env + 0.01 * g.standard_normal(t.shape)).astype(np.float32)


def _close(got, want, atol=ATOL):
    got = got.numpy() if isinstance(got, torch.Tensor) else np.asarray(got)
    want = np.asarray(want)
    assert got.shape == want.shape, (got.shape, want.shape)
    assert np.isfinite(got).all()
    np.testing.assert_allclose(got, want, atol=atol, rtol=0)


# ------------------------------------------------------------------ ops


@pytest.mark.parametrize("n_fft,hop,center,length", [
    (1024, 256, True, 20_000), (512, 128, True, None), (2048, 512, True, 21_000),
    (400, 160, True, 20_000), (400, 160, False, None)])
def test_istft_matches_jax(n_fft, hop, center, length):
    """The n_fft % hop == 0 shifted adds and the general overlap-add (400/160),
    the center trim, and ``length`` shorter and longer than the frames give.
    Uncentred, the outer half-frames divide by a window² sum that falls to
    ~1e-11 and amplify any rounding: there the trimmed samples of a centred
    run are left out, and the rest is held."""
    x = _speech(1.25, seed=1)
    real, imag = jstft.stft(jnp.asarray(x), n_fft, hop, center=center)
    want = np.asarray(jstft.istft(real, imag, n_fft, hop, center=center, length=length))
    got = tstft.istft(torch.from_numpy(np.array(real)), torch.from_numpy(np.array(imag)),
                      n_fft, hop, center=center, length=length).numpy()
    assert got.shape == want.shape
    edge = 0 if center else n_fft // 2
    _close(got[edge:len(got) - edge], want[edge:len(want) - edge])


def test_stft_reflects_pads_longer_than_the_signal_like_jax():
    """700 samples at n_fft 2048 reflect 1024 each side, past the signal,
    as numpy's reflect does (``F.pad`` refuses that)."""
    x = _speech(0.3, seed=2)[:700]
    for got, want in zip(tstft.stft(torch.from_numpy(x), 2048, 512),
                         jstft.stft(jnp.asarray(x), 2048, 512)):
        _close(got, want, atol=1e-4)


ELEMENTWISE = ["remove_dc", "preemphasis", "peak_normalize", "soft_limit", "silence_gate",
               "rms_db", "loudness_normalize", "energy_envelope", "spectral_flatness"]


@pytest.mark.parametrize("name", ELEMENTWISE)
def test_dsp_function_matches_jax(name):
    """Each on a [T] and a [2, T] input (rms_db in dB)."""
    x = np.stack([_speech(1.0, seed=3), 0.05 * _speech(1.0, seed=4)])
    for a in (x[0], x):
        _close(getattr(dsp, name)(torch.from_numpy(a)), getattr(jdsp, name)(jnp.asarray(a)),
               atol=1e-4 if name == "rms_db" else ATOL)


def test_silence_gate_zeroes_quiet_frames_like_jax():
    x = _speech(1.0, seed=5)
    x[4000:9000] *= 1e-4
    got = dsp.silence_gate(torch.from_numpy(x), threshold_db=-30.0, frame=400)
    _close(got, jdsp.silence_gate(jnp.asarray(x), threshold_db=-30.0, frame=400))
    assert (got.numpy()[4400:8800] == 0).all()


@pytest.mark.parametrize("corr", ["correlated", "decorrelated", "mono", "one channel"])
def test_stereo_to_mono_matches_jax(corr):
    a = _speech(0.5, seed=6)
    x = {"correlated": np.stack([a, 0.9 * a]), "decorrelated": np.stack([a, _speech(0.5, 7)]),
         "mono": a, "one channel": a[None]}[corr]
    _close(dsp.stereo_to_mono(torch.from_numpy(x)), jdsp.stereo_to_mono(jnp.asarray(x)))


@pytest.mark.parametrize("valid_frames", [None, 40])
def test_spectral_noise_gate_matches_jax(valid_frames):
    """With ``valid_frames`` the padded zero frames leave the selection."""
    x = np.zeros(16_000, np.float32)
    x[:12_000] = _speech(0.75, seed=8)
    got = dsp.spectral_noise_gate(torch.from_numpy(x), valid_frames=valid_frames)
    _close(got, jdsp.spectral_noise_gate(jnp.asarray(x), valid_frames=valid_frames))


@pytest.mark.parametrize("seconds,mults,ratio", [
    (1.0, (1.0,) * 7, 1.0), (1.0, (0.9, 1.0, 1.1, 1.2, 1.15, 1.05, 0.95), 1.8),
    (0.1, (0.95, 1.0, 1.05, 1.15, 1.2, 1.1, 1.0), 1.5)])
def test_spectral_enhance_matches_jax(seconds, mults, ratio):
    """Three resolutions mixed; 0.1 s (1,600 samples) pads 1,024 at n_fft 2048."""
    x = _speech(seconds, seed=9)
    kw = dict(band_multipliers=mults, compression_ratio=ratio, compression_threshold=0.45)
    _close(dsp.spectral_enhance(torch.from_numpy(x), **kw),
           jdsp.spectral_enhance(jnp.asarray(x), **kw))


def test_band_eq_gains_match_jax():
    args = (SR, 513, 1024, (0, 150, 300, 800, 1500, 3000, 5000, 8000),
            (0.9, 1.0, 1.1, 1.2, 1.15, 1.05, 0.95))
    np.testing.assert_array_equal(dsp.band_eq_gains(*args), jdsp.band_eq_gains(*args))


@pytest.mark.parametrize("rate", [0.8, 1.3])
def test_phase_vocoder_stretch_matches_jax(rate):
    x = _speech(1.0, seed=10)
    got = dsp.phase_vocoder_stretch(torch.from_numpy(x), rate)
    _close(got, jdsp.phase_vocoder_stretch(jnp.asarray(x), rate), atol=PV_ATOL)
    # the first frame keeps its phase and the magnitudes are interpolated
    # alike, so the opening 512 samples agree as closely as the STFTs do
    _close(got[:512], jdsp.phase_vocoder_stretch(jnp.asarray(x), rate)[:512], atol=1e-4)


def test_spectral_centroid_rolloff_match_jax():
    x = _speech(1.0, seed=11)
    (c, r), (jc, jr) = dsp.spectral_centroid_rolloff(torch.from_numpy(x)), \
        jdsp.spectral_centroid_rolloff(jnp.asarray(x))
    np.testing.assert_allclose(c.numpy(), np.asarray(jc), rtol=1e-5)
    np.testing.assert_array_equal(r.numpy(), np.asarray(jr))


# ------------------------------------------------------------ AudioProcessor


@pytest.fixture(scope="module")
def processors():
    return JaxAudioProcessor(), AudioProcessor(device="cpu")


def _upload(kind, seconds, sr, seed):
    """A second voice at another pitch decorrelates the channels: the
    decorrelated pair sits at ~0.35 and the correlated one at ~0.8, on either
    side of the downmix's 0.5 threshold and away from 0 and 1."""
    a = _speech(seconds, seed, sr)
    b = _speech(seconds, seed + 100, sr, pitch=230.0)
    return {"mono": a, "[1, T]": a[None], "stereo correlated": np.stack([a, a + 0.75 * b]),
            "stereo decorrelated": np.stack([a, b + 0.4 * a]),
            "6 channels": np.stack([a, b, 0.5 * a, 0.5 * b, 0.2 * a, 0.1 * b])}[kind]


@pytest.mark.parametrize("kind,seconds,sr", [
    ("mono", 3.0, 16_000), ("mono", 5.0, 16_000), ("mono", 5.0 - 37 / 16_000, 16_000),
    ("[1, T]", 2.0, 16_000), ("6 channels", 2.0, 16_000),
    ("stereo correlated", 2.0, 44_100), ("stereo decorrelated", 2.0, 44_100)])
def test_process_audio_matches_jax(processors, kind, seconds, sr):
    """Downmix, resample (44.1 kHz) and gate inside the 5 s bucket: below it,
    at its edge and 37 samples off it."""
    jproc, proc = processors
    x = _upload(kind, seconds, sr, seed=12)
    if kind.startswith("stereo"):
        corr = np.sum(x[0] * x[1]) / np.sqrt(np.sum(x[0] ** 2) * np.sum(x[1] ** 2))
        assert (0.5 < corr < 0.9) if kind == "stereo correlated" else (0.2 < corr < 0.5), corr
    got = proc.process_audio(x, orig_sr=sr)
    want = jproc.process_audio(x, orig_sr=sr)
    assert got.dtype == np.float32 and got.shape == (-(-x.shape[-1] * SR // sr),)
    _close(got, want)
    _close(proc.process_audio(x, orig_sr=sr, denoise=False),
           jproc.process_audio(x, orig_sr=sr, denoise=False))


def test_process_audio_denoises_against_the_bucket_not_the_input(processors):
    """The gate runs on the input padded to its bucket: the last frames differ
    from the gate on the bare input, and JAX's bucket result is the port's."""
    jproc, proc = processors
    x = _speech(3.0, seed=13)
    got = proc.process_audio(x)
    bare = dsp.spectral_noise_gate(torch.from_numpy(x), valid_frames=1 + len(x) // 256).numpy()
    assert np.abs(got[-256:] - bare[-256:]).max() > 1e-4
    _close(got, jproc.process_audio(x))


def test_preprocess_audio_matches_jax(processors):
    jproc, proc = processors
    x = _speech(1.5, seed=14) + 0.02
    _close(proc.preprocess_audio(x), jproc.preprocess_audio(x))


@pytest.mark.parametrize("seconds", [2.0, 2.0 + 256 / 16_000])
def test_detect_background_music_matches_jax(processors, seconds):
    """126 frames (an even count: the median averages the middle two) and 127;
    a sub-frame clip gives the benign no-music answer in both."""
    jproc, proc = processors
    x = _speech(seconds, seed=15)
    n_frames = 1 + len(x) // 256
    got, want = proc.detect_background_music(x), jproc.detect_background_music(x)
    assert got["has_music"] == want["has_music"]
    assert got["features"].keys() == want["features"].keys()
    for k in want["features"]:
        np.testing.assert_allclose(got["features"][k], want["features"][k], rtol=1e-5,
                                   atol=1e-6, err_msg=f"{k} at {n_frames} frames")
    np.testing.assert_allclose(got["confidence"], want["confidence"], rtol=1e-5)
    flat = dsp.spectral_flatness(torch.from_numpy(x))
    if n_frames % 2 == 0:
        assert got["features"]["flatness"] != float(torch.median(flat))
    assert proc.detect_background_music(x[:1000]) == jproc.detect_background_music(x[:1000])


@pytest.mark.parametrize("language", ["fra", "deu", "default", "ell"])
def test_apply_spectral_enhancement_matches_jax(processors, language):
    jproc, proc = processors
    x = _speech(1.0, seed=16)
    _close(proc.apply_spectral_enhancement(x, language),
           jproc.apply_spectral_enhancement(x, language))


def test_process_audio_enhanced_matches_jax(processors):
    jproc, proc = processors
    x = _upload("stereo decorrelated", 1.5, 44_100, seed=17)
    _close(proc.process_audio_enhanced(x, 44_100, "fra"),
           jproc.process_audio_enhanced(x, 44_100, "fra"))


INVALID = {
    "too short": np.full(1_599, 0.1, np.float32),
    "nan": np.r_[_speech(0.5, 18)[:-1], np.nan].astype(np.float32),
    "silent": np.zeros(16_000, np.float32),
    "rms too high": np.full(16_000, 1.5, np.float32) * np.sign(_speech(1.0, 19) + 1e-9),
    "dc offset": _speech(1.0, 20) * 0.1 + 0.2,
}


@pytest.mark.parametrize("case", sorted(INVALID))
def test_invalid_audio_raises_like_jax(processors, case):
    jproc, proc = processors
    x = INVALID[case].astype(np.float32)
    assert proc.is_valid_audio(x) == jproc.is_valid_audio(x)
    assert not proc.is_valid_audio(x)[0]
    with pytest.raises(JaxValidationError) as want:
        jproc.process_audio(x)
    with pytest.raises(ValidationError) as got:
        proc.process_audio(x)
    assert str(got.value) == str(want.value)
    assert got.value.error_id == want.value.error_id
    assert got.value.to_payload() == want.value.to_payload()


@pytest.mark.parametrize("seconds,limit", [(301.0, None), (0.05, None), (61.0, 60.0),
                                           (120.0, None), (0.1, None)])
def test_validate_audio_length_matches_jax(processors, seconds, limit):
    jproc, proc = processors
    kw = {} if limit is None else {"max_seconds": limit}
    try:
        jproc.validate_audio_length(seconds, **kw)
        want = None
    except JaxValidationError as e:
        want = e
    if want is None:
        proc.validate_audio_length(seconds, **kw)
    else:
        with pytest.raises(ValidationError, match=str(want).split("(")[0]) as got:
            proc.validate_audio_length(seconds, **kw)
        assert str(got.value) == str(want) and got.value.http_status == 400
        assert got.value.error_id == want.error_id
        assert got.value.to_payload() == want.to_payload()


def test_audio_processor_without_a_device_needs_the_card():
    if torch.cuda.is_available():
        pytest.skip("this host has a CUDA device; the default device is valid here")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        AudioProcessor()


def test_language_params_match_jax():
    from expressive_speech_translation_tpu.pipeline import audio_processor as jap
    from expressive_speech_translation_tpu_torch.pipeline import audio_processor as tap

    assert ({k: dataclasses.asdict(v) for k, v in tap.LANGUAGE_PARAMS.items()}
            == {k: dataclasses.asdict(v) for k, v in jap.LANGUAGE_PARAMS.items()})
    assert tap.BAND_EDGES_HZ == jap.BAND_EDGES_HZ
    assert AudioProcessor.DENOISE_BUCKETS_S == JaxAudioProcessor.DENOISE_BUCKETS_S


# ---------------------------------------------------------------- AppConfig


def _both(*args, **kwargs):
    return (dataclasses.asdict(tconfig.load_config(*args, **kwargs)),
            dataclasses.asdict(jconfig.load_config(*args, **kwargs)))


def test_load_config_defaults_match_jax():
    got, want = _both(env={})
    assert got == want
    assert tconfig.AudioConfig().max_audio_seconds == 300.0


def test_load_config_yaml_env_and_overrides_match_jax(tmp_path):
    """defaults < YAML < EST_* and the legacy aliases < overrides; the
    runtime variables and EST_BENCH_* are skipped, empty values are unset."""
    path = tmp_path / "cfg.yaml"
    path.write_text("serve:\n  port: 7000\n  cors_origins: [a, b]\naudio:\n"
                    "  max_audio_seconds: 120\nengines:\n  asr_context_buckets: [10, 30]\n")
    env = {"EST_SERVE__PORT": "7100", "EST_ENGINES__QUANTIZE": "yes",
           "EST_AUDIO__ALLOWED_FORMATS": ".wav, .flac", "COSYVOICE_API_URL": "http://tts:1",
           "MAX_AUDIO_LENGTH_SECONDS": "90", "SAVE_DEBUG_AUDIO_FILES": "1",
           "HUGGINGFACE_TOKEN": "tok", "EST_MODELS_DIR": "/models", "EST_TOKENIZER": "x",
           "EST_BENCH_STEPS": "3", "EST_MESH__TP": "", "MEMORY_THRESHOLD": ""}
    got, want = _both(path, env=env, **{"serve.host": "127.0.0.1", "train": {"seed": 7}})
    assert got == want
    cfg = tconfig.load_config(path, env=env, **{"serve.host": "127.0.0.1"})
    assert cfg.serve.port == 7100 and cfg.serve.host == "127.0.0.1"
    assert cfg.serve.cors_origins == ("a", "b") and cfg.engines.asr_context_buckets == (10, 30)
    assert cfg.audio.max_audio_seconds == 90.0 and cfg.endpoints.cosyvoice_url == "http://tts:1"
    assert cfg.engines.quantize is True and cfg.audio.allowed_formats == (".wav", ".flac")
    assert cfg.hf_token == "tok" and cfg.serve.save_debug_audio is True


@pytest.mark.parametrize("env,overrides", [
    ({"EST_SERVE__NO_SUCH": "1"}, {}), ({"EST_SERVE__PORT": "abc"}, {}),
    ({"EST_ENGINES__QUANTIZE": "maybe"}, {}), ({}, {"serve.port.deeper": 1}),
    ({}, {"nosection": 1})])
def test_load_config_errors_match_jax(env, overrides):
    with pytest.raises(jconfig.ConfigError) as want:
        jconfig.load_config(env=env, **overrides)
    with pytest.raises(tconfig.ConfigError) as got:
        tconfig.load_config(env=env, **overrides)
    assert str(got.value) == str(want.value)


def test_load_config_refuses_a_yaml_that_is_not_a_mapping(tmp_path):
    path = tmp_path / "list.yaml"
    path.write_text("- 1\n- 2\n")
    with pytest.raises(tconfig.ConfigError, match="must contain a mapping"):
        tconfig.load_config(path, env={})
