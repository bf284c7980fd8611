"""The alternate backends (``pipeline/alternate_backends.py``) and the VITS
TTS behind the ESPnet one (``models/vits_tts.py``) against the JAX package
on the CPU.

VITS runs at a narrow config on a tree in JAX's structure and layouts drawn
from a numpy seed, carried across by ``from_jax_params``, with JAX's ε
(``normal(PRNGKey(0))``) injected. The backends are held in f32 by patching
each package's ``models.common.cast_floats`` to the identity inside the test
(both cast the whole tree to bf16 at ``initialize``); the bf16 VITS is held
by its cast points, as ``tests/test_torch_seamless.py`` holds Seamless.
"""

import base64
import dataclasses
import io
import logging

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from werkzeug.test import Client

from expressive_speech_translation_tpu.core import config as jconfig
from expressive_speech_translation_tpu.models import common as jcommon
from expressive_speech_translation_tpu.models import vits_tts as jvits
from expressive_speech_translation_tpu.pipeline import alternate_backends as jab
from expressive_speech_translation_tpu.pipeline import backend as jbackend
from expressive_speech_translation_tpu.pipeline import engines as jengines
from expressive_speech_translation_tpu.pipeline.cascaded import CascadedBackend as JCascaded
from expressive_speech_translation_tpu.serve import app as japp
from expressive_speech_translation_tpu_torch.core import config as tconfig
from expressive_speech_translation_tpu_torch.models import common as tcommon
from expressive_speech_translation_tpu_torch.models import seamless as tsm
from expressive_speech_translation_tpu_torch.models import vits_tts as tvits
from expressive_speech_translation_tpu_torch.pipeline import alternate_backends as tab
from expressive_speech_translation_tpu_torch.pipeline import backend as tbackend
from expressive_speech_translation_tpu_torch.pipeline import engines as tengines
from expressive_speech_translation_tpu_torch.pipeline.cascaded import CascadedBackend as TCascaded
from expressive_speech_translation_tpu_torch.serve import app as tapp

from test_torch_seamless import CFG, TCFG, _jax_tree

CPU = "cpu"
# f32, port against JAX: max |diff| over the output's peak
F32_RTOL = 1e-4
# the host front end (the numpy bandpass; CMVN and stacking over one fbank)
FRONT_ATOL = 1e-5
# kaldi fbank, port against JAX, in the ln domain (tests/test_torch_conditioning.py)
FBANK_ATOL = 1e-4
VCFG = jvits.VitsTTSConfig(hidden=32, layers=2, heads=2, ffn=64, inter_channels=16,
                           max_positions=64)
TVCFG = tvits.VitsTTSConfig(**dataclasses.asdict(VCFG))
MAX_FRAMES = 48
SEAMLESS_KW = dict(num_beams=2, max_text_tokens=10, max_chars=48, max_units=32)


def speech(seconds=1.5, sr=16000, seed=0):
    g = np.random.default_rng(seed)
    t = np.arange(int(sr * seconds)) / sr
    x = 0.4 * np.sin(2 * np.pi * 200 * t) * (0.5 + 0.5 * np.sin(2 * np.pi * 3 * t) ** 2)
    return (x + 0.01 * g.standard_normal(len(t))).astype(np.float32)


def _np(x):
    return x.detach().cpu().numpy() if torch.is_tensor(x) else np.asarray(x)


def _close(got, want, rtol=F32_RTOL):
    got, want = _np(got), _np(want)
    assert got.shape == want.shape
    peak = np.abs(want).max()
    assert peak > 0 and np.abs(got - want).max() <= rtol * peak, (np.abs(got - want).max(), peak)


# ------------------------------------------------- environment and manager


def test_translation_environment_matches_jax():
    for conf in (0.0, 0.05, 0.1499, 0.15, 0.3, 0.3999, 0.4, 0.6, 1.0):
        analysis = {"music_detection": {"confidence": conf}}
        assert tab.TranslationEnvironment.classify(analysis) == \
            jab.TranslationEnvironment.classify(analysis)
        assert tab.TranslationEnvironment.generation_params(analysis) == \
            jab.TranslationEnvironment.generation_params(analysis)
    assert tab.TranslationEnvironment.generation_params({}) == \
        jab.TranslationEnvironment.generation_params({})
    assert tab.TranslationEnvironment.PARAMS == jab.TranslationEnvironment.PARAMS


@pytest.mark.parametrize("package", [jab, tab], ids=["jax", "port"])
def test_model_manager_singleton_and_inactivity_reload(package, caplog):
    """Both packages' managers alike: one instance, a loader called once
    until the inactivity window passes (then JAX's reload message), cleanup
    dropping the components, no loader → RuntimeError."""
    M = package.ModelManager
    M.reset_singleton()
    loads = []
    mgr = M(loader=lambda: loads.append(1) or {"model": object()})
    assert M() is mgr
    c1 = mgr.get_model_components()
    assert mgr.get_model_components() is c1 and len(loads) == 1
    mgr._last_used -= M.INACTIVITY_SECONDS + 1
    with caplog.at_level(logging.INFO):
        c3 = mgr.get_model_components()
    assert len(loads) == 2 and c3 is not c1
    assert "Model inactive for too long, reloading" in caplog.text
    mgr.cleanup()
    assert not mgr._verify_model()
    M.reset_singleton()
    with pytest.raises(RuntimeError, match="no loader"):
        M().get_model_components()
    M.reset_singleton()


# ----------------------------------------------------------------- front end


def test_bandpass_matches_jax():
    sr = 16000
    t = np.arange(sr) / sr
    x = (np.sin(2 * np.pi * 50 * t) + np.sin(2 * np.pi * 1000 * t)
         + np.sin(2 * np.pi * 7900 * t)).astype(np.float32)
    for audio in (x, speech(1.3), x[:777]):
        got, want = tab.bandpass_80_7500(audio, sr), jab.bandpass_80_7500(audio, sr)
        assert got.dtype == want.dtype == np.float32
        assert np.abs(got - want).max() <= FRONT_ATOL
    spec = np.abs(np.fft.rfft(tab.bandpass_80_7500(x, sr)))
    freqs = np.fft.rfftfreq(len(x), 1 / sr)
    assert spec[np.argmin(np.abs(freqs - 50))] < 1e-4 and spec[np.argmin(np.abs(freqs - 1000))] > 100


@pytest.mark.parametrize("n, max_frames", [(1, None), (400, None), (700, None),
                                           (24_000, None), (24_000, 40), (24_000, 400)])
def test_seamless_features_match_jax(n, max_frames, monkeypatch):
    """The features of a bandpassed clip (tiny clips padded to one frame
    pair, a horizon that pads or cuts) and the mask, against JAX's. Over one
    fbank (JAX's, patched into both) the host glue (CMVN, stacking, the
    horizon) agrees within FRONT_ATOL. Each package with its own fbank: the
    two fbanks differ by up to ~6e-5 in ln here (the f32 DFT's rounding,
    held at FBANK_ATOL by tests/test_torch_conditioning.py), and CMVN
    divides that by each bin's spread, so the features are held within
    FRONT_ATOL + FBANK_ATOL / std(bin)."""
    from expressive_speech_translation_tpu import ops as jops

    x = tab.bandpass_80_7500(speech(2.0)[:n] + 0.01)
    got, gmask = tab.seamless_features(x, max_frames=max_frames, device=CPU)
    want, wmask = jab.seamless_features(x, max_frames=max_frames)
    assert got.shape == want.shape and got.dtype == np.float32 and np.isfinite(got).all()
    assert np.array_equal(gmask, wmask) and gmask.any()
    padded = np.pad(x, (0, max(0, 561 - x.size)))
    fbank = jops.kaldi_fbank(jnp.asarray(padded[None]), sr=16_000, n_mels=80,
                             frame_length_ms=25.0, frame_shift_ms=10.0, fmin=20.0)
    fb = np.asarray(fbank)[0]
    spread = np.sqrt(fb.var(0, ddof=1 if fb.shape[0] > 1 else 0) + 1e-7)
    bound = FRONT_ATOL + FBANK_ATOL / np.tile(spread, 2)
    assert (np.abs(got - want) <= bound).all(), np.abs(got - want).max()

    monkeypatch.setattr(jops, "kaldi_fbank", lambda *a, **k: fbank)
    monkeypatch.setattr(tab, "kaldi_fbank", lambda *a, **k: torch.from_numpy(np.array(fbank)))
    got, _ = tab.seamless_features(x, max_frames=max_frames, device=CPU)
    want, _ = jab.seamless_features(x, max_frames=max_frames)
    assert np.abs(got - want).max() <= FRONT_ATOL


# ---------------------------------------------------------------------- VITS


def _vits_tree(seed=0):
    """JAX's VITS tree (``eval_shape`` of ``init_vits``) from a numpy seed:
    kernels N(0, 1/fan_in) (the flow's post convs too, which VITS zeroes, so
    the flow acts), biases N(0, 0.1²), norm scales 1 + N(0, 0.1²),
    embeddings N(0, 0.3²), the sinusoids exact."""
    g = np.random.default_rng(seed)
    shapes = jax.eval_shape(lambda: jvits.init_vits(jax.random.PRNGKey(0), VCFG))

    def draw(path, s):
        name = getattr(path[-1], "key", None)
        if name == "pos":
            return jcommon.sinusoid_position_embedding(VCFG.max_positions, VCFG.hidden)
        if name == "kernel":
            w = g.standard_normal(s.shape) / np.sqrt(np.prod(s.shape[:-1]))
        elif name == "scale":
            w = 1.0 + 0.1 * g.standard_normal(s.shape)
        elif name == "bias":
            w = 0.1 * g.standard_normal(s.shape)
        else:
            w = 0.3 * g.standard_normal(s.shape)
        return w.astype(np.float32)

    return jax.tree_util.tree_map_with_path(draw, shapes)


@pytest.fixture(scope="module")
def vits():
    tree = _vits_tree()
    return jax.tree.map(jnp.asarray, tree), tvits.from_jax_params(tree, CPU)


def _text(texts, max_chars=40):
    tokens = np.zeros((len(texts), max_chars), np.int32)
    mask = np.zeros((len(texts), max_chars), bool)
    for i, t in enumerate(texts):
        ids = np.frombuffer(t.encode(), np.uint8)[:max_chars]
        tokens[i, :len(ids)] = ids
        mask[i, :max(len(ids), 1)] = True
    return tokens, mask


TEXTS = ["Hello there.", "Un peu plus long, avec des accents: é à ü."]


def test_vits_encode_text_matches_jax(vits):
    jt, tp = vits
    tokens, mask = _text(TEXTS)
    _close(tvits.encode_text(tp, TVCFG, torch.from_numpy(tokens), torch.from_numpy(mask)),
           jax.jit(jvits.encode_text, static_argnums=1)(jt, VCFG, jnp.asarray(tokens),
                                                         jnp.asarray(mask)))


@pytest.mark.parametrize("max_frames", [MAX_FRAMES, 12], ids=["fits", "cut"])
def test_vits_synthesize_matches_jax_with_its_noise(vits, max_frames):
    """``synthesize`` with JAX's ε (``normal(PRNGKey(0))`` at the upsampled
    prior's shape) injected: the wave within 1e-4 of its peak and the valid
    samples equal; a horizon shorter than the durations cuts both alike."""
    jt, tp = vits
    tokens, mask = _text(TEXTS)
    fn = jax.jit(jvits.synthesize, static_argnums=1, static_argnames="max_frames")
    key = jax.random.PRNGKey(0)
    wave, n = fn(jt, VCFG, jnp.asarray(tokens), jnp.asarray(mask), max_frames=max_frames,
                 key=key)
    eps = np.array(jax.random.normal(key, (2, max_frames, VCFG.inter_channels), jnp.float32))
    got, got_n = tvits.synthesize(tp, TVCFG, torch.from_numpy(tokens), torch.from_numpy(mask),
                                  max_frames=max_frames, eps=torch.from_numpy(eps))
    _close(got, wave)
    assert got_n.tolist() == np.asarray(n).tolist()


def test_vits_bf16_casts_follow_jax(vits, monkeypatch):
    """A bf16 tree (``VitsTTSModel``'s dtype): every dense layer, norm,
    attention, MLP, the flow's inverse and the generator take and give JAX's
    dtypes, call for call (JAX's traced by ``jax.eval_shape``); ε enters in
    bf16 in both."""
    jt, tp = vits
    jt16 = jax.tree.map(lambda a: a.astype(jnp.bfloat16), jt)
    tp16 = jax.tree.map(lambda t: t.to(torch.bfloat16), tp)
    tokens, mask = _text(TEXTS[:1])
    names = ("dense", "layer_norm", "mha", "mlp", "flow_inverse", "generator_decode",
             "hard_upsample")
    calls = {"jax": [], "port": []}

    def spy(module, label):
        for name in names:
            fn = getattr(module, name)

            def wrapped(*args, _fn=fn, _name=name, **kw):
                out = _fn(*args, **kw)
                outs = out if isinstance(out, tuple) else (out,)
                calls[label].append((_name, tuple(str(a.dtype).replace("torch.", "")
                                                  for a in args if hasattr(a, "shape")),
                                     tuple(str(o.dtype).replace("torch.", "") for o in outs)))
                return out
            monkeypatch.setattr(module, name, wrapped)

    spy(jvits, "jax")
    spy(tvits, "port")
    key = jax.random.PRNGKey(0)
    jax.eval_shape(lambda t: jvits.synthesize(t, VCFG, jnp.asarray(tokens), jnp.asarray(mask),
                                              max_frames=8, key=key), jt16)
    eps = jax.random.normal(key, (1, 8, VCFG.inter_channels), jnp.bfloat16)
    with torch.no_grad():
        tvits.synthesize(tp16, TVCFG, torch.from_numpy(tokens), torch.from_numpy(mask),
                         max_frames=8, eps=torch.from_numpy(np.asarray(eps, np.float32)).bfloat16())
    ints = {"int32", "int64"}      # index and count tensors: JAX int32, torch int32/64
    norm = lambda seq: [(n, tuple("int" if d in ints else d for d in i),
                         tuple("int" if d in ints else d for d in o)) for n, i, o in seq]
    assert len(calls["jax"]) > 10
    assert norm(calls["port"]) == norm(calls["jax"])


def test_vits_model_contract(monkeypatch):
    """JAX's VitsTTSModel contract, on the port's: a weightless bf16
    instance seeded per language (``crc32("vits:<lang>")``), audio whose
    length scales with the text, peak-limited to 0.95; another language
    gives other weights, the same language the same ones."""
    seen = []
    init = tvits.init_vits
    monkeypatch.setattr(tvits, "init_vits", lambda seed, *a, **k: seen.append(seed) or
                        init(seed, *a, **k))
    tts = tvits.VitsTTSModel("fra", device=CPU, max_frames=256)
    assert tts.weightless and tts.sample_rate == 22_050
    assert tts.params["embed"].dtype == torch.bfloat16
    short = tts.synthesize("Hi.")
    long = tts.synthesize("This considerably longer sentence should synthesize "
                          "a considerably longer waveform than the short one.")
    assert len(long) > 2 * len(short) and np.abs(long).max() <= 0.95 + 1e-6
    assert np.isfinite(long).all() and long.dtype == np.float32
    assert np.array_equal(tts.synthesize("Hi."), short)        # ε seeded alike every call
    other = tvits.VitsTTSModel("deu", device=CPU, max_frames=256)
    assert not torch.equal(tts.params["embed"], other.params["embed"])
    assert torch.equal(tts.params["embed"],
                       tvits.VitsTTSModel("fra", device=CPU, max_frames=256).params["embed"])
    import zlib
    assert seen[:2] == [zlib.crc32(f"vits:{lang}".encode()) & 0x7FFFFFFF
                        for lang in ("fra", "deu")]


# ------------------------------------------------------------------- ESPnet


class EmptyAsr:
    weightless = False

    def transcribe(self, audio, language=None):
        return {"text": "", "words": []}


class TextAsr(EmptyAsr):
    def transcribe(self, audio, language=None):
        return {"text": f"  heard {len(audio)} samples in {language}  ", "words": []}


@pytest.mark.parametrize("asr", [EmptyAsr, TextAsr], ids=["empty", "text"])
def test_espnet_backend_matches_jax(asr):
    """Injected factories in both packages (each its own FakeTts at 24 kHz,
    so the backend resamples to 16 kHz): the transcripts (the fallback text
    when the ASR hears nothing) equal, the audio within 1e-4 of its peak,
    one model a language cached."""
    out = {}
    for name, ab, eng in (("jax", jab, jengines), ("port", tab, tengines)):
        loads = []
        kw = {"device": CPU} if ab is tab else {}
        backend = ab.ESPnetBackend(asr_factory=lambda lang: loads.append(lang) or asr(),
                                   tts_factory=lambda lang: eng.FakeTts(), **kw)
        backend.initialize()
        assert backend.initialized and backend.weights_info() == "random"
        out[name] = [backend.translate_speech(speech(), "eng", "fra"),
                     backend.translate_speech(speech(1.0), "eng", "fra"),
                     backend.translate_speech(speech(), "deu", "fra")]
        assert loads == ["eng", "deu"]
        assert backend.weights_info() == "random"            # FakeTts carries no flag
        assert backend.get_supported_languages() == jab.supported_languages()
    for got, want in zip(out["port"], out["jax"]):
        assert got["transcripts"] == want["transcripts"]
        assert got["audio"].dtype == np.float32 and got["audio"].shape[0] == 1
        _close(got["audio"], want["audio"])
    if asr is EmptyAsr:
        assert out["port"][0]["transcripts"]["source"] == tab.ESPnetBackend.FALLBACK_TEXT


def test_espnet_weights_info_follows_the_cached_models():
    class Loaded:
        weightless = False
        sample_rate = 16_000

        def synthesize(self, text, language=None):
            return np.zeros(160, np.float32)

    b = tab.ESPnetBackend(asr_factory=lambda lang: Loaded(), tts_factory=lambda lang: Loaded(),
                          device=CPU)
    assert b.weights_info() == "random"                 # nothing cached yet
    b._load_asr_model("eng")
    b._load_tts_model("fra")
    assert b.weights_info() == "loaded"
    b._tts_models["deu"] = object()                     # no flag: counted random
    assert b.weights_info() == "random"


def test_espnet_default_factories_build_the_ports_engines(tmp_path, monkeypatch):
    """The default ASR is the port's Whisper engine (``WhisperConfig.tiny()``
    random; the bake's ``asr/`` under EST_MODELS_DIR, weights loaded), the
    default TTS a VitsTTSModel a language; both cached."""
    from expressive_speech_translation_tpu_torch.models import loaders as tld
    from expressive_speech_translation_tpu_torch.models import whisper as twh
    from expressive_speech_translation_tpu_torch.pipeline.torch_engines import TorchWhisperAsr

    monkeypatch.delenv("EST_MODELS_DIR", raising=False)
    b = tab.ESPnetBackend(device=CPU)
    asr = b._load_asr_model("eng")
    assert isinstance(asr, TorchWhisperAsr) and asr.weightless
    assert asr.cfg == twh.WhisperConfig.tiny() and b._load_asr_model("eng") is asr
    tts = b._load_tts_model("fra")
    assert isinstance(tts, tvits.VitsTTSModel) and tts.language == "fra"
    assert b._load_tts_model("fra") is tts and b.weights_info() == "random"

    cfg = twh.WhisperConfig(d_model=32, encoder_layers=1, decoder_layers=1, heads=2, ffn_dim=64)
    tld.save_converted(twh.init_whisper(0, cfg, CPU), cfg, tmp_path / "asr")
    monkeypatch.setenv("EST_MODELS_DIR", str(tmp_path))
    baked = tab.ESPnetBackend(device=CPU)._load_asr_model("eng")
    assert not baked.weightless and baked.cfg == cfg


# ----------------------------------------------------------------- Seamless


@pytest.fixture(scope="module")
def seamless_pair():
    """(JAX's backend, the port's) over one toy tree (``_jax_tree``), f32:
    each package's ``cast_floats`` is the identity while ``initialize`` runs."""
    tree = _jax_tree()
    jb = jab.SeamlessBackend(params=jax.tree.map(jnp.asarray, tree), cfg=CFG, **SEAMLESS_KW)
    tb = tab.SeamlessBackend(params=tsm.from_jax_params(tree, CPU), cfg=TCFG, device=CPU,
                             **SEAMLESS_KW)
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(jcommon, "cast_floats", lambda tree, dtype: tree)
        mp.setattr(tcommon, "cast_floats", lambda tree, dtype: tree)
        jb.initialize()
        tb.initialize()
    assert jax.tree.leaves(tb._params)[0].dtype == torch.float32
    return jb, tb


def test_seamless_backend_matches_jax_in_f32(seamless_pair):
    """``translate_speech`` of 1.5 s: the transcript equal (the byte
    tokenizer over the same tokens), the tanh-limited audio within 1e-4 of
    its peak, the vocoder's length trimmed alike."""
    jb, tb = seamless_pair
    for seconds, target in ((1.5, "fra"), (0.7, "ell")):
        x = speech(seconds, seed=int(seconds * 10))
        want = jb.translate_speech(x, "eng", target)
        got = tb.translate_speech(x, "eng", target)
        assert got["transcripts"] == want["transcripts"]
        assert got["audio"].shape == want["audio"].shape and got["audio"].dtype == np.float32
        assert 0 < got["audio"].shape[1] <= SEAMLESS_KW["max_units"] * 2 * TCFG.hop_total
        _close(got["audio"], want["audio"])
        assert np.abs(got["audio"]).max() <= 1.0


def test_seamless_backend_casts_to_bf16_and_keeps_jaxs_contract():
    """Without the patch ``initialize`` casts the tree to bf16 (a random toy
    tree when none is given, with JAX's warning), the audio stays finite
    and tanh-limited within the vocoder's horizon; the language maps are
    strict where a checkpoint gives them; the weights label follows the
    tree given at construction."""
    b = tab.SeamlessBackend(device=CPU, **SEAMLESS_KW)
    assert b.weights_info() == "random" and b.cfg == TCFG and b.is_language_supported("ell")
    b.initialize()
    assert {t.dtype for t in jax.tree.leaves(b._params) if t.is_floating_point()} == \
        {torch.bfloat16}
    out = b.translate_speech(speech(1.0), "eng", "fra")
    assert np.isfinite(out["audio"]).all() and np.abs(out["audio"]).max() <= 1.0
    assert 0 < out["audio"].shape[1] <= 32 * 2 * 16
    assert b.get_supported_languages() == jab.SeamlessBackend().get_supported_languages()
    maps = {"text_decoder_lang_to_code_id": {"__fra__": 42, "ell": 7},
            "vocoder_lang_code_to_id": {"fra": 3, "ell": 1}}
    for lang in ("fra", "ell"):
        assert tab.SeamlessBackend(aux_maps=maps, device=CPU)._lang_ids(lang) == \
            jab.SeamlessBackend(aux_maps=maps)._lang_ids(lang)
    with pytest.raises(ValueError, match="deu"):
        tab.SeamlessBackend(aux_maps=maps, device=CPU)._lang_ids("deu")
    assert tab.SeamlessBackend(device=CPU)._lang_ids("deu") == (0, 0)


def test_the_backends_run_on_the_card_unless_told(monkeypatch):
    """No device → the card; with none the constructors raise, as every
    entry point of the port does."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    for make in (tab.SeamlessBackend, tab.ESPnetBackend, lambda: tvits.VitsTTSModel("fra"),
                 lambda: tab.seamless_features(np.zeros(800, np.float32))):
        with pytest.raises(RuntimeError, match="no CUDA device"):
            make()


# -------------------------------------------------------------------- routes


def _apps(tmp_path, seamless_pair):
    jb, tb = seamless_pair
    jm, tm = jbackend.TranslationManager(), tbackend.TranslationManager()
    jm.register_backend("cascaded", JCascaded(jengines.fake_engines()), is_default=True)
    tm.register_backend("cascaded", TCascaded(tengines.fake_engines()), is_default=True)
    jm.register_backend("seamless", jb)
    tm.register_backend("seamless", tb)
    jm.register_backend("espnet", jab.ESPnetBackend(
        asr_factory=lambda l: EmptyAsr(), tts_factory=lambda l: jengines.FakeTts()))
    tm.register_backend("espnet", tab.ESPnetBackend(
        asr_factory=lambda l: EmptyAsr(), tts_factory=lambda l: tengines.FakeTts(), device=CPU))
    jcfg = jconfig.load_config(env={}, temp_dir=str(tmp_path / "jax"))
    tcfg = tconfig.load_config(env={}, temp_dir=str(tmp_path / "port"))
    return (Client(japp.create_app(manager=jm, config=jcfg)),
            Client(tapp.create_app(manager=tm, config=tcfg, device=CPU)))


def _pcm16(b64):
    raw = base64.b64decode(b64)
    assert raw[:4] == b"RIFF"
    return np.frombuffer(raw[44:], "<i2").astype(np.int32)


def test_the_routes_serve_the_alternates_as_jax_does(tmp_path, seamless_pair):
    """Through each package's ``create_app(manager=...)`` (werkzeug test
    Client): ``/available-backends`` lists and labels the alternates alike
    (Seamless "loaded", ESPnet "random", the fakes "fake");
    ``/translate`` with ``backend=seamless`` and ``backend=espnet`` answers
    with JAX's transcripts, weights label and audio (PCM16) within one
    code."""
    jc, tc = _apps(tmp_path, seamless_pair)
    jr, tr = jc.get("/available-backends"), tc.get("/available-backends")
    assert jr.status_code == tr.status_code == 200
    assert tr.get_json() == jr.get_json()
    assert tr.get_json()["weights"] == {"cascaded": "fake", "seamless": "loaded",
                                        "espnet": "random"}
    wav = tapp.wav_bytes(speech(1.5), 16_000)
    for name in ("seamless", "espnet"):
        form = {"target_language": "fra", "source_language": "eng", "backend": name}
        jr = jc.post("/translate", data={**form, "file": (io.BytesIO(wav), "a.wav")})
        tr = tc.post("/translate", data={**form, "file": (io.BytesIO(wav), "a.wav")})
        assert jr.status_code == tr.status_code == 200, (jr.get_data(), tr.get_data())
        jj, tj = jr.get_json(), tr.get_json()
        assert tj["transcripts"] == jj["transcripts"] and tj["weights"] == jj["weights"]
        got, want = _pcm16(tj["audio"]), _pcm16(jj["audio"])
        assert got.shape == want.shape and got.size > 0
        assert np.abs(got - want).max() <= 1
