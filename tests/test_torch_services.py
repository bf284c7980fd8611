"""The split deployment against the JAX package on the CPU: the four model
services, their clients, ``create_app(mode="remote")``, the URL fetcher and
speaker similarity.

- Services: the port's and JAX's, each over its own fakes, on
  ``tests/test_model_services.py``'s requests: equal status codes and JSON
  (request and error ids aside), WAV bodies within one PCM16 code; the
  OpenVoice service on one shared toy tree, and its bake pickup.
- Clients: the codec bit for bit, each client against its service (port with
  port, JAX with JAX) on ``tests/test_clients.py``'s calls, health retries
  under a flaky transport, the HTTP transport over a real localhost server,
  ``remote_engines`` over a toy port TTS with its noise pinned (equal to the
  in-process engine within PCM16's step), ``create_app(mode="remote",
  device="cpu")`` with ``HttpTransport`` patched to a ``WsgiTransport`` as
  JAX's test does, and the container entry point's TTS (JAX's serves
  ``FakeTts``; the port's its own engine).
- Fetcher: ``tests/test_media_fetcher.py``'s local server and resolver
  patches: the same arrays, rates, error classes, user messages and SSRF
  refusals; the yt-dlp dispatch with ``shutil.which`` and ``subprocess.run``
  patched; the port app's default fetcher.
- ``speaker_similarity`` against JAX's on one ECAPA tree.
"""

import io
import json
import logging
import shutil
import socket
import subprocess
import tempfile
import threading
import wave

import jax
import numpy as np
import pytest
import torch
from werkzeug.serving import make_server
from werkzeug.test import Client
from werkzeug.wrappers import Request, Response

from expressive_speech_translation_tpu.core import errors as jerrors
from expressive_speech_translation_tpu.evals import acoustic_metrics as jam
from expressive_speech_translation_tpu.models import ecapa as jec
from expressive_speech_translation_tpu.models import openvoice as jov
from expressive_speech_translation_tpu.serve import clients as jcl
from expressive_speech_translation_tpu.serve import media_fetcher as jmf
from expressive_speech_translation_tpu.serve import model_services as jms
from expressive_speech_translation_tpu_torch.core import config as tconfig
from expressive_speech_translation_tpu_torch.core import errors as terrors
from expressive_speech_translation_tpu_torch.evals import acoustic_metrics as tam
from expressive_speech_translation_tpu_torch.media import native as tnative
from expressive_speech_translation_tpu_torch.models import cosyvoice as tcv
from expressive_speech_translation_tpu_torch.models import ecapa as tec
from expressive_speech_translation_tpu_torch.models import loaders as tld
from expressive_speech_translation_tpu_torch.models import nllb as tnl
from expressive_speech_translation_tpu_torch.models import openvoice as tov
from expressive_speech_translation_tpu_torch.models import qwen2 as tq2
from expressive_speech_translation_tpu_torch.models import whisper as twh
from expressive_speech_translation_tpu_torch.pipeline import engines as tengines
from expressive_speech_translation_tpu_torch.pipeline import torch_engines as te
from expressive_speech_translation_tpu_torch.pipeline.cascaded import CascadedBackend
from expressive_speech_translation_tpu_torch.serve import app as tapp
from expressive_speech_translation_tpu_torch.serve import clients as tcl
from expressive_speech_translation_tpu_torch.serve import media_fetcher as tmf
from expressive_speech_translation_tpu_torch.serve import model_services as tms

from test_openvoice_convert import CFG as OV_CFG

# JAX's OpenVoice service takes the spectrogram at the default n_fft (1024)
# whatever the tree's config, so the services share a toy tree at 513 bins
OV_SVC_CFG = jov.OpenVoiceConfig(**{**OV_CFG.__dict__, "n_spec": 513})
OV_OUT_GAIN = 300.0

CPU = "cpu"
PCM_LSB = 1          # WAV bodies: at most one PCM16 code apart
PCM_STEP = 1.0 / 32767
# speaker similarity, port against JAX on one tree: the Kaldi fbank's f32
# DFT differs from XLA's in the quietest bands (tests/test_torch_conditioning.py)
SIMILARITY_ATOL = 1e-4
IDS = ("request_id", "error_id")


def wav_bytes(freq=220.0, seconds=1.0, sr=16000):
    t = np.arange(int(sr * seconds)) / sr
    pcm = (0.4 * np.sin(2 * np.pi * freq * t) * 32767).astype("<i2")
    buf = io.BytesIO()
    with wave.open(buf, "wb") as w:
        w.setnchannels(1)
        w.setsampwidth(2)
        w.setframerate(sr)
        w.writeframes(pcm.tobytes())
    return buf.getvalue()


def tone(freq=220.0, seconds=2.0, sr=16000):
    t = np.arange(int(sr * seconds)) / sr
    return (0.3 * np.sin(2 * np.pi * freq * t)).astype(np.float32)


def _pcm(body: bytes) -> np.ndarray:
    assert body[:4] == b"RIFF"
    return np.frombuffer(body[44:], "<i2").astype(np.int32)


def _same(jc, tc, method, path, *, wav=False, files=None, **kw):
    """The same request to both services (multipart files rebuilt for each):
    equal status, mimetype and JSON apart from ids, or WAV bodies within
    PCM_LSB (headers equal)."""
    def send(c):
        data = dict(kw.get("data", {}))
        for k, (raw, name) in (files or {}).items():
            data[k] = (io.BytesIO(raw), name)
        extra = {k: v for k, v in kw.items() if k != "data"}
        return getattr(c, method)(path, data=data, **extra)

    want, got = send(jc), send(tc)
    assert got.status_code == want.status_code, (got.get_data()[:300], want.get_data()[:300])
    assert got.mimetype == want.mimetype
    if want.mimetype == "application/json":
        g, w = got.get_json(), want.get_json()
        assert set(g) == set(w)
        for k in IDS:
            if k in w:
                assert len(g[k]) == len(w[k]) == 8
        assert {k: v for k, v in g.items() if k not in IDS} == \
            {k: v for k, v in w.items() if k not in IDS}
    elif wav:
        gb, wb = got.get_data(), want.get_data()
        assert gb[:44] == wb[:44]
        g, w = _pcm(gb), _pcm(wb)
        assert g.shape == w.shape and np.abs(g - w).max(initial=0) <= PCM_LSB
    else:
        assert got.get_data() == want.get_data()
    return got


# ------------------------------------------------------------------ services


def test_cosyvoice_service_matches_jax():
    jc, tc = Client(jms.CosyVoiceService()), Client(tms.CosyVoiceService(device=CPU))
    _same(jc, tc, "get", "/health")
    for sr in (16_000, 22_050):              # 22.05 kHz: the reference is resampled
        _same(jc, tc, "post", "/generate-speech/", wav=True,
              data={"text": "hello from the service", "style_prompt": "calm"},
              files={"reference_audio": (wav_bytes(sr=sr), "ref.wav")})
    _same(jc, tc, "post", "/generate-speech/", wav=True, data={"text": "γειά", "model": "greek"})
    r = _same(jc, tc, "get", "/health")
    assert set(r.get_json()["models_loaded"]) == {"default", "greek"}
    _same(jc, tc, "post", "/generate-speech/", data={})                   # no text: 400
    _same(jc, tc, "get", "/nowhere")                                      # 404
    r = _same(jc, tc, "post", "/generate-speech/", wav=True,
              data={"text": "streaming hello", "stream": "true"})
    assert r.get_data()[4:8] == b"\xff\xff\xff\xff"


class FakeVideoIO:
    def extract_audio(self, p):
        return np.zeros(16000, np.float32), 16000

    def mux(self, p, a, sr, o):
        open(o, "wb").write(b"MUXED" + np.asarray(a, np.float32).tobytes()[:2000])

    def lipsync(self, p, a, sr, o):
        open(o, "wb").write(b"LIPSYNCED" + np.asarray(a, np.float32).tobytes()[:2000])


class FailingLipsync(FakeVideoIO):
    def lipsync(self, p, a, sr, o):
        raise RuntimeError("no model")


@pytest.mark.parametrize("vio", [FakeVideoIO, FailingLipsync])
def test_musetalk_service_matches_jax(vio):
    jc, tc = Client(jms.MuseTalkService(video_io=vio())), Client(tms.MuseTalkService(vio()))
    files = {"video": (b"vid" * 100, "in.mp4"), "audio": (wav_bytes(), "a.wav")}
    r = _same(jc, tc, "post", "/lipsync-video/", files=files)
    assert r.mimetype == "video/mp4"
    assert r.get_data().startswith(b"LIPSYNCED" if vio is FakeVideoIO else b"MUXED")
    _same(jc, tc, "post", "/lipsync-video/", files={"video": (b"v", "in.mp4")})
    _same(jc, tc, "get", "/health")


def test_similarity_service_matches_jax():
    def scorer(a, b):
        n = min(len(a), len(b))
        return float(np.dot(a[:n], b[:n]) /
                     (np.linalg.norm(a[:n]) * np.linalg.norm(b[:n]) + 1e-9))

    jc, tc = Client(jms.SimilarityService(scorer=scorer)), Client(tms.SimilarityService(scorer))
    for f in (220, 333):
        r = _same(jc, tc, "post", "/compare-voices/",
                  files={"audio1": (wav_bytes(220), "a.wav"), "audio2": (wav_bytes(f), "b.wav")})
    assert r.get_json()["similarity"] < 0.99
    _same(jc, tc, "post", "/compare-voices/", files={"audio1": (wav_bytes(), "a.wav")})
    _same(jc, tc, "get", "/health")


def test_openvoice_service_with_a_converter_matches_jax():
    def converter(src, src_sr, ref, ref_sr):
        return src * 0.5

    jc = Client(jms.OpenVoiceService(converter=converter))
    tc = Client(tms.OpenVoiceService(converter, device=CPU))
    _same(jc, tc, "get", "/status")
    _same(jc, tc, "post", "/clone-voice", wav=True,
          files={"source_audio": (wav_bytes(220), "s.wav"),
                 "reference_audio": (wav_bytes(300), "r.wav")})
    _same(jc, tc, "post", "/clone-voice", files={"source_audio": (wav_bytes(), "s.wav")})


@pytest.fixture(scope="module")
def ov_tree():
    """A toy JAX OpenVoice tree (its flow posts drawn, its output conv
    scaled so that the random generator's waveform spans the PCM16 range)
    and the port's copy."""
    tree = jax.tree.map(np.array, jov.init_openvoice(jax.random.PRNGKey(3), OV_SVC_CFG))
    g = np.random.default_rng(4)
    for layer in tree["flow"]:
        layer["post"]["kernel"] = g.normal(0, 0.3, layer["post"]["kernel"].shape).astype(np.float32)
    tree["dec"]["conv_post"]["kernel"] *= OV_OUT_GAIN
    return tree, tov.from_jax_params(tree, CPU)


def test_openvoice_service_and_client_convert_like_jax_on_one_tree(ov_tree):
    """Both services on one toy tree: 16 kHz uploads (the client's own WAV
    encoding) resampled to 22.05 kHz by each package's resampler, the output
    WAVs within one PCM16 code; the port's client reads the same audio back."""
    jsvc, tsvc = jms.OpenVoiceService(), tms.OpenVoiceService(device=CPU)
    jsvc._params, jsvc._cfg = ov_tree[0], OV_SVC_CFG
    tsvc._params, tsvc._cfg = ov_tree[1], tov.OpenVoiceConfig(**OV_SVC_CFG.__dict__)
    src, ref = tone(seconds=0.5), tone(300.0, 0.5)
    r = _same(Client(jsvc), Client(tsvc), "post", "/clone-voice", wav=True,
              files={"source_audio": (tcl._wav_bytes(src, 16_000), "src.wav"),
                     "reference_audio": (tcl._wav_bytes(ref, 16_000), "ref.wav")})
    assert np.abs(_pcm(r.get_data())).max() > 1_000
    _same(Client(jsvc), Client(tsvc), "get", "/status")
    client = tcl.OpenVoiceClient(tcl.WsgiTransport(tsvc), retries=1, retry_delay_s=0)
    assert client.check_health() and client.status()["model_loaded"]
    out, sr = client.clone(src, 16_000, ref, 16_000)
    want, want_sr = tcl._parse_wav_bytes(r.get_data())
    assert sr == want_sr == 22_050 and np.array_equal(out, want)


def test_openvoice_service_picks_up_the_bake(ov_tree, tmp_path, monkeypatch, caplog):
    cfg = tov.OpenVoiceConfig(**OV_SVC_CFG.__dict__)
    tld.save_converted(ov_tree[1], cfg, tmp_path / "openvoice")
    monkeypatch.setenv("EST_MODELS_DIR", str(tmp_path))
    svc = tms.OpenVoiceService(device=CPU)
    with caplog.at_level(logging.INFO, logger=tms.__name__):
        out, sr = tcl.OpenVoiceClient(tcl.WsgiTransport(svc), retries=1, retry_delay_s=0).clone(
            tone(seconds=0.5), 16_000, tone(300.0, 0.5), 16_000)
    assert "baked converter" in caplog.text and svc._cfg == cfg
    assert sr == 22_050 and len(out) == ((11_025 - 256) // 256 + 1) * 256
    for a, b in zip(jax.tree.leaves(svc._params), jax.tree.leaves(ov_tree[1])):
        assert torch.equal(a, b)


# ------------------------------------------------------------------- clients


def test_the_client_codec_is_bit_equal_to_jax():
    x = np.concatenate([tone(), [1.5, -1.5, 0.0]]).astype(np.float32)
    body = tcl._wav_bytes(x, 16_000)
    assert body == jcl._wav_bytes(x, 16_000)
    for payload in (body, body[:4] + b"\xff\xff\xff\xff" + body[8:40] + b"\xff\xff\xff\xff"
                    + body[44:]):
        (got, sr), (want, jsr) = tcl._parse_wav_bytes(payload), jcl._parse_wav_bytes(payload)
        assert sr == jsr == 16_000 and got.dtype == want.dtype and np.array_equal(got, want)
    with pytest.raises(tcl.RemoteServiceError, match="not a WAV"):
        tcl._parse_wav_bytes(b"nope" * 20)


def _cosy(pkg):
    svc = jms.CosyVoiceService() if pkg is jcl else tms.CosyVoiceService(device=CPU)
    return pkg.CosyVoiceClient(pkg.WsgiTransport(svc), retries=1, retry_delay_s=0)


def test_cosyvoice_client_matches_jax():
    (jc, tc), text = (_cosy(jcl), _cosy(tcl)), "remote parity check"
    want, got = jc.synthesize(text, reference_audio_16k=tone()), tc.synthesize(
        text, reference_audio_16k=tone())
    assert tc.sample_rate == jc.sample_rate == 24_000
    np.testing.assert_allclose(got, want, atol=PCM_STEP)
    streamed = np.concatenate(list(tc.synthesize_streaming("streaming parity")))
    np.testing.assert_allclose(streamed, np.concatenate(list(
        jc.synthesize_streaming("streaming parity"))), atol=PCM_STEP)
    np.testing.assert_allclose(streamed, tc.synthesize("streaming parity"), atol=PCM_STEP)
    tc.warm_up()
    for c, error in ((jc, jcl.RemoteServiceError), (tc, tcl.RemoteServiceError)):
        with pytest.raises(error, match="CosyVoice API failed: 4"):
            c.synthesize("")


def test_health_retries_under_a_flaky_transport():
    class FlakyTransport:
        def __init__(self, inner, fail_times):
            self.inner, self.fails = inner, fail_times

        def get(self, path, *, timeout):
            if self.fails > 0:
                self.fails -= 1
                raise ConnectionError("not up yet")
            return self.inner.get(path, timeout=timeout)

        def post(self, *a, **kw):
            return self.inner.post(*a, **kw)

    for pkg, svc in ((jcl, jms.CosyVoiceService()), (tcl, tms.CosyVoiceService(device=CPU))):
        flaky = FlakyTransport(pkg.WsgiTransport(svc), fail_times=2)
        assert pkg.CosyVoiceClient(flaky, retries=3, retry_delay_s=0).check_health() is True
        flaky.fails = 99
        assert pkg.CosyVoiceClient(flaky, retries=2, retry_delay_s=0).check_health() is False


def test_the_musetalk_and_similarity_clients():
    """MuseTalk over the fake VideoIO through both packages' clients (equal
    bytes); similarity over one ECAPA tree, the score the direct one rounded
    to the response's 4 decimals."""
    jv, tv = (pkg.MuseTalkClient(pkg.WsgiTransport(svc), retries=1, retry_delay_s=0)
              for pkg, svc in ((jcl, jms.MuseTalkService(video_io=FakeVideoIO())),
                               (tcl, tms.MuseTalkService(FakeVideoIO()))))
    outs = []
    for client in (jv, tv):
        with tempfile.TemporaryDirectory() as tmp:
            open(f"{tmp}/in.mp4", "wb").write(b"vid" * 10)
            client.lipsync(f"{tmp}/in.mp4", tone(seconds=1.0), 16_000, f"{tmp}/out.mp4")
            outs.append(open(f"{tmp}/out.mp4", "rb").read())
    assert outs[0] == outs[1] and outs[0].startswith(b"LIPSYNCED")

    # the upload quantises to PCM16 (truncated ×32767, read back /32768):
    # scored directly on that audio, as tests/test_clients.py scores JAX's
    _, ttree, ecfg = _ecapa()
    a, b = tone(220.0), tone(220.5)
    remote = tcl.SimilarityClient(tcl.WsgiTransport(tms.SimilarityService(
        lambda x, y: tam.speaker_similarity(x, y, params=ttree, cfg=ecfg, device=CPU))),
        retries=1, retry_delay_s=0).compare(a, b)
    qa, qb = (np.trunc(np.clip(x, -1.0, 1.0) * 32767.0) / 32768.0 for x in (a, b))
    local = tam.speaker_similarity(qa, qb, params=ttree, cfg=ecfg, device=CPU)
    assert remote == round(local, 4) and 0.0 <= remote <= 1.0


def test_the_http_transport_over_a_localhost_server():
    pytest.importorskip("requests")
    logging.getLogger("werkzeug").setLevel(logging.WARNING)
    server = make_server("127.0.0.1", 0, tms.CosyVoiceService(device=CPU), threaded=True)
    thread = threading.Thread(target=server.serve_forever, daemon=True)
    thread.start()
    try:
        client = tcl.CosyVoiceClient(tcl.HttpTransport(f"http://127.0.0.1:{server.server_port}/"),
                                     retries=1, retry_delay_s=0)
        assert client.check_health()
        local = _cosy(tcl)
        np.testing.assert_allclose(client.synthesize("over the wire", reference_audio_16k=tone()),
                                   local.synthesize("over the wire"), atol=0)
        streamed = np.concatenate(list(client.synthesize_streaming("over the wire")))
        np.testing.assert_allclose(streamed, local.synthesize("over the wire"), atol=PCM_STEP)
    finally:
        server.shutdown()
        server.server_close()
        thread.join(timeout=10)


# the port's tiny engines (the import check's configs), decode budgets short
TINY = dict(
    asr_cfg=twh.WhisperConfig(d_model=32, encoder_layers=1, decoder_layers=1, heads=2,
                              ffn_dim=64, vocab_size=365, max_target_positions=32,
                              eos_token=260, bos_token=261, lang_token_start=262,
                              task_transcribe=362, no_timestamps=363, sop_token=364,
                              no_speech_token=360),
    nmt_cfg=tnl.NLLBConfig(d_model=32, encoder_layers=1, decoder_layers=1, heads=2, ffn_dim=64,
                           vocab_size=384, max_positions=64),
    tts_cfg=tcv.CosyVoiceConfig(
        lm=tcv.SpeechLMConfig(backbone=tq2.Qwen2Config(hidden=32, layers=1, heads=2, kv_heads=1,
                                                      ffn_dim=64, max_positions=1024),
                              text_vocab=384, speech_token_size=32),
        flow=tcv.FlowConfig(token_vocab=35, dim=32, layers=1, heads=2),
        vocoder=tcv.VocoderConfig(base_channels=32)))


def _tiny_tts():
    return te.TorchCosyVoiceTts(TINY["tts_cfg"], device=CPU, dtype=torch.float32,
                                noise=lambda i: tcv.GeneratorNoise(7, CPU))


_TORCH_ENGINES = te.torch_engines


def _tiny_engines(**kw):
    eng = _TORCH_ENGINES(**{**kw, "device": CPU, "scale": "toy"}, **TINY, dtype=torch.float32)
    eng.asr.max_new_tokens = eng.nmt.max_new_tokens = 8
    return eng


def test_remote_engines_equal_the_in_process_tts():
    """Two toy TTS engines on one seeded tree with their noise pinned: one
    served by the port's CosyVoice service, one in-process. The reference
    crosses the wire as PCM16 (truncated ×32767, read back /32768), so the
    in-process engine gets that quantised reference."""
    remote = tcl.remote_engines(
        tcl.WsgiTransport(tms.CosyVoiceService({"default": _tiny_tts}, device=CPU)),
        asr=tengines.FakeAsr(), nmt=tengines.FakeNmt(), warm_up=False, retries=1,
        retry_delay_s=0)
    local = tengines.Engines(asr=tengines.FakeAsr(), nmt=tengines.FakeNmt(), tts=_tiny_tts())
    ref = tone(seconds=1.0)
    quantised = np.trunc(np.clip(ref, -1.0, 1.0) * 32767.0) / 32768.0
    got = remote.tts.synthesize("bonjour le monde", reference_audio_16k=ref)
    want = local.tts.synthesize("bonjour le monde", reference_audio_16k=quantised)
    assert got.shape == want.shape and np.abs(want).max() > 1e-3
    np.testing.assert_allclose(got, np.clip(want, -1, 1), atol=PCM_STEP)
    out_r = CascadedBackend(remote).translate_speech(tone(seconds=2.0), "eng", "fra",
                                                     use_voice_cloning=False)
    out_l = CascadedBackend(local).translate_speech(tone(seconds=2.0), "eng", "fra",
                                                    use_voice_cloning=False)
    assert out_r["transcripts"] == out_l["transcripts"]
    a, b = out_l["audio"].reshape(-1), out_r["audio"].reshape(-1)
    assert a.shape == b.shape
    # the loudness normalisation and the temporal mapping amplify the PCM16
    # step, as tests/test_clients.py bounds JAX's
    assert np.abs(a - b).max() <= 0.03 and np.sqrt(np.mean((a - b) ** 2)) < 1e-3


def test_create_app_remote_mode(monkeypatch):
    """engines.mode=remote wires the split deployment from the config alone:
    the port's ASR and NMT on the device, the TTS a CosyVoiceClient of
    endpoints.cosyvoice_url (here a WsgiTransport, as JAX's test patches it),
    health retries from the endpoints config, warmed up over the wire."""
    seen, urls = {}, []
    svc = tms.CosyVoiceService(device=CPU)

    def engines(**kw):
        seen.update(kw)
        return _tiny_engines(**kw)

    monkeypatch.setattr(te, "torch_engines", engines)
    monkeypatch.setattr(tcl, "HttpTransport", lambda url: urls.append(url) or tcl.WsgiTransport(svc))
    cfg = tconfig.load_config(env={}, **{"engines.mode": "remote", "engines.scale": "toy",
                                         "endpoints.cosyvoice_url": "http://tts:8002",
                                         "endpoints.health_backoff_seconds": 0.0})
    app = tapp.create_app(config=cfg, device=CPU)
    assert urls == ["http://tts:8002"] and seen["device"] == CPU and seen["scale"] == "toy"
    assert svc._models and "default" in svc._models        # the warm-up went over the wire
    b = app.manager.get_backend()
    assert type(b.engines.tts).__name__ == "CosyVoiceClient"
    assert type(b.engines.asr).__name__ == "TorchWhisperAsr"
    assert type(b.engines.nmt).__name__ == "TorchNllbNmt"
    assert b.engines.tts.synthesize("bonjour", reference_audio_16k=tone()).size > 1000
    r = Client(app).get("/health/model").get_json()
    assert r["weights"] == "random" and r["placement"]["tts"] == []


def test_the_cosyvoice_entry_point_serves_the_ports_tts(monkeypatch):
    """JAX's ``run_service("cosyvoice")`` builds its service with no factory,
    so the container serves FakeTts; the port's gives "default" its own TTS
    engine (here the toy engines on the CPU). ``run_simple`` is patched to
    hand back the app instead of serving."""
    import werkzeug.serving

    from expressive_speech_translation_tpu import core as jcore
    from expressive_speech_translation_tpu.core import platform as jplatform
    from expressive_speech_translation_tpu.pipeline.engines import FakeTts as JFakeTts

    served = []
    monkeypatch.setattr(werkzeug.serving, "run_simple",
                        lambda host, port, app, **kw: served.append((host, port, app)))
    monkeypatch.setattr(jcore, "enable_persistent_compilation_cache", lambda *a, **k: None)
    monkeypatch.setattr(jplatform, "pin_platform_from_env", lambda *a, **k: None)
    jms.run_service("cosyvoice")
    host, port, japp = served.pop()
    assert (host, port) == ("0.0.0.0", 8002) and isinstance(japp.get_model("default"), JFakeTts)

    monkeypatch.setattr(te, "torch_engines", _tiny_engines)
    tms.run_service("cosyvoice", device=CPU)
    host, port, tapp_ = served.pop()
    assert (host, port) == ("0.0.0.0", 8002)
    assert isinstance(tapp_.get_model("default"), te.TorchCosyVoiceTts)
    assert "default" in tapp_._models                         # warmed up at start
    for name, cls, port in (("similarity", tms.SimilarityService, 8001),
                            ("openvoice", tms.OpenVoiceService, 8004)):
        tms.run_service(name, 9000, device=CPU)
        assert served[-1][1] == 9000 and isinstance(served[-1][2], cls)
        assert tms.SERVICES[name] == port
    with pytest.raises(ValueError, match="unknown service"):
        tms.build_service("seamless", CPU)


def test_services_need_the_card():
    if torch.cuda.is_available():
        pytest.skip("this host has a CUDA device; the default device is valid here")
    for make in (tms.CosyVoiceService, tms.SimilarityService, tms.OpenVoiceService):
        with pytest.raises(RuntimeError, match="no CUDA device"):
            make()
    with pytest.raises(RuntimeError, match="no CUDA device"):
        tam.speaker_similarity(tone(), tone())


# --------------------------------------------------------- speaker similarity


def _ecapa():
    ecfg = jec.EcapaConfig(channels=16, mfa_out=48, bottleneck=8, attn_channels=8)
    jtree = jec.init_ecapa(jax.random.PRNGKey(1), ecfg)
    ttree = tec.from_jax_params(jax.tree.map(np.asarray, jtree), CPU)
    return jtree, ttree, tec.EcapaConfig(**ecfg.__dict__)


def test_speaker_similarity_matches_jax_on_one_tree():
    jtree, ttree, cfg = _ecapa()
    a, b = tone(220.0, 1.5), tone(233.0, 1.0) + 0.05 * tone(900.0, 1.0)
    want = jam.speaker_similarity(a, b, params=jtree, cfg=jec.EcapaConfig(**cfg.__dict__))
    got = tam.speaker_similarity(a, b, params=ttree, cfg=cfg, device=CPU)
    assert abs(got - want) <= SIMILARITY_ATOL
    assert tam.speaker_similarity(a, a, params=ttree, cfg=cfg, device=CPU) == pytest.approx(1.0)
    # no tree: the seeded default, drawn once per configuration and device
    first = tam.speaker_similarity(a, b, cfg=cfg, device=CPU)
    assert tam.speaker_similarity(a, b, cfg=cfg, device=CPU) == first
    assert tam._default_ecapa.cache_info().currsize >= 1
    x = tone(200.0, 3.0)
    assert tam.f0_statistics(x) == jam.f0_statistics(x)
    assert tam.rms_intensity(x) == jam.rms_intensity(x)


# -------------------------------------------------------------------- fetcher


@pytest.fixture(scope="module")
def media_server():
    payload = wav_bytes(seconds=1.0)

    @Request.application
    def app(request):
        if request.path == "/clip.wav":
            return Response(payload, mimetype="audio/wav")
        if request.path == "/big.wav":
            return Response(b"\x00" * (2 * 1024 * 1024), mimetype="audio/wav")
        if request.path == "/nothing.wav":
            return Response(b"", mimetype="audio/wav")
        if request.path == "/page.html":
            return Response(b"<html>not media</html>", mimetype="text/html")
        return Response("nope", status=404)

    logging.getLogger("werkzeug").setLevel(logging.WARNING)
    srv = make_server("127.0.0.1", 0, app, threaded=True)
    thread = threading.Thread(target=srv.serve_forever, daemon=True)
    thread.start()
    yield f"http://127.0.0.1:{srv.server_port}"
    srv.shutdown()


def _both(fn):
    """fn(module, errors module) in each package → ("ok", value) or
    ("error", class name, str, user_message)."""
    out = []
    for mod, errs in ((jmf, jerrors), (tmf, terrors)):
        try:
            out.append(("ok", fn(mod)))
        except errs.MediaError as e:
            out.append(("error", type(e).__name__, str(e), e.to_payload()["error"]))
    return out


def _same_fetch(fn):
    want, got = _both(fn)
    if want[0] == "ok":
        (ja, jsr), (ta, tsr) = want[1], got[1]
        assert got[0] == "ok" and tsr == jsr and ta.dtype == ja.dtype and np.array_equal(ta, ja)
    else:
        assert got == want
    return got


@pytest.fixture(scope="module")
def shim():
    if tnative.toolchain()["g++"] is None or not all(tnative.toolchain()["headers"].values()):
        pytest.skip("the libav shim does not build without g++ and libav's headers")
    tnative.build()


def test_http_media_fetcher_matches_jax(media_server, shim):
    got = _same_fetch(lambda m: m.http_media_fetcher(f"{media_server}/clip.wav",
                                                     allow_private_hosts=True))
    assert got[1][1] == 16_000 and 15_000 < len(got[1][0]) <= 16_500
    for path, kw, what in (("missing.wav", {}, "HTTP 404"),
                           ("big.wav", {"max_bytes": 1024}, "exceeds"),
                           ("nothing.wav", {}, "empty download")):
        got = _same_fetch(lambda m: m.http_media_fetcher(f"{media_server}/{path}",
                                                         allow_private_hosts=True, **kw))
        assert got[0] == "error" and what in got[2]
    got = _same_fetch(lambda m: m.http_media_fetcher("ftp://x/y.wav", allow_private_hosts=True))
    assert "non-http" in got[2]


def test_ssrf_refusals_match_jax(media_server, monkeypatch):
    assert _same_fetch(lambda m: m.http_media_fetcher(f"{media_server}/clip.wav"))[0] == "error"
    for url in ("http://127.0.0.1/x.wav", "http://10.0.0.1/x.wav",
                "http://169.254.169.254/latest/meta-data", "http://[::1]/x.wav",
                "file:///etc/passwd"):
        got = _same_fetch(lambda m: m._resolve_public_host(url))
        assert got[0] == "error" and ("non-public address" in got[2] or "non-http" in got[2])

    def cgnat(host, port):
        return [(socket.AF_INET, socket.SOCK_STREAM, 6, "", ("100.64.0.5", 0))]

    monkeypatch.setattr(socket, "getaddrinfo", cgnat)
    assert "non-public" in _same_fetch(
        lambda m: m._resolve_public_host("http://evil.example/media.mp3"))[2]

    def dual(host, port):
        return [(socket.AF_INET6, socket.SOCK_STREAM, 6, "", ("2606:4700::1", 0, 0, 0)),
                (socket.AF_INET, socket.SOCK_STREAM, 6, "", ("93.184.216.34", 0))]

    monkeypatch.setattr(socket, "getaddrinfo", dual)
    want, got = _both(lambda m: m._resolve_public_host("http://ok.example/a.mp3"))
    assert got == want == ("ok", ["2606:4700::1", "93.184.216.34"])


def test_default_fetcher_dispatch_matches_jax(media_server, shim, monkeypatch):
    """A direct link downloads (resolver pinned to the loopback server); a
    platform page goes to yt-dlp when ``shutil.which`` finds it (the binary
    stood in by a ``subprocess.run`` that writes a WAV where ``-o`` points),
    and fails clearly when not, or when yt-dlp fails or times out."""
    for mod in (jmf, tmf):
        monkeypatch.setattr(mod, "_resolve_public_host", lambda url: ["127.0.0.1"])
    _same_fetch(lambda m: m.default_fetcher(f"{media_server}/clip.wav"))

    monkeypatch.setattr(shutil, "which", lambda name: None)
    got = _same_fetch(lambda m: m.default_fetcher(f"{media_server}/page.html"))
    assert got[0] == "error" and "yt-dlp" in got[3]
    got = _same_fetch(lambda m: m.ytdlp_fetcher("https://youtube.com/watch?v=x"))
    assert "yt-dlp is not installed" in got[2]

    commands, mode = [], {"rc": 0}

    def fake_run(cmd, capture_output, timeout):
        commands.append((cmd[:-3], cmd[-1], timeout))
        if mode["rc"] == "timeout":
            raise subprocess.TimeoutExpired(cmd, timeout)
        if mode["rc"] == 0:
            open(cmd[cmd.index("-o") + 1] + ".wav", "wb").write(wav_bytes(330.0, 0.5, 22_050))
        return subprocess.CompletedProcess(cmd, mode["rc"], b"", b"ERROR: unsupported URL")

    monkeypatch.setattr(shutil, "which", lambda name: "/usr/local/bin/" + name)
    monkeypatch.setattr(subprocess, "run", fake_run)
    got = _same_fetch(lambda m: m.default_fetcher("https://www.youtube.com/watch?v=abc"))
    assert got[1][1] == 16_000 and abs(len(got[1][0]) - 8_000) <= 2
    assert commands[0] == commands[1] and commands[0][0][:2] == ["yt-dlp", "-f"]
    for rc, what in ((1, "yt-dlp failed"), ("timeout", "timed out")):
        mode["rc"] = rc
        got = _same_fetch(lambda m: m.ytdlp_fetcher("https://youtu.be/abc"))
        assert got[0] == "error" and what in got[2]


def test_the_port_app_takes_the_default_fetcher(tmp_path, monkeypatch):
    """The app's default fetcher answers a platform URL with yt-dlp's absence
    (``shutil.which`` patched, so no host ever runs the binary here)."""
    monkeypatch.setattr(shutil, "which", lambda name: None)
    app = tapp.create_app(config=tconfig.AppConfig(temp_dir=str(tmp_path)), device=CPU)
    assert app.url_fetcher is tmf.default_fetcher
    r = Client(app).post("/process-audio-url", json={"url": "https://youtu.be/abc",
                                                     "target_language": "fra"})
    assert r.status_code == 400 and "yt-dlp" in json.loads(r.get_data())["error"]
