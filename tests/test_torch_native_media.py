"""The port's libav shim (``media/native.py``, built from the port's own
``media/csrc/est_media.cpp`` into ``_build/``) against the JAX package's:
the same C++ source under both, so decoded frames and audio must be equal
on videos each shim encodes. Mirrors ``tests/test_media_native.py`` on clips
the tests make themselves. Skips only where g++ or libav's headers are
missing; a failed build fails."""

import io
import logging
import os
import subprocess
import sys
import textwrap
import threading

import numpy as np
import pytest
from werkzeug.test import Client

from expressive_speech_translation_tpu.media import native as jnative
from expressive_speech_translation_tpu_torch import media as tmedia
from expressive_speech_translation_tpu_torch.core.errors import MediaError
from expressive_speech_translation_tpu_torch.media import native
from expressive_speech_translation_tpu_torch.media.wavio import read_wav, write_wav

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


@pytest.fixture(scope="module")
def shim():
    tools = native.toolchain()
    missing = [p for p, ok in tools["headers"].items() if not ok]
    if tools["g++"] is None or missing:
        pytest.skip(f"g++ ({tools['g++']}) or libav's headers ({missing}) are missing here")
    path = native.build()
    assert native.available() and native._LIB is not None
    return path


def tone(freq=440.0, seconds=1.0, sr=16000):
    t = np.arange(int(sr * seconds)) / sr
    return (0.5 * np.sin(2 * np.pi * freq * t)).astype(np.float32)


def _peak_hz(x, sr):
    spec = np.abs(np.fft.rfft(x * np.hanning(len(x))))
    return np.argmax(spec) * sr / len(x)


def _clip(n=24, h=48, w=64, seed=1):
    g = np.random.default_rng(seed)
    return g.uniform(0, 255, (n, h, w, 3)).astype(np.uint8)


def test_the_library_is_the_ports_own_build(shim):
    assert shim.parent.name == "_build" and shim.name.startswith("libest_media-")
    assert "expressive_speech_translation_tpu_torch" in str(shim)
    assert os.path.realpath(native._LIB._name) == os.path.realpath(shim)


def test_decode_wav_matches_pure_python(shim, tmp_path):
    p = tmp_path / "t.wav"
    write_wav(p, tone(), 16000)
    a_native, sr_n = native.decode_audio(p)
    a_py, sr_p = read_wav(p)
    assert sr_n == sr_p == 16000
    np.testing.assert_allclose(a_native, a_py, atol=1e-4)


def test_decode_stereo_and_resample(shim, tmp_path):
    p = tmp_path / "st.wav"
    stereo = np.stack([tone(300.0, 1.0, 44_100), tone(500.0, 1.0, 44_100)])
    write_wav(p, stereo, 44_100)
    audio, sr = native.decode_audio(p)
    assert sr == 44_100 and audio.shape == (2, 44_100)
    mono16, sr16 = native.decode_audio(p, target_rate=16000, target_channels=1)
    assert sr16 == 16000 and mono16.ndim == 1 and abs(len(mono16) - 16000) < 200
    want, _ = jnative.decode_audio(p, target_rate=16000, target_channels=1)
    np.testing.assert_array_equal(mono16, want)


def test_encode_and_mux_roundtrip(shim, tmp_path):
    frames = _clip(12, 64, 64, seed=0)
    vid = tmp_path / "v.mp4"
    native.encode_video(vid, frames, fps=12.0, audio=tone(seconds=1.0), audio_rate=16000)
    assert vid.stat().st_size > 1000
    back, fps = native.decode_video(vid)
    assert back.shape[0] >= 10 and abs(fps - 12.0) < 1.0
    out = tmp_path / "muxed.mp4"
    native.mux_audio_video(vid, tone(220.0, 1.0), 16000, out)
    audio, sr = native.decode_audio(out, target_rate=16000, target_channels=1)
    assert abs(_peak_hz(audio, sr) - 220.0) < 8.0


@pytest.mark.parametrize("ext", [".wav", ".m4a", ".flac"])
def test_encode_audio_formats(shim, tmp_path, ext):
    p = tmp_path / f"a{ext}"
    native.encode_audio(p, tone(330.0), 16000)
    back, sr = native.decode_audio(p, target_rate=16000, target_channels=1)
    assert abs(_peak_hz(back[1000:-1000], sr) - 330.0) < 10.0
    want, _ = jnative.decode_audio(p, target_rate=16000, target_channels=1)
    np.testing.assert_array_equal(back, want)


def test_extract_audio_from_video(shim, tmp_path):
    vid = tmp_path / "with_audio.mp4"
    native.encode_video(vid, _clip(), fps=24.0, audio=tone(310.0, 1.0), audio_rate=16000)
    audio, sr = native.NativeVideoIO().extract_audio(str(vid))
    assert sr == 16000 and len(audio) > 12000 and float(np.abs(audio).max()) > 0.01
    silent = tmp_path / "silent.mp4"
    native.encode_video(silent, _clip(), fps=24.0)
    with pytest.raises(MediaError, match="no audio stream"):
        native.decode_audio(silent, target_rate=16000, target_channels=1)


def test_missing_file_clean_error(shim, tmp_path):
    with pytest.raises(MediaError) as e:
        native.decode_audio(tmp_path / "nope.mp3")
    assert "cannot open" in str(e.value)


@pytest.mark.parametrize("encoder", ["port", "jax"])
def test_both_shims_decode_the_same(shim, tmp_path, encoder):
    """A video made by either package's shim decodes to equal frames, fps
    and audio through both."""
    assert jnative.available()
    vid = tmp_path / f"{encoder}.mp4"
    frames = _clip(30, 72, 96, seed=4)
    (native if encoder == "port" else jnative).encode_video(
        vid, frames, fps=25.0, audio=tone(260.0, 1.2), audio_rate=16000)
    for kw in ({}, {"max_frames": 10, "frame_step": 3}):
        got, got_fps = native.decode_video(vid, **kw)
        want, want_fps = jnative.decode_video(vid, **kw)
        np.testing.assert_array_equal(got, want)
        assert got_fps == want_fps and got.dtype == np.uint8
    got, sr = native.decode_audio(vid, target_rate=16000, target_channels=1)
    want, want_sr = jnative.decode_audio(vid, target_rate=16000, target_channels=1)
    np.testing.assert_array_equal(got, want)
    assert sr == want_sr
    assert [np.asarray(x).shape for x in native.NativeVideoIO().frames(str(vid))] == \
        [np.asarray(x).shape for x in jnative.NativeVideoIO().frames(str(vid))]


def test_frames_are_empty_when_the_cap_truncates(shim, tmp_path):
    vid = tmp_path / "long.mp4"
    native.encode_video(vid, _clip(40), fps=20.0)
    vio = native.NativeVideoIO()
    fr, fps = vio.frames(str(vid), frame_step=2, max_frames=100)
    assert len(fr) == 20 and fps == pytest.approx(10.0, abs=0.5)
    fr, fps = vio.frames(str(vid), frame_step=2, max_frames=20)
    assert fr.shape == (0, 48, 64, 3) and fps == pytest.approx(10.0, abs=0.5)
    want, want_fps = jnative.NativeVideoIO().frames(str(vid), frame_step=2, max_frames=20)
    assert fr.shape == want.shape and fps == want_fps


def test_lipsync_renders_through_the_fn_and_encodes(shim, tmp_path):
    vid = tmp_path / "in.mp4"
    frames = _clip(20, 48, 64, seed=2)
    native.encode_video(vid, frames, fps=20.0, audio=tone(200.0, 1.0), audio_rate=16000)
    calls = []

    def fn(fr, fps, audio, sr):
        calls.append((fr.shape, fps, len(audio), sr))
        return 255 - fr

    out = tmp_path / "out.mp4"
    native.NativeVideoIO(lipsync_fn=fn).lipsync(str(vid), tone(330.0, 1.0), 16000, str(out))
    # an encode and decode round trip keeps all but the last frame, in both
    # packages' shim (the same source)
    n = len(native.decode_video(vid)[0])
    assert n == len(jnative.decode_video(vid)[0]) == 19
    assert calls == [((n, 48, 64, 3), pytest.approx(20.0, abs=0.5), 16000, 16000)]
    back, _ = native.decode_video(out)
    assert back.shape == (n - 1, 48, 64, 3)
    audio, _ = native.decode_audio(out, target_rate=16000, target_channels=1)
    assert abs(_peak_hz(audio, 16000) - 330.0) < 10.0
    with pytest.raises(MediaError, match="no lip-sync model configured"):
        native.NativeVideoIO().lipsync(str(vid), tone(), 16000, str(out))


def test_decode_audio_bytes_through_the_media_package(shim, tmp_path):
    p = tmp_path / "clip.flac"
    native.encode_audio(p, tone(400.0, 0.5), 16000)
    got, sr = tmedia.decode_audio_bytes(p.read_bytes(), ".flac")
    want, want_sr = jnative.decode_audio_bytes(p.read_bytes(), ".flac")
    np.testing.assert_array_equal(got, want)
    assert sr == want_sr == 16000


def test_a_non_wav_upload_translates_like_jax(shim, tmp_path):
    """A FLAC upload to /translate decodes through each package's shim and
    both apps answer alike."""
    from test_torch_serve import _clients, _same

    p = tmp_path / "up.flac"
    native.encode_audio(p, 0.3 * tone(220.0, 2.0), 16000)
    jc, tc = _clients(tmp_path)
    r = _same(jc, tc, "post", "/translate",
              data={"file": (io.BytesIO(p.read_bytes()), "up.flac"), "target_language": "fra"})
    assert r.status_code == 200 and r.get_json()["weights"] == "fake"


def test_a_failed_build_raises_with_the_compiler_output(shim, tmp_path, monkeypatch, caplog):
    broken = tmp_path / "est_media.cpp"
    broken.write_text(native.SOURCE.read_text() + "\nint est_broken( { return 0; }\n")
    monkeypatch.setattr(native, "SOURCE", broken)
    monkeypatch.setattr(native, "BUILD_DIR", tmp_path / "_build")
    with pytest.raises(RuntimeError, match="error") as e:
        native.build()
    assert "est_broken" in str(e.value)
    assert not list((tmp_path / "_build").glob("*.so"))
    monkeypatch.setattr(native, "_LIB", None)
    monkeypatch.setattr(native, "_BUILD_ERROR", None)
    with caplog.at_level(logging.ERROR), pytest.raises(MediaError, match="not built"):
        native.decode_audio(tmp_path / "x.flac")
    assert any("est_broken" in r.getMessage() for r in caplog.records)
    assert native.available() is False


def test_concurrent_first_builds_leave_one_library(shim, tmp_path, monkeypatch):
    """Threads racing to build into an empty directory each write their own
    temporary file and rename it into place."""
    monkeypatch.setattr(native, "BUILD_DIR", tmp_path / "_build")
    paths, errors = [], []

    def run():
        try:
            paths.append(native.build())
        except Exception as e:  # noqa: BLE001 — collected and asserted below
            errors.append(e)

    threads = [threading.Thread(target=run) for _ in range(3)]
    for t in threads:
        t.start()
    for t in threads:
        t.join()
    assert not errors and len(set(paths)) == 1
    assert [p.name for p in (tmp_path / "_build").iterdir()] == [paths[0].name]


def test_the_port_never_maps_a_jax_package_path(shim):
    """In a process where the JAX package cannot be imported, the port's
    shim loads, decodes, and no file under the JAX package is mapped."""
    script = textwrap.dedent("""
        import sys
        class Block:
            def find_spec(self, name, path=None, target=None):
                if name.split(".")[0] in ("jax", "expressive_speech_translation_tpu"):
                    raise ImportError(name)
        sys.meta_path.insert(0, Block())
        import numpy as np
        from expressive_speech_translation_tpu_torch.media import native
        assert native.available()
        import tempfile, os
        p = os.path.join(tempfile.mkdtemp(), "t.flac")
        native.encode_audio(p, np.zeros(1600, np.float32), 16000)
        native.decode_audio(p)
        maps = open("/proc/self/maps").read()
        bad = [ln for ln in maps.splitlines()
               if "expressive_speech_translation_tpu/" in ln]
        print("MAPPED", bad, "libest_media-" in maps)
    """)
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    env["PYTHONPATH"] = REPO
    proc = subprocess.run([sys.executable, "-c", script], cwd=REPO, env=env,
                          capture_output=True, text=True, timeout=120)
    assert proc.returncode == 0, proc.stderr[-3000:]
    assert "MAPPED [] True" in proc.stdout, proc.stdout
