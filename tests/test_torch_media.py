"""The port's WAV codec (``media/wavio.py``) against the JAX package's on the
CPU: byte-exact encodes, equal decodes of every format the reader takes, and
the same errors."""

import struct

import numpy as np
import pytest

from expressive_speech_translation_tpu.core.errors import MediaError as JaxMediaError
from expressive_speech_translation_tpu.media import wavio as jwav
from expressive_speech_translation_tpu_torch.core.errors import MediaError
from expressive_speech_translation_tpu_torch.media import wavio as twav


def _audio(channels, n=1001, seed=0):
    g = np.random.default_rng(seed)
    x = (1.2 * g.standard_normal((channels, n))).astype(np.float32)   # clipped on write
    return x[0] if channels == 1 else x


def _wav(fmt, channels, sr, bits, raw, *, extensible=None, odd_chunk=False):
    """A WAV by hand: fmt (16 bytes, or 40 with an extensible SubFormat), an
    optional odd-sized chunk before the data (its pad byte skipped)."""
    block = channels * bits // 8
    body = struct.pack("<HHIIHH", fmt, channels, sr, sr * block, block, bits)
    if extensible is not None:
        body += struct.pack("<HHI", 22, bits, 0) + struct.pack("<H", extensible) + b"\0" * 14
    chunks = b"fmt " + struct.pack("<I", len(body)) + body
    if odd_chunk:
        chunks += b"LIST" + struct.pack("<I", 3) + b"abc\0"
    chunks += b"data" + struct.pack("<I", len(raw)) + raw
    return b"RIFF" + struct.pack("<I", 4 + len(chunks)) + b"WAVE" + chunks


@pytest.mark.parametrize("bits", [16, 32])
@pytest.mark.parametrize("channels", [1, 2])
def test_wav_bytes_and_read_back_match_jax(tmp_path, bits, channels):
    x = _audio(channels)
    data = twav.wav_bytes(x, 24_000, bits=bits)
    assert data == jwav.wav_bytes(x, 24_000, bits=bits)
    got, sr = twav.read_wav_bytes(data)
    want, jsr = jwav.read_wav_bytes(data)
    assert sr == jsr == 24_000 and got.dtype == np.float32
    np.testing.assert_array_equal(got, want)
    twav.write_wav(tmp_path / "x.wav", x, 16_000, bits=bits)
    got, sr = twav.read_wav(tmp_path / "x.wav")
    assert sr == 16_000 and got.shape == x.shape
    np.testing.assert_array_equal(got, jwav.read_wav(tmp_path / "x.wav")[0])


def _raw(kind, channels):
    g = np.random.default_rng(1)
    n = 37 * channels
    if kind == "pcm8":
        return 1, 8, g.integers(0, 256, n, dtype=np.uint8).tobytes(), None
    if kind == "pcm24":
        return 1, 24, g.integers(0, 256, 3 * n, dtype=np.uint8).tobytes(), None
    if kind == "pcm32":
        return 1, 32, g.integers(-2**31, 2**31, n, dtype=np.int64).astype("<i4").tobytes(), None
    if kind == "ext_pcm32":
        return 0xFFFE, 32, g.integers(-2**31, 2**31, n).astype("<i4").tobytes(), 1
    if kind == "ext_float":
        return 0xFFFE, 32, g.standard_normal(n).astype("<f4").tobytes(), 3
    if kind == "ext_short24":   # an extensible header with no SubFormat: the depth decides
        return 0xFFFE, 24, g.integers(0, 256, 3 * n, dtype=np.uint8).tobytes(), "short"
    raise AssertionError(kind)


@pytest.mark.parametrize("kind", ["pcm8", "pcm24", "pcm32", "ext_pcm32", "ext_float",
                                  "ext_short24"])
@pytest.mark.parametrize("channels", [1, 2])
def test_every_format_decodes_as_jax_decodes_it(kind, channels):
    fmt, bits, raw, sub = _raw(kind, channels)
    data = _wav(fmt, channels, 8_000, bits, raw, extensible=None if sub == "short" else sub,
                odd_chunk=True)
    got, sr = twav.read_wav_bytes(data)
    want, jsr = jwav.read_wav_bytes(data)
    assert sr == jsr == 8_000 and got.shape == want.shape and got.dtype == np.float32
    np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize("case", ["short", "not_riff", "no_data", "unsupported", "depth"])
def test_the_same_errors(case):
    ok = twav.wav_bytes(_audio(1, 100), 16_000)
    data = {"short": b"RIFF", "not_riff": b"RIFX" + ok[4:],
            "no_data": ok[:36] + b"junk" + ok[40:],
            "unsupported": _wav(1, 1, 16_000, 12, b"\0" * 30), "depth": None}[case]

    def run(mod):
        if data is None:
            return mod.wav_bytes(_audio(1, 10), 16_000, bits=24)
        return mod.read_wav_bytes(data, label="upload.wav")

    with pytest.raises(JaxMediaError) as want:
        run(jwav)
    with pytest.raises(MediaError) as got:
        run(twav)
    assert str(got.value) == str(want.value)
    assert got.value.http_status == want.value.http_status == 400
    assert got.value.error_id == want.value.error_id
    assert got.value.to_payload() == want.value.to_payload()
