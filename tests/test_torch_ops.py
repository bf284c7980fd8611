"""The port's kernel modules against the JAX package on the CPU.

On a CPU tensor each kernel wrapper runs its plain PyTorch version, which is
what these tests hold against the Pallas kernels (interpret mode) and the
XLA frontends. Tolerances: the log-mel is held to 1e-4 in normalised
log-mel units, as tests/test_pallas_mel.py holds the Pallas kernel (f32 sums
of 400 products in another order, then log10); the resblock stage to 1e-5 of
its peak (f32 sums over up to C * 11 products per conv, nine convs deep), as
tests/test_pallas_vocoder.py holds the Pallas kernel against XLA.
"""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from expressive_speech_translation_tpu.models import cosyvoice as jcv
from expressive_speech_translation_tpu.ops import pallas_vocoder as jpv
from expressive_speech_translation_tpu.ops import whisper_log_mel as jax_whisper_log_mel
from expressive_speech_translation_tpu.ops.pallas_mel import whisper_log_mel_pallas
from expressive_speech_translation_tpu_torch.ops import cuda_mel, cuda_vocoder
from expressive_speech_translation_tpu_torch.ops import mel as tmel
from expressive_speech_translation_tpu_torch.ops.host_dsp import resample_np
from expressive_speech_translation_tpu.ops.host_dsp import resample_np as jax_resample_np

MEL_ATOL = 1e-4
RES_RTOL = 1e-5


def _speechlike(seconds, seed, sr=16_000):
    g = np.random.default_rng(seed)
    t = np.arange(int(sr * seconds)) / sr
    x = (0.4 * np.sin(2 * np.pi * 220 * t) + 0.2 * np.sin(2 * np.pi * 880 * t + 1.0)
         + 0.02 * g.standard_normal(t.shape))
    x *= 0.5 + 0.5 * np.sin(2 * np.pi * 3.0 * t) ** 2
    return x.astype(np.float32)


@pytest.mark.parametrize("window_s,n_mels,audio_s", [
    (2, 80, 1.3), (2, 128, 2.5), (4, 80, 3.1), (4, 128, 4.0)])
def test_log_mel_plain_matches_pallas_and_xla(window_s, n_mels, audio_s):
    x = _speechlike(audio_s, seed=window_s * n_mels)
    chunk = 16_000 * window_s
    pallas = np.asarray(whisper_log_mel_pallas(jnp.asarray(x), n_mels=n_mels,
                                               chunk_samples=chunk, interpret=True))
    xla = np.asarray(jax_whisper_log_mel(jnp.asarray(x), n_mels=n_mels, chunk_samples=chunk))
    fused = cuda_mel.whisper_log_mel_fused(torch.from_numpy(x), n_mels=n_mels,
                                           chunk_samples=chunk).numpy()
    plain_xla = tmel.whisper_log_mel(torch.from_numpy(x), n_mels=n_mels,
                                     chunk_samples=chunk).numpy()
    assert fused.shape == pallas.shape == (n_mels, chunk // 160)
    np.testing.assert_allclose(fused, pallas, atol=MEL_ATOL, rtol=0)
    np.testing.assert_allclose(fused, xla, atol=MEL_ATOL, rtol=0)
    np.testing.assert_allclose(plain_xla, xla, atol=MEL_ATOL, rtol=0)


def test_log_mel_rejects_odd_windows():
    with pytest.raises(ValueError, match="multiple of 200 frames"):
        cuda_mel.whisper_log_mel_fused(torch.zeros(16_000), chunk_samples=16_000 * 3)


@pytest.mark.parametrize("n_mels", [80, 128])
def test_mel_bands_cover_exactly_the_filterbank_nonzeros(n_mels):
    fb = np.asarray(tmel.mel_filterbank(16_000, 400, n_mels), np.float32)
    bands, weights = cuda_mel.mel_bands(fb)
    assert bands.dtype == np.int32 and bands.shape == (n_mels, 3)
    assert weights.dtype == np.float32 and weights.size == np.count_nonzero(fb)
    dense = np.zeros_like(fb)
    for m, (lo, hi, off) in enumerate(bands):
        band = weights[off:off + hi - lo]
        assert hi > lo and np.all(band != 0)
        dense[lo:hi, m] = band
    np.testing.assert_array_equal(dense, fb)
    assert list(bands[:, 2]) == list(np.cumsum([0] + [hi - lo for lo, hi, _ in bands[:-1]]))
    with pytest.raises(ValueError, match="gap"):
        gapped = fb.copy()
        widest = int(np.argmax(bands[:, 1] - bands[:, 0]))   # at least 3 bins wide
        gapped[bands[widest, 0] + 1, widest] = 0.0
        cuda_mel.mel_bands(gapped)


@pytest.mark.parametrize("n_mels", [80, 128])
def test_banded_mel_product_equals_the_dense_one(n_mels):
    """The kernel's projection (each filter over its band, ascending k, f32
    fused multiply-adds) against power @ fb: the same nonzero products, so
    they differ by f32 rounding alone."""
    fb = np.asarray(tmel.mel_filterbank(16_000, 400, n_mels), np.float32)
    bands, weights = cuda_mel.mel_bands(fb)
    g = np.random.default_rng(n_mels)
    power = (g.standard_exponential((64, 201)) * 10.0 ** g.uniform(-6, 4, (64, 1))).astype(np.float32)
    banded = np.zeros((64, n_mels), np.float32)
    for m, (lo, hi, off) in enumerate(bands):
        for i in range(hi - lo):
            banded[:, m] = (banded[:, m].astype(np.float64)
                            + power[:, lo + i].astype(np.float64) * weights[off + i]).astype(np.float32)
    dense = power @ fb
    assert np.all(np.abs(banded - dense) <= 16 * 2.0 ** -24 * dense)


def test_fft_twiddles_are_float64_rounded_to_f32():
    tw = cuda_mel.fft_twiddles()
    assert tw.dtype == np.float32 and tw.shape == (400, 2)
    angle = 2 * np.pi * np.arange(400) / 400
    want = np.stack([np.cos(angle), -np.sin(angle)], -1)
    ulp = np.spacing(np.abs(want).astype(np.float32))
    assert np.all(np.abs(tw.astype(np.float64) - want) <= ulp)
    window, twiddles, bands, band_w = cuda_mel._kernel_tables_np(80)
    np.testing.assert_array_equal(twiddles, tw)
    np.testing.assert_array_equal(window, np.asarray(torch.hann_window(400, dtype=torch.float64),
                                                     np.float32))


def _torch_stage(stage):
    """JAX resblock stage params → the port's (conv kernels [out, in, k])."""
    def conv(p):
        return {"kernel": torch.from_numpy(np.array(p["kernel"])).permute(2, 1, 0),
                "bias": torch.from_numpy(np.array(p["bias"]))}
    return [[{"c1": conv(u["c1"]), "c2": conv(u["c2"])} for u in block] for block in stage]


@pytest.mark.parametrize("channels,t,tile", [(8, 301, 128), (16, 300, 128), (16, 77, 4096)])
def test_resblock_plain_matches_pallas(channels, t, tile):
    # base_channels 4 * C puts C on the second stage's resblocks
    cfg = jcv.VocoderConfig(base_channels=4 * channels)
    params = jcv.init_vocoder(jax.random.PRNGKey(channels), cfg)
    stage = params["res"][1]
    g = np.random.default_rng(t)
    x = (0.3 * g.standard_normal((2, t, channels))).astype(np.float32)
    kernels, dilations = cfg.resblock_kernels, cfg.resblock_dilations
    want = np.asarray(jpv.fused_resblock_stage(
        jnp.asarray(x), jpv.stage_weights_flat(stage, kernels, dilations),
        kernels=kernels, dilations=dilations, tile=tile, interpret=True))
    weights = cuda_vocoder.stage_weights_flat(_torch_stage(stage), kernels, dilations)
    got = cuda_vocoder.fused_resblock_stage(torch.from_numpy(x), weights, kernels=kernels,
                                            dilations=dilations).numpy()
    assert got.shape == want.shape == x.shape
    assert np.abs(got - want).max() <= RES_RTOL * np.abs(want).max()


def test_stage_halo_matches_jax():
    for kernels, dilations in (((3, 7, 11), ((1, 3, 5),) * 3), ((3,), ((1,),)), ((5, 9), ((1, 2), (3,)))):
        assert cuda_vocoder.stage_halo(kernels, dilations) == jpv.stage_halo(kernels, dilations)


def test_cpu_tensors_take_the_plain_versions_and_count_no_launch():
    mel_before = cuda_mel.log_mel_frames.launches
    res_before = cuda_vocoder.fused_resblock_stage.launches
    audio = torch.from_numpy(_speechlike(1.0, seed=3))
    frames = cuda_mel.log_mel_frames(audio, 80, 32_000)
    assert torch.equal(frames, cuda_mel.log_mel_frames_plain(audio, 80, 32_000))
    g = torch.Generator().manual_seed(0)
    x = torch.randn((1, 50, 8), generator=g)
    w = (torch.randn((126, 8, 8), generator=g) * 0.1, torch.randn((18, 8), generator=g) * 0.1)
    kw = dict(kernels=(3, 7, 11), dilations=((1, 3, 5),) * 3)
    assert torch.equal(cuda_vocoder.fused_resblock_stage(x, w, **kw),
                       cuda_vocoder.resblock_stage_plain(x, w, **kw))
    assert cuda_mel.log_mel_frames.launches == mel_before
    assert cuda_vocoder.fused_resblock_stage.launches == res_before


def test_host_resample_matches_jax_host_resample():
    x = _speechlike(1.7, seed=9)
    for orig, new in ((24_000, 16_000), (16_000, 24_000)):
        want = jax_resample_np(x, orig, new)
        got = resample_np(x, orig, new)
        assert got.shape == want.shape
        np.testing.assert_allclose(got, want, atol=1e-5, rtol=0)



def test_wrappers_validate_before_any_launch():
    """Inputs the kernels cannot take raise before a launch; a tensor on a
    device other than CPU or CUDA never reaches either version."""
    kw = dict(kernels=(3, 7, 11), dilations=((1, 3, 5),) * 3)
    meta = torch.device("meta")
    w = (torch.empty((126, 16, 16), device=meta), torch.empty((18, 16), device=meta))
    with pytest.raises(ValueError, match="CUDA or CPU"):
        cuda_vocoder.fused_resblock_stage(torch.empty((1, 50, 16), device=meta), w, **kw)
    with pytest.raises(ValueError, match="CUDA or CPU"):
        cuda_mel.log_mel_frames(torch.empty(32_000, device=meta), 80, 32_000)
    bad = (
        (torch.empty((1, 50, 12)), (torch.empty((126, 12, 12)), torch.empty((18, 12))), "C % 8"),
        (torch.empty((1, 50, 136)), (torch.empty((126, 136, 136)), torch.empty((18, 136))), "C <= 128"),
        (torch.empty((1, 50, 16), dtype=torch.float16), w, "float32 or bfloat16"),
        (torch.empty((1, 50, 16)), (torch.empty((120, 16, 16)), torch.empty((18, 16))), "do not fit"),
        (torch.empty((1, 50, 16)), (torch.empty((16, 16, 126)).permute(2, 0, 1),
                                    torch.empty((18, 16))), "contiguous"),
        (torch.empty((1, 50, 16)), (torch.empty((126, 16, 16), dtype=torch.bfloat16),
                                    torch.empty((18, 16))), "contiguous torch.float32"),
    )
    for x, weights, match in bad:
        with pytest.raises((TypeError, ValueError), match=match):
            cuda_vocoder._validate(x, *weights, kw["kernels"], kw["dilations"])
    x = torch.empty((1, 50, 16))
    cw = (torch.empty((126, 16, 16)), torch.empty((18, 16)))
    cuda_vocoder._validate(x, *cw, kw["kernels"], kw["dilations"])
    with pytest.raises(ValueError, match="tap offset"):
        cuda_vocoder._validate(x, torch.empty((84, 16, 16)), torch.empty((6, 16)), (11,), ((1, 3, 9),))
