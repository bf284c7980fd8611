"""The port's resblock stage on the CPU: its plain version on the layout
vocode hands the kernel, the wrapper's planner (which variant, which window,
how much shared memory), the wgmma variant's swizzled weight image, and the
anchors of ``obs/resblock_probe.py`` in ``csrc/resblock.cu``.

The plain version is held to 1e-5 of its peak against the Pallas kernel in
interpret mode, as tests/test_torch_ops.py holds it (f32 sums over up to
C * 11 products per conv, nine convs deep, in another order)."""

import numpy as np
import pytest
import torch

import jax

from expressive_speech_translation_tpu.models import cosyvoice as jcv
from expressive_speech_translation_tpu.ops import pallas_vocoder as jpv
from expressive_speech_translation_tpu_torch.obs import resblock_probe
from expressive_speech_translation_tpu_torch.ops import build, cuda_vocoder

RES_RTOL = 1e-5
REF = jcv.VocoderConfig()                      # HiFi-GAN base 512, rates 8 6 10
KERNELS = tuple(REF.resblock_kernels)
DILATIONS = tuple(tuple(d) for d in REF.resblock_dilations)
SOURCE = (build.CSRC_DIR / "resblock.cu").read_text()


def _torch_stage(stage):
    """JAX resblock stage params → the port's (conv kernels [out, in, k])."""
    def conv(p):
        return {"kernel": torch.from_numpy(np.array(p["kernel"])).permute(2, 1, 0),
                "bias": torch.from_numpy(np.array(p["bias"]))}
    return [[{"c1": conv(u["c1"]), "c2": conv(u["c2"])} for u in block] for block in stage]


@pytest.mark.parametrize("channels,t", [(8, 301), (16, 77)])
def test_resblock_plain_matches_pallas_on_the_vocode_layout(channels, t):
    """x as vocode passes it: the transposed view of a contiguous [B, C, T];
    the output keeps that layout's strides."""
    cfg = jcv.VocoderConfig(base_channels=4 * channels)
    params = jcv.init_vocoder(jax.random.PRNGKey(channels + 1), cfg)
    stage = params["res"][1]
    g = np.random.default_rng(t + 1)
    x_bct = (0.3 * g.standard_normal((2, channels, t))).astype(np.float32)
    kernels, dilations = cfg.resblock_kernels, cfg.resblock_dilations
    want = np.asarray(jpv.fused_resblock_stage(
        jax.numpy.asarray(x_bct.transpose(0, 2, 1)),
        jpv.stage_weights_flat(stage, kernels, dilations),
        kernels=kernels, dilations=dilations, tile=128, interpret=True))
    x = torch.from_numpy(x_bct).transpose(1, 2)
    assert x.stride() == (channels * t, 1, t)
    weights = cuda_vocoder.stage_weights_flat(_torch_stage(stage), kernels, dilations)
    got = cuda_vocoder.fused_resblock_stage(x, weights, kernels=kernels, dilations=dilations)
    assert got.shape == want.shape == x.shape
    assert np.abs(got.numpy() - want).max() <= RES_RTOL * np.abs(want).max()


@pytest.mark.parametrize("c", [64, 128])
def test_main_path_plans_take_wgmma_and_fit_a_block(c):
    """The reference vocoder's two fused stages in bf16: the wgmma variant,
    shared memory within the opt-in limit, a tile of at least MIN_TILE."""
    pl = cuda_vocoder.plan(c, torch.bfloat16, KERNELS, DILATIONS)
    halo = cuda_vocoder.stage_halo(KERNELS, DILATIONS)
    assert pl.variant == "wgmma"
    assert pl.window == cuda_vocoder.WG_WINDOW[c]
    assert pl.smem_bytes <= cuda_vocoder.SMEM_OPTIN_BYTES == 232_448
    assert pl.window - 2 * halo >= cuda_vocoder.MIN_TILE
    assert pl.threads == cuda_vocoder.WG_THREADS == 384


@pytest.mark.parametrize("c", [8, 16, 32, 48, 96, 64, 128])
def test_f32_and_other_bf16_widths_take_the_cuda_core_variant(c):
    """bf16 with C other than 64 or 128 (C % 64 != 0 on the path), and f32 at
    every width, run the CUDA-core variant, within the shared-memory limit."""
    halo = cuda_vocoder.stage_halo(KERNELS, DILATIONS)
    dtypes = [torch.float32] + ([torch.bfloat16] if c % 64 else [])
    for dtype in dtypes:
        pl = cuda_vocoder.plan(c, dtype, KERNELS, DILATIONS)
        assert pl.variant == "cuda-core"
        assert pl.smem_bytes <= cuda_vocoder.SMEM_OPTIN_BYTES
        assert pl.window - 2 * halo >= cuda_vocoder.MIN_TILE
        assert pl.threads == c // 8 * 32 <= 512


def test_wgmma_shared_memory_follows_the_kernels_layout():
    """1 KB of alignment slack, two 8 KB ring slots and their barriers,
    h [W][C] f32, aT [W + 2 * margin][C + 8] bf16, at the stage's margin of
    25 (k = 11, d = 5)."""
    margin = cuda_vocoder.stage_margin(KERNELS, DILATIONS)
    assert margin == 25
    assert cuda_vocoder.wg_smem_bytes(64, 512, margin) == (
        1024 + 2 * 8192 + 32 + 512 * 64 * 4 + (512 + 50) * 72 * 2) == 229_440
    assert cuda_vocoder.wg_smem_bytes(128, 256, margin) == (
        1024 + 2 * 8192 + 32 + 256 * 128 * 4 + (256 + 50) * 136 * 2) == 231_744


def test_a_halo_that_leaves_no_tile_raises():
    """A window keeps a tile of MIN_TILE rows inside its halo; where no
    window of either variant does, planning raises before any launch."""
    dilations = ((5,) * 9,)                              # halo 9 * (25 + 5) = 270
    assert cuda_vocoder.stage_halo((11,), dilations) == 270
    for c, dtype in ((64, torch.bfloat16), (128, torch.bfloat16), (64, torch.float32)):
        with pytest.raises(ValueError, match="no window fits"):
            cuda_vocoder.plan(c, dtype, (11,), dilations)


@pytest.mark.parametrize("c", [64, 128])
def test_wgmma_weight_image_holds_each_weight_once_where_the_swizzle_puts_it(c):
    """Each weight w[j, ci, co] sits in chunk (j, ci // KW), row co, 16-byte
    group (ci % KW // 8) ^ s(co % 8), element ci % 8, where s is the 128-byte
    swizzle's row % 8 (KW = 64) or the 64-byte swizzle's (row % 8) // 2
    (KW = 32); the image is a permutation of the weights."""
    taps = 4
    kw = 64 if c == 64 else 32
    w = torch.arange(taps * c * c, dtype=torch.int64).reshape(taps, c, c)
    image = cuda_vocoder.wgmma_weight_image(w)
    j, ci, co = np.meshgrid(np.arange(taps), np.arange(c), np.arange(c), indexing="ij")
    r = co % 8
    s = r if kw == 64 else r // 2
    pos = ((j * (c // kw) + ci // kw) * c * kw + (co // 8) * 8 * kw + r * kw
           + (((ci % kw) // 8) ^ s) * 8 + ci % 8)
    assert image.shape == (taps * c * c,)
    assert sorted(pos.ravel().tolist()) == list(range(taps * c * c))
    np.testing.assert_array_equal(image.numpy()[pos], w.numpy())
    back = torch.empty_like(image)
    back[torch.from_numpy(pos.ravel())] = w.reshape(-1)
    assert torch.equal(back, image)


def test_wgmma_weight_image_keeps_the_dtype_and_bytes():
    w = torch.randn((126, 64, 64)).to(torch.bfloat16)
    image = cuda_vocoder.wgmma_weight_image(w)
    assert image.dtype == torch.bfloat16 and image.is_contiguous()
    assert torch.equal(image.sort().values, w.reshape(-1).sort().values)


@pytest.mark.parametrize("name", sorted(resblock_probe.CUTS))
def test_resblock_probe_cut_inserts_its_code_once(name):
    cuts = resblock_probe.CUTS[name]
    got = resblock_probe.variant_source(SOURCE, cuts)
    for anchor, code in cuts:
        assert got.count(code + anchor) == 1
        got = got.replace(code, "", 1)
    assert got == SOURCE


def test_resblock_probe_refuses_a_missing_anchor():
    with pytest.raises(ValueError, match="anchors need updating"):
        resblock_probe.variant_source(SOURCE.replace(resblock_probe.AFTER_WGMMA, ""),
                                      resblock_probe.CUTS["no-mma"])


def test_resblock_probe_macros_follow_what_they_replace():
    """Each cut's macro is defined after the function it replaces and before
    the kernel code that calls it."""
    helpers = SOURCE.index(resblock_probe.AFTER_HELPERS)
    wgmma = SOURCE.index(resblock_probe.AFTER_WGMMA)
    kernel = SOURCE.index(resblock_probe.BEFORE_KERNEL)
    for fn in ("void ldsm_x4(", "void bulk_copy(", "void mbar_expect_tx(", "void consumer_sync(",
               "void mbar_wait(", "void mbar_arrive("):
        assert SOURCE.index(fn) < helpers
    assert SOURCE.index("void wgmma_n128(") < wgmma < helpers < kernel
    conv = SOURCE.index("void conv_wg(")
    assert helpers < conv < kernel
    assert "ldsm_x4(" in SOURCE[conv:kernel] and "mbar_expect_tx(" in SOURCE[kernel:]
    assert "bulk_copy(" in SOURCE[kernel:] and "consumer_sync();" in SOURCE[kernel:]
    body = SOURCE[kernel:]
    for fn in ("store_operand", "add_to_state", "load_window", "branch_sum", "write_out"):
        assert SOURCE.index(f"void {fn}(") < kernel
        assert f"{fn}<" in body
    assert "struct WgWindow" in SOURCE[:kernel]


def test_resblock_probe_skip_keeps_the_accumulators_read():
    """The epilogue cuts' stand-in reads every accumulator it is handed, so
    ptxas cannot drop the products that fill them."""
    assert "s += acc[m][k]" in resblock_probe.SKIP
    for cut in ("no-operand", "no-state"):
        (_, code), = resblock_probe.CUTS[cut]
        assert code.startswith(resblock_probe.SKIP)
