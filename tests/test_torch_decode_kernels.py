"""The port's decode kernels (fused norm→matvec, fused norm→MLP, packed-int4
matmul) against the JAX package's Pallas kernels on the CPU.

A CPU tensor makes each wrapper run its plain PyTorch version, which is held
against the Pallas kernel in interpret mode on the same numpy-seeded f32
inputs. Tolerances: the norm kernels to rtol = atol = 2e-5, as
tests/test_pallas_decode.py holds the Pallas kernels against XLA (f32 sums
over up to 1280 products in another order; the JAX gelu's A&S erf is within
1.5e-7 of the exact erf used here); int4 to 1e-5 of the output's peak: both
sides take f32 sums of the same exact integer weights, in another order. The
packings are byte-exact.
"""

import re

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from expressive_speech_translation_tpu.ops import pallas_decode as jpd
from expressive_speech_translation_tpu.ops import pallas_int4 as jpi
from expressive_speech_translation_tpu_torch.ops import build, cuda_decode, cuda_int4

DECODE_TOL = 2e-5
INT4_RTOL = 1e-5
DECODE_SOURCE = (build.CSRC_DIR / "decode.cu").read_text()
Plan = cuda_decode.Plan


def _mk(g, *shape, s=0.05):
    return (g.standard_normal(shape) * s).astype(np.float32)


def _t(a):
    return torch.from_numpy(np.array(a))


@pytest.mark.parametrize("bsz,d,n,norm,eps", [
    (2, 256, 768, "layer", 1e-5),     # qkv
    (1, 128, 512, "none", 1e-5),
    (4, 256, 384, "rms", 1e-6),
    (4, 256, 768, "layer", 1e-5),     # qkv at decode batch 4
    (8, 256, 768, "layer", 1e-5),     # ... and 8 (serve/batching max_batch)
    (8, 128, 384, "rms", 1e-6),
])
def test_ln_matvec_plain_matches_pallas(bsz, d, n, norm, eps):
    g = np.random.default_rng(d + n)
    x, sc, bi = _mk(g, bsz, d, s=1.0), _mk(g, d, s=1.0), _mk(g, d)
    w, b = _mk(g, d, n), _mk(g, n)
    want = jpd.fused_ln_matvec(*map(jnp.asarray, (x, sc, bi, w, b)), norm=norm, eps=eps,
                               interpret=True)
    got = cuda_decode.fused_ln_matvec(*map(_t, (x, sc, bi, w, b)), norm=norm, eps=eps)
    assert got.dtype == torch.float32 and tuple(got.shape) == (bsz, n)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=DECODE_TOL, atol=DECODE_TOL)


@pytest.mark.parametrize("bsz,d,f,gated,norm,eps,activation,residual", [
    (1, 256, 1024, False, "layer", 1e-5, "gelu", True),     # whisper / NLLB mlp
    (4, 256, 1024, False, "layer", 1e-5, "gelu", True),
    (2, 128, 512, False, "layer", 1e-5, "gelu", False),
    (1, 256, 1280, True, "rms", 1e-6, "silu", True),        # qwen2 gated mlp
    (2, 128, 384, False, "none", 1e-5, "relu", True),
    (8, 256, 1024, False, "layer", 1e-5, "gelu", True),     # decode batch 8
    (8, 256, 1280, True, "rms", 1e-6, "silu", True),        # gated, batch 8
])
def test_ln_mlp_plain_matches_pallas(bsz, d, f, gated, norm, eps, activation, residual):
    g = np.random.default_rng(d + f + bsz)
    x, sc, bi = _mk(g, bsz, d, s=1.0), _mk(g, d, s=1.0), _mk(g, d)
    w1, b1, w2, b2 = _mk(g, d, f), _mk(g, f), _mk(g, f, d), _mk(g, d)
    wg = _mk(g, d, f) if gated else None
    jpacked = jpd.pack_mlp(jnp.asarray(w1), jnp.asarray(w2),
                           None if wg is None else jnp.asarray(wg))
    kw = dict(gated=gated, norm=norm, eps=eps, activation=activation, residual=residual)
    want = jpd.fused_ln_mlp(jnp.asarray(x), jnp.asarray(sc), jnp.asarray(bi), jpacked,
                            jnp.asarray(b1), jnp.asarray(b2), interpret=True, **kw)
    packed = cuda_decode.pack_mlp(_t(w1), _t(w2), None if wg is None else _t(wg))
    np.testing.assert_array_equal(packed.numpy(), np.asarray(jpacked))
    got = cuda_decode.fused_ln_mlp(_t(x), _t(sc), _t(bi), packed, _t(b1), _t(b2), **kw)
    assert got.dtype == torch.float32 and tuple(got.shape) == (bsz, d)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=DECODE_TOL, atol=DECODE_TOL)


@pytest.mark.parametrize("b,k,n", [
    (8, 256, 512), (8, 128, 384), (1, 64, 128),
    (3, 200, 384),     # K/2 = 100: a ragged last k-step for the tensor-core kernel
    (16, 256, 256),    # 16 batch rows: two n-tiles in one launch
    (3, 208, 384),     # K/2 = 104: a ragged last k-step with 16-byte copies of x
    (20, 256, 256),    # 20 batch rows: a group of 16, then a group of 4
])
def test_matmul_int4_plain_matches_pallas(b, k, n):
    g = np.random.default_rng(k + n)
    w, x = g.standard_normal((k, n)).astype(np.float32), g.standard_normal((b, k)).astype(np.float32)
    jpacked, jscale = jpi.pack_int4(jnp.asarray(w))
    packed, scale = cuda_int4.pack_int4(_t(w))
    np.testing.assert_array_equal(packed.numpy(), np.asarray(jpacked))
    np.testing.assert_array_equal(scale.numpy(), np.asarray(jscale))
    assert packed.dtype == torch.int8 and scale.dtype == torch.float32
    want = np.asarray(jpi.matmul_int4(jnp.asarray(x), jpacked, jscale, block_n=128,
                                      interpret=True))
    got = cuda_int4.matmul_int4(_t(x), packed, scale).numpy()
    assert got.shape == want.shape == (b, n)
    assert np.abs(got - want).max() <= INT4_RTOL * np.abs(want).max()


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_pack_and_unpack_int4_match_jax(dtype):
    g = np.random.default_rng(5)
    w = g.standard_normal((64, 256)).astype(np.float32)
    jdtype = jnp.float32 if dtype == torch.float32 else jnp.bfloat16
    jpacked, jscale = jpi.pack_int4(jnp.asarray(w, jdtype))
    packed, scale = cuda_int4.pack_int4(_t(w).to(dtype))
    np.testing.assert_array_equal(packed.numpy(), np.asarray(jpacked))
    np.testing.assert_array_equal(scale.numpy(), np.asarray(jscale))
    want = np.asarray(jpi.unpack_int4(jpacked, jscale, dtype=jnp.float32))
    np.testing.assert_array_equal(cuda_int4.unpack_int4(packed, scale, torch.float32).numpy(), want)
    with pytest.raises(ValueError, match="even K"):
        cuda_int4.pack_int4(torch.zeros((7, 128)))


def test_cpu_tensors_take_the_plain_versions_and_count_no_launch():
    before = (cuda_decode.fused_ln_matvec.launches, cuda_decode.fused_ln_mlp.launches,
              cuda_int4.matmul_int4.launches)
    g = torch.Generator().manual_seed(0)
    x, sc, bi = torch.randn((2, 128), generator=g), torch.randn(128, generator=g), torch.zeros(128)
    w, b = torch.randn((128, 256), generator=g) * 0.05, torch.zeros(256)
    assert torch.equal(cuda_decode.fused_ln_matvec(x, sc, bi, w, b),
                       cuda_decode.fused_ln_matvec_plain(x, sc, bi, w, b))
    packed = cuda_decode.pack_mlp(w, w.T.contiguous())
    assert torch.equal(cuda_decode.fused_ln_mlp(x, sc, bi, packed, b, torch.zeros(128)),
                       cuda_decode.fused_ln_mlp_plain(x, sc, bi, packed, b, torch.zeros(128)))
    p, s = cuda_int4.pack_int4(w)
    assert torch.equal(cuda_int4.matmul_int4(x, p, s), cuda_int4.matmul_int4_plain(x, p, s))
    assert (cuda_decode.fused_ln_matvec.launches, cuda_decode.fused_ln_mlp.launches,
            cuda_int4.matmul_int4.launches) == before


@pytest.mark.parametrize("dtype,kernel", [(torch.bfloat16, "tensor-core"),
                                          (torch.float32, "cuda-core")])
def test_int4_variant_follows_the_dtype(dtype, kernel):
    """bf16 x takes the tensor-core kernel; f32 keeps the CUDA-core one, whose
    sums of unrounded x meet the 1e-5 tolerance."""
    assert cuda_int4.variant(dtype) == kernel


def test_wrappers_validate_before_any_launch():
    """Widths the JAX functions refuse raise on every device; a tensor on a
    device other than CPU or CUDA reaches neither version; the checks a
    launch needs (dtype, layout, alignment) raise before it."""
    x, v = torch.zeros((1, 128)), torch.zeros(128)
    with pytest.raises(ValueError, match="multiple of 128"):
        cuda_decode.fused_ln_matvec(x, v, v, torch.zeros((128, 200)), torch.zeros(200))
    with pytest.raises(ValueError, match="multiple of 128"):
        cuda_decode.fused_ln_mlp(x, v, v, torch.zeros((256, 100)), torch.zeros(100), v)
    with pytest.raises(ValueError, match="w_packed"):
        cuda_decode.fused_ln_mlp(x, v, v, torch.zeros((256, 128)), torch.zeros(128), v,
                                 gated=True)
    with pytest.raises(ValueError, match=r"\[128, N\]"):
        cuda_decode.fused_ln_matvec(x, v, v, torch.zeros((64, 128)), v)
    with pytest.raises(ValueError, match="norm must be"):
        cuda_decode.fused_ln_matvec(x, v, v, torch.zeros((128, 128)), v, norm="batch")
    with pytest.raises(ValueError, match="activation must be"):
        cuda_decode.fused_ln_mlp(x, v, v, torch.zeros((256, 128)), v, v, activation="tanh")
    p, s = cuda_int4.pack_int4(torch.ones((64, 128)))
    with pytest.raises(ValueError, match="does not match"):
        cuda_int4.matmul_int4(torch.zeros((1, 100)), p, s)
    with pytest.raises(ValueError, match="multiple of 128"):
        cuda_int4.matmul_int4(torch.zeros((1, 64)), torch.zeros((32, 100), dtype=torch.int8),
                              torch.ones((1, 100)))
    with pytest.raises(ValueError, match=r"x \[B, K\] and packed \[K/2, N\]"):
        cuda_int4.matmul_int4(torch.zeros(64), p, s)
    meta = torch.device("meta")
    with pytest.raises(ValueError, match="CUDA or CPU"):
        cuda_decode.fused_ln_matvec(x.to(meta), v, v, torch.zeros((128, 128), device=meta), v)
    with pytest.raises(ValueError, match="CUDA or CPU"):
        cuda_decode.fused_ln_mlp(x.to(meta), v, v, torch.zeros((256, 128), device=meta), v, v)
    with pytest.raises(ValueError, match="CUDA or CPU"):
        cuda_int4.matmul_int4(torch.zeros((1, 64), device=meta), p.to(meta), s.to(meta))
    w = torch.zeros((128, 128))
    bad = (
        (x.half(), (("w", w.half()),), (), TypeError, "float32 or bfloat16"),
        (x, (("w", w.T),), (), ValueError, "contiguous"),
        (x, (("w", w.bfloat16()),), (), ValueError, "contiguous torch.float32"),
        (x, (("w", torch.zeros(128 * 128 + 1)[1:].view(128, 128)),), (), ValueError, "aligned"),
        (x, (), (("b", torch.zeros(127), 128),), ValueError, "hold 128"),
    )
    for xx, mats, vecs, exc, match in bad:
        with pytest.raises(exc, match=match):
            cuda_decode._device_operands(xx, mats, vecs, "test")
    scale, bias = cuda_decode._norm_vectors(x, torch.zeros(1), torch.zeros(1), "none", v)
    assert scale is v and bias is v
    # a width whose x^ slice overflows a block's shared memory raises before
    # any launch; the widest reference MLP (f32, 16 rows) fits
    with pytest.raises(ValueError, match="does not fit"):
        cuda_decode.check_fits((cuda_decode.matvec_plan(1 << 20, 128, 16, torch.bfloat16, 132),),
                               "fused_ln_matvec")
    with pytest.raises(ValueError, match="does not fit"):
        cuda_decode.check_fits(cuda_decode.mlp_plan(1 << 20, 128, 1, True, torch.float32, 132),
                               "fused_ln_mlp")
    cuda_decode.check_fits(cuda_decode.mlp_plan(4096, 16384, 16, True, torch.float32, 132), "ok")


def _source_constant(name: str) -> int:
    """``constexpr int NAME = <product of integers>;`` in csrc/decode.cu."""
    (expr,) = re.findall(rf"constexpr int {name} = ([0-9 *]+);", DECODE_SOURCE)
    return int(np.prod([int(t) for t in expr.split("*")]))


@pytest.mark.parametrize("name", ["THREADS", "MAX_NB", "ROW_BYTES", "STAGE_ROWS", "KSTEP",
                                  "MAX_CLUSTER", "RING_BYTES", "OUT_ROWS", "OUT_CLUSTER",
                                  "OUT_STAGE_ROW", "RING2_BYTES"])
def test_decode_planner_constants_match_the_kernel_source(name):
    assert getattr(cuda_decode, name) == _source_constant(name)


@pytest.mark.parametrize("d,n,b,gated,mlp,want", [
    # the plans csrc/decode.cu reports for the reference models on a 132-SM H100
    (1024, 3072, 1, False, False, (Plan(4, 256, 8, 8, 44232),)),          # Whisper qkv
    (1024, 3072, 16, False, False, (Plan(4, 256, 8, 8, 54600),)),
    (896, 1152, 1, False, False, (Plan(8, 112, 4, 4, 25512),)),           # Qwen2 qkv
    (1024, 4096, 1, False, True, (Plan(4, 256, 8, 8, 44232), Plan(2, 2048, 8, 8, 71376))),
    (1024, 4096, 16, False, True, (Plan(4, 256, 8, 8, 54600), Plan(2, 2048, 8, 8, 104784))),
    (896, 4864, 1, True, True, (Plan(4, 224, 7, 7, 74432), Plan(2, 2432, 10, 10, 85728))),
    (896, 4864, 16, True, True, (Plan(4, 224, 7, 7, 90432), Plan(2, 2432, 10, 10, 125280))),
])
def test_decode_plans_of_the_reference_models(d, n, b, gated, mlp, want):
    got = (cuda_decode.mlp_plan(d, n, b, gated, torch.bfloat16, 132) if mlp
           else (cuda_decode.matvec_plan(d, n, b, torch.bfloat16, 132),))
    assert got == want


@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
@pytest.mark.parametrize("gated", [False, True])
def test_stream_plans_cover_d_in_whole_k_steps_and_fit(dtype, gated):
    """Every split: a cluster of 1, 2, 4 or 8 whose slices of whole k-steps
    cover D and share the tile's columns evenly; a ring within its budget
    holding every stage when it can; the shared memory of the kernel's
    layout (1 KB of alignment for the swizzled ring, the ring, x^ slice,
    partials, the sums the cluster sends a block, a barrier a slot and one
    for those sums) within the opt-in limit; the
    grid at least one block an SM unless the cluster is at its limit."""
    es = torch.tensor([], dtype=dtype).element_size()
    g = 2 if gated else 1
    for d in (128, 200, 896, 1024, 1280, 4096):
        for n in (128, 384, 1152, 3072, 4864):
            for b in (1, 3, 8, 9, 16, 40):
                for sms in (132, 114):
                    p = cuda_decode.stream_plan(d, n, b, es, gated, sms)
                    tn = cuda_decode.ROW_BYTES // es
                    assert p.cluster in (1, 2, 4, 8) and tn % p.cluster == 0
                    assert p.ks % cuda_decode.KSTEP == 0 and p.cluster * p.ks >= d
                    assert p.stages * cuda_decode.STAGE_ROWS >= p.ks
                    assert p.slots <= p.stages
                    assert p.slots * g * cuda_decode.STAGE_BYTES <= cuda_decode.RING_BYTES
                    max_slots = cuda_decode.RING_BYTES // (g * cuda_decode.STAGE_BYTES)
                    assert p.slots == min(p.stages, max_slots)
                    assert p.cluster == 8 or (n // tn * p.cluster >= sms and p.stages <= max_slots)
                    nbp = 16 if min(b, 16) > 8 else 8
                    parts = 2 if es == 2 else 8
                    assert p.smem == (1024 + p.slots * g * 4096 + nbp * (p.ks * es + 16)
                                      + g * (parts + 1) * nbp * tn * 4 + 8 * (p.slots + 1))
                    assert p.smem <= cuda_decode.SMEM_OPTIN_BYTES


@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
def test_out_plans_split_f_over_a_cluster_in_512_byte_stages(dtype):
    """The MLP's second kernel: clusters of 2 blocks over 8 rows of W2^T,
    each a slice of F of whole 128-column groups covering F, in stages of 512
    bytes a row (4 KB, an mbarrier a stage), after 1 KB that aligns the
    swizzled ring; a ring of at most 96 KB in what
    the block's sums, the sums sent to it, u's slice ([nbp][fs + 8] bf16) and
    the warps' 16 x 8 partials (bf16) leave of a block's shared memory; f32
    reads u from device memory."""
    es = torch.tensor([], dtype=dtype).element_size()
    for f in (128, 384, 4096, 4864, 5120):
        for b in (1, 8, 9, 16):
            p = cuda_decode.out_plan(f, b, es)
            nbp = 16 if b > 8 else 8
            assert p.cluster == cuda_decode.OUT_CLUSTER == 2
            assert p.ks % 128 == 0 and p.cluster * p.ks >= f > (p.cluster - 1) * p.ks - 128
            fixed = 1024 + 2 * nbp * 8 * 4 + (4096 + nbp * (2 * p.ks + 16) if es == 2 else 0) + 16
            assert p.stages == -(-p.ks * es // 512)
            assert 1 <= p.slots <= min(p.stages, 23)
            assert p.smem == p.slots * (4096 + 8) + fixed
            assert p.smem <= cuda_decode.SMEM_OPTIN_BYTES
            if p.slots < p.stages:
                assert p.smem + 4104 > cuda_decode.SMEM_OPTIN_BYTES or p.slots == 23
