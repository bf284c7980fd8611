"""Fused norm→matvec and norm→MLP for decode steps: the CUDA kernels of
``csrc/decode.cu``, their plain PyTorch versions, and the wrappers that pick
between them by device.

Counterpart of the JAX package's ``ops/pallas_decode.py``, with its contract:
x ``[B, D]``, weights ``[D, N]`` (``pack_mlp`` rows ``[w1; w2ᵀ(; w_gate)]``),
widths N and F multiples of 128, norm statistics in f32, x̂ cast to x's dtype
before the first product, the MLP's hidden ``u`` cast to x's dtype before the
second, every sum in f32, the output in x's dtype. The small vectors (norm
scale and bias, biases) are read as f32. The TPU's weight-chunk width has no
counterpart here: the kernels tile for the card themselves, and
:func:`stream_plan` / :func:`out_plan` mirror the split they choose. Like the
JAX functions, these are no part of a decode loop yet.
"""

from __future__ import annotations

import ctypes
from typing import NamedTuple, Optional, Tuple

import torch
import torch.nn.functional as F

from . import build

NORMS = {"none": 0, "layer": 1, "rms": 2}
ACTIVATIONS = {"none": 0, "gelu": 1, "silu": 2, "relu": 3}
LANE = 128                  # the JAX kernels' weight-width quantum
SMEM_OPTIN_BYTES = 232_448  # shared memory one block may opt into on Hopper

# csrc/decode.cu's work split (tests/test_torch_decode_kernels.py holds these
# against the source's constants)
THREADS = 256
MAX_NB = 16                 # batch rows a launch
ROW_BYTES = 128             # a tile row: 64 bf16 or 32 f32 columns
STAGE_ROWS = 32             # weight rows a stream-kernel ring stage
STAGE_BYTES = STAGE_ROWS * ROW_BYTES
KSTEP = 16                  # rows an mma k-step
MAX_CLUSTER = 8
RING_BYTES = 64 * 1024
OUT_ROWS = 8                # second MLP kernel: rows of W2ᵀ a block
OUT_CLUSTER = 2             # ... blocks a cluster, each a slice of F
OUT_STAGE_ROW = 512         # ... bytes of a row a stage
RING2_BYTES = 96 * 1024


class Plan(NamedTuple):
    """A kernel's work split: blocks a cluster, rows of D a block (``ks``;
    the second MLP kernel's columns of F), ring stages, ring slots, shared
    bytes a block."""
    cluster: int
    ks: int
    stages: int
    slots: int
    smem: int


def _ceil_div(a: int, b: int) -> int:
    return -(-a // b)


def stream_plan(d: int, n: int, b: int, es: int, gated: bool, sms: int) -> Plan:
    """The stream kernel's split for ``min(b, 16)`` batch rows, ``es`` bytes
    an element: tiles of 128-byte rows, the smallest cluster of 1, 2, 4 or 8
    slices of D that gives each of ``sms`` SMs a block and whose ring holds
    the whole slice (``decode.cu`` ``stream_plan``)."""
    g = 2 if gated else 1
    nbp = 16 if min(b, MAX_NB) > 8 else 8
    tn, parts = ROW_BYTES // es, 2 if es == 2 else THREADS // 32
    max_slots = RING_BYTES // (g * STAGE_BYTES)
    cluster = 1
    while True:
        ks = _ceil_div(_ceil_div(d, cluster), KSTEP) * KSTEP
        stages = _ceil_div(ks, STAGE_ROWS)
        if cluster == MAX_CLUSTER or (n // tn * cluster >= sms and stages <= max_slots):
            break
        cluster *= 2
    slots = min(stages, max_slots)
    smem = (1024 + slots * g * STAGE_BYTES + nbp * (ks * es + 16)
            + g * (parts + 1) * nbp * tn * 4 + (slots + 1) * 8)
    return Plan(cluster, ks, stages, slots, smem)


def out_plan(f: int, b: int, es: int) -> Plan:
    """The second MLP kernel's split: clusters of ``OUT_CLUSTER`` blocks over 8
    rows of W2ᵀ, each block a slice of ``fs`` columns of F (whole 128-column
    groups; reported as ``ks``) in stages of 512 bytes a row (four TMA boxes
    of 8 x 128 bytes); bf16 keeps u's slice ``[nbp][fs + 8]`` and the warps'
    partials beside the ring, which takes what is left of the block's shared
    memory up to its budget (``decode.cu`` ``out_plan``)."""
    stage, nbp = OUT_ROWS * OUT_STAGE_ROW, 16 if min(b, MAX_NB) > 8 else 8
    fs = _ceil_div(f, OUT_CLUSTER * 128) * 128
    fixed = (1024 + 2 * nbp * OUT_ROWS * 4
             + (8 * 16 * OUT_ROWS * 4 + nbp * (fs * es + 16) if es == 2 else 0) + 16)
    room = min(SMEM_OPTIN_BYTES - fixed, RING2_BYTES)
    stages = _ceil_div(fs * es, OUT_STAGE_ROW)
    slots = min(stages, max(1, room // (stage + 8)))
    return Plan(OUT_CLUSTER, fs, stages, slots, slots * (stage + 8) + fixed)


def matvec_plan(d: int, n: int, b: int, dtype: torch.dtype, sms: int) -> Plan:
    return stream_plan(d, n, b, torch.tensor([], dtype=dtype).element_size(), False, sms)


def mlp_plan(d: int, f: int, b: int, gated: bool, dtype: torch.dtype,
             sms: int) -> Tuple[Plan, Plan]:
    es = torch.tensor([], dtype=dtype).element_size()
    return stream_plan(d, f, b, es, gated, sms), out_plan(f, b, es)


def pack_mlp(w1: torch.Tensor, w2: torch.Tensor,
             w_gate: Optional[torch.Tensor] = None) -> torch.Tensor:
    """``[w1; w2ᵀ(; w_gate)]`` → ``[2D | 3D, F]`` (w1, w_gate ``[D, F]``,
    w2 ``[F, D]``), the JAX package's packed layout. Call once at weight
    preparation."""
    parts = [w1, w2.T]
    if w_gate is not None:
        parts.append(w_gate)
    return torch.cat(parts, dim=0).contiguous()


def _normed(x: torch.Tensor, scale: torch.Tensor, bias: torch.Tensor, norm: str,
            eps: float) -> torch.Tensor:
    """norm(x) with f32 statistics, cast to x's dtype."""
    x32 = x.float()
    if norm == "layer":
        mean = x32.mean(dim=-1, keepdim=True)
        var = ((x32 - mean) ** 2).mean(dim=-1, keepdim=True)
        y = (x32 - mean) * torch.rsqrt(var + eps) * scale.float() + bias.float()
    elif norm == "rms":
        y = x32 * torch.rsqrt((x32 * x32).mean(dim=-1, keepdim=True) + eps) * scale.float()
    else:
        y = x32
    return y.to(x.dtype)


def _act(u: torch.Tensor, activation: str) -> torch.Tensor:
    if activation == "gelu":
        return F.gelu(u)          # exact erf (the JAX kernel's A&S polynomial is within 1.5e-7)
    if activation == "silu":
        return F.silu(u)
    if activation == "relu":
        return torch.relu(u)
    return u


def fused_ln_matvec_plain(x, scale, bias, w, b, *, norm: str = "layer",
                          eps: float = 1e-5) -> torch.Tensor:
    """The kernel's function in plain PyTorch: ``norm(x) @ w + b``. The
    products of x's-dtype operands are exact in f32, so the f32 matmul is the
    kernel's arithmetic up to summation order."""
    xh = _normed(x, scale, bias, norm, eps)
    return (xh.float() @ w.float() + b.float()).to(x.dtype)


def fused_ln_mlp_plain(x, scale, bias, w_packed, b1, b2, *, gated: bool = False,
                       norm: str = "layer", eps: float = 1e-5, activation: str = "gelu",
                       residual: bool = True) -> torch.Tensor:
    """The kernel's function in plain PyTorch: ``[x +] act(x̂@w1+b1) @ w2 + b2``,
    gated ``[x +] (act(x̂@w_gate) * (x̂@w1+b1)) @ w2 + b2``."""
    d = x.shape[-1]
    wp = w_packed.float()
    xh = _normed(x, scale, bias, norm, eps).float()
    h = xh @ wp[:d] + b1.float()
    u = _act(xh @ wp[2 * d:], activation) * h if gated else _act(h, activation)
    y = u.to(x.dtype).float() @ wp[d:2 * d].T + b2.float()
    if residual:
        y = y + x.float()
    return y.to(x.dtype)


def _lib():
    lib = build.load("decode")
    if lib.est_ln_matvec.argtypes is None:
        p, i, f = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
        lib.est_ln_matvec.argtypes = [p, p, p, p, p, p, i, i, i, i, f, i, p]
        lib.est_ln_matvec.restype = i
        lib.est_ln_mlp.argtypes = [p, p, p, p, p, p, p, p, i, i, i, i, f, i, i, i, i, p]
        lib.est_ln_mlp.restype = i
        lib.est_ln_matvec_plan.argtypes = [i, i, i, i, i, p]
        lib.est_ln_matvec_plan.restype = None
        lib.est_ln_mlp_plan.argtypes = [i, i, i, i, i, i, p]
        lib.est_ln_mlp_plan.restype = None
    return lib


def kernel_plans(d: int, n: int, b: int, dtype: torch.dtype, sms: int = 0, *,
                 mlp: bool = False, gated: bool = False) -> Tuple[Plan, ...]:
    """The split ``decode.cu`` itself reports for a call (``sms`` 0: the
    card's SM count): (stream plan,) for ln_matvec, (stream, second) for
    ln_mlp. Needs the built library."""
    lib = _lib()
    out = (ctypes.c_int * 10)()
    bf16 = int(dtype == torch.bfloat16)
    if mlp:
        lib.est_ln_mlp_plan(d, n, b, int(gated), bf16, sms, out)
        return Plan(*out[:5]), Plan(*out[5:])
    lib.est_ln_matvec_plan(d, n, b, bf16, sms, out)
    return (Plan(*out[:5]),)


def check_fits(plans, what: str) -> None:
    """Raise before any launch when a kernel's split needs more shared memory
    than one block may opt into (x^'s slice grows with D)."""
    need = max(p.smem for p in plans)
    if need > SMEM_OPTIN_BYTES:
        raise ValueError(f"{what} does not fit a block's shared memory "
                         f"({need} > {SMEM_OPTIN_BYTES} bytes)")


def _sms(x: torch.Tensor) -> int:
    return torch.cuda.get_device_properties(x.device).multi_processor_count


def _check_width(width: int, what: str) -> None:
    if width % LANE:
        raise ValueError(f"{what} {width} is not a multiple of {LANE}")


def _check_norm(norm: str, activation: str = "none") -> None:
    if norm not in NORMS:
        raise ValueError(f"norm must be one of {sorted(NORMS)}, got {norm!r}")
    if activation not in ACTIVATIONS:
        raise ValueError(f"activation must be one of {sorted(ACTIVATIONS)}, got {activation!r}")


def _device_operands(x: torch.Tensor, mats, vecs, what: str):
    """Validate x and the weight matrices for a launch (CUDA, contiguous,
    16-byte aligned, x's dtype); return the small vectors as contiguous f32."""
    if x.dtype not in (torch.float32, torch.bfloat16):
        raise TypeError(f"{what} kernel takes float32 or bfloat16, got {x.dtype}")
    for name, t in (("x", x),) + tuple(mats):
        if t.device != x.device or t.dtype != x.dtype or not t.is_contiguous():
            raise ValueError(f"{what} {name} must be contiguous {x.dtype} on {x.device}")
        if t.data_ptr() % 16:
            raise ValueError(f"{what} {name} must be 16-byte aligned")
    out = []
    for name, v, n in vecs:
        if v.device != x.device or v.numel() != n:
            raise ValueError(f"{what} {name} must hold {n} values on {x.device}")
        v = v.reshape(-1).float().contiguous()
        out.append(v if v.data_ptr() % 16 == 0 else v.clone())   # the kernels' 16-byte loads
    return out


def _norm_vectors(x: torch.Tensor, scale, bias, norm: str, unused: torch.Tensor):
    """The norm's scale and bias as f32 on the card; a vector the norm does
    not read (any placeholder, as the JAX functions take) is replaced by
    ``unused``."""
    d = x.shape[-1]
    wanted = (("scale", scale, d),) if norm != "none" else ()
    wanted += (("bias", bias, d),) if norm == "layer" else ()
    got = _device_operands(x, (), wanted, "norm")
    return (got[0] if norm != "none" else unused), (got[1] if norm == "layer" else unused)


def _stream(x: torch.Tensor) -> int:
    return torch.cuda.current_stream(x.device).cuda_stream


def fused_ln_matvec(x: torch.Tensor, scale: torch.Tensor, bias: torch.Tensor,
                    w: torch.Tensor, b: torch.Tensor, *, norm: str = "layer",
                    eps: float = 1e-5) -> torch.Tensor:
    """``norm(x) @ w + b``: x ``[B, D]``, w ``[D, N]`` with N % 128 == 0, b
    ``[N]``; ``scale``/``bias`` ``[D]`` (read only by the norms that use
    them) → ``[B, N]`` in x's dtype — the port of ``fused_ln_matvec``.

    A CPU tensor takes :func:`fused_ln_matvec_plain`; a CUDA tensor launches
    the kernel (counted in ``fused_ln_matvec.launches``) or raises."""
    _check_norm(norm)
    bsz, d = x.shape
    if w.ndim != 2 or w.shape[0] != d:
        raise ValueError(f"w must be [{d}, N], got {tuple(w.shape)}")
    n = w.shape[1]
    _check_width(n, "weight width N")
    if x.device.type == "cpu":
        return fused_ln_matvec_plain(x, scale, bias, w, b, norm=norm, eps=eps)
    if x.device.type != "cuda":
        raise ValueError(f"decode kernels run on CUDA or CPU tensors, got {x.device}")
    (b32,) = _device_operands(x, (("w", w),), (("b", b, n),), "fused_ln_matvec")
    scale32, bias32 = _norm_vectors(x, scale, bias, norm, b32)
    check_fits((matvec_plan(d, n, bsz, x.dtype, _sms(x)),), f"fused_ln_matvec: D={d}")
    out = torch.empty((bsz, n), dtype=x.dtype, device=x.device)
    if bsz == 0:
        return out
    with torch.cuda.device(x.device):    # the C side plans and sets attributes on the current card
        status = _lib().est_ln_matvec(x.data_ptr(), scale32.data_ptr(), bias32.data_ptr(),
                                      w.data_ptr(), b32.data_ptr(), out.data_ptr(), bsz, d, n,
                                      NORMS[norm], eps, int(x.dtype == torch.bfloat16),
                                      _stream(x))
    build.check(status, "fused_ln_matvec")
    fused_ln_matvec.launches += 1
    return out


fused_ln_matvec.launches = 0


def fused_ln_mlp(x: torch.Tensor, scale: torch.Tensor, bias: torch.Tensor,
                 w_packed: torch.Tensor, b1: torch.Tensor, b2: torch.Tensor, *,
                 gated: bool = False, norm: str = "layer", eps: float = 1e-5,
                 activation: str = "gelu", residual: bool = True) -> torch.Tensor:
    """``[x +] act(norm(x) @ w1 + b1) @ w2 + b2`` — or, ``gated``,
    ``[x +] (act(x̂ @ w_gate) * (x̂ @ w1 + b1)) @ w2 + b2`` — with
    ``w_packed = pack_mlp(w1, w2[, w_gate])`` ``[2D | 3D, F]``, F % 128 == 0,
    b1 ``[F]``, b2 ``[D]`` → ``[B, D]`` in x's dtype: the port of
    ``fused_ln_mlp``.

    A CPU tensor takes :func:`fused_ln_mlp_plain`; a CUDA tensor launches the
    kernel (counted in ``fused_ln_mlp.launches``) or raises."""
    _check_norm(norm, activation)
    bsz, d = x.shape
    rows = 3 * d if gated else 2 * d
    if w_packed.ndim != 2 or w_packed.shape[0] != rows:
        raise ValueError(f"w_packed must be [{rows}, F] for D={d}, gated={gated}, "
                         f"got {tuple(w_packed.shape)}")
    f = w_packed.shape[1]
    _check_width(f, "hidden width F")
    kw = dict(gated=gated, norm=norm, eps=eps, activation=activation, residual=residual)
    if x.device.type == "cpu":
        return fused_ln_mlp_plain(x, scale, bias, w_packed, b1, b2, **kw)
    if x.device.type != "cuda":
        raise ValueError(f"decode kernels run on CUDA or CPU tensors, got {x.device}")
    b1_32, b2_32 = _device_operands(x, (("w_packed", w_packed),),
                                    (("b1", b1, f), ("b2", b2, d)), "fused_ln_mlp")
    scale32, bias32 = _norm_vectors(x, scale, bias, norm, b2_32)
    check_fits(mlp_plan(d, f, bsz, gated, x.dtype, _sms(x)), f"fused_ln_mlp: D={d}, F={f}")
    out = torch.empty_like(x)
    if bsz == 0:
        return out
    u = torch.empty((min(bsz, MAX_NB), f), dtype=x.dtype, device=x.device)
    with torch.cuda.device(x.device):
        status = _lib().est_ln_mlp(x.data_ptr(), scale32.data_ptr(), bias32.data_ptr(),
                                   w_packed.data_ptr(), b1_32.data_ptr(), b2_32.data_ptr(),
                                   out.data_ptr(), u.data_ptr(), bsz, d, f, NORMS[norm], eps,
                                   ACTIVATIONS[activation], int(gated), int(residual),
                                   int(x.dtype == torch.bfloat16), _stream(x))
    build.check(status, "fused_ln_mlp")
    fused_ln_mlp.launches += 1
    return out


fused_ln_mlp.launches = 0
