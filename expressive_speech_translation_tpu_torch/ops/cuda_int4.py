"""Packed-int4 weight-only matmul: the CUDA kernel of ``csrc/int4.cu``, its
plain PyTorch version, the packing, and the wrapper that picks by device.

Counterpart of the JAX package's ``ops/pallas_int4.py``, with its format:
symmetric per-column int4 in [-7, 7], two weights an int8 byte in split-K
order (low nibble: rows ``[0, K/2)``, high nibble: rows ``[K/2, K)``), the
f32 scale ``[1, N]`` applied after the dot, the output in x's dtype. The
JAX grid covers whole 128-column blocks only, so N is a multiple of 128.
Like the JAX function, it is no part of a serving path.
"""

from __future__ import annotations

import ctypes
from typing import Tuple

import torch

from . import build

LANE = 128
SMEM_OPTIN_BYTES = 232_448  # shared memory one block may opt into on Hopper


def pack_int4(w: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """w [K, N] float → (packed [K/2, N] int8, scale [1, N] f32), the same
    bytes as the JAX package's ``pack_int4``."""
    k, _ = w.shape
    if k % 2:
        raise ValueError(f"pack_int4 needs an even K, got {k}")
    scale = torch.clamp_min(w.abs().amax(dim=0, keepdim=True), 1e-8) / 7.0
    q = torch.clamp(torch.round(w / scale), -7, 7).to(torch.int32)
    lo, hi = q[: k // 2], q[k // 2:]
    packed = ((hi << 4) | (lo & 0x0F)) & 0xFF
    return packed.to(torch.uint8).view(torch.int8), scale.float()


def _nibbles(packed: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """packed [K/2, N] int8 → (rows [0, K/2), rows [K/2, K)) as exact f32."""
    p = packed.to(torch.int32)
    lo4 = p & 15
    lo = lo4 - ((lo4 & 8) << 1)            # sign-extend the low nibble
    hi = p >> 4                            # arithmetic shift: sign-correct
    return lo.float(), hi.float()


def unpack_int4(packed: torch.Tensor, scale: torch.Tensor,
                dtype=torch.bfloat16) -> torch.Tensor:
    """Inverse of :func:`pack_int4` → dequantised [K, N] weights in ``dtype``
    (the product with the scale in f32, as in the JAX package)."""
    return (torch.cat(_nibbles(packed), dim=0) * scale.float()).to(dtype)


def matmul_int4_plain(x: torch.Tensor, packed: torch.Tensor, scale: torch.Tensor) -> torch.Tensor:
    """The kernel's function in plain PyTorch: both half-K products of the
    exact integer weights in f32, summed, then scaled."""
    kh = packed.shape[0]
    lo, hi = _nibbles(packed)
    x32 = x.float()
    acc = x32[:, :kh] @ lo + x32[:, kh:] @ hi
    return (acc * scale.float().reshape(1, -1)).to(x.dtype)


def _lib():
    lib = build.load("int4")
    if lib.est_matmul_int4.argtypes is None:
        p, i, q = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong
        lib.est_matmul_int4.argtypes = [p, p, p, p, p, i, i, i, i, p]
        lib.est_matmul_int4.restype = i
        for fn in (lib.est_int4_scratch_floats, lib.est_int4_smem):
            fn.argtypes = [i, i, i, i]
            fn.restype = q
    return lib


def variant(dtype: torch.dtype) -> str:
    """The kernel a CUDA tensor of this dtype launches, decided here alone
    (:func:`matmul_int4` passes it on as the C entry point's bf16 flag): bf16
    x runs its products on the tensor cores, f32 x on the CUDA cores (tensor
    cores would round x to bf16 or TF32)."""
    return "tensor-core" if dtype == torch.bfloat16 else "cuda-core"


def matmul_int4(x: torch.Tensor, packed: torch.Tensor, scale: torch.Tensor) -> torch.Tensor:
    """x [B, K] @ dequant(packed [K/2, N], scale [1, N]) → [B, N] in x's
    dtype — the port of ``matmul_int4``.

    A CPU tensor takes :func:`matmul_int4_plain`; a CUDA tensor launches the
    kernel (counted in ``matmul_int4.launches``) or raises: the
    :func:`variant` of x's dtype."""
    if x.dim() != 2 or packed.dim() != 2:
        raise ValueError(f"matmul_int4 takes x [B, K] and packed [K/2, N], got "
                         f"{tuple(x.shape)} and {tuple(packed.shape)}")
    bsz, k = x.shape
    kh, n = packed.shape
    if kh * 2 != k:
        raise ValueError(f"x K={k} does not match packed K/2={kh}")
    if n % LANE:
        raise ValueError(f"N {n} is not a multiple of {LANE}")
    if scale.numel() != n:
        raise ValueError(f"scale must hold N={n} values, got {tuple(scale.shape)}")
    if x.device.type == "cpu":
        return matmul_int4_plain(x, packed, scale)
    if x.device.type != "cuda":
        raise ValueError(f"int4 kernel runs on CUDA or CPU tensors, got {x.device}")
    if x.dtype not in (torch.float32, torch.bfloat16):
        raise TypeError(f"int4 kernel takes float32 or bfloat16 x, got {x.dtype}")
    if packed.dtype != torch.int8:
        raise TypeError(f"packed weights must be int8, got {packed.dtype}")
    for name, t in (("x", x), ("packed", packed)):
        if t.device != x.device or not t.is_contiguous() or t.data_ptr() % 16:
            raise ValueError(f"int4 {name} must be contiguous, 16-byte aligned, on {x.device}")
    if scale.device != x.device:
        raise ValueError(f"int4 scale must be on {x.device}")
    with torch.cuda.device(x.device):    # the C side plans and sets attributes on the current card
        lib = _lib()
        bf16 = int(variant(x.dtype) == "tensor-core")
        if lib.est_int4_smem(bsz, k, n, bf16) > SMEM_OPTIN_BYTES:
            raise ValueError(f"matmul_int4: K={k} does not fit a block's shared memory")
        scale32 = scale.reshape(-1).float().contiguous()
        out = torch.empty((bsz, n), dtype=x.dtype, device=x.device)
        if bsz == 0:
            return out
        part = torch.empty((max(1, lib.est_int4_scratch_floats(bsz, k, n, bf16)),),
                           dtype=torch.float32, device=x.device)
        status = lib.est_matmul_int4(x.data_ptr(), packed.data_ptr(), scale32.data_ptr(),
                                     out.data_ptr(), part.data_ptr(), bsz, k, n, bf16,
                                     torch.cuda.current_stream(x.device).cuda_stream)
    build.check(status, "matmul_int4")
    matmul_int4.launches += 1
    return out


matmul_int4.launches = 0
