"""Fused vocoder resblock stage: the CUDA kernels of ``csrc/resblock.cu``,
their plain PyTorch version, and the wrapper that picks by device (and, on
the card, by dtype and width through :func:`plan`: the wgmma variant for bf16
with C = 64 or 128, the CUDA-core variant otherwise).

Counterpart of the JAX package's ``ops/pallas_vocoder.py``. One call runs a
HiFi-GAN upsample stage's whole resblock battery — the mean over kernel-size
branches of sequential dilated units ``h += c2(lrelu(c1(lrelu(h), d)))`` —
with the conv operands in the io dtype (bf16 in serving) and every sum, and
the branch state, in f32.
"""

from __future__ import annotations

import ctypes
from typing import NamedTuple, Sequence, Tuple

import torch
import torch.nn.functional as F

from . import build

MAX_BRANCHES = 4          # csrc/resblock.cu MAX_BRANCH / MAX_DIL
MAX_DILATIONS = 4
MAX_TAP_OFFSET = 32       # zero margin of the kernels' operand rows
KERNEL_SIZES = (3, 5, 7, 9, 11)
SMEM_OPTIN_BYTES = 232_448  # shared memory one block may opt into on Hopper
MIN_TILE = 8
WG_WINDOW = {64: 512, 128: 256}   # wgmma variant: C -> window rows (csrc/resblock.cu)
WG_STAGES = 2               # csrc/resblock.cu WG_STAGES, WG_CS_PAD, WG_THREADS
WG_CS_PAD = 8
WG_THREADS = 384
CORE_RTS = (8, 6, 4)        # CUDA-core variant: columns a lane (window 32 * rt)


class Plan(NamedTuple):
    variant: str       # "wgmma" or "cuda-core"
    window: int        # rows of time a block computes, halo included
    smem_bytes: int
    threads: int


def stage_halo(kernels: Sequence[int], dilations: Sequence[Sequence[int]]) -> int:
    """Total receptive-field half-width of one stage's worst branch."""
    worst = 0
    for k, dils in zip(kernels, dilations):
        c = (k - 1) // 2
        worst = max(worst, sum(c * d + c for d in dils))
    return worst


def stage_weights_flat(stage_params, kernels, dilations) -> Tuple[torch.Tensor, torch.Tensor]:
    """A vocoder stage's conv params (torch layout ``[out, in, k]``) →
    ``(w [taps, C_in, C_out], b [convs, C])`` in the kernel's order: for each
    kernel-size branch, for each dilation unit, c1 then c2."""
    taps, biases = [], []
    for block, dils in zip(stage_params, dilations):
        for unit, _d in zip(block, dils):
            for conv in (unit["c1"], unit["c2"]):
                taps.append(conv["kernel"].permute(2, 1, 0))
                biases.append(conv["bias"])
    return torch.cat(taps).contiguous(), torch.stack(biases).contiguous()


def stage_margin(kernels: Sequence[int], dilations: Sequence[Sequence[int]]) -> int:
    """The largest tap offset (k - 1) / 2 * d of a stage: the zero rows the
    wgmma variant keeps each side of its operand."""
    return max((k - 1) // 2 * d for k, dils in zip(kernels, dilations) for d in dils)


def wg_chunk_width(c: int) -> int:
    """Input channels in one chunk of the wgmma variant's weight ring: 64 (the
    128-byte swizzle) at C = 64, 32 (the 64-byte swizzle) at C = 128."""
    return 64 if c == 64 else 32


def wg_swizzle(row: torch.Tensor, kw: int) -> torch.Tensor:
    """The XOR applied to a 16-byte group's index in chunk row ``row``: the
    128-byte swizzle (kw = 64) takes row % 8, the 64-byte one (row % 8) // 2."""
    return row % 8 if kw == 64 else (row % 8) // 2


def wgmma_weight_image(w: torch.Tensor) -> torch.Tensor:
    """``w`` [taps, C_in, C_out] → the wgmma variant's weight image, flat: for
    each tap and each chunk of KW input channels, C_out rows of KW elements,
    the row's 16-byte groups (8 elements) permuted by
    ``group ^ wg_swizzle(row)``, the shared-memory layout of a K-major wgmma
    operand, so that one bulk copy moves a chunk into place."""
    taps, c, _ = w.shape
    kw = wg_chunk_width(c)
    t = w.transpose(1, 2).reshape(taps, c, c // kw, kw).permute(0, 2, 1, 3)
    t = t.reshape(taps, c // kw, c // 8, 8, kw // 8, 8)   # [.., row group, row, group, element]
    rows = torch.arange(8, device=w.device)
    groups = torch.arange(kw // 8, device=w.device)
    src = groups[None, :] ^ wg_swizzle(rows, kw)[:, None]  # image group p holds group p ^ s
    return t[:, :, :, rows[:, None], src, :].contiguous().reshape(-1)


def _conv_io(h: torch.Tensor, w_taps: torch.Tensor, bias: torch.Tensor, d: int,
             io: torch.dtype) -> torch.Tensor:
    """conv(io(lrelu(h))) on [B, C, T] f32 with zero padding, summed in f32."""
    a = F.leaky_relu(h, 0.1).to(io).float()
    k = w_taps.shape[0]
    return F.conv1d(a, w_taps.permute(2, 1, 0), bias, padding=d * (k - 1) // 2, dilation=d)


def resblock_stage_plain(x: torch.Tensor, weights: Tuple[torch.Tensor, torch.Tensor], *,
                         kernels: Sequence[int],
                         dilations: Sequence[Sequence[int]]) -> torch.Tensor:
    """The kernel's function in plain PyTorch: x [B, T, C] → [B, T, C]."""
    io = x.dtype
    w = weights[0].to(io).float()
    b = weights[1].to(io).float()
    x32 = x.float().transpose(1, 2)
    total = None
    tap = conv = 0
    for k, dils in zip(kernels, dilations):
        h = x32
        for d in dils:
            y = _conv_io(h, w[tap:tap + k], b[conv], d, io)
            y = _conv_io(y, w[tap + k:tap + 2 * k], b[conv + 1], 1, io)
            tap += 2 * k
            conv += 2
            h = h + y
        total = h if total is None else total + h
    return (total / len(kernels)).to(io).transpose(1, 2)


def _lib():
    lib = build.load("resblock")
    fn = lib.est_resblock_stage
    if fn.argtypes is None:
        p, i, q = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong
        fn.argtypes = [p, p, p, p, p, i, i, i, q, q, q, q, q, q, i, i, p, p, p, i, i, i, i, p]
        fn.restype = ctypes.c_int
        lib.est_resblock_smem_bytes.argtypes = [i, i, i]
        lib.est_resblock_smem_bytes.restype = ctypes.c_longlong
        lib.est_resblock_wg_smem_bytes.argtypes = [i, i, i]
        lib.est_resblock_wg_smem_bytes.restype = ctypes.c_longlong
    return lib


def _validate(x, w, b, kernels, dilations) -> None:
    bsz, t, c = x.shape
    if x.dtype not in (torch.float32, torch.bfloat16):
        raise TypeError(f"resblock kernel takes float32 or bfloat16, got {x.dtype}")
    if c % 8 or c > 128:
        raise ValueError(f"resblock kernel needs C % 8 == 0 and C <= 128, got C={c}")
    if len(kernels) > MAX_BRANCHES or any(len(d) > MAX_DILATIONS for d in dilations):
        raise ValueError("resblock kernel takes at most 4 branches of 4 dilations")
    if any(k not in KERNEL_SIZES for k in kernels):
        raise ValueError(f"resblock kernel sizes must be in {KERNEL_SIZES}, got {kernels}")
    if any((k - 1) // 2 * d > MAX_TAP_OFFSET for k, ds in zip(kernels, dilations) for d in ds):
        raise ValueError("resblock kernel tap offset (k-1)/2*d exceeds 32")
    taps = sum(2 * k * len(ds) for k, ds in zip(kernels, dilations))
    convs = sum(2 * len(ds) for ds in dilations)
    if tuple(w.shape) != (taps, c, c) or tuple(b.shape) != (convs, c):
        raise ValueError(f"weights {tuple(w.shape)}/{tuple(b.shape)} do not fit "
                         f"{taps} taps and {convs} convs of C={c}")
    for name, tensor in (("weights", w), ("bias", b)):
        if tensor.device != x.device or tensor.dtype != x.dtype or not tensor.is_contiguous():
            raise ValueError(f"resblock {name} must be contiguous {x.dtype} on {x.device}")


def wg_smem_bytes(c: int, window: int, margin: int) -> int:
    """Shared memory of the wgmma variant (``est_resblock_wg_smem_bytes``):
    1 KB of alignment slack, the weight ring and its barriers, h [window][C]
    in f32, aT [window + 2 margin][C + 8] in bf16."""
    chunk = c * wg_chunk_width(c) * 2
    return (1024 + WG_STAGES * chunk + 16 * WG_STAGES + 4 * window * c
            + 2 * (window + 2 * margin) * (c + WG_CS_PAD))


def core_smem_bytes(c: int, rt: int, io_bytes: int) -> int:
    """Shared memory of the CUDA-core variant (``est_resblock_smem_bytes``):
    h [C][32 rt + 1] in f32, the operand [C][32 rt + 64] in the io dtype."""
    h = (c * (32 * rt + 1) * 4 + 15) & ~15
    return h + c * (32 * rt + 2 * MAX_TAP_OFFSET) * io_bytes


def plan(c: int, dtype: torch.dtype, kernels: Sequence[int],
         dilations: Sequence[Sequence[int]]) -> Plan:
    """Which variant runs a stage of C channels, and its window: the wgmma
    variant for bf16 with C = 64 or 128 where its window's shared memory fits
    a block, else the CUDA-core variant at the widest of its windows that
    fits. Every window leaves a tile of at least MIN_TILE."""
    halo, margin = stage_halo(kernels, dilations), stage_margin(kernels, dilations)
    w = WG_WINDOW.get(c)
    if dtype == torch.bfloat16 and w:
        smem = wg_smem_bytes(c, w, margin)
        if w - 2 * halo >= MIN_TILE and smem <= SMEM_OPTIN_BYTES:
            return Plan("wgmma", w, smem, WG_THREADS)
    es = 2 if dtype == torch.bfloat16 else 4
    for rt in CORE_RTS:
        smem = core_smem_bytes(c, rt, es)
        if 32 * rt - 2 * halo >= MIN_TILE and smem <= SMEM_OPTIN_BYTES:
            return Plan("cuda-core", 32 * rt, smem, c // 8 * 32)
    raise ValueError(f"resblock kernel: no window fits C={c} with halo {halo}")


def variant(x: torch.Tensor, kernels: Sequence[int], dilations: Sequence[Sequence[int]]) -> str:
    """The kernel variant a CUDA tensor like ``x`` [B, T, C] runs."""
    return plan(x.shape[-1], x.dtype, kernels, dilations).variant


def fused_resblock_stage(x: torch.Tensor, weights: Tuple[torch.Tensor, torch.Tensor], *,
                         kernels: Sequence[int],
                         dilations: Sequence[Sequence[int]]) -> torch.Tensor:
    """One vocoder stage's resblock battery. x [B, T, C] (any strides) →
    [B, T, C] with x's layout; ``weights`` from :func:`stage_weights_flat`.

    A CPU tensor takes :func:`resblock_stage_plain`; a CUDA tensor launches
    the kernel (counted in ``fused_resblock_stage.launches``) or raises."""
    if x.device.type == "cpu":
        return resblock_stage_plain(x, weights, kernels=kernels, dilations=dilations)
    if x.device.type != "cuda":
        raise ValueError(f"resblock kernel runs on CUDA or CPU tensors, got {x.device}")
    w, b = weights
    _validate(x, w, b, kernels, dilations)
    bsz, t, c = x.shape
    out = torch.empty_like(x)
    if t == 0:
        return out
    lib = _lib()
    halo = stage_halo(kernels, dilations)
    pl = plan(c, x.dtype, kernels, dilations)
    wg = pl.variant == "wgmma"
    if wg:
        w = wgmma_weight_image(w)
    scratch = torch.empty((bsz * c * t,), dtype=torch.float32, device=x.device)  # branch sum
    n = len(kernels)
    ks = (ctypes.c_int * n)(*kernels)
    n_dil = (ctypes.c_int * n)(*[len(d) for d in dilations])
    dil = (ctypes.c_int * (n * MAX_DILATIONS))(
        *[v for d in dilations for v in (list(d) + [0] * (MAX_DILATIONS - len(d)))])
    with torch.cuda.device(x.device):    # the C side sets attributes on the current card
        status = lib.est_resblock_stage(
            x.data_ptr(), out.data_ptr(), scratch.data_ptr(), w.data_ptr(), b.data_ptr(),
            bsz, t, c, *x.stride(), *out.stride(), halo, n,
            ctypes.addressof(ks), ctypes.addressof(n_dil), ctypes.addressof(dil),
            int(x.dtype == torch.bfloat16), 0 if wg else pl.window // 32,
            pl.window if wg else 0, stage_margin(kernels, dilations),
            torch.cuda.current_stream(x.device).cuda_stream)
    build.check(status, "fused_resblock_stage")
    fused_resblock_stage.launches += 1
    return out


fused_resblock_stage.launches = 0
