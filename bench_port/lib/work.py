"""The yardstick's arithmetic: the card's peaks and the operations and
bytes a kernel's function needs for the shapes it is handed.

Peaks: one NVIDIA H100 SXM, NVIDIA's data sheet, dense: 989 TFLOP/s bf16,
67 TFLOP/s f32 outside the tensor cores, 3.35 TB/s of HBM. A roofline's
bound is max(operations / peak rate, bytes / peak bandwidth), counting each
input byte read once and each output byte written once."""

from __future__ import annotations

from typing import Sequence, Tuple

PEAK_BF16 = 989e12
PEAK_F32 = 67e12
PEAK_BYTES = 3.35e12


def peak_rate(element_bytes: int) -> float:
    return PEAK_BF16 if element_bytes == 2 else PEAK_F32


def resblock_work(b: int, c: int, t: int, element_bytes: int, kernels: Sequence[int],
                  dilations: Sequence[Sequence[int]]) -> Tuple[float, float]:
    """(operations, bytes) of one resblock stage over x [B, T, C]: each
    kernel-size branch runs, for each dilation, two C×C convs of its width
    (2 C² T operations a tap a row); x is read and the output written once,
    the weights ([taps, C, C]) and biases ([convs, C]) read once."""
    taps = sum(2 * k * len(d) for k, d in zip(kernels, dilations))
    convs = sum(2 * len(d) for d in dilations)
    flops = 2.0 * c * c * t * taps * b
    nbytes = (2.0 * b * t * c + taps * c * c + convs * c) * element_bytes
    return flops, nbytes


def bound_s(flops: float, nbytes: float, element_bytes: int) -> float:
    """The least time the card could take for the work."""
    return max(flops / peak_rate(element_bytes), nbytes / PEAK_BYTES)


def mfu_pct(flops: float, seconds: float) -> float:
    """Share of the bf16 peak that ``flops`` of model work in ``seconds`` is."""
    return 100.0 * flops / (seconds * PEAK_BF16)
