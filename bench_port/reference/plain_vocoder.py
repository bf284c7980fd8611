"""The vocoder's resblock stage in plain PyTorch: a frozen copy of the
port's ``ops/cuda_vocoder.py`` plain version, under the names the copied
``cosyvoice.vocode`` calls. No kernel: every call computes in PyTorch."""

from __future__ import annotations

from typing import Sequence, Tuple

import torch
import torch.nn.functional as F


def stage_weights_flat(stage_params, kernels, dilations) -> Tuple[torch.Tensor, torch.Tensor]:
    """A vocoder stage's conv params (``[out, in, k]``) → ``(w [taps, C_in,
    C_out], b [convs, C])``: for each kernel-size branch, for each dilation
    unit, c1 then c2."""
    taps, biases = [], []
    for block, dils in zip(stage_params, dilations):
        for unit, _d in zip(block, dils):
            for conv in (unit["c1"], unit["c2"]):
                taps.append(conv["kernel"].permute(2, 1, 0))
                biases.append(conv["bias"])
    return torch.cat(taps).contiguous(), torch.stack(biases).contiguous()


def _conv_io(h: torch.Tensor, w_taps: torch.Tensor, bias: torch.Tensor, d: int,
             io: torch.dtype) -> torch.Tensor:
    """conv(io(lrelu(h))) on [B, C, T] f32 with zero padding, summed in f32."""
    a = F.leaky_relu(h, 0.1).to(io).float()
    k = w_taps.shape[0]
    return F.conv1d(a, w_taps.permute(2, 1, 0), bias, padding=d * (k - 1) // 2, dilation=d)


def fused_resblock_stage(x: torch.Tensor, weights: Tuple[torch.Tensor, torch.Tensor], *,
                         kernels: Sequence[int],
                         dilations: Sequence[Sequence[int]]) -> torch.Tensor:
    """One upsample stage's resblock battery, x [B, T, C] → [B, T, C]: the
    mean over kernel-size branches of sequential dilated units
    ``h += c2(lrelu(c1(lrelu(h), d)))``, sums in f32."""
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
