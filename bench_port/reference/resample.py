"""Band-limited resampling: a frozen copy of the port's ``ops/resample.py``."""

from __future__ import annotations

import functools

import numpy as np
import torch
import torch.nn.functional as F

from .windows import kaiser_sinc_filter


@functools.lru_cache(maxsize=32)
def _resample_plan(orig_freq: int, new_freq: int, lowpass_filter_width: int,
                   rolloff: float, beta: float | None):
    kernels, width = kaiser_sinc_filter(orig_freq, new_freq,
                                        lowpass_filter_width=lowpass_filter_width,
                                        rolloff=rolloff, beta=beta)
    gcd = int(np.gcd(orig_freq, new_freq))
    return kernels, width, orig_freq // gcd, new_freq // gcd


@functools.lru_cache(maxsize=32)
def _kernels(plan_key: tuple, device: torch.device) -> torch.Tensor:
    kernels = _resample_plan(*plan_key)[0]
    return torch.as_tensor(kernels, device=device)[:, None, :]   # [new_g, 1, K]


def resample(x: torch.Tensor, orig_freq: int, new_freq: int, *,
             lowpass_filter_width: int = 128, rolloff: float = 0.9475937167399596,
             beta: float | None = 14.769656459379492) -> torch.Tensor:
    """Resample [..., T] f32 from ``orig_freq`` to ``new_freq``. The output
    has ``ceil(T * new / orig)`` samples (torchaudio semantics)."""
    if orig_freq == new_freq:
        return x
    key = (orig_freq, new_freq, lowpass_filter_width, rolloff, beta)
    _, width, orig_g, new_g = _resample_plan(*key)
    t_in = x.shape[-1]
    lead = x.shape[:-1]
    num_blocks = -(-t_in // orig_g)
    target_len = -(-t_in * new_g // orig_g)
    # torchaudio's padding: `width` zeros on the left, width + orig_g on the right
    xb = F.pad(x.reshape(-1, 1, t_in), (width, width + orig_g))
    y = F.conv1d(xb, _kernels(key, x.device), stride=orig_g)[..., :num_blocks]
    # interleave the phases: output sample b * new_g + p is y[:, p, b]
    y = y.transpose(1, 2).reshape(-1, num_blocks * new_g)[..., :target_len]
    return y.reshape(*lead, target_len)
