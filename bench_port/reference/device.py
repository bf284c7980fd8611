"""Where the reference runs: a frozen copy of the port's ``core/device.py``
(f32 matmuls and convs in full IEEE f32 on the card)."""

from __future__ import annotations

from typing import Optional, Union

import torch


def resolve_device(device: Optional[Union[str, torch.device]] = None) -> torch.device:
    """``None`` means ``"cuda"``. Raises when that is asked for and there is no
    CUDA device: nothing falls back to the CPU unless the caller says so.

    On the card, f32 matmuls and convs run in full IEEE f32: cuDNN would run
    f32 convs in TF32 by default, which keeps about three decimal digits."""
    dev = torch.device("cuda" if device is None else device)
    if dev.type == "cuda":
        if not torch.cuda.is_available():
            raise RuntimeError(
                "no CUDA device: the port runs on the card; pass device='cpu' "
                "to run it on the CPU")
        torch.backends.cuda.matmul.allow_tf32 = False
        torch.backends.cudnn.allow_tf32 = False
    return dev
