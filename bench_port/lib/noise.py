"""The TTS engine's noise, made by the benchmark from ``--seed``: zero
Gumbel draws, so the speech LM decodes greedily and its tokens can be judged
by their logits, and seeded Gaussian draws for the flow's x_0 and HiFT's
source, which the reference draws again. It follows the port's
``NoiseSource`` protocol; streaming's draws are not served."""

from __future__ import annotations

from typing import Dict, Tuple

import numpy as np
import torch

FLOW, HIFT = 1, 2


def mix(*index: int) -> int:
    """One 63-bit seed from whole numbers (``--seed`` may be any)."""
    seq = np.random.SeedSequence([int(i) % 2**64 for i in index])
    return int(seq.generate_state(1, np.uint64)[0]) >> 1


class BenchNoise:
    """The draws of one synthesis call ``call`` of a run seeded ``seed``.
    Every draw is a function of (seed, call, kind, shape), so the reference
    redraws it; ``shapes`` keeps what was asked."""

    def __init__(self, seed: int, call: int, device):
        self.seed, self.call, self.device = int(seed), int(call), torch.device(device)
        self.shapes: Dict[str, tuple] = {}
        self._zeros: Dict[Tuple[int, ...], torch.Tensor] = {}

    def _gen(self, kind: int) -> torch.Generator:
        return torch.Generator(device=self.device).manual_seed(mix(self.seed, self.call, kind))

    def _zero_pair(self, shape):
        z = self._zeros.get(tuple(shape))
        if z is None:
            z = self._zeros[tuple(shape)] = torch.zeros(shape, device=self.device)
        return z, z

    def ras_gumbel(self, step, shape):
        return self._zero_pair(shape)

    def mtp_gumbel(self, pass_index, head, shape):
        return self._zero_pair(shape)

    def flow_x0(self, shape):
        self.shapes["flow_x0"] = tuple(shape)
        return torch.randn(shape, generator=self._gen(FLOW), device=self.device)

    def hift_source(self, phase_shape, noise_shape):
        self.shapes["hift_source"] = (tuple(phase_shape), tuple(noise_shape))
        gen = self._gen(HIFT)
        phase = torch.rand(phase_shape, generator=gen, device=self.device) * (2 * np.pi) - np.pi
        return phase, torch.randn(noise_shape, generator=gen, device=self.device)

    def chunk(self, index, count):
        raise NotImplementedError("the benchmark's traffic is offline")

    def flow_x0_prefix(self, bucket, shape):
        raise NotImplementedError("the benchmark's traffic is offline")


class RowNoise:
    """Row ``row`` of a recorded call's draws, drawn again on ``device``, for
    the reference's single-row synthesis."""

    def __init__(self, seed: int, call: int, shapes: Dict[str, tuple], row: int, device):
        self.base = BenchNoise(seed, call, device)
        self.shapes, self.row = shapes, row

    def _pick(self, t: torch.Tensor, shape) -> torch.Tensor:
        out = t[self.row:self.row + 1]
        if tuple(out.shape) != tuple(shape):
            raise ValueError(f"the reference asks {tuple(shape)}, the call drew {tuple(out.shape)}")
        return out

    def flow_x0(self, shape):
        return self._pick(self.base.flow_x0(self.shapes["flow_x0"]), shape)

    def hift_source(self, phase_shape, noise_shape):
        phase, noise = self.base.hift_source(*self.shapes["hift_source"])
        return self._pick(phase, phase_shape), self._pick(noise, noise_shape)
