"""The one traffic generator: inputs and arrival times from ``--seed`` and a
traffic file's parameters. The same seed gives the same inputs; every seed
gives the same amount of work (utterances of one length, the same set of
inter-arrival gaps in another order)."""

from __future__ import annotations

import math
from typing import Any, Dict, List

import numpy as np

SR = 16_000


def rng(seed: int, *stream: int) -> np.random.Generator:
    """A numpy generator for one stream of ``seed`` (any whole number)."""
    return np.random.default_rng(np.random.SeedSequence([seed % 2**64, *stream]))


def utterance(g: np.random.Generator, seconds: float) -> np.ndarray:
    """Speech-like float32 audio at 16 kHz: a voiced source with a gliding
    pitch of 90-260 Hz and ten harmonics under two formant peaks, syllables
    at 3-6 Hz, and a little noise."""
    n = int(SR * seconds)
    t = np.arange(n) / SR
    f0 = g.uniform(90, 260) * (1 + 0.08 * np.sin(2 * np.pi * g.uniform(0.2, 0.7) * t))
    phase = 2 * np.pi * np.cumsum(f0) / SR
    formants = g.uniform(300, 900), g.uniform(1000, 2600)
    x = np.zeros(n)
    for h in range(1, 11):
        gain = sum(np.exp(-((h * f0 - f) / 250.0) ** 2) for f in formants) + 0.05
        x += gain * np.sin(h * phase + g.uniform(0, 2 * np.pi)) / h
    x *= 0.5 + 0.5 * np.sin(2 * np.pi * g.uniform(3, 6) * t + g.uniform(0, 2 * np.pi)) ** 2
    x += 0.01 * g.standard_normal(n)
    return (0.3 * x / np.max(np.abs(x))).astype(np.float32)


def utterances(seed: int, count: int, seconds: float) -> List[np.ndarray]:
    """``count`` distinct utterances of ``seconds`` each."""
    g = rng(seed, 1)
    return [utterance(g, seconds) for _ in range(count)]


def open_arrivals(seed: int, rate: float, seconds: float) -> List[float]:
    """Poisson arrivals at ``rate`` a second over ``seconds``, as offsets
    from the window's start: a fixed set of exponential gaps (one at each
    quantile (j + 1/2) / n of the distribution) in an order drawn from the
    seed."""
    n = max(int(math.ceil(rate * seconds * 1.5)), 1)
    gaps = -np.log1p(-(np.arange(n) + 0.5) / n) / rate
    times = np.cumsum(rng(seed, 2).permutation(gaps))
    return [float(t) for t in times if t < seconds]


def requests(traffic: Dict[str, Any], seed: int) -> List[np.ndarray]:
    """The pool of inputs a run sends: two distinct utterances a client for a
    closed loop, one an arrival slot (recycled) for an open one."""
    count = 2 * int(traffic["clients"]) if traffic["loop"] == "closed" else int(traffic["inputs"])
    return utterances(seed, count, float(traffic["utterance_seconds"]))
