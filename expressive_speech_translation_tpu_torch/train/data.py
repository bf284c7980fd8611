"""Training data pipeline: shuffle / sort / dynamic frame batching / padding.

Reproduces the semantics of the reference's 10-stage CosyVoice data pipeline
(greek_sft.yaml:40-91): shuffle buffer 1000 → sort buffer 500 (by length, so
batches are length-homogeneous) → dynamic batching capped at
``max_frames_in_batch=2000`` → padding. Padded lengths snap to a small set of
bucket sizes, as in the JAX package (where they bound its compiles), so both
packages form the same batches from the same samples. A copy of the JAX
package's ``train/data.py``.

Everything is a plain-iterator pipeline over dict samples; no framework
dependency, usable from SLURM batch jobs and tests alike.
"""

from __future__ import annotations

import random
from typing import Any, Callable, Dict, Iterable, Iterator, List, Optional, Sequence

import numpy as np

from ..core.buckets import bucket_size

Sample = Dict[str, Any]


def shuffle_buffer(it: Iterable[Sample], size: int = 1000, *, seed: int = 1986) -> Iterator[Sample]:
    """Streaming shuffle with a bounded buffer (greek_sft.yaml shuffle:1000)."""
    rng = random.Random(seed)
    buf: List[Sample] = []
    for sample in it:
        buf.append(sample)
        if len(buf) >= size:
            idx = rng.randrange(len(buf))
            buf[idx], buf[-1] = buf[-1], buf[idx]
            yield buf.pop()
    rng.shuffle(buf)
    yield from buf


def sort_buffer(
    it: Iterable[Sample], size: int = 500, *, key: Callable[[Sample], int] = None
) -> Iterator[Sample]:
    """Sort within a sliding buffer by length (greek_sft.yaml sort:500) so
    dynamic batches pack near-equal lengths."""
    key = key or (lambda s: s["num_frames"])
    buf: List[Sample] = []
    for sample in it:
        buf.append(sample)
        if len(buf) >= size:
            buf.sort(key=key)
            yield from buf
            buf = []
    buf.sort(key=key)
    yield from buf


def bucket_length(n: int, buckets: Sequence[int]) -> int:
    """Smallest bucket ≥ n (static-shape compilation); doubles above the
    top bucket — returning less than ``n`` made pad_batch silently TRUNCATE
    long admitted samples while marking every position valid (corrupted EOS
    supervision). Shared policy: core/buckets.py."""
    return bucket_size(n, buckets)


class DynamicFrameBatcher:
    """Greedy frame-count batching (greek_sft.yaml:73-75, max 2000 frames).

    Yields lists of samples whose summed ``num_frames`` (after padding to the
    batch max) stays under ``max_frames_in_batch``.
    """

    def __init__(
        self,
        max_frames_in_batch: int = 2000,
        *,
        length_key: str = "num_frames",
        pad_to_bucket: Optional[Sequence[int]] = None,
    ):
        self.max_frames = max_frames_in_batch
        self.length_key = length_key
        self.buckets = tuple(pad_to_bucket) if pad_to_bucket else None

    def _padded_len(self, n: int) -> int:
        if self.buckets:
            return bucket_length(n, self.buckets)
        return n

    def __call__(self, it: Iterable[Sample]) -> Iterator[List[Sample]]:
        batch: List[Sample] = []
        max_len = 0
        for sample in it:
            n = self._padded_len(int(sample[self.length_key]))
            new_max = max(max_len, n)
            if batch and new_max * (len(batch) + 1) > self.max_frames:
                yield batch
                batch, max_len = [], 0
                new_max = n
            batch.append(sample)
            max_len = new_max
        if batch:
            yield batch


def pad_batch(
    samples: List[Sample],
    keys: Sequence[str],
    *,
    pad_value: int = 0,
    buckets: Optional[Sequence[int]] = None,
) -> Dict[str, np.ndarray]:
    """Stack variable-length 1-D fields into [B, L] arrays + bool masks.

    Output lengths snap to ``buckets`` when given (the JAX package's compile-count control).
    """
    out: Dict[str, np.ndarray] = {}
    for key in keys:
        arrays = [np.asarray(s[key]) for s in samples]
        max_len = max(a.shape[0] for a in arrays)
        if buckets:
            max_len = bucket_length(max_len, buckets)
        stacked = np.full((len(arrays), max_len), pad_value, dtype=arrays[0].dtype)
        mask = np.zeros((len(arrays), max_len), dtype=bool)
        for i, a in enumerate(arrays):
            if a.shape[0] > max_len:
                # LOUD: silently clipping here while marking the prefix valid
                # trains EOS onto mid-utterance positions (the corrupted-
                # supervision bug bucket_length's doubling policy fixed —
                # this guard keeps any future non-covering bucket list from
                # reintroducing it invisibly)
                raise ValueError(
                    f"pad_batch: sample length {a.shape[0]} exceeds padded "
                    f"width {max_len} for key {key!r} — bucket list does not "
                    f"cover the data")
            n = a.shape[0]
            stacked[i, :n] = a
            mask[i, :n] = True
        out[key] = stacked
        out[key + "_mask"] = mask
    return out


def filter_samples(
    it: Iterable[Sample],
    *,
    min_frames: int = 2,
    max_frames: int = 2000,
    token_max_length: int = 200,
    token_key: str = "text_tokens",
) -> Iterator[Sample]:
    """Length filters (greek_sft.yaml:48-53 filter stage)."""
    for s in it:
        n = int(s.get("num_frames", 0))
        if n < min_frames or n > max_frames:
            continue
        if token_key in s and len(s[token_key]) > token_max_length:
            continue
        yield s
