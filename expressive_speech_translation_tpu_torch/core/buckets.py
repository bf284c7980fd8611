"""Static-shape bucketing for serving batches and padded widths (copy of the
JAX package's ``core/buckets.py``).

One policy, "smallest bucket ≥ n, doubling above the top": a bucket smaller
than ``n`` would index a batch array past its allocation or clip a row.
"""

from __future__ import annotations

from typing import Iterator, Sequence, Tuple

BATCH_BUCKETS = (1, 2, 4, 8, 16)   # serving batch-size ladder


def bucket_batch(n: int, buckets: Sequence[int] = BATCH_BUCKETS) -> int:
    """Smallest batch bucket ≥ n."""
    return bucket_size(n, buckets)


def bucket_size(n: int, buckets: Sequence[int]) -> int:
    """Smallest bucket ≥ n; keeps doubling above the top bucket."""
    for b in buckets:
        if n <= b:
            return b
    b = buckets[-1]
    while b < n:
        b *= 2
    return b


def row_slices(n: int, cap: int) -> Iterator[Tuple[int, int]]:
    """(start, stop) windows of at most ``cap`` rows, so an oversized burst
    runs as several bounded dispatches instead of one arbitrarily large
    batch."""
    for s in range(0, n, cap):
        yield s, min(s + cap, n)
