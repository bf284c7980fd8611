"""Requests a batched tts dispatch carried (serving runtime: items ÷ batches)."""

from bench_port.lib.readers import batch_rows


def read(ctx):
    return batch_rows(ctx, "tts")
