"""Mean seconds a asr item waited in its micro-batcher (serving runtime):
over the items of the dispatches that start inside the measured window, the
dispatch span's start less the item's submit time."""

from bench_port.metrics._spans import queue_wait_s


def read(ctx):
    return queue_wait_s(ctx, "asr")
