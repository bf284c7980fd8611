"""The whole step's share of the card's bf16 peak: the model FLOPs of the
work done in the window (each row's count from the reference's computation
of one row, FlopCounterMode; a dispatch that spans the close at the share of
its duration inside) over the window's seconds × 989 TFLOP/s."""

from bench_port.lib import work
from bench_port.lib.readers import window_flops


def read(ctx):
    flops = window_flops(ctx)
    if not flops:
        return None
    return work.mfu_pct(flops, ctx.window.end - ctx.window.start)
