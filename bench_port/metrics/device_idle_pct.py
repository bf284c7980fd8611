"""Share of the traced slice with nothing running on the card (the union of
its kernels and copies)."""

from bench_port.lib import trace


def read(ctx):
    sl = ctx.slice
    if sl is None or sl.seconds <= 0:
        return None
    return 100.0 * (1.0 - trace.busy_s(sl) / sl.seconds)
