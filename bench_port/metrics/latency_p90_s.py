"""The 90th percentile of every request's time in the window, from when it
was due to its result (in flight at the close: its age then). In a
saturated closed loop it follows the clients over the rate, and swings with
how the batchers group the requests."""

from bench_port.lib import stats


def read(ctx):
    return stats.latency_p90_s(ctx.window) if ctx.window.requests else None
