"""Kernel launches a request costs (engines and models): the runtime's
launch calls in the traced slice over the requests' worth of work done in
it (every stage dispatch's rows at the share of its duration inside the
slice, over the three stages a request passes)."""

from bench_port.lib import trace
from bench_port.lib.readers import requests_worked


def read(ctx):
    sl = ctx.slice
    if sl is None or not trace.launches(sl):
        return None
    worked = requests_worked(ctx, sl.t0, sl.t1)
    return trace.launches(sl) / worked if worked > 0 else None
