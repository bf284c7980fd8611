"""The resblock kernel's share of its roofline in the traced slice: the
bound of the shapes its function was handed over the kernels' device
time."""

from bench_port.lib import trace, work
from bench_port.lib.readers import kernel_roofline_pct


def read(ctx):
    if ctx.slice is None:
        return None
    voc = ctx.config["tts"]["config"].get("vocoder", {})
    kernels, dilations = voc.get("resblock_kernels"), voc.get("resblock_dilations")
    if not kernels:
        return None

    def shape_work(call):
        b, c, t, es = call
        return work.resblock_work(b, c, t, es, kernels, dilations)

    return kernel_roofline_pct(ctx, trace.resblock_pairs(ctx.slice), shape_work)
