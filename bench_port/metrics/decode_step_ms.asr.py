"""Wall milliseconds a step of the asr stage's decode loops took (engines and
models): the loops' time inside the measured window over their steps at the
same share."""

from bench_port.metrics._spans import decode_step_ms


def read(ctx):
    return decode_step_ms(ctx, "asr")
