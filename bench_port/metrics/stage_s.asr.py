"""Mean seconds a completed request spent in the asr stage (orchestrator)."""

from bench_port.lib.readers import stage_seconds


def read(ctx):
    return stage_seconds(ctx, "asr")
