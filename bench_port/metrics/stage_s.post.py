"""Mean seconds a completed request spent in the post stage (orchestrator):
all of the host's work after the TTS, the resample to 16 kHz included."""

from bench_port.lib.readers import stage_seconds


def read(ctx):
    return stage_seconds(ctx, "post")
