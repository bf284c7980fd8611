"""Share of the traced slice with nothing on the card and no micro-batch
dispatch open (the host outside every stage's batched call: queueing,
the orchestrator, post-processing)."""

from bench_port.metrics._spans import DISPATCH, idle_outside_pct, port_spans


def read(ctx):
    held = port_spans(ctx)
    if held is None:
        return None
    return idle_outside_pct(ctx, [(s.start_ns, s.end_ns) for s in held
                                  if s.name.startswith(DISPATCH)])
