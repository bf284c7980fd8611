"""Share of the traced slice with nothing on the card while some decode
loop of a dispatch is open (the host inside the loop: launches, syncs,
Python between steps)."""

from bench_port.metrics._spans import idle_while_pct, port_spans, staged


def read(ctx):
    held = port_spans(ctx)
    if held is None:
        return None
    return idle_while_pct(ctx, [(s.start_ns, s.end_ns) for s, _ in staged(held, "decode")])
