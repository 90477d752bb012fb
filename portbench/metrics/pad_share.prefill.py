"""The share of the positions prefill computed that were padding, over the
traced segment: one less the program's ``prefill.tokens`` counter (the
rows' valid tokens) over its ``prefill.positions`` (batch x longest row),
both counted where ``write_plan`` reads the rows' lengths."""

from portbench import program_trace


def read(rec):
    if rec.trace is None:
        return None
    positions = program_trace.counter(rec.trace, "prefill.positions")
    tokens = program_trace.counter(rec.trace, "prefill.tokens")
    if not positions or tokens is None:
        return None
    return 100.0 * (1.0 - tokens / positions)
