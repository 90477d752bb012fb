"""The share of the program's ``prefill.layers`` spans in which the device
ran nothing: the launch-bound part of a small batch's prefill, where the
device runs each kernel faster than the host launches the next, without
the plan's host syncs before the layers or the wait for arrivals between
batches.  The spans are not marked, so they are taken on the host's
timeline: an operation that runs on after its span ends lies outside every
span and counts for nothing."""

from portbench import program_trace


def read(rec):
    if rec.trace is None or not rec.trace.device:
        return None
    layers = program_trace.spans_named(rec.trace, "prefill.layers")
    total = program_trace.length(layers)
    if not total:
        return None
    return 100.0 * (1.0 - program_trace.busy_inside(rec.trace, layers) / total)
