"""The cross-entropy's share of the traced train steps' device time: the
device's busy time inside the program's ``train.cross_entropy`` and
``train.cross_entropy.bwd`` spans (its forward, and its backward with the
recomputed chunks) over its busy time inside the ``train.step`` spans.
All three are marked on the card, so the operations inside each are the
work it launched."""

from portbench import program_trace


def read(rec):
    return program_trace.device_share(rec.trace, "train.step", "train.cross_entropy",
                                      "train.cross_entropy.bwd")
