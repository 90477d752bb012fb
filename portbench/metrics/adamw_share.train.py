"""AdamW's share of the traced train steps' device time: the device's busy
time inside the program's marked ``train.adamw`` spans (the global norm
included) over its busy time inside the ``train.step`` spans."""

from portbench import program_trace


def read(rec):
    return program_trace.device_share(rec.trace, "train.step", "train.adamw")
