"""The operations the window's real tokens need (``counts.train_flops``)
over the window's seconds and the card's bf16 peak: the whole train
step's share of the peak."""

from portbench.counts import PEAKS


def read(rec):
    c = rec.counters
    if not c.get("model_flops"):
        return None
    return 100.0 * c["model_flops"] / (c["window_s"] * PEAKS["bf16_flops"])
