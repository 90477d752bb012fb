"""The operations the window's real prompt tokens need
(``counts.prefill_flops``) over the window's seconds and the card's bf16
peak: the whole prefill's share of the peak, padding counted as no work."""

from portbench.counts import PEAKS


def read(rec):
    c = rec.counters
    if not c.get("model_flops"):
        return None
    return 100.0 * c["model_flops"] / (c["window_s"] * PEAKS["bf16_flops"])
