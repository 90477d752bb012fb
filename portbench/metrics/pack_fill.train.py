"""Real tokens over the rows' capacity, over the window's batches: how
full the First-Fit packer keeps the rows."""


def read(rec):
    c = rec.counters
    return 100.0 * c["real_tokens"] / c["capacity_tokens"] if c.get("capacity_tokens") else None
