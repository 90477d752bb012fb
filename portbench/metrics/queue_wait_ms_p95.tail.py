"""95th percentile over the window's requests of the milliseconds each
waited from its arrival until the server took its batch: the serving
loop's share of the time to first token."""


def read(rec):
    c = rec.counters
    return 1e3 * c["wait_p95_s"] if "wait_p95_s" in c else None
