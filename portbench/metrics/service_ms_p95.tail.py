"""95th percentile over the window's requests of the milliseconds from the
server taking a request's batch to its first token on the host: submit, a
fresh cache, prefill and the greedy token."""


def read(rec):
    c = rec.counters
    return 1e3 * c["service_p95_s"] if "service_p95_s" in c else None
