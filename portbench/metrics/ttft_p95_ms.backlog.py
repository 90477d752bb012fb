"""95th percentile of the time to first token of the window's requests
where arrivals outpace the server: it grows with the queue all through the
run, so it is recorded here and judges nothing."""


def read(rec):
    c = rec.counters
    return 1e3 * c["ttft_p95_s"] if "ttft_p95_s" in c else None
