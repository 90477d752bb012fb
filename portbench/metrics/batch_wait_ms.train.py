"""Host milliseconds the step loop waited on the pipeline's next batch,
summed over the window's steps."""


def read(rec):
    c = rec.counters
    return 1e3 * c["batch_wait_s"] if "batch_wait_s" in c else None
