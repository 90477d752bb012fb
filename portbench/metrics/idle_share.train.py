"""Share of an untraced step in which the device runs nothing: one less the
device's busy seconds a traced step, over the measured window's seconds a
step.  The traced segment's own idle share would count the profiler's cost
on each of a step's ~4,400 launches, which puts the host behind; the
kernels' times it records are the untraced step's."""


def read(rec):
    tr, c = rec.trace, rec.counters
    if tr is None or not tr.device or not c.get("steps"):
        return None
    busy_per_step = tr.busy_s() / len(tr.work["segment_ids"])
    return 100.0 * (1.0 - busy_per_step / (c["window_s"] / c["steps"]))
