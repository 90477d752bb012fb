"""Share of the traced arrivals' window in which the device ran nothing."""


def read(rec):
    tr = rec.trace
    if tr is None or not tr.device:
        return None
    return 100.0 * (1.0 - tr.busy_s() / tr.window_s)
