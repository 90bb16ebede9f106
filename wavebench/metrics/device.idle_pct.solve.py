"""device.idle_pct.solve: the share of the traced window in which nothing
ran on the card (the union of the profiler's device intervals)."""


def read(rec):
    if not rec.get("trace_window_s") or rec.get("busy_s") is None:
        return None
    return 100.0 * (1.0 - rec["busy_s"] / rec["trace_window_s"])
