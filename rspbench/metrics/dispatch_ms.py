"""dispatch_ms: the host time to issue a CPI's chain launches, the delta over
the window of ``StreamStats.t_dispatch`` over the CPIs delivered in it
(``Chain.__call__`` -> ``presets`` -> the kernel wrappers, and the
detection count's reduction). Spans the program keeps (``io/stream.py``)."""


def read(run):
    d = run.stats_delta
    if not d.get("frames_out"):
        return None
    return d["t_dispatch"] / d["frames_out"] * 1e3
