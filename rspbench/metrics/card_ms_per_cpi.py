"""card_ms_per_cpi: the card's busy time over the whole window (the union
of every kernel, copy and set interval, from the profiler's trace of the
card's activity, ``trace.DeviceWindow``) over the CPIs that the pipeline
took in the window, every one of which completed inside the trace, in
milliseconds: the card time that one CPI costs on the streamed path. Read in
a ``--trace 0`` run."""


def read(run):
    if run.card_busy_s is None or run.cpis_on_card <= 0:
        return None
    return run.card_busy_s / run.cpis_on_card * 1e3
