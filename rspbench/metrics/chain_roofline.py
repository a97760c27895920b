"""chain_roofline: the least time of a CPI's work (``roofline.py``)
over the device's busy time a CPI in the traced slice (the union of every
kernel, copy and set interval, from the profiler's trace, over the CPIs
delivered in the slice), in percent."""


def read(run):
    t = run.trace
    if t is None or t.busy_s <= 0 or run.cpis_in_trace <= 0:
        return None
    return 100.0 * run.least_s_per_cpi * run.cpis_in_trace / t.busy_s
