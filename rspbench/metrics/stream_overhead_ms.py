"""stream_overhead_ms: the stream layer's host time a CPI, the deltas over
the window of ``StreamStats.t_place`` (the CPI to its device operand) and
``t_result`` (the count fetch, metrics and ``on_result``) over the CPIs
delivered in it. Spans the program keeps (``io/stream.py``). ``t_result``
also covers the benchmark's own ``on_result`` (``loadgen.Recorder``): a time
stamp, two dict entries and, for the few sampled CPIs, a held reference to
the outputs; nothing is copied there."""


def read(run):
    d = run.stats_delta
    if not d.get("frames_out"):
        return None
    return (d["t_place"] + d["t_result"]) / d["frames_out"] * 1e3
