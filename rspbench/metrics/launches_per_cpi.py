"""launches_per_cpi: the C entry launches of a CPI's dispatch, the delta over
the window of ``StreamStats.n_launches`` over the CPIs delivered in it.
Kernels D and G count a CPI's peaks in their own tail, inside the one launch
(``CfarOutput.detections``); ``io/stream.cpi_count`` takes that count, and
torch's ``peaks.sum``, which is not counted here, remains only for outputs
that carry no count. None where the program keeps no such counter."""


def read(run):
    d = run.stats_delta
    if not d.get("frames_out") or d.get("n_launches") is None:
        return None
    return d["n_launches"] / d["frames_out"]
