"""kernel_count_share: the share of the window's delivered CPIs whose
detection count their kernel made (Kernels D and G count the peaks in their
own epilogue), the delta over the window of ``StreamStats.n_kernel_counts``
over the CPIs delivered in it; the rest were counted by ``peaks.sum``. None
where the program keeps no such counter."""


def read(run):
    d = run.stats_delta
    if not d.get("frames_out") or d.get("n_kernel_counts") is None:
        return None
    return d["n_kernel_counts"] / d["frames_out"]
