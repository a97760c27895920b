"""stream_msamples_per_s: samples of every CPI delivered to ``on_result``
within the window, over the window's seconds, in millions (host clock). Read
in the untraced window of a ``--trace 1`` run. The stream layer's host path
sets this pace in the cells, so it follows the host's speed from run to
run."""


def read(run):
    return run.delivered_in_window * run.samples_per_cpi / run.window_s / 1e6
