"""setup_s: seconds from the run's start to the end of the warm-up: imports,
the CUDA context, the kernel library (built on its first use in a checkout),
the CPI ring, the pipeline and the warm-up CPIs. Host clock."""


def read(run):
    return run.setup_s
