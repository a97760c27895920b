from .profiling import stage_timings, trace
