"""The share of the profiled slice in which no kernel, copy or set ran on
the card (torch.profiler's CUDA activity)."""

from portbench import readers


def read(ctx):
    return readers.idle_pct(ctx)
