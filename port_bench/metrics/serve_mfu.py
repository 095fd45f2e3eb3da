"""serve_mfu: the whole serve call's FLOPs (the frozen flops.py count) a second over the measured window (no profiler), as a share of the card's dense peak for the mix's dtype."""

from port_bench import readers


def read(run):
    return readers.mfu_pct(run, "serve")
