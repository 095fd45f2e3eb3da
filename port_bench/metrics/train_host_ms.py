"""train_host_ms: host ms to enqueue one train call (no sync), over the measured window (no profiler)."""

from port_bench import readers


def read(run):
    return readers.host_ms(run, "train")
