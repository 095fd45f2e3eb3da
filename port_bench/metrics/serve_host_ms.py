"""serve_host_ms: host ms to enqueue one serve call (no sync), over the measured window (no profiler)."""

from port_bench import readers


def read(run):
    return readers.host_ms(run, "serve")
