"""serve_p95_ms: the 95th percentile of every request's latency in the window, from the call to its synchronised outputs."""

from port_bench import readers


def read(run):
    return readers.p95_ms(run, "serve")
