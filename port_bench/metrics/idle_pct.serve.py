"""idle_pct.serve: the share of the traced window in which no operation ran on the device."""

from port_bench import readers


def read(run):
    return readers.idle_pct(run, "serve")
