"""distill_steps_s: whole distill steps from the window's first enqueue to the sync after its last step."""

from port_bench import readers


def read(run):
    return readers.units_per_s(run, "distill")
