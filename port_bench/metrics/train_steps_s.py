"""train_steps_s: whole train steps from the window's first enqueue to the sync after its last step."""

from port_bench import readers


def read(run):
    return readers.units_per_s(run, "train")
