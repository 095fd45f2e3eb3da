"""serve_img_s: images served over the whole window (whole requests)."""

from port_bench import readers


def read(run):
    rate = readers.units_per_s(run, "serve")
    return None if rate is None else run.cell.mix["batch"] * rate
