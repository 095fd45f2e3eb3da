"""gdn_bwd_roofline.train: the train step's GDN backward bytes bound over the device time of its GDN backward kernels."""

from port_bench import readers


def read(run):
    return readers.gdn_roofline_pct(run, "train", backward=True)
