"""gdn_bwd_roofline.distill: the distill step's GDN backward bytes bound over the device time of its GDN backward kernels."""

from port_bench import readers


def read(run):
    return readers.gdn_roofline_pct(run, "distill", backward=True)
