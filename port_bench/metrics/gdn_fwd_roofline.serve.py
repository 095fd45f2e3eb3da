"""gdn_fwd_roofline.serve: the serve call's GDN forward bytes bound over the device time of its GDN forward kernels."""

from port_bench import readers


def read(run):
    return readers.gdn_roofline_pct(run, "serve", backward=False)
