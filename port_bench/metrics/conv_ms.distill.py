"""conv_ms.distill: device ms of cuDNN's convolutions (with its FFT pieces) a distill call."""

from port_bench import readers


def read(run):
    return readers.conv_ms(run, "distill")
