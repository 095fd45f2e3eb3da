"""conv_ms.train: device ms of cuDNN's convolutions (with its FFT pieces) a train call."""

from port_bench import readers


def read(run):
    return readers.conv_ms(run, "train")
