"""conv_ms.serve: device ms of cuDNN's convolutions (with its FFT pieces) a serve call."""

from port_bench import readers


def read(run):
    return readers.conv_ms(run, "serve")
