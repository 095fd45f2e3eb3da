"""Device selection for the port's entry points, and the fixed numerics of
the programs whose results must repeat bit for bit."""

import contextlib
from typing import Optional, Union

import torch

DeviceLike = Optional[Union[str, torch.device]]


def resolve_device(device: DeviceLike = None) -> torch.device:
    """The device an entry point runs on: ``cuda`` unless the caller names one.

    With no CUDA device and no explicit request this raises rather than
    running on the CPU unasked.
    """
    if device is None:
        if not torch.cuda.is_available():
            raise RuntimeError(
                "no CUDA device is available; pass device='cpu' to run on the CPU")
        return torch.device("cuda")
    return torch.device(device)


@contextlib.contextmanager
def fixed_numerics():
    """Run the block with cuDNN's deterministic algorithms, no autotuning
    and no TF32 in convolutions or matrix products, whatever the caller set;
    the caller's settings come back afterwards. The codec's coding
    parameters (the hyper-synthesis psi, the z tables) are computed so, at
    encode and at decode time: cuDNN's transposed-convolution algorithms
    may accumulate with atomics, and TF32 is a global flag of the caller."""
    matmul = torch.backends.cuda.matmul
    saved = matmul.allow_tf32
    matmul.allow_tf32 = False
    try:
        with torch.backends.cudnn.flags(enabled=True, benchmark=False, deterministic=True,
                                        allow_tf32=False):
            yield
    finally:
        matmul.allow_tf32 = saved
