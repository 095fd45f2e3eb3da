"""Device kernels by layer: the benchmark's frozen copy of the buckets of
``tools/profile_torch_serve.py``'s ``layer_of``, matched on the kernel's
name as the profiler gives it."""


def layer_of(kernel_name: str) -> str:
    n = kernel_name.lower()
    if "gdn_bwd_" in n:
        # one layer per launch of csrc/gdn_bwd_kernel.cu: gdn_bwd_<launch>_kernel
        return "gdn backward kernel: " + n.split("gdn_bwd_", 1)[1].split("_kernel", 1)[0]
    if "gdn_rows_kernel" in n:
        return "gdn kernel"
    if "gmm_logp_backward_kernel" in n:
        return "gmm backward kernel"
    if "gmm_logp_kernel" in n:
        return "gmm kernel"
    if "multi_tensor_apply" in n or "adam" in n:
        return "optimizer (Adam)"
    if any(s in n for s in ("conv", "xmma", "cudnn", "implicit", "dgrad", "wgrad", "fprop")):
        return "cudnn conv"
    if "gemm" in n or "cutlass" in n:
        return "gemm"
    return "other (elementwise, softmax, reductions, copies)"


def is_gdn_forward(name: str) -> bool:
    return layer_of(name) == "gdn kernel"


def is_gdn_backward(name: str) -> bool:
    return layer_of(name).startswith("gdn backward kernel")


def is_convolution(name: str) -> bool:
    """cuDNN's convolutions, with the FFT pieces of its FFT algorithms
    (``fft2d_*``, the complex pointwise products), which ``layer_of``
    leaves among "other"."""
    n = name.lower()
    return (layer_of(name) == "cudnn conv" or "fft2d" in n or "fft_" in n
            or "pointwise_mult_and_sum_complex" in n)
