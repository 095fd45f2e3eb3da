"""Analytic FLOP counts of the families' networks, the port's own copy of
the JAX package's utils/flops.py (``joint_ar_eval_flops``,
``hyperprior_eval_flops``, ``channel_cb_eval_flops`` and
``factorized_prior_eval_flops`` for the 5x5 transforms,
``train_step_flops``, ``mfu``), with the card's peaks in place of the
TPU's. The checkerboard model's count is ``joint_ar_eval_flops``: its
context conv has the masked conv's shape.

Multiply-accumulates count 2 for every conv, deconv and GDN product on the
eval forward, per image; deconvs count input_pixels * k^2 * Cin * Cout * 2,
masked convs their full taps (the dense conv computes the zeros).
Elementwise work is one small 'elementwise' estimate.
"""

from typing import Dict

# Published dense peaks of one H100 SXM (NVIDIA data sheet), TFLOP/s: bf16
# on the tensor cores, float32 on the CUDA cores (TF32 off, as the port's
# measurements run).
H100_PEAK_TFLOPS = {"bf16": 989.0, "tf32": 495.0, "f32": 67.0}


def _conv(out_h: int, out_w: int, k: int, cin: int, cout: int) -> int:
    return 2 * out_h * out_w * k * k * cin * cout


def _deconv(in_h: int, in_w: int, k: int, cin: int, cout: int) -> int:
    return 2 * in_h * in_w * k * k * cin * cout


def _gdn(h: int, w: int, c: int) -> int:
    return 2 * h * w * c * c  # the (BHW, C) x (C, C) norm product


def joint_ar_eval_flops(M: int, K: int, H: int, W: int) -> Dict[str, int]:
    """Per-image eval-forward FLOPs of JointAutoregressiveHierarchical with
    the 5x5 conv/GDN transforms, by component. H, W: multiples of 64."""
    h16, w16 = H // 16, W // 16
    h64, w64 = H // 64, W // 64
    out = {}
    out["encoder"] = (
        _conv(H // 2, W // 2, 5, 3, M) + _gdn(H // 2, W // 2, M)
        + _conv(H // 4, W // 4, 5, M, M) + _gdn(H // 4, W // 4, M)
        + _conv(H // 8, W // 8, 5, M, M) + _gdn(H // 8, W // 8, M)
        + _conv(h16, w16, 5, M, M))
    out["decoder"] = (
        _deconv(h16, w16, 5, M, M) + _gdn(H // 8, W // 8, M)
        + _deconv(H // 8, W // 8, 5, M, M) + _gdn(H // 4, W // 4, M)
        + _deconv(H // 4, W // 4, 5, M, M) + _gdn(H // 2, W // 2, M)
        + _deconv(H // 2, W // 2, 5, M, 3))
    out["hyper_encoder"] = (
        _conv(h16, w16, 3, M, M) + _conv(H // 32, W // 32, 5, M, M)
        + _conv(h64, w64, 5, M, M))
    out["hyper_decoder"] = (
        _deconv(h64, w64, 5, M, M)
        + _deconv(H // 32, W // 32, 5, M, int(1.5 * M))
        + _conv(h16, w16, 3, int(1.5 * M), 2 * M))
    out["context"] = _conv(h16, w16, 5, M, 2 * M)
    ep_out = 2 * M if K == 1 else 3 * K * M
    out["entropy_parameters"] = (
        _conv(h16, w16, 1, 4 * M, 640) + _conv(h16, w16, 1, 640, 640)
        + _conv(h16, w16, 1, 640, ep_out))
    # likelihoods, quantization and the rest: ~100 FLOPs per latent and component
    out["elementwise"] = 100 * (h16 * w16 * M * K + h64 * w64 * M)
    out["total"] = sum(out.values())
    return out


def hyperprior_eval_flops(M: int, K: int, H: int, W: int) -> Dict[str, int]:
    """Per-image eval-forward FLOPs of MeanScaleHyperprior: the joint-AR
    count without the context conv, the entropy-parameter net contracting
    over psi's 2M channels instead of 4M."""
    out = dict(joint_ar_eval_flops(M, K, H, W))
    h16, w16 = H // 16, W // 16
    del out["context"]
    ep_out = 2 * M if K == 1 else 3 * K * M
    out["entropy_parameters"] = (
        _conv(h16, w16, 1, 2 * M, 640) + _conv(h16, w16, 1, 640, 640)
        + _conv(h16, w16, 1, 640, ep_out))
    out["total"] = sum(v for k, v in out.items() if k != "total")
    return out


def channel_cb_eval_flops(M: int, K: int, H: int, W: int, groups=None) -> Dict[str, int]:
    """Per-image eval-forward FLOPs of ChannelCheckerboardHierarchical: the
    joint-AR transforms, with the context conv and entropy net replaced by
    each group's spatial-context conv, channel-context stack and entropy
    net. groups: the channel split (``models.channel_cb.default_groups``
    when None)."""
    from neural_image_compression_tpu_torch.models.channel_cb import default_groups

    g = tuple(groups) if groups is not None else default_groups(M)
    out = dict(joint_ar_eval_flops(M, K, H, W))
    h16, w16 = H // 16, W // 16
    del out["context"]
    spatial = channel = ep = 0
    off = 0
    for i, gi in enumerate(g):
        spatial += _conv(h16, w16, 5, gi, 2 * gi)
        if i > 0:
            hidden = max(2 * gi, 64)
            channel += _conv(h16, w16, 5, off, hidden) + _conv(h16, w16, 5, hidden, 2 * gi)
        ep_out = 2 * gi if K == 1 else 3 * K * gi
        ep += (_conv(h16, w16, 1, 4 * gi + 2 * M, 640) + _conv(h16, w16, 1, 640, 640)
               + _conv(h16, w16, 1, 640, ep_out))
        off += gi
    out["spatial_ctx"] = spatial
    out["channel_ctx"] = channel
    out["entropy_parameters"] = ep
    out["total"] = sum(v for k, v in out.items() if k != "total")
    return out


def factorized_prior_eval_flops(M: int, H: int, W: int) -> Dict[str, int]:
    """Per-image eval-forward FLOPs of FactorizedPrior: the 5x5 analysis and
    synthesis and the bottleneck's elementwise work on y. H, W: multiples
    of 16."""
    base = joint_ar_eval_flops(M, 1, H, W)
    out = {"encoder": base["encoder"], "decoder": base["decoder"],
           "elementwise": 100 * (H // 16) * (W // 16) * M}
    out["total"] = sum(out.values())
    return out


def train_step_flops(eval_total: int) -> int:
    """Forward + backward, approximated: the backward is ~2x the forward for
    conv nets."""
    return 3 * eval_total


def mfu(images_per_sec: float, flops_per_image: int, peak_tflops: float) -> float:
    """Model FLOP utilization: achieved FLOP/s over ``peak_tflops``."""
    return images_per_sec * flops_per_image / (peak_tflops * 1e12)
