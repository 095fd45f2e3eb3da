"""Analytic FLOP counts of the families' networks, the port's own copy of
the JAX package's utils/flops.py (``joint_ar_eval_flops``,
``hyperprior_eval_flops`` and ``channel_cb_eval_flops`` for either
transform, ``factorized_prior_eval_flops`` for the 5x5 transforms,
``scalable_eval_flops``, ``train_step_flops``, ``mfu``), with the card's
peaks in place of the TPU's. The checkerboard model's count is ``joint_ar_eval_flops``: its
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


def _res_block(h: int, w: int, cin: int, cout: int, stride: int = 1,
               gdn: bool = False) -> int:
    """A residual block on an h x w input: two 3x3 convs, the GDN when it
    has one, the 1x1 skip conv when the stride or the width changes."""
    oh, ow = h // stride, w // stride
    f = _conv(oh, ow, 3, cin, cout) + _conv(oh, ow, 3, cout, cout)
    if gdn:
        f += _gdn(oh, ow, cout)
    if stride != 1 or cin != cout:
        f += _conv(oh, ow, 1, cin, cout)
    return f


def _res_block_up(h: int, w: int, c: int, up: int = 2) -> int:
    """An upsampling block on an h x w input: the main and the skip 3x3
    transposed convs, the 3x3 conv and the IGDN."""
    oh, ow = h * up, w * up
    return 2 * _deconv(h, w, 3, c, c) + _conv(oh, ow, 3, c, c) + _gdn(oh, ow, c)


def joint_ar_eval_flops(M: int, K: int, H: int, W: int,
                        transform: str = "conv5x5") -> Dict[str, int]:
    """Per-image eval-forward FLOPs of JointAutoregressiveHierarchical with
    the ``transform`` ("conv5x5" or "res3x3") transforms, by component. H,
    W: multiples of 64."""
    h16, w16 = H // 16, W // 16
    h64, w64 = H // 64, W // 64
    out = {}
    if transform == "conv5x5":
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
    elif transform == "res3x3":
        out["encoder"] = sum(
            _res_block(H >> i, W >> i, 3 if i == 0 else M, M, stride=2, gdn=True)
            + _res_block(H >> (i + 1), W >> (i + 1), M, M)
            for i in range(3)) + _conv(h16, w16, 3, M, M)
        out["decoder"] = sum(
            _res_block(H >> (4 - i), W >> (4 - i), M, M)
            + _res_block_up(H >> (4 - i), W >> (4 - i), M)
            for i in range(3)) + _res_block(H // 2, W // 2, M, M) + _deconv(H // 2, W // 2, 3, M, 3)
        m15 = int(1.5 * M)
        out["hyper_encoder"] = (
            2 * _conv(h16, w16, 3, M, M) + 2 * _conv(H // 32, W // 32, 3, M, M)
            + _conv(h64, w64, 3, M, M))
        out["hyper_decoder"] = (
            _conv(h64, w64, 3, M, M) + _deconv(h64, w64, 3, M, M)
            + _conv(H // 32, W // 32, 3, M, m15) + _deconv(H // 32, W // 32, 3, m15, m15)
            + _conv(h16, w16, 3, m15, 2 * M))
    else:
        raise ValueError(transform)
    out["context"] = _conv(h16, w16, 5, M, 2 * M)
    ep_out = 2 * M if K == 1 else 3 * K * M
    out["entropy_parameters"] = (
        _conv(h16, w16, 1, 4 * M, 640) + _conv(h16, w16, 1, 640, 640)
        + _conv(h16, w16, 1, 640, ep_out))
    # likelihoods, quantization and the rest: ~100 FLOPs per latent and component
    out["elementwise"] = 100 * (h16 * w16 * M * K + h64 * w64 * M)
    out["total"] = sum(out.values())
    return out


def hyperprior_eval_flops(M: int, K: int, H: int, W: int,
                          transform: str = "conv5x5") -> Dict[str, int]:
    """Per-image eval-forward FLOPs of MeanScaleHyperprior: the joint-AR
    count without the context conv, the entropy-parameter net contracting
    over psi's 2M channels instead of 4M."""
    out = dict(joint_ar_eval_flops(M, K, H, W, transform))
    h16, w16 = H // 16, W // 16
    del out["context"]
    ep_out = 2 * M if K == 1 else 3 * K * M
    out["entropy_parameters"] = (
        _conv(h16, w16, 1, 2 * M, 640) + _conv(h16, w16, 1, 640, 640)
        + _conv(h16, w16, 1, 640, ep_out))
    out["total"] = sum(v for k, v in out.items() if k != "total")
    return out


def channel_cb_eval_flops(M: int, K: int, H: int, W: int, groups=None,
                          transform: str = "conv5x5") -> Dict[str, int]:
    """Per-image eval-forward FLOPs of ChannelCheckerboardHierarchical: the
    joint-AR transforms, with the context conv and entropy net replaced by
    each group's spatial-context conv, channel-context stack and entropy
    net. groups: the channel split (``models.channel_cb.default_groups``
    when None)."""
    from neural_image_compression_tpu_torch.models.channel_cb import default_groups

    g = tuple(groups) if groups is not None else default_groups(M)
    out = dict(joint_ar_eval_flops(M, K, H, W, transform))
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


def scalable_eval_flops(M: int, M1: int, K: int, H: int, W: int,
                        lst_upsampling=(2, 1, 1, 1)) -> Dict[str, int]:
    """Per-image eval-forward FLOPs of ScalableImageCoding: the 5x5
    transforms, one context conv and one entropy net a layer (M1 and
    M - M1 channels, each net over its context and psi's 2M), and the
    LatentSpaceTransform on y1: each stage's residual block bridges the
    previous stage's width c to m (its 1x1 skip when they differ), the
    upsampling block runs at m, and m grows by the stage's factor after
    it; the last conv maps m to m * lst_upsampling[3]."""
    base = joint_ar_eval_flops(M, K, H, W, "conv5x5")
    h16, w16 = H // 16, W // 16
    M2 = M - M1
    out = {k: base[k] for k in ("encoder", "decoder", "hyper_encoder", "hyper_decoder")}
    out["context"] = _conv(h16, w16, 5, M1, 2 * M1) + _conv(h16, w16, 5, M2, 2 * M2)
    out["entropy_parameters"] = 0
    for m in (M1, M2):
        ep_out = 2 * m if K == 1 else 3 * K * m
        out["entropy_parameters"] += (_conv(h16, w16, 1, 2 * m + 2 * M, 640)
                                      + _conv(h16, w16, 1, 640, 640)
                                      + _conv(h16, w16, 1, 640, ep_out))
    h, w, c, m = h16, w16, M1, M1
    lst = 0
    for u in lst_upsampling[:3]:
        lst += _res_block(h, w, c, m) + _res_block_up(h, w, m, u)
        h, w, c = h * u, w * u, m
        m *= u
    out["lst"] = lst + _res_block(h, w, c, m) + _conv(h, w, 3, m, m * lst_upsampling[3])
    out["elementwise"] = 100 * (h16 * w16 * M * K + (H // 64) * (W // 64) * M)
    out["total"] = sum(out.values())
    return out


def train_step_flops(eval_total: int) -> int:
    """Forward + backward, approximated: the backward is ~2x the forward for
    conv nets."""
    return 3 * eval_total


def mfu(images_per_sec: float, flops_per_image: int, peak_tflops: float) -> float:
    """Model FLOP utilization: achieved FLOP/s over ``peak_tflops``."""
    return images_per_sec * flops_per_image / (peak_tflops * 1e12)
