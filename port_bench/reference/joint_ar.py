"""Plain reference of the joint autoregressive hierarchical model (Minnen et
al. 2018) with the 5x5 conv/GDN transforms, and its rate-distortion loss.

    y = g_a(x); z = h_a(y); z~, y~ = Q(z), Q(y)
    psi = h_s(z~); phi = ctx(y~); theta = ep([phi, psi])
    rate = -log2 P(y~ | theta) - log2 P(z~); x^ = g_s(y~)
    loss = bpp + lambda * 255^2 * MSE

Weights come from a dict keyed by ``state_dict`` names (``specs`` lists
them). Q adds U(-1/2, 1/2) noise in training (z first, then y, drawn on the
NHWC latents) and rounds at evaluation.
"""

from typing import List, Optional

import torch

from port_bench.reference import layers as L


# The latents' scale (y and z about 30): large against the rounding step, so
# that a precision lost in the transforms shows in their outputs more than
# the few latents that round the other way. Every consumer of y or z takes
# it back to about 1.
LATENT_SCALE = 30.0
# the entropy nets' scales: 2 to 4 times the latents' (see
# layers.entropy_parameter_specs)
SIGMA = (2.0 * LATENT_SCALE, 4.0 * LATENT_SCALE)


def transform_specs(m: int) -> List[L.Spec]:
    s = []
    for i in range(4):
        s += L.conv_specs(f"encoder.Conv2d_{i}", 3 if i == 0 else m, m, 5,
                          1.0 if i < 3 else 2.0 * LATENT_SCALE)
        if i < 3:
            s += L.gdn_specs(f"encoder.GDN_{i}", m)
    for i in range(3):
        s += L.conv_specs(f"decoder.Deconv2d_{i}", m, m, 5, 1.0 / LATENT_SCALE if i == 0 else 1.0,
                          transposed=True)
        s += L.gdn_specs(f"decoder.GDN_{i}", m)
    # the last layer: x^ around 1/2, mostly inside [0, 1] where serving clips
    last = L.conv_specs("decoder.Deconv2d_3", m, 3, 5, 0.15, transposed=True)
    s += [last[0], L.Spec("decoder.Deconv2d_3.bias", (3,), "range", 0.4, 0.6)]
    s += L.conv_specs("hyper_encoder.Conv2d_0", m, m, 3, 1.4 / LATENT_SCALE)
    s += L.conv_specs("hyper_encoder.Conv2d_1", m, m, 5, 1.4)
    s += L.conv_specs("hyper_encoder.Conv2d_2", m, m, 5, LATENT_SCALE)
    mid = int(1.5 * m)
    s += L.conv_specs("hyper_decoder.Deconv2d_0", m, m, 5, 1.4 / LATENT_SCALE, transposed=True)
    s += L.conv_specs("hyper_decoder.Deconv2d_1", m, mid, 5, 1.4, transposed=True)
    s += L.conv_specs("hyper_decoder.Conv2d_0", mid, 2 * m, 3, 1.0)
    return s


def specs(cfg) -> List[L.Spec]:
    m, k = cfg["latent_channels"], cfg["K"]
    return (transform_specs(m) + L.factorized_specs("factorized_entropy_model", m)
            + L.conv_specs("context_model.MaskedConv2d_0", m, 2 * m, 5, 1.0 / LATENT_SCALE)
            + L.entropy_parameter_specs("entropy_parameters", 4 * m, m, k, SIGMA))


def analysis(p, x, num):
    """x NHWC -> y NCHW."""
    h = L.nchw(x)
    for i in range(3):
        h = L.gdn(p, f"encoder.GDN_{i}", L.conv(p, f"encoder.Conv2d_{i}", h, 2, 2, num), num=num)
    return L.conv(p, "encoder.Conv2d_3", h, 2, 2, num)


def synthesis(p, y, num):
    """y NCHW -> x^ NHWC (not clipped)."""
    h = y
    for i in range(3):
        h = L.gdn(p, f"decoder.GDN_{i}", L.deconv(p, f"decoder.Deconv2d_{i}", h, num=num), True,
                  num)
    return L.nhwc(L.deconv(p, "decoder.Deconv2d_3", h, num=num))


def hyper_analysis(p, y, num):
    h = L.leaky(L.conv(p, "hyper_encoder.Conv2d_0", y, 1, 1, num))
    h = L.leaky(L.conv(p, "hyper_encoder.Conv2d_1", h, 2, 2, num))
    return L.conv(p, "hyper_encoder.Conv2d_2", h, 2, 2, num)


def hyper_synthesis(p, z, num):
    h = L.leaky(L.deconv(p, "hyper_decoder.Deconv2d_0", z, num=num))
    h = L.leaky(L.deconv(p, "hyper_decoder.Deconv2d_1", h, num=num))
    return L.conv(p, "hyper_decoder.Conv2d_0", h, 1, 1, num)


def latents(p, x, training: bool, generator: Optional[torch.Generator], num):
    """(y, y~ NHWC, z~ NHWC)."""
    y = analysis(p, x, num)
    z = hyper_analysis(p, y, num)
    z_in = L.quantize(L.nhwc(z), training, generator)
    y_in = L.quantize(L.nhwc(y), training, generator)
    return y, y_in, z_in


def forward(cfg, p, x, training: bool, generator: Optional[torch.Generator] = None,
            num: L.Numerics = L.F32, teacher=None):
    """x (B, H, W, 3) in [0, 1] -> x_hat (NHWC, not clipped), logp_y,
    logp_z."""
    m, k = cfg["latent_channels"], cfg["K"]
    _, y_in, z_in = latents(p, x, training, generator, num)
    psi = hyper_synthesis(p, L.nchw(z_in), num)
    phi = L.masked_conv(p, "context_model.MaskedConv2d_0", L.nchw(y_in), num)
    theta = L.entropy_parameters(p, "entropy_parameters", torch.cat([phi, psi], 1), m, k, num)
    return {"x_hat": synthesis(p, L.nchw(y_in), num),
            "logp_y": L.conditional_logp(k, y_in, theta),
            "logp_z": L.factorized_logp(p, "factorized_entropy_model", z_in)}


def serving_outputs(out, x):
    pixels = x.shape[1] * x.shape[2]
    bpp_y = sum(L.bpp(v, pixels) for key, v in out.items()
                if key.startswith("logp_") and key != "logp_z")
    bpp_z = L.bpp(out["logp_z"], pixels)
    return {"x_hat": torch.clamp(out["x_hat"], 0.0, 1.0), "bpp_y": bpp_y, "bpp_z": bpp_z,
            "bpp_total": bpp_y + bpp_z}


def loss(cfg, out, x, teacher=None, num: L.Numerics = L.F32):
    pixels = x.shape[1] * x.shape[2]
    rate = torch.mean(L.bpp(out["logp_y"], pixels)) + torch.mean(L.bpp(out["logp_z"], pixels))
    mse = torch.mean((out["x_hat"] - x) ** 2)
    return rate + cfg["lambda_rd"] * 255.0 ** 2 * mse
