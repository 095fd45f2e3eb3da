"""Plain reference of the scalable two-layer model and its vision
distillation loss.

The latents y (M channels) split into y1 (the first M1) and y2; each layer
has its own masked context and entropy-parameter net over [phi_i, psi],
sharing the hyper path. A latent-space transform (LST: residual and
upsampling blocks with IGDN) maps y1 to F~ on the H/8 grid. The loss is

    bpp_y1 + bpp_y2 + bpp_z + lambda * (MSE + gamma * mean((act(F~) - V(x^))^2))

where V is a frozen YOLOv5 backbone through its cut layer and act that
layer's frozen BatchNorm and SiLU (``reference.backbone``).
"""

from typing import List, Optional

import torch

from port_bench.reference import backbone as B
from port_bench.reference import joint_ar as J
from port_bench.reference import layers as L


def _residual_specs(name, cin, cout, gain=1.4) -> List[L.Spec]:
    s = (L.conv_specs(f"{name}.Conv2d_0", cin, cout, 3, gain)
         + L.conv_specs(f"{name}.Conv2d_1", cout, cout, 3, 1.4))
    if cin != cout:
        s += L.conv_specs(f"{name}.Conv2d_2", cin, cout, 1, 1.0)
    return s


def _upsample_specs(name, cin, cout, up, gain=1.0) -> List[L.Spec]:
    return (L.conv_specs(f"{name}.TransposedDeconv3x3_0.Deconv2d_0", cin, cout, 3, 1.4 * gain,
                         transposed=True, stride=up)
            + L.conv_specs(f"{name}.Conv2d_0", cout, cout, 3, 1.0)
            + L.gdn_specs(f"{name}.GDN_0", cout)
            + L.conv_specs(f"{name}.TransposedDeconv3x3_1.Deconv2d_0", cin, cout, 3, 0.5 * gain,
                           transposed=True, stride=up))


def lst_specs(m1, ups) -> List[L.Spec]:
    """The first residual block passes y1 (about LATENT_SCALE) on through
    its identity skip; the first upsampling block takes it back to about 1
    before any IGDN."""
    s, c, m = [], m1, m1
    for i, u in enumerate(ups[:3]):
        gain = 1.0 / J.LATENT_SCALE if i == 0 else 1.0
        s += _residual_specs(f"LST.ResidualBlock_{i}", c, m, 1.4 * gain)
        s += _upsample_specs(f"LST.ResidualBlockUpsample_{i}", m, m, u, gain)
        c, m = m, m * u
    s += _residual_specs("LST.ResidualBlock_3", c, m)
    s += L.conv_specs("LST.Conv2d_0", m, m * ups[3], 3, 1.0)
    return s


def specs(cfg) -> List[L.Spec]:
    m, m1, k = cfg["latent_channels"], cfg["base_channels"], cfg["K"]
    m2 = m - m1
    return (J.transform_specs(m) + L.factorized_specs("factorized_entropy_model", m)
            + L.conv_specs("context_model_1.MaskedConv2d_0", m1, 2 * m1, 5, 1.0 / J.LATENT_SCALE)
            + L.conv_specs("context_model_2.MaskedConv2d_0", m2, 2 * m2, 5, 1.0 / J.LATENT_SCALE)
            + L.entropy_parameter_specs("entropy_parameters_1", 2 * m1 + 2 * m, m1, k, J.SIGMA)
            + L.entropy_parameter_specs("entropy_parameters_2", 2 * m2 + 2 * m, m2, k, J.SIGMA)
            + lst_specs(m1, tuple(cfg["lst_upsampling"])))


def teacher_specs(cfg):
    t = cfg["teacher"]
    return B.specs(t["width"], t["cut"])


def _residual(p, name, x, num):
    out = L.leaky(L.conv(p, f"{name}.Conv2d_1", L.leaky(L.conv(p, f"{name}.Conv2d_0", x, 1, 1, num)),
                         1, 1, num))
    skip = L.conv(p, f"{name}.Conv2d_2", x, num=num) if f"{name}.Conv2d_2.weight" in p else x
    return out + skip


def _upsample(p, name, x, up, num):
    def tdeconv(which, t):
        return L.deconv(p, f"{name}.TransposedDeconv3x3_{which}.Deconv2d_0", t, up, 1, up - 1, num)

    out = L.gdn(p, f"{name}.GDN_0", L.conv(p, f"{name}.Conv2d_0", L.leaky(tdeconv(0, x)), 1, 1, num),
                True, num)
    return out + tdeconv(1, x)


def lst(cfg, p, y1, num):
    """y1 NCHW -> F~ NHWC."""
    h = y1
    for i, u in enumerate(tuple(cfg["lst_upsampling"])[:3]):
        h = _residual(p, f"LST.ResidualBlock_{i}", h, num)
        h = _upsample(p, f"LST.ResidualBlockUpsample_{i}", h, u, num)
    h = _residual(p, "LST.ResidualBlock_3", h, num)
    return L.nhwc(L.conv(p, "LST.Conv2d_0", h, 1, 1, num))


def forward(cfg, p, x, training: bool, generator: Optional[torch.Generator] = None,
            num: L.Numerics = L.F32, teacher=None):
    m1, k = cfg["base_channels"], cfg["K"]
    _, y_in, z_in = J.latents(p, x, training, generator, num)
    psi = J.hyper_synthesis(p, L.nchw(z_in), num)
    out = {}
    for layer, y_l in (("1", y_in[..., :m1]), ("2", y_in[..., m1:])):
        phi = L.masked_conv(p, f"context_model_{layer}.MaskedConv2d_0", L.nchw(y_l), num)
        theta = L.entropy_parameters(p, f"entropy_parameters_{layer}", torch.cat([phi, psi], 1),
                                     y_l.shape[-1], k, num)
        out["logp_y" + layer] = L.conditional_logp(k, y_l, theta)
    out["logp_z"] = L.factorized_logp(p, "factorized_entropy_model", z_in)
    out["x_hat"] = J.synthesis(p, L.nchw(y_in), num)
    out["F_tilde"] = lst(cfg, p, L.nchw(y_in[..., :m1]), num)
    return out


def serving_outputs(out, x):
    return J.serving_outputs(out, x)


def loss(cfg, out, x, teacher, num: L.Numerics = L.F32):
    pixels = x.shape[1] * x.shape[2]
    rate = sum(torch.mean(L.bpp(out[key], pixels)) for key in ("logp_y1", "logp_y2", "logp_z"))
    mse = torch.mean((out["x_hat"] - x) ** 2)
    cut = cfg["teacher"]["cut"]
    f_act = B.frozen_activation(teacher, cut, out["F_tilde"])
    f_target = B.first_half(teacher, cfg["teacher"], out["x_hat"], num)
    vision = torch.mean((f_act - f_target) ** 2)
    return rate + cfg["lambda_rd"] * (mse + cfg["gamma"] * vision)
