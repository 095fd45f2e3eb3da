"""The scalable two-layer family (``ScalableImageCoding``) with its vision
distillation teacher."""

import functools

from port_bench import flops


def build_model(cfg, dtype, device):
    from neural_image_compression_tpu_torch.models.scalable import ScalableImageCoding
    return ScalableImageCoding(cfg["latent_channels"], cfg["base_channels"], cfg["K"],
                               tuple(cfg["lst_upsampling"]), dtype=dtype, device=device)


def build_objective(cfg, teacher_weights, device):
    """(loss, lambda) for ``make_train_step``: ``vision_rd_loss`` with the
    vision term against the port's YOLOv5 backbone, its layers 0..cut
    loaded with the benchmark's weights (the later layers never run)."""
    from neural_image_compression_tpu_torch.models.backbones import (
        build_yolo_backbone, distillation_targets,
    )
    from neural_image_compression_tpu_torch.train.loss import vision_rd_loss

    t = cfg["teacher"]
    backbone = build_yolo_backbone(t["width"], t["depth"], device=device)
    missing, unexpected = backbone.load_state_dict(teacher_weights, strict=False)
    cut_prefixes = tuple(f"layers_{i}_0." for i in range(t["cut"] + 1))
    if unexpected or any(k.startswith(cut_prefixes) for k in missing):
        raise ValueError(f"teacher weights do not fit the backbone: missing {missing}, "
                         f"unexpected {unexpected}")
    act, V = distillation_targets(backbone, t["cut"])
    return (functools.partial(vision_rd_loss, gamma=cfg["gamma"], frozen_activation=act, V=V),
            cfg["lambda_rd"])


def captured_modules(model):
    """The LST's output F~, which the serving dict leaves out."""
    return {"F_tilde": model.LST}


def eval_flops(cfg, h, w) -> int:
    return flops.scalable_eval_flops(cfg["latent_channels"], cfg["base_channels"], cfg["K"],
                                     h, w, tuple(cfg["lst_upsampling"]))["total"]


def step_flops(cfg, h, w) -> int:
    """Forward and backward of the model, and the teacher's forward and its
    input gradient."""
    return (flops.train_step_flops(eval_flops(cfg, h, w))
            + 2 * flops.teacher_flops(cfg["teacher"]["width"], h, w))


def gdn_sites(cfg, h, w, training: bool):
    """The transforms' six GDN/IGDN at M channels, then the LST's IGDNs on
    the H/8 grid: one at M1 and two at 2 M1 (the default upsampling)."""
    m, m1 = cfg["latent_channels"], cfg["base_channels"]
    sites = [(h * w // (s * s), m) for s in (2, 4, 8, 8, 4, 2)]
    grid, width = h * w // 256, m1
    for u in cfg["lst_upsampling"][:3]:
        grid *= u * u
        sites.append((grid, width))
        width *= u
    return sites
