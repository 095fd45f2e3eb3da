"""The joint autoregressive hierarchical family (``JointAutoregressiveHierarchical``)."""

from port_bench import flops


def build_model(cfg, dtype, device):
    from neural_image_compression_tpu_torch.models.joint_ar import (
        JointAutoregressiveHierarchical,
    )
    return JointAutoregressiveHierarchical(cfg["latent_channels"], cfg["K"], cfg["transform"],
                                           dtype=dtype, device=device)


def build_objective(cfg, teacher_weights, device):
    """(loss, lambda) for ``make_train_step``."""
    from neural_image_compression_tpu_torch.train.loss import rd_loss
    return rd_loss, cfg["lambda_rd"]


def captured_modules(model):
    """Modules whose outputs the serve check compares besides the serving
    dict: none here."""
    return {}


def eval_flops(cfg, h, w) -> int:
    return flops.joint_ar_eval_flops(cfg["latent_channels"], cfg["K"], h, w,
                                     cfg["transform"])["total"]


def step_flops(cfg, h, w) -> int:
    return flops.train_step_flops(eval_flops(cfg, h, w))


def gdn_sites(cfg, h, w, training: bool):
    """(pixels of one image, channels) of every GDN/IGDN call of a forward:
    the analysis's three at H/2, H/4, H/8 and the synthesis's three back
    up; a training step runs each one's backward too."""
    m = cfg["latent_channels"]
    return [(h * w // (s * s), m) for s in (2, 4, 8, 8, 4, 2)]
