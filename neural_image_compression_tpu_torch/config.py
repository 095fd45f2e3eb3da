"""Dataclass configuration and the model factory, port of config.py.

Every run is described by small dataclasses, written to and read from JSON
with the JAX package's schema: a file written by its ``Config.to_json()``
loads here unchanged, and the other way round. The defaults are the
reference's published flagship run: JointAutoregressiveHierarchical(
latent_channels=128, K=3), lambda=0.005, Adam lr=1e-4, batch 16 on 256^2
patches.
"""

import dataclasses
import json
from dataclasses import dataclass, field
from typing import Optional

import torch

from neural_image_compression_tpu_torch.utils.device import DeviceLike


@dataclass
class ModelConfig:
    name: str = "joint_ar"  # joint_ar | residual | factorized | hyperprior
                            # | scalable | checkerboard | channel_cb (alias
                            # elic) | gained | gained_hyperprior
                            # | gained_checkerboard | gained_channel_cb
    latent_channels: int = 128
    K: int = 3
    base_channels: int = 96        # scalable only (M1 < M)
    dtype: Optional[str] = None    # None (f32) | 'bf16' transform compute
    levels: Optional[list] = None  # gained* only: ascending lambda
                                   # ladder (None -> family defaults)


@dataclass
class DataConfig:
    train_dir: str = "./data/train"
    val_dir: Optional[str] = None
    batch_size: int = 16
    shuffle: bool = True
    seed: int = 0


@dataclass
class TrainConfig:
    lambda_rd: float = 0.005
    loss: str = "mse"                    # 'mse' (rd_loss, reference objective)
                                         # | 'msssim' (bpp + lambda*(1-MS-SSIM);
                                         #   lambda scales differ — see
                                         #   train.loss.msssim_rd_loss)
    learning_rate: float = 1e-4
    max_steps: int = 100000
    scheduler: Optional[str] = None      # None | 'cosine' | 'plateau'
    log_interval: Optional[int] = None
    img_interval: Optional[int] = None
    val_interval: Optional[int] = None
    checkpoint_interval: Optional[int] = None
    log_dir: str = "runs/experiment"
    checkpoint_path: str = "./checkpoints/checkpoint"
    resume: bool = False
    seed: int = 0
    gamma: float = 0.0                   # vision distillation weight (scalable)
    backbone: str = ""                   # saved backbone .npz (models.save_backbone);
                                         # activates the distillation term when gamma>0
    backbone_cut: int = 3                # backbone split layer (FirstHalf = [0, cut])
    data_parallel: bool = False          # shard the batch over all devices
    scalar_interval: int = 1             # per-step scalar logging cadence
    preemption_safe: bool = False        # SIGTERM -> checkpoint + clean exit
    ema_decay: float = 0.0               # >0 enables EMA params (e.g. 0.999);
                                         # checkpointed; eval prefers them
    clip_grad_norm: float = 0.0          # >0 clips gradients by global norm
                                         # (stabilizes high-lambda training)


@dataclass
class EvalConfig:
    data_dir: str = "./data/kodak"
    lambda_rd: float = 0.005
    save_dir: str = "./eval_results"
    caption: str = ""
    nb_steps: int = 0


@dataclass
class Config:
    model: ModelConfig = field(default_factory=ModelConfig)
    data: DataConfig = field(default_factory=DataConfig)
    train: TrainConfig = field(default_factory=TrainConfig)
    eval: EvalConfig = field(default_factory=EvalConfig)

    def to_json(self) -> str:
        return json.dumps(dataclasses.asdict(self), indent=1)

    @classmethod
    def from_json(cls, text: str) -> "Config":
        raw = json.loads(text)
        return cls(model=ModelConfig(**raw.get("model", {})),
                   data=DataConfig(**raw.get("data", {})),
                   train=TrainConfig(**raw.get("train", {})),
                   eval=EvalConfig(**raw.get("eval", {})))


_GAINED = ("gained", "gained_hyperprior", "gained_checkerboard", "gained_channel_cb")


def build_model(cfg: ModelConfig, device: DeviceLike = None, seed: int = 0):
    """The port's model for ``cfg``, its weights drawn from ``seed`` on
    ``device`` (``cuda`` unless the caller names one; with no CUDA device
    and none named the model's constructor raises). An unknown name raises
    ``ValueError``."""
    from neural_image_compression_tpu_torch import models

    dtype = torch.bfloat16 if cfg.dtype == "bf16" else None
    kw = dict(dtype=dtype, device=device, seed=seed)
    m, k = cfg.latent_channels, cfg.K
    if cfg.name in _GAINED:
        if cfg.levels:
            kw["levels"] = tuple(cfg.levels)
        cls = {"gained": models.GainedJointAR,
               "gained_hyperprior": models.GainedHyperprior,
               "gained_checkerboard": models.GainedCheckerboard,
               "gained_channel_cb": models.GainedChannelCheckerboard}[cfg.name]
        return cls(m, k, **kw)
    if cfg.name == "joint_ar":
        return models.JointAutoregressiveHierarchical(m, k, **kw)
    if cfg.name == "checkerboard":
        return models.CheckerboardHierarchical(m, k, **kw)
    if cfg.name in ("channel_cb", "elic"):
        return models.ChannelCheckerboardHierarchical(m, k, **kw)
    if cfg.name == "residual":
        return models.HierarchicalMixtureResidual(m, k, **kw)
    if cfg.name == "factorized":
        return models.FactorizedPrior(m, **kw)
    if cfg.name == "hyperprior":
        return models.MeanScaleHyperprior(m, k, **kw)
    if cfg.name == "scalable":
        return models.ScalableImageCoding(m, cfg.base_channels, k, **kw)
    raise ValueError(f"unknown model name: {cfg.name}")
