"""PyTorch port, ``config.py``: the dataclasses against the JAX package's
(JSON both ways) and ``build_model`` for every model name against the JAX
``build_model``'s tree of parameters (names and shapes, from
``jax.eval_shape``: nothing is compiled), the dtype, the ladder and the
errors (CPU)."""

import dataclasses

import jax
import jax.numpy as jnp
import pytest
import torch

from neural_image_compression_tpu import config as jax_config
from neural_image_compression_tpu.config import Config as JConfig
from neural_image_compression_tpu.config import ModelConfig as JModelConfig
from neural_image_compression_tpu.config import build_model as jbuild_model
from neural_image_compression_tpu_torch import Config, build_model, config
from neural_image_compression_tpu_torch.config import ModelConfig
from neural_image_compression_tpu_torch.utils.weights import joint_ar_params_to_jax

torch.set_num_threads(1)

NAMES = ("joint_ar", "residual", "factorized", "hyperprior", "scalable", "checkerboard",
         "channel_cb", "elic", "gained", "gained_hyperprior", "gained_checkerboard",
         "gained_channel_cb")
CLASSES = {"joint_ar": "JointAutoregressiveHierarchical",
           "residual": "JointAutoregressiveHierarchical", "factorized": "FactorizedPrior",
           "hyperprior": "MeanScaleHyperprior", "scalable": "ScalableImageCoding",
           "checkerboard": "CheckerboardHierarchical",
           "channel_cb": "ChannelCheckerboardHierarchical",
           "elic": "ChannelCheckerboardHierarchical", "gained": "GainedJointAR",
           "gained_hyperprior": "GainedHyperprior", "gained_checkerboard": "GainedCheckerboard",
           "gained_channel_cb": "GainedChannelCheckerboard"}


def _shapes(tree, prefix=()):
    out = {}
    for k, v in tree.items():
        if isinstance(v, dict):
            out.update(_shapes(v, prefix + (k,)))
        else:
            out["/".join(prefix + (k,))] = tuple(v.shape)
    return out


def _edited(cls):
    cfg = cls()
    cfg.model.latent_channels = 64
    cfg.model.dtype = "bf16"
    cfg.model.levels = [0.001, 0.01]
    cfg.data.val_dir = "val"
    cfg.train.lambda_rd = 0.01
    cfg.train.scheduler = "cosine"
    cfg.train.ema_decay = 0.999
    cfg.eval.caption = "x"
    return cfg


@pytest.mark.parametrize("cls", ["Config", "ModelConfig", "DataConfig", "TrainConfig",
                                 "EvalConfig"])
def test_schema_is_the_jax_packages(cls):
    def fields(c):
        return [(f.name, getattr(f.type, "__name__", f.type), f.default)
                for f in dataclasses.fields(c)]

    assert fields(getattr(config, cls)) == fields(getattr(jax_config, cls))


def test_json_both_ways_with_the_jax_config():
    assert Config().to_json() == JConfig().to_json()
    port, jax_cfg = _edited(Config), _edited(JConfig)
    assert port.to_json() == jax_cfg.to_json()
    assert Config.from_json(jax_cfg.to_json()) == port
    assert JConfig.from_json(port.to_json()) == jax_cfg
    assert Config.from_json(port.to_json()).model.levels == [0.001, 0.01]
    # sections left out take their defaults, as in JAX
    assert Config.from_json('{"model": {"K": 1}}') == Config(model=ModelConfig(K=1))


def test_defaults_are_the_flagship():
    cfg = Config()
    assert (cfg.model.name, cfg.model.latent_channels, cfg.model.K) == ("joint_ar", 128, 3)
    assert (cfg.train.lambda_rd, cfg.train.learning_rate, cfg.data.batch_size) == (
        0.005, 1e-4, 16)


@pytest.mark.parametrize("name", NAMES)
def test_build_model_tree_matches_jax(name):
    fields = dict(name=name, latent_channels=16, K=2, base_channels=8)
    model = build_model(ModelConfig(**fields), device="cpu")
    assert type(model).__name__ == CLASSES[name]
    jmodel = jbuild_model(JModelConfig(**fields))
    key = jax.random.PRNGKey(0)
    want = jax.eval_shape(lambda: jmodel.init({"params": key, "noise": key},
                                              jnp.zeros((1, 64, 64, 3)), training=False))
    assert _shapes(joint_ar_params_to_jax(model)) == _shapes(want["params"])
    assert next(model.parameters()).device.type == "cpu"


def test_build_model_options():
    cfg = ModelConfig(latent_channels=16, K=1)
    assert build_model(cfg, device="cpu").dtype is None
    bf16 = build_model(dataclasses.replace(cfg, dtype="bf16"), device="cpu")
    assert bf16.dtype == torch.bfloat16
    assert next(bf16.parameters()).dtype == torch.float32  # bf16 compute, f32 weights
    gained = build_model(dataclasses.replace(cfg, name="gained", levels=[0.002, 0.02, 0.2]),
                         device="cpu")
    assert tuple(gained.levels) == (0.002, 0.02, 0.2)
    assert build_model(dataclasses.replace(cfg, name="scalable", base_channels=8),
                       device="cpu").base_channels == 8
    a, b, c = (build_model(cfg, device="cpu", seed=s).state_dict() for s in (0, 0, 1))
    assert all(torch.equal(a[k], b[k]) for k in a)
    assert not all(torch.equal(a[k], c[k]) for k in a)


def test_build_model_unknown():
    with pytest.raises(ValueError, match="unknown model name: nope"):
        build_model(ModelConfig(name="nope"), device="cpu")


def test_build_model_default_device_needs_cuda(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        build_model(ModelConfig(latent_channels=16, K=1))
