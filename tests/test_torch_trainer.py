"""PyTorch port, train.Trainer, held against the JAX package's Trainer on the
same weights (JAX-initialised, carried across with load_jax_params) and the
same noise (CPU, M=16, K=3, batch 2 of 64x64): the loss and learning-rate
trajectory with the cosine schedule, a binding gradient clip, the EMA and
validation, and the TensorBoard tag catalogue. Then the port alone: exact
resume, diagnostics that leave training alone, preemption, uint8 batches,
intervals, the plateau controller, the event files, pre-EMA checkpoints.

The JAX Trainer draws each step's noise key from its key chain:
PRNGKey(seed) split in 3 at construction (the chain, init, init noise),
then one split a step. The test rebuilds each step's (z, y) noise from
that chain and hands it to the port's training forward by replacing the
port's noise_quantize for calls with the Trainer's generator; the
diagnostic forward keeps drawing its own."""

import json
import os
import signal

import jax
import numpy as np
import pytest
import torch

from neural_image_compression_tpu.models import JointAutoregressiveHierarchical as JModel
from neural_image_compression_tpu.train import Trainer as JTrainer
from neural_image_compression_tpu.train.schedulers import ReduceLROnPlateau as JPlateau
from neural_image_compression_tpu.train.schedulers import cosine_lr as jcosine_lr
from neural_image_compression_tpu_torch.models import JointAutoregressiveHierarchical, joint_ar
from neural_image_compression_tpu_torch.parallel import train_step
from neural_image_compression_tpu_torch.train import ReduceLROnPlateau, Trainer, cosine_lr
from neural_image_compression_tpu_torch.utils.checkpoint import checkpoint_exists
from neural_image_compression_tpu_torch.utils.weights import load_jax_params
from test_torch_train import _jax_noise

torch.set_num_threads(1)

M, K = 16, 3
SEED = 0
LAMBDA = 0.005
LR = 1e-3
STEPS = 4
CLIP = 0.5  # below every step's gradient norm here: checked, so it binds
EMA_DECAY = 0.9
# the JAX run: cosine, clip, EMA, validation at steps 0 and 2, diagnostics
# every step
JAX_SETTINGS = dict(lambda_val=LAMBDA, learning_rate=LR, scheduler="cosine", max_steps=STEPS,
                    val_interval=2, log_interval=1, img_interval=1, ema_decay=EMA_DECAY,
                    clip_grad_norm=CLIP, seed=SEED)


def _loader(n=3, batch=2, size=64, seed=1):
    rng = np.random.default_rng(seed)
    return [rng.uniform(size=(batch, size, size, 3)).astype(np.float32) for _ in range(n)]


VAL = _loader(n=1, batch=1, seed=2)


def _scalars(log_dir, tag):
    rows = [json.loads(line) for line in open(os.path.join(log_dir, "metrics.jsonl"))]
    return [(r["step"], r["value"]) for r in rows if r["tag"] == tag]


def _tags(log_dir):
    from tensorboard.backend.event_processing.event_accumulator import EventAccumulator

    acc = EventAccumulator(str(log_dir), size_guidance={"scalars": 0, "histograms": 0,
                                                        "images": 0})
    acc.Reload()
    tags = acc.Tags()
    return {kind: set(tags[kind]) for kind in ("scalars", "histograms", "images")}, acc


def _jax_step_keys(seed, steps):
    rng = jax.random.PRNGKey(seed)
    rng, _, _ = jax.random.split(rng, 3)
    keys = []
    for _ in range(steps):
        rng, step_rng = jax.random.split(rng)
        keys.append(step_rng)
    return keys


@pytest.fixture(scope="module")
def jax_run(tmp_path_factory):
    """The JAX Trainer's run: its initial params, its log dir and each
    step's noise."""
    pytest.importorskip("tensorboard")
    pytest.importorskip("matplotlib")
    log_dir = tmp_path_factory.mktemp("jax_runs")
    loader = _loader()
    trainer = JTrainer(JModel(latent_channels=M, K=K), loader, val_loader=VAL,
                       log_dir=str(log_dir), checkpoint_path=None, **JAX_SETTINGS)
    params0 = jax.tree.map(np.array, trainer.params)
    trainer.train()
    trainer.logger.flush()
    jmodel = JModel(latent_channels=M, K=K)
    noises = []
    for i, key in enumerate(_jax_step_keys(SEED, STEPS)):
        noises.append(_jax_noise(jmodel, params0, key, loader[i % len(loader)]))
    return params0, log_dir, noises


def _port_model(params0):
    return load_jax_params(JointAutoregressiveHierarchical(M, K, device="cpu"), params0)


def _feed_noise(monkeypatch, trainer, noises):
    """The training forward adds the JAX noise of each step; any other
    forward (the diagnostics') draws its own."""
    flat = iter([a for pair in noises for a in pair])
    drawn = joint_ar.noise_quantize

    def fed(v, generator=None):
        if generator is trainer.generator:
            return v + torch.tensor(next(flat))
        return drawn(v, generator)

    monkeypatch.setattr(joint_ar, "noise_quantize", fed)


def test_trajectory_matches_jax_trainer(monkeypatch, tmp_path, jax_run):
    """Cosine schedule, a clip that binds at every step, EMA, validation on
    the EMA weights: losses within rtol 1e-4 (test_torch_train.py's bound
    for make_train_step's trajectory), the learning rates within 1e-6 (JAX
    keeps them in float32) and the validation loss within 1e-5."""
    params0, jax_dir, noises = jax_run
    norms = []
    clip = train_step.clip_by_global_norm

    def recording(grads, max_norm):
        norm = clip(grads, max_norm)
        norms.append(float(norm))
        return norm

    monkeypatch.setattr(train_step, "clip_by_global_norm", recording)
    trainer = Trainer(_port_model(params0), _loader(), val_loader=VAL,
                      log_dir=str(tmp_path / "runs"), checkpoint_path=None, **JAX_SETTINGS)
    _feed_noise(monkeypatch, trainer, noises)
    assert trainer.train() is trainer.model
    assert trainer.step == STEPS
    assert len(norms) == STEPS and min(norms) > CLIP, norms

    port_dir = str(tmp_path / "runs")
    for tag, rtol in (("losses/loss", 1e-4), ("losses/bpp_total", 1e-4),
                      ("train/learning_rate", 1e-6), ("validation/validation_loss", 1e-5)):
        got, want = _scalars(port_dir, tag), _scalars(str(jax_dir), tag)
        assert [s for s, _ in got] == [s for s, _ in want], tag
        np.testing.assert_allclose([v for _, v in got], [v for _, v in want], rtol=rtol,
                                   err_msg=tag)
    assert [s for s, _ in _scalars(port_dir, "validation/validation_loss")] == [0, 2]
    losses = [v for _, v in _scalars(port_dir, "losses/loss")]
    assert losses[-1] != losses[0]


def test_tensorboard_tags_match_jax_trainer(tmp_path, jax_run):
    """Every scalar, histogram and image tag of the JAX Trainer's catalogue,
    and no other, with diagnostics at every step; the events read back with
    tensorboard's own reader."""
    params0, jax_dir, _ = jax_run
    trainer = Trainer(_port_model(params0), _loader(), val_loader=VAL,
                      log_dir=str(tmp_path / "runs"), checkpoint_path=None,
                      **dict(JAX_SETTINGS, max_steps=2))
    trainer.train()
    trainer.logger.flush()
    got, acc = _tags(tmp_path / "runs")
    want, _ = _tags(jax_dir)
    assert got == want
    assert "bottleneck/cdf" in got["images"] and "comparison/paired" in got["images"]
    assert [s.step for s in acc.Scalars("losses/loss")] == [0, 1]
    assert len(acc.Histograms("latents/y")) == 2


def _state(trainer):
    """Parameters, Adam's state and the EMA, cloned."""
    return ({k: v.clone() for k, v in trainer.model.state_dict().items()},
            {i: {k: v.clone() for k, v in s.items()}
             for i, s in trainer.optimizer.state_dict()["state"].items()},
            {k: v.clone() for k, v in (trainer.ema_params or {}).items()})


def _assert_state_equal(a, b):
    for x, y in zip(a, b):
        assert x.keys() == y.keys()
        for k in x:
            if isinstance(x[k], dict):
                for kk in x[k]:
                    assert torch.equal(x[k][kk], y[k][kk]), (k, kk)
            else:
                assert torch.equal(x[k], y[k]), k


def _port_trainer(tmp_path, name, **kw):
    settings = dict(lambda_val=LAMBDA, learning_rate=LR, log_interval=1000, img_interval=1000,
                    log_dir=str(tmp_path / name), checkpoint_path=None, seed=3)
    settings.update(kw)
    model = JointAutoregressiveHierarchical(M, K, device="cpu", seed=5)
    return Trainer(model, settings.pop("loader", _loader()), **settings)


def test_resume_is_exact(tmp_path):
    """Six steps straight, and three + checkpoint + a resumed Trainer of
    three: bit-equal parameters, Adam state and EMA (the noise generator's
    state travels in the checkpoint); resume extends max_steps."""
    ckpt = str(tmp_path / "ckpt.pt")
    kw = dict(ema_decay=EMA_DECAY, clip_grad_norm=CLIP)
    straight = _port_trainer(tmp_path, "a", max_steps=6, **kw)
    straight.train()
    first = _port_trainer(tmp_path, "b", max_steps=3, checkpoint_path=ckpt, **kw)
    first.train()
    assert checkpoint_exists(ckpt) and not os.path.exists(ckpt + ".tmp")
    second = _port_trainer(tmp_path, "c", max_steps=3, checkpoint_path=ckpt, resume=True, **kw)
    assert second.step == 3 and second.max_steps == 6
    second.train()
    assert second.step == 6
    _assert_state_equal(_state(straight), _state(second))
    assert not torch.equal(straight.ema_params["encoder.Conv2d_0.weight"],
                           straight.model.encoder.Conv2d_0.weight)


def test_diagnostics_leave_training_alone(tmp_path):
    """Diagnostics at every step draw their own noise: the parameters after
    two steps are bit-equal to a run without them."""
    logged = _port_trainer(tmp_path, "a", max_steps=2, log_interval=1, img_interval=1)
    logged.train()
    quiet = _port_trainer(tmp_path, "b", max_steps=2)
    quiet.train()
    _assert_state_equal(_state(logged), _state(quiet))
    tags = {json.loads(line)["tag"] for line in open(tmp_path / "a" / "metrics.jsonl")}
    assert "activity/y_dead_channels_by_entropy" in tags


class _SigtermLoader:
    """Three batches; sends SIGTERM to this process while producing the
    batch of step 2."""

    def __init__(self):
        self.batches = _loader()
        self.served = 0

    def __iter__(self):
        for b in self.batches:
            if self.served == 2:
                os.kill(os.getpid(), signal.SIGTERM)
            self.served += 1
            yield b


def test_sigterm_checkpoints_and_resumes(tmp_path):
    ckpt = str(tmp_path / "ckpt.pt")
    before = signal.getsignal(signal.SIGTERM)
    trainer = _port_trainer(tmp_path, "a", max_steps=100, preemption_safe=True,
                            checkpoint_path=ckpt, loader=_SigtermLoader())
    trainer.train()
    assert signal.getsignal(signal.SIGTERM) is before  # handlers restored
    assert trainer.step == 3  # the step in flight finished, then the loop stopped
    assert checkpoint_exists(ckpt)
    resumed = _port_trainer(tmp_path, "b", max_steps=2, checkpoint_path=ckpt, resume=True)
    assert resumed.step == 3 and resumed.max_steps == 5
    _assert_state_equal(_state(trainer)[:2], _state(resumed)[:2])


def test_uint8_batches_train_and_validate(tmp_path):
    """uint8 batches (normalized on the device) give the float32 run's
    losses and validation loss."""
    u8 = [(b * 255).round().astype(np.uint8) for b in _loader()]
    runs = {}
    for name, loader, val in (("u8", u8, [u8[0][:1]]),
                              ("f32", [b.astype(np.float32) / 255 for b in u8],
                               [u8[0][:1].astype(np.float32) / 255])):
        _port_trainer(tmp_path, name, max_steps=2, loader=loader, val_loader=val,
                      val_interval=1).train()
        runs[name] = [v for _, v in _scalars(str(tmp_path / name), "losses/loss")
                      + _scalars(str(tmp_path / name), "validation/validation_loss")]
    assert len(runs["u8"]) == 4 and np.isfinite(runs["u8"]).all()
    np.testing.assert_allclose(runs["u8"], runs["f32"], rtol=1e-6)


def test_scalar_interval(tmp_path):
    _port_trainer(tmp_path, "a", max_steps=6, scalar_interval=3, scheduler="cosine").train()
    assert [s for s, _ in _scalars(str(tmp_path / "a"), "losses/loss")] == [0, 3]
    assert [s for s, _ in _scalars(str(tmp_path / "a"), "train/learning_rate")] == [0, 3]


def test_empty_loader_raises(tmp_path):
    with pytest.raises(ValueError, match="no batches"):
        _port_trainer(tmp_path, "a", max_steps=1, loader=[]).train()


@pytest.mark.parametrize("kw, match", [
    (dict(ema_decay=1.0), "ema_decay"),
    (dict(clip_grad_norm=0.0), "clip_grad_norm"),
    (dict(scheduler="linear"), "scheduler"),
])
def test_invalid_settings_raise(tmp_path, kw, match):
    with pytest.raises(ValueError, match=match):
        _port_trainer(tmp_path, "a", max_steps=1, **kw)


def test_custom_optimizer_with_clip_raises(tmp_path):
    model = JointAutoregressiveHierarchical(8, 3, device="cpu")
    opt = torch.optim.SGD(model.parameters(), lr=1e-3)
    with pytest.raises(ValueError, match="not both"):
        Trainer(model, _loader(), optimizer=opt, clip_grad_norm=1.0, checkpoint_path=None,
                log_dir=str(tmp_path / "a"))


def test_custom_optimizer_takes_the_schedule(tmp_path):
    """The schedule writes lr into every param group of any optimizer."""
    model = JointAutoregressiveHierarchical(8, 3, device="cpu")
    opt = torch.optim.SGD([{"params": list(model.encoder.parameters())},
                           {"params": [p for n, p in model.named_parameters()
                                       if not n.startswith("encoder.")]}], lr=LR)
    trainer = Trainer(model, _loader(), optimizer=opt, scheduler="cosine", max_steps=2,
                      learning_rate=LR, log_interval=1000, img_interval=1000,
                      checkpoint_path=None, log_dir=str(tmp_path / "a"))
    trainer.train()
    assert [g["lr"] for g in opt.param_groups] == [cosine_lr(2, LR, 2)] * 2


def test_plateau_controller_follows_jax():
    rng = np.random.default_rng(7)
    metrics = list(np.cumsum(rng.normal(size=60)) + 100.0)
    ours, ref = ReduceLROnPlateau(1.0, patience=2), JPlateau(1.0, patience=2)
    assert [ours.step(m) for m in metrics] == [ref.step(m) for m in metrics]
    assert ours.state_dict() == ref.state_dict()
    fresh = ReduceLROnPlateau(1.0)
    fresh.load_state_dict(ours.state_dict())
    assert fresh.state_dict() == ours.state_dict()
    for step in (0, 1, 37, 100, 150):
        assert cosine_lr(step, 1e-3, 100) == jcosine_lr(step, 1e-3, 100)


def test_plateau_scheduler_in_the_trainer(tmp_path):
    trainer = _port_trainer(tmp_path, "a", max_steps=3, val_loader=VAL, val_interval=1,
                            scheduler="plateau")
    trainer.plateau.patience = 0  # every validation is a plateau
    trainer.plateau.best = -1.0
    trainer.train()
    assert trainer.current_lr() == LR * 0.5 ** 3
    lrs = [v for _, v in _scalars(str(tmp_path / "a"), "train/learning_rate")]
    assert lrs == [LR * 0.5, LR * 0.25, LR * 0.125]


def test_ema_resumes_from_a_checkpoint_without_ema(tmp_path):
    ckpt = str(tmp_path / "ckpt.pt")
    _port_trainer(tmp_path, "a", max_steps=2, checkpoint_path=ckpt).train()
    resumed = _port_trainer(tmp_path, "b", max_steps=1, checkpoint_path=ckpt, resume=True,
                            ema_decay=EMA_DECAY)
    assert resumed.step == 2
    for name, p in resumed.model.named_parameters():
        assert torch.equal(resumed.ema_params[name], p.detach()), name
    assert resumed.eval_params is resumed.ema_params
    resumed.train()
    plain = _port_trainer(tmp_path, "c", max_steps=1)
    assert plain.eval_params.keys() == dict(plain.model.named_parameters()).keys()
