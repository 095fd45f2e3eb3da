"""PyTorch port, global-norm gradient clipping (parallel.clip_by_global_norm
and make_train_step's clip_grad_norm), held against
optax.clip_by_global_norm on the same gradients: where the bound binds and
where it does not."""

import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from neural_image_compression_tpu_torch.models import JointAutoregressiveHierarchical, joint_ar
from neural_image_compression_tpu_torch.parallel import clip_by_global_norm, make_train_step
from neural_image_compression_tpu_torch.train import rd_loss

torch.set_num_threads(1)

SHAPES = [(5, 3), (7,), (2, 3, 4), (16, 16, 5, 5)]


def _grads(seed):
    rng = np.random.default_rng(seed)
    return [rng.normal(scale=10.0 ** rng.uniform(-3, 0), size=s).astype(np.float32)
            for s in SHAPES]


@pytest.mark.parametrize("factor", [0.1, 0.999, 1.001, 10.0],
                         ids=["binds", "binds-barely", "free-barely", "free"])
def test_clip_matches_optax(factor):
    """max_norm = factor x the global norm: below 1 the bound binds. The
    clipped gradients match optax's to float32 rounding (the norm sums in
    another order); unclipped ones come back bit-equal."""
    grads = _grads(0)
    norm = float(np.sqrt(sum(np.sum(g.astype(np.float64) ** 2) for g in grads)))
    max_norm = factor * norm
    want, _ = optax.clip_by_global_norm(max_norm).update([jnp.asarray(g) for g in grads],
                                                         optax.EmptyState())
    got = [torch.from_numpy(g.copy()) for g in grads]
    returned = clip_by_global_norm(got, max_norm)
    np.testing.assert_allclose(float(returned), norm, rtol=1e-6)
    for g, w, orig in zip(got, want, grads):
        if factor > 1:
            assert np.array_equal(g.numpy(), orig)
        else:
            np.testing.assert_allclose(g.numpy(), np.asarray(w), rtol=2e-6, atol=0)
    clipped = float(np.sqrt(sum(np.sum(g.numpy().astype(np.float64) ** 2) for g in got)))
    assert clipped <= max_norm * (1 + 1e-6)


def test_train_step_clips_before_the_optimizer(monkeypatch):
    """SGD at lr 1 moves each parameter by minus its gradient: with a clip
    of 0.1 (the gradient's norm is about 190 here) the whole move has that
    global norm."""
    model = JointAutoregressiveHierarchical(8, 3, device="cpu", seed=2)
    before = [p.detach().clone() for p in model.parameters()]
    opt = torch.optim.SGD(model.parameters(), lr=1.0)
    step = make_train_step(model, opt, rd_loss, 0.005, clip_grad_norm=0.1)
    monkeypatch.setattr(joint_ar, "noise_quantize", lambda v, generator=None: v)
    step(np.random.default_rng(3).uniform(size=(1, 64, 64, 3)).astype(np.float32))
    moved = torch.sqrt(sum(((p.detach() - b).double() ** 2).sum()
                           for p, b in zip(model.parameters(), before)))
    np.testing.assert_allclose(float(moved), 0.1, rtol=1e-5)


@pytest.mark.parametrize("value", [0.0, -1.0])
def test_clip_must_be_positive(value):
    model = JointAutoregressiveHierarchical(8, 3, device="cpu")
    with pytest.raises(ValueError, match="clip_grad_norm"):
        make_train_step(model, torch.optim.SGD(model.parameters(), lr=1.0), rd_loss, 0.005,
                        clip_grad_norm=value)
