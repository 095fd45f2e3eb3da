"""PyTorch port, the serving export (``serving.export_model``,
``save_exported``, ``load_exported``) and the kernels' export operators
(``nic_torch::gdn``, ``nic_torch::gmm_logp``), modelled on
tests/test_serving.py: the artifact's round trip against the live
``make_serving_fn`` and, on carried weights, against the JAX package's;
the symbolic batch; the graph's kernel nodes; the other families; the
resolution check; bpp against rd_loss (CPU, M=16, 64x128)."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from torch._subclasses.fake_tensor import FakeTensorMode

from neural_image_compression_tpu import serving as jserving
from neural_image_compression_tpu.models import JointAutoregressiveHierarchical as JModel
from neural_image_compression_tpu_torch import serving
from neural_image_compression_tpu_torch.models import (
    ChannelCheckerboardHierarchical, FactorizedPrior, GainedJointAR,
    JointAutoregressiveHierarchical, MeanScaleHyperprior, fold_gains, folded_model,
)
from neural_image_compression_tpu_torch.ops.kernels import gdn_kernel, gmm_kernel
from neural_image_compression_tpu_torch.train import rd_loss
from neural_image_compression_tpu_torch.utils.weights import joint_ar_params_to_jax

torch.set_num_threads(2)

M, K, H, W = 16, 3, 64, 128
GDN_OP, GMM_OP = "nic_torch.gdn.default", "nic_torch.gmm_logp.default"
# what the plain versions would put in the graph in the kernels' place
PLAIN_OPS = ("aten.rsqrt", "aten.sqrt", "aten.erf", "aten.erfc", "aten.special_ndtr",
             "aten.matmul", "aten.mm")


def _x(b, seed, h=H, w=W):
    return np.random.default_rng(seed).uniform(size=(b, h, w, 3)).astype(np.float32)


def _targets(exported):
    return [str(n.target) for n in exported.graph.nodes if n.op == "call_function"]


def _close(got, want, atol=1e-6):
    assert set(got) == set(want) == {"x_hat", "bpp_y", "bpp_z", "bpp_total"}
    for k in want:
        assert got[k].shape == want[k].shape, k
        np.testing.assert_allclose(got[k].detach().numpy(), want[k].numpy(), rtol=1e-6,
                                   atol=atol, err_msg=k)


@pytest.fixture(scope="module")
def flagship(tmp_path_factory):
    """(model, its artifact exported with a symbolic batch, saved and
    loaded)."""
    model = JointAutoregressiveHierarchical(M, K, device="cpu", seed=4)
    with torch.no_grad():  # spread y over several integers
        model.encoder.Conv2d_3.weight.mul_(4.0)
        model.encoder.Conv2d_3.bias.mul_(4.0)
    path = str(tmp_path_factory.mktemp("export") / "flagship.pt2")
    serving.save_exported(serving.export_model(model, H, W), path)
    return model, serving.load_exported(path)


def test_roundtrip_matches_live_forward(flagship):
    model, loaded = flagship
    x = _x(2, 1)
    got = loaded.module()(torch.from_numpy(x))
    want = serving.make_serving_fn(model)(x)
    _close(got, want)
    assert got["bpp_total"].shape == (2,)  # per image, not the batch mean
    assert not got["x_hat"].requires_grad  # the loaded weights are frozen
    np.testing.assert_allclose((got["bpp_y"] + got["bpp_z"]).numpy(), got["bpp_total"].numpy(),
                               rtol=1e-6)


def test_artifact_matches_jax_serving(flagship):
    """The loaded artifact against the JAX package's make_serving_fn on the
    same weights, within test_torch_serving.py's tolerances."""
    model, loaded = flagship
    x = _x(2, 5)
    params = jax.tree.map(jnp.asarray, joint_ar_params_to_jax(model))
    want = jax.jit(jserving.make_serving_fn(JModel(latent_channels=M, K=K), params))(
        jnp.asarray(x))
    got = loaded.module()(torch.from_numpy(x))
    for k in ("bpp_y", "bpp_z", "bpp_total"):
        np.testing.assert_allclose(got[k].numpy(), np.asarray(want[k]), rtol=1e-5, err_msg=k)
    np.testing.assert_allclose(got["x_hat"].numpy(), np.asarray(want["x_hat"]), atol=1e-5)


def test_symbolic_batch_serves_any_b(flagship):
    model, loaded = flagship
    f = loaded.module()
    for b in (1, 3):
        out = f(torch.from_numpy(_x(b, 10 + b)))
        assert out["x_hat"].shape == (b, H, W, 3) and out["bpp_total"].shape == (b,)
    # batch entries are independent
    x = torch.from_numpy(_x(2, 7))
    both, solo = f(x), f(x[:1])
    np.testing.assert_allclose(both["bpp_total"][0].item(), solo["bpp_total"][0].item(),
                               rtol=1e-5)


def test_graph_holds_the_kernel_ops(flagship):
    """6 GDN and 1 mixture operator nodes at K=3, and none of the plain
    versions' operations in their place."""
    _, loaded = flagship
    targets = _targets(loaded)
    assert targets.count(GDN_OP) == 6 and targets.count(GMM_OP) == 1
    assert not [t for t in targets if t.startswith(PLAIN_OPS)]
    gdn_nodes = [n for n in loaded.graph.nodes if str(n.target) == GDN_OP]
    assert [n.args[3] for n in gdn_nodes] == [False] * 3 + [True] * 3  # 3 GDN, then 3 IGDN


def test_fixed_batch(flagship):
    model, _ = flagship
    exported = serving.export_model(model, H, W, batch=1)
    x = torch.from_numpy(_x(1, 3))
    _close(exported.module()(x), serving.make_serving_fn(model)(x))
    with pytest.raises(Exception):
        exported.module()(torch.from_numpy(_x(2, 3)))


@pytest.mark.parametrize("family", ["factorized", "hyperprior", "channel_cb"])
def test_other_families_export(tmp_path, family):
    model = {"factorized": lambda: FactorizedPrior(M, device="cpu", seed=1),
             "hyperprior": lambda: MeanScaleHyperprior(M, 1, device="cpu", seed=1),
             "channel_cb": lambda: ChannelCheckerboardHierarchical(M, K, device="cpu",
                                                                   seed=1)}[family]()
    path = str(tmp_path / "model.pt2")
    serving.save_exported(serving.export_model(model, H, W), path)
    loaded = serving.load_exported(path)
    x = _x(2, 8)
    got = loaded.module()(torch.from_numpy(x))
    _close(got, serving.make_serving_fn(model)(x))
    targets = _targets(loaded)
    assert targets.count(GDN_OP) == 6
    assert targets.count(GMM_OP) == (1 if family == "channel_cb" else 0)
    if family == "factorized":  # a zero-rate z placeholder of the symbolic batch
        assert torch.equal(got["bpp_z"], torch.zeros(2))
    else:
        assert bool((got["bpp_z"] > 0).all())
    assert bool((got["bpp_total"] > 0).all())


def test_folded_gained_model_exports():
    gained = GainedJointAR(M, K, device="cpu", seed=2)
    model = folded_model(gained)
    model.load_state_dict(fold_gains(gained.state_dict(), 1.5))
    x = torch.from_numpy(_x(2, 9))
    _close(serving.export_model(model, H, W).module()(x), serving.make_serving_fn(model)(x))


def test_bad_resolution_raises(flagship):
    model, _ = flagship
    with pytest.raises(ValueError, match="multiples of 64"):
        serving.export_model(model, 100, 64)


def test_bpp_matches_rd_loss(flagship):
    """Per-image bpp from the artifact == the batch-1 rd_loss bpp."""
    model, loaded = flagship
    x = torch.from_numpy(_x(1, 3))
    with torch.no_grad():
        want = rd_loss(model(x, training=False), x, 0.005)
    got = loaded.module()(x)
    np.testing.assert_allclose(got["bpp_total"][0].item(), want["bpp_total"].item(), rtol=1e-5)


def test_export_ops_schema_and_fake():
    """The operators against torch.library's checks, their fake kernels
    against _check's rules, and eager calls that never enter them."""
    rng = np.random.default_rng(0)
    x = torch.from_numpy(rng.normal(size=(40, 12)).astype(np.float32))
    gamma = torch.from_numpy(rng.uniform(0.01, 0.1, size=(12, 12)).astype(np.float32))
    beta = torch.ones(12)
    y = torch.from_numpy(np.round(rng.normal(size=(40, 12))).astype(np.float32))
    w = torch.softmax(torch.from_numpy(rng.normal(size=(40, 3, 12)).astype(np.float32)), 1)
    mu = torch.from_numpy(rng.normal(size=(40, 3, 12)).astype(np.float32))
    sigma = torch.from_numpy(rng.uniform(0.2, 2.0, size=(40, 3, 12)).astype(np.float32))
    tests = ("test_schema", "test_faketensor")
    for inverse in (False, True):
        torch.library.opcheck(gdn_kernel.gdn_op, (x, gamma, beta, inverse), test_utils=tests)
        torch.testing.assert_close(gdn_kernel.gdn_op(x, gamma, beta, inverse),
                                   gdn_kernel.gdn_reference(x, gamma, beta, inverse))
    torch.library.opcheck(gmm_kernel.gmm_logp_op, (y, w, mu, sigma), test_utils=tests)
    torch.testing.assert_close(gmm_kernel.gmm_logp_op(y, w, mu, sigma),
                               gmm_kernel.mixture_log_likelihood_reference(y, w, mu, sigma))
    y64 = y.double()
    with FakeTensorMode() as mode:
        fx, fg, fb = (mode.from_tensor(t) for t in (x, gamma, beta))
        assert gdn_kernel.gdn_op(fx, fg, fb, False).shape == (40, 12)
        with pytest.raises(ValueError, match="gamma must be"):
            gdn_kernel.gdn_op(fx, fg[:4, :4], fb, False)
        with pytest.raises(TypeError, match="float32"):
            gmm_kernel.gmm_logp_op(*(mode.from_tensor(t) for t in (y64, w, mu, sigma)))
        # an eager call with tracer tensors is refused: only export records the operators
        with pytest.raises(TypeError, match="plain tensors"):
            gdn_kernel.gdn(fx, fg, fb)
