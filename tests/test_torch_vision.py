"""PyTorch port, vision-backbone surgery and the YOLOv5 teacher
(``models.vision``, ``models.backbones``): the graph and its halves, the
frozen activation, ``build_yolo_backbone`` at width 4 against the JAX
package on the same variables, ``save_backbone`` / ``load_backbone`` across
the two packages, ``yolo_backbone_variables_from_torch`` on a synthetic
ultralytics-style state dict, and ``distillation_targets`` (CPU, 64x64).

Tolerances: the graph and the backbone within 1e-5 relative and absolute
of the JAX package's (float32 convs summed in other orders through up to
40 layers; 2e-4 / 2e-5 against torch's own layers for the imported
checkpoint, the JAX package's own test's); the halves' composition and
the saved weights' round trips exact.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import torch.nn as tnn

from neural_image_compression_tpu.models import backbones as jbackbones
from neural_image_compression_tpu.models import vision as jvision
from neural_image_compression_tpu.ops import Conv2d as JConv2d
from neural_image_compression_tpu.utils.torch_import import (
    yolo_backbone_variables_from_torch as jyolo_variables_from_torch,
)
from neural_image_compression_tpu_torch.models import (
    C3, SPPF, Concat, ConvBNSiLU, FirstHalf, FrozenActivationBlock, GraphBackbone, SecondHalf,
    ScalableImageCoding, build_yolo_backbone, distillation_targets, frozen_activation_from_conv,
    load_backbone, save_backbone,
)
from neural_image_compression_tpu_torch.ops import Conv2d
from neural_image_compression_tpu_torch.train import vision_rd_loss
from neural_image_compression_tpu_torch.utils import yolo_backbone_variables_from_torch
from neural_image_compression_tpu_torch.utils.weights import (
    joint_ar_params_to_jax, load_jax_variables, variables_to_jax,
)

torch.set_num_threads(1)

TOL = 1e-5
WIDTH = 4


def _x(shape, seed=0):
    return np.random.default_rng(seed).normal(size=shape).astype(np.float32)


def _jax_tree(tree):
    return jax.tree.map(jnp.asarray, tree)


def _nontrivial_bn(backbone, seed=0):
    """Random frozen statistics, so every BatchNorm does work."""
    gen = torch.Generator().manual_seed(seed)
    with torch.no_grad():
        for name, t in list(backbone.named_parameters()) + list(backbone.named_buffers()):
            leaf = name.rsplit(".", 1)[-1]
            if leaf in ("scale", "bias", "mean", "var"):
                r = torch.randn(t.shape, generator=gen)
                t.copy_({"scale": 1.0 + 0.2 * r, "bias": 0.2 * r, "mean": 0.5 * r,
                         "var": 1.0 + 0.5 * torch.rand(t.shape, generator=gen)}[leaf])
    return backbone


@pytest.fixture(scope="module", params=[1, 2], ids=["depth1", "depth2"])
def yolo(request):
    """(depth, the port's width-4 backbone with non-trivial BatchNorms, its
    variables as the JAX package's, the JAX backbone, x, the JAX output and
    every JAX layer's output)."""
    depth = request.param
    bb = _nontrivial_bn(build_yolo_backbone(WIDTH, depth, device="cpu", seed=depth), depth)
    variables = variables_to_jax(bb)
    jbb = jbackbones.build_yolo_backbone(width=WIDTH, depth=depth)
    x = _x((2, 64, 64, 3), depth)
    want, outs = jax.jit(lambda v, x: jbb.apply(v, x, method="run", collect=True))(
        _jax_tree(variables), jnp.asarray(x))
    return depth, bb, variables, jbb, x, np.asarray(want), {k: np.asarray(v)
                                                           for k, v in outs.items()}


# --- the graph --------------------------------------------------------------------

def _small_graph():
    """conv, conv (stride 2), conv, concat([1, 2]) -> 1x1: a skip across layers."""
    gen = torch.Generator().manual_seed(0)
    kw = dict(device="cpu", generator=gen)
    return (GraphBackbone(((Conv2d(3, 8, 3, 1, 1, **kw), -1), (Conv2d(8, 8, 3, 2, 1, **kw), -1),
                           (Conv2d(8, 8, 3, 1, 1, **kw), -1), (Conv2d(16, 4, 1, 1, 0, **kw),
                                                               [1, 2]))),
            jvision.GraphBackbone(layers=((JConv2d(8, 3, 1, 1), -1), (JConv2d(8, 3, 2, 1), -1),
                                          (JConv2d(8, 3, 1, 1), -1),
                                          (JConv2d(4, 1, 1, 0), [1, 2]))))


def test_graph_matches_jax_and_splits():
    bb, jbb = _small_graph()
    x = _x((2, 16, 16, 3))
    params = joint_ar_params_to_jax(bb)
    assert jax.tree.structure(_jax_tree(params)) == jax.tree.structure(
        jax.eval_shape(jbb.init, jax.random.PRNGKey(0), jnp.asarray(x))["params"])
    want = np.asarray(jbb.apply({"params": _jax_tree(params)}, jnp.asarray(x)))
    with torch.no_grad():
        full = bb(torch.from_numpy(x))
        assert full.shape == (2, 8, 8, 4)
        np.testing.assert_allclose(full.numpy(), want, rtol=TOL, atol=TOL)
        for cut in (0, 1, 2):
            mid, outs = FirstHalf(bb, cut)(torch.from_numpy(x), collect=True)
            assert sorted(outs) == list(range(cut + 1))
            assert torch.equal(SecondHalf(bb, cut)(mid, prev_outputs=outs), full)


def test_running_x_in_a_concat_list():
    """-1 inside an f list is the running x (the ultralytics yaml's
    Concat f=[-1, 6])."""
    gen = torch.Generator().manual_seed(1)
    a, b = Conv2d(3, 4, 1, device="cpu", generator=gen), Conv2d(4, 4, 1, device="cpu",
                                                                generator=gen)
    bb = GraphBackbone(((a, -1), (b, -1), (Concat(), [-1, 0])))
    x = torch.from_numpy(_x((1, 4, 4, 3), 1))
    with torch.no_grad():
        h0 = a(x.permute(0, 3, 1, 2))
        want = torch.cat([b(h0), h0], dim=1).permute(0, 2, 3, 1)
        assert torch.equal(bb(x), want)


def test_frozen_activation_block():
    c = 6
    rng = np.random.RandomState(0)
    stats = dict(scale=rng.rand(c) + 0.5, bias=rng.randn(c), mean=rng.randn(c),
                 var=rng.rand(c) + 0.1)
    blk = FrozenActivationBlock.from_stats(**stats, device="cpu")
    x = rng.randn(1, 4, 4, c).astype(np.float32)
    norm = (x - stats["mean"]) / np.sqrt(stats["var"] + 1e-5) * stats["scale"] + stats["bias"]
    np.testing.assert_allclose(blk(torch.from_numpy(x)).numpy(), norm / (1 + np.exp(-norm)),
                               rtol=1e-4, atol=1e-5)
    want = jvision.FrozenActivationBlock.from_stats(**stats)(jnp.asarray(x))
    np.testing.assert_allclose(blk(torch.from_numpy(x)).numpy(), np.asarray(want), rtol=TOL,
                               atol=TOL)
    assert list(blk.parameters()) == [] and len(list(blk.buffers())) == 4


# --- the YOLOv5 backbone -----------------------------------------------------------

def test_backbone_matches_jax(yolo):
    depth, bb, _, _, x, want, outs = yolo
    with torch.no_grad():
        got, got_outs = bb.run(torch.from_numpy(x), collect=True)
    assert got.shape == want.shape == (2, 8, 8, 4 * WIDTH)  # P3: /8, 4w channels
    np.testing.assert_allclose(got.numpy(), want, rtol=TOL, atol=TOL)
    assert sorted(got_outs) == sorted(outs) == list(range(18))
    for i in (0, 3, 9, 12, 16):  # stem, the cut, SPPF, the two neck concats
        np.testing.assert_allclose(got_outs[i].numpy(), outs[i], rtol=TOL, atol=TOL, err_msg=i)
    assert bb.layers_4_0.n == 2 * depth and bb.layers_6_0.n == 3 * depth


def test_split_across_the_neck_concats(yolo):
    """Cuts in [4, 15] make SecondHalf read layers 4 and 6 through
    prev_outputs."""
    _, bb, _, _, x, _, _ = yolo
    with torch.no_grad():
        full = bb(torch.from_numpy(x))
        for cut in (3, 5, 7, 9, 13):
            mid, outs = FirstHalf(bb, cut)(torch.from_numpy(x), collect=True)
            assert torch.equal(SecondHalf(bb, cut)(mid, prev_outputs=outs), full), cut


def test_backbone_modules_match_jax_names():
    bb = build_yolo_backbone(WIDTH, device="cpu")
    kinds = [type(getattr(bb, f"layers_{i}_0")).__name__ for i in range(len(bb.froms))]
    assert kinds == ["ConvBNSiLU", "ConvBNSiLU", "C3", "ConvBNSiLU", "C3", "ConvBNSiLU", "C3",
                     "ConvBNSiLU", "C3", "SPPF", "ConvBNSiLU", "Upsample2x", "Concat", "C3",
                     "ConvBNSiLU", "Upsample2x", "Concat", "C3"]
    assert bb.froms[12] == (11, 6) and bb.froms[16] == (15, 4)
    assert bb.layers_0_0.Conv2d_0.bias is None  # the convs before a BatchNorm have none
    assert isinstance(bb.layers_2_0, C3) and isinstance(bb.layers_9_0, SPPF)
    assert not bb.layers_13_0.Bottleneck_0.add and bb.layers_2_0.Bottleneck_0.add
    assert (bb.width, bb.depth) == (WIDTH, 1)


def test_frozen_activation_from_conv(yolo):
    _, bb, variables, _, _, _, _ = yolo
    got = frozen_activation_from_conv(bb, 3)
    want = jbackbones.frozen_activation_from_conv(variables, 3)
    f = _x((1, 8, 8, 4 * WIDTH), 3)
    np.testing.assert_allclose(got(torch.from_numpy(f)).numpy(), np.asarray(want(jnp.asarray(f))),
                               rtol=TOL, atol=TOL)
    for bad in (9, 11):  # SPPF (its BatchNorms sit in sub-blocks), Upsample2x
        with pytest.raises(ValueError, match="no ConvBNSiLU"):
            frozen_activation_from_conv(bb, bad)


def test_distillation_targets_are_frozen_and_pass_gradients(yolo):
    _, bb, variables, jbb, x, _, outs = yolo
    act, V = distillation_targets(bb, 3)
    assert not any(p.requires_grad for p in bb.parameters()) and not V.training
    xt = torch.from_numpy(x).requires_grad_(True)
    f = V(xt)
    np.testing.assert_allclose(f.detach().numpy(), outs[3], rtol=TOL, atol=TOL)
    (f ** 2).sum().backward()
    assert xt.grad is not None and float(xt.grad.abs().max()) > 0
    assert all(p.grad is None for p in bb.parameters())
    jact, _ = jbackbones.distillation_targets(jbb, _jax_tree(variables), 3)
    np.testing.assert_allclose(act(f).detach().numpy(), np.asarray(jact(jnp.asarray(outs[3]))),
                               rtol=1e-4, atol=1e-5)


# --- files and imported checkpoints ------------------------------------------------

def test_save_and_load_across_the_packages(yolo, tmp_path):
    """A file the port writes loads in the JAX package and gives its
    forward; a file the JAX package writes loads in the port with the same
    weights; both keep the depth."""
    depth, bb, variables, _, x, want, _ = yolo
    ours = str(tmp_path / "ours.npz")
    save_backbone(ours, WIDTH, bb, depth=depth)
    jbb, jvars = jbackbones.load_backbone(ours)
    assert jax.tree.structure(_jax_tree(jvars)) == jax.tree.structure(_jax_tree(variables))
    np.testing.assert_allclose(np.asarray(jax.jit(jbb.apply)(_jax_tree(jvars), jnp.asarray(x))),
                               want, rtol=TOL, atol=TOL)
    theirs = str(tmp_path / "theirs.npz")
    jbackbones.save_backbone(theirs, WIDTH, _jax_tree(variables), depth=depth)
    loaded = load_backbone(theirs, device="cpu")
    assert (loaded.width, loaded.depth) == (WIDTH, depth)
    for (name, a), (_, b) in zip(loaded.state_dict().items(), bb.state_dict().items()):
        assert torch.equal(a, b), name
    assert set(np.load(ours).files) == set(np.load(theirs).files)


class TConv(tnn.Module):
    def __init__(self, c1, c2, k=1, s=1):
        super().__init__()
        self.conv = tnn.Conv2d(c1, c2, k, s, (k - 1) // 2, bias=False)
        self.bn = tnn.BatchNorm2d(c2)

    def forward(self, x):
        return tnn.functional.silu(self.bn(self.conv(x)))


class TBottleneck(tnn.Module):
    def __init__(self, c, shortcut=True):
        super().__init__()
        self.cv1, self.cv2, self.add = TConv(c, c, 1), TConv(c, c, 3), shortcut

    def forward(self, x):
        y = self.cv2(self.cv1(x))
        return x + y if self.add else y


class TC3(tnn.Module):
    def __init__(self, c1, c2, n=1, shortcut=True):
        super().__init__()
        h = c2 // 2
        self.cv1, self.cv2, self.cv3 = TConv(c1, h, 1), TConv(c1, h, 1), TConv(c2, c2, 1)
        self.m = tnn.Sequential(*[TBottleneck(h, shortcut) for _ in range(n)])

    def forward(self, x):
        return self.cv3(torch.cat([self.m(self.cv1(x)), self.cv2(x)], 1))


class TSPPF(tnn.Module):
    def __init__(self, c):
        super().__init__()
        self.cv1, self.cv2, self.pool = TConv(c, c // 2, 1), TConv(2 * c, c, 1), tnn.MaxPool2d(5, 1, 2)

    def forward(self, x):
        x = self.cv1(x)
        p1 = self.pool(x)
        p2 = self.pool(p1)
        return self.cv2(torch.cat([x, p1, p2, self.pool(p2)], 1))


class TBackbone(tnn.Module):
    """The yolov5n layout (yaml indices 0-17 through the P3 C3) in plain
    torch with ultralytics' module names; Concat layers are identities so
    the state_dict indices match."""

    def __init__(self, w):
        super().__init__()
        self.model = tnn.ModuleList([
            TConv(3, w, 6, 2), TConv(w, 2 * w, 3, 2), TC3(2 * w, 2 * w, 1),
            TConv(2 * w, 4 * w, 3, 2), TC3(4 * w, 4 * w, 2), TConv(4 * w, 8 * w, 3, 2),
            TC3(8 * w, 8 * w, 3), TConv(8 * w, 16 * w, 3, 2), TC3(16 * w, 16 * w, 1),
            TSPPF(16 * w), TConv(16 * w, 8 * w, 1), tnn.Upsample(scale_factor=2),
            tnn.Identity(), TC3(16 * w, 8 * w, 1, shortcut=False), TConv(8 * w, 4 * w, 1),
            tnn.Upsample(scale_factor=2), tnn.Identity(), TC3(8 * w, 4 * w, 1, shortcut=False)])

    def forward(self, x):
        outs, cat_from = [], {12: 6, 16: 4}
        for i, m in enumerate(self.model):
            if i in cat_from:
                x = torch.cat([x, outs[cat_from[i]]], 1)
            x = m(x)
            outs.append(x)
        return x


def test_yolo_import_of_a_torch_state_dict():
    """An ultralytics-style state dict (model.{i}.conv/bn, cv1/cv2/cv3,
    m.{j}) through the port's importer: the JAX importer's tree, and the
    torch network's eval forward."""
    torch.manual_seed(0)
    tb = TBackbone(WIDTH).eval()
    with torch.no_grad():
        for m in tb.modules():
            if isinstance(m, tnn.BatchNorm2d):
                m.running_mean.normal_(0.0, 0.5)
                m.running_var.uniform_(0.5, 1.5)
                m.weight.normal_(1.0, 0.2)
                m.bias.normal_(0.0, 0.2)
    x = torch.randn(1, 3, 64, 64)
    with torch.no_grad():
        ref = tb(x).numpy()
    sd = {k: v.numpy() for k, v in tb.state_dict().items()}
    variables = yolo_backbone_variables_from_torch(sd)
    got = jax.tree_util.tree_flatten_with_path(variables)[0]
    want = jax.tree_util.tree_flatten_with_path(jyolo_variables_from_torch(sd))[0]
    assert [p for p, _ in got] == [p for p, _ in want]
    for (p, a), (_, b) in zip(got, want):
        np.testing.assert_array_equal(a, b, err_msg=str(p))
    bb = load_jax_variables(build_yolo_backbone(WIDTH, device="cpu"), variables)
    with torch.no_grad():
        out = bb(x.permute(0, 2, 3, 1).contiguous()).permute(0, 3, 1, 2).numpy()
    np.testing.assert_allclose(out, ref, rtol=2e-4, atol=2e-5)
    back = variables_to_jax(bb)
    assert jax.tree.structure(back) == jax.tree.structure(variables)


def test_distillation_end_to_end():
    """ScalableImageCoding distilling against the width-4 backbone cut at 3
    (P3 channels 16 == 2 M1 at M1 = 8): a few Adam steps lower the loss and
    the vision term is live."""
    act, V = distillation_targets(build_yolo_backbone(WIDTH, device="cpu", seed=3), 3)
    model = ScalableImageCoding(16, 8, 1, device="cpu", seed=3)
    opt = torch.optim.Adam(model.parameters(), lr=1e-3)
    x = torch.from_numpy(np.random.default_rng(3).uniform(size=(2, 64, 64, 3)).astype(np.float32))
    gen = torch.Generator().manual_seed(0)
    losses, vmses = [], []
    for _ in range(8):
        m = vision_rd_loss(model(x, training=True, generator=gen), x, 0.01, gamma=1.0,
                           frozen_activation=act, V=V)
        m["loss"].backward()
        opt.step()
        opt.zero_grad()
        losses.append(float(m["loss"].detach()))
        vmses.append(float(m["vision_mse"].detach()))
    assert np.isfinite(losses).all() and losses[-1] < losses[0]
    assert vmses[0] > 0.0


def test_modules_take_channels_last_nchw():
    gen = torch.Generator().manual_seed(2)
    kw = dict(device="cpu", generator=gen)
    x = torch.from_numpy(_x((1, 8, 8, 6), 2)).permute(0, 3, 1, 2)
    for mod, c in ((ConvBNSiLU(6, 4, 3, 2, **kw), 4), (C3(6, 8, 2, **kw), 8),
                   (SPPF(6, 6, **kw), 6)):
        with torch.no_grad():
            assert mod(x).shape[1] == c
