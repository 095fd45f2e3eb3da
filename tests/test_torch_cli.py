"""PyTorch port, the CLI (``neural_image_compression_tpu_torch.cli``): the
JAX package's CLI tests (tests/test_cli.py) run through the port's ``main``
with ``--device cpu``, at the same tiny widths, plus a portable stream
written by the port's CLI and decoded by the JAX codec with the same card
and the same weights, the variable-rate fold and the device rule."""

import glob
import json
import os

import jax
import numpy as np
import pytest
import torch
from PIL import Image

from neural_image_compression_tpu.coding import codec as jcodec
from neural_image_compression_tpu.coding import portable as jportable
from neural_image_compression_tpu.models import JointAutoregressiveHierarchical as JModel
from neural_image_compression_tpu_torch import build_model, serving
from neural_image_compression_tpu_torch.cli import _restore_params
from neural_image_compression_tpu_torch.cli import main as cli_main
from neural_image_compression_tpu_torch.coding import JointARCodec, PortableCard
from neural_image_compression_tpu_torch.config import Config
from neural_image_compression_tpu_torch.models import build_yolo_backbone, save_backbone
from neural_image_compression_tpu_torch.utils.checkpoint import restore_raw, save_checkpoint
from neural_image_compression_tpu_torch.utils.weights import joint_ar_params_to_jax

torch.set_num_threads(2)

CPU = ["--device", "cpu"]


def _write_images(d, n=3, size=300):
    os.makedirs(d, exist_ok=True)
    rng = np.random.RandomState(0)
    for i in range(n):
        Image.fromarray((rng.rand(size, size, 3) * 255).astype(np.uint8)
                        ).save(os.path.join(d, f"im{i}.png"))


def _image(path, h, w, seed):
    rng = np.random.RandomState(seed)
    Image.fromarray((rng.rand(h, w, 3) * 255).astype(np.uint8)).save(path)
    return path


def _config(tmp_path, name, latent_channels=8, K=3, **sections):
    """A config file: the model's name and widths, no checkpoint unless a
    section names one, and the given fields of the other sections."""
    cfg = Config()
    cfg.model.name = name
    cfg.model.latent_channels = latent_channels
    cfg.model.K = K
    cfg.train.checkpoint_path = str(tmp_path / "nockpt")
    for section, fields in sections.items():
        for k, v in fields.items():
            setattr(getattr(cfg, section), k, v)
    path = str(tmp_path / "cfg.json")
    with open(path, "w") as f:
        f.write(cfg.to_json())
    return cfg, path


def _png(path):
    return np.asarray(Image.open(path))


def test_cli_preprocess(tmp_path):
    src, dst = str(tmp_path / "src"), str(tmp_path / "dst")
    _write_images(src)
    cli_main(["preprocess", "--input_dir", src, "--output_dir", dst,
              "--target_size", "128", "--seed", "0"])
    assert len(os.listdir(dst)) == 3


def test_cli_train_and_eval(tmp_path):
    train_dir = str(tmp_path / "train")
    _write_images(train_dir, n=2, size=192)
    cfg, cfg_path = _config(
        tmp_path, "factorized",
        data=dict(train_dir=train_dir, batch_size=1),
        train=dict(max_steps=2, log_dir=str(tmp_path / "runs"),
                   checkpoint_path=str(tmp_path / "ckpt.pt")),
        eval=dict(data_dir=train_dir, save_dir=str(tmp_path / "eval"), caption="cli"))
    cli_main(["train", "--config", cfg_path, *CPU])
    assert os.path.isfile(cfg.train.checkpoint_path)
    assert set(restore_raw(cfg.train.checkpoint_path)) >= {"model", "optimizer", "rng"}
    # eval at 192 px (MS-SSIM needs 161 a side)
    cli_main(["eval", "--config", cfg_path, *CPU])
    assert any(o.startswith("eval_results_") for o in os.listdir(cfg.eval.save_dir))


def test_cli_train_data_parallel(tmp_path, capsys):
    """train.data_parallel builds the mesh through parallel.make_mesh: a
    one-process group here (torchrun's where its environment is set), torn
    down after the run."""
    from torch import distributed as dist

    train_dir = str(tmp_path / "train")
    _write_images(train_dir, n=2, size=64)
    cfg, cfg_path = _config(tmp_path, "factorized",
                            data=dict(train_dir=train_dir, batch_size=2),
                            train=dict(max_steps=2, data_parallel=True,
                                       log_dir=str(tmp_path / "runs"),
                                       checkpoint_path=str(tmp_path / "ckpt.pt")))
    assert not dist.is_initialized()
    try:
        cli_main(["train", "--config", cfg_path, *CPU])
        assert dist.is_initialized() and dist.get_world_size() == 1
        assert dist.get_backend() == "gloo"
    finally:
        if dist.is_initialized():
            dist.destroy_process_group()
    assert os.path.isfile(cfg.train.checkpoint_path)
    assert "Checkpoint saved at step 2" in capsys.readouterr().out


def test_cli_compress_decompress(tmp_path):
    img_path = _image(str(tmp_path / "in.png"), 100, 140, 1)
    _, cfg_path = _config(tmp_path, "factorized")
    bit_path, rec_path = str(tmp_path / "out.nic"), str(tmp_path / "rec.png")
    cli_main(["compress", "--config", cfg_path, "--image", img_path, "--out", bit_path, *CPU])
    assert os.path.getsize(bit_path) > 0
    cli_main(["decompress", "--config", cfg_path, "--bitstream", bit_path, "--out", rec_path,
              *CPU])
    assert _png(rec_path).shape == (100, 140, 3)  # cropped back from the padded size


def test_cli_compress_decompress_multi(tmp_path):
    """Several same-size images go through the batched codec path and land
    in output directories; each stream equals the codec's single call."""
    img_paths = [_image(str(tmp_path / f"in{i}.png"), 70, 90, 4 + i) for i in range(2)]
    cfg, cfg_path = _config(tmp_path, "joint_ar")
    bits_dir, rec_dir = str(tmp_path / "bits"), str(tmp_path / "recs")
    cli_main(["compress", "--config", cfg_path, "--image", *img_paths, "--out", bits_dir, *CPU])
    bit_paths = [os.path.join(bits_dir, f"in{i}.nic") for i in range(2)]
    codec = JointARCodec(build_model(cfg.model, device="cpu", seed=cfg.train.seed))
    for img, bits in zip(img_paths, bit_paths):
        with open(bits, "rb") as f:
            meta = json.loads(f.read(int.from_bytes(f.read(2), "little")))
            assert meta == {"orig_h": 70, "orig_w": 90}
            assert f.read() == codec.compress(_png(img)[None])
    cli_main(["decompress", "--config", cfg_path, "--bitstream", *bit_paths, "--out", rec_dir,
              *CPU])
    for i in range(2):
        assert _png(os.path.join(rec_dir, f"in{i}.png")).shape == (70, 90, 3)


def test_cli_compress_decompress_scalable(tmp_path):
    img_path = _image(str(tmp_path / "in.png"), 80, 90, 2)
    _, cfg_path = _config(tmp_path, "scalable", 12, 1, model=dict(base_channels=8))
    bit_path, rec_path = str(tmp_path / "out.nic"), str(tmp_path / "rec.png")
    cli_main(["compress", "--config", cfg_path, "--image", img_path, "--out", bit_path, *CPU])
    cli_main(["decompress", "--config", cfg_path, "--bitstream", bit_path, "--out", rec_path,
              *CPU])
    assert _png(rec_path).shape == (80, 90, 3)


def test_cli_eval_with_codec(tmp_path):
    data_dir = str(tmp_path / "imgs")
    _write_images(data_dir, n=1, size=192)
    cfg, cfg_path = _config(tmp_path, "factorized",
                            eval=dict(data_dir=data_dir, save_dir=str(tmp_path / "eval"),
                                      caption="codec"))
    cli_main(["eval", "--config", cfg_path, "--codec", *CPU])
    with open(os.path.join(cfg.eval.save_dir, "eval_results_0.005_lambda_codec.txt")) as f:
        assert "codec/BPP(bitstream)" in f.read()


def test_cli_compress_streams(tmp_path):
    """--streams N routes through the interleaved coder; decompress needs no
    extra flag (N is in the bitstream header)."""
    img_path = _image(str(tmp_path / "in.png"), 70, 70, 7)
    cfg, cfg_path = _config(tmp_path, "joint_ar", K=1)
    bit_path, rec_path = str(tmp_path / "out.nic"), str(tmp_path / "rec.png")
    cli_main(["compress", "--config", cfg_path, "--image", img_path, "--out", bit_path,
              "--streams", "4", *CPU])
    codec = JointARCodec(build_model(cfg.model, device="cpu", seed=cfg.train.seed))
    with open(bit_path, "rb") as f:
        f.read(int.from_bytes(f.read(2), "little"))
        assert f.read() == codec.compress(_png(img_path)[None], n_streams=4)
    cli_main(["decompress", "--config", cfg_path, "--bitstream", bit_path, "--out", rec_path,
              *CPU])
    assert _png(rec_path).shape == (70, 70, 3)


def test_cli_portable_card_roundtrip(tmp_path):
    """--card builds and saves the portable card on the first compress,
    then decompress loads it; the reconstruction matches the float path's."""
    img_path = _image(str(tmp_path / "in.png"), 80, 120, 2)
    _, cfg_path = _config(tmp_path, "joint_ar", K=1)
    card_path = str(tmp_path / "model.card.npz")
    bit_path, rec_path = str(tmp_path / "out.nic"), str(tmp_path / "rec.png")
    plain_path, rec2_path = str(tmp_path / "plain.nic"), str(tmp_path / "rec2.png")
    cli_main(["compress", "--config", cfg_path, "--image", img_path, "--out", bit_path,
              "--card", card_path, *CPU])
    assert os.path.exists(card_path)
    cli_main(["decompress", "--config", cfg_path, "--bitstream", bit_path, "--out", rec_path,
              "--card", card_path, *CPU])
    cli_main(["compress", "--config", cfg_path, "--image", img_path, "--out", plain_path,
              "--streams", "1", *CPU])
    cli_main(["decompress", "--config", cfg_path, "--bitstream", plain_path, "--out", rec2_path,
              *CPU])
    np.testing.assert_array_equal(_png(rec_path), _png(rec2_path))


@pytest.mark.parametrize("name", ["factorized", "scalable", "channel_cb"])
def test_cli_portable_card_roundtrip_other_families(tmp_path, name):
    """--card for every codec family: factorized saves a FactorizedCard,
    scalable an l1_/l2_ card pair, channel_cb a ChannelCBCards set; decode
    reconstructs as the float path does."""
    img_path = _image(str(tmp_path / "in.png"), 80, 96, 3)
    extra = {"model": dict(base_channels=4)} if name == "scalable" else {}
    _, cfg_path = _config(tmp_path, name, K=1, **extra)
    card_path = str(tmp_path / "model.card.npz")
    bit_path, rec_path = str(tmp_path / "out.nic"), str(tmp_path / "rec.png")
    cli_main(["compress", "--config", cfg_path, "--image", img_path, "--out", bit_path,
              "--card", card_path, *CPU])
    assert os.path.exists(card_path)
    cli_main(["decompress", "--config", cfg_path, "--bitstream", bit_path, "--out", rec_path,
              "--card", card_path, *CPU])
    plain_path, rec2_path = str(tmp_path / "plain.nic"), str(tmp_path / "rec2.png")
    cli_main(["compress", "--config", cfg_path, "--image", img_path, "--out", plain_path, *CPU])
    cli_main(["decompress", "--config", cfg_path, "--bitstream", plain_path, "--out", rec2_path,
              *CPU])
    np.testing.assert_array_equal(_png(rec_path), _png(rec2_path))


@pytest.mark.parametrize("portable", [False, True], ids=["float", "portable"])
def test_cli_compress_refine(tmp_path, capsys, portable):
    """--refine optimizes the latents before coding, also into a portable
    stream; the streams decode through the unchanged decompress path."""
    img_path = _image(str(tmp_path / "in.png"), 70, 90, 5 + portable)
    _, cfg_path = _config(tmp_path, "hyperprior", K=1)
    card = ["--card", str(tmp_path / "model.card.npz")] if portable else []
    bit_path, rec_path = str(tmp_path / "out.nic"), str(tmp_path / "rec.png")
    cli_main(["compress", "--config", cfg_path, "--image", img_path, "--out", bit_path,
              "--refine", "6", "--refine_lr", "0.02", *card, *CPU])
    assert "refined 6 steps, RD loss" in capsys.readouterr().out
    cli_main(["decompress", "--config", cfg_path, "--bitstream", bit_path, "--out", rec_path,
              *card, *CPU])
    assert _png(rec_path).shape == (70, 90, 3)


def test_cli_train_scalable_with_backbone(tmp_path):
    """Scalable training with the distillation term live (gamma > 0 and a
    saved backbone), then eval reporting the vision MSE with gamma 0."""
    train_dir = str(tmp_path / "train")
    _write_images(train_dir, n=2, size=192)
    bb_path = str(tmp_path / "bb.npz")
    save_backbone(bb_path, 4, build_yolo_backbone(width=4, device="cpu"))  # P3: 16 = 2 * M1
    cfg, cfg_path = _config(tmp_path, "scalable", 16, 1, model=dict(base_channels=8),
                            data=dict(train_dir=train_dir, batch_size=1),
                            train=dict(max_steps=2, gamma=1.0, log_dir=str(tmp_path / "runs"),
                                       checkpoint_path=str(tmp_path / "ckpt.pt")))
    cli_main(["train", "--config", cfg_path, "--backbone", bb_path, *CPU])
    assert os.path.isfile(cfg.train.checkpoint_path)
    logs = glob.glob(os.path.join(cfg.train.log_dir, "**", "*.jsonl"), recursive=True)
    assert logs
    with open(logs[0]) as f:
        rows = [json.loads(line) for line in f]
    assert any(r["tag"] == "losses/vision_mse" and r["value"] > 0 for r in rows)

    cfg.train.gamma = 0.0
    cfg.eval.data_dir = train_dir
    cfg.eval.save_dir = str(tmp_path / "eval")
    with open(cfg_path, "w") as f:
        f.write(cfg.to_json())
    cli_main(["eval", "--config", cfg_path, "--backbone", bb_path, *CPU])
    txts = [o for o in os.listdir(cfg.eval.save_dir) if o.startswith("eval_results_")]
    with open(os.path.join(cfg.eval.save_dir, txts[0])) as f:
        assert "VisionMSE" in f.read()


def test_cli_bdrate(tmp_path, capsys):
    anchor = [{"lambda": 0.001, "bpp": 0.1, "psnr": 28.0, "msssim": 0.90},
              {"lambda": 0.005, "bpp": 0.3, "psnr": 32.0, "msssim": 0.94},
              {"lambda": 0.02, "bpp": 0.7, "psnr": 36.0, "msssim": 0.97}]
    test = [dict(p, bpp=p["bpp"] * 0.9) for p in anchor]
    a_path, t_path = str(tmp_path / "a.json"), str(tmp_path / "t.json")
    for path, pts in ((a_path, anchor), (t_path, test)):
        with open(path, "w") as f:
            json.dump(pts, f)
    cli_main(["bdrate", a_path, t_path])
    out = json.loads(capsys.readouterr().out.strip())
    assert out["bd_rate_pct"] == pytest.approx(-10.0, rel=1e-6)
    assert out["bd_psnr"] > 0
    cli_main(["bdrate", a_path, t_path, "--metric", "msssim"])
    out = json.loads(capsys.readouterr().out.strip())
    assert out["bd_rate_pct"] == pytest.approx(-10.0, rel=1e-6)
    assert "bd_msssim" in out


def test_cli_bdrate_no_overlap_exits(tmp_path):
    a = [{"bpp": 0.1, "psnr": 28.0}, {"bpp": 0.3, "psnr": 32.0}]
    b = [{"bpp": 0.1, "psnr": 48.0}, {"bpp": 0.3, "psnr": 52.0}]
    a_path, b_path = str(tmp_path / "a.json"), str(tmp_path / "b.json")
    for path, pts in ((a_path, a), (b_path, b)):
        with open(path, "w") as f:
            json.dump(pts, f)
    with pytest.raises(SystemExit, match="overlap"):
        cli_main(["bdrate", a_path, b_path])


def test_cli_anchor_curve(tmp_path, capsys):
    data_dir = str(tmp_path / "imgs")
    _write_images(data_dir, n=1, size=64)
    out = str(tmp_path / "anchor.json")
    cli_main(["anchor-curve", "--data_dir", data_dir, "--qualities", "30,70", "--out", out])
    with open(out) as f:
        curve = json.load(f)
    assert [p["quality"] for p in curve] == [30, 70] and curve[0]["bpp"] < curve[1]["bpp"]
    assert "jpeg q= 30" in capsys.readouterr().out


def test_cli_export(tmp_path, capsys):
    cfg, cfg_path = _config(tmp_path, "factorized")
    out_path = str(tmp_path / "model.pt2")
    cli_main(["export", "--config", cfg_path, "--out", out_path, "--height", "64",
              "--width", "64", "--batch", "1", *CPU])
    assert "exported factorized" in capsys.readouterr().out
    loaded = serving.load_exported(out_path)
    x = np.random.default_rng(0).uniform(size=(1, 64, 64, 3)).astype(np.float32)
    got = loaded.module()(torch.from_numpy(x))
    want = serving.make_serving_fn(build_model(cfg.model, device="cpu", seed=cfg.train.seed))(x)
    assert got["x_hat"].shape == (1, 64, 64, 3)
    for k in want:
        np.testing.assert_allclose(got[k].numpy(), want[k].numpy(), rtol=1e-6, atol=1e-6)


def test_cli_export_bad_size_exits(tmp_path):
    with pytest.raises(SystemExit, match="multiples of 64"):
        cli_main(["export", "--out", str(tmp_path / "x.pt2"), "--height", "100",
                  "--width", "64", *CPU])


def test_cli_train_ema_and_restore_prefers_ema(tmp_path, capsys):
    """A run with ema_decay > 0 checkpoints ema_params, and the CLI's
    restore (eval, compress, export) loads those rather than the raw
    weights."""
    train_dir = str(tmp_path / "train")
    _write_images(train_dir, n=2, size=192)
    cfg, cfg_path = _config(tmp_path, "factorized",
                            data=dict(train_dir=train_dir, batch_size=1),
                            train=dict(max_steps=2, ema_decay=0.9,
                                       log_dir=str(tmp_path / "runs"),
                                       checkpoint_path=str(tmp_path / "ckpt.pt")))
    cli_main(["train", "--config", cfg_path, *CPU])
    model = build_model(cfg.model, device="cpu")
    state = _restore_params(model, cfg)
    assert "restored EMA params" in capsys.readouterr().out
    raw = restore_raw(cfg.train.checkpoint_path)
    assert set(raw["ema_params"]) == {n for n, _ in model.named_parameters()}
    for name, value in model.state_dict().items():
        want = raw["ema_params"].get(name, raw["model"][name])
        assert torch.equal(value, want) and torch.equal(state[name], want), name
    assert not all(torch.equal(raw["model"][n], raw["ema_params"][n]) for n in raw["ema_params"])


def test_cli_gained_level_roundtrip(tmp_path, capsys):
    """A variable-rate config folds at --level (or the level --target_bpp
    picks), records it in each stream, and decompress folds there again."""
    img_path = _image(str(tmp_path / "in.png"), 64, 64, 8)
    _, cfg_path = _config(tmp_path, "gained", K=1)
    bit_path, rec_path = str(tmp_path / "out.nic"), str(tmp_path / "rec.png")
    cli_main(["compress", "--config", cfg_path, "--image", img_path, "--out", bit_path,
              "--level", "1.5", *CPU])
    with open(bit_path, "rb") as f:
        assert json.loads(f.read(int.from_bytes(f.read(2), "little")))["level"] == 1.5
    cli_main(["decompress", "--config", cfg_path, "--bitstream", bit_path, "--out", rec_path,
              *CPU])
    assert "folded at level 1.5" in capsys.readouterr().out
    assert _png(rec_path).shape == (64, 64, 3)
    with pytest.raises(SystemExit, match="contradicts"):
        cli_main(["decompress", "--config", cfg_path, "--bitstream", bit_path, "--out",
                  rec_path, "--level", "2", *CPU])
    cli_main(["compress", "--config", cfg_path, "--image", img_path, "--out", bit_path,
              "--target_bpp", "0.5", *CPU])
    assert "target 0.5000 bpp -> level" in capsys.readouterr().out


def test_cli_device_cuda_without_a_card_exits(tmp_path, monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    _, cfg_path = _config(tmp_path, "factorized")
    with pytest.raises(SystemExit, match="pass --device cpu"):
        cli_main(["export", "--config", cfg_path, "--out", str(tmp_path / "x.pt2"),
                  "--height", "64", "--width", "64"])


def test_port_portable_stream_decodes_with_the_jax_codec(tmp_path):
    """A portable stream written by the port's CLI (its card built and saved
    by that call, its weights a port checkpoint) decodes with the JAX
    package's JointARCodec given the same card and the same weights: the
    latents bit for bit, the reconstruction within float32 rounding."""
    M, K = 16, 3
    cfg, cfg_path = _config(tmp_path, "joint_ar", M, K,
                            train=dict(checkpoint_path=str(tmp_path / "ckpt.pt")))
    model = build_model(cfg.model, device="cpu", seed=3)
    with torch.no_grad():  # spread y and z over several integers
        for conv, gain in ((model.encoder.Conv2d_3, 12.0), (model.hyper_encoder.Conv2d_2, 30.0)):
            conv.weight.mul_(gain)
            conv.bias.mul_(gain)
    save_checkpoint(cfg.train.checkpoint_path, {"model": model.state_dict()})
    img_path = _image(str(tmp_path / "in.png"), 64, 128, 9)
    card_path, bit_path = str(tmp_path / "card.npz"), str(tmp_path / "out.nic")
    cli_main(["compress", "--config", cfg_path, "--image", img_path, "--out", bit_path,
              "--card", card_path, *CPU])
    with open(bit_path, "rb") as f:
        f.read(int.from_bytes(f.read(2), "little"))
        data = f.read()

    port = JointARCodec(model, portable_card=PortableCard.load(card_path))
    jmodel = JModel(latent_channels=M, K=K)
    params = jax.tree.map(np.asarray, joint_ar_params_to_jax(model))
    jax_codec = jcodec.JointARCodec(jmodel, {"params": params},
                                    portable_card=jportable.PortableCard.load(card_path))
    y, z = port.decode_latents(data)
    assert np.abs(y).max() >= 2 and np.abs(z).max() >= 2
    jy, jz = jax_codec.decode_latents(data)
    np.testing.assert_array_equal(np.asarray(jy), y)
    np.testing.assert_array_equal(np.asarray(jz), z)
    np.testing.assert_allclose(np.asarray(jax_codec.decompress(data)), port.decompress(data),
                               atol=1e-5)
