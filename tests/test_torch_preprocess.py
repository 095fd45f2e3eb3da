"""PyTorch port, ``data/preprocess.py`` and ``data/coco.py``: patches byte
for byte against the JAX package's for one seeded input directory, the same
patches for any worker count, the PIL helpers against JAX's on one
generator, and the COCO subset download with ``requests`` replaced by a
stub over a local zip (nothing is downloaded). Modelled on
tests/test_data.py."""

import io
import json
import sys
import types
import zipfile

import numpy as np
import pytest
from PIL import Image

from neural_image_compression_tpu.data import preprocess as jpreprocess
from neural_image_compression_tpu_torch import data
from neural_image_compression_tpu_torch.data import preprocess


@pytest.fixture(scope="module")
def src(tmp_path_factory):
    """Six files: four images, one of them too small for the worst-case
    downsample (300 px: 225 < 256) and one a jpeg, a saturated image the
    filter drops and a file that is no image."""
    d = tmp_path_factory.mktemp("src")
    rng = np.random.RandomState(0)
    for i, (h, w) in enumerate(((400, 400), (300, 520), (352, 460), (600, 380))):
        ext = "jpg" if i == 3 else "png"
        Image.fromarray((rng.rand(h, w, 3) * 255).astype(np.uint8)).save(d / f"img_{i}.{ext}")
    sat = np.zeros((400, 400, 3), np.uint8)
    sat[..., 0] = 255
    Image.fromarray(sat).save(d / "sat.png")
    (d / "broken.png").write_bytes(b"not an image")
    return d


def _patches(d):
    return {p.name: p.read_bytes() for p in sorted(d.iterdir())}


@pytest.mark.parametrize("seed", [0, 7])
def test_patches_byte_identical_to_jax(src, tmp_path, seed):
    n_jax = jpreprocess.preprocess_images(src, tmp_path / "jax", target_size=256, seed=seed,
                                          workers=1)
    n = preprocess.preprocess_images(src, tmp_path / "port", target_size=256, seed=seed,
                                     workers=1)
    assert n == n_jax == 3
    want = _patches(tmp_path / "jax")
    assert sorted(want) == ["img_0.png", "img_2.png", "img_3.jpg"]
    assert _patches(tmp_path / "port") == want
    for name in want:
        assert Image.open(tmp_path / "port" / name).size == (256, 256)


def test_same_patches_for_any_worker_count(src, tmp_path):
    assert preprocess.preprocess_images(src, tmp_path / "one", seed=3, workers=1) == 3
    assert preprocess.preprocess_images(src, tmp_path / "four", seed=3, workers=4) == 3
    assert _patches(tmp_path / "one") == _patches(tmp_path / "four")


def test_existing_patches_are_kept_unless_overwrite(src, tmp_path):
    dst = tmp_path / "dst"
    preprocess.preprocess_images(src, dst, seed=1)
    before = _patches(dst)
    assert preprocess.preprocess_images(src, dst, seed=2) == 3
    assert _patches(dst) == before
    preprocess.preprocess_images(src, dst, seed=2, overwrite=True)
    assert _patches(dst) != before


def test_file_rng_matches_jax():
    for seed, name in ((0, "a.png"), (None, "b.jpg"), (12345, "img_0.png")):
        np.testing.assert_array_equal(preprocess._file_rng(seed, name).random(8),
                                      jpreprocess._file_rng(seed, name).random(8))


def test_pil_helpers_match_jax():
    rng = np.random.RandomState(4)
    img = Image.fromarray((rng.rand(400, 500, 3) * 255).astype(np.uint8))
    for name in ("add_quantization_noise", "random_downsample_crop"):
        got = getattr(data, name)(img, rng=np.random.default_rng(5))
        want = getattr(jpreprocess, name)(img, rng=np.random.default_rng(5))
        np.testing.assert_array_equal(np.asarray(got), np.asarray(want))
    assert data.random_downsample_crop(img).size == (256, 256)
    assert data.random_downsample_crop(Image.fromarray(np.zeros((100, 100, 3), np.uint8))) is None
    noisy = np.asarray(data.add_quantization_noise(Image.fromarray(np.full((8, 8, 3), 100,
                                                                           np.uint8))))
    assert np.abs(noisy.astype(int) - 100).max() <= 1
    sat = np.zeros((10, 10, 3), np.uint8)
    sat[..., 0] = 255
    assert data.is_saturated(Image.fromarray(sat))
    assert not data.is_saturated(Image.fromarray(np.full((10, 10, 3), 128, np.uint8)))


def test_main(src, tmp_path, capsys):
    preprocess.main(["--input_dir", str(src), "--output_dir", str(tmp_path / "out"),
                     "--target_size", "128", "--seed", "0", "--workers", "2"])
    # at 128 px the 300-px image fits a crop too
    assert capsys.readouterr().out.strip().endswith(f"4 patches in {tmp_path / 'out'}")
    jpreprocess.main(["--input_dir", str(src), "--output_dir", str(tmp_path / "jax"),
                      "--target_size", "128", "--seed", "0"])
    assert _patches(tmp_path / "out") == _patches(tmp_path / "jax")


def test_download_coco_subset_with_a_stub(tmp_path, monkeypatch):
    """The annotation zip comes from a stub of ``requests`` (its archive
    built here), the subset is drawn from the annotations with the seed,
    and a second run finds everything on disk and asks for nothing."""
    ann = {"images": [{"coco_url": f"http://example.com/img_{i}.jpg",
                       "file_name": f"img_{i}.jpg"} for i in range(5)]}
    buf = io.BytesIO()
    with zipfile.ZipFile(buf, "w") as z:
        z.writestr("annotations/instances_train2017.json", json.dumps(ann))
    calls = []

    class Response:
        def __init__(self, content, status_code=200):
            self.content, self.status_code = content, status_code

        def raise_for_status(self):
            pass

        def iter_content(self, n):
            for i in range(0, len(self.content), n):
                yield self.content[i:i + n]

    def get(url, stream=False, timeout=None):
        calls.append(url)
        if url.endswith(".zip"):
            return Response(buf.getvalue())
        return Response(b"jpeg " + url.encode(), 404 if url.endswith("img_4.jpg") else 200)

    stub = types.ModuleType("requests")
    stub.get = get
    stub.RequestException = OSError
    monkeypatch.setitem(sys.modules, "requests", stub)

    out, root = tmp_path / "subset", tmp_path / "data"
    n = data.download_coco_subset(out_dir=str(out), split="train2017", n_images=5,
                                  data_root=str(root), seed=0)
    assert n == 4  # img_4 answers 404 and is reported, not fatal
    assert (root / "annotations" / "instances_train2017.json").exists()
    assert sorted(p.name for p in out.glob("*.jpg")) == [f"img_{i}.jpg" for i in range(4)]
    assert (out / "img_2.jpg").read_bytes() == b"jpeg http://example.com/img_2.jpg"
    assert calls[0].endswith("annotations_trainval2017.zip")
    before = len(calls)
    assert data.download_coco_subset(out_dir=str(out), split="train2017", n_images=4,
                                     data_root=str(root), seed=1) <= 4
    # the zip and the annotations stay on disk: only the missing image is asked for
    assert all(c.endswith("img_4.jpg") for c in calls[before:])
