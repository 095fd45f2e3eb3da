"""COCO subset downloader, port of data/coco.py (capability parity with
the reference's dataset.py:8-53).

Downloads a random n-image subset of COCO 2017 via the annotations index.
Fixes the reference's `.data/annotations` path bug (dataset.py:33, missing
slash). Network access is required; in air-gapped environments this raises a
clear error instead of hanging.
"""

import json
import os
import random
import zipfile


def download_coco_subset(
        out_dir: str = "./data/coco_train_subset",
        split: str = "train2017",
        n_images: int = 1000,
        ann_url: str = "http://images.cocodataset.org/annotations/annotations_trainval2017.zip",
        data_root: str = "./data",
        seed=None):
    """Download a random subset of COCO 2017 images into out_dir."""
    try:
        import requests
    except ImportError as e:  # pragma: no cover
        raise RuntimeError("COCO download requires the 'requests' package") from e

    os.makedirs(out_dir, exist_ok=True)
    ann_dir = os.path.join(data_root, "annotations")
    ann_file = os.path.join(ann_dir, f"instances_{split}.json")

    if not os.path.exists(ann_file):
        os.makedirs(data_root, exist_ok=True)
        zip_path = os.path.join(data_root, "annotations_trainval2017.zip")
        if not os.path.exists(zip_path):
            r = requests.get(ann_url, stream=True, timeout=60)
            r.raise_for_status()
            with open(zip_path, "wb") as f:
                for chunk in r.iter_content(1 << 20):
                    f.write(chunk)
        with zipfile.ZipFile(zip_path, "r") as z:
            z.extractall(data_root)

    with open(ann_file) as f:
        images = json.load(f)["images"]

    rng = random.Random(seed)
    rng.shuffle(images)
    images = images[:n_images]

    n_ok = 0
    failures = []
    for info in images:
        url = info["coco_url"]
        filename = os.path.join(out_dir, info["file_name"])
        if os.path.exists(filename):
            n_ok += 1
            continue
        # tolerate per-image failures (transient network, 4xx/5xx): one bad
        # image must not abort a multi-thousand-image run, and the caller
        # should learn which ones were skipped
        try:
            r = requests.get(url, stream=True, timeout=60)
        except requests.RequestException as e:
            failures.append((info["file_name"], str(e)))
            continue
        if r.status_code == 200:
            with open(filename, "wb") as f:
                f.write(r.content)
            n_ok += 1
        else:
            failures.append((info["file_name"], f"HTTP {r.status_code}"))

    for name, why in failures[:20]:
        print(f"[WARN] failed to download {name}: {why}")
    if len(failures) > 20:
        print(f"[WARN] ... and {len(failures) - 20} more failures")
    print(f"Download done. {n_ok} images saved in {out_dir}")
    return n_ok


if __name__ == "__main__":
    download_coco_subset(out_dir="./data/coco_train_subset",
                         split="train2017", n_images=5000)
