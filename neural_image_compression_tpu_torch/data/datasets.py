"""Image datasets and batch loaders, port of data/datasets.py: NHWC numpy
batches, float32 in [0, 1] or uint8, decoded on the host (PIL, imported
where an image is read) with a background thread that prefetches batches
while the device computes. The Trainer and the evaluator move each batch
to the model's device.
"""

import glob
import os
import queue
import threading
from typing import Iterator, Optional, Sequence

import numpy as np


def load_image(path: str, dtype=np.float32) -> np.ndarray:
    """Decode one image file -> (H, W, 3); float32 in [0,1] (default) or raw
    uint8 (dtype=np.uint8: 4x less host-to-device traffic; the train step
    normalizes on the device)."""
    from PIL import Image

    with Image.open(path) as img:
        arr = np.asarray(img.convert("RGB"), dtype=np.uint8)
    if dtype == np.uint8:
        return arr
    return arr.astype(np.float32) / 255.0


class ImageFolderDataset:
    """Folder of jpg/jpeg/png images, sorted by path.

    cache=True keeps decoded arrays in RAM after first use: a patch-sized
    training set is small, while repeated decodes can hold back a trainer
    that cycles it many times."""

    EXTS = ("*.jpg", "*.jpeg", "*.png")

    def __init__(self, root_dir: str, dtype=np.float32, cache: bool = False):
        images = []
        for ext in self.EXTS:
            images.extend(glob.glob(os.path.join(root_dir, ext)))
        self.images = sorted(images)
        self.dtype = dtype
        self._cache = {} if cache else None

    def __len__(self) -> int:
        return len(self.images)

    def __getitem__(self, idx: int) -> np.ndarray:
        if self._cache is not None:
            arr = self._cache.get(idx)
            if arr is None:
                arr = load_image(self.images[idx], self.dtype)
                # cached samples are returned by reference; freeze them so an
                # in-place change cannot corrupt the cache for later epochs
                arr.setflags(write=False)
                self._cache[idx] = arr
            return arr
        return load_image(self.images[idx], self.dtype)


# The reference names this PreprocessedDataset.
PreprocessedDataset = ImageFolderDataset


class KodakDataset(ImageFolderDataset):
    """Kodak eval set: 24 768x512 PNGs."""

    EXTS = ("*.png",)


class BatchLoader:
    """Batches a dataset into NHWC arrays.

    One pass per __iter__ (the Trainer cycles it). Shuffling draws from
    ``np.random.RandomState(seed)``, one permutation a pass. All images in a
    batch must share a shape. prefetch > 0 builds up to that many batches
    ahead on a background thread; an error there reaches the consumer, and
    an abandoned iterator stops the thread.
    """

    def __init__(self, dataset, batch_size: int = 1, shuffle: bool = False,
                 drop_remainder: bool = True, seed: int = 0,
                 prefetch: int = 2, pad_multiple: Optional[int] = None):
        self.dataset = dataset
        self.batch_size = batch_size
        self.shuffle = shuffle
        self.drop_remainder = drop_remainder
        self.prefetch = prefetch
        self.pad_multiple = pad_multiple
        self._rng = np.random.RandomState(seed)

    def __len__(self) -> int:
        n = len(self.dataset)
        if self.drop_remainder:
            return n // self.batch_size
        return (n + self.batch_size - 1) // self.batch_size

    def _indices(self) -> Sequence[int]:
        idx = np.arange(len(self.dataset))
        if self.shuffle:
            self._rng.shuffle(idx)
        return idx

    def _make_batch(self, idxs) -> np.ndarray:
        imgs = [self.dataset[int(i)] for i in idxs]
        batch = np.stack(imgs, axis=0)
        if self.pad_multiple:
            batch = pad_to_multiple(batch, self.pad_multiple)
        return batch

    def _batch_indices(self):
        idx = self._indices()
        n = len(idx)
        stop = (n // self.batch_size) * self.batch_size if self.drop_remainder else n
        for s in range(0, stop, self.batch_size):
            yield idx[s:s + self.batch_size]

    def __iter__(self) -> Iterator[np.ndarray]:
        if self.prefetch <= 0:
            for b in self._batch_indices():
                yield self._make_batch(b)
            return
        q: "queue.Queue" = queue.Queue(maxsize=self.prefetch)
        sentinel = object()
        error: list = []
        stop = threading.Event()  # the consumer is gone (GeneratorExit, break)

        def producer():
            try:
                for b in self._batch_indices():
                    batch = self._make_batch(b)
                    while not stop.is_set():
                        try:
                            q.put(batch, timeout=0.1)
                            break
                        except queue.Full:
                            continue
                    if stop.is_set():
                        return
            except BaseException as e:  # re-raised in the consumer: a
                error.append(e)         # swallowed decode error would cut
            finally:                    # every epoch short at that batch
                while not stop.is_set():
                    try:
                        q.put(sentinel, timeout=0.1)
                        break
                    except queue.Full:
                        continue
        t = threading.Thread(target=producer, daemon=True)
        t.start()
        try:
            while True:
                item = q.get()
                if item is sentinel:
                    if error:
                        raise error[0]
                    break
                yield item
        finally:
            # an abandoned iterator (the Trainer stops mid-epoch) must not
            # leave the producer blocked on a full queue for ever
            stop.set()


def pad_to_multiple(batch: np.ndarray, multiple: int) -> np.ndarray:
    """Replicate-pad H and W up to the next multiple (the models need H and
    W multiples of 64)."""
    _, h, w, _ = batch.shape
    ph = (-h) % multiple
    pw = (-w) % multiple
    if ph == 0 and pw == 0:
        return batch
    return np.pad(batch, ((0, 0), (0, ph), (0, pw), (0, 0)), mode="edge")


def center_crop(batch: np.ndarray, h: int, w: int) -> np.ndarray:
    """The top-left h x w of each image (undoes pad_to_multiple)."""
    return batch[:, :h, :w, :]


def shard_for_process(items, process_index: Optional[int] = None,
                      process_count: Optional[int] = None):
    """This rank's share of a sequence (a file list, an array, a dataset)
    for data-parallel training: the strided split items[i::p], so every
    rank holds the same number of items (within one) in the same order.
    The rank and the world's size come from ``torch.distributed`` where a
    process group exists, else 0 and 1. Lists, tuples and arrays are
    sliced; anything else with ``len`` and indexing gets a lazy view, so no
    image is decoded before it is read."""
    import torch.distributed as dist

    grouped = dist.is_available() and dist.is_initialized()
    pi = (dist.get_rank() if grouped else 0) if process_index is None else process_index
    pc = (dist.get_world_size() if grouped else 1) if process_count is None else process_count
    if not 0 <= pi < pc:
        raise ValueError(f"process_index {pi} out of range for {pc} processes")
    if isinstance(items, (list, tuple, np.ndarray)):
        return items[pi::pc]
    return _Subset(items, range(pi, len(items), pc))


class _Subset:
    """Lazy index view over a dataset."""

    def __init__(self, dataset, indices):
        self._dataset = dataset
        self._indices = list(indices)

    def __len__(self):
        return len(self._indices)

    def __getitem__(self, i):
        return self._dataset[self._indices[i]]
