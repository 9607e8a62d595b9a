"""Host-side numpy input pipelines (the port's copy of
sparse_vision_tpu/data/datasets.py, which imports no JAX): the synthetic
stand-in and the loaders of real datasets on disk. Batches are NHWC float32
numpy arrays with each sample's index in the dataset; drop_last everywhere;
train shuffled, eval not. Decoded values are bitwise the JAX package's.

- MNIST from its idx files (plain or ``.gz``): (x / 255 - 0.1307) / 0.3081
  (reference utils.py:429-433).
- CIFAR-10 from its python pickles, with the MNIST constants on every channel:
  a quirk of the reference kept (utils.py:374-408).
- Tiny-ImageNet from its folder layout: raw float32 pixels in [0, 255] (the
  reference builds the dataset with transform=None, utils.py:353-357).
- ImageNet from class folders or from webdataset tar shards (``<key>.jpg`` and
  ``<key>.cls`` pairs, utils.py:520-547), decoded per backbone family
  (decode_fns_for_model): resize 256, centre-crop 229, pixels - 117 for the
  CNNs (lucent InceptionV1, utils.py:318-329), the HF processors' numerics at
  224 px for the ViT and CLIP towers.
- The reference's val-loader bug (load_data returns the train loader twice,
  utils.py:610) is not replicated: the validation split is real.

File-backed datasets decode on a thread pool (``workers``: None or -1 picks a
size, 0 decodes on the consumer's thread) with a two-batch look-ahead; PIL's
decoders release the GIL. PIL is imported at the first decode, where a missing
PIL raises its ImportError; there is no other decoder.
"""

from __future__ import annotations

import glob as _glob
import gzip
import hashlib
import io
import json
import os
import pickle
import struct
import tarfile
from collections import deque
from concurrent.futures import ThreadPoolExecutor
from dataclasses import dataclass
from typing import Iterator, Optional, Sequence

import numpy as np

from sparse_vision_tpu_torch.config import NUM_CLASSES, RunConfig, get_img_size


def _auto_workers(workers: Optional[int]) -> int:
    """None or a negative count: a pool of min(16, CPUs) threads; 0: decode on
    the consumer's thread."""
    if workers is None or workers < 0:
        return min(16, os.cpu_count() or 8)
    return workers


@dataclass
class Batch:
    images: np.ndarray  # [B, H, W, C] float32
    labels: np.ndarray  # [B] int32
    indices: np.ndarray  # [B] int32: the samples' indices in the dataset (top-k files)


class ArrayDataset:
    """In-memory dataset with deterministic epoch shuffling and drop_last batching."""

    def __init__(self, images: np.ndarray, labels: np.ndarray, category_names: Sequence[str]):
        if images.ndim != 4 or images.shape[0] != labels.shape[0]:
            raise ValueError(f"images {images.shape} / labels {labels.shape} mismatch")
        self.images = images
        self.labels = labels.astype(np.int32)
        self.category_names = list(category_names)

    def __len__(self) -> int:
        return self.images.shape[0]

    def batches(self, batch_size: int, shuffle: bool, seed: int = 0,
                workers: Optional[int] = 0) -> Iterator[Batch]:
        """``workers`` is accepted for the file-backed datasets' signature: there
        is nothing to decode."""
        n = len(self)
        order = (
            np.random.default_rng(seed).permutation(n) if shuffle else np.arange(n)
        ).astype(np.int32)
        for b in range(n // batch_size):  # drop_last=True
            idx = order[b * batch_size : (b + 1) * batch_size]
            yield Batch(self.images[idx], self.labels[idx], idx)


class LazyImageDataset:
    """Image files decoded per batch by ``decode_fn(path)`` on a thread pool,
    two batches ahead of the consumer (the reference's DataLoader workers,
    utils.py:354 and 540-547)."""

    def __init__(self, paths, labels, category_names, decode_fn):
        self.paths = list(paths)
        self.labels = np.asarray(labels, np.int32)
        self.category_names = list(category_names)
        self.decode_fn = decode_fn

    def __len__(self) -> int:
        return len(self.paths)

    def batches(self, batch_size: int, shuffle: bool, seed: int = 0,
                workers: Optional[int] = None) -> Iterator[Batch]:
        n = len(self)
        order = (
            np.random.default_rng(seed).permutation(n) if shuffle else np.arange(n)
        ).astype(np.int32)
        nb = n // batch_size
        w = _auto_workers(workers)
        if w == 0:
            for b in range(nb):
                idx = order[b * batch_size : (b + 1) * batch_size]
                yield Batch(np.stack([self.decode_fn(self.paths[i]) for i in idx]),
                            self.labels[idx], idx)
            return
        lookahead = 2  # batches in flight beyond the one being consumed
        ex = ThreadPoolExecutor(max_workers=w)
        try:
            def submit(b):
                idx = order[b * batch_size : (b + 1) * batch_size]
                return idx, [ex.submit(self.decode_fn, self.paths[i]) for i in idx]

            pending: deque = deque(submit(b) for b in range(min(1 + lookahead, nb)))
            for b in range(nb):
                idx, futs = pending.popleft()
                if b + 1 + lookahead < nb:
                    pending.append(submit(b + 1 + lookahead))
                yield Batch(np.stack([f.result() for f in futs]), self.labels[idx], idx)
        finally:
            ex.shutdown(wait=False, cancel_futures=True)


def make_synthetic(num_samples: int = 512, img_size: tuple = (28, 28, 1),
                   num_classes: int = 10, seed: int = 0,
                   center_seed: int = 1234) -> ArrayDataset:
    """Class-conditional Gaussian blobs; the class centres come from
    ``center_seed`` so train and val splits (different ``seed``) share one task.
    Bit-identical to the JAX package's make_synthetic."""
    centers = (
        np.random.default_rng(center_seed)
        .normal(0, 1.0, size=(num_classes,) + tuple(img_size))
        .astype(np.float32)
    )
    rng = np.random.default_rng(seed)
    labels = rng.integers(0, num_classes, size=num_samples)
    images = centers[labels] + rng.normal(
        0, 0.3, size=(num_samples,) + tuple(img_size)).astype(np.float32)
    return ArrayDataset(images, labels, [str(i) for i in range(num_classes)])


# ---------------------------------------------------------------------------
# MNIST (idx files) and CIFAR-10 (python pickles)
# ---------------------------------------------------------------------------

def _read_idx(path: str) -> np.ndarray:
    opener = gzip.open if path.endswith(".gz") else open
    with opener(path, "rb") as f:
        ndim = struct.unpack(">I", f.read(4))[0] & 0xFF
        dims = struct.unpack(f">{ndim}I", f.read(4 * ndim))
        return np.frombuffer(f.read(), dtype=np.uint8).reshape(dims)


def _find(dirpath: str, names: Sequence[str]) -> str:
    for n in names:
        for cand in (os.path.join(dirpath, n), os.path.join(dirpath, n + ".gz")):
            if os.path.exists(cand):
                return cand
    raise FileNotFoundError(f"None of {names} under {dirpath}")


def load_mnist(data_dir: str, split: str) -> ArrayDataset:
    base = os.path.join(data_dir, "mnist")
    if os.path.isdir(os.path.join(base, "MNIST", "raw")):
        base = os.path.join(base, "MNIST", "raw")
    prefix = "train" if split == "train" else "t10k"
    images = _read_idx(_find(base, [f"{prefix}-images-idx3-ubyte",
                                    f"{prefix}-images.idx3-ubyte"]))
    labels = _read_idx(_find(base, [f"{prefix}-labels-idx1-ubyte",
                                    f"{prefix}-labels.idx1-ubyte"]))
    x = images.astype(np.float32)[..., None] / 255.0
    x = (x - 0.1307) / 0.3081
    return ArrayDataset(x, labels, [str(i) for i in range(10)])


CIFAR10_NAMES = ["plane", "car", "bird", "cat", "deer", "dog", "frog", "horse", "ship",
                 "truck"]


def load_cifar10(data_dir: str, split: str) -> ArrayDataset:
    base = os.path.join(data_dir, "cifar-10")
    for sub in ("cifar-10-batches-py", "."):
        cand = os.path.join(base, sub)
        if os.path.exists(os.path.join(cand, "data_batch_1")):
            base = cand
            break
    files = [f"data_batch_{i}" for i in range(1, 6)] if split == "train" else ["test_batch"]
    xs, ys = [], []
    for fn in files:
        # the dataset's own pickles: read only files of a dataset you trust
        with open(os.path.join(base, fn), "rb") as f:
            d = pickle.load(f, encoding="bytes")
        xs.append(d[b"data"])
        ys.extend(d[b"labels"])
    x = np.concatenate(xs).reshape(-1, 3, 32, 32).transpose(0, 2, 3, 1).astype(np.float32) / 255.0
    x = (x - 0.1307) / 0.3081  # the reference's quirk: MNIST constants on all channels
    return ArrayDataset(x, np.asarray(ys), CIFAR10_NAMES)


# ---------------------------------------------------------------------------
# Tiny-ImageNet (folders): raw float32 pixels
# ---------------------------------------------------------------------------

def _decode_image(path: str) -> np.ndarray:
    from PIL import Image

    return np.asarray(Image.open(path).convert("RGB"), dtype=np.float32)


def load_tiny_imagenet(data_dir: str, split: str) -> LazyImageDataset:
    root = os.path.join(data_dir, "tiny-imagenet-200")
    with open(os.path.join(root, "wnids.txt")) as f:
        wnids = [l.strip() for l in f if l.strip()]
    wnid_to_idx = {w: i for i, w in enumerate(wnids)}
    paths, labels = [], []
    if split == "train":
        for w in wnids:
            d = os.path.join(root, "train", w, "images")
            for fn in sorted(os.listdir(d)):
                paths.append(os.path.join(d, fn))
                labels.append(wnid_to_idx[w])
    else:
        with open(os.path.join(root, "val", "val_annotations.txt")) as f:
            for line in f:
                parts = line.split("\t")
                paths.append(os.path.join(root, "val", "images", parts[0]))
                labels.append(wnid_to_idx[parts[1]])
    return LazyImageDataset(paths, labels, wnids, _decode_image)


# ---------------------------------------------------------------------------
# ImageNet (class folders): resize 256, centre-crop 229, pixels - 117
# ---------------------------------------------------------------------------

def imagenet_decode(path: str, crop: int = 229) -> np.ndarray:
    """Lucent-InceptionV1 preprocessing (utils.py:318-329): shorter side to 256
    (bilinear), centre crop ``crop``, raw pixel values minus 117."""
    from PIL import Image

    return _imagenet_transform(Image.open(path), crop)


def imagenet_decode_bytes(data: bytes, crop: int = 229) -> np.ndarray:
    """The same from encoded bytes (the tar shards' read path)."""
    from PIL import Image

    return _imagenet_transform(Image.open(io.BytesIO(data)), crop)


def _imagenet_transform(img, crop: int) -> np.ndarray:
    from PIL import Image

    img = img.convert("RGB")
    w, h = img.size
    scale = 256 / min(w, h)
    img = img.resize((round(w * scale), round(h * scale)), Image.BILINEAR)
    w, h = img.size
    left, top = (w - crop) // 2, (h - crop) // 2
    img = img.crop((left, top, left + crop, top + crop))
    return np.asarray(img, dtype=np.float32) - 117.0


def load_imagenet(data_dir: str, split: str, class_filter: Optional[str] = None,
                  decode_fn=imagenet_decode) -> LazyImageDataset:
    """``<data_dir>/imagenet/{train,val}/<wnid>/*``; labels index the sorted
    wnids. ``class_filter`` (one wnid) keeps that class's files only (the
    reference's flamingo filter, utils.py:2163-2168, as an explicit option)."""
    root = os.path.join(data_dir, "imagenet", "train" if split == "train" else "val")
    wnids = sorted(d for d in os.listdir(root) if os.path.isdir(os.path.join(root, d)))
    wnid_to_idx = {w: i for i, w in enumerate(wnids)}
    paths, labels = [], []
    for w in wnids:
        if class_filter is not None and w != class_filter:
            continue
        d = os.path.join(root, w)
        for fn in sorted(os.listdir(d)):
            paths.append(os.path.join(d, fn))
            labels.append(wnid_to_idx[w])
    return LazyImageDataset(paths, labels, wnids, decode_fn)


# ---------------------------------------------------------------------------
# ViT / CLIP preprocessing: the HF processors' numerics, per backbone family
# ---------------------------------------------------------------------------

VIT_MEAN = (0.5, 0.5, 0.5)  # HF ViTImageProcessor (IMAGENET_STANDARD_MEAN / STD)
VIT_STD = (0.5, 0.5, 0.5)
CLIP_MEAN = (0.48145466, 0.4578275, 0.40821073)  # HF CLIPImageProcessor (OpenAI CLIP)
CLIP_STD = (0.26862954, 0.26130258, 0.27577711)


def _rescale_normalize(img, mean, std) -> np.ndarray:
    x = np.asarray(img, np.float32) / 255.0
    return ((x - np.asarray(mean, np.float32)) / np.asarray(std, np.float32)).astype(np.float32)


def _vit_transform(img, size: int) -> np.ndarray:
    """ViTImageProcessor: a direct (size, size) bilinear resize, 1/255, mean and
    std 0.5."""
    from PIL import Image

    img = img.convert("RGB").resize((size, size), Image.BILINEAR)
    return _rescale_normalize(img, VIT_MEAN, VIT_STD)


def _clip_transform(img, size: int) -> np.ndarray:
    """CLIPImageProcessor: the shortest edge to ``size`` by bicubic resize (the
    long side truncated to an int), centre crop size x size, 1/255, the OpenAI
    CLIP statistics."""
    from PIL import Image

    img = img.convert("RGB")
    w, h = img.size
    short, long = (w, h) if w <= h else (h, w)
    new_short, new_long = size, int(size * long / short)
    nw, nh = (new_short, new_long) if w <= h else (new_long, new_short)
    img = img.resize((nw, nh), Image.BICUBIC)
    left, top = (nw - size) // 2, (nh - size) // 2
    img = img.crop((left, top, left + size, top + size))
    return _rescale_normalize(img, CLIP_MEAN, CLIP_STD)


def vit_decode(path: str, size: int = 224) -> np.ndarray:
    from PIL import Image

    return _vit_transform(Image.open(path), size)


def vit_decode_bytes(data: bytes, size: int = 224) -> np.ndarray:
    from PIL import Image

    return _vit_transform(Image.open(io.BytesIO(data)), size)


def clip_decode(path: str, size: int = 224) -> np.ndarray:
    from PIL import Image

    return _clip_transform(Image.open(path), size)


def clip_decode_bytes(data: bytes, size: int = 224) -> np.ndarray:
    from PIL import Image

    return _clip_transform(Image.open(io.BytesIO(data)), size)


def decode_fns_for_model(model_name: str):
    """(file decode, bytes decode) of the ImageNet path for ``model_name``: the
    CLIP towers' CLIPImageProcessor numerics, the ViTs' ViTImageProcessor
    numerics, the lucent-InceptionV1 229 px convention for every other
    backbone."""
    base = model_name[:-6] if model_name.endswith("_split") else model_name
    if base.startswith("clip_vit"):
        return clip_decode, clip_decode_bytes
    if base.startswith("vit_"):
        return vit_decode, vit_decode_bytes
    return imagenet_decode, imagenet_decode_bytes


# ---------------------------------------------------------------------------
# tar shards (webdataset layout), the reference's production ImageNet format
# ---------------------------------------------------------------------------

_IMG_EXTS = (".jpg", ".jpeg", ".png", ".ppm", ".bmp")


def _scan_tar_shards(tar_paths: Sequence[str]) -> list:
    """Per shard, the (offset, size, label, name) of each image member in key
    order; the label from the member ``<key>.cls``, -1 without one. Later reads
    are a seek and a read, with no tarfile layer."""
    shards = []
    for p in tar_paths:
        entries: dict = {}
        with tarfile.open(p, "r:") as tf:  # uncompressed: members are seekable
            for m in tf:
                if not m.isfile():
                    continue
                key, ext = os.path.splitext(m.name)
                ext = ext.lower()
                if ext in _IMG_EXTS:
                    e = entries.setdefault(key, {"label": -1})
                    e["offset"] = m.offset_data
                    e["size"] = m.size
                    e["name"] = m.name
                elif ext == ".cls":
                    f = tf.extractfile(m)
                    entries.setdefault(key, {})["label"] = int(f.read().decode().strip())
        shards.append([e for _, e in sorted(entries.items()) if "offset" in e])
    return shards


def _getter(dataset):
    """Random access to one decoded image by sample index."""
    if hasattr(dataset, "get_image"):
        return dataset.get_image
    return lambda i: dataset.decode_fn(dataset.paths[i])


def fetch_images(dataset, indices) -> np.ndarray:
    """The images of ``indices`` from any dataset kind: in-memory arrays
    (``.images``), tar shards (``.get_image``) or image files (``.paths`` and
    ``.decode_fn``); for the top-k image grids and MIS."""
    idx = [int(i) for i in indices]
    if hasattr(dataset, "images"):
        return dataset.images[np.asarray(idx, np.int64)]
    get = _getter(dataset)
    return np.stack([get(i) for i in idx])


def fetch_images_batches(dataset, indices, batch_size: int,
                         workers: Optional[int] = None) -> Iterator[tuple]:
    """``indices`` in chunks of ``batch_size``: yields ``(chunk_indices [b]
    int64, images [b, H, W, C])``, the last chunk possibly shorter (the MIS
    embedding pass). Files and tar shards decode on a thread pool with a
    two-chunk look-ahead, as LazyImageDataset.batches; in-memory arrays have
    nothing to decode."""
    idx = [int(i) for i in indices]
    chunks = [idx[s : s + batch_size] for s in range(0, len(idx), batch_size)]
    if hasattr(dataset, "images"):
        for c in chunks:
            a = np.asarray(c, np.int64)
            yield a, dataset.images[a]
        return
    get = _getter(dataset)
    w = _auto_workers(workers)
    if w == 0:
        for c in chunks:
            yield np.asarray(c, np.int64), np.stack([get(i) for i in c])
        return
    lookahead = 2
    ex = ThreadPoolExecutor(max_workers=w)
    try:
        pending: deque = deque((c, [ex.submit(get, i) for i in c])
                               for c in chunks[: 1 + lookahead])
        for b in range(len(chunks)):
            c, futs = pending.popleft()
            imgs = np.stack([f.result() for f in futs])
            nxt = b + 1 + lookahead
            if nxt < len(chunks):
                pending.append((chunks[nxt], [ex.submit(get, i) for i in chunks[nxt]]))
            yield np.asarray(c, np.int64), imgs
    finally:
        ex.shutdown(wait=False, cancel_futures=True)


class _Done:
    """A resolved stand-in for a Future (synchronous decode, workers=0)."""

    __slots__ = ("_v",)

    def __init__(self, v):
        self._v = v

    def result(self):
        return self._v


class TarShardDataset:
    """Uncompressed webdataset-style tar shards, read by offset.

    The first open scans the tar headers into an offset index, cached as
    ``<dir>/_svt_index_<md5 of the basenames>.json`` with each shard's size and
    mtime, so regenerated shards invalidate it and train and val shard sets in
    one folder keep separate files. An epoch shuffles the shard order, then the
    samples within each shard (the reference's webdataset regime,
    utils.py:534-543); reads stay sequential within a shard, and a thread pool
    decodes ``2 * batch_size`` samples ahead. A sample's index is its position
    in the sorted-shard, sorted-key catalog, the same in every epoch."""

    def __init__(self, tar_paths: Sequence[str], category_names: Sequence[str],
                 decode_bytes_fn=imagenet_decode_bytes, index_cache: Optional[str] = None):
        self.tar_paths = sorted(tar_paths)
        if not self.tar_paths:
            raise ValueError("no tar shards given")
        self.category_names = list(category_names)
        self.decode_bytes_fn = decode_bytes_fn
        basenames = [os.path.basename(p) for p in self.tar_paths]
        stamps = [[os.path.getsize(p), os.stat(p).st_mtime_ns] for p in self.tar_paths]
        cache = index_cache
        if cache is None:
            tag = hashlib.md5("\0".join(basenames).encode()).hexdigest()[:10]
            cache = os.path.join(os.path.dirname(self.tar_paths[0]), f"_svt_index_{tag}.json")
        self.entries = None
        if cache and os.path.exists(cache):
            with open(cache) as f:
                idx = json.load(f)
            if idx.get("tar_paths") == basenames and idx.get("stamps") == stamps:
                self.entries = idx["shards"]
        if self.entries is None:
            self.entries = _scan_tar_shards(self.tar_paths)
            if cache:
                tmp = cache + ".tmp"
                with open(tmp, "w") as f:
                    json.dump({"tar_paths": basenames, "stamps": stamps,
                               "shards": self.entries}, f)
                os.replace(tmp, cache)
        self._base = np.cumsum([0] + [len(s) for s in self.entries])
        self.labels = np.asarray([e["label"] for s in self.entries for e in s], np.int32)

    def __len__(self) -> int:
        return int(self._base[-1])

    def get_image(self, i: int) -> np.ndarray:
        """The decoded image of sample ``i`` (the top-k grids' and MIS's random
        access; the reference extracts such images from the tars,
        utils.py:2367-2445)."""
        si = int(np.searchsorted(self._base, i, side="right") - 1)
        e = self.entries[si][i - int(self._base[si])]
        with open(self.tar_paths[si], "rb") as f:
            f.seek(e["offset"])
            data = f.read(e["size"])
        return self.decode_bytes_fn(data)

    def batches(self, batch_size: int, shuffle: bool, seed: int = 0,
                workers: Optional[int] = None) -> Iterator[Batch]:
        rng = np.random.default_rng(seed)
        shard_order = np.arange(len(self.tar_paths))
        if shuffle:
            rng.shuffle(shard_order)
        w = _auto_workers(workers)
        if w == 0:  # decode on the consumer's thread
            ex = None

            def submit(fn, a):
                return _Done(fn(a))
        else:
            ex = ThreadPoolExecutor(max_workers=w)
            submit = ex.submit
        try:
            buf: list = []  # (future, label, index), across shard boundaries

            def drain(min_keep: int):
                # keep min_keep decodes in flight behind the batch yielded
                while len(buf) >= batch_size + min_keep:
                    chunk = buf[:batch_size]
                    del buf[:batch_size]
                    yield Batch(np.stack([f.result() for f, _, _ in chunk]),
                                np.asarray([l for _, l, _ in chunk], np.int32),
                                np.asarray([i for _, _, i in chunk], np.int32))

            lookahead = 2 * batch_size
            for si in shard_order:
                entries = self.entries[si]
                order = np.arange(len(entries))
                if shuffle:
                    rng.shuffle(order)
                with open(self.tar_paths[si], "rb") as f:
                    for j in order:
                        e = entries[j]
                        f.seek(e["offset"])
                        data = f.read(e["size"])
                        buf.append((submit(self.decode_bytes_fn, data), e["label"],
                                    int(self._base[si]) + int(j)))
                        if len(buf) > batch_size + lookahead:
                            yield from drain(lookahead)
            yield from drain(0)  # a trailing partial batch is dropped (drop_last)
        finally:
            if ex is not None:
                ex.shutdown(wait=False, cancel_futures=True)


def write_tar_shards(paths: Sequence[str], labels: Sequence[int], out_dir: str,
                     shard_size: int = 1024, prefix: str = "train") -> list:
    """Pack image files and their labels into tar shards ``<prefix>-NNNNN.tar``
    of ``<key><ext>`` + ``<key>.cls`` pairs (the reference's production format,
    utils.py:520-526). Each shard is written under a temporary name and
    renamed when complete, so a killed write leaves no truncated shard."""
    os.makedirs(out_dir, exist_ok=True)
    out_paths = []
    for s in range(0, len(paths), shard_size):
        op = os.path.join(out_dir, f"{prefix}-{s // shard_size:05d}.tar")
        tmp = op + ".tmp"
        with tarfile.open(tmp, "w") as tf:
            for i in range(s, min(s + shard_size, len(paths))):
                key = f"{i:08d}"
                ext = os.path.splitext(paths[i])[1].lower() or ".jpg"
                with open(paths[i], "rb") as f:
                    data = f.read()
                info = tarfile.TarInfo(key + ext)
                info.size = len(data)
                tf.addfile(info, io.BytesIO(data))
                cls = str(int(labels[i])).encode()
                info = tarfile.TarInfo(key + ".cls")
                info.size = len(cls)
                tf.addfile(info, io.BytesIO(cls))
        os.replace(tmp, op)
        out_paths.append(op)
    return out_paths


def load_imagenet_tars(data_dir: str, split: str,
                       decode_bytes_fn=imagenet_decode_bytes) -> Optional[TarShardDataset]:
    """ImageNet's tar shards of ``split``: ``<data_dir>/imagenet/<split>*.tar``,
    ``imagenet-<split>-*.tar`` (the reference's naming) or
    ``shards/<split>*.tar``, the first pattern that matches; class names from
    ``imagenet/wnids.txt`` when present. None when no shard exists."""
    base = os.path.join(data_dir, "imagenet")
    tars: list = []
    for p in (os.path.join(base, f"{split}*.tar"),
              os.path.join(base, f"imagenet-{split}-*.tar"),
              os.path.join(base, "shards", f"{split}*.tar")):
        tars = sorted(_glob.glob(p))
        if tars:
            break
    if not tars:
        return None
    names_file = os.path.join(base, "wnids.txt")
    if os.path.exists(names_file):
        with open(names_file) as f:
            names = [l.strip() for l in f if l.strip()]
    else:
        names = [str(i) for i in range(NUM_CLASSES["imagenet"])]
    return TarShardDataset(tars, names, decode_bytes_fn)


def load_data(cfg: RunConfig, class_filter: Optional[str] = None):
    """Returns (train_ds, val_ds, category_names, img_size). Without
    ``cfg.data_dir`` (or for "synthetic"): the stand-in, 512 train / 256 val
    images at ``get_img_size(dataset)`` (229 px on ImageNet whatever the
    model, as the JAX package: ROADMAP C7). With it, the dataset's files:
    ImageNet from tar shards when there are any (not with ``class_filter``,
    which needs the class folders), else from the folders, decoded for
    ``cfg.model_name`` (decode_fns_for_model); the image size then is
    ``get_img_size(dataset, model)``."""
    name = cfg.dataset_name
    if name == "synthetic" or not cfg.data_dir:
        size = get_img_size(name)
        train = make_synthetic(seed=cfg.seed, img_size=size, num_classes=NUM_CLASSES[name])
        val = make_synthetic(num_samples=256, seed=cfg.seed + 1, img_size=size,
                             num_classes=NUM_CLASSES[name])
        return train, val, train.category_names, size
    if name == "mnist":
        train, val = load_mnist(cfg.data_dir, "train"), load_mnist(cfg.data_dir, "val")
    elif name == "cifar_10":
        train, val = load_cifar10(cfg.data_dir, "train"), load_cifar10(cfg.data_dir, "val")
    elif name == "tiny_imagenet":
        train = load_tiny_imagenet(cfg.data_dir, "train")
        val = load_tiny_imagenet(cfg.data_dir, "val")
    elif name == "imagenet":
        dec, dec_bytes = decode_fns_for_model(cfg.model_name)
        train = None if class_filter else load_imagenet_tars(cfg.data_dir, "train", dec_bytes)
        val = None if class_filter else load_imagenet_tars(cfg.data_dir, "val", dec_bytes)
        if train is None:
            train = load_imagenet(cfg.data_dir, "train", class_filter, dec)
        if val is None:
            val = load_imagenet(cfg.data_dir, "val", class_filter, dec)
    else:
        raise ValueError(f"Unsupported dataset: {name}")
    return train, val, train.category_names, get_img_size(name, cfg.model_name)
