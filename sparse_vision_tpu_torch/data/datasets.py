"""Host-side numpy batching (port of the in-memory and synthetic parts of
sparse_vision_tpu/data/datasets.py). Batches are NHWC float32 numpy arrays;
drop_last everywhere; train shuffled, eval not. Loaders for real datasets are
not ported yet: ``load_data`` raises for a non-empty ``data_dir``.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Iterator, Sequence

import numpy as np

from sparse_vision_tpu_torch.config import NUM_CLASSES, RunConfig, get_img_size


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

    def batches(self, batch_size: int, shuffle: bool, seed: int = 0) -> Iterator[Batch]:
        n = len(self)
        order = (
            np.random.default_rng(seed).permutation(n) if shuffle else np.arange(n)
        ).astype(np.int32)
        for b in range(n // batch_size):  # drop_last=True
            idx = order[b * batch_size : (b + 1) * batch_size]
            yield Batch(self.images[idx], self.labels[idx], idx)


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


def load_data(cfg: RunConfig):
    """Returns (train_ds, val_ds, category_names, img_size): the synthetic
    stand-in (512 train / 256 val images at the dataset's size)."""
    name = cfg.dataset_name
    if cfg.data_dir and name != "synthetic":
        raise NotImplementedError(
            f"data_dir={cfg.data_dir!r}: loaders for real datasets are not ported; "
            "leave data_dir empty for the synthetic stand-in")
    size = get_img_size(name)
    train = make_synthetic(seed=cfg.seed, img_size=size, num_classes=NUM_CLASSES[name])
    val = make_synthetic(num_samples=256, seed=cfg.seed + 1, img_size=size,
                         num_classes=NUM_CLASSES[name])
    return train, val, train.category_names, size
