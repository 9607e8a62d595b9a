"""ImageNet label translation: PyTorch/torchvision class ids -> the old TF/GoogLeNet
convention (port of sparse_vision_tpu/data/labels.py).

Both conventions are wordnet-id lists (public label files, the port's own copies
in data/assets/). Translation maps a new-convention index to its wordnet id,
looks that id up in the old list, and adds 1 (old-convention GoogLeNet ids start
at 1). The table is a gather index, so a batch translates in one indexing op on
whatever device its labels are.
"""

from __future__ import annotations

import functools
import os

import torch

_ASSETS = os.path.join(os.path.dirname(__file__), "assets")


def _read_wids(path: str) -> list:
    with open(path, "r", encoding="utf-8") as f:
        return [line.split(" ")[0].strip() for line in f.read().strip().split("\n")]


@functools.lru_cache(maxsize=1)
def _table() -> tuple:
    old_wids = _read_wids(os.path.join(_ASSETS, "old_imagenet_labels.txt"))
    new_wids = _read_wids(os.path.join(_ASSETS, "imagenet_labels.txt"))
    old_index = {wid: i for i, wid in enumerate(old_wids)}
    return tuple(old_index.get(wid, -2) + 1 for wid in new_wids)  # missing -> -1


def torch_to_tf_label_table() -> torch.Tensor:
    """[1000]-entry int32 table: new-convention class id -> old-convention id (+1
    offset). Entries whose wordnet id is missing from the old list map to -1; both
    shipped lists cover all 1000 classes, so a -1 signals a mismatched label file."""
    return torch.tensor(_table(), dtype=torch.int32)


def remap_torch_to_tf_labels(labels: torch.Tensor) -> torch.Tensor:
    """The old-convention ids of ``labels``, int32, on their device."""
    return torch_to_tf_label_table().to(labels.device)[labels.long()]
