"""The per-unit top-k sample grids (port of the top-k part of
sparse_vision_tpu/eval_tools/viz.py), drawn with eval_tools/draw.py.

``gather_topk_images`` fetches the images behind a top-k state's dataset
indices through data/datasets.fetch_images (in-memory arrays, image files and
tar shards); ``show_top_k_samples`` draws one row per unit, each image titled
with its unit and activation value. ``feature_visualization``,
``show_classification_with_images`` and ``extract_images_from_tars`` are not
ported.
"""

from __future__ import annotations

from typing import Sequence

import numpy as np

DPI = 150  # the JAX figures' savefig dpi


def _to_display(img: np.ndarray) -> np.ndarray:
    """Any float image normalized to [0, 1] for display (all zeros when flat)."""
    img = np.asarray(img, np.float32)
    lo, hi = float(img.min()), float(img.max())
    if hi - lo < 1e-12:
        return np.zeros_like(img)
    return (img - lo) / (hi - lo)


def _shown_units(images_by_unit: dict, values_by_unit: dict) -> tuple:
    """(the units with at least one image, the images per row): a unit with
    fewer images than values (sentinels dropped by gather_topk_images) is
    bounded by the images present."""
    units = [u for u in images_by_unit if len(images_by_unit[u])]
    k = max((min(len(values_by_unit[u]), len(images_by_unit[u])) for u in units), default=0)
    return units, k


def topk_tile_boxes(images_by_unit: dict, values_by_unit: dict) -> dict:
    """Where show_top_k_samples pastes each tile: {(unit, column): (x, y,
    scale, stride)}, the tile being draw.tile_pixels(image[::stride,
    ::stride], scale) at pixel (x, y)."""
    from sparse_vision_tpu_torch.eval_tools.draw import TITLE_H, grid_boxes, tile_place

    units, k = _shown_units(images_by_unit, values_by_unit)
    if not units:  # the title-only figure
        return {}
    size = (int(2 * k * DPI), int(2.2 * len(units) * DPI))
    boxes = grid_boxes(size, TITLE_H, len(units), k)
    out = {}
    for r, u in enumerate(units):
        for c in range(min(len(values_by_unit[u]), len(images_by_unit[u]))):
            out[(u, c)] = tile_place(boxes[r * k + c], images_by_unit[u][c].shape)
    return out


def show_top_k_samples(images_by_unit: dict, values_by_unit: dict, path: str,
                       title: str = "Top-k activating samples") -> str:
    """One row per unit, its images titled ``u{unit}: {value:.3f}``, at the JAX
    figure's size (2k x 2.2 rows inches at 150 dpi). With no unit left (every
    one dead or sentinel-only) a title-only figure of matplotlib's default
    size (6.4 x 4.8 in)."""
    from sparse_vision_tpu_torch.eval_tools.draw import Figure

    units, k = _shown_units(images_by_unit, values_by_unit)
    if not units:
        fig = Figure((6.4, 4.8), DPI)
        fig.title(f"{title} (no activating samples)")
        return fig.save(path)
    fig = Figure((2 * k, 2.2 * len(units)), DPI)
    fig.title(title)
    panels = fig.grid(len(units), k)
    for r, u in enumerate(units):
        for c in range(min(len(values_by_unit[u]), len(images_by_unit[u]))):
            panels[r * k + c].image(images_by_unit[u][c],
                                    f"u{u}: {float(values_by_unit[u][c]):.3f}")
    return fig.save(path)


def gather_topk_images(dataset, topk_indices: np.ndarray, units: Sequence[int]) -> dict:
    """The images behind a top-k state's dataset indices [k, U] for ``units``:
    {unit: [n, H, W, C]}. Sentinel (-1) entries are dropped; a unit with no
    real entry (dead, or fewer samples than k) gets an empty [0, H, W, C]
    array. Any dataset kind that data/datasets.fetch_images reads."""
    from sparse_vision_tpu_torch.data.datasets import fetch_images

    sample = fetch_images(dataset, [0])[0]
    out = {}
    for u in units:
        idx = [int(i) for i in topk_indices[:, u] if int(i) >= 0]
        out[u] = (np.empty((0,) + sample.shape, sample.dtype) if not idx
                  else fetch_images(dataset, idx))
    return out
