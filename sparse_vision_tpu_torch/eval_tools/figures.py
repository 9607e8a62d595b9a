"""Analysis figures and the MIS adjustments (port of
sparse_vision_tpu/eval_tools/figures.py), drawn with eval_tools/draw.py at the
JAX figures' pixel sizes (150 dpi), with the ``csv`` module where the JAX
package reads the per-unit MIS CSV with pandas.

- IE distributions and node counts: ``plot_ie_histograms``,
  ``plot_node_count_vs_threshold``;
- MIS over epochs: ``plot_mis_over_epochs``;
- pixel- against channel-wise sparsity: ``plot_pixel_vs_channel_sparsity``;
- class counts of a dataset: ``class_counts``, ``plot_class_counts``;
- dead-unit- and reinit-adjusted MIS: ``mis_adjusted_for_dead_units``,
  ``adjusted_median_mis``, ``mis_adjusted_series``.
"""

from __future__ import annotations

import csv
import re
from typing import Mapping, Sequence

import numpy as np

from sparse_vision_tpu_torch.eval_tools.draw import COLORS, Figure

DPI = 150


def plot_ie_histograms(node_features: Mapping[str, np.ndarray], path: str) -> str:
    """Per-layer histograms of |node IE| (100 bins, log counts) with the
    median marked."""
    layers = list(node_features)
    cols = min(4, len(layers))
    rows = (len(layers) + cols - 1) // cols
    fig = Figure((5 * cols, 4 * rows), DPI)
    fig.title("|node IE| per SAE feature")
    for ax, name in zip(fig.grid(rows, cols), layers):
        vals = np.abs(np.asarray(node_features[name], np.float64))
        counts, edges = np.histogram(vals, bins=100)
        med = float(np.median(vals))
        ax.axes(name, "", "", (edges[0], edges[-1]), (0.5, max(float(counts.max()), 1.0)),
                ylog=True)
        ax.bars(edges[:-1], counts, np.diff(edges), fill="dodgerblue")
        ax.vline(med)
        ax.legend([(f"median={med:.2e}", "red")])
    return fig.save(path)


def plot_node_count_vs_threshold(node_features: Mapping[str, np.ndarray],
                                 thresholds: Sequence[float], path: str) -> str:
    """The number of circuit nodes above each IE threshold, per layer and in
    total, on a log threshold axis."""
    series = {name: [int(np.sum(np.abs(np.asarray(v)) > t)) for t in thresholds]
              for name, v in node_features.items()}
    total = np.sum([np.asarray(c) for c in series.values()], axis=0) if series else \
        np.zeros(len(thresholds))
    fig = Figure((8, 5), DPI)
    ax = fig.grid(1, 1)[0]
    ax.axes("", "IE threshold", "nodes above threshold", (min(thresholds), max(thresholds)),
            (0.0, max(float(np.max(total, initial=0)), 1.0)), xlog=True)
    legend = []
    for i, (name, counts) in enumerate(series.items()):
        ax.line(thresholds, counts, fill=COLORS[i % len(COLORS)], marker=True)
        legend.append((name, COLORS[i % len(COLORS)]))
    ax.line(thresholds, total, fill="black", marker=True, dashed=True)
    ax.legend(legend + [("total", "black")])
    return fig.save(path)


def _epoch_lines(path: str, series: Mapping[str, Mapping[int, float]], ylabel: str,
                 baseline: tuple | None = None) -> str:
    """One line with markers per series over its sorted epochs (8 x 5 in),
    and an optional dashed horizontal ``baseline`` (value, label)."""
    points = [(e, float(s[e])) for s in series.values() for e in s]
    ys = [y for _, y in points] + ([baseline[0]] if baseline is not None else [])
    xs = [e for e, _ in points]
    fig = Figure((8, 5), DPI)
    ax = fig.grid(1, 1)[0]
    ax.axes("", "epoch", ylabel, (min(xs, default=0), max(xs, default=1)),
            (min(ys, default=0.0), max(ys, default=1.0)))
    legend = []
    for i, (label, s) in enumerate(series.items()):
        epochs = sorted(s)
        color = COLORS[i % len(COLORS)]
        ax.line(epochs, [s[e] for e in epochs], fill=color, marker=True)
        legend.append((label, color))
    if baseline is not None:
        ax.hline(baseline[0])
        legend.append((baseline[1], "gray"))
    ax.legend(legend)
    return fig.save(path)


def plot_mis_over_epochs(mis_by_config: Mapping[str, Mapping[int, float]], path: str,
                         baseline: float | None = None,
                         baseline_label: str = "original layer") -> str:
    """Median MIS per epoch, one line per configuration, with an optional
    horizontal baseline."""
    return _epoch_lines(path, mis_by_config, "median MIS",
                        None if baseline is None else (baseline, baseline_label))


def plot_pixel_vs_channel_sparsity(pixel_sparsity: Mapping[int, float],
                                   channel_sparsity: Mapping[int, float], path: str) -> str:
    """Pixel-wise against channel-wise sparsity over epochs."""
    return _epoch_lines(path, {"pixel-wise": pixel_sparsity,
                               "channel-wise": channel_sparsity}, "sparsity")


def _load_mis_rows(mis_csv, layer_name: str | None) -> list:
    """The per-unit MIS CSV's rows (a path, or rows already read), kept where
    ``layer_name`` matches the row's layer_name as a regular expression and
    "bottleneck" does not, as the JAX package filters its frame."""
    if isinstance(mis_csv, str):
        with open(mis_csv, newline="") as f:
            rows = list(csv.DictReader(f))
    else:
        rows = list(mis_csv)
    if layer_name:
        rows = [r for r in rows if re.search(layer_name, str(r["layer_name"]))
                and "bottleneck" not in str(r["layer_name"])]
    return rows


def _confidence(rows: list) -> np.ndarray:
    """MIS_confidence as floats, an empty cell as NaN (pandas' reading)."""
    return np.asarray([float(r["MIS_confidence"]) if str(r["MIS_confidence"]).strip()
                       else np.nan for r in rows], np.float64)


def _as_positions(indices) -> np.ndarray:
    idx = np.asarray(indices)
    return np.flatnonzero(idx) if idx.dtype == bool else idx.astype(np.int64)


def _drop(conf: np.ndarray, positions: np.ndarray) -> np.ndarray:
    keep = np.ones(conf.shape[0], bool)
    keep[positions] = False
    return conf[keep]


def _mean(v: np.ndarray) -> float:
    """pandas' mean: NaN skipped, NaN when nothing is left."""
    v = v[~np.isnan(v)]
    return float(v.mean()) if v.size else float("nan")


def _median(v: np.ndarray) -> float:
    v = v[~np.isnan(v)]
    return float(np.median(v)) if v.size else float("nan")


def mis_adjusted_for_dead_units(mis_csv, dead_units, layer_name: str | None = None) -> dict:
    """Mean and median of MIS_confidence before removal, after dropping the
    dead units' rows and over the dead units alone. ``dead_units``: a bool
    mask or index array (the filename-indices npz's 'dead_units'); indices are
    positions within the layer-filtered rows."""
    conf = _confidence(_load_mis_rows(mis_csv, layer_name))
    dead = _as_positions(dead_units)
    dead_rows, alive_rows = conf[dead], _drop(conf, dead)
    return {
        "n_dead": int(len(dead)),
        "n_units": int(len(conf)),
        "average_before": _mean(conf),
        "median_before": _median(conf),
        "average_after": _mean(alive_rows) if len(alive_rows) else None,
        "median_after": _median(alive_rows) if len(alive_rows) else None,
        "average_dead": _mean(dead_rows) if len(dead_rows) else None,
        "median_dead": _median(dead_rows) if len(dead_rows) else None,
    }


def adjusted_median_mis(mis_csv, drop_indices, layer_name: str | None = None) -> float:
    """Median MIS_confidence after dropping the given units' rows."""
    conf = _confidence(_load_mis_rows(mis_csv, layer_name))
    return _median(_drop(conf, _as_positions(drop_indices)))


def mis_adjusted_series(mis_csvs: Mapping[int, str],
                        drop_indices_by_epoch: Mapping[int, np.ndarray],
                        layer_name: str | None = None) -> dict:
    """Per epoch, the median MIS after dropping that epoch's re-initialized
    (or dead) units; an epoch without indices keeps its plain median. Feed
    it to plot_mis_over_epochs."""
    out = {}
    for epoch, csv_path in mis_csvs.items():
        drop = drop_indices_by_epoch.get(epoch)
        out[epoch] = adjusted_median_mis(
            csv_path, drop if drop is not None else np.zeros(0, np.int64), layer_name)
    return out


def class_counts(labels: np.ndarray, num_classes: int) -> np.ndarray:
    """Per-class sample counts."""
    return np.bincount(np.asarray(labels, np.int64), minlength=num_classes)


def plot_class_counts(labels: np.ndarray, num_classes: int, path: str) -> str:
    counts = class_counts(labels, num_classes)
    fig = Figure((10, 4), DPI)
    ax = fig.grid(1, 1)[0]
    ax.axes("", "class", "count", (-0.5, num_classes - 0.5),
            (0.0, max(float(counts.max(initial=0)), 1.0)))
    ax.bars(np.arange(num_classes) - 0.4, counts, 0.8)
    return fig.save(path)
