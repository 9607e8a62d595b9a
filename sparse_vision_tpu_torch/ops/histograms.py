"""Streaming per-unit activation histograms (port of
sparse_vision_tpu/ops/histograms.py).

Each unit has fixed bins over [min, max], chosen once from the eval's recorded
extrema, so the bins are the same for every batch. A batch's update keeps
torch.histc's semantics per unit: uniform bins over [min, max], a value equal
to max in the last bin, out-of-range values dropped, and a unit whose span is
zero counts its in-range values in bin 0. The update is one bucketize and one
scatter-add over all units, on the device of the activations.
"""

from __future__ import annotations

import math
import os
from typing import NamedTuple

import numpy as np
import torch


class HistogramState(NamedTuple):
    counts: torch.Tensor  # [num_bins, U] float32: integer counts, exact below 2^24
    mins: torch.Tensor  # [U] lower edge per unit (fixed across batches)
    maxs: torch.Tensor  # [U] upper edge per unit


def init_histogram(num_bins: int, mins: torch.Tensor, maxs: torch.Tensor) -> HistogramState:
    counts = torch.zeros((num_bins, mins.shape[0]), dtype=torch.float32, device=mins.device)
    return HistogramState(counts, mins, maxs)


def update_histogram(state: HistogramState, acts: torch.Tensor) -> HistogramState:
    """Accumulate one batch of activations [B, U]. The bin index is taken only
    where the value lies in [min, max]; elsewhere, and where the position is
    NaN (an infinite extremum: inf · 0), it is 0, as the JAX package's cast
    gives, with a zero weight for the out-of-range values."""
    num_bins = state.counts.shape[0]
    mins, maxs = state.mins[None, :], state.maxs[None, :]
    span = state.maxs - state.mins
    scale = torch.where(span > 0, num_bins / torch.where(span > 0, span, 1.0), 0.0)
    valid = (acts >= mins) & (acts <= maxs)
    pos = torch.where(valid, (acts - mins) * scale[None, :], 0.0)
    # x == max lands in the last bin; clamping before the cast keeps it defined
    idx = torch.nan_to_num(pos, nan=0.0).clamp(0, num_bins - 1).floor().long()
    units = torch.arange(acts.shape[1], device=acts.device).expand_as(idx)
    counts = state.counts.clone()
    counts.index_put_((idx.reshape(-1), units.reshape(-1)), valid.reshape(-1).float(),
                      accumulate=True)
    return HistogramState(counts, state.mins, state.maxs)


def bin_edges(state: HistogramState, unit: int) -> np.ndarray:
    """The unit's num_bins + 1 edges, for plotting."""
    num_bins = state.counts.shape[0]
    return np.linspace(float(state.mins[unit]), float(state.maxs[unit]), num_bins + 1)


def plot_histograms(state: HistogramState, neuron_indices, path: str, title: str) -> str:
    """A grid of per-unit histograms, one filled stairs outline a unit, at the
    JAX figure's pixel size (18 x 12 in at 150 dpi), drawn with
    eval_tools/draw.py."""
    from sparse_vision_tpu_torch.eval_tools.draw import Figure

    num_units = state.counts.shape[1]
    cols = math.ceil(math.sqrt(num_units))
    rows = math.ceil(num_units / cols)
    fig = Figure((18, 12), dpi=150)
    fig.title(title)
    counts = state.counts.cpu().numpy()
    for i, ax in enumerate(fig.grid(rows, cols)[:num_units]):
        edges = bin_edges(state, i)
        ax.axes(f"Neuron {neuron_indices[i]}", "Activation value", "No. of samples",
                (edges[0], edges[-1]), (0.0, max(float(counts[:, i].max()), 1.0)))
        ax.stairs(counts[:, i], edges)
    os.makedirs(os.path.dirname(path) or ".", exist_ok=True)
    return fig.save(path)
