"""Streaming per-unit top-k and bottom-k samples (port of
sparse_vision_tpu/ops/topk.py).

Per batch, the k most (or least) activating samples of every unit are merged
into a running state by concatenating and taking the top k again, with each
sample's dataset index and filename index carried along. The state has a fixed
shape from the first step: value, dataset-index and filename-index buffers of
[k, U], filled with -inf (largest) or +inf (smallest) and index -1. Once k
samples have been seen it holds real samples only; before that, rows with index
-1 are sentinels. The buffers stay on the device of the activations.

The selection is a stable descending sort along the sample axis, cut to k:
among equal values the lower position (the older sample) comes first, the
order ``jax.lax.top_k`` gives. ``torch.topk`` fixes no order for equal values,
and the code of a gated SAE, or a dead latent's, has many exact zeros.
"""

from __future__ import annotations

from dataclasses import dataclass

import torch


@dataclass
class TopKState:
    values: torch.Tensor  # [k, U] float
    dataset_indices: torch.Tensor  # [k, U] int32: the sample's index in the dataset
    filename_indices: torch.Tensor  # [k, U] int32
    largest: bool


def init_topk(k: int, num_units: int, largest: bool = True, device=None) -> TopKState:
    fill = -float("inf") if largest else float("inf")
    return TopKState(
        values=torch.full((k, num_units), fill, dtype=torch.float32, device=device),
        dataset_indices=torch.full((k, num_units), -1, dtype=torch.int32, device=device),
        filename_indices=torch.full((k, num_units), -1, dtype=torch.int32, device=device),
        largest=largest,
    )


def _select(largest: bool, k: int, vals, ds, fn) -> TopKState:
    sign = 1.0 if largest else -1.0
    top_vals, top_pos = torch.sort(sign * vals, dim=0, descending=True, stable=True)
    top_pos = top_pos[:k]  # [k, U]
    return TopKState(sign * top_vals[:k], torch.gather(ds, 0, top_pos),
                     torch.gather(fn, 0, top_pos), largest)


def update_topk(state: TopKState, batch_activations: torch.Tensor, batch_start_index: int,
                batch_filename_indices: torch.Tensor) -> TopKState:
    """Merge one batch of channel-averaged activations [B, U] into the state. A
    sample's dataset index is ``batch_start_index`` plus its position in the
    batch; ``batch_filename_indices`` [B] travel with it."""
    k = state.values.shape[0]
    b, u = batch_activations.shape
    dev = state.values.device
    ds = (batch_start_index + torch.arange(b, dtype=torch.int32, device=dev))[:, None]
    fn = batch_filename_indices.to(device=dev, dtype=torch.int32)[:, None]
    return _select(
        state.largest, k,
        torch.cat([state.values, batch_activations.to(state.values.dtype)], dim=0),
        torch.cat([state.dataset_indices, ds.expand(b, u)], dim=0),
        torch.cat([state.filename_indices, fn.expand(b, u)], dim=0))


def merge_topk_states(a: TopKState, b: TopKState) -> TopKState:
    """Merge two partial states of the same kind (associative)."""
    assert a.largest == b.largest
    return _select(a.largest, a.values.shape[0],
                   torch.cat([a.values, b.values], dim=0),
                   torch.cat([a.dataset_indices, b.dataset_indices], dim=0),
                   torch.cat([a.filename_indices, b.filename_indices], dim=0))
