"""Indirect-effect (IE) formulas on tensors (port of
sparse_vision_tpu/interp/ie_math.py).

Layout: NHWC activations, token matrices ``[T, C] = [B*H*W, C]``; dataset
averages are per-position ``[H, W, C]`` for conv taps, ``[N, C]`` per token
position, or ``[C]`` for 2-D taps.

- ie_channel_wise: ``ie[c] = mean_t |grad[t,c] * (avg[t,c] - act[t,c])|``
- ie_all_channels: ``ie = mean_t |sum_c grad[t,c] * (avg[t,c] - err[t,c])|``
"""

from __future__ import annotations

from typing import Optional

import torch


def broadcast_average(avg: torch.Tensor, batch_size: int) -> torch.Tensor:
    """Tile a per-position average over the batch and flatten to tokens:
    [H, W, C] -> [B*H*W, C], [N, C] -> [B*N, C]; [C] -> [1, C] (broadcasts
    against any [T, C])."""
    if avg.ndim in (2, 3):
        return avg.expand(batch_size, *avg.shape).reshape(-1, avg.shape[-1])
    if avg.ndim == 1:
        return avg[None, :]
    raise ValueError(f"Unexpected average rank {avg.ndim}")


def ie_channel_wise(act_tok: torch.Tensor, avg: torch.Tensor, grad_tok: torch.Tensor,
                    batch_size: int) -> torch.Tensor:
    """Per-channel IE: mean over tokens of ``|grad * (avg - act)|`` -> [C]."""
    avg_tok = broadcast_average(avg, batch_size)
    return torch.abs(grad_tok * (avg_tok - act_tok)).mean(0)


def ie_all_channels(act_tok: torch.Tensor, avg: torch.Tensor, grad_tok: torch.Tensor,
                    batch_size: int) -> torch.Tensor:
    """Single-node IE: per-token dot product over channels, abs, mean -> scalar."""
    avg_tok = broadcast_average(avg, batch_size)
    return torch.abs((grad_tok * (avg_tok - act_tok)).sum(-1)).mean()


def running_mean(old: Optional[torch.Tensor], new: torch.Tensor, n_old: int, n_new: int):
    """Sample-count-weighted running mean."""
    if old is None:
        return new
    return (old * n_old + new * n_new) / (n_old + n_new)
