"""Evaluation metrics (port of sparse_vision_tpu/ops/metrics.py).

Layout convention: conv activations are NHWC ``[B, H, W, C]``, as in the JAX
package. Parity targets: average_over_W_H utils.py:1996-2010, variance_explained
utils.py:2012-2030 (torch.var default ddof=1), measure_inactive_units
utils.py:2032-2069, KLD / %same / loss-diff model_pipeline.py:690-714.
"""

from __future__ import annotations

import torch


def spatial_mean(x: torch.Tensor) -> torch.Tensor:
    """Average over H, W if 4-D NHWC; over the token axis if 3-D; identity if 2-D."""
    if x.ndim == 4:
        return x.mean(dim=(1, 2))
    if x.ndim == 3:
        return x.mean(dim=1)
    if x.ndim == 2:
        return x
    raise ValueError(f"Unexpected rank {x.ndim}")


def variance_explained(x: torch.Tensor, recon: torch.Tensor) -> torch.Tensor:
    """1 - Var(recon)/Var(x): 4-D variance over (H, W) per (batch, channel); 3-D
    over the token axis; 2-D over units per sample; then the mean. ddof=1."""
    if x.ndim == 4:
        dims = (1, 2)
    elif x.ndim in (2, 3):
        dims = (1,)
    else:
        raise ValueError(f"Unexpected rank {x.ndim}")
    var = torch.var(x, dim=dims, correction=1).mean()
    mod_var = torch.var(recon, dim=dims, correction=1).mean()
    return 1.0 - mod_var / var


def measure_inactive_units(x: torch.Tensor, expansion_factor: int):
    """Dead-unit / sparsity statistics for one batch. A unit is inactive for a
    sample iff its activation is exactly zero everywhere spatially. Returns
    (batch_dead_units bool [U], batch_sparsity scalar, activity_freq [U])."""
    zero = x == 0
    if x.ndim == 4:
        sample_inactive = zero.all(dim=2).all(dim=1)  # [B, C]
    elif x.ndim == 3:
        sample_inactive = zero.all(dim=1)
    elif x.ndim == 2:
        sample_inactive = zero
    else:
        raise ValueError(f"Unexpected rank {x.ndim}")
    num_units = sample_inactive.shape[1]
    batch_dead_units = sample_inactive.all(dim=0)
    activity_freq = 1.0 - sample_inactive.float().mean(0)
    n_active = num_units - sample_inactive.sum(1)
    batch_sparsity = (n_active / (num_units / expansion_factor)).mean()
    return batch_dead_units, batch_sparsity, activity_freq


def perc_dead(dead_units: torch.Tensor) -> torch.Tensor:
    """Fraction of dead units (reference utils.py:1206-1215)."""
    return dead_units.sum() / dead_units.shape[0]


def kld_original_vs_modified(logits_original: torch.Tensor,
                             logits_modified: torch.Tensor) -> torch.Tensor:
    """KL(modified || original) summed over classes, averaged over the batch
    (the reference's F.kl_div(log_softmax(orig), log_softmax(mod), 'sum',
    log_target=True) / batch_size)."""
    logp_orig = torch.log_softmax(logits_original, dim=1)
    logp_mod = torch.log_softmax(logits_modified, dim=1)
    kl = (torch.exp(logp_mod) * (logp_mod - logp_orig)).sum()
    return kl / logits_original.shape[0]


def perc_same_classification(logits_a: torch.Tensor, logits_b: torch.Tensor) -> torch.Tensor:
    """Fraction of samples where both models predict the same class."""
    return (logits_a.argmax(1) == logits_b.argmax(1)).float().mean()


def accuracy(logits: torch.Tensor, targets: torch.Tensor) -> torch.Tensor:
    return (logits.argmax(1) == targets).float().mean()


def update_dead_accumulator(acc, batch_dead: torch.Tensor) -> torch.Tensor:
    """Running AND across batches: dead iff dead in every batch seen so far."""
    if acc is None:
        return batch_dead
    return acc & batch_dead
