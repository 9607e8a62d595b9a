"""Loss functions (port of sparse_vision_tpu/ops/losses.py: the sae_mlp, gated,
JumpReLU and Matryoshka terms).

Reference semantics: SparseLoss / compute_rmse_nrmse (losses/sparse_loss.py:4-61),
total-loss assembly (utils.py:2467-2475), CustomCrossEntropyLoss (utils.py:99-125).
"""

from __future__ import annotations

import torch
import torch.nn.functional as F


def rmse_nrmse(decoded: torch.Tensor, targets: torch.Tensor):
    """Per-dimension RMSE over the batch axis, and range-normalized NRMSE.
    Dimensions constant across the batch (range 0) are excluded from the NRMSE
    mean, so the metric stays finite once units die."""
    sample_range = targets.amax(0) - targets.amin(0)  # in the targets' dtype
    return _rmse_nrmse(torch.square(decoded - targets).mean(0), sample_range)


def rmse_nrmse_global(decoded: torch.Tensor, targets: torch.Tensor, mesh):
    """rmse_nrmse over the global batch of ``mesh``'s 'data' axis, each rank
    holding its token rows (the JAX package's TP twins): the per-dimension MSE
    pmean'd, the range from the global max and min (the max as −pmin(−max),
    in one all_reduce). Gradients stopped."""
    decoded, targets = decoded.detach(), targets.detach()
    sample_mse = mesh.pmean(torch.square(decoded - targets).mean(0), "data")
    c = targets.shape[1]
    lows = mesh.pmin(torch.cat([-targets.amax(0), targets.amin(0)]).float(), "data")
    # the extremes are values of targets' dtype: the range is taken in it
    return _rmse_nrmse(sample_mse, (-lows[:c]).to(targets.dtype) - lows[c:].to(targets.dtype))


def _rmse_nrmse(sample_mse: torch.Tensor, sample_range: torch.Tensor):
    sample_rmse = torch.sqrt(sample_mse)
    valid = sample_range > 0
    one = torch.ones((), dtype=sample_range.dtype, device=sample_range.device)
    ratio = sample_rmse / torch.where(valid, sample_range, one)
    nrmse = torch.where(valid, ratio, torch.zeros_like(ratio)).sum() / valid.sum().clamp(min=1)
    return sample_rmse.mean(), nrmse


def sae_loss_terms(encoded: torch.Tensor, decoded: torch.Tensor,
                   targets: torch.Tensor, lambda_sparse: float) -> dict:
    """ReLU-SAE loss: MSE reconstruction + mean|encoded| L1, plus RMSE/NRMSE.
    total = rec + lambda * l1 (reference utils.py:2467-2470)."""
    rec = torch.square(decoded - targets).mean()
    l1 = encoded.abs().mean()
    rmse, nrmse = rmse_nrmse(decoded, targets)
    return {
        "loss": rec + lambda_sparse * l1,
        "rec_loss": rec,
        "l1_loss": l1,
        "nrmse_loss": nrmse,
        "rmse_loss": rmse,
        "aux_loss": torch.zeros((), dtype=decoded.dtype, device=decoded.device),
    }


def matryoshka_loss_terms(encoded: torch.Tensor, prefix_recons: list,
                          targets: torch.Tensor, lambda_sparse: float) -> dict:
    """Matryoshka-SAE loss (Bussmann et al. 2024): the mean over the latent-prefix
    reconstructions of their MSE + λ·mean|encoded|. ``rec_loss`` is the
    full-dictionary MSE and ``aux_loss`` = prefix mean − rec (it may be
    negative), so loss = rec + λ·l1 + aux still holds."""
    full = prefix_recons[-1]
    rec = torch.square(full - targets).mean()
    prefix_mean = sum(torch.square(r - targets).mean() for r in prefix_recons) / len(
        prefix_recons)
    l1 = encoded.abs().mean()
    rmse, nrmse = rmse_nrmse(full, targets)
    return {
        "loss": prefix_mean + lambda_sparse * l1,
        "rec_loss": rec,
        "l1_loss": l1,
        "nrmse_loss": nrmse,
        "rmse_loss": rmse,
        "aux_loss": prefix_mean - rec,
    }


def gated_sae_loss_terms(relu_pi_gate: torch.Tensor, via_gate: torch.Tensor,
                         decoded: torch.Tensor, targets: torch.Tensor,
                         lambda_sparse: float) -> dict:
    """Gated-SAE loss (Rajamanoharan et al.): rec + λ·mean|relu(pi_gate)| + aux,
    where aux is the MSE of ``via_gate`` (relu(pi_gate) through the frozen
    decoder) against the targets (reference losses/sparse_loss.py:64-75)."""
    rec = torch.square(decoded - targets).mean()
    l1 = relu_pi_gate.abs().mean()
    aux = torch.square(via_gate - targets).mean()
    rmse, nrmse = rmse_nrmse(decoded, targets)
    return {
        "loss": rec + lambda_sparse * l1 + aux,
        "rec_loss": rec,
        "l1_loss": l1,
        "nrmse_loss": nrmse,
        "rmse_loss": rmse,
        "aux_loss": aux,
    }


def jumprelu_loss_terms(encoded: torch.Tensor, decoded: torch.Tensor,
                        targets: torch.Tensor, pre: torch.Tensor,
                        log_threshold: torch.Tensor, lambda_sparse: float,
                        bandwidth: float = 1e-3) -> dict:
    """JumpReLU-SAE loss: MSE reconstruction + λ·L0, the L0 gradient reaching the
    thresholds through the STE (models/sae.jumprelu_l0). ``l1_loss`` is a metric
    for the shared results schema and does not enter the loss."""
    from sparse_vision_tpu_torch.models.sae import jumprelu_l0

    rec = torch.square(decoded - targets).mean()
    l0 = jumprelu_l0(pre, torch.exp(log_threshold), bandwidth)
    rmse, nrmse = rmse_nrmse(decoded, targets)
    return {
        "loss": rec + lambda_sparse * l0,
        "rec_loss": rec,
        "l0_loss": l0,
        "l1_loss": encoded.abs().mean(),
        "nrmse_loss": nrmse,
        "rmse_loss": rmse,
        "aux_loss": torch.zeros((), dtype=decoded.dtype, device=decoded.device),
    }


def cross_entropy(logits: torch.Tensor, targets: torch.Tensor) -> torch.Tensor:
    """Mean softmax cross-entropy over integer labels (torch nn.CrossEntropyLoss)."""
    return F.cross_entropy(logits, targets.long())


def negative_log_likelihood(probs: torch.Tensor, targets: torch.Tensor) -> torch.Tensor:
    """NLL over already-softmaxed outputs: -log(p[target] + 1e-40), averaged."""
    p = probs.gather(-1, targets.long()[:, None])[:, 0]
    return (-torch.log(p + 1e-40)).mean()


def get_criterion(name: str):
    """Criterion factory (reference utils.py:127-137)."""
    if name == "cross_entropy":
        return cross_entropy
    if name == "negative_log_likelihood":
        return negative_log_likelihood
    raise ValueError(f"Unsupported criterion: {name}")
