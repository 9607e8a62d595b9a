"""TopK-SAE train path with a gather decode and statistics from the indices
(port of fast_topk_sae_loss_terms in sparse_vision_tpu/ops/fast_topk_sae.py;
its tensor-parallel op waits for the multi-rank port).

The stock TopK step scatters the selected values into a dense [T, H] code,
decodes it with a [T, H] x [H, C] product and reads the dead and frequency
statistics from [T, H] passes. With k << H only k latents per token are
non-zero, so here:
- decode: ``recon[t] = sum_j relu(vals[t, j]) * W_dec[idx[t, j]] + b_dec``,
  a [T, k, C] gather (GatherDecode) instead of the scatter and dense product;
- statistics: the activity counts from the [T·k] indices, the per-token L0
  from the [T, k] values;
- the L1 term is zero in the loss (the TopK recipe) and only reported.
The encode product stays dense. The selection is exact (``torch.topk``); the
JAX package's ``approx`` (lax.approx_max_k) is exact off the TPU, and the port
selects exactly for it as well. Plain torch ops, the same on every device.
"""

from __future__ import annotations

import torch

from sparse_vision_tpu_torch.ops.losses import rmse_nrmse


class GatherDecode(torch.autograd.Function):
    """``out[t] = sum_j act[t, j] * w[idx[t, j]]`` for act [T, k], idx [T, k]
    (int64) and w [H, C]. The [T, k, C] gather is recomputed in the backward
    rather than saved. d_act is the batched product of the gathered rows with
    the cotangent. dW accumulates ``act[t, j] * g[t]`` into row idx[t, j] with
    ``index_put_(accumulate=True)``, which on a CUDA tensor always runs
    PyTorch's sort-based kernel: the rows that share an index are summed in
    the order of their position, without float atomics, so a run repeats
    bitwise (torch's determinism notes list only the CPU kernel as
    nondeterministic)."""

    @staticmethod
    def forward(ctx, act, idx, w):
        ctx.save_for_backward(act, idx, w)
        return torch.bmm(act.unsqueeze(1), w[idx]).squeeze(1)

    @staticmethod
    def backward(ctx, g):
        act, idx, w = ctx.saved_tensors
        d_act = dw = None
        if ctx.needs_input_grad[0]:
            d_act = torch.bmm(w[idx], g.unsqueeze(2)).squeeze(2)
        if ctx.needs_input_grad[2]:
            contrib = (act.unsqueeze(2) * g.unsqueeze(1)).reshape(-1, w.shape[1])
            dw = torch.zeros_like(w).index_put_((idx.reshape(-1),), contrib.to(w.dtype),
                                                accumulate=True)
        return d_act, None, dw


def fast_topk_sae_loss_terms(params: dict, x: torch.Tensor, lambda_sparse: float,
                             expansion_factor: int, k: int, approx: bool = False) -> dict:
    """Loss terms and statistics of the TopK SAE on token input [T, C] with the
    fused ops' contract: loss, rec_loss, l1_loss (reported, not in the loss:
    ``lambda_sparse`` is unused), nrmse_loss, rmse_loss, aux_loss (0),
    decoded, dead, activity_freq, sparsity."""
    del lambda_sparse, approx
    t = x.shape[0]
    h = params["b_enc"].shape[0]
    if k > h:
        raise ValueError(f"sae_topk={k} exceeds the latent count {h}")
    pre = (x - params["b_dec"]) @ params["W_enc"] + params["b_enc"]
    vals, idx = torch.topk(pre, k, dim=-1)
    act = torch.relu(vals)
    recon = GatherDecode.apply(act, idx, params["W_dec"]) + params["b_dec"]
    rec = torch.square(recon - x).mean()
    # the mean |code| over the dense [T, H] code: only the kept values count
    l1 = act.sum() / (t * h)
    active = vals.detach() > 0
    # one slot past the last latent takes the selected values that are not positive
    act_count = torch.bincount(torch.where(active, idx, h).reshape(-1), minlength=h + 1)[:h]
    rmse, nrmse = rmse_nrmse(recon.detach(), x)
    return {
        "loss": rec,
        "rec_loss": rec,
        "l1_loss": l1,
        "nrmse_loss": nrmse,
        "rmse_loss": rmse,
        "aux_loss": torch.zeros((), dtype=x.dtype, device=x.device),
        "decoded": recon,
        "dead": act_count == 0,
        "activity_freq": act_count / t,
        "sparsity": (active.sum(1) / (h / expansion_factor)).mean(),
    }
