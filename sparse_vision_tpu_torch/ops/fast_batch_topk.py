"""Batch-level TopK: the fast train path and the exact cutoff (port of
sparse_vision_tpu/ops/fast_batch_topk.py).

BatchTopK training keeps the n = T·k largest pre-activations of the whole
[T, H] batch. The JAX package selects them with a cutoff mask, ``pre >=
kth_largest(pre, n)``, because lax.top_k is a full sort on the TPU and its
radix bisection is not. On CUDA ``torch.topk`` is a radix select, and an H100
ran the index selection (topk, scatter into the code, a gather in the
backward) faster than any cutoff-mask form, whose [T, H] mask and masked
backward cost more than the n-entry scatter saves (PERF.md §6). So the
fast path here selects by index, as the stock path does, and takes what the
fused steps read from the n selected entries instead of [T, H] passes: the
activity counts from their indices, the L1 term (only reported: the TopK
recipe has none in the loss) and the threshold EMA's observation from their
values. Under ties at the n-th value it keeps exactly n entries, where JAX's
mask keeps every tied one.

``kth_largest`` is the exact cutoff that the threshold calibration
(models/sae.calibrate_batch_topk_threshold) reads: one ``torch.topk`` over
int32 keys in the IEEE-754 total order, so the result is JAX's bit pattern,
ties and ±0 included. Non-negative floats keep their bits, negative floats
flip every bit but the sign (so -0.0 sorts just below +0.0). These are the JAX
package's uint32 keys with the sign bit flipped, carried as int32 because most
uint32 ops are missing on CUDA.

Data parallel (a ``mesh`` whose 'data' axis has more than one rank): each rank
holds a token shard and the selection is the GLOBAL batch's. The cutoff is
``kth_largest_sharded``, JAX's radix bisection on the same keys with each of
its 32 counts psummed over 'data' (32 scalar all_reduces, no candidate
gathering), and each rank keeps its entries at or above it, as the JAX
package's sharded step does (ties at the cutoff all kept); the threshold
observation is the least positive kept value over the ranks (a pmin).
"""

from __future__ import annotations

import torch

from sparse_vision_tpu_torch.ops import losses

_LOW31 = 0x7FFFFFFF  # every bit but the sign


def ordered_keys(x: torch.Tensor) -> torch.Tensor:
    """f32 -> int32 keys in the same total order (NaN excluded by contract)."""
    if x.dtype != torch.float32:
        raise TypeError(f"ordered keys are defined on f32, got {x.dtype}")
    b = x.contiguous().view(torch.int32)
    return torch.where(b < 0, b ^ _LOW31, b)


def kth_largest(flat: torch.Tensor, n: int) -> torch.Tensor:
    """The exact ``n``-th largest element of the 1-D f32 ``flat``, as a 0-d f32
    tensor on its device, without a gradient: the least of the ``n`` largest
    ordered keys, mapped back to its float."""
    keys = ordered_keys(flat.detach())
    key = torch.topk(keys, n, sorted=False).values.min()
    return torch.where(key < 0, key ^ _LOW31, key).view(torch.float32)


def kth_largest_sharded(flat: torch.Tensor, n: int, mesh) -> torch.Tensor:
    """The exact ``n``-th largest element over every rank's 1-D f32 ``flat``
    along the mesh's 'data' axis: radix bisection MSB-first on the unsigned
    order of the int32 keys (u = key + 2^31), bit b kept when at least n
    entries over the ranks lie at or above the prefix with it; each count is
    an all_reduce. A 0-d f32 tensor, the same on every rank."""
    keys = ordered_keys(flat.detach())
    prefix = torch.zeros((), dtype=torch.int64, device=flat.device)
    for b in range(31, -1, -1):
        cand = prefix | (1 << b)
        count = (keys >= (cand - 2 ** 31).to(torch.int32)).sum()
        prefix = torch.where(mesh.psum(count, "data") >= n, cand, prefix)
    key = (prefix - 2 ** 31).to(torch.int32)
    return torch.where(key < 0, key ^ _LOW31, key).view(torch.float32)


def fast_batch_topk_sae_loss_terms(params: dict, x: torch.Tensor, lambda_sparse: float,
                                   expansion_factor: int, k: int, mesh=None) -> dict:
    """sae_inference_and_loss("batch_topk_sae", training=True) on token input
    [T, C], plus the statistics the fused steps read (dead, activity_freq,
    sparsity), all from the T·k selected entries (module docstring). No L1 in
    the loss; ``lambda_sparse`` is unused. Plain torch ops, the same on every
    device. With a data-parallel ``mesh``, ``x`` is the rank's shard and the
    selection is the global batch's (module docstring); the loss terms stay
    the shard's (the step pmeans them)."""
    del lambda_sparse
    t = x.shape[0]
    h = params["b_enc"].shape[0]
    if k > h:
        raise ValueError(f"sae_topk={k} exceeds the latent count {h}")
    pre = (x - params["b_dec"]) @ params["W_enc"] + params["b_enc"]
    sharded = mesh is not None and mesh.size("data") > 1
    if sharded:
        flat = pre.reshape(-1)
        cutoff = kth_largest_sharded(flat, t * mesh.size("data") * k, mesh)
        idx = torch.nonzero(flat.detach() >= cutoff).squeeze(1)
        vals = flat[idx]
    else:
        vals, idx = torch.topk(pre.reshape(-1), t * k, sorted=False)
    kept = torch.relu(vals)
    post = torch.zeros_like(pre).reshape(-1).scatter(0, idx, kept).reshape(pre.shape)
    recon = post @ params["W_dec"] + params["b_dec"]
    rec = torch.square(recon - x).mean()
    rmse, nrmse = losses.rmse_nrmse(recon.detach(), x)
    active = kept.detach() > 0
    # one slot past the last latent takes the selected values that are not positive
    act_count = torch.bincount(torch.where(active, idx % h, h), minlength=h + 1)[:h]
    # +inf where nothing positive is kept (a shard may keep nothing)
    mp = torch.cat([torch.where(active, kept.detach(), float("inf")),
                    vals.new_full((1,), float("inf"))]).min()
    if sharded:
        mp = mesh.pmin(mp, "data")
    return {
        "loss": rec,
        "rec_loss": rec,
        "l1_loss": kept.detach().sum() / (t * h),
        "nrmse_loss": nrmse,
        "rmse_loss": rmse,
        "aux_loss": torch.zeros((), dtype=x.dtype, device=x.device),
        "batch_topk_min_pos": torch.where(torch.isfinite(mp), mp, torch.zeros_like(mp)),
        "encoded": post,
        "encoded_pre": pre,
        "decoded": recon,
        "dead": act_count == 0,
        "activity_freq": act_count / t,
        "sparsity": active.sum() / (t * (h / expansion_factor)),
    }
