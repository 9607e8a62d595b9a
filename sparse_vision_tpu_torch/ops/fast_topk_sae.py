"""TopK-SAE train path with a gather decode and statistics from the indices,
on one rank and on a latent shard of a (data, model) mesh (port of
sparse_vision_tpu/ops/fast_topk_sae.py).

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

Under tensor parallelism (FastTopKTPFunction) the latents shard over 'model'
but the selection is global. It takes two stages and moves only candidates:
each rank takes its local top k of its [T/d, H/m] pre-activations, the
candidates of every shard (value, global index) are gathered over 'model'
(one mesh.gather, built from an all_reduce), and a second top k over the m·k
candidates gives the global top k. This is exact, since each global top-k
entry is among its shard's local top k. The indices travel as f32 in the
values' buffer, so one all_reduce carries both; an index below 2^24 is exact
in f32. On ties: JAX orders the candidates by shard, then local index, and
lax.top_k takes the lowest index first; torch.topk does not promise an order
among equal values, so a tie may select another latent. On the continuous f32
pre-activations of training, ties do not occur. Each rank then decodes only
the selected latents it owns (the others masked to 0) against its W_dec rows;
the partial reconstructions are psummed over 'model' and b_dec is added once.
The backward recomputes that owned decode and takes its vjp; the latent-local
gradients are psummed over 'data', and db_dec is the centring part psummed
over both axes plus the direct term c_rec·Σ_T err psummed over 'data'.
"""

from __future__ import annotations

import torch

from sparse_vision_tpu_torch.ops.fused_sae import compute_dtype_of
from sparse_vision_tpu_torch.ops.losses import rmse_nrmse

_F32 = torch.float32


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


def _pre(x, w_enc, b_enc, b_dec, cd):
    """The encode (x − b_dec) @ W_enc + b_enc, its operands rounded to ``cd``
    (None: as they are) and the products summed in f32: JAX's dot with
    preferred_element_type f32."""
    xc, we = x - b_dec, w_enc
    if cd is not None:
        xc, we = xc.to(cd).float(), we.to(cd).float()
    return xc @ we + b_enc


def _owned_decode(x, w_enc, b_enc, w_dec, b_dec, rows, own, cd):
    """The partial reconstruction of the selected latents this rank owns
    (``rows`` their local indices, 0 where not ``own``), their pre-activations
    recomputed and ReLU'd, the others 0; returns (recon_part, act)."""
    pre = _pre(x, w_enc, b_enc, b_dec, cd)
    act = torch.relu(torch.where(own, pre.gather(1, rows), torch.zeros((), device=x.device)))
    return GatherDecode.apply(act, rows, w_dec), act


class FastTopKTPFunction(torch.autograd.Function):
    """(x [T/d, C], W_enc [C, H/m], b_enc [H/m], W_dec [H/m, C], b_dec [C]) ->
    (rec_loss, l1_loss, recon, act_count, row_active, mean_row_active): the
    counterpart of the JAX op's custom_vjp (module docstring). rec_loss is
    global and the only differentiable output; ``act_count`` counts the global
    batch on the local latents, ``row_active`` each local token's active
    selections, ``mean_row_active`` its global mean; x is data."""

    @staticmethod
    def forward(ctx, x, w_enc, b_enc, w_dec, b_dec, k, compute_dtype, mesh):
        t_l, c = x.shape
        h_l = b_enc.shape[0]
        m, kk = mesh.size("model"), mesh.index("model")
        t_g, h_g = t_l * mesh.size("data"), h_l * m
        if h_g >= 2 ** 24:
            raise ValueError(f"{h_g} latents: the candidates' f32 indices are exact below 2^24")
        pre = _pre(x, w_enc, b_enc, b_dec, compute_dtype)
        vals, idx = torch.topk(pre, k, dim=1)
        # the m·k candidates of every token, in shard order: values, global indices
        cand = mesh.gather(torch.stack([vals, (idx + kk * h_l).float()]), 2)
        top_vals, pos = torch.topk(cand[0], k, dim=1)
        top_idx = cand[1].gather(1, pos).long()
        own = (top_idx // h_l) == kk
        rows = torch.where(own, top_idx - kk * h_l, 0)
        recon_part, act = _owned_decode(x, w_enc, b_enc, w_dec, b_dec, rows, own, compute_dtype)
        recon, l1_sum = mesh.psum_many([recon_part, act.sum()], "model")
        recon = recon + b_dec  # once: no rank's partial holds it
        err = recon - x
        positive = top_vals > 0
        # one slot past the last local latent takes the entries this rank does not count
        act_count = torch.bincount(torch.where(own & positive, rows, h_l).reshape(-1),
                                   minlength=h_l + 1)[:h_l].float()
        row_active = positive.sum(1).float()
        act_count, sq, l1_sum, mean_rows = mesh.psum_many(
            [act_count, err.square().mean(), l1_sum, row_active.mean()], "data")
        n_data = mesh.size("data")
        ctx.save_for_backward(x, w_enc, b_enc, w_dec, b_dec, rows, own, err)
        ctx.dims = (t_g, compute_dtype)
        ctx.mesh = mesh
        out = (sq / n_data, l1_sum / (t_g * h_g), recon, act_count, row_active,
               mean_rows / n_data)
        ctx.mark_non_differentiable(*out[1:])
        return out

    @staticmethod
    def backward(ctx, g_rec, *_unused):
        x, w_enc, b_enc, w_dec, b_dec, rows, own, err = ctx.saved_tensors
        t_g, cd = ctx.dims
        mesh = ctx.mesh
        zero = torch.zeros((), dtype=_F32, device=x.device)
        # rec_loss = pmean_data(local mean): d/d recon_local = 2·err / (T_g·C)
        c_rec = (zero if g_rec is None else g_rec.float()) * 2.0 / (t_g * x.shape[1])
        with torch.enable_grad():
            leaves = [t.detach().requires_grad_(True) for t in (w_enc, b_enc, w_dec, b_dec)]
            recon_part, _ = _owned_decode(x, *leaves, rows, own, cd)
            dw_enc, db_enc, dw_dec, db_cent = torch.autograd.grad(recon_part, leaves,
                                                                  c_rec * err)
        direct = c_rec * err.sum(0)  # the recon adds b_dec once
        dw_enc, db_enc, dw_dec, db_cent, direct = mesh.psum_many(
            [dw_enc, db_enc, dw_dec, db_cent, direct], "data")
        db_dec = mesh.psum(db_cent, "model") + direct
        return None, dw_enc, db_enc, dw_dec, db_dec, None, None, None


def fast_topk_sae_tp_loss_terms(params: dict, x: torch.Tensor, lambda_sparse: float,
                                expansion_factor: int, mesh, *, k: int = 32,
                                approx: bool = False, compute_dtype=None) -> dict:
    """The TP counterpart of fast_topk_sae_loss_terms on the rank's shard
    (``params`` the latent shard, ``x`` the local token rows; pure-MSE loss,
    the L1 reported only): GLOBAL rec_loss, l1_loss and ``sparsity``; ``dead``
    and ``activity_freq`` over the local latents and the global batch;
    ``decoded`` the full reconstruction of the local tokens; rmse and nrmse
    local. ``compute_dtype`` rounds the encode's operands (products summed in
    f32; None: f32 as they are); ``approx`` selects exactly, as on one rank."""
    del lambda_sparse, approx
    h_l = params["b_enc"].shape[0]
    h_g = h_l * mesh.size("model")
    if k > h_l:
        raise ValueError(
            f"sae_topk={k} exceeds the local latent shard {h_l}: the two-stage selection "
            f"needs k <= H/model_axis (H={h_g}, model={mesh.size('model')})")
    cd = None if compute_dtype is None else compute_dtype_of(compute_dtype)
    rec, l1, recon, act_count, _, mean_rows = FastTopKTPFunction.apply(
        x, params["W_enc"], params["b_enc"], params["W_dec"], params["b_dec"], k, cd, mesh)
    rmse, nrmse = rmse_nrmse(recon, x)
    return {
        "loss": rec,
        "rec_loss": rec,
        "l1_loss": l1,
        "nrmse_loss": nrmse,
        "rmse_loss": rmse,
        "aux_loss": torch.zeros((), dtype=x.dtype, device=x.device),
        "decoded": recon,
        "dead": act_count == 0,
        "activity_freq": act_count / (x.shape[0] * mesh.size("data")),
        "sparsity": mean_rows / (h_g / expansion_factor),
    }
