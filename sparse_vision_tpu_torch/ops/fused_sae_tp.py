"""Tensor-parallel fused SAE ops: the ReLU and gated SAEs' fused bodies on a
latent shard, for a (data, model) mesh (port of the ReLU and gated parts of
sparse_vision_tpu/ops/fused_sae_tp.py; the JumpReLU and Matryoshka TP ops are
not ported yet).

The split is JAX's, per rank (d = data index, k = model index; the rank holds
the token rows of its data index and the latents of its model index):
- forward: the UNCHANGED single-device forward entry point (ops/fused_sae.py,
  ops/fused_gated_sae.py: the coder bodies on CUDA, their plain versions on
  the CPU) runs on the shard, W_enc [C, H/m] and W_dec [H/m, C], and gives a
  PARTIAL reconstruction ``post_k @ W_dec_k + b_dec``. The full one is
  ``psum_model(recon_part) − (m−1)·b_dec`` (each rank added b_dec once), and
  the MSE comes after that psum. The gated op's second token-space output,
  via_gate, is assembled the same way.
- backward: the UNCHANGED backward entry point takes the full-reconstruction
  error, which every rank of a data index holds. dW_enc, db_enc and dW_dec
  are latent-local and need only the 'data' psum. db_dec is psummed over both
  axes, less the (m−1) extra direct terms Σ_T drecon that the kernel adds
  once per rank: ``direct = c_rec·Σ_T err`` in f32, JAX's cast point. The
  gated op's only direct term is Σ drecon: the aux path's decoder is frozen.
- the loss scalars are GLOBAL (pmean'd and psummed inside the op), so the
  gradients come out global: the step must not reduce them again.

Collectives per step: two all_reduces in the forward (over 'model': the
partial outputs, row_active and Σpost; over 'data': the activity counts, the
MSEs, the L1 sum and the mean row activity) and two in the backward (over
'data': the latent-local gradients and the direct term; over 'model':
db_dec), each of one concatenated f32 buffer.

The kernels are the single-device ops' bodies through wrappers of their own
(``KERNELS``), so their launches count apart from the single-device rows.
On CPU tensors the plain versions run, as in the single-device ops. A shard
whose H/m is not a multiple of 128 is zero-padded inside the ReLU op, as
ops/fused_sae.FusedSAEFunction pads; the gated op keeps the single-device
gated op's rule (H/m a multiple of 128 on the card).
"""

from __future__ import annotations

import torch

from sparse_vision_tpu_torch.ops import fused_gated_sae, fused_sae, losses
from sparse_vision_tpu_torch.ops.fused_sae import compute_dtype_of, padded_operands
from sparse_vision_tpu_torch.parallel.mesh import BOTH

_F32 = torch.float32


class _ReluForward(fused_sae._ForwardKernel):
    """svt_sae_fwd on a latent shard (the site of fused_sae_tp.py:65)."""

    name = "fused_sae_tp_fwd"


class _ReluBackward(fused_sae._BackwardKernel):
    """svt_sae_bwd on a latent shard (the site of fused_sae_tp.py:102)."""

    name = "fused_sae_tp_bwd"


class _GatedForward(fused_gated_sae._ForwardKernel):
    """svt_gated_fwd on a latent shard (the site of fused_sae_tp.py:275)."""

    name = "fused_gated_sae_tp_fwd"


class _GatedBackward(fused_gated_sae._BackwardKernel):
    """svt_gated_bwd on a latent shard (the site of fused_sae_tp.py:341)."""

    name = "fused_gated_sae_tp_bwd"


fwd_kernel = _ReluForward()
bwd_kernel = _ReluBackward()
gated_fwd_kernel = _GatedForward()
gated_bwd_kernel = _GatedBackward()
KERNELS = (fwd_kernel, bwd_kernel, gated_fwd_kernel, gated_bwd_kernel)


def _zero_if_none(g, like):
    return torch.zeros((), dtype=_F32, device=like.device) if g is None else g.float()


class FusedSAETPFunction(torch.autograd.Function):
    """(x [T/d, C], W_enc [C, H/m], b_enc [H/m], W_dec [H/m, C], b_dec [C]) ->
    (rec_loss, l1_loss, recon, act_count, row_active, mean_row_active): the
    counterpart of the JAX op's custom_vjp on ``mesh``. ``recon`` is the full
    reconstruction of the local tokens, ``act_count`` the global-batch count
    of each local latent, ``row_active`` each local token's count over every
    latent, ``mean_row_active`` its global mean; the statistics are
    non-differentiable and x is data."""

    @staticmethod
    def forward(ctx, x, w_enc, b_enc, w_dec, b_dec, compute_dtype, mesh):
        cd = compute_dtype
        t_l, c = x.shape
        h_l = b_enc.shape[0]  # the true shard width; the kernels run at padded_h
        m = mesh.size("model")
        t_g, h_g = t_l * mesh.size("data"), h_l * m
        we, be, wd = padded_operands(w_enc, b_enc, w_dec, cd)
        b_dec = b_dec.contiguous()
        x_cent, recon_part, act_count, row_active, l1_sum = fused_sae.fused_sae_forward(
            x.to(cd).contiguous(), we, be, wd, b_dec, kernel=fwd_kernel)
        recon, row_active, l1_sum = mesh.psum_many([recon_part, row_active, l1_sum], "model")
        recon = recon - (m - 1) * b_dec  # every rank's kernel added b_dec once
        err = recon - x
        act_count, sq, l1_sum, mean_rows = mesh.psum_many(
            [act_count[:h_l], err.square().mean(), l1_sum, row_active.mean()], "data")
        n_data = mesh.size("data")
        ctx.save_for_backward(x_cent, we, be, wd, err.to(cd), err.float().sum(0))
        ctx.dims = (t_g, h_g, h_l, m)
        ctx.mesh = mesh
        out = (sq / n_data, l1_sum / (t_g * h_g), recon, act_count, row_active,
               mean_rows / n_data)
        ctx.mark_non_differentiable(*out[2:])
        return out

    @staticmethod
    def backward(ctx, g_rec, g_l1, *_unused):
        x_cent, we, be, wd, err, err_sum = ctx.saved_tensors
        t_g, h_g, h_l, m = ctx.dims
        mesh = ctx.mesh
        c = x_cent.shape[1]
        # rec_loss = pmean_data(local mean): d/d recon_local = 2·err / (T_g·C)
        coeffs = torch.stack([_zero_if_none(g_rec, x_cent) * 2.0 / (t_g * c),
                              _zero_if_none(g_l1, x_cent) / (t_g * h_g)])
        dw_enc, db_enc, dw_dec, db_dec = fused_sae.fused_sae_backward(
            x_cent, we, be, wd, err, coeffs, kernel=bwd_kernel)
        if be.shape[0] != h_l:  # the padded latents' gradients are exactly zero
            dw_enc, db_enc, dw_dec = dw_enc[:, :h_l].contiguous(), db_enc[:h_l], dw_dec[:h_l]
        direct = coeffs[0] * err_sum
        dw_enc, db_enc, dw_dec, db_dec, direct = mesh.psum_many(
            [dw_enc, db_enc, dw_dec, db_dec, direct], "data")
        # the kernel adds the direct term once per rank: m times after the psum
        db_dec = mesh.psum(db_dec, "model") - (m - 1) * direct
        return None, dw_enc, db_enc, dw_dec, db_dec, None, None


class FusedGatedSAETPFunction(torch.autograd.Function):
    """(x [T/d, C], W_gate [C, H/m], b_gate, b_mag, r_mag [H/m], W_dec [H/m, C],
    b_dec [C]) -> (rec_loss, l1_loss, aux_loss, recon, act_count, row_active,
    mean_row_active), as FusedSAETPFunction, with the gated op's aux loss of
    via_gate assembled like recon."""

    @staticmethod
    def forward(ctx, x, w_gate, b_gate, b_mag, r_mag, w_dec, b_dec, compute_dtype, mesh):
        cd = compute_dtype
        t_l, _ = x.shape
        h_l = b_gate.shape[0]
        m = mesh.size("model")
        t_g, h_g = t_l * mesh.size("data"), h_l * m
        xc, wg, wd = x.to(cd).contiguous(), w_gate.to(cd).contiguous(), w_dec.to(cd).contiguous()
        b_gate, b_mag, b_dec = b_gate.contiguous(), b_mag.contiguous(), b_dec.contiguous()
        er = torch.exp(r_mag).float().contiguous()
        recon_p, via_p, act_count, row_active, l1_sum = fused_gated_sae.fused_gated_forward(
            xc, wg, b_gate, b_mag, er, wd, b_dec, kernel=gated_fwd_kernel)
        recon, via, row_active, l1_sum = mesh.psum_many(
            [recon_p, via_p, row_active, l1_sum], "model")
        recon = recon - (m - 1) * b_dec
        via = via - (m - 1) * b_dec
        err_rec = recon - x  # f32, against x in its own dtype
        err_via = via - x
        act_count, sq, sq_via, l1_sum, mean_rows = mesh.psum_many(
            [act_count, err_rec.square().mean(), err_via.square().mean(), l1_sum,
             row_active.mean()], "data")
        n_data = mesh.size("data")
        ctx.save_for_backward(xc, wg, b_gate, b_mag, er, wd, b_dec, err_rec, err_via)
        ctx.dims = (t_g, h_g, m)
        ctx.mesh = mesh
        out = (sq / n_data, l1_sum / (t_g * h_g), sq_via / n_data, recon, act_count,
               row_active, mean_rows / n_data)
        ctx.mark_non_differentiable(*out[3:])
        return out

    @staticmethod
    def backward(ctx, g_rec, g_l1, g_aux, *_unused):
        xc, wg, b_gate, b_mag, er, wd, b_dec, err_rec, err_via = ctx.saved_tensors
        t_g, h_g, m = ctx.dims
        mesh = ctx.mesh
        c = xc.shape[1]
        coeffs = torch.stack([_zero_if_none(g_rec, xc) * 2.0 / (t_g * c),
                              _zero_if_none(g_l1, xc) / (t_g * h_g),
                              _zero_if_none(g_aux, xc) * 2.0 / (t_g * c)])
        grads = fused_gated_sae.fused_gated_backward(
            xc, wg, b_gate, b_mag, er, wd, b_dec, err_rec, err_via, coeffs,
            kernel=gated_bwd_kernel)
        # via contributes no direct term: its decoder and bias are frozen
        direct = coeffs[0] * err_rec.sum(0)
        dw_gate, db_gate, db_mag, dr_mag, dw_dec, db_dec, direct = mesh.psum_many(
            [*grads, direct], "data")
        db_dec = mesh.psum(db_dec, "model") - (m - 1) * direct
        return None, dw_gate, db_gate, db_mag, dr_mag, dw_dec, db_dec, None, None


def _loss_terms(x, rec_loss, l1_loss, aux_loss, lambda_sparse, recon, act_count,
                mean_rows, h_g: int, t_g: int, expansion_factor: int) -> dict:
    rmse, nrmse = losses.rmse_nrmse(recon, x)
    return {
        "loss": rec_loss + lambda_sparse * l1_loss + aux_loss,
        "rec_loss": rec_loss,
        "l1_loss": l1_loss,
        "nrmse_loss": nrmse,
        "rmse_loss": rmse,
        "aux_loss": aux_loss,
        "decoded": recon,
        "dead": act_count == 0,
        "activity_freq": act_count / t_g,
        "sparsity": mean_rows / (h_g / expansion_factor),
    }


def fused_sae_tp_loss_terms(params: dict, x: torch.Tensor, lambda_sparse: float,
                            expansion_factor: int, mesh, *, compute_dtype=torch.bfloat16) -> dict:
    """The TP counterpart of ops/fused_sae.fused_sae_loss_terms on the rank's
    shard (``params`` the latent shard, ``x`` the local token rows): GLOBAL
    rec_loss, l1_loss (loss = rec + λ·l1) and ``sparsity``; ``dead`` and
    ``activity_freq`` over the local latents and the global batch; ``decoded``
    the full reconstruction of the local tokens; rmse and nrmse local."""
    cd = compute_dtype_of(compute_dtype)
    rec_loss, l1_loss, recon, act_count, _, mean_rows = FusedSAETPFunction.apply(
        x, params["W_enc"], params["b_enc"], params["W_dec"], params["b_dec"], cd, mesh)
    zero = torch.zeros((), dtype=_F32, device=x.device)
    return _loss_terms(x, rec_loss, l1_loss, zero, lambda_sparse, recon, act_count, mean_rows,
                       params["b_enc"].shape[0] * mesh.size("model"),
                       x.shape[0] * mesh.size("data"), expansion_factor)


def fused_gated_sae_tp_loss_terms(params: dict, x: torch.Tensor, lambda_sparse: float,
                                  expansion_factor: int, mesh, *,
                                  compute_dtype=torch.bfloat16) -> dict:
    """The TP counterpart of ops/fused_gated_sae.fused_gated_sae_loss_terms
    (loss = rec + λ·l1 + aux), with fused_sae_tp_loss_terms' contract."""
    cd = compute_dtype_of(compute_dtype)
    rec_loss, l1_loss, aux_loss, recon, act_count, _, mean_rows = \
        FusedGatedSAETPFunction.apply(
            x, params["W_gate"], params["b_gate"], params["b_mag"], params["r_mag"],
            params["W_dec"], params["b_dec"], cd, mesh)
    return _loss_terms(x, rec_loss, l1_loss, aux_loss, lambda_sparse, recon, act_count,
                       mean_rows, params["b_gate"].shape[0] * mesh.size("model"),
                       x.shape[0] * mesh.size("data"), expansion_factor)
