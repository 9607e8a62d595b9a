"""Fused crosscoder training op: L-layer encode + ReLU + L-layer decode +
per-layer MSE + decoder-norm-weighted L1 + dead-latent statistics, through the
kernels of csrc/fused_transcoder.cu (the coder bodies of csrc/coder.cuh).

Port of sparse_vision_tpu/ops/fused_crosscoder.py. The crosscoder reduces to one
transcoder-shaped kernel pair by concatenation and per-column scaling:

  x_cat [T, ΣC]  = concat_l x_l            W_enc_cat [ΣC, H] = concat rows
  recon_cat      = z·W_dec_cat·s + b_dec_cat·s,  y = x_cat·s
  s_c            = sqrt(ΣC / C_l)  for column c in layer l

so the plain concatenated mean mean_{T,ΣC}((s·err)²) is exactly the summed
per-layer MSE Σ_l mean_{T,C_l}(err²). The concat and the scale stay outside the
kernels in plain torch, so autograd routes the cat-space gradients back to the
flat per-layer parameters. The f32 kernels take any ΣC; the bf16 kernels read
rows by TMA, whose row strides are multiples of 16 bytes, so with bf16 operands
ΣC must be a multiple of 8 (2,896 = 8·362 for GoogLeNet mixed4a..mixed4e; every
GoogLeNet tap is), and TMA zero-fills the partial box at the edge, so no padding
is needed.

Two differences from the transcoder op (ops/fused_transcoder.py), both in the
L1 term:
  1. the forward returns per-latent sums zsum [H] = Σ_T z_j (the kernel's
     per-token-tile partials reduced here) as a differentiable output; the
     decoder-norm-weighted L1, l1 = zsum·n_j/(T·H) with n_j = Σ_l ‖W_dec_l[j]‖,
     is assembled outside, so the n_j → W_dec path is ordinary autograd;
  2. the backward takes zsum's cotangent, a per-latent vector, where the
     transcoder broadcasts its scalar c_l1.
The TPU kernel also emits per-latent partials (per token tile); here they are
per 64-token block, the same sums to f32 rounding.

Dispatch rule (ops/fused_sae.run_on_device): a CPU tensor runs the plain PyTorch
version of each kernel; a CUDA tensor launches the kernel or raises.

Cast points as ops/fused_transcoder.py, with c_rec = 2·g_rec/(T·ΣC). JAX's type
promotion is kept: a bf16 x_cat times the f32 scale gives an f32 target.

Differentiability contract: gradients flow through ``rec_loss`` and ``zsum``
into the parameters only; the inputs are data.

Tensor parallel (FusedCrosscoderTPFunction, fused_crosscoder_tp_loss_terms):
the same kernels through wrappers of their own (``TP_KERNELS``) on a rank's
latent shard of a (data, model) mesh, the JAX package's
make_fused_crosscoder_tp_op; the weighted L1 and its collectives live inside
that function.
"""

from __future__ import annotations

import torch

from sparse_vision_tpu_torch.models.crosscoder import crosscoder_num_layers
from sparse_vision_tpu_torch.ops import losses
from sparse_vision_tpu_torch.ops.fused_sae import (
    _F32,
    _BF16,
    Kernel,
    _expect,
    compute_dtype_of,
    run_on_device,
)
from sparse_vision_tpu_torch.ops.fused_sae import bodies_take as can_fuse  # no latent padding
from sparse_vision_tpu_torch.ops.fused_sae_tp import _zero_if_none
from sparse_vision_tpu_torch.ops.fused_transcoder import (
    coder_backward_launch,
    coder_backward_plain,
    coder_forward_launch,
    coder_forward_plain,
)

__all__ = ["can_fuse", "fused_crosscoder_loss_terms", "FusedCrosscoderFunction"]


def fused_crosscoder_forward_plain(x, w_enc, b_enc, w_dec, b_dec):
    """Plain forward in the cat space: (recon, act_count, row_active, zsum [H])."""
    return coder_forward_plain(x, w_enc, b_enc, w_dec, b_dec)


def fused_crosscoder_backward_plain(x, w_enc, b_enc, w_dec, err, coeffs, ct_zsum):
    """Plain backward in the cat space; ``coeffs`` = (c_rec,), ``ct_zsum`` [H] the
    per-latent L1 cotangent."""
    return coder_backward_plain(x, w_enc, b_enc, w_dec, err, coeffs[0], ct_zsum)


class _ForwardKernel(Kernel):
    """The coder forward (csrc/coder.cuh) for the crosscoder."""

    name = "fused_crosscoder_fwd"

    def __call__(self, x, w_enc, b_enc, w_dec, b_dec, n_split=None):
        return coder_forward_launch(self, x, w_enc, b_enc, w_dec, b_dec, n_split)


class _BackwardKernel(Kernel):
    """The coder backward (csrc/coder.cuh) for the crosscoder: the per-latent L1
    cotangent."""

    name = "fused_crosscoder_bwd"

    def __call__(self, x, w_enc, b_enc, w_dec, err, coeffs, ct_zsum, n_split=None):
        _expect("coeffs", coeffs, (1,), _F32, x.device)
        return coder_backward_launch(self, x, w_enc, b_enc, w_dec, err, coeffs, ct_zsum,
                                     n_split)


class _TPForwardKernel(_ForwardKernel):
    """The coder forward on a latent shard (the site of the JAX package's
    fused_crosscoder.py:399 in make_fused_crosscoder_tp_op :371; pallas_call
    :238)."""

    name = "fused_crosscoder_tp_fwd"


class _TPBackwardKernel(_BackwardKernel):
    """The coder backward on a latent shard (fused_crosscoder.py:450; pallas_call
    :274)."""

    name = "fused_crosscoder_tp_bwd"


fwd_kernel = _ForwardKernel()
bwd_kernel = _BackwardKernel()
KERNELS = (fwd_kernel, bwd_kernel)
tp_fwd_kernel = _TPForwardKernel()
tp_bwd_kernel = _TPBackwardKernel()
TP_KERNELS = (tp_fwd_kernel, tp_bwd_kernel)


def fused_crosscoder_forward(*args, kernel=fwd_kernel):
    """The forward kernel on CUDA tensors (through ``kernel``, whose count it
    adds to), its plain version on CPU tensors."""
    return run_on_device(kernel, fused_crosscoder_forward_plain, *args)


def fused_crosscoder_backward(*args, kernel=bwd_kernel):
    """The backward kernel on CUDA tensors (through ``kernel``), its plain
    version on CPU tensors."""
    return run_on_device(kernel, fused_crosscoder_backward_plain, *args)


class FusedCrosscoderFunction(torch.autograd.Function):
    """Cat-space (x, W_enc, b_enc, W_dec, b_dec, y) -> (rec_loss, zsum, recon,
    act_count, row_active), the counterpart of the JAX op's custom_vjp."""

    @staticmethod
    def forward(ctx, x, w_enc, b_enc, w_dec, b_dec, y, compute_dtype):
        cd = compute_dtype
        xc, we, wd = x.to(cd).contiguous(), w_enc.to(cd).contiguous(), w_dec.to(cd).contiguous()
        b_enc = b_enc.contiguous()
        recon, act_count, row_active, zsum = fused_crosscoder_forward(
            xc, we, b_enc, wd, b_dec.contiguous())
        err = recon - y
        ctx.save_for_backward(xc, we, b_enc, wd, err.to(cd))
        ctx.mark_non_differentiable(recon, act_count, row_active)
        return err.square().mean(), zsum, recon, act_count, row_active

    @staticmethod
    def backward(ctx, g_rec, g_zsum, *_unused):
        xc, we, b_enc, wd, err = ctx.saved_tensors
        t, c = xc.shape
        h = b_enc.shape[0]
        g_rec = torch.zeros((), dtype=_F32, device=xc.device) if g_rec is None else g_rec.float()
        ct_zsum = (torch.zeros((h,), dtype=_F32, device=xc.device) if g_zsum is None
                   else g_zsum.float().contiguous())
        coeffs = (g_rec * 2.0 / (t * c)).reshape(1)  # a device tensor: no host sync
        dw_enc, db_enc, dw_dec, db_dec = fused_crosscoder_backward(
            xc, we, b_enc, wd, err, coeffs, ct_zsum)
        return None, dw_enc, db_enc, dw_dec, db_dec, None, None


def _cat_space(params: dict, xs: tuple) -> tuple:
    """The concat/scale reduction (module docstring) of the flat per-layer
    ``params`` (a latent shard or all latents) and inputs: (dims, s, x_cat,
    W_enc_cat, W_dec_cat·s, b_dec_cat·s, n_j), n_j = Σ_l ‖W_dec_l[j]‖, every
    part differentiable in the parameters."""
    n_layers = crosscoder_num_layers(params)
    if len(xs) != n_layers:
        raise ValueError(f"crosscoder with {n_layers} layers got {len(xs)} inputs")
    dims = tuple(int(x.shape[1]) for x in xs)
    csum = sum(dims)
    dev = xs[0].device
    s = torch.cat([torch.full((d,), (csum / d) ** 0.5, dtype=_F32, device=dev) for d in dims])
    w_enc = torch.cat([params[f"W_enc_{i}"] for i in range(n_layers)], 0)
    w_dec = torch.cat([params[f"W_dec_{i}"] for i in range(n_layers)], 1) * s[None, :]
    b_dec = torch.cat([params[f"b_dec_{i}"] for i in range(n_layers)]) * s
    n_j = sum(torch.linalg.vector_norm(params[f"W_dec_{i}"], dim=1) for i in range(n_layers))
    return dims, s, torch.cat(xs, 1), w_enc, w_dec, b_dec, n_j


def fused_crosscoder_loss_terms(params: dict, xs: tuple, lambda_sparse: float,
                                expansion_factor: int, *, compute_dtype=_BF16) -> dict:
    """Fused equivalent of crosscoder_inference_and_loss + measure_inactive_units
    on per-layer 2-D token inputs (the module docstring has the concat/scale
    reduction). NRMSE/RMSE are reported on the anchor layer, unscaled."""
    dims, s, x_cat, w_enc, w_dec, b_dec, n_j = _cat_space(params, xs)
    h = params["b_enc"].shape[0]
    t = xs[0].shape[0]
    dev = xs[0].device
    rec_loss, zsum, recon, act_count, row_active = FusedCrosscoderFunction.apply(
        x_cat, w_enc, params["b_enc"], w_dec, b_dec, x_cat * s[None, :],
        compute_dtype_of(compute_dtype))
    # the decoder-norm-weighted L1 from the differentiable per-latent sums: the
    # zsum cotangent drives the kernel backward, n_j reaches W_dec by autograd
    l1 = zsum @ n_j / (t * h)
    rmse, nrmse = losses.rmse_nrmse(recon[:, : dims[0]] / s[0], xs[0])
    return {
        "loss": rec_loss + lambda_sparse * l1,
        "rec_loss": rec_loss,
        "l1_loss": l1,
        "nrmse_loss": nrmse,
        "rmse_loss": rmse,
        "aux_loss": torch.zeros((), dtype=_F32, device=dev),
        "dead": act_count == 0,
        "activity_freq": act_count / t,
        "sparsity": torch.mean(row_active / (h / expansion_factor)),
    }


class FusedCrosscoderTPFunction(torch.autograd.Function):
    """Cat-space (x_cat [T/d, ΣC], W_enc [ΣC, H/m], b_enc [H/m], W_dec [H/m, ΣC],
    b_dec [ΣC], y [T/d, ΣC], n_local [H/m]) -> (rec_loss, l1_loss, recon,
    act_count, row_active, mean_row_active) on a rank of ``mesh``: the
    counterpart of the JAX package's make_fused_crosscoder_tp_op (its
    fused_crosscoder.py:371).

    The forward is FusedTranscoderTPFunction's on the cat space (the partial
    reconstruction psummed over 'model' less (m−1)·b_dec, the MSE after it).
    The decoder-norm-weighted L1 is assembled INSIDE, with the decoder-norm
    weights ``n_local`` of the shard's latents a differentiable input:
    l1 = psum_both(zsum·n_local)/(T_g·H_g). Its backward gives the kernel the
    per-latent cotangent ct_zsum = g_l1·n_local/(T_g·H_g), and n_local the
    gradient g_l1·psum_data(zsum)/(T_g·H_g), which autograd carries on to
    W_dec through the caller's local norm graph, with no collective. (Handing
    zsum out and summing it outside with a raw all_reduce would leave that
    gradient local, or count it twice.) dW_enc, db_enc, dW_dec and db_dec are
    psummed over 'data' only: db_dec is the same on every model rank. No
    latent padding (fused_sae.bodies_take's rule, as the single-device op)."""

    @staticmethod
    def forward(ctx, x, w_enc, b_enc, w_dec, b_dec, y, n_local, compute_dtype, mesh):
        cd = compute_dtype
        t_l = x.shape[0]
        h_l = b_enc.shape[0]
        m, n_data = mesh.size("model"), mesh.size("data")
        t_g, h_g = t_l * n_data, h_l * m
        xc, we, wd = x.to(cd).contiguous(), w_enc.to(cd).contiguous(), w_dec.to(cd).contiguous()
        b_enc, b_dec = b_enc.contiguous(), b_dec.contiguous()
        recon_p, act_count, row_active, zsum = fused_crosscoder_forward(
            xc, we, b_enc, wd, b_dec, kernel=tp_fwd_kernel)
        recon, row_active, l1_sum = mesh.psum_many(
            [recon_p, row_active, zsum @ n_local.float()], "model")
        recon = recon - (m - 1) * b_dec
        err = recon - y
        act_count, sq, l1_sum, mean_rows = mesh.psum_many(
            [act_count, err.square().mean(), l1_sum, row_active.mean()], "data")
        ctx.save_for_backward(xc, we, b_enc, wd, err.to(cd), n_local, zsum)
        ctx.dims = (t_g, h_g)
        ctx.mesh = mesh
        out = (sq / n_data, l1_sum / (t_g * h_g), recon, act_count, row_active,
               mean_rows / n_data)
        ctx.mark_non_differentiable(*out[2:])
        return out

    @staticmethod
    def backward(ctx, g_rec, g_l1, *_unused):
        xc, we, b_enc, wd, err, n_local, zsum = ctx.saved_tensors
        t_g, h_g = ctx.dims
        g_l1 = _zero_if_none(g_l1, xc)
        coeffs = (_zero_if_none(g_rec, xc) * 2.0 / (t_g * xc.shape[1])).reshape(1)
        ct_zsum = (g_l1 * n_local.float() / (t_g * h_g)).contiguous()
        grads = fused_crosscoder_backward(xc, we, b_enc, wd, err, coeffs, ct_zsum,
                                          kernel=tp_bwd_kernel)
        dw_enc, db_enc, dw_dec, db_dec, zsum = ctx.mesh.psum_many([*grads, zsum], "data")
        # each data rank's token sum multiplies the same latent-local weight
        dn = g_l1 * zsum / (t_g * h_g)
        return None, dw_enc, db_enc, dw_dec, db_dec, None, dn, None, None


def fused_crosscoder_tp_loss_terms(params: dict, xs: tuple, lambda_sparse: float,
                                   expansion_factor: int, mesh, *,
                                   compute_dtype=_BF16) -> dict:
    """The TP counterpart of fused_crosscoder_loss_terms on the rank's shard
    (``params`` the flat per-layer latent shards, ``xs`` the per-layer local
    token rows): the concat/scale reduction and the n_j norm graph are local
    torch, the collectives live in FusedCrosscoderTPFunction. GLOBAL rec_loss,
    l1_loss and ``sparsity``; the anchor layer's rmse / nrmse over the global
    batch (losses.rmse_nrmse_global); ``dead`` and ``activity_freq`` over the
    local latents and the global batch."""
    dims, s, x_cat, w_enc, w_dec, b_dec, n_local = _cat_space(params, xs)
    rec_loss, l1_loss, recon, act_count, _, mean_rows = FusedCrosscoderTPFunction.apply(
        x_cat, w_enc, params["b_enc"], w_dec, b_dec, x_cat * s[None, :], n_local,
        compute_dtype_of(compute_dtype), mesh)
    t_g = xs[0].shape[0] * mesh.size("data")
    h_g = params["b_enc"].shape[0] * mesh.size("model")
    rmse, nrmse = losses.rmse_nrmse_global(recon[:, : dims[0]] / s[0], xs[0], mesh)
    return {
        "loss": rec_loss + lambda_sparse * l1_loss,
        "rec_loss": rec_loss,
        "l1_loss": l1_loss,
        "nrmse_loss": nrmse,
        "rmse_loss": rmse,
        "aux_loss": torch.zeros((), dtype=_F32, device=x_cat.device),
        "dead": act_count == 0,
        "activity_freq": act_count / t_g,
        "sparsity": mean_rows / (h_g / expansion_factor),
    }
