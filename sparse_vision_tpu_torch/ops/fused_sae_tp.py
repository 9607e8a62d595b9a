"""Tensor-parallel fused SAE ops: the ReLU, gated, JumpReLU and Matryoshka
SAEs' fused bodies on a latent shard, for a (data, model) mesh (port of
sparse_vision_tpu/ops/fused_sae_tp.py).

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
  The JumpReLU op's threshold gradient dθ is latent-local like dW_enc: it is
  psummed over 'data' only, and d log_θ = psum_data(dθ)·θ is taken once, after
  that psum. Its training sparsity term, the L0 Σ act_count / T_g, is summed
  over both axes.
- Matryoshka: the global prefix boundaries cut through the shards, so every
  rank runs the forward entry point at the same local boundaries, the SNAPSHOT
  UNION (tp_snapshot_union: each global boundary clipped into every rank's
  shard), and takes prefix p's contribution from the snapshot at its own clip
  (zero where the clip is 0). Every rank builds the same [P, T/d, C] tensor,
  so the psum over 'model' has one shape on every rank; prefix p's recon is
  that psum less (n_contrib_p − 1)·b_dec, n_contrib_p the ranks with a
  positive clip. The backward runs the backward entry point at the union on
  S_local[q] = Σ_p [clip_p ≥ union_q]·c_p·err_p; its direct term (Σ_T S_0 on
  each rank) counts prefix p n_contrib_p times after the psum, so db_dec
  takes off Σ_p (n_contrib_p − 1)·c_p·Σ_T err_p.
- the loss scalars are GLOBAL (pmean'd and psummed inside the op), so the
  gradients come out global: the step must not reduce them again.

Collectives per step: two all_reduces in the forward (over 'model': the
partial outputs, row_active and Σpost, and the JumpReLU op's Σ act_count;
over 'data': the activity counts, the MSEs, the L1 (and L0) sums and the mean
row activity) and two in the backward (over 'data': the latent-local
gradients and the direct term; over 'model': db_dec), each of one
concatenated f32 buffer.

The kernels are the single-device ops' bodies through wrappers of their own
(``KERNELS``), so their launches count apart from the single-device rows.
On CPU tensors the plain versions run, as in the single-device ops. A shard
whose H/m is not a multiple of 128 is zero-padded inside the ReLU op, as
ops/fused_sae.FusedSAEFunction pads; the gated, JumpReLU and Matryoshka ops
keep their single-device ops' rules (H/m a multiple of 128 on the card, and
for Matryoshka a union of multiples of 128: can_fuse_matryoshka_tp).
"""

from __future__ import annotations

import torch

from sparse_vision_tpu_torch.models.sae import (
    DEFAULT_MATRYOSHKA_PREFIXES,
    JUMPRELU_BANDWIDTH,
    matryoshka_prefix_counts,
)
from sparse_vision_tpu_torch.ops import (
    fused_gated_sae,
    fused_jumprelu_sae,
    fused_matryoshka_sae,
    fused_sae,
    losses,
)
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


class _JumpReLUForward(fused_jumprelu_sae._ForwardKernel):
    """svt_jumprelu_fwd on a latent shard (the site of fused_sae_tp.py:463)."""

    name = "fused_jumprelu_sae_tp_fwd"


class _JumpReLUBackward(fused_jumprelu_sae._BackwardKernel):
    """svt_jumprelu_bwd on a latent shard (the site of fused_sae_tp.py:526)."""

    name = "fused_jumprelu_sae_tp_bwd"


class _MatryoshkaForward(fused_matryoshka_sae._ForwardKernel):
    """svt_matryoshka_fwd on a latent shard at the snapshot union (the site of
    fused_sae_tp.py:721)."""

    name = "fused_matryoshka_sae_tp_fwd"


class _MatryoshkaBackward(fused_matryoshka_sae._BackwardKernel):
    """svt_matryoshka_bwd on a latent shard at the snapshot union (the site of
    fused_sae_tp.py:803)."""

    name = "fused_matryoshka_sae_tp_bwd"


fwd_kernel = _ReluForward()
bwd_kernel = _ReluBackward()
gated_fwd_kernel = _GatedForward()
gated_bwd_kernel = _GatedBackward()
jumprelu_fwd_kernel = _JumpReLUForward()
jumprelu_bwd_kernel = _JumpReLUBackward()
matryoshka_fwd_kernel = _MatryoshkaForward()
matryoshka_bwd_kernel = _MatryoshkaBackward()
KERNELS = (fwd_kernel, bwd_kernel, gated_fwd_kernel, gated_bwd_kernel, jumprelu_fwd_kernel,
           jumprelu_bwd_kernel, matryoshka_fwd_kernel, matryoshka_bwd_kernel)


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


class FusedJumpReLUSAETPFunction(torch.autograd.Function):
    """(x [T/d, C], W_enc [C, H/m], b_enc [H/m], log_threshold [H/m], W_dec [H/m,
    C], b_dec [C]) -> (rec_loss, l0_loss, l1_loss, recon, act_count, row_active,
    mean_row_active), as FusedSAETPFunction with the JumpReLU op's L0 as the
    trained sparsity term (l1_loss a metric) and the threshold gradient kept on
    its latent shard."""

    @staticmethod
    def forward(ctx, x, w_enc, b_enc, log_threshold, w_dec, b_dec, compute_dtype, bandwidth,
                mesh):
        cd = compute_dtype
        t_l, _ = x.shape
        h_l = b_enc.shape[0]
        m = mesh.size("model")
        t_g, h_g = t_l * mesh.size("data"), h_l * m
        xc, we, wd = x.to(cd).contiguous(), w_enc.to(cd).contiguous(), w_dec.to(cd).contiguous()
        b_enc, b_dec = b_enc.contiguous(), b_dec.contiguous()
        thr = torch.exp(log_threshold).float().contiguous()
        recon_p, act_count, row_active, l1_sum = fused_jumprelu_sae.fused_jumprelu_forward(
            xc, we, b_enc, thr, wd, b_dec, kernel=jumprelu_fwd_kernel)
        recon, row_active, l1_sum, l0_sum = mesh.psum_many(
            [recon_p, row_active, l1_sum, act_count.sum()], "model")
        recon = recon - (m - 1) * b_dec  # every rank's kernel added b_dec once
        err = recon - x  # f32, against x in its own dtype
        act_count, sq, l1_sum, l0_sum, mean_rows = mesh.psum_many(
            [act_count, err.square().mean(), l1_sum, l0_sum, row_active.mean()], "data")
        n_data = mesh.size("data")
        ctx.save_for_backward(xc, we, b_enc, thr, wd, b_dec, err)
        ctx.dims = (t_g, m)
        ctx.bandwidth, ctx.mesh = bandwidth, mesh
        out = (sq / n_data, l0_sum / t_g, l1_sum / (t_g * h_g), recon, act_count, row_active,
               mean_rows / n_data)
        ctx.mark_non_differentiable(*out[2:])
        return out

    @staticmethod
    def backward(ctx, g_rec, g_l0, *_unused):
        xc, we, b_enc, thr, wd, b_dec, err = ctx.saved_tensors
        t_g, m = ctx.dims
        mesh = ctx.mesh
        c = xc.shape[1]
        coeffs = torch.stack([_zero_if_none(g_rec, xc) * 2.0 / (t_g * c),
                              _zero_if_none(g_l0, xc) / t_g])
        dw_enc, db_enc, dthr, dw_dec, db_dec = fused_jumprelu_sae.fused_jumprelu_backward(
            xc, we, b_enc, thr, wd, b_dec, err, coeffs, ctx.bandwidth,
            kernel=jumprelu_bwd_kernel)
        direct = coeffs[0] * err.sum(0)
        # dθ is latent-local, as dW_enc: psummed over 'data' only
        dw_enc, db_enc, dthr, dw_dec, db_dec, direct = mesh.psum_many(
            [dw_enc, db_enc, dthr, dw_dec, db_dec, direct], "data")
        db_dec = mesh.psum(db_dec, "model") - (m - 1) * direct
        # chain rule through θ = exp(log_θ), once, after the psum
        return None, dw_enc, db_enc, dthr * thr, dw_dec, db_dec, None, None, None


def tp_snapshot_union(boundaries: tuple, n_model: int) -> tuple:
    """(union, H/m, n_contrib): the local snapshot boundaries every rank runs
    the Matryoshka forward at (each global boundary clipped into each rank's
    shard, the positive clips of every rank, sorted), the shard width, and per
    global prefix the ranks that hold part of it, ceil(b_p / (H/m))."""
    h = boundaries[-1]
    if h % n_model:
        raise ValueError(f"latent count {h} not divisible by model axis {n_model}")
    h_l = h // n_model
    union = {c for k in range(n_model) for c in _clips(boundaries, k, h_l) if c > 0}
    return tuple(sorted(union)), h_l, tuple(-(-b // h_l) for b in boundaries)


def _clips(boundaries: tuple, k: int, h_l: int) -> tuple:
    """Each global boundary clipped into the shard of model index ``k``."""
    return tuple(min(max(b - k * h_l, 0), h_l) for b in boundaries)


def matryoshka_union_tiles(boundaries: tuple, n_model: int) -> bool:
    """True when the global ``boundaries`` (strictly increasing) split over
    ``n_model`` shards into a snapshot union that the kernels take: every entry
    a multiple of 128, at most MAX_LEVELS of them, the last equal to H/m."""
    b = list(boundaries)
    if not b or b != sorted(set(b)) or b[0] <= 0 or b[-1] % n_model:
        return False
    union, h_l, _ = tp_snapshot_union(tuple(b), n_model)
    return fused_matryoshka_sae._levels_ok(h_l, union, fused_matryoshka_sae.TILE_H)


def can_fuse_matryoshka_tp(t_local: int, boundaries: tuple, n_model: int, c: int = 256,
                           dtype=torch.bfloat16) -> bool:
    """True when the Matryoshka TP op's kernels take a rank's shard: T/d local
    tokens, the GLOBAL prefix ``boundaries``, ``n_model`` latent shards, C
    channels in ``dtype``. The union must tile (matryoshka_union_tiles) and the
    coder bodies must take (T/d, H/m, C) (fused_sae.bodies_take)."""
    return (matryoshka_union_tiles(boundaries, n_model)
            and fused_sae.bodies_take(t_local, boundaries[-1] // n_model, c, c, dtype))


class FusedMatryoshkaSAETPFunction(torch.autograd.Function):
    """(x [T/d, C], W_enc [C, H/m], b_enc [H/m], W_dec [H/m, C], b_dec [C]) ->
    (prefix_losses [P], l1_loss, recon, act_count, row_active,
    mean_row_active) for the GLOBAL prefix ``boundaries`` (module docstring):
    prefix_losses and l1_loss global and differentiable, ``recon`` the full
    dictionary's reconstruction of the local tokens."""

    @staticmethod
    def forward(ctx, x, w_enc, b_enc, w_dec, b_dec, boundaries, compute_dtype, mesh):
        cd = compute_dtype
        t_l, _ = x.shape
        m = mesh.size("model")
        union, h_l, n_contrib = tp_snapshot_union(boundaries, m)
        t_g, h_g = t_l * mesh.size("data"), h_l * m
        clips = _clips(boundaries, mesh.index("model"), h_l)
        xc, we, wd = x.to(cd).contiguous(), w_enc.to(cd).contiguous(), w_dec.to(cd).contiguous()
        b_enc, b_dec = b_enc.contiguous(), b_dec.contiguous()
        x_cent, snap, act_count, row_active, l1_sum = fused_matryoshka_sae.fused_matryoshka_forward(
            xc, we, b_enc, wd, b_dec, union, kernel=matryoshka_fwd_kernel)
        # prefix p's part on this rank: the snapshot at its clip, or zero; the
        # same [P, T/d, C] shape on every rank
        zero = torch.zeros_like(snap[0])
        contrib = torch.stack([snap[union.index(cp)] if cp > 0 else zero for cp in clips])
        prefix_recon, row_active, l1_sum = mesh.psum_many([contrib, row_active, l1_sum],
                                                          "model")
        extra = torch.tensor(n_contrib, dtype=_F32, device=x.device) - 1.0  # [P]
        prefix_recon = prefix_recon - extra[:, None, None] * b_dec
        errs = prefix_recon - x.float()[None]
        act_count, sq, l1_sum, mean_rows = mesh.psum_many(
            [act_count, errs.square().mean((1, 2)), l1_sum, row_active.mean()], "data")
        n_data = mesh.size("data")
        ctx.save_for_backward(x_cent, we, b_enc, wd, errs, extra)
        ctx.dims = (t_g, h_g, union, clips)
        ctx.mesh = mesh
        out = (sq / n_data, l1_sum / (t_g * h_g), prefix_recon[-1], act_count, row_active,
               mean_rows / n_data)
        ctx.mark_non_differentiable(*out[2:])
        return out

    @staticmethod
    def backward(ctx, g_prefix, g_l1, *_unused):
        x_cent, we, b_enc, wd, errs, extra = ctx.saved_tensors
        t_g, h_g, union, clips = ctx.dims
        mesh = ctx.mesh
        c = x_cent.shape[1]
        dev = x_cent.device
        g_prefix = torch.zeros(errs.shape[0], dtype=_F32, device=dev) \
            if g_prefix is None else g_prefix.float()
        cts = g_prefix * (2.0 / (t_g * c))  # [P]
        # union tile q's cotangent sums every prefix whose clip covers it
        cmask = torch.tensor([[float(cp >= u) for cp in clips] for u in union], device=dev)
        s = torch.einsum("qp,ptc->qtc", cmask, cts[:, None, None] * errs).to(x_cent.dtype)
        coeffs = torch.stack([torch.ones((), dtype=_F32, device=dev),
                              _zero_if_none(g_l1, x_cent) / (t_g * h_g)])
        dw_enc, db_enc, dw_dec, db_dec = fused_matryoshka_sae.fused_matryoshka_backward(
            x_cent, we, b_enc, wd, s, coeffs, union, kernel=matryoshka_bwd_kernel)
        # each rank's kernel summed S_0, which holds every prefix it contributes
        # to: n_contrib_p copies of prefix p's direct term after the psum
        direct_extra = torch.einsum("p,ptc->c", extra * cts, errs)
        dw_enc, db_enc, dw_dec, db_dec, direct_extra = mesh.psum_many(
            [dw_enc, db_enc, dw_dec, db_dec, direct_extra], "data")
        db_dec = mesh.psum(db_dec, "model") - direct_extra
        return None, dw_enc, db_enc, dw_dec, db_dec, None, None, None


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


def fused_jumprelu_sae_tp_loss_terms(params: dict, x: torch.Tensor, lambda_sparse: float,
                                     expansion_factor: int, mesh, *,
                                     compute_dtype=torch.bfloat16,
                                     bandwidth: float = JUMPRELU_BANDWIDTH) -> dict:
    """The TP counterpart of ops/fused_jumprelu_sae.fused_jumprelu_sae_loss_terms
    (loss = rec + λ·L0; l1_loss a metric), with fused_sae_tp_loss_terms'
    contract."""
    cd = compute_dtype_of(compute_dtype)
    rec_loss, l0_loss, l1_loss, recon, act_count, _, mean_rows = \
        FusedJumpReLUSAETPFunction.apply(
            x, params["W_enc"], params["b_enc"], params["log_threshold"], params["W_dec"],
            params["b_dec"], cd, bandwidth, mesh)
    zero = torch.zeros((), dtype=_F32, device=x.device)
    out = _loss_terms(x, rec_loss, l1_loss, zero, lambda_sparse, recon, act_count, mean_rows,
                      params["b_enc"].shape[0] * mesh.size("model"),
                      x.shape[0] * mesh.size("data"), expansion_factor)
    return {**out, "loss": rec_loss + lambda_sparse * l0_loss, "l0_loss": l0_loss}


def fused_matryoshka_sae_tp_loss_terms(params: dict, x: torch.Tensor, lambda_sparse: float,
                                       expansion_factor: int, mesh,
                                       prefixes: tuple = DEFAULT_MATRYOSHKA_PREFIXES, *,
                                       compute_dtype=torch.bfloat16) -> dict:
    """The TP counterpart of
    ops/fused_matryoshka_sae.fused_matryoshka_sae_loss_terms (loss = mean_p
    prefix MSE + λ·l1; rec_loss the full dictionary's MSE; aux_loss the prefix
    surcharge), ``prefixes`` the GLOBAL dictionary fractions, with
    fused_sae_tp_loss_terms' contract."""
    cd = compute_dtype_of(compute_dtype)
    h_g = params["b_enc"].shape[0] * mesh.size("model")
    boundaries = matryoshka_prefix_counts(h_g, tuple(prefixes))
    prefix_losses, l1_loss, recon, act_count, _, mean_rows = \
        FusedMatryoshkaSAETPFunction.apply(
            x, params["W_enc"], params["b_enc"], params["W_dec"], params["b_dec"], boundaries,
            cd, mesh)
    prefix_mean = prefix_losses.mean()
    rec = prefix_losses[-1]
    out = _loss_terms(x, rec, l1_loss, prefix_mean - rec, lambda_sparse, recon, act_count,
                      mean_rows, h_g, x.shape[0] * mesh.size("data"), expansion_factor)
    return {**out, "loss": prefix_mean + lambda_sparse * l1_loss}
