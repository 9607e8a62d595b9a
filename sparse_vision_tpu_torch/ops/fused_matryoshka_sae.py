"""Fused Matryoshka-SAE training op (Bussmann et al. 2024): the ReLU-SAE entry
points of csrc/fused_sae.cu (the coder bodies of csrc/coder.cuh on the centred
input), with the loss averaged over nested latent prefixes.

Port of sparse_vision_tpu/ops/fused_matryoshka_sae.py. The objective is
loss = mean_p MSE(x̂_p, x) + λ·L1, where x̂_p decodes only the first b_p latents
(models/sae.matryoshka_sae_apply); run stock, that is P [T, H] latent
materializations. Fused, it costs almost nothing over the ReLU op:
  - forward: the forward body accumulates each token tile's reconstruction
    over the latent groups in order, so the accumulator passes through every
    prefix reconstruction; the kernel writes a snapshot of it at the end of
    each prefix into prefix_recon [P, T, C] (f32). The per-prefix losses are
    assembled here from ``prefix_recon − x`` in full precision.
  - backward: the cotangent of latent tile j's contribution sums the errors of
    every prefix that contains it, the suffix-weighted error
    S_q = Σ_{p≥q} c_p·err_p (c_p = g_p·2/(T·C)) with q = level(j). S [P, T, C]
    is computed here from the saved errors, cast to the compute dtype, and the
    backward body and the dx route read S[level(j)] with c_rec = 1 where they
    read c_rec·err (so the kernel's rounding of 1·S is exact and the cast
    points are the Pallas body's). The direct b_dec term is Σ_t S_0, summed by
    the blocks of level 0. In bf16 at C <= 256 the body is the cluster pair
    (fused_sae.bwd_route, act "sae": coder_bwd_pair<Act::Relu>, whose D CTA
    reads its block's level of S as it is), after scale_err_kernel's direct
    rows of S_0 (no copy of S); wider, coder_bwd_tc.
As for the ReLU op (ops/fused_sae.py), the forward entry point centres x first
and the backward and dx run on the saved x_cent; the glue around each entry point
(partial reductions, the centring rows of db_dec) is shared by the CPU path,
where the entry points' plain versions stand.

Dispatch rule (ops/fused_sae.run_on_device): a CPU tensor runs the plain
PyTorch version of each kernel; a CUDA tensor launches the kernel or raises.

Kernel constraint: every prefix boundary is a multiple of the latent group
(128, the JAX op's latent quantum), so each prefix ends at a group boundary
(can_fuse_matryoshka).

The sweep (train/sweep_vmap.py; ops/fused_sae.py's docstring):
FusedMatryoshkaSAEFunction on parameters with a leading combo axis runs N
stacked dictionaries on one shared batch through svt_matryoshka_sweep_fwd /
_bwd, one launch each; the prefix boundaries depend on H only, so the combos
share them.

Differentiability contract: gradients flow through ``prefix_losses`` and
``l1_loss`` only; the other outputs are metrics. ``x`` gets its gradient from
the dx entry point, dx = Σ_j round(dpre_j)·W_enc_jᵀ − S_0, when
``compute_dx=True``, and None otherwise.
"""

from __future__ import annotations

import ctypes
import functools

import torch

from sparse_vision_tpu_torch.models.sae import (
    DEFAULT_MATRYOSHKA_PREFIXES,
    matryoshka_prefix_counts,
)
from sparse_vision_tpu_torch.ops import fused_sae, losses, native
from sparse_vision_tpu_torch.ops.fused_sae import (
    _F32,
    _BF16,
    Kernel,
    _check_operands,
    _check_sweep,
    _expect,
    _ptrs,
    _r,
    backward_outputs,
    centring_rows_plain,
    coder_backward_plain,
    compute_dtype_of,
    forward_outputs,
    join_forward,
    launch_split,
    loss_coeffs,
    run_on_device,
    split_workspace,
    stack_plain,
    sweep_terms,
)

TILE_H = fused_sae.TILE_H
MAX_LEVELS = 16  # kMaxLevels of csrc/sae_common.cuh


def _levels_ok(h: int, boundaries: tuple, quantum: int) -> bool:
    b = list(boundaries)
    return (0 < len(b) <= MAX_LEVELS and b[-1] == h and b[0] > 0
            and all(lo < hi for lo, hi in zip(b, b[1:]))
            and all(v % quantum == 0 for v in b))


def can_fuse_matryoshka(t: int, h: int, boundaries: tuple, c: int = 256,
                        dtype=_BF16) -> bool:
    """True when the CUDA forward and backward take this shape in ``dtype``: the
    coder bodies' rule (fused_sae.bodies_take; this op pads no latent), and at
    most MAX_LEVELS prefix boundaries, strictly increasing, each a multiple of
    the latent group (128), the last equal to H. The CPU plain versions take
    any valid boundaries."""
    return _levels_ok(h, boundaries, TILE_H) and fused_sae.bodies_take(t, h, c, c, dtype)


def _segments(boundaries):
    """(level, first latent, end latent) of each prefix level."""
    return zip(range(len(boundaries)), (0, *boundaries[:-1]), boundaries)


# ---------------------------------------------------------------------------
# plain versions (CPU path; the reference the kernels are held against)
# ---------------------------------------------------------------------------

def _prefix_forward(x_cent, w_enc, b_enc, w_dec, b_dec, boundaries):
    """(prefix_recon [P, T, C] f32, post > 0, post) of the centred input; prefix
    p sums the decodes of levels 0..p."""
    post = torch.relu(x_cent.float() @ w_enc.float() + b_enc)
    postc, wd = _r(post, x_cent.dtype), w_dec.float()
    parts = torch.stack([postc[:, lo:hi] @ wd[lo:hi] for _, lo, hi in _segments(boundaries)])
    return parts.cumsum(0) + b_dec, post > 0, post


def fused_matryoshka_forward_plain(x, w_enc, b_enc, w_dec, b_dec, boundaries):
    """The op's forward in plain PyTorch, the reference the kernels are held to.
    ``x``, ``w_enc``, ``w_dec`` are in the compute dtype. Returns (prefix_recon
    [P, T, C] f32, act_count [H], row_active [T], l1_sum scalar)."""
    prefix_recon, active, post = _prefix_forward(
        fused_sae.center_plain(x, b_dec), w_enc, b_enc, w_dec, b_dec, boundaries)
    return prefix_recon, active.sum(0).float(), active.sum(1).float(), post.sum()


def _levels_plain(x_cent, w_enc, b_enc, w_dec, s, coeffs, boundaries):
    """Per prefix level q: (lo, hi, xc, W_enc level block, post, drecon, dpre)
    of the plain backward and dx, with drecon = c_rec·S_q."""
    cd = x_cent.dtype
    c_rec, c_l1 = coeffs[0], coeffs[1]
    xc = x_cent.float()
    for q, lo, hi in _segments(boundaries):
        we = w_enc[:, lo:hi].float()
        pre = xc @ we + b_enc[lo:hi]
        drecon = c_rec * s[q].float()
        dpost = _r(drecon, cd) @ w_dec[lo:hi].float().T + c_l1
        dpre = torch.where(pre > 0, dpost, torch.zeros((), device=pre.device))
        yield lo, hi, xc, we, torch.relu(pre), drecon, dpre


def fused_matryoshka_backward_plain(x, w_enc, b_enc, w_dec, b_dec, s, coeffs, boundaries):
    """The op's backward over P levels in plain PyTorch, the reference the kernels
    are held to. ``s`` is the suffix-weighted error [P, T, C] in the compute
    dtype, ``coeffs`` = (c_rec, c_l1) with c_rec = 1 on the main path. Returns
    f32 (dW_enc [C, H], db_enc [H], dW_dec [H, C], db_dec [C])."""
    cd = x.dtype
    dw_enc, db_enc, dw_dec = [], [], []
    db_dec = (coeffs[0] * s[0].float()).sum(0)  # the direct term, level 0 once
    for _, _, xc, we, post, drecon, dpre in _levels_plain(
            fused_sae.center_plain(x, b_dec), w_enc, b_enc, w_dec, s, coeffs, boundaries):
        db = dpre.sum(0)
        dw_enc.append(xc.T @ _r(dpre, cd))
        db_enc.append(db)
        dw_dec.append(_r(post, cd).T @ _r(drecon, cd))
        db_dec = db_dec - _r(db, cd) @ we.T
    return torch.cat(dw_enc, 1), torch.cat(db_enc), torch.cat(dw_dec), db_dec


def fused_matryoshka_dx_plain(x_cent, w_enc, b_enc, w_dec, s, coeffs, boundaries):
    """Plain version of the dx entry point svt_matryoshka_dx (dx_kernel) over P
    levels, on the forward's x_cent: Σ_q round(dpre_q) @ W_enc_qᵀ − c_rec·S_0,
    [T, C] f32."""
    cd = x_cent.dtype
    dx = -coeffs[0] * s[0].float()
    for _, _, _, we, _, _, dpre in _levels_plain(
            x_cent, w_enc, b_enc, w_dec, s, coeffs, boundaries):
        dx = dx + _r(dpre, cd) @ we.T
    return dx


def matryoshka_fwd_plain(x, w_enc, b_enc, w_dec, b_dec, boundaries):
    """Plain version of the forward entry point svt_matryoshka_fwd (fwd_kernel):
    (x_cent, prefix_recon, act_part, row_active, zsum_part), the per-latent
    partials as one row."""
    x_cent = fused_sae.center_plain(x, b_dec)
    prefix_recon, active, post = _prefix_forward(x_cent, w_enc, b_enc, w_dec, b_dec, boundaries)
    return (x_cent, prefix_recon, active.sum(0).float()[None], active.sum(1).float(),
            post.sum(0)[None])


def matryoshka_bwd_plain(x_cent, w_enc, b_enc, w_dec, s, coeffs, boundaries):
    """Plain version of the backward entry point svt_matryoshka_bwd (bwd_kernel):
    per level q, the coder backward of its latents on S_q; db_dec_part holds
    Σ_t c_rec·S_0, then the centring row."""
    parts = [coder_backward_plain(x_cent, w_enc[:, lo:hi], b_enc[lo:hi], w_dec[lo:hi], s[q],
                                  coeffs[0], coeffs[1])
             for q, lo, hi in _segments(boundaries)]
    db_enc = torch.cat([p[1] for p in parts])
    return (torch.cat([p[0] for p in parts], 1), db_enc, torch.cat([p[2] for p in parts]),
            torch.cat([parts[0][3][None], centring_rows_plain(db_enc, w_enc)]))


def matryoshka_bwd_pair_plain(x_cent, w_enc, b_enc, w_dec, s, coeffs, boundaries):
    """Plain version of svt_matryoshka_bwd's cluster-pair route:
    scale_err_kernel's direct rows of db_dec from S_0 (c_rec·S_0 summed per
    512-token step; no copy of S), then coder_bwd_pair<Act::Relu>, each block
    reading its level of S as it is: matryoshka_bwd_plain at a unit scale (c_rec
    is 1 on the op's path), its own direct row left to the pre-pass's."""
    _, direct = fused_sae.scale_err_plain(s[0], coeffs[0], x_cent.dtype)
    dw_enc, db_enc, dw_dec, rows = matryoshka_bwd_plain(x_cent, w_enc, b_enc, w_dec, s,
                                                        fused_sae.unit_scale(coeffs), boundaries)
    return dw_enc, db_enc, dw_dec, torch.cat([direct, rows[1:]])


# the plain version of each backward route (fused_sae.bwd_route, act "sae")
ROUTE_PLAIN = {"pair": matryoshka_bwd_pair_plain, "tc": matryoshka_bwd_plain,
               "simt": matryoshka_bwd_plain}


def backward_plain(x_cent, *args, route=None):
    """The plain version of the route the card's backward takes for ``x_cent``
    (``route``, or fused_sae.bwd_route's for an SAE of its width, levels and
    dtype); ``args`` end in the prefix boundaries."""
    c = x_cent.shape[-1]
    route = route or fused_sae.bwd_route(c, c, len(args[-1]), act="sae", dtype=x_cent.dtype)
    return ROUTE_PLAIN[route](x_cent, *args)


# ---------------------------------------------------------------------------
# CUDA kernels (entry points of csrc/fused_sae.cu)
# ---------------------------------------------------------------------------

_P = ctypes.c_void_p
_I = ctypes.c_int


@functools.cache
def _lib() -> ctypes.CDLL:
    lib = native.load("fused_sae")
    # the forwards and backwards end in (..., n_split, stream); the backwards'
    # last pointer is split_ws (csrc/coder.cuh, "Splits")
    lib.svt_matryoshka_fwd.restype = _I
    lib.svt_matryoshka_fwd.argtypes = [_I] + [_P] * 10 + [_I, _I, _I, _P, _I, _I, _P]
    lib.svt_matryoshka_bwd.restype = _I
    lib.svt_matryoshka_bwd.argtypes = [_I] + [_P] * 12 + [_I, _I, _I, _P, _I, _I, _I, _P]
    lib.svt_matryoshka_dx.restype = _I
    lib.svt_matryoshka_dx.argtypes = [_I] + [_P] * 7 + [_I, _I, _I, _P, _I, _P]
    lib.svt_matryoshka_sweep_fwd.restype = _I
    lib.svt_matryoshka_sweep_fwd.argtypes = ([_I] + [_P] * 10 + [_I, _I, _I, _P, _I, _I, _I]
                                             + [_P])
    lib.svt_matryoshka_sweep_bwd.restype = _I
    lib.svt_matryoshka_sweep_bwd.argtypes = ([_I] + [_P] * 12
                                             + [_I, _I, _I, _P, _I, _I, _I, _I] + [_P])
    return lib


def _bounds(h: int, boundaries, quantum: int):
    """The prefix boundaries as a C int array, after checking them."""
    if not _levels_ok(h, boundaries, quantum):
        raise ValueError(
            f"fused Matryoshka kernel: prefix boundaries {tuple(boundaries)} not supported "
            f"for H={h} (at most {MAX_LEVELS}, strictly increasing multiples of "
            f"{quantum}, the last = H)")
    return (ctypes.c_int * len(boundaries))(*boundaries)


def _check_s(x, s, coeffs, n_levels: int) -> None:
    t, c = x.shape
    _expect("S", s, (n_levels, t, c), x.dtype, x.device)
    _expect("coeffs", coeffs, (2,), _F32, x.device)


class _ForwardKernel(Kernel):
    """csrc svt_matryoshka_fwd: center_kernel, then the coder forward body with
    the prefix snapshots. Returns what matryoshka_fwd_plain returns."""

    name = "fused_matryoshka_sae_fwd"

    def __call__(self, x, w_enc, b_enc, w_dec, b_dec, boundaries, n_split=None):
        t, c, h = _check_operands(x, w_enc, b_enc, w_dec, b_dec)
        bounds = _bounds(h, boundaries, TILE_H)
        s = launch_split(x, t, h, c, backward=False, n_split=n_split)
        outs = forward_outputs(x, h, (len(boundaries), t, c), split=s)
        self._launch(_lib().svt_matryoshka_fwd, x.device,
                     *_ptrs(x, w_enc, b_enc, w_dec, b_dec, *outs), t, c, h, bounds,
                     len(boundaries), s)
        return join_forward(outs, s)


class _BackwardKernel(Kernel):
    """csrc svt_matryoshka_bwd: the body fused_sae.bwd_route names on x_cent,
    each latent block reading S[level]: in bf16 at C <= 256 the cluster pair
    (scale_err_kernel's direct rows of S_0, then coder_bwd_pair<Act::Relu>;
    counted on fused_sae.pair_kernel too), else coder_bwd_tc; in f32 the SIMT
    body. ``route="tc"`` runs coder_bwd_tc on a pair launch. Returns what the
    route's plain version returns (backward_plain)."""

    name = "fused_matryoshka_sae_bwd"

    def __call__(self, x_cent, w_enc, b_enc, w_dec, s, coeffs, boundaries, n_split=None,
                 route=None):
        t, c, h = _check_operands(x_cent, w_enc, b_enc, w_dec)
        bounds = _bounds(h, boundaries, TILE_H)
        _check_s(x_cent, s, coeffs, len(boundaries))
        ct = coeffs[1:].expand(h).contiguous()
        route, pair = fused_sae.sae_route(x_cent, c, len(boundaries), route)
        sp = launch_split(x_cent, t, h, c, backward=True, n_split=n_split, pair=bool(pair))
        outs = backward_outputs(x_cent, h)
        self._launch(_lib().svt_matryoshka_bwd, x_cent.device,
                     *_ptrs(x_cent, w_enc, b_enc, w_dec, s, coeffs, ct, *outs,
                            split_workspace(sp, 1, h, c, c, x_cent.device, route)), t, c, h,
                     bounds, len(boundaries), pair, sp)
        fused_sae.pair_kernel.launches += pair
        return outs


class _DxKernel(Kernel):
    """csrc svt_matryoshka_dx: the coder forward bodies' dx route on x_cent, each
    latent group reading S[level]. Returns what fused_matryoshka_dx_plain
    returns."""

    name = "fused_matryoshka_sae_dx"

    def __call__(self, x_cent, w_enc, b_enc, w_dec, s, coeffs, boundaries):
        t, c, h = _check_operands(x_cent, w_enc, b_enc, w_dec)
        bounds = _bounds(h, boundaries, TILE_H)
        _check_s(x_cent, s, coeffs, len(boundaries))
        dx = torch.empty((t, c), dtype=_F32, device=x_cent.device)
        self._launch(_lib().svt_matryoshka_dx, x_cent.device,
                     *_ptrs(x_cent, w_enc, b_enc, w_dec, s, coeffs, dx), t, c, h,
                     bounds, len(boundaries))
        return dx


fwd_kernel = _ForwardKernel()
bwd_kernel = _BackwardKernel()
dx_kernel = _DxKernel()
KERNELS = (fwd_kernel, bwd_kernel, dx_kernel)


def fused_matryoshka_forward(x, w_enc, b_enc, w_dec, b_dec, boundaries, kernel=fwd_kernel):
    """The forward entry point (the kernels on CUDA tensors, through ``kernel``,
    whose count it adds to; matryoshka_fwd_plain on CPU tensors), its partials
    reduced here: (x_cent, prefix_recon, act_count, row_active, l1_sum)."""
    x_cent, prefix_recon, act_part, row_active, zsum_part = run_on_device(
        kernel, matryoshka_fwd_plain, x, w_enc, b_enc, w_dec, b_dec, boundaries)
    return x_cent, prefix_recon, act_part.sum(0), row_active, zsum_part.sum()


def fused_matryoshka_backward(x_cent, w_enc, b_enc, w_dec, s, coeffs, boundaries,
                              kernel=bwd_kernel):
    """The backward entry point on the saved x_cent (the kernel on CUDA tensors,
    through ``kernel``; the plain version of its route, backward_plain, on CPU
    tensors), db_dec's partial rows reduced here."""
    dw_enc, db_enc, dw_dec, db_dec_part = run_on_device(
        kernel, backward_plain, x_cent, w_enc, b_enc, w_dec, s, coeffs, boundaries)
    return dw_enc, db_enc, dw_dec, db_dec_part.sum(0)


def fused_matryoshka_dx(x_cent, w_enc, b_enc, w_dec, s, coeffs, boundaries):
    """The dx entry point on the saved x_cent (the kernel on CUDA tensors,
    fused_matryoshka_dx_plain on CPU tensors): dx [T, C] f32."""
    return run_on_device(dx_kernel, fused_matryoshka_dx_plain, x_cent, w_enc, b_enc, w_dec, s,
                         coeffs, boundaries)


class FusedMatryoshkaSAEFunction(torch.autograd.Function):
    """(x, W_enc, b_enc, W_dec, b_dec) -> (prefix_losses [P], l1_loss, recon,
    act_count, row_active), the counterpart of the JAX op's custom_vjp; with a
    sweep's leading [N] axis on the parameters (x shared) every output gains
    it, one launch of each sweep entry point (no dx: x is data there)."""

    @staticmethod
    def forward(ctx, x, w_enc, b_enc, w_dec, b_dec, boundaries, compute_dtype, compute_dx):
        cd = compute_dtype
        xc, we, wd = x.to(cd).contiguous(), w_enc.to(cd).contiguous(), w_dec.to(cd).contiguous()
        b_enc, b_dec = b_enc.contiguous(), b_dec.contiguous()
        forward = fused_matryoshka_sweep_forward if w_enc.ndim == 3 else fused_matryoshka_forward
        x_cent, prefix_recon, act_count, row_active, l1_sum = forward(
            xc, we, b_enc, wd, b_dec, boundaries)
        t, _ = x.shape
        h = b_enc.shape[-1]
        # [(N,) P, T, C]; full-precision x here: the kernel saw its compute-dtype cast
        errs = prefix_recon - x.float()
        prefix_losses = errs.square().mean((-2, -1))
        l1_loss = l1_sum / (t * h)
        # the backward and dx run on x_cent
        ctx.save_for_backward(x_cent, we, b_enc, wd, errs)
        ctx.boundaries, ctx.compute_dx = boundaries, compute_dx
        recon = prefix_recon[..., -1, :, :]
        ctx.mark_non_differentiable(recon, act_count, row_active)
        return prefix_losses, l1_loss, recon, act_count, row_active

    @staticmethod
    def backward(ctx, g_prefix, g_l1, *_unused):
        x_cent, we, b_enc, wd, errs = ctx.saved_tensors
        *lead, t, c = x_cent.shape
        h = b_enc.shape[-1]
        dev = x_cent.device
        if g_prefix is None:
            g_prefix = torch.zeros(errs.shape[:-2], dtype=_F32, device=dev)
        weighted = (g_prefix.float() * (2.0 / (t * c)))[..., None, None] * errs
        # S_q = Σ_{p≥q} c_p·err_p: a reverse cumulative sum over the levels
        s = weighted.flip(-3).cumsum(-3).flip(-3).to(x_cent.dtype)
        lead = tuple(lead)
        coeffs = loss_coeffs((torch.ones(lead, dtype=_F32, device=dev), 1.0, 1.0),
                             (g_l1, 1.0, t * h), lead=lead, device=dev)
        backward = fused_matryoshka_sweep_backward if lead else fused_matryoshka_backward
        dw_enc, db_enc, dw_dec, db_dec = backward(x_cent, we, b_enc, wd, s, coeffs,
                                                  ctx.boundaries)
        dx = None
        if ctx.compute_dx and ctx.needs_input_grad[0]:
            dx = fused_matryoshka_dx(x_cent, we, b_enc, wd, s, coeffs, ctx.boundaries)
        return dx, dw_enc, db_enc, dw_dec, db_dec, None, None, None


def fused_matryoshka_sae(params: dict, x: torch.Tensor, boundaries: tuple, *,
                         compute_dtype=_BF16, compute_dx: bool = False) -> dict:
    """The op itself (the JAX make_fused_matryoshka_sae_op's output): prefix_losses
    [P], l1_loss, recon, dead, activity_freq, row_active."""
    cd = compute_dtype_of(compute_dtype)
    prefix_losses, l1_loss, recon, act_count, row_active = FusedMatryoshkaSAEFunction.apply(
        x, params["W_enc"], params["b_enc"], params["W_dec"], params["b_dec"],
        tuple(boundaries), cd, compute_dx)
    return {
        "prefix_losses": prefix_losses,
        "l1_loss": l1_loss,
        "recon": recon,
        "dead": act_count == 0,
        "activity_freq": act_count / x.shape[0],
        "row_active": row_active,
    }


def fused_matryoshka_sae_loss_terms(params: dict, x: torch.Tensor, lambda_sparse: float,
                                    expansion_factor: int,
                                    prefixes: tuple = DEFAULT_MATRYOSHKA_PREFIXES, *,
                                    compute_dtype=_BF16, compute_dx: bool = False) -> dict:
    """Fused equivalent of sae_inference_and_loss("matryoshka_sae") +
    measure_inactive_units on 2-D token input, with the decomposition of
    ops/losses.matryoshka_loss_terms: loss = mean_p(prefix MSE) + λ·l1, rec_loss
    = the full-dictionary MSE, aux_loss = the prefix surcharge (may be
    negative)."""
    h = params["b_enc"].shape[0]
    out = fused_matryoshka_sae(params, x, matryoshka_prefix_counts(h, tuple(prefixes)),
                               compute_dtype=compute_dtype, compute_dx=compute_dx)
    prefix_mean = out["prefix_losses"].mean()
    rec = out["prefix_losses"][-1]
    rmse, nrmse = losses.rmse_nrmse(out["recon"], x)
    return {
        "loss": prefix_mean + lambda_sparse * out["l1_loss"],
        "rec_loss": rec,
        "l1_loss": out["l1_loss"],
        "nrmse_loss": nrmse,
        "rmse_loss": rmse,
        "aux_loss": prefix_mean - rec,
        "decoded": out["recon"],
        "dead": out["dead"],
        "activity_freq": out["activity_freq"],
        "sparsity": torch.mean(out["row_active"] / (h / expansion_factor)),
    }


# ---------------------------------------------------------------------------
# the sweep: N stacked dictionaries on one shared batch (module docstring)
# ---------------------------------------------------------------------------

def matryoshka_sweep_fwd_plain(x, w_enc, b_enc, w_dec, b_dec, boundaries):
    """Plain version of svt_matryoshka_sweep_fwd: matryoshka_fwd_plain per combo
    on the shared x, stacked (prefix_recon [N, P, T, C])."""
    return stack_plain(lambda *a: matryoshka_fwd_plain(*a, boundaries), 1,
                       x, w_enc, b_enc, w_dec, b_dec)


def matryoshka_sweep_bwd_plain(x_cent, w_enc, b_enc, w_dec, s, coeffs, boundaries):
    """Plain version of svt_matryoshka_sweep_bwd's route (backward_plain) per
    combo, stacked; ``s`` [N, P, T, C], ``coeffs`` [N, 2]."""
    return stack_plain(lambda *a: backward_plain(*a, boundaries), 0,
                       x_cent, w_enc, b_enc, w_dec, s, coeffs)


class _SweepForwardKernel(Kernel):
    """csrc svt_matryoshka_sweep_fwd: center_kernel, then the coder forward body
    with the prefix snapshots for all N combos, one launch each. Returns what
    matryoshka_sweep_fwd_plain returns."""

    name = "fused_matryoshka_sae_sweep_fwd"

    def __call__(self, x, w_enc, b_enc, w_dec, b_dec, boundaries, n_split=None):
        n, t, c, h = _check_sweep(self.name, x, w_enc, b_enc, w_dec, b_dec)
        bounds = _bounds(h, boundaries, TILE_H)
        s = launch_split(x, t, h, c, backward=False, n_split=n_split)  # one combo's
        outs = forward_outputs(x, h, (len(boundaries), t, c), n, s)
        self._launch(_lib().svt_matryoshka_sweep_fwd, x.device,
                     *_ptrs(x, w_enc, b_enc, w_dec, b_dec, *outs), t, c, h, bounds,
                     len(boundaries), n, s)
        return join_forward(outs, s)


class _SweepBackwardKernel(Kernel):
    """csrc svt_matryoshka_sweep_bwd: _BackwardKernel's route (bwd_route's from
    one dictionary's width and levels) on every combo's x_cent, each latent
    block reading its combo's S[level], one launch of each pass. Returns what
    matryoshka_sweep_bwd_plain returns."""

    name = "fused_matryoshka_sae_sweep_bwd"

    def __call__(self, x_cent, w_enc, b_enc, w_dec, s, coeffs, boundaries, n_split=None,
                 route=None):
        n, t, c, h = _check_sweep(self.name, x_cent, w_enc, b_enc, w_dec, x_rows=1)
        bounds = _bounds(h, boundaries, TILE_H)
        _expect("S", s, (n, len(boundaries), t, c), x_cent.dtype, x_cent.device)
        _expect("coeffs", coeffs, (n, 2), _F32, x_cent.device)
        ct = coeffs[:, 1:].expand(n, h).contiguous()
        route, pair = fused_sae.sae_route(x_cent, c, len(boundaries), route)
        sp = launch_split(x_cent, t, h, c, backward=True, n_split=n_split,
                          pair=bool(pair))  # one combo's
        outs = backward_outputs(x_cent, h)
        self._launch(_lib().svt_matryoshka_sweep_bwd, x_cent.device,
                     *_ptrs(x_cent, w_enc, b_enc, w_dec, s, coeffs, ct, *outs,
                            split_workspace(sp, n, h, c, c, x_cent.device, route)), t, c, h,
                     bounds, len(boundaries), n, pair, sp)
        fused_sae.pair_kernel.launches += pair
        return outs


sweep_fwd_kernel = _SweepForwardKernel()
sweep_bwd_kernel = _SweepBackwardKernel()
SWEEP_KERNELS = (sweep_fwd_kernel, sweep_bwd_kernel)


def fused_matryoshka_sweep_forward(x, w_enc, b_enc, w_dec, b_dec, boundaries):
    """The sweep forward entry point (the kernels on CUDA tensors;
    matryoshka_sweep_fwd_plain on CPU tensors), its partials reduced per combo:
    (x_cent, prefix_recon [N, P, T, C], act_count [N, H], row_active [N, T],
    l1_sum [N])."""
    x_cent, prefix_recon, act_part, row_active, zsum_part = run_on_device(
        sweep_fwd_kernel, matryoshka_sweep_fwd_plain, x, w_enc, b_enc, w_dec, b_dec, boundaries)
    return x_cent, prefix_recon, act_part.sum(1), row_active, zsum_part.sum((1, 2))


def fused_matryoshka_sweep_backward(x_cent, w_enc, b_enc, w_dec, s, coeffs, boundaries):
    """The sweep backward entry point on the saved x_cent (the kernel on CUDA
    tensors; matryoshka_sweep_bwd_plain on CPU tensors), db_dec's partial rows
    reduced per combo."""
    dw_enc, db_enc, dw_dec, db_dec_part = run_on_device(
        sweep_bwd_kernel, matryoshka_sweep_bwd_plain, x_cent, w_enc, b_enc, w_dec, s, coeffs,
        boundaries)
    return dw_enc, db_enc, dw_dec, db_dec_part.sum(1)


def fused_matryoshka_sweep_loss_terms(params: dict, x: torch.Tensor, lambdas: torch.Tensor,
                                      expansion_factor: int,
                                      prefixes: tuple = DEFAULT_MATRYOSHKA_PREFIXES, *,
                                      compute_dtype=_BF16) -> dict:
    """fused_matryoshka_sae_loss_terms for N stacked dictionaries on one shared
    batch (fused_sae.fused_sae_sweep_loss_terms' contract): loss = mean_p(prefix
    MSE) + λ_n·l1, rec_loss the full-dictionary MSE."""
    h = params["b_enc"].shape[1]
    cd = compute_dtype_of(compute_dtype)
    prefix_losses, l1_loss, recon, act_count, row_active = FusedMatryoshkaSAEFunction.apply(
        x, params["W_enc"], params["b_enc"], params["W_dec"], params["b_dec"],
        matryoshka_prefix_counts(h, tuple(prefixes)), cd, False)
    return sweep_terms(prefix_losses[:, -1], l1_loss, act_count, row_active, x.shape[0], h,
                       expansion_factor, prefix_losses.mean(1) + lambdas * l1_loss)
