"""Fused JumpReLU-SAE training op: encode + JumpReLU + decode + loss terms +
dead-latent statistics in one forward kernel, and a recomputing backward kernel
that also computes the straight-through threshold gradient.

Port of sparse_vision_tpu/ops/fused_jumprelu_sae.py; the design and the memory
argument are those of ops/fused_sae.py (the [T, H] latents never reach device
memory). Differences from the ReLU pair:
  - activation: post = pre · 1[pre > θ] (strict) with θ = exp(log_θ) in f32,
    computed outside the kernel;
  - sparsity term: L0 = Σ act_count / T, from the activity counts the forward
    already emits; ``l1_loss`` = Σ post / (T·H) is a metric only;
  - backward: no sparsity term in dpre (the L0 moves only the thresholds); the
    two STE paths fuse into one threshold gradient,
      dθ = Σ_t win · (dpost · (−θ/ε) + c_l0 · (−1/ε)),  win = 1[|pre − θ| ≤ ε/2]
    (inclusive), with c_l0 = g_l0 / T; d log_θ = dθ · θ is applied in torch.
    The bandwidth ε reaches the kernel as a runtime float.

Kernels: in bf16 (the training path) the forward and the backward run the
coder body family's tensor-core bodies (csrc/coder.cuh, their JumpReLU
epilogues, Act::Jump) at any width that fwd_takes and bwd_takes allow (T and H
multiples of 128, C of 8), each after center_kernel (x_cent; the backward
recomputes it from the saved x). The forward is the ReLU forward's width route
(register-held recon to C = 512, updated in place above) with the strict
threshold; it leaves per-64-token partials of the activity counts and of Σ post,
whose total is the L1 sum. The backward first runs scale_err_kernel
(round(c_rec·err) from the saved f32 error, and the direct rows of db_dec),
then the body fused_sae.bwd_route names: at C <= 256 "pair", coder_bwd_pair
(two CTAs of a thread block cluster a latent block, one holding dW_enc and
one dW_dec in registers for the whole sweep; counted on ``pair_kernel`` as
well as on the launching wrapper), wider "tc", coder_bwd_tc. In
f32 (the check path) both run the coder family's SIMT bodies with the same
epilogues, at any width (T and H multiples of 128), after center_kernel; the
backward reads the saved f32 error itself. can_fuse asks the coder bodies'
rule (fused_sae.bodies_take) with the dtype.

Dispatch rule: a CPU tensor runs the plain PyTorch version of each kernel (the
same formulas, the same cast points); a CUDA tensor launches the kernel or
raises. There is no fallback from one to the other.

Cast points (identical to the Pallas kernels): x, W_enc and W_dec are cast to the
compute dtype before the kernels; ``x − b_dec`` is a difference in that dtype;
``b_enc`` and the ``+ b_dec`` on recon are f32; the saved error ``recon − x``
stays f32 and the backward rounds ``drecon`` to the compute dtype only before
its products; every product accumulates in f32. One documented difference in
bf16: the centring term of ``db_dec`` rounds the whole-batch ``db_enc`` to bf16
once, where the TPU kernel rounds each 2048-token tile's partial sum, so bf16
``db_dec`` agrees with the JAX op within a tolerance and exactly in f32.

The sweep (train/sweep_vmap.py; ops/fused_sae.py's docstring):
FusedJumpReLUSAEFunction on parameters with a leading combo axis runs N
stacked dictionaries on one shared batch through svt_jumprelu_sweep_fwd /
_bwd, one launch each (with their center_kernel and scale_err_kernel
passes, each one launch for all combos).

Differentiability contract: gradients flow through ``rec_loss`` and ``l0_loss``
only (loss = rec + λ·L0). ``l1_loss``, ``recon`` and the statistics are marked
non-differentiable, and ``x`` is data: its gradient is None.
"""

from __future__ import annotations

import ctypes
import functools

import torch

from sparse_vision_tpu_torch.models.sae import JUMPRELU_BANDWIDTH
from sparse_vision_tpu_torch.ops import losses, native
from sparse_vision_tpu_torch.ops.fused_sae import (
    _F32,
    _BF16,
    BLOCK_H,
    PART_T,
    Kernel,
    _check_sweep,
    _expect,
    _ptrs,
    _r,
    bodies_take,
    bwd_route,
    center_plain,
    centring_rows_plain,
    compute_dtype_of,
    direct_rows,
    join_splits,
    launch_split,
    loss_coeffs,
    run_on_device,
    scale_err_plain,
    split_empty,
    split_workspace,
    stack_plain,
    sweep_terms,
)

def fwd_takes(t: int, h: int, c: int = 256, dtype=_BF16) -> bool:
    """True when the CUDA forward takes this shape with ``dtype`` operands: the
    coder bodies' rule (fused_sae.bodies_take: T and H multiples of 128; in
    bf16 C a multiple of 8, in f32 any C)."""
    return bodies_take(t, h, c, c, dtype)


def bwd_takes(t: int, h: int, c: int = 256, dtype=_BF16) -> bool:
    """True when the CUDA backward takes this shape with ``dtype`` operands:
    the forward's rule, fwd_takes."""
    return fwd_takes(t, h, c, dtype)


def can_fuse(t: int, h: int, c: int = 256, dtype=_BF16) -> bool:
    """True when the CUDA forward and backward take this (tokens, latents,
    channels) shape with ``dtype`` operands. The CPU plain versions take any
    shape."""
    return fwd_takes(t, h, c, dtype) and bwd_takes(t, h, c, dtype)


# ---------------------------------------------------------------------------
# plain versions (CPU path; the reference the kernels are held against)
# ---------------------------------------------------------------------------

def fused_jumprelu_forward_plain(x, w_enc, b_enc, thr, w_dec, b_dec):
    """Plain forward of csrc svt_jumprelu_fwd (either route). ``x``, ``w_enc``, ``w_dec`` are
    in the compute dtype, ``thr`` = exp(log_threshold) in f32. Returns (recon
    [T, C] f32, act_count [H], row_active [T], l1_sum scalar)."""
    cd = x.dtype
    xc = (x - b_dec.to(cd)).float()
    pre = xc @ w_enc.float() + b_enc
    post = torch.where(pre > thr, pre, torch.zeros((), device=pre.device))
    recon = _r(post, cd) @ w_dec.float() + b_dec
    active = post != 0
    return recon, active.sum(0).float(), active.sum(1).float(), post.sum()


def fused_jumprelu_backward_plain(x, w_enc, b_enc, thr, w_dec, b_dec, err, coeffs,
                                  bandwidth):
    """Plain backward of csrc svt_jumprelu_bwd's f32 route (center_kernel, then
    coder_bwd_kernel<float, true, Act::Jump>). ``err`` is the f32 residual
    ``recon − x``; ``coeffs`` = (c_rec, c_l0) with c_rec = 2·g_rec/(T·C),
    c_l0 = g_l0/T. Returns f32 (dW_enc [C, H], db_enc [H], dθ [H], dW_dec [H, C],
    db_dec [C])."""
    cd = x.dtype
    c_rec, c_l0 = coeffs[0], coeffs[1]
    eps = bandwidth
    xc = (x - b_dec.to(cd)).float()
    we = w_enc.float()
    pre = xc @ we + b_enc
    mask = pre > thr
    zero = torch.zeros((), device=pre.device)
    post = torch.where(mask, pre, zero)
    win = (torch.abs(pre - thr) <= eps / 2).float()
    drecon = c_rec * err
    dpost = _r(drecon, cd) @ w_dec.float().T
    dpre = torch.where(mask, dpost, zero)
    dw_enc = xc.T @ _r(dpre, cd)
    db_enc = dpre.sum(0)
    dthr = (win * (dpost * (-thr / eps) + c_l0 * (-1.0 / eps))).sum(0)
    dw_dec = _r(post, cd).T @ _r(drecon, cd)
    db_dec = drecon.sum(0) - _r(db_enc, cd) @ we.T
    return dw_enc, db_enc, dthr, dw_dec, db_dec


def jumprelu_bwd_tc_plain(x, w_enc, b_enc, thr, w_dec, b_dec, err, coeffs, bandwidth):
    """Plain version of svt_jumprelu_bwd's tensor-core route (the bf16 training
    path): center_kernel, scale_err_kernel, then coder_bwd_tc<true, Act::Jump>
    on x_cent and round(c_rec·err). Arguments and results as for
    fused_jumprelu_backward_plain; db_dec is the sum of the pre-pass's direct
    rows and the centring term."""
    cd = x.dtype
    c_l0, eps = coeffs[1], bandwidth
    x_cent = center_plain(x, b_dec).float()
    dr, direct = scale_err_plain(err, coeffs[0], cd)
    dr = dr.float()
    pre = x_cent @ w_enc.float() + b_enc
    mask = pre > thr
    zero = torch.zeros((), device=pre.device)
    dpost = dr @ w_dec.float().T
    dpre = torch.where(mask, dpost, zero)
    win = torch.abs(pre - thr) <= eps / 2
    dthr = torch.where(win, dpost * (-thr / eps) + c_l0 * (-1.0 / eps), zero).sum(0)
    db_enc = dpre.sum(0)
    db_dec = torch.cat([direct, centring_rows_plain(db_enc, w_enc)]).sum(0)
    return (x_cent.T @ _r(dpre, cd), db_enc, dthr,
            _r(torch.where(mask, pre, zero), cd).T @ dr, db_dec)


# the plain version of each backward route (fused_sae.bwd_route): the pair
# computes coder_bwd_tc's function, at its own summation order
ROUTE_PLAIN = {"pair": jumprelu_bwd_tc_plain, "tc": jumprelu_bwd_tc_plain,
               "simt": fused_jumprelu_backward_plain}


def backward_plain(x, *args, route=None):
    """The plain version of the route the card's backward takes for ``x``
    (``route``, or fused_sae.bwd_route's for its width and dtype):
    jumprelu_bwd_tc_plain for "pair" and "tc" (bf16), fused_jumprelu_backward_plain
    for "simt" (f32)."""
    c = x.shape[-1]
    return ROUTE_PLAIN[route or bwd_route(c, c, act="jump", dtype=x.dtype)](x, *args)


# ---------------------------------------------------------------------------
# CUDA kernels
# ---------------------------------------------------------------------------

_P = ctypes.c_void_p
_I = ctypes.c_int
_F = ctypes.c_float


@functools.cache
def _lib() -> ctypes.CDLL:
    lib = native.load("fused_jumprelu_sae")
    # every launching entry point ends in (..., n_split, stream); the backwards'
    # last pointer is split_ws (csrc/coder.cuh, "Splits"), their ``pair``
    # comes before n_split (bwd_route)
    lib.svt_jumprelu_fwd.restype = _I
    lib.svt_jumprelu_fwd.argtypes = [_I] + [_P] * 11 + [_I] * 4 + [_P]
    lib.svt_jumprelu_bwd.restype = _I
    lib.svt_jumprelu_bwd.argtypes = ([_I] + [_P] * 8 + [_F, _F, _F] + [_P] * 8
                                     + [_I] * 5 + [_P])
    lib.svt_jumprelu_sweep_fwd.restype = _I
    lib.svt_jumprelu_sweep_fwd.argtypes = [_I] + [_P] * 11 + [_I] * 5 + [_P]
    lib.svt_jumprelu_sweep_bwd.restype = _I
    lib.svt_jumprelu_sweep_bwd.argtypes = ([_I] + [_P] * 8 + [_F, _F, _F] + [_P] * 8
                                           + [_I] * 6 + [_P])
    lib.svt_jumprelu_pair_clusters.restype = _I
    lib.svt_jumprelu_pair_clusters.argtypes = [_P]
    return lib


def pair_clusters() -> int:
    """The clusters of coder_bwd_pair (two CTAs each) that the current card
    holds at once (cudaOccupancyMaxActiveClusters); raises where the query
    fails."""
    out = (ctypes.c_int * 1)()
    rc = _lib().svt_jumprelu_pair_clusters(out)
    if rc != 0:
        raise RuntimeError(f"svt_jumprelu_pair_clusters failed: cudaError_t {rc}")
    return out[0]


def _check_operands(x, w_enc, b_enc, thr, w_dec, b_dec, backward: bool = False):
    t, c = x.shape
    h = b_enc.shape[0]
    if x.dtype not in (_F32, _BF16):
        raise ValueError(f"fused JumpReLU kernel: compute dtype {x.dtype} not supported")
    if not fwd_takes(t, h, c, x.dtype):
        raise ValueError(
            f"fused JumpReLU {'backward' if backward else 'kernel'}: shape T={t}, C={c}, "
            f"H={h} not supported with {x.dtype} operands (T and H multiples of 128; "
            "bf16: C a multiple of 8)"
        )
    dev = x.device
    _expect("x", x, (t, c), x.dtype, dev)
    _expect("W_enc", w_enc, (c, h), x.dtype, dev)
    _expect("b_enc", b_enc, (h,), _F32, dev)
    _expect("threshold", thr, (h,), _F32, dev)
    _expect("W_dec", w_dec, (h, c), x.dtype, dev)
    _expect("b_dec", b_dec, (c,), _F32, dev)
    return t, c, h


class _ForwardKernel(Kernel):
    """csrc svt_jumprelu_fwd: center_kernel and the coder forward route with
    the JumpReLU epilogue (bf16: tensor cores; f32: the SIMT body). The
    partials are reduced here."""

    name = "fused_jumprelu_sae_fwd"

    def __call__(self, x, w_enc, b_enc, thr, w_dec, b_dec, n_split=None):
        t, c, h = _check_operands(x, w_enc, b_enc, thr, w_dec, b_dec)
        dev = x.device
        s = launch_split(x, t, h, c, backward=False, n_split=n_split)
        recon = split_empty(s, (t, c), dev)
        # per-64-token partials of the counts and of Σ post (the L1 sum)
        act_part = torch.empty((t // PART_T, h), dtype=_F32, device=dev)
        l1_part = torch.empty_like(act_part)
        row_active = split_empty(s, (t,), dev)
        x_cent = torch.empty_like(x)  # center_kernel's output
        self._launch(_lib().svt_jumprelu_fwd, dev,
                     *_ptrs(x, w_enc, b_enc, thr, w_dec, b_dec, recon, act_part, row_active,
                            l1_part, x_cent), t, c, h, s)
        return (join_splits(recon, s), act_part.sum(0), join_splits(row_active, s),
                l1_part.sum())


class _PairBody(Kernel):
    """The cluster-pair backward body (csrc/coder.cuh coder_bwd_pair,
    fused_sae.bwd_route's "pair"): its count goes up wherever a JumpReLU
    backward launch runs it (the launching wrapper's own count goes up too)."""

    name = "coder_bwd_pair"


pair_kernel = _PairBody()


def _route(x, c: int, route) -> tuple:
    """(route, its ``pair`` flag for the backward entry points): ``route`` where
    the caller names one (chip_smoke.py times "tc" on a pair launch), else
    fused_sae.bwd_route's for a JumpReLU backward of width c in x's dtype."""
    route = route or bwd_route(c, c, act="jump", dtype=x.dtype)
    return route, int(route == "pair")


class _BackwardKernel(Kernel):
    """csrc svt_jumprelu_bwd: in bf16 center_kernel, scale_err_kernel and the
    body bwd_route names, coder_bwd_pair<Act::Jump> at C <= 256, else
    coder_bwd_tc<true, Act::Jump> (both jumprelu_bwd_tc_plain), in f32
    center_kernel and coder_bwd_kernel<float, true, Act::Jump>
    (fused_jumprelu_backward_plain). db_dec's partial rows are reduced here."""

    name = "fused_jumprelu_sae_bwd"

    def __call__(self, x, w_enc, b_enc, thr, w_dec, b_dec, err, coeffs, bandwidth,
                 n_split=None, route=None):
        t, c, h = _check_operands(x, w_enc, b_enc, thr, w_dec, b_dec, backward=True)
        dev = x.device
        _expect("err", err, (t, c), _F32, dev)
        _expect("coeffs", coeffs, (2,), _F32, dev)
        bf16 = x.dtype == _BF16
        route, pair = _route(x, c, route)
        s = launch_split(x, t, h, c, backward=True, n_split=n_split, pair=bool(pair))
        dw_enc = torch.empty((c, h), dtype=_F32, device=dev)
        db_enc = torch.empty((h,), dtype=_F32, device=dev)
        dthr = torch.empty((h,), dtype=_F32, device=dev)
        dw_dec = torch.empty((h, c), dtype=_F32, device=dev)
        # the direct rows, then one centring row per 64 latents
        rows = direct_rows(t, x.dtype) + h // BLOCK_H
        db_dec_part = torch.empty((rows, c), dtype=_F32, device=dev)
        x_cent = torch.empty_like(x)  # center_kernel's output
        # bf16: round(c_rec·err), scale_err_kernel's output; f32 reads err itself
        err_s = torch.empty((t, c), dtype=_BF16, device=dev) if bf16 else None
        eps = float(bandwidth)
        self._launch(_lib().svt_jumprelu_bwd, dev,
                     *_ptrs(x, w_enc, b_enc, thr, w_dec, b_dec, err, coeffs),
                     eps, eps / 2, -1.0 / eps,
                     *_ptrs(x, dw_enc, db_enc, dthr, dw_dec, db_dec_part, x_cent, err_s,
                            split_workspace(s, 1, h, c, c, dev, route))[2:], t, c, h, pair, s)
        pair_kernel.launches += pair
        return dw_enc, db_enc, dthr, dw_dec, db_dec_part.sum(0)


fwd_kernel = _ForwardKernel()
bwd_kernel = _BackwardKernel()
KERNELS = (fwd_kernel, bwd_kernel)


def fused_jumprelu_forward(*args, kernel=fwd_kernel):
    """The forward kernel on CUDA tensors (through ``kernel``, whose count it
    adds to), its plain version on CPU tensors."""
    return run_on_device(kernel, fused_jumprelu_forward_plain, *args)


def fused_jumprelu_backward(*args, kernel=bwd_kernel):
    """The backward kernel on CUDA tensors (through ``kernel``), the plain
    version of its route for the operands' dtype (backward_plain) on CPU
    tensors."""
    return run_on_device(kernel, backward_plain, *args)


class FusedJumpReLUSAEFunction(torch.autograd.Function):
    """(x, W_enc, b_enc, log_threshold, W_dec, b_dec) -> (rec_loss, l0_loss,
    l1_loss, recon, act_count, row_active), the counterpart of the JAX op's
    custom_vjp; with a sweep's leading [N] axis on the parameters (x shared)
    every output gains it, one launch of each sweep entry point."""

    @staticmethod
    def forward(ctx, x, w_enc, b_enc, log_threshold, w_dec, b_dec, compute_dtype, bandwidth):
        cd = compute_dtype
        xc, we, wd = x.to(cd).contiguous(), w_enc.to(cd).contiguous(), w_dec.to(cd).contiguous()
        b_enc, b_dec = b_enc.contiguous(), b_dec.contiguous()
        thr = torch.exp(log_threshold).float().contiguous()
        forward = fused_jumprelu_sweep_forward if w_enc.ndim == 3 else fused_jumprelu_forward
        recon, act_count, row_active, l1_sum = forward(xc, we, b_enc, thr, wd, b_dec)
        t, _ = x.shape
        h = b_enc.shape[-1]
        err = recon - x  # f32, against x in its own dtype
        rec_loss = err.square().mean((-2, -1))
        l0_loss = act_count.sum(-1) / t
        l1_loss = l1_sum / (t * h)
        ctx.save_for_backward(xc, we, b_enc, thr, wd, b_dec, err)
        ctx.bandwidth = bandwidth
        ctx.mark_non_differentiable(l1_loss, recon, act_count, row_active)
        return rec_loss, l0_loss, l1_loss, recon, act_count, row_active

    @staticmethod
    def backward(ctx, g_rec, g_l0, *_unused):
        xc, we, b_enc, thr, wd, b_dec, err = ctx.saved_tensors
        *lead, t, c = err.shape
        coeffs = loss_coeffs((g_rec, 2.0, t * c), (g_l0, 1.0, t), lead=tuple(lead),
                             device=xc.device)
        backward = fused_jumprelu_sweep_backward if lead else fused_jumprelu_backward
        dw_enc, db_enc, dthr, dw_dec, db_dec = backward(
            xc, we, b_enc, thr, wd, b_dec, err, coeffs, ctx.bandwidth)
        # chain rule through θ = exp(log_θ)
        return None, dw_enc, db_enc, dthr * thr, dw_dec, db_dec, None, None


def fused_jumprelu_sae_loss_terms(params: dict, x: torch.Tensor, lambda_sparse: float,
                                  expansion_factor: int, *, compute_dtype=_BF16,
                                  bandwidth: float = JUMPRELU_BANDWIDTH) -> dict:
    """Fused equivalent of jumprelu_sae_apply + jumprelu_loss_terms +
    measure_inactive_units on 2-D token input (loss = rec + λ·L0; l1 is a
    metric). RMSE/NRMSE come from the [T, C] reconstruction in plain torch."""
    cd = compute_dtype_of(compute_dtype)
    rec_loss, l0_loss, l1_loss, recon, act_count, row_active = FusedJumpReLUSAEFunction.apply(
        x, params["W_enc"], params["b_enc"], params["log_threshold"], params["W_dec"],
        params["b_dec"], cd, bandwidth)
    t = x.shape[0]
    h = params["b_enc"].shape[0]
    rmse, nrmse = losses.rmse_nrmse(recon, x)
    return {
        "loss": rec_loss + lambda_sparse * l0_loss,
        "rec_loss": rec_loss,
        "l0_loss": l0_loss,
        "l1_loss": l1_loss,
        "aux_loss": torch.zeros((), dtype=_F32, device=x.device),
        "nrmse_loss": nrmse,
        "rmse_loss": rmse,
        "decoded": recon,
        "dead": act_count == 0,
        "activity_freq": act_count / t,
        "sparsity": torch.mean(row_active / (h / expansion_factor)),
    }


# ---------------------------------------------------------------------------
# the sweep: N stacked dictionaries on one shared batch (module docstring)
# ---------------------------------------------------------------------------

def jumprelu_sweep_fwd_plain(x, w_enc, b_enc, thr, w_dec, b_dec):
    """Plain version of svt_jumprelu_sweep_fwd: fused_jumprelu_forward_plain per
    combo on the shared x, stacked, the sums as one partial row (recon [N, T,
    C], act_part [N, 1, H], row_active [N, T], l1_part [N, 1, 1]), as the
    kernel's partials come."""
    recon, act, row_active, l1 = stack_plain(fused_jumprelu_forward_plain, 1,
                                             x, w_enc, b_enc, thr, w_dec, b_dec)
    return recon, act[:, None], row_active, l1[:, None, None]


def jumprelu_sweep_bwd_plain(x, w_enc, b_enc, thr, w_dec, b_dec, err, coeffs, bandwidth):
    """Plain version of svt_jumprelu_sweep_bwd's route for x's dtype
    (backward_plain) per combo on the shared x, stacked, db_dec as one partial
    row [N, 1, C]; ``err`` [N, T, C], ``coeffs`` [N, 2]."""
    *grads, db_dec = stack_plain(lambda *a: backward_plain(*a, bandwidth), 1,
                                 x, w_enc, b_enc, thr, w_dec, b_dec, err, coeffs)
    return (*grads, db_dec[:, None])


def _check_sweep_operands(name, x, w_enc, b_enc, thr, w_dec, b_dec):
    n, t, c, h = _check_sweep(name, x, w_enc, b_enc, w_dec, b_dec)
    _expect("threshold", thr, (n, h), _F32, x.device)
    return n, t, c, h


class _SweepForwardKernel(Kernel):
    """csrc svt_jumprelu_sweep_fwd: center_kernel and the JumpReLU coder forward
    for all N combos, one launch each. Returns what jumprelu_sweep_fwd_plain
    returns (one partial row per 64 tokens)."""

    name = "fused_jumprelu_sae_sweep_fwd"

    def __call__(self, x, w_enc, b_enc, thr, w_dec, b_dec, n_split=None):
        n, t, c, h = _check_sweep_operands(self.name, x, w_enc, b_enc, thr, w_dec, b_dec)
        dev = x.device
        s = launch_split(x, t, h, c, backward=False, n_split=n_split)  # one combo's
        recon = split_empty(s, (n, t, c), dev)
        act_part = torch.empty((n, t // PART_T, h), dtype=_F32, device=dev)
        l1_part = torch.empty_like(act_part)
        row_active = split_empty(s, (n, t), dev)
        x_cent = torch.empty((n, t, c), dtype=x.dtype, device=dev)
        self._launch(_lib().svt_jumprelu_sweep_fwd, dev,
                     *_ptrs(x, w_enc, b_enc, thr, w_dec, b_dec, recon, act_part, row_active,
                            l1_part, x_cent), t, c, h, n, s)
        return join_splits(recon, s), act_part, join_splits(row_active, s), l1_part


class _SweepBackwardKernel(Kernel):
    """csrc svt_jumprelu_sweep_bwd: _BackwardKernel's route for all N combos
    (bwd_route's from one dictionary's width), one launch of each pass. Returns
    what jumprelu_sweep_bwd_plain returns (db_dec's partial rows)."""

    name = "fused_jumprelu_sae_sweep_bwd"

    def __call__(self, x, w_enc, b_enc, thr, w_dec, b_dec, err, coeffs, bandwidth,
                 n_split=None, route=None):
        n, t, c, h = _check_sweep_operands(self.name, x, w_enc, b_enc, thr, w_dec, b_dec)
        dev = x.device
        _expect("err", err, (n, t, c), _F32, dev)
        _expect("coeffs", coeffs, (n, 2), _F32, dev)
        bf16 = x.dtype == _BF16
        route, pair = _route(x, c, route)
        s = launch_split(x, t, h, c, backward=True, n_split=n_split,
                         pair=bool(pair))  # one combo's
        dw_enc = torch.empty((n, c, h), dtype=_F32, device=dev)
        db_enc = torch.empty((n, h), dtype=_F32, device=dev)
        dthr = torch.empty((n, h), dtype=_F32, device=dev)
        dw_dec = torch.empty((n, h, c), dtype=_F32, device=dev)
        rows = direct_rows(t, x.dtype) + h // BLOCK_H
        db_dec_part = torch.empty((n, rows, c), dtype=_F32, device=dev)
        x_cent = torch.empty((n, t, c), dtype=x.dtype, device=dev)
        err_s = torch.empty((n, t, c), dtype=_BF16, device=dev) if bf16 else None
        eps = float(bandwidth)
        self._launch(_lib().svt_jumprelu_sweep_bwd, dev,
                     *_ptrs(x, w_enc, b_enc, thr, w_dec, b_dec, err, coeffs),
                     eps, eps / 2, -1.0 / eps,
                     *_ptrs(x, dw_enc, db_enc, dthr, dw_dec, db_dec_part, x_cent, err_s,
                            split_workspace(s, n, h, c, c, dev, route))[2:], t, c, h, n, pair,
                     s)
        pair_kernel.launches += pair
        return dw_enc, db_enc, dthr, dw_dec, db_dec_part


sweep_fwd_kernel = _SweepForwardKernel()
sweep_bwd_kernel = _SweepBackwardKernel()
SWEEP_KERNELS = (sweep_fwd_kernel, sweep_bwd_kernel)


def fused_jumprelu_sweep_forward(*args):
    """The sweep forward kernel on CUDA tensors, its plain version on CPU
    tensors; the partials reduced per combo: (recon [N, T, C],
    act_count [N, H], row_active [N, T], l1_sum [N])."""
    recon, act_part, row_active, l1_part = run_on_device(
        sweep_fwd_kernel, jumprelu_sweep_fwd_plain, *args)
    return recon, act_part.sum(1), row_active, l1_part.sum((1, 2))


def fused_jumprelu_sweep_backward(*args):
    """The sweep backward kernel on CUDA tensors, the plain version of its
    route on CPU tensors; db_dec's rows reduced per combo."""
    *grads, db_dec_part = run_on_device(sweep_bwd_kernel, jumprelu_sweep_bwd_plain, *args)
    return (*grads, db_dec_part.sum(1))


def fused_jumprelu_sweep_loss_terms(params: dict, x: torch.Tensor, lambdas: torch.Tensor,
                                    expansion_factor: int, *, compute_dtype=_BF16,
                                    bandwidth: float = JUMPRELU_BANDWIDTH) -> dict:
    """fused_jumprelu_sae_loss_terms for N stacked dictionaries on one shared
    batch (fused_sae.fused_sae_sweep_loss_terms' contract): loss = rec + λ_n·L0."""
    cd = compute_dtype_of(compute_dtype)
    rec_loss, l0_loss, l1_loss, recon, act_count, row_active = FusedJumpReLUSAEFunction.apply(
        x, params["W_enc"], params["b_enc"], params["log_threshold"], params["W_dec"],
        params["b_dec"], cd, bandwidth)
    return sweep_terms(rec_loss, l1_loss, act_count, row_active, x.shape[0],
                       params["b_enc"].shape[1], expansion_factor, rec_loss + lambdas * l0_loss)
