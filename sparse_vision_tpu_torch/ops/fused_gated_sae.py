"""Fused Gated-SAE training op: gate product + gate/magnitude paths + decode of
the reconstruction and of via_gate + loss terms + dead-latent statistics in one
forward kernel, and a recomputing backward kernel.

Port of sparse_vision_tpu/ops/fused_gated_sae.py; the design and the memory
argument are those of ops/fused_sae.py (no [T, H] matrix reaches device memory).

Algebraic fusion, as in the JAX op: the weight-shared magnitude path
``x_cent @ (W_gate ⊙ exp(r_mag))`` equals ``(x_cent @ W_gate) ⊙ exp(r_mag)``
because exp(r_mag) rescales columns, so ONE gate product ``g`` feeds both paths
(the stock path runs two). The two differ by f32 rounding only.

Loss: total = rec + λ·l1 + aux with rec = mse(recon, x), l1 = mean(relu(π_gate)),
aux = mse(via_gate, x), via_gate = relu(π_gate) @ stopgrad(W_dec) + stopgrad(b_dec).
Gradient notes: the Heaviside gate (1 / 0.5 / 0 at π > / == / < 0) is detached;
via_gate gives W_dec and b_dec no gradient; b_dec gets Σ drecon − Σ_rows(dg) @
W_gateᵀ; dr_mag = Σ_t(d_premag · g) · exp(r_mag), g without b_gate.

Kernels: in bf16 (the training path) the forward and the backward run the
coder body family's tensor-core bodies (csrc/coder.cuh, their gated epilogues)
at any width that fwd_takes and bwd_takes allow (T and H multiples of 128, C of
8), each after center_kernel (x_cent; the backward recomputes it from the saved
x). The forward at C ≤ 256 holds recon and via_gate in registers together, one
gate product and one W_dec stream feeding both decodes (Act::Gated); wider, it
is two launches of the ReLU forward's width route, recon with the counts
(Act::GatedEnc), then via_gate with the sums of relu(π_gate) (Act::GatedPi).
It leaves per-64-token partials of the counts and of Σ relu(π_gate), whose
total is the L1 sum. The backward first runs scale_err_kernel on both
errors, then the body fused_sae.bwd_route names: at 128 < C ≤ 256 "pair",
coder_bwd_pair<Act::Gated> (one launch in clusters of two CTAs a latent
block: E holds dW_gate and sends g in f32, D runs the gated epilogue and its
three products, holds dW_dec and sends round(dg) back; counted on
``pair_kernel`` as well), else "tc", coder_bwd_tc's gated epilogue (three
products per token tile, the second error's W_dec tiles streamed again). Both
compute one function, so their plain version is one (ROUTE_PLAIN). In f32
(the check path) both run the coder family's SIMT bodies with the same
epilogues, at any width (T and H multiples of 128), after center_kernel: the
forward as two launches at every width (GatedEnc, GatedPi), the backward on
copies of both saved f32 errors in one [2, T, C] workspace. can_fuse asks
the coder bodies' rule (fused_sae.bodies_take) with the dtype.

Dispatch rule: a CPU tensor runs the plain PyTorch version of each kernel (the
same formulas, the same cast points); a CUDA tensor launches the kernel or
raises. There is no fallback from one to the other.

Cast points (identical to the Pallas kernels): x, W_gate and W_dec are cast to
the compute dtype before the kernels; ``x − b_dec`` is a difference in that
dtype; ``exp(r_mag)`` is computed in f32 outside the kernels; b_gate, b_mag and
the ``+ b_dec`` on recon and via are f32; both saved errors (``recon − x``,
``via − x``) stay f32 and the backward rounds ``drecon``/``dvia`` to the compute
dtype only before their products; every product accumulates in f32. One
documented difference in bf16: the centring term of ``db_dec`` rounds the
whole-batch row sum of ``dg`` to bf16 once, where the TPU kernel rounds each
1024-token tile's partial sum, so bf16 ``db_dec`` agrees with the JAX op within
a tolerance and exactly in f32.

The sweep (train/sweep_vmap.py; ops/fused_sae.py's docstring):
FusedGatedSAEFunction on parameters with a leading combo axis runs N stacked
dictionaries on one shared batch through svt_gated_sweep_fwd / _bwd, one
launch of each pass for all combos (the forward above C 256 two,
Act::GatedEnc and Act::GatedPi, each batched).

Differentiability contract: gradients flow through ``rec_loss``, ``l1_loss`` and
``aux_loss`` only. ``recon`` and the statistics are marked non-differentiable,
and ``x`` is data: its gradient is None.
"""

from __future__ import annotations

import ctypes
import functools

import torch

from sparse_vision_tpu_torch.models.sae import heaviside_gate
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

def _gate_paths(x, w_gate, b_gate, b_mag, er, b_dec):
    """x_cent (f32 copy of the compute-dtype values), g, pre_gate, pre_mag, gate."""
    cd = x.dtype
    xc = (x - b_dec.to(cd)).float()
    g = xc @ w_gate.float()
    pre_gate = g + b_gate
    pre_mag = g * er + b_mag
    return xc, g, pre_gate, pre_mag, heaviside_gate(pre_gate)


def fused_gated_forward_plain(x, w_gate, b_gate, b_mag, er, w_dec, b_dec):
    """Plain forward of csrc svt_gated_fwd (either route). ``x``, ``w_gate``, ``w_dec`` are in
    the compute dtype, ``er`` = exp(r_mag) in f32. Returns (recon [T, C] f32,
    via [T, C] f32, act_count [H], row_active [T], l1_sum scalar)."""
    cd = x.dtype
    _, _, pre_gate, pre_mag, gate = _gate_paths(x, w_gate, b_gate, b_mag, er, b_dec)
    enc = gate * torch.relu(pre_mag)
    relu_pi = torch.relu(pre_gate)
    wd = w_dec.float()
    recon = _r(enc, cd) @ wd + b_dec
    via = _r(relu_pi, cd) @ wd + b_dec
    active = enc != 0
    return recon, via, active.sum(0).float(), active.sum(1).float(), relu_pi.sum()


def fused_gated_backward_plain(x, w_gate, b_gate, b_mag, er, w_dec, b_dec, err_rec,
                               err_via, coeffs):
    """Plain backward of csrc svt_gated_bwd's f32 route (center_kernel, then
    coder_bwd_kernel<float, true, Act::Gated>). ``err_rec``/``err_via`` are the f32
    residuals; ``coeffs`` = (c_rec, c_l1, c_aux) with c_rec = 2·g_rec/(T·C),
    c_l1 = g_l1/(T·H), c_aux = 2·g_aux/(T·C). Returns f32 (dW_gate [C, H],
    db_gate [H], db_mag [H], dr_mag [H], dW_dec [H, C], db_dec [C])."""
    cd = x.dtype
    c_rec, c_l1, c_aux = coeffs[0], coeffs[1], coeffs[2]
    xc, g, pre_gate, pre_mag, gate = _gate_paths(x, w_gate, b_gate, b_mag, er, b_dec)
    enc = gate * torch.relu(pre_mag)
    drecon = c_rec * err_rec
    dvia = c_aux * err_via
    wdt = w_dec.float().T
    denc = _r(drecon, cd) @ wdt
    d_relu_pi = _r(dvia, cd) @ wdt + c_l1
    zero = torch.zeros((), device=g.device)
    d_premag = torch.where(pre_mag > 0, denc * gate, zero)
    d_pregate = torch.where(pre_gate > 0, d_relu_pi, zero)
    dg = d_premag * er + d_pregate
    dw_gate = xc.T @ _r(dg, cd)
    dw_dec = _r(enc, cd).T @ _r(drecon, cd)
    db_dec = drecon.sum(0) - _r(dg.sum(0), cd) @ w_gate.float().T
    return (dw_gate, d_pregate.sum(0), d_premag.sum(0), (d_premag * g).sum(0) * er,
            dw_dec, db_dec)


def gated_bwd_tc_plain(x, w_gate, b_gate, b_mag, er, w_dec, b_dec, err_rec, err_via, coeffs):
    """Plain version of svt_gated_bwd's tensor-core route (the bf16 training
    path): center_kernel, scale_err_kernel on both errors, then
    coder_bwd_tc<true, Act::Gated> on x_cent, round(c_rec·err_rec) and
    round(c_aux·err_via). Arguments and results as for
    fused_gated_backward_plain; db_dec is the sum of the pre-pass's direct rows
    and the centring term."""
    cd = x.dtype
    x_cent = center_plain(x, b_dec).float()
    dr, direct = scale_err_plain(err_rec, coeffs[0], cd)
    dv, _ = scale_err_plain(err_via, coeffs[2], cd)
    dr = dr.float()
    g = x_cent @ w_gate.float()
    pre_gate = g + b_gate
    pre_mag = g * er + b_mag
    gate = heaviside_gate(pre_gate)
    wdt = w_dec.float().T
    zero = torch.zeros((), device=g.device)
    d_premag = torch.where(pre_mag > 0, (dr @ wdt) * gate, zero)
    d_pregate = torch.where(pre_gate > 0, dv.float() @ wdt + coeffs[1], zero)
    dg = d_premag * er + d_pregate
    cent = -(_r(dg.sum(0), cd) @ w_gate.float().T)
    return (x_cent.T @ _r(dg, cd), d_pregate.sum(0), d_premag.sum(0),
            (d_premag * g).sum(0) * er, _r(gate * torch.relu(pre_mag), cd).T @ dr,
            torch.cat([direct, cent[None]]).sum(0))


# the plain version of each backward route (fused_sae.bwd_route): the pair
# computes coder_bwd_tc's function, at its own summation order
ROUTE_PLAIN = {"pair": gated_bwd_tc_plain, "tc": gated_bwd_tc_plain,
               "simt": fused_gated_backward_plain}


def backward_plain(x, *args, route=None):
    """The plain version of the route the card's backward takes for ``x``
    (``route``, or fused_sae.bwd_route's for its width and dtype):
    gated_bwd_tc_plain for "pair" and "tc" (bf16), fused_gated_backward_plain
    for "simt" (f32)."""
    c = x.shape[-1]
    return ROUTE_PLAIN[route or bwd_route(c, c, act="gated", dtype=x.dtype)](x, *args)


# ---------------------------------------------------------------------------
# CUDA kernels
# ---------------------------------------------------------------------------

_P = ctypes.c_void_p
_I = ctypes.c_int


@functools.cache
def _lib() -> ctypes.CDLL:
    lib = native.load("fused_gated_sae")
    # every launching entry point ends in (..., n_split, stream); the
    # backwards' last pointer is split_ws (csrc/coder.cuh, "Splits"), their
    # ``pair`` comes before n_split (bwd_route)
    lib.svt_gated_fwd.restype = _I
    lib.svt_gated_fwd.argtypes = [_I] + [_P] * 13 + [_I] * 4 + [_P]
    lib.svt_gated_bwd.restype = _I
    lib.svt_gated_bwd.argtypes = [_I] + [_P] * 19 + [_I] * 5 + [_P]
    lib.svt_gated_sweep_fwd.restype = _I
    lib.svt_gated_sweep_fwd.argtypes = [_I] + [_P] * 13 + [_I] * 5 + [_P]
    lib.svt_gated_sweep_bwd.restype = _I
    lib.svt_gated_sweep_bwd.argtypes = [_I] + [_P] * 19 + [_I] * 6 + [_P]
    lib.svt_gated_pair_clusters.restype = _I
    lib.svt_gated_pair_clusters.argtypes = [_P]
    return lib


def pair_clusters() -> int:
    """The clusters of coder_bwd_pair<Act::Gated> (two CTAs each) that the
    current card holds at once (cudaOccupancyMaxActiveClusters); raises where
    the query fails."""
    out = (ctypes.c_int * 1)()
    rc = _lib().svt_gated_pair_clusters(out)
    if rc != 0:
        raise RuntimeError(f"svt_gated_pair_clusters failed: cudaError_t {rc}")
    return out[0]


def _check_operands(x, w_gate, b_gate, b_mag, er, w_dec, b_dec, backward: bool = False):
    t, c = x.shape
    h = b_gate.shape[0]
    if x.dtype not in (_F32, _BF16):
        raise ValueError(f"fused gated kernel: compute dtype {x.dtype} not supported")
    if not fwd_takes(t, h, c, x.dtype):
        raise ValueError(
            f"fused gated {'backward' if backward else 'kernel'}: shape T={t}, C={c}, "
            f"H={h} not supported with {x.dtype} operands (T and H multiples of 128; "
            "bf16: C a multiple of 8)"
        )
    dev = x.device
    _expect("x", x, (t, c), x.dtype, dev)
    _expect("W_gate", w_gate, (c, h), x.dtype, dev)
    for name, v in (("b_gate", b_gate), ("b_mag", b_mag), ("exp(r_mag)", er)):
        _expect(name, v, (h,), _F32, dev)
    _expect("W_dec", w_dec, (h, c), x.dtype, dev)
    _expect("b_dec", b_dec, (c,), _F32, dev)
    return t, c, h


class _ForwardKernel(Kernel):
    """csrc svt_gated_fwd: center_kernel and the coder forward with the gated
    epilogue (bf16: one launch at C ≤ 256, two wider; f32: two launches of the
    SIMT body). The partials are reduced here."""

    name = "fused_gated_sae_fwd"

    def __call__(self, x, w_gate, b_gate, b_mag, er, w_dec, b_dec, n_split=None):
        t, c, h = _check_operands(x, w_gate, b_gate, b_mag, er, w_dec, b_dec)
        dev = x.device
        s = launch_split(x, t, h, c, backward=False, n_split=n_split)
        recon = split_empty(s, (t, c), dev)
        via = split_empty(s, (t, c), dev)
        # per-64-token partials of the counts and of Σ relu(π_gate) (the L1 sum)
        act_part = torch.empty((t // PART_T, h), dtype=_F32, device=dev)
        l1_part = torch.empty_like(act_part)
        row_active = split_empty(s, (t,), dev)
        x_cent = torch.empty_like(x)  # center_kernel's output
        self._launch(_lib().svt_gated_fwd, dev,
                     *_ptrs(x, w_gate, b_gate, b_mag, er, w_dec, b_dec, recon, via, act_part,
                            row_active, l1_part, x_cent), t, c, h, s)
        return (join_splits(recon, s), join_splits(via, s), act_part.sum(0),
                join_splits(row_active, s), l1_part.sum())


class _PairBody(Kernel):
    """The cluster-pair backward body's gated instantiation (csrc/coder.cuh
    coder_bwd_pair<Act::Gated>, fused_sae.bwd_route's "pair"): its count goes
    up wherever a gated backward launch runs it (the launching wrapper's own
    count goes up too)."""

    name = "coder_bwd_pair_gated"


pair_kernel = _PairBody()


def _route(x, c: int, route) -> tuple:
    """(route, its ``pair`` flag for the backward entry points): ``route`` where
    the caller names one (chip_smoke.py times "tc" on a pair launch), else
    fused_sae.bwd_route's for a gated backward of width c in x's dtype."""
    route = route or bwd_route(c, c, act="gated", dtype=x.dtype)
    if route not in ROUTE_PLAIN:
        raise ValueError(f"fused gated backward: no {route!r} route (its routes: "
                         f"{', '.join(ROUTE_PLAIN)})")
    return route, int(route == "pair")


class _BackwardKernel(Kernel):
    """csrc svt_gated_bwd: in bf16 center_kernel, scale_err_kernel (twice) and
    the body bwd_route names, coder_bwd_pair<Act::Gated> at 128 < C ≤ 256
    (counted on ``pair_kernel`` too), else coder_bwd_tc<true, Act::Gated> (both
    gated_bwd_tc_plain), in f32 center_kernel, copies of both errors and
    coder_bwd_kernel<float, true, Act::Gated> (fused_gated_backward_plain).
    ``route="tc"`` runs coder_bwd_tc on a pair launch. db_dec's partial rows
    are reduced here."""

    name = "fused_gated_sae_bwd"

    def __call__(self, x, w_gate, b_gate, b_mag, er, w_dec, b_dec, err_rec, err_via, coeffs,
                 n_split=None, route=None):
        t, c, h = _check_operands(x, w_gate, b_gate, b_mag, er, w_dec, b_dec, backward=True)
        dev = x.device
        _expect("err_rec", err_rec, (t, c), _F32, dev)
        _expect("err_via", err_via, (t, c), _F32, dev)
        _expect("coeffs", coeffs, (3,), _F32, dev)
        route, pair = _route(x, c, route)
        s = launch_split(x, t, h, c, backward=True, n_split=n_split, pair=bool(pair))
        dw_gate = torch.empty((c, h), dtype=_F32, device=dev)
        db_gate = torch.empty((h,), dtype=_F32, device=dev)
        db_mag = torch.empty((h,), dtype=_F32, device=dev)
        dr_mag = torch.empty((h,), dtype=_F32, device=dev)
        dw_dec = torch.empty((h, c), dtype=_F32, device=dev)
        # the direct rows, then one centring row per 64 latents
        rows = direct_rows(t, x.dtype) + h // BLOCK_H
        db_dec_part = torch.empty((rows, c), dtype=_F32, device=dev)
        # workspaces in the operand type: x_cent, and both errors (bf16:
        # round(c_rec·err_rec) then round(c_aux·err_via); f32: their copies)
        x_cent = torch.empty_like(x)
        err_s = torch.empty((2, t, c), dtype=x.dtype, device=dev)
        self._launch(_lib().svt_gated_bwd, dev,
                     *_ptrs(x, w_gate, b_gate, b_mag, er, w_dec, b_dec, err_rec, err_via,
                            coeffs, dw_gate, db_gate, db_mag, dr_mag, dw_dec, db_dec_part,
                            x_cent, err_s, split_workspace(s, 1, h, c, c, dev, route)),
                     t, c, h, pair, s)
        pair_kernel.launches += pair
        return dw_gate, db_gate, db_mag, dr_mag, dw_dec, db_dec_part.sum(0)


fwd_kernel = _ForwardKernel()
bwd_kernel = _BackwardKernel()
KERNELS = (fwd_kernel, bwd_kernel)


def fused_gated_forward(*args, kernel=fwd_kernel):
    """The forward kernel on CUDA tensors (through ``kernel``, whose count it
    adds to), its plain version on CPU tensors."""
    return run_on_device(kernel, fused_gated_forward_plain, *args)


def fused_gated_backward(*args, kernel=bwd_kernel):
    """The backward kernel on CUDA tensors (through ``kernel``), the plain
    version of its route for the operands' dtype (backward_plain) on CPU
    tensors."""
    return run_on_device(kernel, backward_plain, *args)


class FusedGatedSAEFunction(torch.autograd.Function):
    """(x, W_gate, b_gate, b_mag, r_mag, W_dec, b_dec) -> (rec_loss, l1_loss,
    aux_loss, recon, act_count, row_active), the counterpart of the JAX op's
    custom_vjp; with a sweep's leading [N] axis on the parameters (x shared)
    every output gains it, one launch of each sweep entry point."""

    @staticmethod
    def forward(ctx, x, w_gate, b_gate, b_mag, r_mag, w_dec, b_dec, compute_dtype):
        cd = compute_dtype
        xc, wg, wd = x.to(cd).contiguous(), w_gate.to(cd).contiguous(), w_dec.to(cd).contiguous()
        b_gate, b_mag, b_dec = b_gate.contiguous(), b_mag.contiguous(), b_dec.contiguous()
        er = torch.exp(r_mag).float().contiguous()
        forward = fused_gated_sweep_forward if w_gate.ndim == 3 else fused_gated_forward
        recon, via, act_count, row_active, l1_sum = forward(xc, wg, b_gate, b_mag, er, wd, b_dec)
        t, _ = x.shape
        h = b_gate.shape[-1]
        err_rec = recon - x  # f32, against x in its own dtype
        err_via = via - x
        rec_loss = err_rec.square().mean((-2, -1))
        l1_loss = l1_sum / (t * h)
        aux_loss = err_via.square().mean((-2, -1))
        ctx.save_for_backward(xc, wg, b_gate, b_mag, er, wd, b_dec, err_rec, err_via)
        ctx.mark_non_differentiable(recon, act_count, row_active)
        return rec_loss, l1_loss, aux_loss, recon, act_count, row_active

    @staticmethod
    def backward(ctx, g_rec, g_l1, g_aux, *_unused):
        xc, wg, b_gate, b_mag, er, wd, b_dec, err_rec, err_via = ctx.saved_tensors
        *lead, t, c = err_rec.shape
        h = b_gate.shape[-1]
        coeffs = loss_coeffs((g_rec, 2.0, t * c), (g_l1, 1.0, t * h), (g_aux, 2.0, t * c),
                             lead=tuple(lead), device=xc.device)
        backward = fused_gated_sweep_backward if lead else fused_gated_backward
        dw_gate, db_gate, db_mag, dr_mag, dw_dec, db_dec = backward(
            xc, wg, b_gate, b_mag, er, wd, b_dec, err_rec, err_via, coeffs)
        return None, dw_gate, db_gate, db_mag, dr_mag, dw_dec, db_dec, None


def fused_gated_sae_loss_terms(params: dict, x: torch.Tensor, lambda_sparse: float,
                               expansion_factor: int, *, compute_dtype=_BF16) -> dict:
    """Fused equivalent of gated_sae_apply + gated_sae_loss_terms +
    measure_inactive_units on 2-D token input (loss = rec + λ·l1 + aux).
    RMSE/NRMSE come from the [T, C] reconstruction in plain torch."""
    cd = compute_dtype_of(compute_dtype)
    rec_loss, l1_loss, aux_loss, recon, act_count, row_active = FusedGatedSAEFunction.apply(
        x, params["W_gate"], params["b_gate"], params["b_mag"], params["r_mag"],
        params["W_dec"], params["b_dec"], cd)
    t = x.shape[0]
    h = params["b_gate"].shape[0]
    rmse, nrmse = losses.rmse_nrmse(recon, x)
    return {
        "loss": rec_loss + lambda_sparse * l1_loss + aux_loss,
        "rec_loss": rec_loss,
        "l1_loss": l1_loss,
        "aux_loss": aux_loss,
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

def gated_sweep_fwd_plain(x, w_gate, b_gate, b_mag, er, w_dec, b_dec):
    """Plain version of svt_gated_sweep_fwd: fused_gated_forward_plain per combo
    on the shared x, stacked, the sums as one partial row (recon and via [N, T,
    C], act_part [N, 1, H], row_active [N, T], l1_part [N, 1, 1]), as the
    kernel's partials come."""
    recon, via, act, row_active, l1 = stack_plain(fused_gated_forward_plain, 1, x, w_gate,
                                                  b_gate, b_mag, er, w_dec, b_dec)
    return recon, via, act[:, None], row_active, l1[:, None, None]


def gated_sweep_bwd_plain(x, w_gate, b_gate, b_mag, er, w_dec, b_dec, err_rec, err_via,
                          coeffs):
    """Plain version of svt_gated_sweep_bwd's route for x's dtype
    (backward_plain) per combo on the shared x, stacked, db_dec as one partial
    row [N, 1, C]; the errors [N, T, C], ``coeffs`` [N, 3]."""
    *grads, db_dec = stack_plain(backward_plain, 1, x, w_gate, b_gate, b_mag, er, w_dec,
                                 b_dec, err_rec, err_via, coeffs)
    return (*grads, db_dec[:, None])


def _check_sweep_operands(name, x, w_gate, b_gate, b_mag, er, w_dec, b_dec):
    n, t, c, h = _check_sweep(name, x, w_gate, b_gate, w_dec, b_dec)
    for what, v in (("b_mag", b_mag), ("exp(r_mag)", er)):
        _expect(what, v, (n, h), _F32, x.device)
    return n, t, c, h


class _SweepForwardKernel(Kernel):
    """csrc svt_gated_sweep_fwd: center_kernel and the gated coder forward for
    all N combos (bf16: one launch at C ≤ 256, two wider; f32: two), each
    launch for every combo. Returns what gated_sweep_fwd_plain returns (one
    partial row per 64 tokens)."""

    name = "fused_gated_sae_sweep_fwd"

    def __call__(self, x, w_gate, b_gate, b_mag, er, w_dec, b_dec, n_split=None):
        n, t, c, h = _check_sweep_operands(self.name, x, w_gate, b_gate, b_mag, er, w_dec,
                                           b_dec)
        dev = x.device
        s = launch_split(x, t, h, c, backward=False, n_split=n_split)  # one combo's
        recon = split_empty(s, (n, t, c), dev)
        via = split_empty(s, (n, t, c), dev)
        act_part = torch.empty((n, t // PART_T, h), dtype=_F32, device=dev)
        l1_part = torch.empty_like(act_part)
        row_active = split_empty(s, (n, t), dev)
        x_cent = torch.empty((n, t, c), dtype=x.dtype, device=dev)
        self._launch(_lib().svt_gated_sweep_fwd, dev,
                     *_ptrs(x, w_gate, b_gate, b_mag, er, w_dec, b_dec, recon, via, act_part,
                            row_active, l1_part, x_cent), t, c, h, n, s)
        return (join_splits(recon, s), join_splits(via, s), act_part,
                join_splits(row_active, s), l1_part)


class _SweepBackwardKernel(Kernel):
    """csrc svt_gated_sweep_bwd: _BackwardKernel's route for all N combos
    (bwd_route's from one dictionary's width), one launch of each pass.
    Returns what gated_sweep_bwd_plain returns (db_dec's partial rows)."""

    name = "fused_gated_sae_sweep_bwd"

    def __call__(self, x, w_gate, b_gate, b_mag, er, w_dec, b_dec, err_rec, err_via, coeffs,
                 n_split=None, route=None):
        n, t, c, h = _check_sweep_operands(self.name, x, w_gate, b_gate, b_mag, er, w_dec,
                                           b_dec)
        dev = x.device
        _expect("err_rec", err_rec, (n, t, c), _F32, dev)
        _expect("err_via", err_via, (n, t, c), _F32, dev)
        _expect("coeffs", coeffs, (n, 3), _F32, dev)
        route, pair = _route(x, c, route)
        s = launch_split(x, t, h, c, backward=True, n_split=n_split,
                         pair=bool(pair))  # one combo's
        dw_gate = torch.empty((n, c, h), dtype=_F32, device=dev)
        db_gate, db_mag, dr_mag = (torch.empty((n, h), dtype=_F32, device=dev) for _ in range(3))
        dw_dec = torch.empty((n, h, c), dtype=_F32, device=dev)
        rows = direct_rows(t, x.dtype) + h // BLOCK_H
        db_dec_part = torch.empty((n, rows, c), dtype=_F32, device=dev)
        x_cent = torch.empty((n, t, c), dtype=x.dtype, device=dev)
        err_s = torch.empty((n, 2, t, c), dtype=x.dtype, device=dev)
        self._launch(_lib().svt_gated_sweep_bwd, dev,
                     *_ptrs(x, w_gate, b_gate, b_mag, er, w_dec, b_dec, err_rec, err_via,
                            coeffs, dw_gate, db_gate, db_mag, dr_mag, dw_dec, db_dec_part,
                            x_cent, err_s, split_workspace(s, n, h, c, c, dev, route)),
                     t, c, h, n, pair, s)
        pair_kernel.launches += pair
        return dw_gate, db_gate, db_mag, dr_mag, dw_dec, db_dec_part


sweep_fwd_kernel = _SweepForwardKernel()
sweep_bwd_kernel = _SweepBackwardKernel()
SWEEP_KERNELS = (sweep_fwd_kernel, sweep_bwd_kernel)


def fused_gated_sweep_forward(*args):
    """The sweep forward kernel on CUDA tensors, its plain version on CPU
    tensors; the partials reduced per combo: (recon, via [N, T,
    C], act_count [N, H], row_active [N, T], l1_sum [N])."""
    recon, via, act_part, row_active, l1_part = run_on_device(
        sweep_fwd_kernel, gated_sweep_fwd_plain, *args)
    return recon, via, act_part.sum(1), row_active, l1_part.sum((1, 2))


def fused_gated_sweep_backward(*args):
    """The sweep backward kernel on CUDA tensors, the plain version of its
    route on CPU tensors; db_dec's rows reduced per combo."""
    *grads, db_dec_part = run_on_device(sweep_bwd_kernel, gated_sweep_bwd_plain, *args)
    return (*grads, db_dec_part.sum(1))


def fused_gated_sweep_loss_terms(params: dict, x: torch.Tensor, lambdas: torch.Tensor,
                                 expansion_factor: int, *, compute_dtype=_BF16) -> dict:
    """fused_gated_sae_loss_terms for N stacked dictionaries on one shared batch
    (fused_sae.fused_sae_sweep_loss_terms' contract): loss = rec + λ_n·l1 + aux."""
    cd = compute_dtype_of(compute_dtype)
    rec_loss, l1_loss, aux_loss, recon, act_count, row_active = FusedGatedSAEFunction.apply(
        x, params["W_gate"], params["b_gate"], params["b_mag"], params["r_mag"],
        params["W_dec"], params["b_dec"], cd)
    return sweep_terms(rec_loss, l1_loss, act_count, row_active, x.shape[0],
                       params["b_gate"].shape[1], expansion_factor,
                       rec_loss + lambdas * l1_loss + aux_loss)
