"""Fused transcoder training op: encode + ReLU + decode into another layer's space
+ loss terms + dead-latent statistics in one forward kernel, and a recomputing
backward kernel.

Port of sparse_vision_tpu/ops/fused_transcoder.py. A transcoder maps x [T, C_in]
to a prediction of y [T, C_out] (models/sae.transcoder_apply): no input centring
(b_dec lives in the output space), a rectangular decoder W_dec [H, C_out], and
err = recon − y, so b_dec's gradient is Σ_T drecon with no centring term. At the
training shape (C_in 256 → C_out 480, 16,384 latents, 32,768 tokens a step) the
latent matrix is 2 GB in f32 per pass; the kernels (the coder bodies of
csrc/coder.cuh, entry points in csrc/fused_transcoder.cu) never write it: the
backward recomputes pre/post from x and the saved error.

The kernels are shared with the crosscoder (ops/fused_crosscoder.py), and the
bodies with the ReLU and Matryoshka SAE ops (ops/fused_sae.py): the
forward emits per-latent sums of post (zsum) and the backward takes a
per-latent L1 cotangent. This op's scalar Σpost is Σ_j zsum_j, and its c_l1 is
broadcast to all latents. Summation order therefore differs from the TPU
kernel's (which adds the whole tile's post into one scalar): per latent over a
block's 64 tokens, then over blocks, then over latents; the same value to f32
rounding.

Dispatch rule (ops/fused_sae.run_on_device): a CPU tensor runs the plain PyTorch
version of each kernel (the same formulas, the same cast points); a CUDA tensor
launches the kernel or raises. On the card the backward's body is
fused_sae.bwd_route's pick from the widths: at the transcoder's (C_in <= 256 <
C_out <= 512) the held route, csrc/coder.cuh coder_bwd_held, two launches that
each hold one gradient tile in registers for the whole token sweep (pass E:
dW_enc, db_enc; pass D: dW_dec, db_dec, with pre recomputed), counted on the
wrapper once and on HELD_PASSES once each; elsewhere (the crosscoder, wider
transcoders) coder_bwd_tc. Both compute coder_backward_plain's function, the
held passes' parts being fused_sae.coder_bwd_enc_plain and
coder_bwd_dec_plain.

Cast points (the Pallas kernels'): x, W_enc, W_dec and the saved error are cast
to the compute dtype before the kernels; b_enc and the + b_dec on recon are
f32; every product accumulates in f32; the saved error is recon − y in f32,
cast to the compute dtype; c_rec = 2·g_rec/(T·C_out), c_l1 = g_l1/(T·H).

Latent padding (ops/fused_sae.py's rule): at an H that is no multiple of 128
(the mixed4d -> mixed4e transcoder: 2,112 latents) FusedTranscoderFunction
pads the latent axis with zeros to padded_h(H) after the compute cast and
slices act_count and the gradients back; c_l1 and the L1 mean use the true H.

Differentiability contract: gradients flow through ``rec_loss`` and ``l1_loss``
into the four parameters only; x and y are data (their gradients are None).

Tensor parallel (FusedTranscoderTPFunction, fused_transcoder_tp_loss_terms):
the same kernels through wrappers of their own (``TP_KERNELS``, counted apart
from the single-device pair) on a rank's latent shard of a (data, model) mesh,
the JAX package's make_fused_transcoder_tp_op.
"""

from __future__ import annotations

import ctypes
import functools

import torch

from sparse_vision_tpu_torch.ops import losses, native
from sparse_vision_tpu_torch.ops.fused_sae import (
    _F32,
    _BF16,
    BF16_WIDTH,
    PART_T,
    TILE_H,
    TILE_T,
    Kernel,
    _expect,
    _ptrs,
    bodies_take,
    bwd_route,
    coder_backward_plain,
    coder_forward_plain,
    compute_dtype_of,
    direct_rows,
    join_splits,
    launch_split,
    padded_h,
    padded_operands,
    run_on_device,
    split_empty,
    split_workspace,
)
from sparse_vision_tpu_torch.ops.fused_sae_tp import _zero_if_none


def can_fuse(t: int, h: int, c_in: int = 256, c_out: int = 256, dtype=_BF16) -> bool:
    """True when the op takes this shape in ``dtype`` on the card: any H > 0,
    since FusedTranscoderFunction pads the latent axis to padded_h(H); T and the
    widths by the coder bodies' rule (bodies_take)."""
    return h > 0 and bodies_take(t, padded_h(h), c_in, c_out, dtype)


# ---------------------------------------------------------------------------
# plain versions (CPU path; the reference the kernels are held against)
# ---------------------------------------------------------------------------

def fused_transcoder_forward_plain(x, w_enc, b_enc, w_dec, b_dec):
    """The transcoder's forward: (recon, act_count, row_active, l1_sum = Σ post)."""
    recon, act_count, row_active, zsum = coder_forward_plain(x, w_enc, b_enc, w_dec, b_dec)
    return recon, act_count, row_active, zsum.sum()


def fused_transcoder_backward_plain(x, w_enc, b_enc, w_dec, err, coeffs):
    """The transcoder's backward; ``coeffs`` = (c_rec, c_l1)."""
    return coder_backward_plain(x, w_enc, b_enc, w_dec, err, coeffs[0], coeffs[1])


# ---------------------------------------------------------------------------
# CUDA kernels (entry points of csrc/fused_transcoder.cu)
# ---------------------------------------------------------------------------

_P = ctypes.c_void_p
_I = ctypes.c_int


@functools.cache
def _lib() -> ctypes.CDLL:
    lib = native.load("fused_transcoder")
    # both end in (..., n_split, stream); the backward's last pointer is split_ws
    # (csrc/coder.cuh, "Splits"), its ``held`` comes before n_split (bwd_route)
    lib.svt_coder_fwd.restype = _I
    lib.svt_coder_fwd.argtypes = [_I] + [_P] * 9 + [_I] * 5 + [_P]
    lib.svt_coder_bwd.restype = _I
    lib.svt_coder_bwd.argtypes = [_I] + [_P] * 12 + [_I] * 6 + [_P]
    return lib


def _check_operands(x, w_enc, b_enc, w_dec, b_dec=None):
    """Device, dtype, shape and contiguity of the shared kernels' operands;
    returns (t, c_in, c_out, h)."""
    t, c_in = x.shape
    h, c_out = w_dec.shape
    if x.dtype not in (_F32, _BF16):
        raise ValueError(f"fused transcoder kernel: compute dtype {x.dtype} not supported")
    if not bodies_take(t, h, c_in, c_out, x.dtype):
        raise ValueError(
            f"fused transcoder kernel: shape T={t}, H={h}, C_in={c_in}, C_out={c_out} not "
            f"supported with {x.dtype} operands (T a multiple of {TILE_T}, H of {TILE_H}; in "
            f"bf16 each width a multiple of {BF16_WIDTH})")
    dev = x.device
    _expect("x", x, (t, c_in), x.dtype, dev)
    _expect("W_enc", w_enc, (c_in, h), x.dtype, dev)
    _expect("b_enc", b_enc, (h,), _F32, dev)
    _expect("W_dec", w_dec, (h, c_out), x.dtype, dev)
    if b_dec is not None:
        _expect("b_dec", b_dec, (c_out,), _F32, dev)
    return t, c_in, c_out, h


class HeldPass(Kernel):
    """One pass of the held backward route (csrc/coder.cuh coder_bwd_held,
    fused_sae.bwd_route): its count goes up wherever a backward launch runs it
    (the launching wrapper's own count goes up once for both passes)."""

    def __init__(self, name: str):
        super().__init__()
        self.name = name


held_enc_kernel = HeldPass("coder_bwd_held_enc")  # pass E: dW_enc, db_enc
held_dec_kernel = HeldPass("coder_bwd_held_dec")  # pass D: dW_dec, db_dec's direct rows
HELD_PASSES = (held_enc_kernel, held_dec_kernel)
# svt_coder_bwd's ``held`` for each route name a backward wrapper takes
# (coder.cuh bwd_held's ``passes``: bit 0 pass E, bit 1 pass D): "held" both,
# "held E" / "held D" one alone (the measurement scripts'); "tc" and "simt" 0
HELD_FLAGS = {"held": 3, "held E": 1, "held D": 2}


def coder_forward_launch(kernel: Kernel, x, w_enc, b_enc, w_dec, b_dec, n_split=None):
    """Launch the coder forward (csrc/coder.cuh), counted on ``kernel``, split as
    fused_sae.launch_split says (or in ``n_split`` parts); returns what
    coder_forward_plain returns, the partials reduced here."""
    t, c_in, c_out, h = _check_operands(x, w_enc, b_enc, w_dec, b_dec)
    dev = x.device
    s = launch_split(x, t, h, c_out, backward=False, n_split=n_split)
    recon = split_empty(s, (t, c_out), dev)
    act_part = torch.empty((t // PART_T, h), dtype=_F32, device=dev)
    row_active = split_empty(s, (t,), dev)
    zsum_part = torch.empty((t // PART_T, h), dtype=_F32, device=dev)
    kernel._launch(_lib().svt_coder_fwd, dev,
                   *_ptrs(x, w_enc, b_enc, w_dec, b_dec, recon, act_part, row_active,
                          zsum_part), t, c_in, c_out, h, s)
    return join_splits(recon, s), act_part.sum(0), join_splits(row_active, s), zsum_part.sum(0)


def coder_backward_launch(kernel: Kernel, x, w_enc, b_enc, w_dec, err, coeffs, ct,
                          n_split=None, route=None):
    """Launch the coder backward (csrc/coder.cuh), counted on ``kernel``, split as
    coder_forward_launch, through the body fused_sae.bwd_route picks from the
    widths, or the one ``route`` names (HELD_FLAGS; chip_smoke.py and
    chip_bwd_probe.py time coder_bwd_tc and each held pass on a held launch):
    ``coeffs[0]`` is c_rec (a device tensor), ``ct`` the [H] L1 cotangent.
    Returns what coder_backward_plain returns; a held pass launched alone
    leaves the other pass's outputs unwritten."""
    t, c_in, c_out, h = _check_operands(x, w_enc, b_enc, w_dec)
    dev = x.device
    _expect("err", err, (t, c_out), x.dtype, dev)
    _expect("ct", ct, (h,), _F32, dev)
    if coeffs.dtype != _F32 or coeffs.device != dev or not coeffs.is_contiguous():
        raise ValueError("fused transcoder kernel: coeffs must be a contiguous f32 tensor "
                         f"on {dev}")
    route = route or bwd_route(c_in, c_out, dtype=x.dtype)
    if route not in ("tc", "simt", *HELD_FLAGS):  # svt_coder_bwd has no cluster pair
        raise ValueError(f"fused coder backward: no {route!r} route")
    s = launch_split(x, t, h, c_out, backward=True, n_split=n_split)
    dw_enc = torch.empty((c_in, h), dtype=_F32, device=dev)
    db_enc = torch.empty((h,), dtype=_F32, device=dev)
    dw_dec = torch.empty((h, c_out), dtype=_F32, device=dev)
    db_dec_part = torch.empty((direct_rows(t, x.dtype), c_out), dtype=_F32, device=dev)
    held = HELD_FLAGS.get(route, 0)
    kernel._launch(_lib().svt_coder_bwd, dev,
                   *_ptrs(x, w_enc, b_enc, w_dec, err, coeffs, ct, dw_enc, db_enc, dw_dec,
                          db_dec_part, split_workspace(s, 1, h, c_in, c_out, dev, route)),
                   t, c_in, c_out, h, held, s)
    for bit, p in enumerate(HELD_PASSES):  # each pass the launch ran
        if held >> bit & 1:
            p.launches += 1
    return dw_enc, db_enc, dw_dec, db_dec_part.sum(0)


class _ForwardKernel(Kernel):
    """The coder forward (csrc/coder.cuh) for the transcoder."""

    name = "fused_transcoder_fwd"

    def __call__(self, x, w_enc, b_enc, w_dec, b_dec, n_split=None):
        recon, act_count, row_active, zsum = coder_forward_launch(
            self, x, w_enc, b_enc, w_dec, b_dec, n_split)
        return recon, act_count, row_active, zsum.sum()


class _BackwardKernel(Kernel):
    """The coder backward (csrc/coder.cuh) for the transcoder: c_l1 broadcast to
    every latent."""

    name = "fused_transcoder_bwd"

    def __call__(self, x, w_enc, b_enc, w_dec, err, coeffs, n_split=None, route=None):
        _expect("coeffs", coeffs, (2,), _F32, x.device)
        ct = coeffs[1:].expand(w_dec.shape[0]).contiguous()
        return coder_backward_launch(self, x, w_enc, b_enc, w_dec, err, coeffs, ct, n_split,
                                     route)


class _TPForwardKernel(_ForwardKernel):
    """The coder forward on a latent shard (the site of the JAX package's
    fused_transcoder.py:318 in make_fused_transcoder_tp_op :296; pallas_call
    :227)."""

    name = "fused_transcoder_tp_fwd"


class _TPBackwardKernel(_BackwardKernel):
    """The coder backward on a latent shard (fused_transcoder.py:362; pallas_call
    :264)."""

    name = "fused_transcoder_tp_bwd"


fwd_kernel = _ForwardKernel()
bwd_kernel = _BackwardKernel()
KERNELS = (fwd_kernel, bwd_kernel)
tp_fwd_kernel = _TPForwardKernel()
tp_bwd_kernel = _TPBackwardKernel()
TP_KERNELS = (tp_fwd_kernel, tp_bwd_kernel)


def fused_transcoder_forward(*args, kernel=fwd_kernel):
    """The forward kernel on CUDA tensors (through ``kernel``, whose count it
    adds to), its plain version on CPU tensors."""
    return run_on_device(kernel, fused_transcoder_forward_plain, *args)


def fused_transcoder_backward(*args, kernel=bwd_kernel):
    """The backward kernel on CUDA tensors (through ``kernel``), its plain
    version on CPU tensors."""
    return run_on_device(kernel, fused_transcoder_backward_plain, *args)


class FusedTranscoderFunction(torch.autograd.Function):
    """(x, W_enc, b_enc, W_dec, b_dec, y) -> (rec_loss, l1_loss, recon, act_count,
    row_active), the counterpart of the JAX op's custom_vjp."""

    @staticmethod
    def forward(ctx, x, w_enc, b_enc, w_dec, b_dec, y, compute_dtype):
        cd = compute_dtype
        t = x.shape[0]
        h = b_enc.shape[0]  # the true H; the kernels run at padded_h(H)
        xc = x.to(cd).contiguous()
        we, b_enc, wd = padded_operands(w_enc, b_enc, w_dec, cd)
        recon, act_count, row_active, l1_sum = fused_transcoder_forward(
            xc, we, b_enc, wd, b_dec.contiguous())
        err = recon - y  # f32: recon is f32, whatever y's dtype
        ctx.save_for_backward(xc, we, b_enc, wd, err.to(cd))
        ctx.h = h
        act_count = act_count[:h]
        ctx.mark_non_differentiable(recon, act_count, row_active)
        return err.square().mean(), l1_sum / (t * h), recon, act_count, row_active

    @staticmethod
    def backward(ctx, g_rec, g_l1, *_unused):
        xc, we, b_enc, wd, err = ctx.saved_tensors
        t = xc.shape[0]
        h, c_out = ctx.h, wd.shape[1]
        zero = torch.zeros((), dtype=_F32, device=xc.device)
        g_rec = zero if g_rec is None else g_rec.float()
        g_l1 = zero if g_l1 is None else g_l1.float()
        # a device tensor, not host floats: the backward never syncs
        coeffs = torch.stack([g_rec * 2.0 / (t * c_out), g_l1 / (t * h)])
        dw_enc, db_enc, dw_dec, db_dec = fused_transcoder_backward(xc, we, b_enc, wd, err, coeffs)
        if b_enc.shape[0] != h:  # the padded latents' gradients are exactly zero
            dw_enc, db_enc, dw_dec = dw_enc[:, :h].contiguous(), db_enc[:h], dw_dec[:h]
        return None, dw_enc, db_enc, dw_dec, db_dec, None, None


def fused_transcoder_loss_terms(params: dict, x: torch.Tensor, y: torch.Tensor,
                                lambda_sparse: float, expansion_factor: int, *,
                                compute_dtype=_BF16) -> dict:
    """Fused equivalent of transcoder_inference_and_loss + measure_inactive_units
    on 2-D token input (x [T, C_in], y [T, C_out]): loss = rec + λ·l1, the
    prediction, dead/sparsity statistics from the kernel, and RMSE/NRMSE of the
    prediction against y in plain torch."""
    cd = compute_dtype_of(compute_dtype)
    rec_loss, l1_loss, recon, act_count, row_active = FusedTranscoderFunction.apply(
        x, params["W_enc"], params["b_enc"], params["W_dec"], params["b_dec"], y, cd)
    t = x.shape[0]
    h = params["b_enc"].shape[0]
    rmse, nrmse = losses.rmse_nrmse(recon, y)
    return {
        "loss": rec_loss + lambda_sparse * l1_loss,
        "rec_loss": rec_loss,
        "l1_loss": l1_loss,
        "nrmse_loss": nrmse,
        "rmse_loss": rmse,
        "aux_loss": torch.zeros((), dtype=_F32, device=x.device),
        "decoded": recon,
        "dead": act_count == 0,
        "activity_freq": act_count / t,
        "sparsity": torch.mean(row_active / (h / expansion_factor)),
    }


class FusedTranscoderTPFunction(torch.autograd.Function):
    """(x [T/d, C_in], W_enc [C_in, H/m], b_enc [H/m], W_dec [H/m, C_out], b_dec
    [C_out], y [T/d, C_out]) -> (rec_loss, l1_loss, recon, act_count,
    row_active, mean_row_active) on a rank of ``mesh``: the counterpart of the
    JAX package's make_fused_transcoder_tp_op (its fused_transcoder.py:296).

    The unchanged forward entry point gives the shard's partial prediction;
    the full one is ``psum_model(recon_part) − (m−1)·b_dec`` (every rank's
    kernel added b_dec once), and the MSE against y comes after that psum,
    pmean'd over 'data'. The activity counts are psummed over 'data',
    row_active over 'model', the L1 sum over both axes (divided by T_g·H_g).
    The backward takes the full prediction's error with c_rec = 2·g/(T_g·C_out)
    and c_l1 = g/(T_g·H_g); dW_enc, db_enc and dW_dec are latent-local, and
    db_dec = Σ_T drecon is the same on every model rank (the error is), so all
    four are psummed over 'data' only. A shard whose H/m is no multiple of 128
    is zero-padded, as FusedTranscoderFunction pads. ``recon`` is the full
    prediction of the local tokens; the statistics are non-differentiable and
    x, y are data."""

    @staticmethod
    def forward(ctx, x, w_enc, b_enc, w_dec, b_dec, y, compute_dtype, mesh):
        cd = compute_dtype
        t_l = x.shape[0]
        h_l = b_enc.shape[0]  # the true shard width; the kernels run at padded_h
        m, n_data = mesh.size("model"), mesh.size("data")
        t_g, h_g = t_l * n_data, h_l * m
        xc = x.to(cd).contiguous()
        we, be, wd = padded_operands(w_enc, b_enc, w_dec, cd)
        b_dec = b_dec.contiguous()
        recon_p, act_count, row_active, l1_sum = fused_transcoder_forward(
            xc, we, be, wd, b_dec, kernel=tp_fwd_kernel)
        recon, row_active, l1_sum = mesh.psum_many([recon_p, row_active, l1_sum], "model")
        recon = recon - (m - 1) * b_dec
        err = recon - y  # f32: recon is f32, whatever y's dtype
        act_count, sq, l1_sum, mean_rows = mesh.psum_many(
            [act_count[:h_l], err.square().mean(), l1_sum, row_active.mean()], "data")
        ctx.save_for_backward(xc, we, be, wd, err.to(cd))
        ctx.dims = (t_g, h_g, h_l)
        ctx.mesh = mesh
        out = (sq / n_data, l1_sum / (t_g * h_g), recon, act_count, row_active,
               mean_rows / n_data)
        ctx.mark_non_differentiable(*out[2:])
        return out

    @staticmethod
    def backward(ctx, g_rec, g_l1, *_unused):
        xc, we, be, wd, err = ctx.saved_tensors
        t_g, h_g, h_l = ctx.dims
        coeffs = torch.stack([_zero_if_none(g_rec, xc) * 2.0 / (t_g * wd.shape[1]),
                              _zero_if_none(g_l1, xc) / (t_g * h_g)])
        dw_enc, db_enc, dw_dec, db_dec = fused_transcoder_backward(
            xc, we, be, wd, err, coeffs, kernel=tp_bwd_kernel)
        if be.shape[0] != h_l:  # the padded latents' gradients are exactly zero
            dw_enc, db_enc, dw_dec = dw_enc[:, :h_l].contiguous(), db_enc[:h_l], dw_dec[:h_l]
        # db_dec too: every model rank holds the whole Σ_T drecon already
        dw_enc, db_enc, dw_dec, db_dec = ctx.mesh.psum_many(
            [dw_enc, db_enc, dw_dec, db_dec], "data")
        return None, dw_enc, db_enc, dw_dec, db_dec, None, None, None


def fused_transcoder_tp_loss_terms(params: dict, x: torch.Tensor, y: torch.Tensor,
                                   lambda_sparse: float, expansion_factor: int, mesh, *,
                                   compute_dtype=_BF16) -> dict:
    """The TP counterpart of fused_transcoder_loss_terms on the rank's shard
    (``params`` the latent shard, ``x`` and ``y`` the local token rows):
    GLOBAL rec_loss, l1_loss (loss = rec + λ·l1), ``sparsity``, and rmse /
    nrmse over the global batch (losses.rmse_nrmse_global, as the JAX
    package's twin); ``dead`` and ``activity_freq`` over the local latents and
    the global batch; ``decoded`` the full prediction of the local tokens."""
    cd = compute_dtype_of(compute_dtype)
    rec_loss, l1_loss, recon, act_count, _, mean_rows = FusedTranscoderTPFunction.apply(
        x, params["W_enc"], params["b_enc"], params["W_dec"], params["b_dec"], y, cd, mesh)
    t_g = x.shape[0] * mesh.size("data")
    h_g = params["b_enc"].shape[0] * mesh.size("model")
    rmse, nrmse = losses.rmse_nrmse_global(recon, y, mesh)
    return {
        "loss": rec_loss + lambda_sparse * l1_loss,
        "rec_loss": rec_loss,
        "l1_loss": l1_loss,
        "nrmse_loss": nrmse,
        "rmse_loss": rmse,
        "aux_loss": torch.zeros((), dtype=_F32, device=x.device),
        "decoded": recon,
        "dead": act_count == 0,
        "activity_freq": act_count / t_g,
        "sparsity": mean_rows / (h_g / expansion_factor),
    }
