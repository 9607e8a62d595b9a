"""Fused ReLU-SAE training op: encode + ReLU + decode + loss terms + dead-latent
statistics in one forward kernel, a recomputing backward kernel, and a dx kernel
for the gradient with respect to the input.

Port of sparse_vision_tpu/ops/fused_sae.py. Why fuse: at the training shape
(C = 256 channels, 16,384 latents, 32,768 tokens a step) the latent matrix
``post`` is [T, H] = 2 GB in f32; the stock path writes it to device memory and
reads it back in the backward. The kernels (csrc/fused_sae.cu) never write it:
the forward keeps each token tile's reconstruction on chip while it sweeps the
latents, and the backward recomputes pre/post per token tile from x and the
saved [T, C] reconstruction error.

Dispatch rule: a CPU tensor runs the plain PyTorch version of each kernel (the
same formulas, the same cast points); a CUDA tensor launches the kernel or
raises. There is no fallback from one to the other.

Cast points (identical to the Pallas kernels): x, W_enc, W_dec and the saved
error are cast to the compute dtype before the kernels; ``x - b_dec`` is a
difference in that dtype; ``b_enc`` and the ``+ b_dec`` on recon are f32; every
product accumulates in f32. One documented difference in bf16: the centring term
of ``db_dec`` rounds the whole-batch ``db_enc`` to bf16 once, where the TPU kernel
rounds each 2048-token tile's partial sum, so bf16 ``db_dec`` agrees with the
JAX op within a tolerance and exactly in f32.

Differentiability contract: gradients flow through ``rec_loss`` and ``l1_loss``
only (loss = rec + λ·l1). ``recon`` and the statistics are marked
non-differentiable. ``x`` is data unless ``compute_dx=True``: then its gradient
comes from the dx kernel, dx = round(dpre)·W_encᵀ − c_rec·err; otherwise it is
None (the JAX op's zero cotangent).
"""

from __future__ import annotations

import ctypes
import functools

import torch

from sparse_vision_tpu_torch.ops import losses, native

# tile sizes of csrc/fused_sae.cu (kFwdTT, kBwdTT, kDxTT, kTH) and its supported widths
FWD_TILE_T = 64
BWD_TILE_T = 32
DX_TILE_T = 32
TILE_H = 64
SUPPORTED_C = (64, 128, 256)

_F32 = torch.float32
_BF16 = torch.bfloat16


def can_fuse(t: int, h: int, c: int = 256) -> bool:
    """True when the CUDA kernels take this (tokens, latents, channels) shape.
    The CPU plain versions take any shape."""
    return (
        c in SUPPORTED_C and t > 0 and h > 0
        and t % FWD_TILE_T == 0 and t % BWD_TILE_T == 0 and t % DX_TILE_T == 0
        and h % TILE_H == 0
    )


def compute_dtype_of(name) -> torch.dtype:
    """'bfloat16' / 'float32' (RunConfig.compute_dtype) or a torch dtype."""
    dt = {"bfloat16": _BF16, "float32": _F32}.get(name, name)
    if dt not in (_BF16, _F32):
        raise ValueError(f"compute dtype must be bfloat16 or float32, got {name!r}")
    return dt


# ---------------------------------------------------------------------------
# plain versions (CPU path; the reference the kernels are held against)
# ---------------------------------------------------------------------------

def _r(a: torch.Tensor, cd: torch.dtype) -> torch.Tensor:
    """Round to the compute dtype, compute on in f32 (exact products)."""
    return a.to(cd).float()


def fused_sae_forward_plain(x, w_enc, b_enc, w_dec, b_dec):
    """Plain forward of csrc sae_fwd_kernel. ``x``, ``w_enc``, ``w_dec`` are in the
    compute dtype. Returns (recon [T, C] f32, act_count [H], row_active [T],
    l1_sum scalar)."""
    cd = x.dtype
    xc = (x - b_dec.to(cd)).float()
    pre = xc @ w_enc.float() + b_enc
    post = torch.relu(pre)
    recon = _r(post, cd) @ w_dec.float() + b_dec
    active = post > 0
    return recon, active.sum(0).float(), active.sum(1).float(), post.sum()


def fused_sae_backward_plain(x, w_enc, b_enc, w_dec, b_dec, err, coeffs):
    """Plain backward of csrc sae_bwd_kernel. ``coeffs`` = (c_rec, c_l1) with
    c_rec = 2·g_rec/(T·C), c_l1 = g_l1/(T·H). Returns f32
    (dW_enc [C, H], db_enc [H], dW_dec [H, C], db_dec [C])."""
    cd = x.dtype
    c_rec, c_l1 = coeffs[0], coeffs[1]
    xc = (x - b_dec.to(cd)).float()
    we = w_enc.float()
    pre = xc @ we + b_enc
    post = torch.relu(pre)
    drecon = c_rec * err.float()
    dpost = _r(drecon, cd) @ w_dec.float().T + c_l1
    dpre = torch.where(pre > 0, dpost, torch.zeros((), device=pre.device))
    dw_enc = xc.T @ _r(dpre, cd)
    db_enc = dpre.sum(0)
    dw_dec = _r(post, cd).T @ _r(drecon, cd)
    db_dec = drecon.sum(0) - _r(db_enc, cd) @ we.T
    return dw_enc, db_enc, dw_dec, db_dec


def fused_sae_dx_plain(x, w_enc, b_enc, w_dec, b_dec, err, coeffs):
    """Plain version of csrc sae_dx_kernel: the gradient of c_rec/2·Σ err² +
    c_l1·Σ post with respect to x, round(dpre) @ W_encᵀ − c_rec·err, [T, C] f32.
    Arguments as for fused_sae_backward_plain."""
    cd = x.dtype
    c_rec, c_l1 = coeffs[0], coeffs[1]
    xc = (x - b_dec.to(cd)).float()
    we = w_enc.float()
    pre = xc @ we + b_enc
    drecon = c_rec * err.float()
    dpost = _r(drecon, cd) @ w_dec.float().T + c_l1
    dpre = torch.where(pre > 0, dpost, torch.zeros((), device=pre.device))
    return _r(dpre, cd) @ we.T - drecon


# ---------------------------------------------------------------------------
# CUDA kernels
# ---------------------------------------------------------------------------

_P = ctypes.c_void_p
_I = ctypes.c_int


@functools.cache
def _lib() -> ctypes.CDLL:
    lib = native.load("fused_sae")
    lib.svt_sae_fwd.restype = _I
    lib.svt_sae_fwd.argtypes = [_I, _P, _P, _P, _P, _P, _P, _P, _P, _P, _I, _I, _I, _P]
    lib.svt_sae_bwd.restype = _I
    lib.svt_sae_bwd.argtypes = [_I, _P, _P, _P, _P, _P, _P, _P, _P, _P, _P, _P,
                                _I, _I, _I, _P]
    lib.svt_sae_dx.restype = _I
    lib.svt_sae_dx.argtypes = [_I] + [_P] * 8 + [_I, _I, _I, _P]
    return lib


def _expect(name: str, t: torch.Tensor, shape: tuple, dtype, device) -> None:
    if t.device != device or t.dtype != dtype or tuple(t.shape) != shape \
            or not t.is_contiguous():
        raise ValueError(
            f"fused SAE kernel: {name} must be a contiguous {dtype} tensor of shape "
            f"{shape} on {device}; got {t.dtype} {tuple(t.shape)} on {t.device}"
            f"{'' if t.is_contiguous() else ' (not contiguous)'}"
        )


def _check_operands(x, w_enc, b_enc, w_dec, b_dec):
    t, c = x.shape
    h = b_enc.shape[0]
    if x.dtype not in (_F32, _BF16):
        raise ValueError(f"fused SAE kernel: compute dtype {x.dtype} not supported")
    if not can_fuse(t, h, c):
        raise ValueError(
            f"fused SAE kernel: shape T={t}, C={c}, H={h} not supported (C in "
            f"{SUPPORTED_C}, T a multiple of {FWD_TILE_T}, H of {TILE_H})"
        )
    dev = x.device
    _expect("x", x, (t, c), x.dtype, dev)
    _expect("W_enc", w_enc, (c, h), x.dtype, dev)
    _expect("b_enc", b_enc, (h,), _F32, dev)
    _expect("W_dec", w_dec, (h, c), x.dtype, dev)
    _expect("b_dec", b_dec, (c,), _F32, dev)
    return t, c, h


def _stream(dev: torch.device) -> _P:
    return _P(torch.cuda.current_stream(dev).cuda_stream)


class Kernel:
    """Wrapper of one CUDA kernel; ``launches`` counts its launches."""

    name = ""

    def __init__(self):
        self.launches = 0

    def _launch(self, fn, dev: torch.device, *args) -> None:
        """Call the C entry point ``fn`` with ``args`` and ``dev``'s current
        stream; raise on a non-zero cudaError_t, else count the launch."""
        with torch.cuda.device(dev):
            rc = fn(*args, _stream(dev))
        if rc != 0:
            raise RuntimeError(f"{fn.__name__} launch failed: cudaError_t {rc}")
        self.launches += 1


def _ptrs(x, *tensors) -> tuple:
    """(bf16 flag, data pointers) of the operands, as the C entry points take them."""
    return (int(x.dtype == _BF16), x.data_ptr(), *(t.data_ptr() for t in tensors))


class _ForwardKernel(Kernel):
    """csrc sae_fwd_kernel."""

    name = "fused_sae_fwd"

    def __call__(self, x, w_enc, b_enc, w_dec, b_dec):
        t, c, h = _check_operands(x, w_enc, b_enc, w_dec, b_dec)
        dev = x.device
        recon = torch.empty((t, c), dtype=_F32, device=dev)
        act_part = torch.empty((t // FWD_TILE_T, h), dtype=_F32, device=dev)
        row_active = torch.empty((t,), dtype=_F32, device=dev)
        l1_part = torch.empty((t // FWD_TILE_T,), dtype=_F32, device=dev)
        self._launch(_lib().svt_sae_fwd, dev,
                     *_ptrs(x, w_enc, b_enc, w_dec, b_dec, recon, act_part, row_active,
                            l1_part), t, c, h)
        # per-token-tile partials reduced here, as the JAX op sums act_part
        return recon, act_part.sum(0), row_active, l1_part.sum()


class _BackwardKernel(Kernel):
    """csrc sae_bwd_kernel."""

    name = "fused_sae_bwd"

    def __call__(self, x, w_enc, b_enc, w_dec, b_dec, err, coeffs):
        t, c, h = _check_operands(x, w_enc, b_enc, w_dec, b_dec)
        dev = x.device
        _expect("err", err, (t, c), x.dtype, dev)
        _expect("coeffs", coeffs, (2,), _F32, dev)
        dw_enc = torch.empty((c, h), dtype=_F32, device=dev)
        db_enc = torch.empty((h,), dtype=_F32, device=dev)
        dw_dec = torch.empty((h, c), dtype=_F32, device=dev)
        db_dec_part = torch.empty((h // TILE_H, c), dtype=_F32, device=dev)
        self._launch(_lib().svt_sae_bwd, dev,
                     *_ptrs(x, w_enc, b_enc, w_dec, b_dec, err, coeffs, dw_enc, db_enc,
                            dw_dec, db_dec_part), t, c, h)
        return dw_enc, db_enc, dw_dec, db_dec_part.sum(0)


class _DxKernel(Kernel):
    """csrc sae_dx_kernel (one level)."""

    name = "fused_sae_dx"

    def __call__(self, x, w_enc, b_enc, w_dec, b_dec, err, coeffs):
        t, c, h = _check_operands(x, w_enc, b_enc, w_dec, b_dec)
        dev = x.device
        _expect("err", err, (t, c), x.dtype, dev)
        _expect("coeffs", coeffs, (2,), _F32, dev)
        dx = torch.empty((t, c), dtype=_F32, device=dev)
        self._launch(_lib().svt_sae_dx, dev,
                     *_ptrs(x, w_enc, b_enc, w_dec, b_dec, err, coeffs, dx), t, c, h)
        return dx


fwd_kernel = _ForwardKernel()
bwd_kernel = _BackwardKernel()
dx_kernel = _DxKernel()
KERNELS = (fwd_kernel, bwd_kernel, dx_kernel)


def run_on_device(kernel, plain, x, *args):
    """``kernel(x, *args)`` when ``x`` is a CUDA tensor, ``plain(x, *args)`` when
    it is a CPU tensor; any other device raises. There is no fallback from one to
    the other: a kernel that fails raises."""
    if x.device.type == "cuda":
        return kernel(x, *args)
    if x.device.type == "cpu":
        return plain(x, *args)
    raise ValueError(f"fused SAE op: no kernel for device {x.device}")


def fused_sae_forward(*args):
    """The forward kernel on CUDA tensors, its plain version on CPU tensors."""
    return run_on_device(fwd_kernel, fused_sae_forward_plain, *args)


def fused_sae_backward(*args):
    """The backward kernel on CUDA tensors, its plain version on CPU tensors."""
    return run_on_device(bwd_kernel, fused_sae_backward_plain, *args)


def fused_sae_dx(*args):
    """The dx kernel on CUDA tensors, its plain version on CPU tensors."""
    return run_on_device(dx_kernel, fused_sae_dx_plain, *args)


class FusedSAEFunction(torch.autograd.Function):
    """(x, W_enc, b_enc, W_dec, b_dec) -> (rec_loss, l1_loss, recon, act_count,
    row_active), the counterpart of the JAX op's custom_vjp."""

    @staticmethod
    def forward(ctx, x, w_enc, b_enc, w_dec, b_dec, compute_dtype, compute_dx):
        cd = compute_dtype
        xc, we, wd = x.to(cd).contiguous(), w_enc.to(cd).contiguous(), w_dec.to(cd).contiguous()
        b_enc, b_dec = b_enc.contiguous(), b_dec.contiguous()
        recon, act_count, row_active, l1_sum = fused_sae_forward(xc, we, b_enc, wd, b_dec)
        t, c = x.shape
        h = b_enc.shape[0]
        err = recon - x  # against x in its own dtype, before the compute cast
        rec_loss = err.square().mean()
        l1_loss = l1_sum / (t * h)
        ctx.save_for_backward(xc, we, b_enc, wd, b_dec, err.to(cd))
        ctx.compute_dx = compute_dx
        ctx.mark_non_differentiable(recon, act_count, row_active)
        return rec_loss, l1_loss, recon, act_count, row_active

    @staticmethod
    def backward(ctx, g_rec, g_l1, *_unused):
        xc, we, b_enc, wd, b_dec, err = ctx.saved_tensors
        t, c = xc.shape
        h = b_enc.shape[0]
        zero = torch.zeros((), dtype=_F32, device=xc.device)
        g_rec = zero if g_rec is None else g_rec.float()
        g_l1 = zero if g_l1 is None else g_l1.float()
        # a device tensor, not host floats: the backward never syncs
        coeffs = torch.stack([g_rec * 2.0 / (t * c), g_l1 / (t * h)])
        ops = (xc, we, b_enc, wd, b_dec, err, coeffs)
        dw_enc, db_enc, dw_dec, db_dec = fused_sae_backward(*ops)
        dx = None
        if ctx.compute_dx and ctx.needs_input_grad[0]:
            dx = fused_sae_dx(*ops)
        return dx, dw_enc, db_enc, dw_dec, db_dec, None, None


def fused_sae_loss_terms(params: dict, x: torch.Tensor, lambda_sparse: float,
                         expansion_factor: int, *, compute_dtype=_BF16,
                         compute_dx: bool = False) -> dict:
    """Fused equivalent of sae_inference_and_loss + measure_inactive_units on 2-D
    token input: loss terms (loss = rec + λ·l1), recon, and dead/sparsity stats
    from the kernel. RMSE/NRMSE come from the [T, C] reconstruction in plain
    torch. ``compute_dx=True`` gives ``x`` its gradient (the dx kernel);
    otherwise training treats the activations as data."""
    cd = compute_dtype_of(compute_dtype)
    rec_loss, l1_loss, recon, act_count, row_active = FusedSAEFunction.apply(
        x, params["W_enc"], params["b_enc"], params["W_dec"], params["b_dec"], cd,
        compute_dx)
    t = x.shape[0]
    h = params["b_enc"].shape[0]
    rmse, nrmse = losses.rmse_nrmse(recon, x)
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
