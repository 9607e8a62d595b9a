"""Fused ReLU-SAE training op: encode + ReLU + decode + loss terms + dead-latent
statistics in one forward entry point, a recomputing backward, and a dx entry
point for the gradient with respect to the input.

Port of sparse_vision_tpu/ops/fused_sae.py. Why fuse: at the training shape
(C = 256 channels, 16,384 latents, 32,768 tokens a step) the latent matrix
``post`` is [T, H] = 2 GB in f32; the stock path writes it to device memory and
reads it back in the backward. The kernels never write it: the forward keeps
each token tile's reconstruction on chip while it sweeps the latents, and the
backward recomputes pre/post per token step from the centred input and the
saved [T, C] reconstruction error.

The forward, backward and dx run the coder body family (csrc/coder.cuh, shared
with the transcoder and crosscoder ops; wgmma/TMA bodies in bf16, SIMT in f32,
any width that bodies_take allows) through the entry points of
csrc/fused_sae.cu: the forward's first centres x (x_cent = x − round(b_dec),
saved for the backward and dx), the backward adds db_dec's centring term as one
partial row per 64 latents, and dx is the forward bodies' dx route (kDx). In
bf16 at C <= 256 the backward's body is the cluster pair, coder_bwd_pair<Act::
Relu> (bwd_route, act "sae": two CTAs a latent block, one holding dW_enc and one
dW_dec in registers for the whole sweep; counted on ``pair_kernel`` too), after
scale_err_kernel, which rounds c_rec·err from the saved bf16 error as
coder_bwd_tc does and writes db_dec's direct rows; wider, coder_bwd_tc. The
glue around each entry point (the partial reductions, c_l1 broadcast to every
latent) is the same on both devices; only the entry points differ.

Dispatch rule: a CPU tensor runs the plain PyTorch version of each entry point
(the same formulas, the same cast points; the backward's of its route,
backward_plain); a CUDA tensor launches the kernel or raises. There is no
fallback from one to the other.

Cast points (identical to the Pallas kernels): x, W_enc, W_dec and the saved
error are cast to the compute dtype before the kernels; ``x - b_dec`` is a
difference in that dtype; ``b_enc`` and the ``+ b_dec`` on recon are f32; every
product accumulates in f32. One documented difference in bf16: the centring term
of ``db_dec`` rounds the whole-batch ``db_enc`` to bf16 once, where the TPU kernel
rounds each 2048-token tile's partial sum, so bf16 ``db_dec`` agrees with the
JAX op within a tolerance and exactly in f32.

Latent padding: the kernels take H in multiples of TILE_H (128). At any other
H (the registry's mixed4d SAE: 528 × 4 = 2,112 latents) FusedSAEFunction pads
W_enc's columns, b_enc and W_dec's rows with zeros to padded_h(H) after the
compute cast, runs the entry points at that width on both devices, and slices
act_count and the gradients back to H; the normalisers (c_l1, the L1 mean) use
the true H. A padded latent's pre-activation is exactly 0, so it never fires
and every output and gradient it touches is exactly what the unpadded op gives
up to summation order. Nothing outside the op holds the padded width.

The sweep (train/sweep_vmap.py): N dictionaries of one shape that differ only
in their hyperparameters train on one shared batch. The JAX op runs under
jax.vmap there, and pallas_call's batching rule makes each kernel one launch
for all N combos, the combo as the outer grid dimension.
FusedSAEFunction given parameters with a leading combo axis is that launch:
(x [T, C] shared, W_enc [N, C, H], b_enc [N, H], W_dec [N, H, C], b_dec [N,
C]) -> per-combo losses [N] and statistics [N, ...], through the sweep entry
points svt_sae_sweep_fwd / _bwd (no dx: the sweep trains x as data), whose
bodies take the combo as the grid's second dimension (csrc/coder.cuh,
"Combos"): one forward and one backward launch whatever N is. Their plain
versions are the per-combo stacks of sae_fwd_plain / sae_bwd_plain, and a
combo's outputs are those of the one-dictionary op on its slices.

Differentiability contract: gradients flow through ``rec_loss`` and ``l1_loss``
only (loss = rec + λ·l1). ``recon`` and the statistics are marked
non-differentiable. ``x`` is data unless ``compute_dx=True``: then its gradient
comes from the dx entry point, dx = round(dpre)·W_encᵀ − c_rec·err, on the saved
x_cent and error; otherwise it is None (the JAX op's zero cotangent).
"""

from __future__ import annotations

import ctypes
import functools
from fractions import Fraction

import torch

from sparse_vision_tpu_torch.ops import losses, native

_F32 = torch.float32
_BF16 = torch.bfloat16

# Tiling of the coder body family (csrc/coder.cuh), which runs this op's forward
# and backward and the transcoder's and crosscoder's: the T and H multiples
# (kBwdTB, kFwdLG; H's is also the Matryoshka prefix quantum), tokens per
# activity/zsum partial row, the bf16 backward's tokens per direct db_dec row
# (kTcBwdTS), the f32 backward's direct db_dec rows, latents per backward block
# (one centring row of db_dec each), and the bf16 width multiple (TMA's 16-byte
# row strides). The dx route (kDx) runs the forward bodies: the same rule.
TILE_T = 128
TILE_H = 128
PART_T = 64
BF16_STEP_T = 512
F32_DIRECT_ROWS = 2
BLOCK_H = 64
BF16_WIDTH = 8
# The split of the bf16 bodies' sweeps (csrc/coder.cuh, "Splits"; grid_split):
# the in-place forward's tokens per block and latents per group (kTcFwdTT,
# kTcFwdLG), the widest C_out that the register-held forwards take (kHoldCout;
# they never split), at most MAX_SPLIT parts, the 512-token steps a backward
# part keeps at least, and the per-latent sums a backward part leaves in its
# workspace (kSplitSums).
FWD_TILE_T = 128
FWD_GROUP_H = 512
HOLD_COUT = 512
MAX_SPLIT = 4
SPLIT_MIN_STEPS = 2
SPLIT_SUMS = 4
# The held backward route (csrc/coder.cuh coder_bwd_held; bwd_route): the widest
# C_in and C_out whose gradient tiles it holds in registers (kHeldCin,
# kHeldCout), and the C_out at and below which coder_bwd_tc is as fast
# (kHeldMinCout).
HELD_CIN = 256
HELD_COUT = 512
HELD_MIN_COUT = 256
# The cluster-pair backward route (csrc/coder.cuh coder_bwd_pair; bwd_route):
# the widest C whose gradient tiles a pair holds in registers (kPairCmax), and
# its CTAs a latent block (two: a thread block cluster).
PAIR_C = 256
PAIR_CTAS = 2
# the widest C at which the gated epilogue keeps coder_bwd_tc: its pair lost or
# tied at C 64 and 128 at large H (bwd_route's docstring)
GATED_PAIR_MIN_C = 128


def bodies_take(t: int, h: int, c_in: int = 256, c_out: int = 256, dtype=_BF16) -> bool:
    """True when the coder bodies take T tokens, H latents and these widths with
    operands of ``dtype``: T and H multiples of 128; any positive width in f32,
    multiples of 8 in bf16."""
    dt = compute_dtype_of(dtype)
    return (t > 0 and h > 0 and c_in > 0 and c_out > 0 and t % TILE_T == 0
            and h % TILE_H == 0
            and (dt != _BF16 or (c_in % BF16_WIDTH == 0 and c_out % BF16_WIDTH == 0)))


def grid_split(t: int, h: int, c_out: int, *, backward: bool, n_sm: int,
               pair: bool = False) -> int:
    """The number s of parts into which a bf16 launch cuts each block's sweep
    (csrc/coder.cuh, "Splits"), from ONE dictionary's T, H and C_out and the
    card's SM count only: never a sweep's N, so every combo of a sweep launch
    runs as a one-dictionary launch does. The bodies are pinned at one block an
    SM. The backward's grid is b = H/64 latent blocks (``pair``, the cluster-pair
    route: b = 2·H/64 CTAs, two a latent block), each sweeping the
    512-token steps; the in-place forward's (C_out > 512: the register-held
    forwards never split) b = T/128 token blocks, each sweeping the 512-latent
    groups. A grid of at least 10/11 of the SMs (120 of 132) stays whole; a
    smaller one takes the least s in 1..MAX_SPLIT whose waves s·b/n_sm are at
    least 90% full, else the fullest (the least s of a tie), where each part
    keeps at least SPLIT_MIN_STEPS token steps (backward) or one latent group
    (forward). The pair's split cut its body's device time for one dictionary
    wherever it split in chip_bwd_probe.py's split grid; a sweep of 8, whose
    grid the combos already fill, runs split slower (PERF.md, "Findings")."""
    if backward:
        blocks = (PAIR_CTAS if pair else 1) * (h // BLOCK_H)
        most = -(-t // BF16_STEP_T) // SPLIT_MIN_STEPS
    elif c_out <= HOLD_COUT:
        return 1
    else:
        blocks, most = t // FWD_TILE_T, -(-h // FWD_GROUP_H)
    if 11 * blocks >= 10 * n_sm:
        return 1
    best, best_fill = 1, Fraction(0)
    for s in range(1, max(1, min(MAX_SPLIT, most)) + 1):
        fill = Fraction(s * blocks, n_sm * -(-s * blocks // n_sm))  # of the last wave's SMs
        if fill >= Fraction(9, 10):
            return s
        if fill > best_fill:
            best, best_fill = s, fill
    return best


def bwd_route(c_in: int, c_out: int, levels: int = 1, act: str = "relu", dtype=_BF16) -> str:
    """The body that runs a backward launch, from its widths, prefix levels,
    epilogue and operand dtype alone. ``act`` names the epilogue and so the
    caller's entry point: "relu" the coders' (svt_coder_bwd: the transcoder
    and the crosscoder, no centred input, no centring row), "sae" the ReLU and
    Matryoshka SAEs' (the same ReLU on x_cent with db_dec's centring row:
    svt_sae_bwd, svt_matryoshka_bwd and their sweeps), "jump" the JumpReLU
    SAE's, "gated" the gated SAE's.
    - "held": csrc/coder.cuh's coder_bwd_held, two launches (pass E holds dW_enc,
      pass D dW_dec, each in registers for the whole token sweep, written once),
      for a bf16 coder ("relu") backward of one level with C_in <= 256 and 256
      < C_out <= 512: the transcoder at its training widths, 256 -> 480, on one
      card and on a shard (PERF.md rows 12 and 24). On an H100 80GB HBM3 at
      700 W (chip_smoke.py's "[route]" lines; PERF.md's kernel table) it ran
      row 12 in 7.255 ms against coder_bwd_tc's 8.064 on the same launch, and
      row 24 in 1.867 against 2.053;
    - "pair": coder_bwd_pair, one launch in which two CTAs of a thread block
      cluster share a latent block (E holds dW_enc, D dW_dec, each in
      registers for the whole sweep; they trade post and dpre through
      distributed shared memory), with C_in = C_out <= PAIR_C (256, the widest
      tile a CTA holds), at any T and H:
      * a bf16 JumpReLU backward of one level (coder_bwd_pair<Act::Jump>). On
        an H100 80GB HBM3 at 700 W, each body at grid_split's split of its own
        grid, the pair's body ran faster on the device than coder_bwd_tc's at
        every width (8, 64, 128, 192, 256) and shape of chip_bwd_probe.py's
        route grid (T 4,096 and 32,768, expansions 2 to 64), and the launch
        faster wherever the device, not the wrapper's host work, set its time:
        rows 5, 20 and 32 and C 64 and 192 in chip_smoke.py's "[route]" lines
        (PERF.md, "Findings");
      * a bf16 "sae" backward, one level or any prefix levels
        (coder_bwd_pair<Act::Relu> after the scale_err_kernel pre-pass, its
        D CTA reading its block's level of S). On the same card, each body at
        grid_split's split of its own grid, the pair's body ran faster on the
        device than coder_bwd_tc's at all 36 shapes of chip_bwd_probe.py's
        route grid for the SAEs (C 8, 64, 128, 192, 256; T 4,096 and 32,768;
        expansions 2, 16, 64; three prefix levels at C 256), 1.27-3.56x, and
        the launch 1.30-2.99x faster at T 32,768; at T 4,096 and H to 3,072,
        where the bodies take 0.02-0.09 ms, the wrapper's host work sets the
        launch's time (PERF.md, "Findings");
      * a bf16 gated backward of one level with GATED_PAIR_MIN_C < C
        (coder_bwd_pair<Act::Gated>, after the two scale_err_kernel
        pre-passes). On the same card, each body at its own rule's split, the
        pair's body ran 1.28-2.51x faster than coder_bwd_tc's at every shape
        of chip_bwd_probe.py's route grid at C 192 and 256 (T 4,096 and
        32,768; expansions 2, 16, 64); at C 8, 64 and 128 it ran 1.41-1.86x
        faster at expansion 2 (and at C 8 and 64 at 16), but 0.91-1.00x at C
        64, expansion 64 and at C 128, expansions 16 and 64, and the rule
        reads no H. Rows 7, 18 and 30 on the pair: 1.35x, 1.33x and 1.22x
        coder_bwd_tc on the same launch (chip_smoke.py's "[route]" lines;
        PERF.md, "Findings");
    - "tc": coder_bwd_tc, dW updated in place once a 512-token step, for every
      other bf16 backward: the coders' at C_out <= 256 (their entry point has
      no pair route, and there the held passes were no faster on the same
      card: PERF.md, "Findings"), the gated epilogue to GATED_PAIR_MIN_C, the
      JumpReLU and gated ones with levels, and every dictionary wider than
      the pair's and held passes' registers (the crosscoder's ΣC 2,896; C_in
      264 and up, C_out 520 and up);
    - "simt": the f32 check path, coder_bwd_kernel.
    A launch that this rule sends to "held" or "pair" runs that body or raises:
    no other body takes its place."""
    if compute_dtype_of(dtype) != _BF16:
        return "simt"
    if (act == "relu" and levels == 1 and c_in <= HELD_CIN
            and HELD_MIN_COUT < c_out <= HELD_COUT):
        return "held"
    if c_in == c_out <= PAIR_C and (
            act == "sae" or (act == "jump" and levels == 1)
            or (act == "gated" and levels == 1 and c_in > GATED_PAIR_MIN_C)):
        return "pair"
    return "tc"


@functools.cache
def sm_count(index: int) -> int:
    """The streaming multiprocessors of CUDA device ``index``."""
    return torch.cuda.get_device_properties(index).multi_processor_count


def launch_split(x: torch.Tensor, t: int, h: int, c_out: int, *, backward: bool,
                 n_split: int | None = None, pair: bool = False) -> int:
    """The split of a launch on CUDA operand ``x`` (one dictionary's T, H,
    C_out; ``pair``: the cluster-pair backward's grid): ``n_split`` where the
    caller names one (chip_smoke.py times the unsplit launch beside the split
    one), else grid_split's in bf16; the f32 SIMT bodies never split."""
    if n_split is not None:
        return n_split
    if x.dtype != _BF16:
        return 1
    return grid_split(t, h, c_out, backward=backward, n_sm=sm_count(x.device.index),
                      pair=pair)


def split_empty(s: int, shape: tuple, device) -> torch.Tensor:
    """An f32 output of ``shape`` with a leading [s] axis of split partials
    when s > 1, as the bodies write it (the split outermost)."""
    return torch.empty(((s,) if s > 1 else ()) + tuple(shape), dtype=_F32, device=device)


def join_splits(t: torch.Tensor, s: int) -> torch.Tensor:
    """A split output summed over its s partials (one .sum(0): the same order
    for every element, whatever the other axes), or ``t`` when s is 1."""
    return t.sum(0) if s > 1 else t


def split_workspace(s: int, n: int, h: int, c_in: int, c_out: int, device,
                    route: str = "tc"):
    """The backward's split workspace (csrc/coder.cuh, bwd_tc, bwd_held and
    bwd_pair) for n combos of one shape: the partials of splits 1..s-1, dW_enc
    [s - 1, n, c_in, h] and dW_dec [s - 1, n, h, c_out], the per-latent sums
    [s, n, SPLIT_SUMS, h] (f32 all), then [n, h / 64] int32 tickets, zeroed, in
    one int32 buffer (a held ``route``: two ticket arrays, one a pass; "pair":
    two, D's then E's); None (a null pointer) when s is 1. The last split of
    each latent block adds the partials into the outputs, which keep their
    shapes."""
    if s == 1:
        return None
    floats = (s - 1) * n * h * (c_in + c_out) + s * n * SPLIT_SUMS * h
    passes = 2 if route.startswith("held") or route == "pair" else 1
    ws = torch.empty(floats + passes * n * (h // BLOCK_H), dtype=torch.int32, device=device)
    ws[floats:].zero_()
    return ws


def padded_h(h: int) -> int:
    """H rounded up to a multiple of TILE_H: the latent count the kernels run at."""
    return -(-h // TILE_H) * TILE_H


def can_fuse(t: int, h: int, c: int = 256, dtype=_BF16) -> bool:
    """True when the op takes this (tokens, latents, channels) shape in
    ``dtype`` on the card: any H > 0, since FusedSAEFunction pads the latent axis
    to padded_h(H); T and the widths by bodies_take. The CPU plain versions take
    any shape."""
    return h > 0 and bodies_take(t, padded_h(h), c, c, dtype)


def cast_padded(w: torch.Tensor, cd: torch.dtype, shape: tuple) -> torch.Tensor:
    """``w`` cast to ``cd``, contiguous, zero-padded at the end of each dim to
    ``shape`` (one copy at most)."""
    if tuple(w.shape) == tuple(shape):
        return w.to(cd).contiguous()
    out = w.new_zeros(shape, dtype=cd)
    out[tuple(slice(0, n) for n in w.shape)] = w
    return out


def padded_operands(w_enc, b_enc, w_dec, cd):
    """The compute casts of W_enc [C_in, H] and W_dec [H, C_out] and the f32
    b_enc [H] (each with a sweep's leading [N] axis, or none), zero-padded on
    the latent axis to padded_h(H). A padded
    latent has a zero W_enc column and b_enc, so its pre-activation is exactly 0
    and it never fires: it adds nothing to recon, Σpost, the activity counts or
    row_active, and its gradients are exactly zero (sliced away by the
    callers)."""
    hp = padded_h(b_enc.shape[-1])
    return (cast_padded(w_enc, cd, (*w_enc.shape[:-1], hp)),
            cast_padded(b_enc, _F32, (*b_enc.shape[:-1], hp)),
            cast_padded(w_dec, cd, (*w_dec.shape[:-2], hp, w_dec.shape[-1])))


def direct_rows(t: int, dtype) -> int:
    """Direct rows of db_dec (Σ_T drecon) that the coder backward leaves."""
    return -(-t // BF16_STEP_T) if dtype == _BF16 else F32_DIRECT_ROWS


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
    """The op's forward in plain PyTorch, the reference the kernels are held to.
    ``x``, ``w_enc``, ``w_dec`` are in the compute dtype. Returns (recon [T, C]
    f32, act_count [H], row_active [T], l1_sum scalar)."""
    cd = x.dtype
    xc = (x - b_dec.to(cd)).float()
    pre = xc @ w_enc.float() + b_enc
    post = torch.relu(pre)
    recon = _r(post, cd) @ w_dec.float() + b_dec
    active = post > 0
    return recon, active.sum(0).float(), active.sum(1).float(), post.sum()


def fused_sae_backward_plain(x, w_enc, b_enc, w_dec, b_dec, err, coeffs):
    """The op's backward in plain PyTorch, the reference the kernels are held to.
    ``coeffs`` = (c_rec, c_l1) with c_rec = 2·g_rec/(T·C), c_l1 = g_l1/(T·H).
    Returns f32 (dW_enc [C, H], db_enc [H], dW_dec [H, C], db_dec [C])."""
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


def fused_sae_dx_plain(x_cent, w_enc, b_enc, w_dec, err, coeffs):
    """Plain version of the dx entry point svt_sae_dx (dx_kernel): the gradient of
    c_rec/2·Σ err² + c_l1·Σ post with respect to x, round(dpre) @ W_encᵀ −
    c_rec·err, [T, C] f32, on the forward's x_cent. Arguments as for
    sae_bwd_plain."""
    cd = x_cent.dtype
    c_rec, c_l1 = coeffs[0], coeffs[1]
    we = w_enc.float()
    pre = x_cent.float() @ we + b_enc
    drecon = c_rec * err.float()
    dpost = _r(drecon, cd) @ w_dec.float().T + c_l1
    dpre = torch.where(pre > 0, dpost, torch.zeros((), device=pre.device))
    return _r(dpre, cd) @ we.T - drecon


# plain versions of the coder bodies (csrc/coder.cuh), shared with the
# transcoder and crosscoder ops

def coder_forward_plain(x, w_enc, b_enc, w_dec, b_dec):
    """Plain version of the coder forward body. ``x``, ``w_enc``, ``w_dec`` are in
    the compute dtype. Returns (recon [T, C_out] f32, act_count [H], row_active
    [T], zsum [H] = Σ_T post)."""
    cd = x.dtype
    pre = x.float() @ w_enc.float() + b_enc
    post = torch.relu(pre)
    recon = _r(post, cd) @ w_dec.float() + b_dec
    active = post > 0
    return recon, active.sum(0).float(), active.sum(1).float(), post.sum(0)


def coder_bwd_enc_plain(x, w_enc, b_enc, w_dec, err, c_rec, ct):
    """Plain version of the held route's pass E (csrc coder_bwd_held, kDec
    false), arguments as coder_backward_plain's: f32 (dW_enc [C_in, H] = xᵀ @
    round(dpre), db_enc [H] = Σ_T dpre)."""
    cd = x.dtype
    xf = x.float()
    pre = xf @ w_enc.float() + b_enc
    dpost = _r(c_rec * err.float(), cd) @ w_dec.float().T + ct
    dpre = torch.where(pre > 0, dpost, torch.zeros((), device=pre.device))
    return xf.T @ _r(dpre, cd), dpre.sum(0)


def coder_bwd_dec_plain(x, w_enc, b_enc, err, c_rec):
    """Plain version of the held route's pass D (csrc coder_bwd_held, kDec
    true), which recomputes pre: f32 (dW_dec [H, C_out] = round(post)ᵀ @
    round(c_rec·err), db_dec's direct term [C_out] = Σ_T c_rec·err)."""
    cd = x.dtype
    post = torch.relu(x.float() @ w_enc.float() + b_enc)
    drecon = c_rec * err.float()
    return _r(post, cd).T @ _r(drecon, cd), drecon.sum(0)


def coder_backward_plain(x, w_enc, b_enc, w_dec, err, c_rec, ct):
    """Plain version of the coder backward body (every route: the held route's
    two passes together give the same function). ``err`` [T, C_out] is in the
    compute dtype, ``c_rec`` a scalar, ``ct`` the per-latent L1 cotangent ([H] or
    a scalar). Returns f32 (dW_enc [C_in, H], db_enc [H], dW_dec [H, C_out],
    db_dec [C_out])."""
    return (*coder_bwd_enc_plain(x, w_enc, b_enc, w_dec, err, c_rec, ct),
            *coder_bwd_dec_plain(x, w_enc, b_enc, err, c_rec))


def center_plain(x, b_dec):
    """Plain version of csrc center_kernel: x − round(b_dec), in x's dtype."""
    return x - b_dec.to(x.dtype)


def scale_err_plain(err, c, cd):
    """Plain version of csrc scale_err_kernel, the bf16 pre-pass of the JumpReLU
    and gated backwards (f32 err) and of the ReLU and Matryoshka SAEs' cluster
    pair (bf16 err): (round(c·err) [T, C] in ``cd``, the f32 column sums of
    the unrounded c·err over each BF16_STEP_T-token step [ceil(T / 512), C]),
    c·err in f32 whatever err's dtype."""
    d = c * err.float()
    return d.to(cd), torch.stack([s.sum(0) for s in d.split(BF16_STEP_T)])


def centring_rows_plain(db_enc, w_enc):
    """db_dec's centring term −round(db_enc)·W_encᵀ as one partial row [1, C]
    (the backward kernel leaves one per 64-latent block)."""
    return -(_r(db_enc, w_enc.dtype) @ w_enc.float().T)[None]


def sae_fwd_plain(x, w_enc, b_enc, w_dec, b_dec):
    """Plain version of the forward entry point svt_sae_fwd (fwd_kernel): x_cent,
    then the coder forward on it. Returns (x_cent, recon, act_part, row_active,
    zsum_part), the per-latent partials as one row."""
    x_cent = center_plain(x, b_dec)
    recon, act, row_active, zsum = coder_forward_plain(x_cent, w_enc, b_enc, w_dec, b_dec)
    return x_cent, recon, act[None], row_active, zsum[None]


def sae_bwd_plain(x_cent, w_enc, b_enc, w_dec, err, coeffs):
    """Plain version of the backward entry point svt_sae_bwd (bwd_kernel): the
    coder backward on x_cent with c_l1 for every latent. Returns (dW_enc,
    db_enc, dW_dec, db_dec_part): the direct row, then the centring row."""
    dw_enc, db_enc, dw_dec, direct = coder_backward_plain(x_cent, w_enc, b_enc, w_dec, err,
                                                          coeffs[0], coeffs[1])
    return dw_enc, db_enc, dw_dec, torch.cat([direct[None], centring_rows_plain(db_enc, w_enc)])


def unit_scale(coeffs):
    """(1, c_l1) of (c_rec, c_l1): the coefficients of a body that reads its
    error already scaled."""
    return torch.stack([torch.ones_like(coeffs[0]), coeffs[1]])


def sae_bwd_pair_plain(x_cent, w_enc, b_enc, w_dec, err, coeffs):
    """Plain version of svt_sae_bwd's cluster-pair route: scale_err_kernel on
    the bf16 error (scale_err_plain: round(c_rec·err) and its per-step direct
    rows of db_dec), then coder_bwd_pair<Act::Relu>, sae_bwd_plain's function
    on the rounded error at a unit scale, its own direct row left to the
    pre-pass's. Returns (dW_enc, db_enc, dW_dec, db_dec_part): the direct rows,
    then the centring row."""
    scaled, direct = scale_err_plain(err, coeffs[0], x_cent.dtype)
    dw_enc, db_enc, dw_dec, rows = sae_bwd_plain(x_cent, w_enc, b_enc, w_dec, scaled,
                                                 unit_scale(coeffs))
    return dw_enc, db_enc, dw_dec, torch.cat([direct, rows[1:]])


# the plain version of each backward route of the SAE entry points (bwd_route,
# act "sae"): the pair computes coder_bwd_tc's function after its pre-pass
ROUTE_PLAIN = {"pair": sae_bwd_pair_plain, "tc": sae_bwd_plain, "simt": sae_bwd_plain}


def backward_plain(x_cent, *args, route=None):
    """The plain version of the route the card's backward takes for ``x_cent``
    (``route``, or bwd_route's for an SAE of its width and dtype)."""
    c = x_cent.shape[-1]
    return ROUTE_PLAIN[route or bwd_route(c, c, act="sae", dtype=x_cent.dtype)](x_cent, *args)


# ---------------------------------------------------------------------------
# CUDA kernels
# ---------------------------------------------------------------------------

_P = ctypes.c_void_p
_I = ctypes.c_int


@functools.cache
def _lib() -> ctypes.CDLL:
    lib = native.load("fused_sae")
    # the forwards and backwards end in (..., n_split, stream); the backwards'
    # last pointer is split_ws (csrc/coder.cuh, "Splits")
    lib.svt_sae_fwd.restype = _I
    lib.svt_sae_fwd.argtypes = [_I] + [_P] * 10 + [_I] * 4 + [_P]
    lib.svt_sae_bwd.restype = _I
    lib.svt_sae_bwd.argtypes = [_I] + [_P] * 13 + [_I] * 5 + [_P]
    lib.svt_sae_dx.restype = _I
    lib.svt_sae_dx.argtypes = [_I] + [_P] * 7 + [_I, _I, _I, _P]
    lib.svt_sae_sweep_fwd.restype = _I
    lib.svt_sae_sweep_fwd.argtypes = [_I] + [_P] * 10 + [_I] * 5 + [_P]
    lib.svt_sae_sweep_bwd.restype = _I
    lib.svt_sae_sweep_bwd.argtypes = [_I] + [_P] * 13 + [_I] * 6 + [_P]
    lib.svt_sae_pair_clusters.restype = _I
    lib.svt_sae_pair_clusters.argtypes = [_P]
    return lib


def pair_clusters() -> int:
    """The clusters of coder_bwd_pair<Act::Relu> (two CTAs each) that the
    current card holds at once (cudaOccupancyMaxActiveClusters); raises where
    the query fails."""
    out = (ctypes.c_int * 1)()
    rc = _lib().svt_sae_pair_clusters(out)
    if rc != 0:
        raise RuntimeError(f"svt_sae_pair_clusters failed: cudaError_t {rc}")
    return out[0]


def _expect(name: str, t: torch.Tensor, shape: tuple, dtype, device) -> None:
    if t.device != device or t.dtype != dtype or tuple(t.shape) != shape \
            or not t.is_contiguous():
        raise ValueError(
            f"fused SAE kernel: {name} must be a contiguous {dtype} tensor of shape "
            f"{shape} on {device}; got {t.dtype} {tuple(t.shape)} on {t.device}"
            f"{'' if t.is_contiguous() else ' (not contiguous)'}"
        )


def _check_operands(x, w_enc, b_enc, w_dec, b_dec=None):
    """Device, dtype, shape and contiguity of the forward's, backward's and dx's
    operands (the backward and dx have no b_dec), and the coder bodies' width
    rule (bodies_take); returns (t, c, h)."""
    t, c = x.shape
    h = b_enc.shape[0]
    if x.dtype not in (_F32, _BF16):
        raise ValueError(f"fused SAE kernel: compute dtype {x.dtype} not supported")
    if not bodies_take(t, h, c, c, x.dtype):
        raise ValueError(
            f"fused SAE kernel: shape T={t}, C={c}, H={h} not supported with {x.dtype} "
            f"operands (T a multiple of {TILE_T}, H of {TILE_H}; in bf16 C a multiple of "
            f"{BF16_WIDTH})"
        )
    dev = x.device
    _expect("x", x, (t, c), x.dtype, dev)
    _expect("W_enc", w_enc, (c, h), x.dtype, dev)
    _expect("b_enc", b_enc, (h,), _F32, dev)
    _expect("W_dec", w_dec, (h, c), x.dtype, dev)
    if b_dec is not None:
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
    """(bf16 flag, data pointers) of the operands, as the C entry points take them
    (None, a null pointer, for an absent one)."""
    return (int(x.dtype == _BF16), x.data_ptr(),
            *(None if t is None else t.data_ptr() for t in tensors))


def forward_outputs(x, h: int, recon_shape: tuple, n: int = 0, split: int = 1) -> tuple:
    """Empty outputs of the SAE forward entry points: x_cent, recon (or
    prefix_recon), act_part, row_active, zsum_part; each with a leading [n]
    axis when ``n`` (the sweep's combos, ``recon_shape`` one combo's), recon
    and row_active with a leading [split] axis of partials before it when
    ``split`` > 1 (join_forward sums them)."""
    t = x.shape[0]
    lead = (n,) if n else ()
    dev = x.device
    return (torch.empty((*lead, *x.shape), dtype=x.dtype, device=dev),
            split_empty(split, (*lead, *recon_shape), dev),
            torch.empty((*lead, t // PART_T, h), dtype=_F32, device=dev),
            split_empty(split, (*lead, t), dev),
            torch.empty((*lead, t // PART_T, h), dtype=_F32, device=dev))


def join_forward(outs: tuple, s: int) -> tuple:
    """forward_outputs' tuple with recon and row_active summed over their s
    split partials."""
    x_cent, recon, act_part, row_active, zsum_part = outs
    return x_cent, join_splits(recon, s), act_part, join_splits(row_active, s), zsum_part


def backward_outputs(x_cent, h: int) -> tuple:
    """Empty outputs of the SAE backward entry points: dW_enc, db_enc, dW_dec and
    db_dec_part (the direct rows, then one centring row per 64 latents); each
    with x_cent's leading [N] axis in the sweep."""
    *lead, t, c = x_cent.shape
    dev = x_cent.device
    rows = direct_rows(t, x_cent.dtype) + h // BLOCK_H
    return (torch.empty((*lead, c, h), dtype=_F32, device=dev),
            torch.empty((*lead, h), dtype=_F32, device=dev),
            torch.empty((*lead, h, c), dtype=_F32, device=dev),
            torch.empty((*lead, rows, c), dtype=_F32, device=dev))


class _ForwardKernel(Kernel):
    """csrc svt_sae_fwd: center_kernel, then the coder forward body on x_cent.
    Returns what sae_fwd_plain returns (one partial row per 64 tokens)."""

    name = "fused_sae_fwd"

    def __call__(self, x, w_enc, b_enc, w_dec, b_dec, n_split=None):
        t, c, h = _check_operands(x, w_enc, b_enc, w_dec, b_dec)
        s = launch_split(x, t, h, c, backward=False, n_split=n_split)
        outs = forward_outputs(x, h, (t, c), split=s)
        self._launch(_lib().svt_sae_fwd, x.device,
                     *_ptrs(x, w_enc, b_enc, w_dec, b_dec, *outs), t, c, h, s)
        return join_forward(outs, s)


class _PairBody(Kernel):
    """The cluster-pair backward body of the ReLU and Matryoshka SAEs (csrc/
    coder.cuh coder_bwd_pair<Act::Relu>, bwd_route's "pair" for act "sae"):
    its count goes up wherever one of their backward launches runs it (the
    launching wrapper's own count goes up too)."""

    name = "coder_bwd_pair_relu"


pair_kernel = _PairBody()


def sae_route(x_cent, c: int, levels: int, route) -> tuple:
    """(route, its ``pair`` flag for the SAE backward entry points): ``route``
    where the caller names one (chip_smoke.py times "tc" on a pair launch),
    else bwd_route's for an SAE backward of width c and ``levels`` prefix
    levels in x_cent's dtype."""
    route = route or bwd_route(c, c, levels, act="sae", dtype=x_cent.dtype)
    if route not in ROUTE_PLAIN:
        raise ValueError(f"fused SAE backward: no {route!r} route (its routes: "
                         f"{', '.join(ROUTE_PLAIN)})")
    return route, int(route == "pair")


class _BackwardKernel(Kernel):
    """csrc svt_sae_bwd: the body bwd_route names on x_cent, c_l1 broadcast to
    every latent: in bf16 at C <= 256 the cluster pair (scale_err_kernel, then
    coder_bwd_pair<Act::Relu>; counted on ``pair_kernel`` too), else
    coder_bwd_tc; in f32 the SIMT body. ``route="tc"`` runs coder_bwd_tc on a
    pair launch. Returns what the route's plain version returns
    (backward_plain; one centring row per 64 latents)."""

    name = "fused_sae_bwd"

    def __call__(self, x_cent, w_enc, b_enc, w_dec, err, coeffs, n_split=None, route=None):
        t, c, h = _check_operands(x_cent, w_enc, b_enc, w_dec)
        dev = x_cent.device
        _expect("err", err, (t, c), x_cent.dtype, dev)
        _expect("coeffs", coeffs, (2,), _F32, dev)
        ct = coeffs[1:].expand(h).contiguous()
        route, pair = sae_route(x_cent, c, 1, route)
        s = launch_split(x_cent, t, h, c, backward=True, n_split=n_split, pair=bool(pair))
        outs = backward_outputs(x_cent, h)
        err_s = torch.empty_like(err) if pair else None  # round(c_rec·err), the pre-pass's
        self._launch(_lib().svt_sae_bwd, dev,
                     *_ptrs(x_cent, w_enc, b_enc, w_dec, err, coeffs, ct, *outs,
                            split_workspace(s, 1, h, c, c, dev, route), err_s), t, c, h,
                     pair, s)
        pair_kernel.launches += pair
        return outs


class _DxKernel(Kernel):
    """csrc svt_sae_dx: the coder forward bodies' dx route on x_cent (one level).
    Returns dx [T, C] f32, what fused_sae_dx_plain returns."""

    name = "fused_sae_dx"

    def __call__(self, x_cent, w_enc, b_enc, w_dec, err, coeffs):
        t, c, h = _check_operands(x_cent, w_enc, b_enc, w_dec)
        dev = x_cent.device
        _expect("err", err, (t, c), x_cent.dtype, dev)
        _expect("coeffs", coeffs, (2,), _F32, dev)
        dx = torch.empty((t, c), dtype=_F32, device=dev)
        self._launch(_lib().svt_sae_dx, dev,
                     *_ptrs(x_cent, w_enc, b_enc, w_dec, err, coeffs, dx), t, c, h)
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


def fused_sae_forward(x, w_enc, b_enc, w_dec, b_dec, kernel=fwd_kernel):
    """The forward entry point (the kernels on CUDA tensors, through
    ``kernel``, whose count it adds to; sae_fwd_plain on CPU tensors), its
    partials reduced here: (x_cent, recon, act_count, row_active, l1_sum)."""
    x_cent, recon, act_part, row_active, zsum_part = run_on_device(
        kernel, sae_fwd_plain, x, w_enc, b_enc, w_dec, b_dec)
    return x_cent, recon, act_part.sum(0), row_active, zsum_part.sum()


def fused_sae_backward(x_cent, w_enc, b_enc, w_dec, err, coeffs, kernel=bwd_kernel):
    """The backward entry point on the saved x_cent (the kernel on CUDA tensors,
    through ``kernel``; the plain version of its route, backward_plain, on CPU
    tensors), db_dec's partial rows reduced here: (dW_enc, db_enc, dW_dec,
    db_dec)."""
    dw_enc, db_enc, dw_dec, db_dec_part = run_on_device(
        kernel, backward_plain, x_cent, w_enc, b_enc, w_dec, err, coeffs)
    return dw_enc, db_enc, dw_dec, db_dec_part.sum(0)


def fused_sae_dx(x_cent, w_enc, b_enc, w_dec, err, coeffs):
    """The dx entry point on the saved x_cent and error (the kernel on CUDA
    tensors, fused_sae_dx_plain on CPU tensors): dx [T, C] f32."""
    return run_on_device(dx_kernel, fused_sae_dx_plain, x_cent, w_enc, b_enc, w_dec, err, coeffs)


def loss_coeffs(*terms, lead: tuple, device) -> torch.Tensor:
    """The backward's coefficients [*lead, len(terms)]: each term (g, num, den)
    the cotangent g (shape ``lead``: () for one dictionary, (N,) for a sweep;
    None for zero) times num over den, in one order of operations for both, so
    a sweep's combo gets its one-dictionary op's coefficients; on the device
    (never a host sync)."""
    zero = torch.zeros(lead, dtype=_F32, device=device)
    return torch.stack([(zero if g is None else g.float()) * num / den
                        for g, num, den in terms], -1)


class FusedSAEFunction(torch.autograd.Function):
    """(x, W_enc, b_enc, W_dec, b_dec) -> (rec_loss, l1_loss, recon, act_count,
    row_active), the counterpart of the JAX op's custom_vjp; with a sweep's
    leading [N] axis on the parameters (x shared) every output gains it, and
    each pass is one launch of its sweep entry point (module docstring)."""

    @staticmethod
    def forward(ctx, x, w_enc, b_enc, w_dec, b_dec, compute_dtype, compute_dx):
        cd = compute_dtype
        t, c = x.shape
        h = b_enc.shape[-1]  # the true H; the kernels run at padded_h(H)
        xc = x.to(cd).contiguous()
        we, b_enc, wd = padded_operands(w_enc, b_enc, w_dec, cd)
        forward = fused_sae_sweep_forward if w_enc.ndim == 3 else fused_sae_forward
        x_cent, recon, act_count, row_active, l1_sum = forward(
            xc, we, b_enc, wd, b_dec.contiguous())
        err = recon - x  # against x in its own dtype, before the compute cast
        rec_loss = err.square().mean((-2, -1))
        l1_loss = l1_sum / (t * h)
        # the backward and dx run on x_cent
        ctx.save_for_backward(x_cent, we, b_enc, wd, err.to(cd))
        ctx.compute_dx = compute_dx
        ctx.h = h
        act_count = act_count[..., :h]
        ctx.mark_non_differentiable(recon, act_count, row_active)
        return rec_loss, l1_loss, recon, act_count, row_active

    @staticmethod
    def backward(ctx, g_rec, g_l1, *_unused):
        x_cent, we, b_enc, wd, err = ctx.saved_tensors
        *lead, t, c = x_cent.shape
        h = ctx.h
        coeffs = loss_coeffs((g_rec, 2.0, t * c), (g_l1, 1.0, t * h), lead=tuple(lead),
                             device=x_cent.device)
        backward = fused_sae_sweep_backward if lead else fused_sae_backward
        dw_enc, db_enc, dw_dec, db_dec = backward(x_cent, we, b_enc, wd, err, coeffs)
        dx = None
        if ctx.compute_dx and ctx.needs_input_grad[0]:
            dx = fused_sae_dx(x_cent, we, b_enc, wd, err, coeffs)
        if b_enc.shape[-1] != h:  # the padded latents' gradients are exactly zero
            dw_enc, db_enc, dw_dec = (dw_enc[..., :h].contiguous(), db_enc[..., :h],
                                      dw_dec[..., :h, :])
        return dx, dw_enc, db_enc, dw_dec, db_dec, None, None


def fused_sae_loss_terms(params: dict, x: torch.Tensor, lambda_sparse: float,
                         expansion_factor: int, *, compute_dtype=_BF16,
                         compute_dx: bool = False) -> dict:
    """Fused equivalent of sae_inference_and_loss + measure_inactive_units on 2-D
    token input: loss terms (loss = rec + λ·l1), recon, and dead/sparsity stats
    from the kernel. RMSE/NRMSE come from the [T, C] reconstruction in plain
    torch. ``compute_dx=True`` gives ``x`` its gradient (the dx entry point);
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


# ---------------------------------------------------------------------------
# the sweep: N stacked dictionaries on one shared batch (module docstring)
# ---------------------------------------------------------------------------

def stack_plain(plain, shared: int, *args):
    """The per-combo stack of ``plain``: combo n gets args[:shared] whole (the
    shared batch) and args[shared:][j][n] of every stacked argument j; each of
    plain's outputs comes back stacked [N, ...]."""
    n = args[shared].shape[0]
    outs = [plain(*args[:shared], *(a[i] for a in args[shared:])) for i in range(n)]
    return tuple(torch.stack(o) for o in zip(*outs))


def sae_sweep_fwd_plain(x, w_enc, b_enc, w_dec, b_dec):
    """Plain version of svt_sae_sweep_fwd: sae_fwd_plain per combo on the shared
    x, stacked (x_cent [N, T, C], recon [N, T, C], act_part and zsum_part [N, 1,
    H], row_active [N, T])."""
    return stack_plain(sae_fwd_plain, 1, x, w_enc, b_enc, w_dec, b_dec)


def sae_sweep_bwd_plain(x_cent, w_enc, b_enc, w_dec, err, coeffs):
    """Plain version of svt_sae_sweep_bwd's route for x_cent's width and dtype
    (backward_plain) per combo, stacked; ``coeffs`` [N, 2]."""
    return stack_plain(backward_plain, 0, x_cent, w_enc, b_enc, w_dec, err, coeffs)


def _check_sweep(name, x, w_enc, b_enc, w_dec, b_dec=None, x_rows: int = 0):
    """Device, dtype, shape and contiguity of a sweep entry point's operands: x
    [T, C] shared (``x_rows`` 0) or x_cent [N, T, C] stacked (``x_rows`` 1), the
    stacked W_enc [N, C, H], b_enc [N, H], W_dec [N, H, C] and b_dec [N, C], and
    the bodies' width rule; returns (n, t, c, h)."""
    n, c, h = w_enc.shape
    t = x.shape[x_rows]
    if x.dtype not in (_F32, _BF16):
        raise ValueError(f"{name}: compute dtype {x.dtype} not supported")
    if not bodies_take(t, h, c, c, x.dtype):
        raise ValueError(
            f"{name}: shape T={t}, C={c}, H={h} not supported with {x.dtype} operands (T a "
            f"multiple of {TILE_T}, H of {TILE_H}; in bf16 C a multiple of {BF16_WIDTH})")
    dev = x.device
    _expect("x", x, (n, t, c)[1 - x_rows:], x.dtype, dev)
    _expect("W_enc", w_enc, (n, c, h), x.dtype, dev)
    _expect("b_enc", b_enc, (n, h), _F32, dev)
    _expect("W_dec", w_dec, (n, h, c), x.dtype, dev)
    if b_dec is not None:
        _expect("b_dec", b_dec, (n, c), _F32, dev)
    return n, t, c, h


class _SweepForwardKernel(Kernel):
    """csrc svt_sae_sweep_fwd: center_kernel and the coder forward body for all
    N combos, one launch each. Returns what sae_sweep_fwd_plain returns (one
    partial row per 64 tokens)."""

    name = "fused_sae_sweep_fwd"

    def __call__(self, x, w_enc, b_enc, w_dec, b_dec, n_split=None):
        n, t, c, h = _check_sweep(self.name, x, w_enc, b_enc, w_dec, b_dec)
        s = launch_split(x, t, h, c, backward=False, n_split=n_split)  # one combo's
        outs = forward_outputs(x, h, (t, c), n, s)
        self._launch(_lib().svt_sae_sweep_fwd, x.device,
                     *_ptrs(x, w_enc, b_enc, w_dec, b_dec, *outs), t, c, h, n, s)
        return join_forward(outs, s)


class _SweepBackwardKernel(Kernel):
    """csrc svt_sae_sweep_bwd: _BackwardKernel's route (bwd_route's from one
    dictionary's width) on every combo's x_cent, one launch of each pass.
    Returns what sae_sweep_bwd_plain returns (one centring row per 64
    latents)."""

    name = "fused_sae_sweep_bwd"

    def __call__(self, x_cent, w_enc, b_enc, w_dec, err, coeffs, n_split=None, route=None):
        n, t, c, h = _check_sweep(self.name, x_cent, w_enc, b_enc, w_dec, x_rows=1)
        dev = x_cent.device
        _expect("err", err, (n, t, c), x_cent.dtype, dev)
        _expect("coeffs", coeffs, (n, 2), _F32, dev)
        ct = coeffs[:, 1:].expand(n, h).contiguous()
        route, pair = sae_route(x_cent, c, 1, route)
        s = launch_split(x_cent, t, h, c, backward=True, n_split=n_split,
                         pair=bool(pair))  # one combo's
        outs = backward_outputs(x_cent, h)
        err_s = torch.empty_like(err) if pair else None
        self._launch(_lib().svt_sae_sweep_bwd, dev,
                     *_ptrs(x_cent, w_enc, b_enc, w_dec, err, coeffs, ct, *outs,
                            split_workspace(s, n, h, c, c, dev, route), err_s), t, c, h, n,
                     pair, s)
        pair_kernel.launches += pair
        return outs


sweep_fwd_kernel = _SweepForwardKernel()
sweep_bwd_kernel = _SweepBackwardKernel()
SWEEP_KERNELS = (sweep_fwd_kernel, sweep_bwd_kernel)


def fused_sae_sweep_forward(x, w_enc, b_enc, w_dec, b_dec):
    """The sweep forward entry point (the kernels on CUDA tensors;
    sae_sweep_fwd_plain on CPU tensors), its partials reduced per combo:
    (x_cent [N, T, C], recon [N, T, C], act_count [N, H], row_active [N, T],
    l1_sum [N])."""
    x_cent, recon, act_part, row_active, zsum_part = run_on_device(
        sweep_fwd_kernel, sae_sweep_fwd_plain, x, w_enc, b_enc, w_dec, b_dec)
    return x_cent, recon, act_part.sum(1), row_active, zsum_part.sum((1, 2))


def fused_sae_sweep_backward(x_cent, w_enc, b_enc, w_dec, err, coeffs):
    """The sweep backward entry point on the saved x_cent (the kernel on CUDA
    tensors; sae_sweep_bwd_plain on CPU tensors), db_dec's partial rows reduced
    per combo: (dW_enc, db_enc, dW_dec, db_dec), each [N, ...]."""
    dw_enc, db_enc, dw_dec, db_dec_part = run_on_device(
        sweep_bwd_kernel, sae_sweep_bwd_plain, x_cent, w_enc, b_enc, w_dec, err, coeffs)
    return dw_enc, db_enc, dw_dec, db_dec_part.sum(1)


def sweep_terms(rec_loss, l1_loss, act_count, row_active, t: int, h: int,
                expansion_factor: int, loss) -> dict:
    """The sweep step's per-combo terms of a fused sweep op ([N] each; dead [N,
    H]): loss, rec_loss, l1_loss, dead and sparsity, as fused_sae_loss_terms
    names them."""
    return {"loss": loss, "rec_loss": rec_loss, "l1_loss": l1_loss, "dead": act_count == 0,
            "sparsity": torch.mean(row_active / (h / expansion_factor), 1)}


def fused_sae_sweep_loss_terms(params: dict, x: torch.Tensor, lambdas: torch.Tensor,
                               expansion_factor: int, *, compute_dtype=_BF16) -> dict:
    """fused_sae_loss_terms for N stacked dictionaries (``params`` leaves [N,
    ...], ``lambdas`` [N]) on one shared batch x [T, C]: per-combo loss terms
    [N], the dead mask [N, H] and sparsity [N]; one forward and one backward
    launch for all N (FusedSAEFunction on the stacked parameters)."""
    cd = compute_dtype_of(compute_dtype)
    rec_loss, l1_loss, recon, act_count, row_active = FusedSAEFunction.apply(
        x, params["W_enc"], params["b_enc"], params["W_dec"], params["b_dec"], cd, False)
    return sweep_terms(rec_loss, l1_loss, act_count, row_active, x.shape[0],
                       params["b_enc"].shape[1], expansion_factor,
                       rec_loss + lambdas * l1_loss)
