"""Smoke run of the PyTorch/CUDA port on one NVIDIA GPU.

    python3 chip_smoke.py              # every phase, one card
    python3 chip_smoke.py --profile    # the same, with a torch.profiler table of each slice run

Phases, in order; a phase that fails raises and the script exits non-zero:
  1. device:  require CUDA; print the card's name and power limit (nvidia-smi).
  2. build:   compile every kernel in sparse_vision_tpu_torch/csrc with nvcc, one
              process per source, all started together; print each
              instantiation's registers (beside REGISTERS_BEFORE's count
              where it has one) and fail on any spill.
  3. kernels: hold each kernel against its plain PyTorch version on the card at
              the training shape (SAEs: T=32768 tokens, C=256, H=16384 latents,
              the Matryoshka prefixes ending at 1024, 4096 and 16384; the
              transcoder: T=32768, C_in=256 -> C_out=480, H=16384; the
              crosscoder: T=16384, dims 512/512/512/528/832 = 2896, H=8192), in
              f32 and bf16 operands; time kernel, plain version and the cuBLAS
              products of the stock path; compute each kernel's bound and its
              achieved TFLOP/s. The ReLU and Matryoshka ops (the coder bodies
              on the centred input) are also held to their plain versions at
              C=480 and C=832 (T=8192, H=4096, prefixes 1024/2048/4096; a
              Matryoshka backward whose levels' errors differ, prefixes
              128/1024/4096), their bf16 launches must repeat bitwise, 20 at
              C=832 (the in-place forward), and each is timed there, the two
              dx entry points too (above C=256 the dx route of the in-place
              body; 20 bitwise-equal ReLU dx launches at 832); so are
              the JumpReLU and gated forwards and backwards in both dtypes (the
              coder bodies' Act::Jump and Act::Gated epilogues; the gated
              forward's two launches, Act::GatedEnc and Act::GatedPi, above
              C=256 in bf16 and always in f32), also at a ragged shape (T=1152,
              H=640, C=136), 20 bitwise-equal bf16 launches each at C=832.
              The ptxas report names each instantiation with its registers
              and spill bytes. The
              transcoder/crosscoder pair is also held to
              its plain versions at ragged shapes (T=1152, C_in=264, H=640,
              C_out=136 and 520: a partial token step, latent group and channel
              chunk at every edge, for both bf16 forward bodies), and its bf16 kernels must give bitwise-equal outputs
              on a repeat launch.
  4. parity:  each fused op's loss and gradients against the stock autograd path
              on the card at a small shape, in f32; with compute_dx=True, the
              sae_mlp and Matryoshka ops' input gradients too.
  5. dx:      the dx kernels' path (training treats activations as data): the
              sae_mlp and Matryoshka ops with compute_dx=True at the training
              shape in bf16 through torch.autograd, one launch each of forward,
              backward and dx, x's gradient held to the plain dx.
  6. slice:   Pipeline.train_sae on the north-star config (GoogLeNet mixed3a,
              16,384 latents, bf16 cache, 12 steps of 32,768 tokens) for sae_mlp
              (measurement resets at steps 4 and 12, a resample at step 9), then
              gated_sae, jumprelu_sae and matryoshka_sae (the rolling dead window
              restarts at steps 4, 8 and 12), the transcoder mixed3a -> mixed3b
              and the crosscoder mixed4a..mixed4e (8,192 latents, 12 steps of
              16,384 tokens; sae_input_norm="rms" at λ 5), both resampling
              like sae_mlp; every kernel launch count is reset just before each
              run and read after it.
  7. cache:   the host side of the cached path at the sae_mlp slice's shape:
              an overlap_dump_train run (12 + 12 launches) whose shards are
              byte-equal to a sequential dump's; every stack that prefetch
              stages onto the card bitwise equal to a synchronous copy, read
              behind fused launches; an int8-cache run through the
              device-dequant steps within 5% of the bf16 run's last eval.
  8. artifacts: a trained dictionary as an artifact, on the gated_sae slice
              (two epochs, 12 steps each, through Pipeline.run): (a) an
              uninterrupted run (24 + 24 launches); (b) one epoch, then a
              fresh Pipeline resumed from its checkpoint (12 + 12 launches
              each), bitwise equal to (a) in params, Adam state, step and
              dead accumulator; (c) a standalone eval of (a)'s epoch-2
              checkpoint that reproduces (a)'s last eval; (d) the .npz, .pth
              and SAELens exports read back bitwise; (e) the results CSV's
              rows of epochs 1 and 2 and the epoch-2 top-k file. Times one
              checkpoint's snapshot, write and restore, the export, and an
              eval with and without its top-k updates.
Then one JSON line naming each kernel, the nvidia-smi line, and the last line
{"ok": true, "device": {...}}.
"""

from __future__ import annotations

import argparse
import dataclasses
import json
import math
import os
import re
import shutil
import subprocess
import sys
import time
from pathlib import Path

import torch

from sparse_vision_tpu_torch.config import RunConfig
from sparse_vision_tpu_torch.data.datasets import make_synthetic
from sparse_vision_tpu_torch.models.crosscoder import (
    crosscoder_inference_and_loss,
    init_crosscoder,
)
from sparse_vision_tpu_torch.models.sae import (
    DEFAULT_MATRYOSHKA_PREFIXES,
    init_gated_sae,
    init_jumprelu_sae,
    init_sae_mlp,
    init_transcoder,
    matryoshka_prefix_counts,
    matryoshka_sae_apply,
    sae_inference_and_loss,
    transcoder_inference_and_loss,
)
from sparse_vision_tpu_torch.ops import (
    fused_crosscoder,
    fused_gated_sae,
    fused_jumprelu_sae,
    fused_matryoshka_sae,
    fused_sae,
    fused_transcoder,
    native,
)
from sparse_vision_tpu_torch.train import checkpoint as ckpt
from sparse_vision_tpu_torch.train.pipeline import Pipeline

ROOT = Path(__file__).resolve().parent
WORK = ROOT / "_smoke_work"  # listed in .gitignore; removed at the end
DEVICE = "cuda"

# H100 SXM data sheet, dense: bf16 tensor cores, f32 outside them; HBM3 rate
PEAK_FLOPS = {torch.bfloat16: 989e12, torch.float32: 67e12}
PEAK_BYTES_PER_S = 3.35e12

T, C, H = 32768, 256, 16384
TC_T, TC_CIN, TC_COUT, TC_H = 32768, 256, 480, 16384  # transcoder mixed3a -> mixed3b
CC_T, CC_DIMS, CC_H = 16384, (512, 512, 512, 528, 832), 8192  # crosscoder mixed4a..4e
LAMBDA = 5.0  # sae_mlp and gated_sae
# jumprelu_sae: λ, and the STE bandwidth of the kernel and parity phases, whose
# inputs give pre-activations of std ~2
LAMBDA_J, BANDWIDTH = 0.02, 1.0
REPS = 5  # timed launches per measurement, after one warm-up

MODULES = {"sae_mlp": fused_sae, "gated_sae": fused_gated_sae,
           "jumprelu_sae": fused_jumprelu_sae, "matryoshka_sae": fused_matryoshka_sae,
           "transcoder": fused_transcoder, "crosscoder": fused_crosscoder}
KERNELS = tuple(k for m in MODULES.values() for k in m.KERNELS)
# the source of each kernel's body (bf16, the main path's); the coder family's
# entry points are in fused_sae.cu (the ReLU and Matryoshka SAEs),
# fused_jumprelu_sae.cu and fused_gated_sae.cu (the JumpReLU and gated SAEs) and
# fused_transcoder.cu (the coders)
CODER = "sparse_vision_tpu_torch/csrc/coder.cuh"
SOURCES = {
    "fused_sae_fwd": CODER, "fused_sae_bwd": CODER,
    "fused_sae_dx": CODER,  # bf16: coder_fwd_tc_hold<256, false, Act::Relu, true> (kDx)
    "fused_matryoshka_sae_fwd": CODER, "fused_matryoshka_sae_bwd": CODER,
    "fused_matryoshka_sae_dx": CODER,
    "fused_jumprelu_sae_fwd": CODER,  # bf16: coder_fwd_tc_hold<256, false, Act::Jump>
    "fused_jumprelu_sae_bwd": CODER,  # bf16: coder_bwd_tc<true, Act::Jump>
    "fused_gated_sae_fwd": CODER,  # bf16: coder_fwd_tc_hold<256, false, Act::Gated>
    "fused_gated_sae_bwd": CODER,  # bf16: coder_bwd_tc<true, Act::Gated>
    "fused_transcoder_fwd": CODER, "fused_transcoder_bwd": CODER,
    "fused_crosscoder_fwd": CODER, "fused_crosscoder_bwd": CODER,
}
REPLACES = {
    "fused_sae_fwd": "sparse_vision_tpu/ops/fused_sae.py:43",
    "fused_sae_bwd": "sparse_vision_tpu/ops/fused_sae.py:96",
    "fused_sae_dx": "sparse_vision_tpu/ops/fused_sae.py:168",
    "fused_matryoshka_sae_fwd": "sparse_vision_tpu/ops/fused_matryoshka_sae.py:99",
    "fused_matryoshka_sae_bwd": "sparse_vision_tpu/ops/fused_matryoshka_sae.py:155",
    "fused_matryoshka_sae_dx": "sparse_vision_tpu/ops/fused_matryoshka_sae.py:227",
    "fused_jumprelu_sae_fwd": "sparse_vision_tpu/ops/fused_jumprelu_sae.py:30",
    "fused_jumprelu_sae_bwd": "sparse_vision_tpu/ops/fused_jumprelu_sae.py:80",
    "fused_gated_sae_fwd": "sparse_vision_tpu/ops/fused_gated_sae.py:42",
    "fused_gated_sae_bwd": "sparse_vision_tpu/ops/fused_gated_sae.py:98",
    "fused_transcoder_fwd": "sparse_vision_tpu/ops/fused_transcoder.py:41",
    "fused_transcoder_bwd": "sparse_vision_tpu/ops/fused_transcoder.py:91",
    "fused_crosscoder_fwd": "sparse_vision_tpu/ops/fused_crosscoder.py:68",
    "fused_crosscoder_bwd": "sparse_vision_tpu/ops/fused_crosscoder.py:109",
}


def log(msg: str) -> None:
    print(msg, flush=True)


def set_tf32(enabled: bool) -> None:
    torch.backends.cuda.matmul.allow_tf32 = enabled
    torch.backends.cudnn.allow_tf32 = enabled


def time_ms(fn, reps: int) -> float:
    """Mean device time of ``fn`` over ``reps`` calls after one warm-up (CUDA events)."""
    fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    end.synchronize()
    return start.elapsed_time(end) / reps


def nbytes(*ts) -> int:
    return sum(t.numel() * t.element_size() for t in ts)


def bound(flops: float, moved: int, dtype) -> tuple:
    t_ops = flops / PEAK_FLOPS[dtype] * 1e3
    t_bytes = moved / PEAK_BYTES_PER_S * 1e3
    return (t_ops, "operations") if t_ops >= t_bytes else (t_bytes, "bytes")


def phase_device() -> str:
    if not torch.cuda.is_available():
        raise SystemExit("chip_smoke: torch.cuda.is_available() is false; no result")
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         check=True, capture_output=True, text=True).stdout.strip()
    log(f"[device] {smi}")
    log(f"[device] torch {torch.__version__} cuda {torch.version.cuda} "
        f"count {torch.cuda.device_count()} kind {torch.cuda.get_device_name(0)}")
    return smi.splitlines()[0]


def phase_build() -> None:
    """Build every kernel and print ptxas's report; a kernel that spills
    registers to local memory fails the phase."""
    t0 = time.perf_counter()
    built = native.build()
    for name, b in built.items():
        ptxas = [ln.strip() for ln in b["log"].splitlines()
                 if "Function properties" in ln or "registers" in ln or "spill" in ln]
        log(f"[build] {name}: {b['seconds']:.1f} s -> {b['path']}")
        for ln in ptxas:
            log(f"[build]   {ln}")
        for kernel, regs, spill in _ptxas_kernels(b["log"]):
            before = REGISTERS_BEFORE.get(re.sub(r"^(coder_fwd_tc\w*<.*), false>$", r"\1>", kernel))
            note = "" if before is None else (
                f" (before: {before}{'' if before == regs else ', moved'})")
            log(f"[build]   {regs} registers, {spill} spill bytes: {kernel}{note}")
        spills = [ln for ln in ptxas if re.search(r"[1-9]\d* bytes spill (stores|loads)", ln)]
        if spills:
            raise AssertionError(f"{name}: ptxas reports register spills: {spills}")
    log(f"[build] all kernels in {time.perf_counter() - t0:.1f} s")


# ptxas registers of the coder family's instantiations (nvcc 12.8, sm_90a; this
# script's build phase on an H100 host): the bf16 bodies' before the dx route
# (kDx) joined the forward bodies, the SIMT bodies' Act::Relu instantiations
# before the kAct epilogues joined them (the parent's sources built beside).
# The build phase prints each instantiation here beside its count: neither
# change moves them.
REGISTERS_BEFORE = {
    "coder_fwd_kernel<float, true, false, Act::Relu>": 122,
    "coder_fwd_kernel<float, false, false, Act::Relu>": 181,
    "coder_fwd_kernel<float, false, true, Act::Relu>": 216,
    "coder_fwd_tc<true, Act::Relu>": 255, "coder_fwd_tc<false, Act::Relu>": 247,
    "coder_fwd_tc_hold<512, true, Act::Relu>": 255,
    "coder_fwd_tc_hold<512, false, Act::Relu>": 254,
    "coder_fwd_tc_hold<256, true, Act::Relu>": 225,
    "coder_fwd_tc_hold<256, false, Act::Relu>": 218,
    "coder_fwd_tc<false, Act::Jump>": 251, "coder_fwd_tc_hold<512, false, Act::Jump>": 255,
    "coder_fwd_tc_hold<256, false, Act::Jump>": 226,
    "coder_fwd_tc<false, Act::GatedEnc>": 246,
    "coder_fwd_tc_hold<512, false, Act::GatedEnc>": 254,
    "coder_fwd_tc<false, Act::GatedPi>": 192, "coder_fwd_tc_hold<512, false, Act::GatedPi>": 248,
    "coder_fwd_tc_hold<256, false, Act::Gated>": 255,
    "coder_bwd_kernel<float, true, Act::Relu>": 197,
    "coder_bwd_kernel<float, false, Act::Relu>": 189,
    "coder_bwd_tc<true, Act::Relu>": 251, "coder_bwd_tc<false, Act::Relu>": 254,
    "coder_bwd_tc<true, Act::Jump>": 248, "coder_bwd_tc<true, Act::Gated>": 254,
}


def _ptxas_kernels(ptxas_log: str) -> list:
    """(kernel, registers, spill bytes) of every entry function in a ptxas -v
    report, the names demangled by c++filt where the toolkit's host has it."""
    rows, name, spill = [], None, 0
    for ln in ptxas_log.splitlines():
        if m := re.search(r"Compiling entry function '([^']+)'", ln):
            name, spill = m.group(1), 0
        elif (m := re.search(r"(\d+) bytes spill stores, (\d+) bytes spill loads", ln)) and name:
            spill = int(m.group(1)) + int(m.group(2))
        elif (m := re.search(r"Used (\d+) registers", ln)) and name:
            rows.append([name, int(m.group(1)), spill])
            name = None
    if rows and shutil.which("c++filt"):
        out = subprocess.run(["c++filt"], input="\n".join(r[0] for r in rows), text=True,
                             capture_output=True, check=True).stdout.splitlines()
        for r, n in zip(rows, out):
            depth = 0  # cut the parameter list, the last balanced (...)
            for i in range(len(n) - 1, -1, -1):
                depth += {")": 1, "(": -1}.get(n[i], 0)
                if depth == 0:
                    n = n[:i]
                    break
            n = n.removeprefix("void ").replace("(anonymous namespace)::", "")
            for k, act in enumerate(("Relu", "Jump", "Gated", "GatedEnc", "GatedPi")):
                n = n.replace(f"(Act){k}", f"Act::{act}")
            r[0] = n
    return rows


def _check(name: str, got, ref, rtol: float, atol_frac: float) -> float:
    """Max abs error of got vs ref; fails when it exceeds rtol*|ref| + atol_frac*max|ref|."""
    got, ref = got.float(), ref.float()
    err = (got - ref).abs()
    scale = ref.abs().max().item()
    tol = rtol * ref.abs() + atol_frac * max(scale, 1e-30)
    worst = err.max().item()
    log(f"[kernels]   {name}: max_abs_err {worst:.3e} (max|ref| {scale:.3e}, "
        f"max rel {(err / ref.abs().clamp(min=1e-30)).max().item():.3e})")
    if not bool((err <= tol).all()):
        raise AssertionError(f"{name}: kernel disagrees with the plain version "
                             f"(max abs err {worst:.3e})")
    return worst


def _measure(name: str, tag: str, cd, kernel, plain, library, flops: float, moved: int,
             max_abs_err: float) -> dict:
    """Times of kernel, plain version and the stock path's cuBLAS products, the
    bound and the achieved rate; one row of the kernels line."""
    ms = time_ms(kernel, REPS)
    plain_ms = time_ms(plain, REPS)
    lib_ms = time_ms(library, REPS)
    b_ms, b_by = bound(flops, moved, cd)
    tflops = flops / ms / 1e9
    log(f"[kernels] {name} [{tag}] ms {ms:.3f} plain_ms {plain_ms:.3f} "
        f"library_ms {lib_ms:.3f} bound_ms {b_ms:.4f} ({b_by}) TFLOP/s {tflops:.1f}")
    return dict(max_abs_err=max_abs_err, ms=ms, plain_ms=plain_ms, bound_ms=b_ms,
                bound_by=b_by, library_ms=lib_ms, tflops=tflops)


def _dyadic(t: torch.Tensor, step: float) -> torch.Tensor:
    """``t`` rounded to a multiple of the power of two ``step``."""
    return torch.round(t / step) * step


def _odd_grid(gen, n: int, half_range: int) -> torch.Tensor:
    """Odd multiples of 2^-11 in about ±half_range·2^-10: as biases on top of a
    product that is an exact multiple of 2^-10, the sum is never 0."""
    k = torch.randint(-half_range, half_range, (n,), device=DEVICE, generator=gen)
    return (2 * k + 1).float() * 2.0 ** -11


def _exact_inputs(gen, n_tokens: int, w: torch.Tensor):
    """Token input and encoder weights on a dyadic grid (x in quarters, W in
    1/256ths, b_dec in quarters): every product and partial sum of x_cent @ W is
    exact in f32, so the kernel and cuBLAS, which sum in other orders, give the
    same pre-activations bit for bit. The gated and JumpReLU activations jump at
    a threshold, so a pre-activation that differed by one rounding could switch a
    latent on in one and off in the other; on this grid none can."""
    x = _dyadic(torch.relu(torch.randn(n_tokens, w.shape[0], device=DEVICE, generator=gen))
                * 2.0, 0.25)
    b_dec = _dyadic(0.2 * torch.randn(w.shape[0], device=DEVICE, generator=gen), 0.25)
    return x, _dyadic(w, 2.0 ** -8), b_dec


# ---------------------------------------------------------------------------
# kernels phase, one function per fused op; each returns {kernel name: row}
# ---------------------------------------------------------------------------

def _sae_fwd_check(mod, tag: str, cd, ops, extra=(), exact: bool = False, label: str = ""):
    """The SAE op ``mod``'s forward entry point (fused_sae or
    fused_matryoshka_sae) on the card against its plain reference on the same
    inputs; bf16 launches repeat bitwise. Returns (x_cent, the plain outputs,
    max abs err of the reconstruction)."""
    fwd = mod.fused_sae_forward if mod is fused_sae else mod.fused_matryoshka_forward
    plain = (mod.fused_sae_forward_plain if mod is fused_sae
             else mod.fused_matryoshka_forward_plain)
    x, bd = ops[0], ops[4]
    out_k = fwd(*ops, *extra)
    out_p = plain(*ops, *extra)
    torch.cuda.synchronize()
    log(f"[kernels] {mod.fwd_kernel.name} [{tag}{label}] vs plain")
    if cd == torch.bfloat16:
        _repeatable(mod.fwd_kernel.name, mod.fwd_kernel(*ops, *extra),
                    mod.fwd_kernel(*ops, *extra))
    if not torch.equal(out_k[0], x - bd.to(cd)):
        raise AssertionError(f"{mod.fwd_kernel.name}: x_cent differs from x - round(b_dec)")
    # on _exact_inputs' grid the pre-activations are exact on both sides, so the
    # counts agree exactly; else a pre-activation within rounding of 0 may flip,
    # so counts get a tolerance of a few tokens
    count_tol = 0.0 if exact else 1e-3
    err = _check("recon", out_k[1], out_p[0], 1e-4, 1e-5)
    _check("act_count", out_k[2], out_p[1], 0.0, count_tol)
    _check("row_active", out_k[3], out_p[2], 0.0, count_tol)
    _check("l1_sum", out_k[4], out_p[3], 1e-5, 0.0)
    return out_k[0], out_p, err


def _sae_bwd_check(mod, tag: str, cd, ops, x_cent, err_in, coeffs, extra=(), label: str = ""):
    """The SAE op's backward entry point on x_cent against its plain reference on
    (x, b_dec); bf16 launches repeat bitwise. Returns (plain grads, max abs err)."""
    if mod is fused_sae:
        bwd, plain = mod.fused_sae_backward, mod.fused_sae_backward_plain
    else:
        bwd, plain = mod.fused_matryoshka_backward, mod.fused_matryoshka_backward_plain
    x, we, be, wd, bd = ops
    g_k = bwd(x_cent, we, be, wd, err_in, coeffs, *extra)
    g_p = plain(*ops, err_in, coeffs, *extra)
    torch.cuda.synchronize()
    log(f"[kernels] {mod.bwd_kernel.name} [{tag}{label}] vs plain")
    if cd == torch.bfloat16:
        _repeatable(mod.bwd_kernel.name, mod.bwd_kernel(x_cent, we, be, wd, err_in, coeffs, *extra),
                    mod.bwd_kernel(x_cent, we, be, wd, err_in, coeffs, *extra))
    err = max(_check(n, a, b, 1e-3, 1e-4)
              for n, a, b in zip(("dW_enc", "db_enc", "dW_dec", "db_dec"), g_k, g_p))
    return g_p, err


def kernels_relu(cd, tag: str) -> dict:
    # on _exact_inputs' grid: the tensor cores' sums of the encode run in another
    # order and rounding than cuBLAS's, and off the grid a pre-activation that
    # moved by a rounding flips round_bf16(post) by a bf16 ulp in the decode
    ops = _relu_exact_operands(cd)
    x, we, be, wd, bd = ops
    x_cent, out_p, err = _sae_fwd_check(fused_sae, tag, cd, ops, exact=True)
    xc = x - bd.to(cd)
    post = torch.relu(xc @ we).to(cd)
    rows = {"fused_sae_fwd": _measure(
        "fused_sae_fwd", tag, cd, lambda: fused_sae.fused_sae_forward(*ops),
        lambda: fused_sae.fused_sae_forward_plain(*ops),
        lambda: (xc @ we, post @ wd), 4.0 * T * C * H,
        nbytes(*ops) + nbytes(out_p[0], out_p[1], out_p[2]) + 4, err)}

    res = (out_p[0] - x.float()).to(cd)  # the residual the backward reads
    del out_p
    coeffs = torch.tensor([2.0 / (T * C), LAMBDA / (T * H)], device=DEVICE)
    g_p, err = _sae_bwd_check(fused_sae, tag, cd, ops, x_cent, res, coeffs)
    moved = nbytes(*ops, res, coeffs) + nbytes(*g_p)
    del g_p
    dr = (coeffs[0] * res.float()).to(cd)
    rows["fused_sae_bwd"] = _measure(
        "fused_sae_bwd", tag, cd,
        lambda: fused_sae.fused_sae_backward(x_cent, we, be, wd, res, coeffs),
        lambda: fused_sae.fused_sae_backward_plain(*ops, res, coeffs),
        lambda: (dr @ wd.T, xc.T @ post, post.T @ dr), 8.0 * T * C * H, moved, err)
    return rows


def kernels_gated(cd, tag: str) -> dict:
    gen = torch.Generator(device=DEVICE).manual_seed(0)
    params = init_gated_sae(gen, C, H // C)
    x, wg, bd = _exact_inputs(gen, T, params["W_gate"])
    x, wg, wd = x.to(cd), wg.to(cd), params["W_dec"].to(cd).contiguous()
    bg = _odd_grid(gen, H, 100)  # about ±0.05
    bm = _odd_grid(gen, H, 60)
    er = torch.exp(0.1 * torch.randn(H, device=DEVICE, generator=gen))
    ops = (x, wg, bg, bm, er, wd, bd)
    out_p, err = _act_fwd_check(fused_gated_sae, tag, cd, ops)
    rows = {"fused_gated_sae_fwd": _measure(
        "fused_gated_sae_fwd", tag, cd, lambda: fused_gated_sae.fwd_kernel(*ops),
        lambda: fused_gated_sae.fused_gated_forward_plain(*ops),
        _act_fwd_library(fused_gated_sae, ops), 6.0 * T * C * H,
        nbytes(*ops) + nbytes(*out_p[:4]) + 4, err)}

    del out_p
    bops = _gated_bwd_operands(ops, T, C, H)
    g_p, err = _act_bwd_check(fused_gated_sae, tag, cd, bops, GATED_GRADS)
    moved = nbytes(*bops) + nbytes(*g_p)
    del g_p
    rows["fused_gated_sae_bwd"] = _measure(
        "fused_gated_sae_bwd", tag, cd, lambda: fused_gated_sae.bwd_kernel(*bops),
        lambda: fused_gated_sae.backward_plain(*bops), _gated_bwd_library(bops),
        10.0 * T * C * H, moved, err)
    return rows


GATED_GRADS = ("dW_gate", "db_gate", "db_mag", "dr_mag", "dW_dec", "db_dec")
JUMPRELU_GRADS = ("dW_enc", "db_enc", "dtheta", "dW_dec", "db_dec")


def _act_fwd_check(mod, tag: str, cd, ops, repeats: int = 2, label: str = ""):
    """The forward of the JumpReLU or gated op ``mod`` against its plain version
    on the same inputs; in bf16 ``repeats`` launches must agree bitwise. The
    inputs lie on _exact_inputs' grid, so the pre-activations, and with them the
    mask or gate, the counts and relu(pi), agree exactly; the decodes (recon,
    and the gated op's via_gate) and the L1 sum add in other orders. Returns
    (plain outputs, max abs err of the decodes)."""
    name = mod.fwd_kernel.name
    out_k = mod.fwd_kernel(*ops)
    out_p = _act_fwd_plain(mod)(*ops)
    torch.cuda.synchronize()
    log(f"[kernels] {name} [{tag}{label}] vs plain")
    if cd == torch.bfloat16:
        for _ in range(repeats - 1):
            _repeatable(name, out_k, mod.fwd_kernel(*ops))
        if repeats > 2:
            log(f"[kernels]   {name}: {repeats} launches bitwise equal")
    n = len(out_p) - 3  # the decodes come first
    err = max(_check(k, a, b, 1e-4, 1e-5)
              for k, a, b in zip(("recon", "via_gate")[:n], out_k, out_p))
    _check("act_count", out_k[n], out_p[n], 0.0, 0.0)
    _check("row_active", out_k[n + 1], out_p[n + 1], 0.0, 0.0)
    _check("l1_sum", out_k[n + 2], out_p[n + 2], 1e-5, 0.0)
    return out_p, err


def _act_fwd_plain(mod):
    """The forward's plain version of the JumpReLU or gated op ``mod``."""
    return (mod.fused_gated_forward_plain if mod is fused_gated_sae
            else mod.fused_jumprelu_forward_plain)


def _act_fwd_library(mod, ops):
    """The stock path's cuBLAS products of the JumpReLU forward (encode and
    decode) or the gated one (encode and two decodes), as one call."""
    x, w, wd, bd = ops[0], ops[1], ops[-2], ops[-1]
    xc = x - bd.to(x.dtype)
    post = torch.relu(xc @ w).to(x.dtype)  # a [T, H] operand of the stock path's shapes
    if mod is fused_gated_sae:
        return lambda: (xc @ w, post @ wd, post @ wd)
    return lambda: (xc @ w, post @ wd)


def _act_bwd_check(mod, tag: str, cd, bops, names, repeats: int = 2, label: str = ""):
    """The backward of the JumpReLU or gated op ``mod`` against the plain
    version of its route (backward_plain: in bf16 centre, pre-pass and the coder
    body's epilogue); in bf16 ``repeats`` launches must agree bitwise. Returns
    (plain grads, max abs err)."""
    name = mod.bwd_kernel.name
    g_k = mod.bwd_kernel(*bops)
    g_p = mod.backward_plain(*bops)
    torch.cuda.synchronize()
    log(f"[kernels] {name} [{tag}{label}] vs plain")
    if cd == torch.bfloat16:
        for _ in range(repeats - 1):
            _repeatable(name, g_k, mod.bwd_kernel(*bops))
        if repeats > 2:
            log(f"[kernels]   {name}: {repeats} launches bitwise equal")
    err = max(_check(n, a, b, 1e-3, 1e-4) for n, a, b in zip(names, g_k, g_p))
    if mod is fused_jumprelu_sae:
        n_win = int((g_p[2] != 0).sum())
        log(f"[kernels]   dtheta non-zero for {n_win} of {g_p[2].numel()} latents")
        if n_win == 0:
            raise AssertionError("no pre-activation fell in the STE window")
    return g_p, err


def _gated_bwd_operands(ops, t: int, c: int, h: int):
    """The gated backward's operands after its forward's plain version: the f32
    residuals of recon and via_gate, and (c_rec, c_l1, c_aux)."""
    x = ops[0]
    recon, via = fused_gated_sae.fused_gated_forward_plain(*ops)[:2]
    coeffs = torch.tensor([2.0 / (t * c), LAMBDA / (t * h), 2.0 / (t * c)], device=DEVICE)
    return ops + (recon - x.float(), via - x.float(), coeffs)


def _gated_bwd_library(bops):
    """The stock path's four cuBLAS products of the gated backward, as one call."""
    x, wg, _, _, _, wd, bd, err_rec, err_via, coeffs = bops
    cd = x.dtype
    xc = x - bd.to(cd)
    enc = torch.relu(xc @ wg).to(cd)  # a [T, H] operand of the stock path's shapes
    dr = (coeffs[0] * err_rec).to(cd)
    dv = (coeffs[2] * err_via).to(cd)
    return lambda: (dr @ wd.T, dv @ wd.T, xc.T @ enc, enc.T @ dr)


def _jumprelu_bwd_library(bops):
    """The stock path's three cuBLAS products of the JumpReLU backward."""
    x, we, _, _, wd, bd, res, coeffs, _ = bops
    cd = x.dtype
    xc = x - bd.to(cd)
    post = torch.relu(xc @ we).to(cd)
    dr = (coeffs[0] * res).to(cd)
    return lambda: (dr @ wd.T, xc.T @ post, post.T @ dr)


def kernels_jumprelu(cd, tag: str) -> dict:
    gen = torch.Generator(device=DEVICE).manual_seed(0)
    params = init_jumprelu_sae(gen, C, H // C)
    x, we, bd = _exact_inputs(gen, T, params["W_enc"])
    x, we, wd = x.to(cd), we.to(cd), params["W_dec"].to(cd).contiguous()
    be = _odd_grid(gen, H, 100)
    thr = 0.5 + torch.rand(H, device=DEVICE, generator=gen)  # pre has std ~2 here
    ops = (x, we, be, thr, wd, bd)
    out_p, err = _act_fwd_check(fused_jumprelu_sae, tag, cd, ops)
    rows = {"fused_jumprelu_sae_fwd": _measure(
        "fused_jumprelu_sae_fwd", tag, cd, lambda: fused_jumprelu_sae.fwd_kernel(*ops),
        lambda: fused_jumprelu_sae.fused_jumprelu_forward_plain(*ops),
        _act_fwd_library(fused_jumprelu_sae, ops), 4.0 * T * C * H,
        nbytes(*ops) + nbytes(*out_p[:3]) + 4, err)}

    del out_p
    bops = _jumprelu_bwd_operands(ops, T, C)
    g_p, err = _act_bwd_check(fused_jumprelu_sae, tag, cd, bops, JUMPRELU_GRADS)
    moved = nbytes(*bops[:-1]) + nbytes(*g_p)
    del g_p
    rows["fused_jumprelu_sae_bwd"] = _measure(
        "fused_jumprelu_sae_bwd", tag, cd, lambda: fused_jumprelu_sae.bwd_kernel(*bops),
        lambda: fused_jumprelu_sae.backward_plain(*bops), _jumprelu_bwd_library(bops),
        8.0 * T * C * H, moved, err)
    return rows


def _jumprelu_bwd_operands(ops, t: int, c: int):
    """The JumpReLU backward's operands after its forward's plain version: the
    f32 residual, (c_rec, c_l0) and the STE bandwidth."""
    res = fused_jumprelu_sae.fused_jumprelu_forward_plain(*ops)[0] - ops[0].float()
    return ops + (res, torch.tensor([2.0 / (t * c), LAMBDA_J / t], device=DEVICE), BANDWIDTH)


def _relu_exact_operands(cd):
    """ReLU-layout operands at the training shape on _exact_inputs' grid, b_enc
    odd multiples of 2^-11: the kernel and cuBLAS get the same pre-activations,
    so the ReLU mask, which the dx kernels' sums over latents jump with, is the
    same on both sides."""
    gen = torch.Generator(device=DEVICE).manual_seed(0)
    params = init_sae_mlp(gen, C, H // C)
    x, we, bd = _exact_inputs(gen, T, params["W_enc"])
    be = _odd_grid(gen, H, 100)
    return x.to(cd), we.to(cd), be, params["W_dec"].to(cd).contiguous(), bd


def _dx_check(mod, tag: str, cd, dops, repeats: int = 2, label: str = ""):
    """The dx entry point of the SAE op ``mod`` (fused_sae or
    fused_matryoshka_sae) on (x_cent, W_enc, b_enc, W_dec, err or S, coeffs[,
    boundaries]) against its plain version; in bf16 ``repeats`` launches must
    agree bitwise. Returns (plain dx, max abs err)."""
    kern = mod.dx_kernel
    plain = mod.fused_sae_dx_plain if mod is fused_sae else mod.fused_matryoshka_dx_plain
    dx_k = kern(*dops)
    dx_p = plain(*dops)
    torch.cuda.synchronize()
    log(f"[kernels] {kern.name} [{tag}{label}] vs plain")
    if cd == torch.bfloat16:
        for _ in range(repeats - 1):
            _repeatable(kern.name, (dx_k,), (kern(*dops),))
        if repeats > 2:
            log(f"[kernels]   {kern.name}: {repeats} launches bitwise equal")
    if not bool(torch.isfinite(dx_k).all()):
        raise AssertionError(f"{kern.name}: non-finite dx")
    return dx_p, _check("dx", dx_k, dx_p, 1e-3, 1e-4)


def _dx_library(x_cent, we, wd, dr):
    """The stock path's three cuBLAS products of dx (encode, dpost, the product
    with W_enc^T), as one call; dr is the rounded cotangent of level 0."""
    post = torch.relu(x_cent @ we)  # a [T, H] operand of the stock path's shapes
    return lambda: (x_cent @ we, dr @ wd.T, post @ we.T)


def kernels_relu_dx(cd, tag: str) -> dict:
    ops = _relu_exact_operands(cd)
    x, we, be, wd, bd = ops
    res = (fused_sae.fused_sae_forward_plain(*ops)[0] - x.float()).to(cd)
    coeffs = torch.tensor([2.0 / (T * C), LAMBDA / (T * H)], device=DEVICE)
    dops = (x - bd.to(cd), we, be, wd, res, coeffs)  # x_cent, as the forward saves it
    dx_p, err = _dx_check(fused_sae, tag, cd, dops)
    dr = (coeffs[0] * res.float()).to(cd)
    return {"fused_sae_dx": _measure(
        "fused_sae_dx", tag, cd, lambda: fused_sae.dx_kernel(*dops),
        lambda: fused_sae.fused_sae_dx_plain(*dops), _dx_library(dops[0], we, wd, dr),
        6.0 * T * C * H, nbytes(*dops) + nbytes(dx_p), err)}


def _suffix_error(prefix_recon, x, cd):
    """The suffix-weighted error S of the prefix mean's cotangents, 1/P each."""
    n, t, c = prefix_recon.shape
    weighted = (2.0 / (n * t * c)) * (prefix_recon - x.float()[None])
    return weighted.flip(0).cumsum(0).flip(0).to(cd)


def kernels_matryoshka(cd, tag: str) -> dict:
    fm = fused_matryoshka_sae
    ops = _relu_exact_operands(cd)
    x, we, _, wd, bd = ops
    bounds = matryoshka_prefix_counts(H, DEFAULT_MATRYOSHKA_PREFIXES)
    x_cent, out_p, err = _sae_fwd_check(fm, tag, cd, ops, (bounds,), exact=True,
                                        label=f", prefixes end at {bounds}")
    xc = x - bd.to(cd)
    post = torch.relu(xc @ we).to(cd)
    rows = {"fused_matryoshka_sae_fwd": _measure(
        "fused_matryoshka_sae_fwd", tag, cd, lambda: fm.fused_matryoshka_forward(*ops, bounds),
        lambda: fm.fused_matryoshka_forward_plain(*ops, bounds),
        lambda: (xc @ we, *(post[:, :m] @ wd[:m] for m in bounds)), 4.0 * T * C * H,
        nbytes(*ops) + nbytes(*out_p[:3]) + 4, err)}

    s = _suffix_error(out_p[0], x, cd)
    del out_p
    coeffs = torch.tensor([1.0, LAMBDA / (T * H)], device=DEVICE)
    g_p, err = _sae_bwd_check(fm, tag, cd, ops, x_cent, s, coeffs, (bounds,))
    moved = nbytes(*ops, s, coeffs) + nbytes(*g_p)
    del g_p
    dr = s[0]
    rows["fused_matryoshka_sae_bwd"] = _measure(
        "fused_matryoshka_sae_bwd", tag, cd,
        lambda: fm.fused_matryoshka_backward(x_cent, we, *ops[2:4], s, coeffs, bounds),
        lambda: fm.fused_matryoshka_backward_plain(*ops, s, coeffs, bounds),
        lambda: (xc @ we, dr @ wd.T, xc.T @ post, post.T @ dr), 8.0 * T * C * H, moved, err)

    bops = (x_cent, we, ops[2], wd, s, coeffs, bounds)
    dx_p, err = _dx_check(fm, tag, cd, bops)
    rows["fused_matryoshka_sae_dx"] = _measure(
        "fused_matryoshka_sae_dx", tag, cd, lambda: fm.dx_kernel(*bops),
        lambda: fm.fused_matryoshka_dx_plain(*bops), _dx_library(x_cent, we, wd, dr),
        6.0 * T * C * H, nbytes(*bops[:-1]) + nbytes(dx_p), err)
    return rows


# the ReLU and Matryoshka ops at other widths: mixed3b's 480 (the register-held
# bf16 forward) and mixed4e's 832 (the in-place one)
W_T, W_H, W_WIDTHS, W_BOUNDS = 8192, 4096, (480, 832), (1024, 2048, 4096)
REPEATS = 20  # bitwise-equal launches of the in-place bf16 forward at C = 832
# the JumpReLU and gated ops' ragged shape: T = 2*512 + 128, H = 640, C = 2*64 + 8
RAGGED_T, RAGGED_H, RAGGED_C = 1152, 640, 136


def kernels_sae_widths(cd, tag: str) -> dict:
    """Both SAE ops at C = 480 and 832 (T = 8,192, H = 4,096, prefixes 1,024 /
    2,048 / 4,096) on _exact_inputs' grid against their plain references, and a
    Matryoshka backward whose levels' errors differ, with prefixes 128 / 1,024 /
    4,096: two level-0 blocks must sum all 16 steps' direct db_dec rows from
    S_0; the dx entry points of both (above C = 256 the dx route of the
    in-place coder_fwd_tc), the Matryoshka one on both sets of levels. In bf16,
    REPEATS launches of the C = 832 forward (coder_fwd_tc) and of the ReLU dx
    there must agree bitwise, and each op is timed. No rows: the kernels line
    keeps the main path's."""
    fm = fused_matryoshka_sae
    for c in W_WIDTHS:
        gen = torch.Generator(device=DEVICE).manual_seed(c)
        w = torch.randn(c, W_H, device=DEVICE, generator=gen) / c ** 0.5
        x, we, bd = _exact_inputs(gen, W_T, w)
        wd = _dyadic(torch.randn(W_H, c, device=DEVICE, generator=gen) / W_H ** 0.5, 2.0 ** -8)
        ops = (x.to(cd), we.to(cd), _odd_grid(gen, W_H, 100), wd.to(cd), bd)
        label = f", C={c} T={W_T} H={W_H}"
        x_cent, out_p, _ = _sae_fwd_check(fused_sae, tag, cd, ops, exact=True, label=label)
        res = (out_p[0] - ops[0].float()).to(cd)
        coeffs = torch.tensor([2.0 / (W_T * c), LAMBDA / (W_T * W_H)], device=DEVICE)
        _sae_bwd_check(fused_sae, tag, cd, ops, x_cent, res, coeffs, label=label)
        if cd == torch.bfloat16 and c > 512:
            first = fused_sae.fwd_kernel(*ops)
            for _ in range(REPEATS - 1):
                _repeatable(fused_sae.fwd_kernel.name, first, fused_sae.fwd_kernel(*ops))
            log(f"[kernels]   {fused_sae.fwd_kernel.name}: {REPEATS} launches of the in-place "
                f"forward at C={c} bitwise equal")

        _, m_out, _ = _sae_fwd_check(fm, tag, cd, ops, (W_BOUNDS,), exact=True, label=label)
        s = _suffix_error(m_out[0], ops[0], cd)
        m_coeffs = torch.tensor([1.0, LAMBDA / (W_T * W_H)], device=DEVICE)
        _sae_bwd_check(fm, tag, cd, ops, x_cent, s, m_coeffs, (W_BOUNDS,), label=label)
        # levels whose errors differ by orders of magnitude, few level-0 blocks;
        # S and W_dec on dyadic grids, so that dpost = S @ W_dec^T is exact on
        # both sides and round_bf16(dpre) cannot flip
        lv = (128, W_H // 4, W_H)
        s_diff = torch.stack([
            _dyadic(torch.randn(W_T, c, device=DEVICE, generator=gen) * 2.0 ** e, 2.0 ** (e - 4))
            for e in (-13, -17, -20)]).to(cd)
        _sae_bwd_check(fm, tag, cd, ops, x_cent, s_diff, m_coeffs, (lv,),
                       label=f"{label}, levels {lv} with differing errors")
        dops = (x_cent, *ops[1:4], res, coeffs)
        _dx_check(fused_sae, tag, cd, dops, REPEATS if c > 512 else 2, label)
        mops = (x_cent, *ops[1:4], s, m_coeffs, W_BOUNDS)
        _dx_check(fm, tag, cd, mops, label=label)
        _dx_check(fm, tag, cd, (x_cent, *ops[1:4], s_diff, m_coeffs, lv),
                  label=f"{label}, levels {lv} with differing errors")
        if cd == torch.bfloat16:
            xc = x_cent
            post = torch.relu(xc @ ops[1]).to(cd)
            dr = (coeffs[0] * res.float()).to(cd)
            fl = 4.0 * W_T * c * W_H
            for name, kern, plain, lib, flops in (
                    ("fused_sae_fwd", lambda: fused_sae.fused_sae_forward(*ops),
                     lambda: fused_sae.fused_sae_forward_plain(*ops),
                     lambda: (xc @ ops[1], post @ ops[3]), fl),
                    ("fused_sae_bwd",
                     lambda: fused_sae.fused_sae_backward(x_cent, *ops[1:4], res, coeffs),
                     lambda: fused_sae.fused_sae_backward_plain(*ops, res, coeffs),
                     lambda: (dr @ ops[3].T, xc.T @ post, post.T @ dr), 2 * fl),
                    ("fused_matryoshka_sae_fwd",
                     lambda: fm.fused_matryoshka_forward(*ops, W_BOUNDS),
                     lambda: fm.fused_matryoshka_forward_plain(*ops, W_BOUNDS),
                     lambda: (xc @ ops[1], *(post[:, :m] @ ops[3][:m] for m in W_BOUNDS)), fl),
                    ("fused_matryoshka_sae_bwd",
                     lambda: fm.fused_matryoshka_backward(x_cent, *ops[1:4], s, m_coeffs,
                                                          W_BOUNDS),
                     lambda: fm.fused_matryoshka_backward_plain(*ops, s, m_coeffs, W_BOUNDS),
                     lambda: (xc @ ops[1], s[0] @ ops[3].T, xc.T @ post, post.T @ s[0]),
                     2 * fl),
                    ("fused_sae_dx", lambda: fused_sae.dx_kernel(*dops),
                     lambda: fused_sae.fused_sae_dx_plain(*dops),
                     _dx_library(xc, ops[1], ops[3], dr), 1.5 * fl),
                    ("fused_matryoshka_sae_dx", lambda: fm.dx_kernel(*mops),
                     lambda: fm.fused_matryoshka_dx_plain(*mops),
                     _dx_library(xc, ops[1], ops[3], s[0]), 1.5 * fl)):
                _measure(name, f"{tag}, C={c} T={W_T} H={W_H}", cd, kern, plain, lib, flops,
                         0, 0.0)
        torch.cuda.empty_cache()
    return {}


def kernels_act_widths(cd, tag: str) -> dict:
    """The JumpReLU and gated forwards and backwards on _exact_inputs' grid
    against the plain versions of their routes, the backwards' errors from the
    forwards' plain versions: first at the ragged shape (RAGGED_*: a partial
    token step and channel chunk; in bf16 the forwards' register-held bodies,
    the gated one with recon and via_gate held together), then at C = 480 (bf16:
    the held 512-column bodies, the gated forward's two launches) and 832 (bf16:
    the in-place bodies) with T = 8,192, H = 4,096, where each is timed. In f32
    every shape runs the SIMT bodies (the gated forward in two launches). In
    bf16 REPEATS launches of each at C = 832 must agree bitwise. No rows: the
    kernels line keeps the main path's."""
    for t, h, c in ((RAGGED_T, RAGGED_H, RAGGED_C),) + tuple((W_T, W_H, c) for c in W_WIDTHS):
        gen = torch.Generator(device=DEVICE).manual_seed(c)
        w = torch.randn(c, h, device=DEVICE, generator=gen) / c ** 0.5
        x, we, bd = _exact_inputs(gen, t, w)
        x, we = x.to(cd), we.to(cd)
        wd = (torch.randn(h, c, device=DEVICE, generator=gen) / h ** 0.5).to(cd)
        label = f", C={c} T={t} H={h}"
        repeats = REPEATS if c > 512 else 2
        thr = 0.5 + torch.rand(h, device=DEVICE, generator=gen)  # pre has std ~2 here
        jf = (x, we, _odd_grid(gen, h, 100), thr, wd, bd)
        jp, _ = _act_fwd_check(fused_jumprelu_sae, tag, cd, jf, repeats, label)
        jops = _jumprelu_bwd_operands(jf, t, c)
        _act_bwd_check(fused_jumprelu_sae, tag, cd, jops, JUMPRELU_GRADS, repeats, label)
        er = torch.exp(0.1 * torch.randn(h, device=DEVICE, generator=gen))
        gf = (x, we, _odd_grid(gen, h, 100), _odd_grid(gen, h, 60), er, wd, bd)
        gp, _ = _act_fwd_check(fused_gated_sae, tag, cd, gf, repeats, label)
        gops = _gated_bwd_operands(gf, t, c, h)
        _act_bwd_check(fused_gated_sae, tag, cd, gops, GATED_GRADS, repeats, label)
        if t == W_T:
            fl = 2.0 * t * c * h
            for mod, fops, out_p, flops in ((fused_jumprelu_sae, jf, jp, 2 * fl),
                                            (fused_gated_sae, gf, gp, 3 * fl)):
                _measure(mod.fwd_kernel.name, f"{tag}{label}", cd,
                         lambda: mod.fwd_kernel(*fops), lambda: _act_fwd_plain(mod)(*fops),
                         _act_fwd_library(mod, fops), flops,
                         nbytes(*fops) + nbytes(*out_p[:-1]) + 4, 0.0)
            for mod, bops, lib, flops in (
                    (fused_jumprelu_sae, jops, _jumprelu_bwd_library(jops), 4 * fl),
                    (fused_gated_sae, gops, _gated_bwd_library(gops), 5 * fl)):
                _measure(mod.bwd_kernel.name, f"{tag}{label}", cd,
                         lambda: mod.bwd_kernel(*bops), lambda: mod.backward_plain(*bops), lib,
                         flops, 0, 0.0)
        del jp, gp, jops, gops
        torch.cuda.empty_cache()
    return {}


def _coder_operands(gen, t: int, c_in: int, c_out: int, h: int, cd):
    """Operands of the transcoder/crosscoder kernels: x and W_enc on
    _exact_inputs' grid (x in quarters, W_enc in 1/256ths, sums of at most a few
    thousand products: exact in f32), b_enc odd multiples of 2^-11, so the
    kernel and cuBLAS get the same pre-activations and switch the same latents
    on; W_dec and b_dec plain random."""
    x = _dyadic(torch.relu(torch.randn(t, c_in, device=DEVICE, generator=gen)) * 2.0, 0.25)
    we = _dyadic(torch.randn(c_in, h, device=DEVICE, generator=gen) / c_in ** 0.5, 2.0 ** -8)
    be = _odd_grid(gen, h, 100)
    wd = torch.randn(h, c_out, device=DEVICE, generator=gen) / h ** 0.5
    bd = 0.1 * torch.randn(c_out, device=DEVICE, generator=gen)
    return x.to(cd), we.to(cd), be, wd.to(cd), bd


def _kernels_coder(mod, tag: str, cd, t: int, c_in: int, c_out: int, h: int,
                   bwd_extra, timed: bool = True) -> dict:
    """The fused transcoder or crosscoder kernel pair (``mod``) against its plain
    versions at [t, c_in] -> [t, c_out] with h latents. ``bwd_extra(gen)`` gives
    the backward's coefficient arguments, c_rec first. bf16 kernels launch twice
    and must agree bitwise. ``timed`` false: checks only, no rows."""
    gen = torch.Generator(device=DEVICE).manual_seed(0)
    x, we, be, wd, _ = ops = _coder_operands(gen, t, c_in, c_out, h, cd)
    if mod is fused_transcoder:
        plain_fwd, plain_bwd = (mod.fused_transcoder_forward_plain,
                                mod.fused_transcoder_backward_plain)
    else:
        plain_fwd, plain_bwd = (mod.fused_crosscoder_forward_plain,
                                mod.fused_crosscoder_backward_plain)
    name = mod.fwd_kernel.name
    out_k = mod.fwd_kernel(*ops)
    out_p = plain_fwd(*ops)
    torch.cuda.synchronize()
    log(f"[kernels] {name} [{tag}] vs plain, T={t} C_in={c_in} C_out={c_out} H={h}")
    if cd == torch.bfloat16:
        _repeatable(name, out_k, mod.fwd_kernel(*ops))
    # pre-activations are exact on both sides, so the counts agree exactly; the
    # decode and the sums of post run in other orders
    err = _check("recon", out_k[0], out_p[0], 1e-4, 1e-5)
    _check("act_count", out_k[1], out_p[1], 0.0, 0.0)
    _check("row_active", out_k[2], out_p[2], 0.0, 0.0)
    _check("zsum" if mod is fused_crosscoder else "l1_sum", out_k[3], out_p[3], 1e-5, 1e-7)
    del out_k
    post = torch.relu(x @ we).to(cd) if timed else None  # a [T, H] operand of the stock path
    rows = {name: _measure(
        name, tag, cd, lambda: mod.fwd_kernel(*ops), lambda: plain_fwd(*ops),
        lambda: (x @ we, post @ wd), 2.0 * t * h * (c_in + c_out),
        nbytes(*ops) + nbytes(*out_p), err)} if timed else {}

    y = torch.randn(t, c_out, device=DEVICE, generator=gen)
    res = (out_p[0] - y).to(cd)  # the residual the backward reads
    del out_p, y
    bops = (x, we, be, wd, res) + bwd_extra(gen)
    name = mod.bwd_kernel.name
    g_k = mod.bwd_kernel(*bops)
    g_p = plain_bwd(*bops)
    torch.cuda.synchronize()
    log(f"[kernels] {name} [{tag}] vs plain")
    if cd == torch.bfloat16:
        _repeatable(name, g_k, mod.bwd_kernel(*bops))
    err = max(_check(n, a, b, 1e-3, 1e-4)
              for n, a, b in zip(("dW_enc", "db_enc", "dW_dec", "db_dec"), g_k, g_p))
    moved = nbytes(*bops) + nbytes(*g_p)
    del g_k, g_p
    if not timed:
        return rows
    dr = (bops[5][0] * res.float()).to(cd)
    rows[name] = _measure(
        name, tag, cd, lambda: mod.bwd_kernel(*bops), lambda: plain_bwd(*bops),
        lambda: (dr @ wd.T, x.T @ post, post.T @ dr), 4.0 * t * h * (c_in + c_out), moved, err)
    return rows


def _repeatable(name: str, first, second) -> None:
    """Two launches on the same inputs must give bitwise-equal outputs."""
    torch.cuda.synchronize()
    if not all(torch.equal(a, b) for a, b in zip(first, second)):
        raise AssertionError(f"{name}: two launches on the same inputs differ")
    log(f"[kernels]   {name}: a repeat launch is bitwise equal")


def kernels_transcoder(cd, tag: str) -> dict:
    def coeffs(gen):
        return (torch.tensor([2.0 / (TC_T * TC_COUT), LAMBDA / (TC_T * TC_H)], device=DEVICE),)

    return _kernels_coder(fused_transcoder, tag, cd, TC_T, TC_CIN, TC_COUT, TC_H, coeffs)


def kernels_coder_ragged(cd, tag: str) -> dict:
    """Both coder ops at small shapes with a partial chunk at every edge of the
    kernels' tiling (T = 2*512 + 128 tokens, H = 512 + 128 latents, C_in = 4*64 + 8
    channels; C_out = 128 + 8, where the bf16 forward holds recon in registers,
    and 4*128 + 8, where it updates recon in place), checked against the plain
    versions; no rows."""
    t, c_in, h = 1152, 264, 640
    for c_out in (136, 520):
        def tc_coeffs(gen):
            return (torch.tensor([2.0 / (t * c_out), LAMBDA / (t * h)], device=DEVICE),)

        def cc_coeffs(gen):
            n_j = 0.5 + torch.rand(h, device=DEVICE, generator=gen)
            return torch.tensor([2.0 / (t * c_out)], device=DEVICE), n_j * (LAMBDA / (t * h))

        _kernels_coder(fused_transcoder, tag, cd, t, c_in, c_out, h, tc_coeffs, timed=False)
        _kernels_coder(fused_crosscoder, tag, cd, t, c_in, c_out, h, cc_coeffs, timed=False)
    return {}


def kernels_crosscoder(cd, tag: str) -> dict:
    csum = sum(CC_DIMS)

    def coeffs(gen):
        # the L1 cotangent n_j·λ/(T·H), with decoder-norm weights n_j around 1
        n_j = 0.5 + torch.rand(CC_H, device=DEVICE, generator=gen)
        return (torch.tensor([2.0 / (CC_T * csum)], device=DEVICE),
                n_j * (LAMBDA / (CC_T * CC_H)))

    return _kernels_coder(fused_crosscoder, tag, cd, CC_T, csum, csum, CC_H, coeffs)


def phase_kernels() -> dict:
    """Every kernel against its plain version in f32 and bf16; returns the bf16
    (main path) rows."""
    set_tf32(False)  # the plain versions' f32 products in full f32
    rows = {}
    for cd, tag in ((torch.float32, "f32"), (torch.bfloat16, "bf16")):
        for fn in (kernels_relu, kernels_relu_dx, kernels_gated, kernels_jumprelu,
                   kernels_matryoshka, kernels_sae_widths, kernels_act_widths,
                   kernels_coder_ragged, kernels_transcoder, kernels_crosscoder):
            with torch.no_grad():
                r = fn(cd, tag)
            torch.cuda.empty_cache()  # the plain versions' [T, H] temporaries
            if cd == torch.bfloat16:
                rows.update(r)
    return rows


# ---------------------------------------------------------------------------
# parity phase
# ---------------------------------------------------------------------------

def _parity(name: str, params: dict, fused_fn, stock_fn, keys: tuple) -> None:
    def grads(loss_fn):
        p = {k: v.clone().requires_grad_(True) for k, v in params.items()}
        out = loss_fn(p)
        g = torch.autograd.grad(out["loss"], list(p.values()))
        return out, dict(zip(p, g))

    out_f, g_f = grads(fused_fn)
    out_s, g_s = grads(stock_fn)
    for k in keys:
        a, b = float(out_f[k].detach()), float(out_s[k].detach())
        if not math.isclose(a, b, rel_tol=1e-4):
            raise AssertionError(f"parity {name} {k}: fused {a} vs stock {b}")
    for k in params:
        err = (g_f[k] - g_s[k]).abs().max().item()
        scale = g_s[k].abs().max().item()
        log(f"[parity] {name} grad {k}: max_abs_err {err:.3e} (max|ref| {scale:.3e})")
        if err > 1e-4 * scale + 1e-7 or scale == 0.0:
            raise AssertionError(f"parity {name} grad {k}: max abs err {err:.3e} "
                                 f"(max|ref| {scale:.3e})")
    log(f"[parity] {name}: fused op == stock autograd path (f32): ok")


def _parity_dx(name: str, kernel, x, fused_fn, stock_fn) -> None:
    """The input gradient of a fused op with compute_dx=True (one launch of its
    dx kernel) against the stock autograd path's."""
    def xgrad(loss_fn):
        xx = x.clone().requires_grad_(True)
        return torch.autograd.grad(loss_fn(xx)["loss"], [xx])[0]

    before = kernel.launches
    g_f = xgrad(fused_fn)
    if kernel.launches != before + 1:
        raise AssertionError(f"parity {name} dx: {kernel.name} was not launched")
    g_s = xgrad(stock_fn)
    err = (g_f - g_s).abs().max().item()
    scale = g_s.abs().max().item()
    log(f"[parity] {name} grad x: max_abs_err {err:.3e} (max|ref| {scale:.3e})")
    if err > 1e-4 * scale + 1e-7 or scale == 0.0:
        raise AssertionError(f"parity {name} grad x: max abs err {err:.3e} "
                             f"(max|ref| {scale:.3e})")
    log(f"[parity] {name}: compute_dx=True x gradient == stock autograd path (f32): ok")


def phase_parity() -> None:
    """Each fused op (kernels + autograd.Function) against the stock autograd path
    on the card: loss terms and every parameter gradient, f32, small shape; for
    the sae_mlp and Matryoshka ops also the input gradient (compute_dx=True).
    The gated, JumpReLU and Matryoshka inputs, and those of the input-gradient
    checks, lie on _exact_inputs' grid, so both paths switch the same latents
    on."""
    set_tf32(False)
    base = ("loss", "rec_loss", "l1_loss", "nrmse_loss", "rmse_loss")
    f32 = torch.float32

    gen = torch.Generator(device=DEVICE).manual_seed(1)
    params = init_sae_mlp(gen, C, 4)
    params["b_enc"] = params["b_enc"] - 0.05
    x = torch.randn(512, C, device=DEVICE, generator=gen)
    _parity("sae_mlp", params,
            lambda p: fused_sae.fused_sae_loss_terms(p, x, LAMBDA, 4, compute_dtype=f32),
            lambda p: sae_inference_and_loss("sae_mlp", p, x, LAMBDA), base)

    gen = torch.Generator(device=DEVICE).manual_seed(2)
    params = init_gated_sae(gen, C, 4)  # r_mag = 0: both paths' magnitude products exact
    x, params["W_gate"], params["b_dec"] = _exact_inputs(gen, 512, params["W_gate"])
    params["b_gate"] = _odd_grid(gen, 4 * C, 100)
    params["b_mag"] = _odd_grid(gen, 4 * C, 60)
    _parity("gated_sae", params,
            lambda p: fused_gated_sae.fused_gated_sae_loss_terms(p, x, LAMBDA, 4,
                                                                 compute_dtype=f32),
            lambda p: sae_inference_and_loss("gated_sae", p, x, LAMBDA), base + ("aux_loss",))

    gen = torch.Generator(device=DEVICE).manual_seed(3)
    params = init_jumprelu_sae(gen, C, 4, threshold_init=0.5)
    x, params["W_enc"], params["b_dec"] = _exact_inputs(gen, 512, params["W_enc"])
    params["b_enc"] = _odd_grid(gen, 4 * C, 100)
    params["log_threshold"] = params["log_threshold"] + 0.5 * torch.rand(
        4 * C, device=DEVICE, generator=gen)
    _parity("jumprelu_sae", params,
            lambda p: fused_jumprelu_sae.fused_jumprelu_sae_loss_terms(
                p, x, LAMBDA_J, 4, compute_dtype=f32, bandwidth=BANDWIDTH),
            lambda p: sae_inference_and_loss("jumprelu_sae", p, x, LAMBDA_J,
                                             jumprelu_bandwidth=BANDWIDTH),
            base + ("l0_loss",))

    # 2,048 latents: the default prefixes then end at multiples of 128
    gen = torch.Generator(device=DEVICE).manual_seed(4)
    params = init_sae_mlp(gen, C, 8)
    x, params["W_enc"], params["b_dec"] = _exact_inputs(gen, 512, params["W_enc"])
    params["b_enc"] = _odd_grid(gen, 8 * C, 100)
    bounds = matryoshka_prefix_counts(8 * C, DEFAULT_MATRYOSHKA_PREFIXES)
    got = fused_matryoshka_sae.fused_matryoshka_sae(params, x, bounds,
                                                    compute_dtype=f32)["prefix_losses"]
    want = torch.stack([(r - x).square().mean()
                        for r in matryoshka_sae_apply(params, x, bounds)[3]])
    log(f"[parity] matryoshka_sae prefix_losses {got.tolist()} vs stock {want.tolist()}")
    if not torch.allclose(got, want, rtol=1e-5, atol=0.0):
        raise AssertionError("parity matryoshka_sae prefix_losses")
    _parity("matryoshka_sae", params,
            lambda p: fused_matryoshka_sae.fused_matryoshka_sae_loss_terms(
                p, x, LAMBDA, 8, compute_dtype=f32),
            lambda p: sae_inference_and_loss("matryoshka_sae", p, x, LAMBDA),
            base + ("aux_loss",))
    _parity_dx("matryoshka_sae", fused_matryoshka_sae.dx_kernel, x,
               lambda xx: fused_matryoshka_sae.fused_matryoshka_sae_loss_terms(
                   params, xx, LAMBDA, 8, compute_dtype=f32, compute_dx=True),
               lambda xx: sae_inference_and_loss("matryoshka_sae", params, xx, LAMBDA))
    # the same params: sae_mlp has the Matryoshka SAE's layout
    _parity_dx("sae_mlp", fused_sae.dx_kernel, x,
               lambda xx: fused_sae.fused_sae_loss_terms(params, xx, LAMBDA, 8,
                                                         compute_dtype=f32, compute_dx=True),
               lambda xx: sae_inference_and_loss("sae_mlp", params, xx, LAMBDA))

    # the transcoder at its real widths, 1,024 latents; the target y is random
    gen = torch.Generator(device=DEVICE).manual_seed(5)
    params = init_transcoder(gen, TC_CIN, 4, TC_COUT)
    x, params["W_enc"], _ = _exact_inputs(gen, 512, params["W_enc"])
    params["b_enc"] = _odd_grid(gen, 4 * TC_CIN, 100)
    params["b_dec"] = 0.1 * torch.randn(TC_COUT, device=DEVICE, generator=gen)
    y = torch.randn(512, TC_COUT, device=DEVICE, generator=gen)
    _parity("transcoder", params,
            lambda p: fused_transcoder.fused_transcoder_loss_terms(p, x, y, LAMBDA, 4,
                                                                   compute_dtype=f32),
            lambda p: transcoder_inference_and_loss(p, x, y, LAMBDA), base)

    # the crosscoder with ΣC = 176, not a multiple of the kernels' 32- and
    # 128-channel chunks, and 640 latents; the loss's decoder-norm weights n_j
    # carry gradient into every W_dec_i
    dims = (40, 64, 72)
    gen = torch.Generator(device=DEVICE).manual_seed(6)
    params = init_crosscoder(gen, dims, 16)
    xs = []
    for i, d in enumerate(dims):
        xi, params[f"W_enc_{i}"], _ = _exact_inputs(gen, 512, params[f"W_enc_{i}"])
        params[f"b_dec_{i}"] = 0.1 * torch.randn(d, device=DEVICE, generator=gen)
        xs.append(xi)
    params["b_enc"] = _odd_grid(gen, 16 * dims[0], 100)
    xs = tuple(xs)
    _parity("crosscoder", params,
            lambda p: fused_crosscoder.fused_crosscoder_loss_terms(p, xs, LAMBDA, 16,
                                                                   compute_dtype=f32),
            lambda p: crosscoder_inference_and_loss(p, xs, LAMBDA), base)


# ---------------------------------------------------------------------------
# dx phase
# ---------------------------------------------------------------------------

def phase_dx() -> dict:
    """The dx kernels' path: the input gradient that attribution through a
    spliced SAE takes, fused_sae_loss_terms and the Matryoshka op with
    compute_dx=True at the training shape in bf16, through torch.autograd, on
    _relu_exact_operands' grid. Every count is set to 0 just before each op and
    read just after: the op must launch its forward, backward and dx kernels
    once each and no other kernel, and x's gradient must be finite and within
    the dx check's tolerance of the dx entry point's plain version on the
    operands the op saved. Returns the dx kernels' launches."""
    set_tf32(False)
    bf, fm = torch.bfloat16, fused_matryoshka_sae
    x, we, be, wd, bd = _relu_exact_operands(torch.float32)
    params = {"W_enc": we, "b_enc": be, "W_dec": wd, "b_dec": bd}
    saved = (x.to(bf) - bd.to(bf), we.to(bf), be, wd.to(bf))  # x_cent and the cast weights
    bounds = matryoshka_prefix_counts(H, DEFAULT_MATRYOSHKA_PREFIXES)
    launches = {}
    for mod in (fused_sae, fm):
        for k in KERNELS:
            k.launches = 0
        xx = x.clone().requires_grad_(True)
        if mod is fused_sae:
            out = fused_sae.fused_sae_loss_terms(params, xx, LAMBDA, H // C, compute_dtype=bf,
                                                 compute_dx=True)
        else:
            out = fm.fused_matryoshka_sae_loss_terms(params, xx, LAMBDA, H // C,
                                                     compute_dtype=bf, compute_dx=True)
        (gx,) = torch.autograd.grad(out["loss"], [xx])
        torch.cuda.synchronize()
        got = {k.name: k.launches for k in KERNELS}
        log(f"[dx] {mod.dx_kernel.name}: compute_dx=True at T={T} C={C} H={H} (bf16); "
            f"launches {got}")
        want = {k.name: int(k in mod.KERNELS) for k in KERNELS}
        if got != want:
            raise AssertionError(f"dx phase: expected launches {want}, got {got}")
        if not bool(torch.isfinite(gx).all()):
            raise AssertionError(f"dx phase: non-finite x gradient ({mod.dx_kernel.name})")
        launches[mod.dx_kernel.name] = got[mod.dx_kernel.name]
        # the plain dx on what the op saved: its error in bf16 and (c_rec, c_l1)
        # from the loss's cotangents, 1 for the reconstruction term (1/P per
        # prefix) and λ for l1
        if mod is fused_sae:
            err = (out["decoded"] - x).to(bf)
            coeffs = torch.tensor([2.0 / (T * C), LAMBDA / (T * H)], device=DEVICE)
            ref = fused_sae.fused_sae_dx_plain(*saved, err, coeffs)
        else:
            prefix_recon = fm.fused_matryoshka_forward(x.to(bf), saved[1], be, saved[3], bd,
                                                       bounds)[1]
            g = torch.full((len(bounds),), 1.0 / len(bounds), device=DEVICE) * (2.0 / (T * C))
            s = (g[:, None, None] * (prefix_recon - x[None])).flip(0).cumsum(0).flip(0).to(bf)
            coeffs = torch.tensor([1.0, LAMBDA / (T * H)], device=DEVICE)
            ref = fm.fused_matryoshka_dx_plain(*saved, s, coeffs, bounds)
        _check("x.grad vs plain dx", gx, ref, 1e-3, 1e-4)
        del out, gx, ref
        torch.cuda.empty_cache()
    return launches


# ---------------------------------------------------------------------------
# slice phase
# ---------------------------------------------------------------------------

# sae_model_name -> (config fields beyond the shared ones, steps whose perc_dead
# reads a freshly restarted accumulator, train images: None for the 512 of the
# synthetic stand-in). JumpReLU takes the "scaled" STE rule, bandwidth ≈ the
# activations' std and θ0 = std/2 (docs/CONVERGENCE.md:39), at the std of this
# run's stand-in activations, ~0.05 (random backbone, synthetic images); θ0 = 0.5
# would sit ~7 std above every pre-activation and no latent would ever fire.
SLICES = {
    # resets at 4 and 12, the resample at 9
    "sae_mlp": (dict(sae_lambda_sparse=LAMBDA), (4, 9, 12), None),
    "gated_sae": (dict(sae_lambda_sparse=LAMBDA), (4, 8, 12), None),  # the rolling window
    "jumprelu_sae": (dict(sae_lambda_sparse=LAMBDA_J, jumprelu_bandwidth=0.05,
                          jumprelu_threshold_init=0.025), (4, 8, 12), None),
    # λ = 5 and the default prefixes 1/16, 1/4, 1 (docs/CONVERGENCE.md:66)
    "matryoshka_sae": (dict(sae_lambda_sparse=LAMBDA), (4, 8, 12), None),
    # bench_transcoder.py:3-5: mixed3a (256) -> mixed3b (480), 16,384 latents
    "transcoder": (dict(sae_lambda_sparse=LAMBDA, transcoder_target_layer="mixed3b"),
                   (4, 9, 12), None),
    # bench_crosscoder.py:3-6: mixed4a..mixed4e (ΣC = 2,896), 8,192 latents, Adam,
    # λ 5, 16,384 tokens a step; 12 steps need 1,004 images of 196 tokens. Each
    # layer trains divided by its cache's token RMS (sae_input_norm="rms"): on the
    # raw stand-in activations (summed MSE ~3.6e-5 at init) λ 5 killed 98% of
    # the latents within four steps (PERF.md §4)
    "crosscoder": (dict(sae_lambda_sparse=LAMBDA, sae_input_norm="rms", sae_layer="mixed4a",
                        crosscoder_layers="mixed4b,mixed4c,mixed4d,mixed4e",
                        sae_expansion_factor=16, sae_optimizer_name="adam",
                        cache_tokens_per_step=16384), (4, 9, 12), 1024),
}


# device work of a traced run, by the start of its name in torch.profiler's
# averages: the host-device copies, the port's kernels (csrc/), and the rest
# (backbone, optimizer, losses, evals)
PORT_KERNELS = ("coder_", "center_kernel", "scale_err_kernel")


def _device_split(averages) -> str:
    """One line: the traced run's device time by kind, from torch.profiler's
    key_averages (self device time, microseconds)."""
    parts = {"HtoD": 0.0, "DtoH": 0.0, "DtoD": 0.0, "port kernels": 0.0, "other": 0.0}
    for e in averages:  # device events only, as the table's total counts them
        if e.device_type.name != "CUDA" or getattr(e, "is_user_annotation", False):
            continue
        if e.key.startswith("Memcpy"):
            kind = next((k for k in ("HtoD", "DtoH", "DtoD") if k in e.key), "DtoD")
        elif any(k in e.key for k in PORT_KERNELS):
            kind = "port kernels"
        else:
            kind = "other"
        parts[kind] += e.self_device_time_total
    total = sum(parts.values())
    return (f"device time {total / 1e3:.1f} ms: " + ", ".join(
        f"{k} {v / 1e3:.1f} ms ({v / max(total, 1e-9):.1%})" for k, v in parts.items()))


def _slice_config(name: str, extra: dict | None = None) -> tuple:
    """(RunConfig, datasets or None) of the slice ``name`` with the fields
    ``extra`` beyond SLICES'."""
    fields, _, n_train = SLICES[name]
    cfg = RunConfig(**{
        **dict(model_name="inceptionv1", dataset_name="imagenet", sae_layer="mixed3a",
               sae_model_name=name, sae_expansion_factor=64,
               sae_optimizer_name="constrained_adam", sae_learning_rate=1e-3,
               sae_batch_size=256, use_activation_cache=True, cache_tokens_per_step=32768,
               cache_dtype="bfloat16", sae_epochs=1, dead_neurons_steps=4,
               directory_path=str(WORK)),
        **fields, **(extra or {})})
    datasets = None
    if n_train is not None:  # the synthetic stand-in of load_data, with more train images
        size = (229, 229, 3)
        train = make_synthetic(num_samples=n_train, seed=cfg.seed, img_size=size,
                               num_classes=1000)
        val = make_synthetic(num_samples=256, seed=cfg.seed + 1, img_size=size,
                             num_classes=1000)
        datasets = (train, val, train.category_names, size)
    return cfg, datasets


def phase_slice(name: str, profile: bool = False, extra: dict | None = None,
                label: str = "", keep: bool = False) -> tuple:
    """One north-star-width run of ``name`` through the port's Pipeline, with
    the config fields ``extra`` beyond SLICES' (``label`` names the run in the
    log); returns (launches per kernel, the last eval's means, the cache
    directory of its sae_layer, which ``keep`` leaves on disk). ``profile``
    traces the run with torch.profiler and prints device time by kernel."""
    set_tf32(False)
    torch.backends.cudnn.allow_tf32 = True  # PyTorch's default for the backbone convs
    shutil.rmtree(WORK, ignore_errors=True)
    restarts = SLICES[name][1]
    name_log = f"{name}{label}"
    cfg, datasets = _slice_config(name, extra)
    t0 = time.perf_counter()
    pipe = Pipeline(cfg, datasets=datasets)
    log(f"[slice {name_log}] pipeline built in {time.perf_counter() - t0:.1f} s "
        f"(train {len(pipe.train_ds)} / val {len(pipe.val_ds)} images, "
        f"{pipe.num_units} latents)")
    before = {k: v.clone() for k, v in pipe.ts.params.items()}
    for k in KERNELS:
        k.launches = 0
    t0 = time.perf_counter()
    if profile:
        from torch.profiler import ProfilerActivity
        from torch.profiler import profile as trace

        with trace(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
            pipe.train_sae()
        averages = prof.key_averages()
        log(averages.table(sort_by="self_device_time_total", row_limit=25))
        log(f"[slice {name_log}] {_device_split(averages)}")
    else:
        pipe.train_sae()
    wall = time.perf_counter() - t0
    launches = {k.name: k.launches for k in KERNELS}
    log(f"[slice {name_log}] train_sae (dump, 12 steps, 2 evals) in {wall:.1f} s; "
        f"launches {launches}")

    steps = [(s, {k: float(v) for k, v in m.items()}) for s, m in pipe.train_log]
    for s, m in steps:
        log(f"[slice {name_log}] step {s}: sae_loss {m['sae_loss']:.6g} rec "
            f"{m['sae_rec_loss']:.6g} l1 {m['sae_l1_loss']:.6g} sparsity "
            f"{m['sparsity']:.6g} perc_dead {m['perc_dead']:.6g}")
    if len(steps) != 12:
        raise AssertionError(f"{name_log}: expected 12 train steps, ran {len(steps)}")
    if not all(math.isfinite(v) for _, m in steps for v in m.values()):
        raise AssertionError(f"{name_log}: non-finite step metric")
    by_step = dict(steps)
    # each restart leaves an all-True accumulator, which perc_dead reads (the
    # JAX step's documented quirk)
    for s in restarts:
        if by_step[s]["perc_dead"] != 1.0:
            raise AssertionError(f"{name_log}: no restart of the dead accumulator at step {s}: "
                                 f"perc_dead {by_step[s]['perc_dead']}")
    # and between restarts latents fire, so the restarts are what set it to 1
    if not all(m["perc_dead"] < 1.0 and m["sparsity"] > 0.0
               for s, m in steps if s not in restarts):
        raise AssertionError(f"{name_log}: every latent dead between restarts")
    timing = pipe.train_timing[0]
    log(f"[slice {name_log}] training loop: {timing['steps']} steps, {timing['tokens']} tokens "
        f"in {timing['seconds']:.3f} s = {timing['tokens'] / timing['seconds']:.0f} tokens/s "
        "(host clock, ends in a synchronize)")
    if len(pipe.eval_log) != 2:
        raise AssertionError(f"{name_log}: expected evals before and after the epoch")
    for epoch, m in pipe.eval_log:
        log(f"[slice {name_log}] eval epoch {epoch}: " + json.dumps(m, sort_keys=True))
        if not all(math.isfinite(v) for v in m.values()):
            raise AssertionError(f"{name_log}: non-finite eval metric at epoch {epoch}")
    trained = (MODULES[name].fwd_kernel, MODULES[name].bwd_kernel)  # not dx: x is data
    for k in KERNELS:
        want = 12 if k in trained else 0
        if launches[k.name] != want:
            raise AssertionError(f"{name_log}: expected {want} launches of {k.name}, got "
                                 f"{launches[k.name]}")
    for k, v in pipe.ts.params.items():
        moved = int((v != before[k]).sum())
        log(f"[slice {name_log}] {k}: {moved} of {v.numel()} entries moved")
        if k == "log_threshold" and moved == 0:
            raise AssertionError(f"{name_log}: no threshold moved: the STE path did not train")
    if name == "crosscoder":
        with open(pipe.decoder_norms_path) as f:
            rows = sum(1 for _ in f) - 1
        log(f"[slice {name_log}] decoder-norm CSV {pipe.decoder_norms_path}: {rows} rows")
        if rows != pipe.num_units:
            raise AssertionError(f"{name_log}: decoder-norm CSV has {rows} rows, not one per "
                                 "latent")
    last_eval, cache_dir = pipe.eval_log[-1][1], pipe._cache_dir(cfg.sae_layer)
    del pipe
    torch.cuda.empty_cache()
    if not keep:
        shutil.rmtree(WORK, ignore_errors=True)
    return {k: v for k, v in launches.items() if v}, last_eval, cache_dir


# ---------------------------------------------------------------------------
# cache phase
# ---------------------------------------------------------------------------

STAGE_ROUNDS = 8  # passes over the cache's stacks: each pinned buffer size is reused
INT8_BOUND = 0.05  # relative: the int8 run's last sae_rec_loss and sparsity vs bf16's


def _staged_copies_equal(cache_dir: str) -> None:
    """(a) Every stack that prefetch stages onto the card (pinned buffers, a
    side stream, an event each) is bitwise equal to a synchronous copy of the
    same host stack, read after two fused forward launches queued on the compute
    stream; over STAGE_ROUNDS passes each pinned buffer is reused, so a buffer
    refilled before its copy had landed would show."""
    from sparse_vision_tpu_torch.data.activation_cache import ActivationCache
    from sparse_vision_tpu_torch.data.prefetch import prefetch

    host = list(ActivationCache(cache_dir).stacks(T, Pipeline.CACHE_SCAN_K, shuffle=True))
    items = host * STAGE_ROUNDS
    ops = _relu_exact_operands(torch.bfloat16)
    t0 = time.perf_counter()
    with torch.no_grad():
        for i, staged in enumerate(prefetch(iter(items), DEVICE)):
            for _ in range(2):  # the compute stream is busy when the stack is read
                fused_sae.fused_sae_forward(*ops)
            if not torch.equal(staged, items[i].to(DEVICE)):
                raise AssertionError(f"cache: staged stack {i} differs from a synchronous copy")
    torch.cuda.synchronize()
    log(f"[cache] (a) {len(items)} staged stacks ({[tuple(h.shape) for h in host]}, "
        f"{STAGE_ROUNDS} passes) bitwise equal to synchronous copies, read behind fused "
        f"launches, in {time.perf_counter() - t0:.1f} s")


def _same_bytes(a: str, b: str) -> int:
    """Fail unless directories ``a`` and ``b`` hold the same files with the same
    bytes; returns the file count."""
    names = sorted(os.listdir(a))
    if names != sorted(os.listdir(b)) or any(".tmp" in n for n in names):
        raise AssertionError(f"cache: files differ: {names} vs {sorted(os.listdir(b))}")
    for n in names:
        if Path(a, n).read_bytes() != Path(b, n).read_bytes():
            raise AssertionError(f"cache: {n} differs between {a} and {b}")
    return len(names)


def phase_cache(bf16_eval: dict) -> None:
    """The host side of the cached path at the sae_mlp slice's shape (mixed3a,
    bf16 cache, T 32,768, K 8): (b) an overlap_dump_train run (the dump on a
    thread of its own stream, the epoch streamed from its shards) makes 12
    finite steps with 12 + 12 launches, and its shards are byte-equal to a
    sequential dump's; (a) the staged copies of that cache are bitwise equal to
    synchronous ones (_staged_copies_equal); (c) a cache_dtype="int8" run makes
    its 12 steps through the device-dequantizing steps, and its last eval's
    sae_rec_loss and sparsity are within INT8_BOUND of the bf16 slice's
    (``bf16_eval``; tests/test_int8_cache.py:100-110's bound)."""
    import sparse_vision_tpu_torch.train.pipeline as pipeline_mod
    from sparse_vision_tpu_torch.data.activation_cache import dump_activations

    _, _, over_dir = phase_slice("sae_mlp", extra=dict(overlap_dump_train=True),
                                 label=" (overlap_dump_train)", keep=True)
    cfg, _ = _slice_config("sae_mlp")
    pipe = Pipeline(dataclasses.replace(cfg, directory_path=str(WORK / "sequential")))
    seq_dir = pipe._cache_dir(cfg.sae_layer)
    t0 = time.perf_counter()
    dump_activations(pipe.net, pipe.frozen_params, pipe.net_state, pipe.train_ds,
                     cfg.sae_layer, seq_dir, device=pipe.device, **pipe._cache_dump_kwargs())
    del pipe
    n = _same_bytes(over_dir, seq_dir)
    log(f"[cache] (b) the overlapped dump's {n} files are byte-equal to a sequential dump's "
        f"(sequential dump {time.perf_counter() - t0:.1f} s)")
    _staged_copies_equal(seq_dir)
    shutil.rmtree(WORK, ignore_errors=True)

    quant = {"multi": 0, "single": 0}

    def counted(make, key):
        def wrapped(step_fn):
            inner = make(step_fn)

            def run(ts, q, *rest):
                if q.dtype != torch.int8 or q.device.type != torch.device(DEVICE).type:
                    raise AssertionError(f"cache: the quant step got {q.dtype} on {q.device}")
                quant[key] += 1
                return inner(ts, q, *rest)
            return run
        return wrapped

    saved = (pipeline_mod.make_sae_train_multi_step_quant, pipeline_mod.make_dequant_step_fn)
    pipeline_mod.make_sae_train_multi_step_quant = counted(saved[0], "multi")
    pipeline_mod.make_dequant_step_fn = counted(saved[1], "single")
    try:
        _, int8_eval, _ = phase_slice("sae_mlp", extra=dict(cache_dtype="int8"),
                                      label=" (int8 cache)")
    finally:
        pipeline_mod.make_sae_train_multi_step_quant, pipeline_mod.make_dequant_step_fn = saved
    steps = Pipeline.CACHE_SCAN_K * quant["multi"] + quant["single"]
    if steps != 12:
        raise AssertionError(f"cache: {steps} of 12 steps took the device-dequant steps")
    for key in ("sae_rec_loss", "sparsity"):
        rel = abs(int8_eval[key] - bf16_eval[key]) / abs(bf16_eval[key])
        log(f"[cache] (c) int8 {key} {int8_eval[key]:.6g} vs bf16 {bf16_eval[key]:.6g}: "
            f"{rel:.4%} apart (bound {INT8_BOUND:.0%})")
        if not rel <= INT8_BOUND:
            raise AssertionError(f"cache: int8 {key} is {rel:.2%} from bf16's")
    log(f"[cache] (c) {quant['multi']} multi-step and {quant['single']} single dispatches "
        "dequantized int8 stacks on the card")


# ---------------------------------------------------------------------------
# artifacts phase
# ---------------------------------------------------------------------------

COUNTING = ("perc_same", "perc_dead_units", "accuracy")
EVAL_RTOL = 1e-6  # the standalone eval's means against the last training eval's


def _same_state(name: str, a, b) -> None:
    """Fail unless two train states are bitwise equal: params, Adam moments and
    count, step and dead accumulator."""
    for k in a.params:
        for what, x, y in (("param", a.params[k], b.params[k]),
                           ("mu", a.opt_state["mu"][k], b.opt_state["mu"][k]),
                           ("nu", a.opt_state["nu"][k], b.opt_state["nu"][k])):
            if not torch.equal(x, y):
                n = int((x != y).sum())
                raise AssertionError(f"artifacts: {name}: {what} {k} differs in {n} entries")
    if (a.step, a.opt_state["count"]) != (b.step, b.opt_state["count"]):
        raise AssertionError(f"artifacts: {name}: step/count {a.step}/{a.opt_state['count']} "
                             f"vs {b.step}/{b.opt_state['count']}")
    if not torch.equal(a.dead_acc, b.dead_acc):
        raise AssertionError(f"artifacts: {name}: the dead accumulators differ")


def _artifact_run(label: str, want: int, **extra) -> tuple:
    """The gated_sae slice with ``extra`` through Pipeline.run(); fails unless
    rows 6-7 launched ``want`` times each and nothing else launched. Returns
    (pipe, result of run, seconds)."""
    cfg, datasets = _slice_config("gated_sae", extra)
    pipe = Pipeline(cfg, datasets=datasets)
    for k in KERNELS:
        k.launches = 0
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    out = pipe.run()
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = {k.name: k.launches for k in KERNELS}
    trained = (fused_gated_sae.fwd_kernel, fused_gated_sae.bwd_kernel)
    for k in KERNELS:
        if launches[k.name] != (want if k in trained else 0):
            raise AssertionError(f"artifacts: {label}: expected {want if k in trained else 0} "
                                 f"launches of {k.name}, got {launches[k.name]}")
    log(f"[artifacts] {label}: Pipeline.run in {wall:.1f} s, step {pipe.ts.step}, "
        f"{want} + {want} launches of {trained[0].name} / {trained[1].name}")
    return pipe, out, wall


def _check_exports(pipe) -> None:
    """(d) The .npz and .pth that training exported and a SAELens folder, each
    read back through import_any, bitwise equal to the trained params; the
    SAELens file's header parses and names every tensor."""
    from sparse_vision_tpu_torch.train import sae_io
    from sparse_vision_tpu_torch.utils.paths import sae_run_name

    params = pipe.ts.params
    folder = pipe.paths["sae_weights"]
    stem = os.path.join(folder, f"{sae_run_name(pipe.cfg)}_model_weights")
    t0 = time.perf_counter()
    pipe._export_sae_weights()
    export_s = time.perf_counter() - t0
    t0 = time.perf_counter()
    saelens = sae_io.save_sae_saelens(params, "gated_sae", os.path.join(folder, "saelens"))
    saelens_s = time.perf_counter() - t0
    for path in (stem + ".npz", stem + ".pth", saelens):
        got = sae_io.import_any(path, "gated_sae", like=params)
        for k, v in params.items():
            if not torch.equal(got[k], v.cpu()):
                raise AssertionError(f"artifacts: {path}: {k} does not read back bitwise")
    wpath = os.path.join(saelens, sae_io.SAELENS_WEIGHTS_FILE)
    raw = Path(wpath).read_bytes()
    n = int.from_bytes(raw[:8], "little")
    header = json.loads(raw[8:8 + n])
    want = {"W_enc": params["W_gate"], "b_gate": params["b_gate"], "b_mag": params["b_mag"],
            "r_mag": params["r_mag"], "W_dec": params["W_dec"], "b_dec": params["b_dec"]}
    for k, v in want.items():
        e = header[k]
        if e["dtype"] != "F32" or e["shape"] != list(v.shape):
            raise AssertionError(f"artifacts: SAELens header entry {k}: {e}")
    if max(e["data_offsets"][1] for k, e in header.items() if k != "__metadata__") != \
            len(raw) - 8 - n:
        raise AssertionError("artifacts: the SAELens header's offsets do not end the file")
    log(f"[artifacts] (d) .npz, .pth and SAELens exports read back bitwise equal; export "
        f"(.npz + .pth, {os.path.getsize(stem + '.npz') + os.path.getsize(stem + '.pth')} "
        f"bytes) {export_s:.3f} s, SAELens {saelens_s:.3f} s; header of {len(header)} "
        "entries parsed")


def _check_results(pipe, last: dict) -> dict:
    """(e) The results CSV's rows of epochs 1 and 2, the second with the last
    eval's values; the epoch-2 top-k file: [25, H] indices of samples in
    [0, 256), unique per unit, and H finite activity frequencies in [0, 1]."""
    import numpy as np

    from sparse_vision_tpu_torch.eval_tools.results import read_results

    folder = pipe.paths["evaluation_results"]
    rows = read_results(os.path.join(folder, "sae_eval_results.csv"))
    if [r["epochs"] for r in rows] != [1.0, 2.0]:
        raise AssertionError(f"artifacts: results rows {[r['epochs'] for r in rows]}")
    names = {"rec_loss": "sae_rec_loss", "l1_loss": "sae_l1_loss",
             "nrmse_loss": "sae_nrmse_loss", "rmse_loss": "sae_rmse_loss",
             "aux_loss": "sae_aux_loss", "rel_sparsity": "sparsity", "var_expl": "var_expl",
             "perc_dead_units": "perc_dead_units", "loss_diff": "loss_diff"}
    for col, key in names.items():
        if rows[1][col] != last[key]:
            raise AssertionError(f"artifacts: results row 2 {col} {rows[1][col]} != {last[key]}")
    n_val = len(pipe.val_ds)
    with np.load(os.path.join(folder, "filename_indices",
                              f"{pipe.run_id}_epoch_2.npz")) as z:
        f = {k: z[k] for k in z.files}
    h = pipe.num_units
    for k in ("max_filename_indices", "min_filename_indices"):
        idx = f[k]
        if idx.shape != (25, h) or idx.min() < 0 or idx.max() >= n_val:
            raise AssertionError(f"artifacts: {k} shape {idx.shape}, range "
                                 f"[{idx.min()}, {idx.max()}]")
        srt = np.sort(idx, axis=0)
        if (srt[1:] == srt[:-1]).any():
            raise AssertionError(f"artifacts: {k} repeats a sample within a unit")
    freq = f["activity_freq"]
    if freq.shape != (h,) or not np.isfinite(freq).all() or freq.min() < 0 or freq.max() > 1:
        raise AssertionError(f"artifacts: activity_freq shape {freq.shape}, range "
                             f"[{freq.min()}, {freq.max()}]")
    log(f"[artifacts] (e) results rows of epochs 1 and 2 (row 2 = the last eval); top-k "
        f"file [25, {h}] indices in [0, {n_val}), unique per unit; activity_freq in "
        f"[{freq.min():.4g}, {freq.max():.4g}], {int(f['dead_units'].sum())} dead units")
    return f


def _check_topk_values(pipe, f: dict) -> None:
    """The top-k file's samples rank first by value: the values at its indices,
    from a fresh pass of the eval step over the validation images, equal the
    largest and smallest 25 of each unit (values, not order, so the check does
    not depend on how equal values are ordered)."""
    import numpy as np

    bs = pipe.cfg.eval_batch_size or pipe._auto_eval_batch_size()
    with torch.no_grad():
        acts = torch.cat([pipe._sae_eval_step_fn(
            pipe.ts.params, pipe.frozen_params, pipe.net_state,
            torch.from_numpy(b.images).to(DEVICE), torch.from_numpy(b.labels).to(DEVICE)
        )[1]["topk_acts"] for b in pipe.val_ds.batches(bs, shuffle=False)])
    scale = float(acts.abs().max())
    for k, largest in (("max_filename_indices", True), ("min_filename_indices", False)):
        idx = torch.from_numpy(f[k].astype(np.int64)).to(DEVICE)
        got = acts.gather(0, idx)
        want = torch.topk(acts, 25, dim=0, largest=largest).values
        err = float((got - want).abs().max())
        if not err <= 1e-6 * scale:
            raise AssertionError(f"artifacts: {k}: values at the file's indices {err:.3g} "
                                 f"from the top 25 (scale {scale:.3g})")
    log(f"[artifacts] (e) the top-k file's samples hold the 25 largest and smallest values "
        f"of each unit (fresh eval pass, {acts.shape[0]} samples)")


def phase_artifacts() -> None:
    """A trained dictionary as an artifact (gated_sae slice, two epochs; its
    rolling window never resamples, so the generator, which is not
    checkpointed, plays no part)."""
    set_tf32(False)
    torch.backends.cudnn.allow_tf32 = True
    shutil.rmtree(WORK, ignore_errors=True)
    split, whole = str(WORK / "resumed"), str(WORK / "uninterrupted")
    # (b) one epoch, then a fresh Pipeline resumed from its checkpoint
    _, _, _ = _artifact_run("(b) epoch 1", 12, sae_epochs=1, directory_path=split)
    resumed, _, _ = _artifact_run("(b) resumed to epoch 2", 12, sae_epochs=2,
                                  sae_checkpoint_epoch=1, directory_path=split)
    # (a) the uninterrupted run, from a copy of the same cache bytes
    cache = os.path.join(resumed.paths["evaluation_results"], "activation_cache")
    cfg, _ = _slice_config("gated_sae", dict(sae_epochs=2, directory_path=whole))
    from sparse_vision_tpu_torch.utils.paths import folder_paths

    shutil.copytree(cache, os.path.join(folder_paths(cfg)["evaluation_results"],
                                        "activation_cache"))
    pipe, last, _ = _artifact_run("(a) uninterrupted", 24, sae_epochs=2, directory_path=whole)
    _same_state("(b) against (a)", resumed.ts, pipe.ts)
    log("[artifacts] (b) the resumed run is bitwise equal to the uninterrupted one: params, "
        "Adam moments and count, step, dead accumulator")
    del resumed
    torch.cuda.empty_cache()

    # one checkpoint's snapshot, write and restore
    tree, ck_dir = pipe._ckpt_tree(), str(WORK / "ckpt_timing")
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    path = ckpt.save_checkpoint(ck_dir, 1, tree, blocking=False)
    t1 = time.perf_counter()
    ckpt.wait_for_saves()
    t2 = time.perf_counter()
    back = ckpt.load_checkpoint(ck_dir, 1, like=tree)
    torch.cuda.synchronize()
    t3 = time.perf_counter()
    on_card = back["dead_acc"].device.type == torch.device(DEVICE).type
    if not on_card or back["opt_state"]["count"] != 24:
        raise AssertionError("artifacts: the restored checkpoint is off the card or miscounted")
    _same_state("checkpoint round trip", pipe.ts, pipe.ts._replace(
        params=back["params"], opt_state=back["opt_state"], step=back["step"],
        dead_acc=back["dead_acc"]))
    log(f"[artifacts] checkpoint of {os.path.getsize(path)} bytes: snapshot (blocking) "
        f"{(t1 - t0) * 1e3:.1f} ms, write {(t2 - t1) * 1e3:.1f} ms, restore to the card "
        f"{(t3 - t2) * 1e3:.1f} ms; round trip bitwise")

    _check_exports(pipe)
    f = _check_results(pipe, last)

    # (c) the standalone eval of the epoch-2 checkpoint
    import sparse_vision_tpu_torch.train.pipeline as pipeline_mod

    evaluated, means, eval_s = _artifact_run("(c) standalone eval", 0, training=False,
                                             sae_epochs=2, sae_checkpoint_epoch=2,
                                             directory_path=whole)
    _same_state("(c) restored against (a)", evaluated.ts, pipe.ts)
    for k, v in last.items():
        if (means[k] != v) if k in COUNTING else not abs(means[k] - v) <= EVAL_RTOL * abs(v):
            raise AssertionError(f"artifacts: standalone eval {k} {means[k]!r} vs last "
                                 f"training eval {v!r}")
    exact = sum(means[k] == v for k, v in last.items())
    log(f"[artifacts] (c) standalone eval of the epoch-2 checkpoint reproduces the last "
        f"eval (counts exactly, the rest within {EVAL_RTOL:g} relative; {exact} of "
        f"{len(last)} means bitwise): {json.dumps(means)}")
    del evaluated
    _check_topk_values(pipe, f)

    # an eval with and without its top-k updates, on the same pipeline
    times, bs = {}, pipe.cfg.eval_batch_size or pipe._auto_eval_batch_size()
    saved = pipeline_mod.update_topk
    for label in ("with top-k", "without top-k", "with top-k"):
        if label == "without top-k":
            pipeline_mod.update_topk = lambda state, *_: state
        try:
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            pipe.eval_modified(epoch=99, store=False)
            torch.cuda.synchronize()
            times.setdefault(label, []).append(time.perf_counter() - t0)
        finally:
            pipeline_mod.update_topk = saved
    log(f"[artifacts] eval of {len(pipe.val_ds)} val images in batches of {bs} (drop_last): "
        f"with its top-k updates "
        f"{times['with top-k']} s, without {times['without top-k']} s (the standalone "
        f"Pipeline.run eval, build not counted: {eval_s:.2f} s)")
    del pipe
    torch.cuda.empty_cache()
    shutil.rmtree(WORK, ignore_errors=True)


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--profile", action="store_true",
                    help="trace the slices with torch.profiler (slows them; times are then "
                         "not clean)")
    args = ap.parse_args()

    smi = phase_device()
    phase_build()
    rows = phase_kernels()
    phase_parity()
    launches = phase_dx()
    evals = {}
    for name in SLICES:
        got, evals[name], _ = phase_slice(name, args.profile)
        launches.update(got)
    phase_cache(evals["sae_mlp"])
    phase_artifacts()
    kernels = [
        {"name": k.name, "route": "cuda", "source": SOURCES[k.name],
         "replaces": REPLACES[k.name], "launches": launches.get(k.name, 0), **rows[k.name]}
        for k in KERNELS
    ]
    print(json.dumps({"kernels": kernels}))
    print(smi)
    print(json.dumps({"ok": True, "device": {"platform": "gpu",
                                             "kind": torch.cuda.get_device_name(0),
                                             "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
