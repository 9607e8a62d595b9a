"""Smoke run of the PyTorch/CUDA port on one NVIDIA GPU.

    python3 chip_smoke.py              # every phase, one card
    python3 chip_smoke.py --profile    # the same, with a torch.profiler table of the slice

Phases, in order; a phase that fails raises and the script exits non-zero:
  1. device:  require CUDA; print the card's name and power limit (nvidia-smi).
  2. build:   compile every kernel in sparse_vision_tpu_torch/csrc with nvcc.
  3. kernels: hold each kernel against its plain PyTorch version on the card at
              the training shape (T=32768 tokens, C=256, H=16384 latents), in
              f32 and bf16 operands; time kernel, plain version and the cuBLAS
              products of the stock path; compute each kernel's bound.
  4. parity:  the fused op's loss and gradients against the stock autograd path
              on the card at a small shape, in f32.
  5. slice:   Pipeline.train_sae_cached on the north-star config (GoogLeNet
              mixed3a, 16,384-latent sae_mlp, bf16 cache, 12 steps of 32,768
              tokens, a measurement reset at step 4 and a resample at step 9),
              with every kernel launch count reset just before and read after.
Then one JSON line naming each kernel, the nvidia-smi line, and the last line
{"ok": true, "device": {...}}.
"""

from __future__ import annotations

import argparse
import json
import math
import shutil
import subprocess
import sys
import time
from pathlib import Path

import torch

from sparse_vision_tpu_torch.config import RunConfig
from sparse_vision_tpu_torch.models.sae import init_sae_mlp, sae_inference_and_loss
from sparse_vision_tpu_torch.ops import fused_sae, native
from sparse_vision_tpu_torch.train.pipeline import Pipeline

ROOT = Path(__file__).resolve().parent
WORK = ROOT / "_smoke_work"  # listed in .gitignore; removed at the end

# H100 SXM data sheet, dense: bf16 tensor cores, f32 outside them; HBM3 rate
PEAK_FLOPS = {torch.bfloat16: 989e12, torch.float32: 67e12}
PEAK_BYTES_PER_S = 3.35e12

T, C, H = 32768, 256, 16384
LAMBDA = 5.0
REPS = 5  # timed launches per measurement, after one warm-up
REPLACES = {
    "fused_sae_fwd": "sparse_vision_tpu/ops/fused_sae.py:43",
    "fused_sae_bwd": "sparse_vision_tpu/ops/fused_sae.py:96",
}
SOURCE = "sparse_vision_tpu_torch/csrc/fused_sae.cu"


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
    t0 = time.perf_counter()
    built = native.build()
    for name, b in built.items():
        ptxas = [ln.strip() for ln in b["log"].splitlines()
                 if "Function properties" in ln or "registers" in ln or "spill" in ln]
        log(f"[build] {name}: {b['seconds']:.1f} s -> {b['path']}")
        for ln in ptxas:
            log(f"[build]   {ln}")
    log(f"[build] all kernels in {time.perf_counter() - t0:.1f} s")


def _inputs(cd, seed: int = 0):
    gen = torch.Generator(device="cuda").manual_seed(seed)
    params = init_sae_mlp(gen, C, H // C)
    params["b_enc"] = params["b_enc"] - 0.05
    params["b_dec"] = 0.1 * torch.randn(C, device="cuda", generator=gen)
    x = torch.relu(torch.randn(T, C, device="cuda", generator=gen)) * 2.0
    return (x.to(cd).contiguous(), params["W_enc"].to(cd).contiguous(), params["b_enc"],
            params["W_dec"].to(cd).contiguous(), params["b_dec"].contiguous())


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


def phase_kernels() -> dict:
    """Both kernels against their plain versions in f32 and bf16; returns the
    bf16 (main path) rows."""
    set_tf32(False)  # the plain versions' f32 products in full f32
    rows = {}
    for cd in (torch.float32, torch.bfloat16):
        tag = "f32" if cd == torch.float32 else "bf16"
        x, we, be, wd, bd = _inputs(cd)
        with torch.no_grad():
            out_k = fused_sae.fwd_kernel(x, we, be, wd, bd)
            out_p = fused_sae.fused_sae_forward_plain(x, we, be, wd, bd)
            torch.cuda.synchronize()
            log(f"[kernels] fused_sae_fwd [{tag}] vs plain")
            # the kernel and cuBLAS sum in other orders; a pre-activation within
            # rounding of 0 may flip, so counts get a tolerance of a few tokens
            errs = [_check("recon", out_k[0], out_p[0], 1e-4, 1e-5),
                    _check("act_count", out_k[1], out_p[1], 0.0, 1e-3),
                    _check("row_active", out_k[2], out_p[2], 0.0, 1e-3),
                    _check("l1_sum", out_k[3], out_p[3], 1e-5, 0.0)]
            fwd_err = errs[0]
            ms = time_ms(lambda: fused_sae.fwd_kernel(x, we, be, wd, bd), REPS)
            plain_ms = time_ms(lambda: fused_sae.fused_sae_forward_plain(x, we, be, wd, bd), REPS)
            xc = (x - bd.to(cd))
            post = torch.relu(xc @ we).to(cd)
            lib_ms = time_ms(lambda: (xc @ we, post @ wd), REPS)
            b_ms, b_by = bound(4.0 * T * C * H,
                               nbytes(x, we, be, wd, bd) + nbytes(out_p[0], out_p[1], out_p[2])
                               + 4, cd)
            log(f"[kernels] fused_sae_fwd [{tag}] ms {ms:.3f} plain_ms {plain_ms:.3f} "
                f"library_ms(2 matmuls) {lib_ms:.3f} bound_ms {b_ms:.4f} ({b_by})")
            fwd_row = dict(max_abs_err=fwd_err, ms=ms, plain_ms=plain_ms, bound_ms=b_ms,
                           bound_by=b_by, library_ms=lib_ms)

            err = (out_p[0] - x.float()).to(cd)  # the residual the backward reads
            coeffs = torch.tensor([2.0 / (T * C), LAMBDA / (T * H)], device="cuda")
            g_k = fused_sae.bwd_kernel(x, we, be, wd, bd, err, coeffs)
            g_p = fused_sae.fused_sae_backward_plain(x, we, be, wd, bd, err, coeffs)
            torch.cuda.synchronize()
            log(f"[kernels] fused_sae_bwd [{tag}] vs plain")
            errs = [_check(n, a, b, 1e-3, 1e-4)
                    for n, a, b in zip(("dW_enc", "db_enc", "dW_dec", "db_dec"), g_k, g_p)]
            bwd_err = max(errs)
            ms = time_ms(lambda: fused_sae.bwd_kernel(x, we, be, wd, bd, err, coeffs), REPS)
            plain_ms = time_ms(
                lambda: fused_sae.fused_sae_backward_plain(x, we, be, wd, bd, err, coeffs), REPS)
            dr = (coeffs[0] * err.float()).to(cd)
            lib_ms = time_ms(lambda: (dr @ wd.T, xc.T @ post, post.T @ dr), REPS)
            b_ms, b_by = bound(8.0 * T * C * H,
                               nbytes(x, we, be, wd, bd, err, coeffs) + nbytes(*g_p), cd)
            log(f"[kernels] fused_sae_bwd [{tag}] ms {ms:.3f} plain_ms {plain_ms:.3f} "
                f"library_ms(3 matmuls) {lib_ms:.3f} bound_ms {b_ms:.4f} ({b_by})")
            bwd_row = dict(max_abs_err=bwd_err, ms=ms, plain_ms=plain_ms, bound_ms=b_ms,
                           bound_by=b_by, library_ms=lib_ms)
        del x, we, be, wd, bd, out_k, out_p, g_k, g_p, err, xc, post, dr
        torch.cuda.empty_cache()
        if cd == torch.bfloat16:
            rows = {"fused_sae_fwd": fwd_row, "fused_sae_bwd": bwd_row}
    return rows


def phase_parity() -> None:
    """The fused op (kernels + autograd.Function) against the stock autograd path
    on the card: loss terms and parameter gradients, f32, small shape."""
    set_tf32(False)
    gen = torch.Generator(device="cuda").manual_seed(1)
    params = init_sae_mlp(gen, C, 4)
    params["b_enc"] = params["b_enc"] - 0.05
    x = torch.randn(512, C, device="cuda", generator=gen)

    def grads(loss_fn):
        p = {k: v.clone().requires_grad_(True) for k, v in params.items()}
        out = loss_fn(p)
        g = torch.autograd.grad(out["loss"], list(p.values()))
        return out, dict(zip(p, g))

    out_f, g_f = grads(lambda p: fused_sae.fused_sae_loss_terms(
        p, x, LAMBDA, 4, compute_dtype=torch.float32))
    out_s, g_s = grads(lambda p: sae_inference_and_loss("sae_mlp", p, x, LAMBDA))
    for k in ("loss", "rec_loss", "l1_loss", "nrmse_loss", "rmse_loss"):
        a, b = float(out_f[k].detach()), float(out_s[k].detach())
        if not math.isclose(a, b, rel_tol=1e-4):
            raise AssertionError(f"parity {k}: fused {a} vs stock {b}")
    for k in params:
        err = (g_f[k] - g_s[k]).abs().max().item()
        scale = g_s[k].abs().max().item()
        log(f"[parity] grad {k}: max_abs_err {err:.3e} (max|ref| {scale:.3e})")
        if err > 1e-4 * scale + 1e-7:
            raise AssertionError(f"parity grad {k}: max abs err {err:.3e}")
    log("[parity] fused op == stock autograd path (f32): ok")


def phase_slice(profile: bool = False) -> dict:
    """The north-star chain through the port's Pipeline; returns launches per kernel.
    ``profile`` traces it with torch.profiler and prints device time by kernel."""
    set_tf32(False)
    torch.backends.cudnn.allow_tf32 = True  # PyTorch's default for the backbone convs
    shutil.rmtree(WORK, ignore_errors=True)
    cfg = RunConfig(
        model_name="inceptionv1", dataset_name="imagenet", sae_layer="mixed3a",
        sae_model_name="sae_mlp", sae_expansion_factor=64, sae_lambda_sparse=5.0,
        sae_optimizer_name="constrained_adam", sae_learning_rate=1e-3,
        sae_batch_size=256, use_activation_cache=True, cache_tokens_per_step=32768,
        cache_dtype="bfloat16", sae_epochs=1, dead_neurons_steps=4,
        directory_path=str(WORK),
    )
    t0 = time.perf_counter()
    pipe = Pipeline(cfg)
    log(f"[slice] pipeline built in {time.perf_counter() - t0:.1f} s "
        f"(train {len(pipe.train_ds)} / val {len(pipe.val_ds)} images, "
        f"{pipe.num_units} latents)")
    for k in fused_sae.KERNELS:
        k.launches = 0
    t0 = time.perf_counter()
    if profile:
        from torch.profiler import ProfilerActivity
        from torch.profiler import profile as trace

        with trace(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
            pipe.train_sae_cached()
        log(prof.key_averages().table(sort_by="self_device_time_total", row_limit=25))
    else:
        pipe.train_sae_cached()
    wall = time.perf_counter() - t0
    launches = {k.name: k.launches for k in fused_sae.KERNELS}
    log(f"[slice] train_sae_cached (dump, 12 steps, 2 evals) in {wall:.1f} s; launches {launches}")

    steps = [(s, {k: float(v) for k, v in m.items()}) for s, m in pipe.train_log]
    for s, m in steps:
        log(f"[slice] step {s}: sae_loss {m['sae_loss']:.6g} rec {m['sae_rec_loss']:.6g} "
            f"l1 {m['sae_l1_loss']:.6g} sparsity {m['sparsity']:.6g} "
            f"perc_dead {m['perc_dead']:.6g}")
    if len(steps) != 12:
        raise AssertionError(f"expected 12 train steps, ran {len(steps)}")
    if not all(math.isfinite(m["sae_loss"]) for _, m in steps):
        raise AssertionError("non-finite sae_loss")
    by_step = dict(steps)
    # the reset at step 4 and the resample at step 9 both leave an all-True
    # accumulator, which perc_dead reads (the JAX step's documented quirk)
    for s in (4, 9):
        if by_step[s]["perc_dead"] != 1.0:
            raise AssertionError(f"no reset/resample at step {s}: "
                                 f"perc_dead {by_step[s]['perc_dead']}")
    timing = pipe.train_timing[0]
    log(f"[slice] training loop: {timing['steps']} steps, {timing['tokens']} tokens in "
        f"{timing['seconds']:.3f} s = {timing['tokens'] / timing['seconds']:.0f} tokens/s "
        "(host clock, ends in a synchronize)")
    for epoch, m in pipe.eval_log:
        log(f"[slice] eval epoch {epoch}: " + json.dumps(m, sort_keys=True))
        if not all(math.isfinite(v) for v in m.values()):
            raise AssertionError(f"non-finite eval metric at epoch {epoch}")
    if not (launches["fused_sae_fwd"] == launches["fused_sae_bwd"] == 12):
        raise AssertionError(f"expected 12 forward and 12 backward launches, got {launches}")
    shutil.rmtree(WORK, ignore_errors=True)
    return launches


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--profile", action="store_true",
                    help="trace the slice with torch.profiler (slows it; times are then not clean)")
    args = ap.parse_args()

    smi = phase_device()
    phase_build()
    rows = phase_kernels()
    phase_parity()
    launches = phase_slice(args.profile)
    kernels = [
        {"name": name, "route": "cuda", "source": SOURCE, "replaces": REPLACES[name],
         "launches": launches[name], **rows[name]}
        for name in ("fused_sae_fwd", "fused_sae_bwd")
    ]
    print(json.dumps({"kernels": kernels}))
    print(smi)
    print(json.dumps({"ok": True, "device": {"platform": "gpu",
                                             "kind": torch.cuda.get_device_name(0),
                                             "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
