"""Checks of chip_smoke.py phase 15's own mesh checks, on one NVIDIA GPU.

    python3 chip_mesh_checks.py

Phase 15 holds each mesh run of phase 6's configs to the one-rank run of the
same config (chip_smoke._check_mesh_run). This script runs that check on eight
more mesh runs, every world's ranks on the one card over gloo, each against a
one-rank run made here:
  grads     sae_mlp at (2,) with the data-parallel step's gradients left
            unreduced (each replica steps on its own shard's gradient);
  db_dec    sae_mlp at (2, 2) with the ReLU TP op's (m−1)·direct correction
            of db_dec left out (db_dec then counts the direct term m times);
  dtheta    jumprelu_sae at (2, 2) with the JumpReLU TP op's threshold
            gradient psummed over both axes (each latent's dθ then adds the
            dθ of the latent at its place on the other model rank);
  n_contrib matryoshka_sae at (2, 2) with the Matryoshka TP op's
            (n_contrib_p − 1) correction of db_dec left out;
  tc_db_dec the transcoder at (2, 2) with the transcoder TP op's db_dec
            psummed over both axes (m times the direct term: every model
            rank holds the whole Σ_T drecon already);
  cc_dn     the crosscoder at (2, 2) with the crosscoder TP op's decoder-norm
            gradient dn left without its 'data' psum (each data rank's own
            token sum);
  gated dp  gated_sae at (2,) in bf16, as phase 15 runs it;
  gated f32 gated_sae at (2, 2) with compute_dtype float32.
The six faults are planted at run time in the ranks' processes (no file
changes), and each must fail the check. The two gated runs say where phase 15
(c)'s wider parameter gap comes from: the summation order of the TP op in
bf16 (the data-parallel run sums in yet another order) or something the f32
run shares; both must pass the check. Prints each run's readings, then one
JSON line of the verdicts; exits non-zero if a planted fault passes the check
or a clean run fails it.
"""

from __future__ import annotations

import contextlib
import json
import shutil
import sys
import time

import torch

import chip_smoke as cs
from sparse_vision_tpu_torch.ops import (
    fused_crosscoder,
    fused_gated_sae,
    fused_sae,
    fused_sae_tp,
    fused_transcoder,
)
from sparse_vision_tpu_torch.parallel import sharded_steps
from sparse_vision_tpu_torch.parallel.distributed import spawn

F32 = {"compute_dtype": "float32"}


def _relu_db_dec(saved):
    """The ReLU TP op's backward with its (m−1)·direct correction undone."""
    def backward(ctx, g_rec, g_l1, *rest):
        x_cent, *_, err_sum = ctx.saved_tensors
        t_g, _, _, m = ctx.dims
        out = list(saved.__func__(ctx, g_rec, g_l1, *rest))
        coeff = fused_sae_tp._zero_if_none(g_rec, x_cent) * 2.0 / (t_g * x_cent.shape[1])
        # db_dec + (m−1)·psum_data(direct)
        out[4] = out[4] + (m - 1) * ctx.mesh.psum(coeff * err_sum, "data")
        return tuple(out)
    return backward


def _jumprelu_dtheta(saved):
    """The JumpReLU TP op's backward with dθ psummed over 'model' as well."""
    def backward(ctx, *cts):
        thr = ctx.saved_tensors[3]
        out = list(saved.__func__(ctx, *cts))
        # d log_θ = psum_data(dθ)·θ, made psum_both(dθ)·θ
        out[3] = ctx.mesh.psum(out[3] / thr, "model") * thr
        return tuple(out)
    return backward


def _matryoshka_n_contrib(saved):
    """The Matryoshka TP op's backward with its (n_contrib_p − 1) correction
    undone."""
    def backward(ctx, g_prefix, g_l1, *rest):
        x_cent, _, _, _, errs, extra = ctx.saved_tensors
        t_g = ctx.dims[0]
        out = list(saved.__func__(ctx, g_prefix, g_l1, *rest))
        cts = g_prefix.float() * (2.0 / (t_g * x_cent.shape[1]))
        # db_dec + psum_data(Σ_p (n_contrib_p − 1)·c_p·Σ_T err_p)
        out[4] = out[4] + ctx.mesh.psum(torch.einsum("p,ptc->c", extra * cts, errs), "data")
        return tuple(out)
    return backward


def _transcoder_db_dec(saved):
    """The transcoder TP op's backward with db_dec psummed over 'model' too."""
    def backward(ctx, *cts):
        out = list(saved.__func__(ctx, *cts))
        out[4] = ctx.mesh.psum(out[4], "model")
        return tuple(out)
    return backward


def _crosscoder_dn(saved):
    """The crosscoder TP op's backward with dn from this rank's own token sum
    (no 'data' psum)."""
    def backward(ctx, g_rec, g_l1, *rest):
        zsum = ctx.saved_tensors[6]
        t_g, h_g = ctx.dims
        out = list(saved.__func__(ctx, g_rec, g_l1, *rest))
        out[6] = fused_sae_tp._zero_if_none(g_l1, zsum) * zsum / (t_g * h_g)
        return tuple(out)
    return backward


@contextlib.contextmanager
def _planted(fault: str):
    """``fault`` ("grads", "db_dec", "dtheta", "n_contrib", "tc_db_dec" or
    "cc_dn", the module docstring) planted in this process for the block."""
    if fault == "grads":
        cls, attr = sharded_steps.DataSync, "grads"
        saved = cls.__dict__[attr]
        cls.grads = lambda self, grads: grads
    else:
        cls, make = {"db_dec": (fused_sae_tp.FusedSAETPFunction, _relu_db_dec),
                     "dtheta": (fused_sae_tp.FusedJumpReLUSAETPFunction, _jumprelu_dtheta),
                     "n_contrib": (fused_sae_tp.FusedMatryoshkaSAETPFunction,
                                   _matryoshka_n_contrib),
                     "tc_db_dec": (fused_transcoder.FusedTranscoderTPFunction,
                                   _transcoder_db_dec),
                     "cc_dn": (fused_crosscoder.FusedCrosscoderTPFunction,
                               _crosscoder_dn)}[fault]
        attr = "backward"
        saved = cls.__dict__[attr]
        cls.backward = staticmethod(make(saved))
    try:
        yield
    finally:
        setattr(cls, attr, saved)


def _rank(rank: int, mesh, job: str) -> dict:
    """A rank of the (2,) world ("dp": grads, gated dp) or of the (2, 2) world
    ("tp": db_dec, dtheta, n_contrib, tc_db_dec, cc_dn, gated f32)."""
    cs.set_tf32(False)
    torch.backends.cudnn.allow_tf32 = True
    if job == "dp":
        with _planted("grads"):
            out = {"grads": cs._mesh_run(mesh, "sae_mlp", fused_sae.KERNELS)}
        out["gated dp"] = cs._mesh_run(mesh, "gated_sae", fused_gated_sae.KERNELS)
        return out
    out = {}
    for fault, name, kernels in (("db_dec", "sae_mlp", cs.TP_KERNELS),
                                 ("dtheta", "jumprelu_sae", cs.TP_KERNELS),
                                 ("n_contrib", "matryoshka_sae", cs.TP_KERNELS),
                                 ("tc_db_dec", "transcoder", fused_transcoder.TP_KERNELS),
                                 ("cc_dn", "crosscoder", fused_crosscoder.TP_KERNELS)):
        with _planted(fault):
            out[fault] = cs._mesh_run(mesh, name, kernels)
    out["gated f32"] = cs._mesh_run(mesh, "gated_sae", cs.TP_KERNELS, F32)
    return out


def main() -> int:
    smi = cs.phase_device()
    t0 = time.perf_counter()
    shutil.rmtree(cs.MESH_WORK, ignore_errors=True)
    cs.set_tf32(False)
    ref = {name: cs._one_rank_run(name)
           for name in ("sae_mlp", "gated_sae", "jumprelu_sae", "matryoshka_sae", "transcoder",
                        "crosscoder")}
    ref["gated_sae f32"] = cs._one_rank_run("gated_sae", F32)
    worlds = {"dp": spawn(_rank, cs.MESH_DP, "dp", device=cs.DEVICE, backend="gloo",
                          timeout_s=cs.MESH_TIMEOUT_S),
              "tp": spawn(_rank, cs.MESH, "tp", device=cs.DEVICE, backend="gloo",
                          timeout_s=cs.MESH_TIMEOUT_S)}
    runs = (  # label, world, variant, reference, kernels, planted
        ("grads", "dp", "sae_mlp", "sae_mlp", fused_sae.KERNELS[:2], True),
        ("db_dec", "tp", "sae_mlp", "sae_mlp", cs.TP_KERNELS[:2], True),
        ("dtheta", "tp", "jumprelu_sae", "jumprelu_sae", cs.TP_KERNELS[4:6], True),
        ("n_contrib", "tp", "matryoshka_sae", "matryoshka_sae", cs.TP_KERNELS[6:8], True),
        ("tc_db_dec", "tp", "transcoder", "transcoder", fused_transcoder.TP_KERNELS, True),
        ("cc_dn", "tp", "crosscoder", "crosscoder", fused_crosscoder.TP_KERNELS, True),
        ("gated dp", "dp", "gated_sae", "gated_sae", fused_gated_sae.KERNELS, False),
        ("gated f32", "tp", "gated_sae", "gated_sae f32", cs.TP_KERNELS[2:4], False),
    )
    verdicts, ok = {}, True
    for label, world, name, r, kernels, planted in runs:
        try:
            cs._check_mesh_run(label, name, [x[label] for x in worlds[world]], ref[r],
                               kernels, 12)
            failure = None
        except AssertionError as e:
            failure = str(e)
        right = (failure is not None) == planted
        ok &= right
        verdicts[label] = {"planted": planted, "check_failed": failure is not None,
                           "as_required": right}
        cs.log(f"[checks] {label}: " + (f"the check failed: {failure}" if failure else
                                         "the check passed")
               + ("" if right else " -- NOT AS REQUIRED"))
    shutil.rmtree(cs.MESH_WORK, ignore_errors=True)
    cs.log(f"[checks] {smi}: {time.perf_counter() - t0:.1f} s")
    print(json.dumps({"verdicts": verdicts, "ok": ok}))
    return 0 if ok else 1


if __name__ == "__main__":
    sys.exit(main())
