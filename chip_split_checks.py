"""The grid split of the bf16 coder bodies (csrc/coder.cuh, "Splits") on one
NVIDIA GPU, in about a minute with the build: the quick card run after a change
to a split body, before the whole of chip_smoke.py.

    python3 chip_split_checks.py            # build; the split launches' checks and pairs
    python3 chip_split_checks.py --probe    # and where a split's cost goes at N 8

It builds every kernel (chip_smoke.phase_build: ptxas's registers, a spill
fails), then holds the launches that split against their plain versions, each
bf16 launch repeated bitwise (chip_smoke's own checks): both coders at ragged
shapes (the forward split at C_out 520, the backward at T 2,176; the
transcoder's held passes at C_in 136 -> C_out 264, T 1,152 and 2,176, and at
phase 10's mixed3a -> mixed3b launch, T 3,072, split in 3, each split launch
and the same launch unsplit held pass by pass), the ReLU,
Matryoshka, JumpReLU and gated ops at C 480 and 832 with T 8,192 and H 4,096
(the backward split in two at every width, the in-place forward at 832),
PERF.md rows 23-26 at a (2, 2) rank's shard, and the four sweep kernels at
bench_sweep.py's shape for N 3 and 8 (each combo bitwise a one-dictionary
launch). chip_smoke._split_pair times every split launch beside the same
launch unsplit; the pairs come out as one JSON line. ``--probe`` then times
the ReLU and gated sweep backwards at equal work with blocks of 8 token steps
(N 8, T 4,096, unsplit), of 2 (N 8 split in 4; N 32, T 1,024 unsplit) and of
1 (N 32, T 1,024 split in 2), twice each, 30 launches a point: the unsplit
pair separates a block's own fixed cost from the split's sums.
"""

from __future__ import annotations

import argparse
import json
import time

import torch

import chip_smoke as c


def checks() -> None:
    bf = torch.bfloat16
    with torch.no_grad():
        for cd, tag in ((torch.float32, "f32"), (bf, "bf16")):
            c.kernels_coder_ragged(cd, tag)
        c.kernels_sae_widths(bf, "bf16")
        torch.cuda.empty_cache()
        c.kernels_act_widths(bf, "bf16")
        torch.cuda.empty_cache()
        rows = c._tp_coder_rows(bf, "bf16")
        torch.cuda.empty_cache()
        for name in c.SWEEP_MODULES:
            c._sweep_kernel_check(name, bf, 3, c.SW_T, c.SW_C, c.SW_H, timed=False)
            c._sweep_kernel_check(name, bf, c.SW_ROW_N, c.SW_T, c.SW_C, c.SW_H, timed=True)
            torch.cuda.empty_cache()
    print(json.dumps({"splits": c.SPLITS}))
    print(json.dumps({k: {m: v[m] for m in ("ms", "bound_ms", "library_ms")}
                      for k, v in rows.items()}))


def _sweep_bwd(name: str, n: int, t: int):
    """The sweep backward wrapper of ``name`` and its operands at (n, t, SW_C,
    SW_H), after the batched forward."""
    bf = torch.bfloat16
    ops = c._sweep_ops(name, bf, n, t, c.SW_C, c.SW_H)
    mod = c.SWEEP_MODULES[name]
    plain = c.SW_PLAIN[name][0](*ops)
    x_cent = mod.sweep_fwd_kernel(*ops)[0] if name in ("sae_mlp", "matryoshka_sae") else None
    if name in ("jumprelu_sae", "gated_sae"):
        plain = c._sweep_reduce(name, plain, False)
    return mod.sweep_bwd_kernel, c._sweep_bwd_ops(name, bf, ops, x_cent, plain)


def probe() -> None:
    with torch.no_grad():
        for name in ("sae_mlp", "gated_sae"):
            k8, a8 = _sweep_bwd(name, 8, 4096)
            k32, a32 = _sweep_bwd(name, 32, 1024)
            points = {"N8 s1": lambda: k8(*a8, n_split=1), "N8 s2": lambda: k8(*a8, n_split=2),
                      "N8 s4": lambda: k8(*a8, n_split=4),
                      "N32 T1024 s1": lambda: k32(*a32, n_split=1),
                      "N32 T1024 s2": lambda: k32(*a32, n_split=2)}
            got = {k: [] for k in points}
            for _ in range(2):
                for k, fn in points.items():
                    got[k].append(c.time_ms(fn, 30))
            print(name, json.dumps({k: [round(v, 4) for v in vs] for k, vs in got.items()}),
                  flush=True)
            del a8, a32
            torch.cuda.empty_cache()


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--probe", action="store_true", help="also time the split's cost at N 8")
    args = ap.parse_args()
    t0 = time.perf_counter()
    smi = c.phase_device()
    c.phase_build()
    c.set_tf32(False)
    checks()
    if args.probe:
        probe()
    print(f"done in {time.perf_counter() - t0:.1f} s")
    print(smi)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
