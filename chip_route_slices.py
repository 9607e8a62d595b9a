"""Phase 6's sae_mlp and matryoshka_sae slices (chip_smoke.phase_slice: GoogLeNet
mixed3a, 16,384 latents, bf16 cache, 12 steps of 32,768 tokens) with the SAEs'
backward on the body ops/fused_sae.bwd_route gives it (the cluster pair at C
256) and forced onto coder_bwd_tc, in turns (pair, tc, tc, pair) in one
process, on one NVIDIA GPU: the end-to-end tokens/s of each route.

    python3 chip_route_slices.py

Prints each run's training-loop tokens/s and launches, one JSON line of them,
then nvidia-smi's name and power limit. A 12-step loop takes ~0.2 s on the
host clock, so read the turns together: the first run of a process pays its
warm-up.
"""

from __future__ import annotations

import json

import torch

import chip_smoke as c
from sparse_vision_tpu_torch.ops import fused_sae

ORDER = ("pair", "tc", "tc", "pair")


def main() -> int:
    smi = c.phase_device()
    c.phase_build()
    rule = fused_sae.bwd_route

    def tc_route(c_in, c_out, levels=1, act="relu", dtype=torch.bfloat16):
        """The rule with the SAEs' "pair" answered "tc"."""
        route = rule(c_in, c_out, levels, act, dtype)
        return "tc" if act == "sae" and route == "pair" else route

    out = []
    try:
        for name in ("sae_mlp", "matryoshka_sae"):
            for route in ORDER:
                fused_sae.bwd_route = rule if route == "pair" else tc_route
                kept = {}
                got, _, _ = c.phase_slice(name, on_pipeline=lambda p: kept.update(pipe=p))
                t = kept.pop("pipe").train_timing[0]
                tps = t["tokens"] / t["seconds"]
                c.log(f"[route slices] {name} route {route}: {tps:.0f} tokens/s; launches {got}")
                out.append(dict(name=name, route=route, tokens_per_sec=tps, launches=got))
                torch.cuda.empty_cache()
    finally:
        fused_sae.bwd_route = rule
    print(json.dumps({"route_slices": out}))
    print(smi)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
