"""Where the bf16 transcoder backward's time goes, on one NVIDIA GPU, in about
two minutes with the builds: the held route (csrc/coder.cuh coder_bwd_held, two
launches: pass E holds dW_enc, pass D dW_dec) beside the in-place body
coder_bwd_tc on the same launch.

    python3 chip_bwd_probe.py

Builds the sources as they are and ablated copies of coder.cuh (made by text
substitution under _smoke_work/bwd_probe/, which .gitignore lists; an
ablation's outputs are wrong by design and are never checked):
  no_products   the held passes with every TMA load, barrier and epilogue
                kept and no wgmma issued: what the loads and the chain cost;
  one_set       one A-fragment set (kHeldSets 1): every register-A product
                waited on before the next tile's fragments load.
Then times, in turns (REPS launches a turn, two turns each), at PERF.md's row
24 (the transcoder's TP backward at a (2, 2) rank's shard: T 16,384, 256 ->
480, H 8,192) and row 12 (T 32,768, 256 -> 480, H 16,384), each unsplit: the
held route (both passes), pass E alone and pass D alone, each as built and in
each ablated copy, and coder_bwd_tc as built. (The sae_mlp rows, C 256, keep
coder_bwd_tc: fused_sae.bwd_route.) Prints one JSON line of the times (each
one's share of the held route's), then nvidia-smi's name and power limit.
"""

from __future__ import annotations

import json
import shutil
import subprocess
import time
from pathlib import Path

import torch

import chip_smoke as c
from sparse_vision_tpu_torch.ops import fused_transcoder, native

WORK = Path(__file__).resolve().parent / "_smoke_work" / "bwd_probe"
SOURCES = ("fused_transcoder",)
REPS = 20
# (old, new, count) substitutions of each ablation: in coder_bwd_held's body,
# or (with a leading "=") in the constants above it
VARIANTS = {
    "no_products": [("wgmma_ss<0, 1>(pre,", "if (false) wgmma_ss<0, 1>(pre,", 1),
                    ("wgmma_rs<0>(dp, a[kk]", "if (false) wgmma_rs<0>(dp, a[kk]", 1),
                    ("wgmma_rs<1>(g[p], a[kk]", "if (false) wgmma_rs<1>(g[p], a[kk]", 1),
                    ("wgmma_ss<1, 1>(g[p],", "if (false) wgmma_ss<1, 1>(g[p],", 1)],
    "one_set": [("=constexpr int kHeldSets = 2;", "constexpr int kHeldSets = 1;", 1)],
}
# the wrappers' route names: both passes, pass E alone, pass D alone
PASSES = {"held": "held", "E": "held E", "D": "held D"}


def _ablate(text: str, name: str) -> str:
    """coder.cuh with the held passes ablated as VARIANTS[name] says."""
    i0 = text.index("coder_bwd_held(const __grid_constant__")
    i1 = text.index("bool bad_shape(int n_tokens")
    head, body, tail = text[:i0], text[i0:i1], text[i1:]
    for old, new, count in VARIANTS[name]:
        in_head = old.startswith("=")
        old = old.lstrip("=")
        part = head if in_head else body
        if part.count(old) != count:
            raise AssertionError(f"{name}: {old!r} found {part.count(old)} times, not {count}")
        if in_head:
            head = head.replace(old, new)
        else:
            body = body.replace(old, new)
    return head + body + tail


def build(variants) -> dict:
    """{variant: {source: library path}}, every nvcc started together."""
    shutil.rmtree(WORK, ignore_errors=True)
    procs, libs = [], {}
    for v in variants:
        src = WORK / v / "csrc"
        shutil.copytree(native.CSRC_DIR, src)
        (src / "coder.cuh").write_text(_ablate((src / "coder.cuh").read_text(), v))
        for name in SOURCES:
            out = WORK / v / f"lib{name}.so"
            libs.setdefault(v, {})[name] = out
            cmd = [native._nvcc(), *native.NVCC_FLAGS, "-o", str(out),
                   str(src / native.SOURCES[name])]
            procs.append((v, subprocess.Popen(cmd, stdout=subprocess.PIPE,
                                              stderr=subprocess.STDOUT, text=True)))
    for v, p in procs:
        log, _ = p.communicate()
        if p.returncode:
            raise RuntimeError(f"nvcc failed for {v}:\n{log}")
        for kernel, regs, spill in c._ptxas_kernels(log):
            if "held" in kernel:
                c.log(f"[probe] {v}: {regs} registers, {spill} spill bytes: {kernel}")
    return libs


_own_path = native.library_path


def use(libs: dict | None) -> None:
    """Load the ablated libraries (None: the package's own builds)."""
    native.load.cache_clear()
    fused_transcoder._lib.cache_clear()
    native.library_path = (_own_path if libs is None else (lambda name: libs[name]))


def main() -> int:
    t0 = time.perf_counter()
    smi = c.phase_device()
    native.build(list(SOURCES))
    libs = build(VARIANTS)
    c.log(f"[probe] builds in {time.perf_counter() - t0:.1f} s")
    gen = torch.Generator(device="cuda").manual_seed(0)
    bf = torch.bfloat16

    def ops(t, h):
        x = torch.randn(t, 256, device="cuda", generator=gen).to(bf)
        we = (0.05 * torch.randn(256, h, device="cuda", generator=gen)).to(bf)
        be = 0.01 * torch.randn(h, device="cuda", generator=gen)
        wd = (0.05 * torch.randn(h, 480, device="cuda", generator=gen)).to(bf)
        err = torch.randn(t, 480, device="cuda", generator=gen).to(bf)
        return x, we, be, wd, err, torch.tensor([1e-3, 1e-4], device="cuda")

    out = {}
    with torch.no_grad():
        rows = {"row 24": (fused_transcoder.tp_bwd_kernel, ops(16384, 8192)),
                "row 12": (fused_transcoder.bwd_kernel, ops(32768, 16384))}
        points = [("as is", None)] + [(v, libs[v]) for v in VARIANTS]
        times = {r: {} for r in rows}
        for turn in range(2):
            for p, lib in (points if turn == 0 else points[::-1]):
                use(lib)
                for r, (k, a) in rows.items():
                    routes = {f"{p} {q}": route for q, route in PASSES.items()}
                    if lib is None:
                        routes["tc"] = "tc"
                    for name, route in routes.items():
                        times[r].setdefault(name, []).append(c.time_ms(
                            lambda: k(*a, n_split=1, route=route), REPS))
        use(None)
        for r in rows:
            base = sum(times[r]["as is held"]) / 2
            out[r] = {p: {"ms": sum(v) / 2, "share": sum(v) / 2 / base}
                      for p, v in times[r].items()}
            c.log(f"[probe] {r}: " + ", ".join(f"{p} {v['ms']:.3f} ms ({v['share']:.3f})"
                                              for p, v in out[r].items()))
    print(json.dumps({"bwd_probe": out}))
    print(smi)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
