"""Where the bf16 backward body's time goes (csrc/coder.cuh coder_bwd_tc), on
one NVIDIA GPU, in about two minutes with the builds.

    python3 chip_bwd_probe.py

Builds the body as it is and three ablated copies of its sources (made by
text substitution under _smoke_work/bwd_probe/, which .gitignore lists; their
outputs are wrong by design and are never checked):
  no_update     phase B and C products kept, the in-place dW updates left out;
  no_products   every TMA load and barrier kept, no wgmma issued;
  half_tokens   every other latent block loads no x or err box (its full
                barriers count only its W tiles), halving the token tiles'
                traffic from L2 to the SMs.
Then times each beside the body as it is, in turns (20 launches a turn, two
turns each), at PERF.md's row 24 (the transcoder's TP backward at a (2, 2)
rank's shard: T 16,384, 256 -> 480, H 8,192, unsplit), row 12 (T 32,768, H
16,384) and row 32 (the JumpReLU sweep backward, N 8 of T 4,096, C 256, H
2,048, split in 4). Prints one JSON line of the times and each one's share of
the unablated time, then nvidia-smi's name and power limit.
"""

from __future__ import annotations

import json
import shutil
import subprocess
import time
from pathlib import Path

import torch

import chip_smoke as c
import chip_split_checks as cs
from sparse_vision_tpu_torch.ops import fused_jumprelu_sae, fused_transcoder, native

WORK = Path(__file__).resolve().parent / "_smoke_work" / "bwd_probe"
SOURCES = ("fused_transcoder", "fused_jumprelu_sae")
REPS = 20


def _ablate(text: str, name: str) -> str:
    """coder.cuh with coder_bwd_tc ablated as ``name`` says."""
    i0 = text.index("coder_bwd_tc(const __grid_constant__")
    i1 = text.index("bool bad_shape(int n_tokens")
    body = text[i0:i1]

    def sub(old: str, new: str, count: int) -> None:
        nonlocal body
        if body.count(old) != count:
            raise AssertionError(f"{name}: {old!r} found {body.count(old)} times, not {count}")
        body = body.replace(old, new)

    if name == "no_update":
        sub("      update_pairs(\n", "      if (false) update_pairs(\n", 1)
        sub("prev[j][h][e] = first || col + 8 * h >= Cout ? 0.f : dwd[o];",
            "prev[j][h][e] = 0.f;", 1)
        sub("if (col + 8 * h < Cout) dwd[o] =", "if (false) dwd[o] =", 1)
    elif name == "no_products":
        for call in ("wgmma_ss<0, 1>(pre,", "wgmma_rs<0>(d, af[kk]", "wgmma_ss<1, 1>(g,",
                     "wgmma_rs<1>(g, af[kk]"):
            sub(call, "if (false) " + call, 1)
    elif name == "half_tokens":
        sub("  auto issue = [&]() {\n", "  const bool skip = blk.x & 1;\n  auto issue = [&]() {\n", 1)
        for box in ("tma_box(d, mx, prod.bar", "tma_box(d + kBox, mx, prod.bar",
                    "tma_box(d, merr, prod.bar", "tma_box(d + kBox, merr, prod.bar"):
            sub(box, "if (!skip) " + box, 2)
        sub("prod.acquire(3 * kBox)", "prod.acquire(skip ? kBox : 3 * kBox)", 1)
        sub("prod.acquire(2 * kBox)", "prod.acquire(skip ? 0 : 2 * kBox)", 1)
    else:
        raise ValueError(name)
    return text[:i0] + body + text[i1:]


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
    return libs


def use(libs: dict | None) -> None:
    """Load the ablated libraries (None: the package's own builds)."""
    native.load.cache_clear()
    fused_transcoder._lib.cache_clear()
    fused_jumprelu_sae._lib.cache_clear()
    native.library_path = (_own_path if libs is None else (lambda name: libs[name]))


_own_path = native.library_path


def main() -> int:
    t0 = time.perf_counter()
    smi = c.phase_device()
    native.build(list(SOURCES))
    variants = ("no_update", "no_products", "half_tokens")
    libs = build(variants)
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
        a24, a12 = ops(16384, 8192), ops(32768, 16384)
        k32, b32 = cs._sweep_bwd("jumprelu_sae", 8, 4096)
        rows = {"row 24": lambda: fused_transcoder.tp_bwd_kernel(*a24),
                "row 12": lambda: fused_transcoder.bwd_kernel(*a12),
                "row 32": lambda: k32(*b32)}
        points = [("as is", None)] + [(v, libs[v]) for v in variants]
        times = {r: {p: [] for p, _ in points} for r in rows}
        for turn in range(2):
            for p, lib in (points if turn == 0 else points[::-1]):
                use(lib)
                for r, fn in rows.items():
                    times[r][p].append(c.time_ms(fn, REPS))
        use(None)
        for r in rows:
            base = sum(times[r]["as is"]) / 2
            out[r] = {p: {"ms": sum(v) / 2, "share": sum(v) / 2 / base}
                      for p, v in times[r].items()}
            c.log(f"[probe] {r}: " + ", ".join(f"{p} {v['ms']:.3f} ms ({v['share']:.3f})"
                                              for p, v in out[r].items()))
    print(json.dumps({"bwd_probe": out}))
    print(smi)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
