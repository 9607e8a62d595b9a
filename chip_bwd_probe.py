"""Where the bf16 backwards' time goes, on one NVIDIA GPU, in about three minutes
with the builds: the transcoder's held route (csrc/coder.cuh coder_bwd_held, two
launches: pass E holds dW_enc, pass D dW_dec) beside the in-place body
coder_bwd_tc on the same launch, coder_bwd_tc itself at the ReLU SAE's C 256,
and the JumpReLU, ReLU and gated backwards' cluster pair (coder_bwd_pair: two
CTAs a latent block, E holding dW_enc, D dW_dec) beside coder_bwd_tc on the
same launch.

    python3 chip_bwd_probe.py [--rows 'row 18,row 7'] [--variants pair_gated_no_products]
                              [--acts gated]

Builds the sources as they are and ablated copies of coder.cuh (made by text
substitution under _smoke_work/bwd_probe/, which .gitignore lists; an
ablation's outputs are wrong by design and are never checked):
  no_products      the held passes with every TMA load, barrier and epilogue
                   kept and no wgmma issued: what the loads and the chain cost;
  one_set          one A-fragment set (kHeldSets 1): every register-A product
                   waited on before the next tile's fragments load;
  tc_no_products   coder_bwd_tc with every tile, barrier, epilogue and dW
                   update kept and no wgmma issued: the tile chain's cost
                   apart from the products;
  tc_no_updates    coder_bwd_tc with every product and drain kept and no dW
                   tile read back or written (update_pairs and phase C's
                   read-modify-write skipped): the in-place updates' share;
  pair_no_products coder_bwd_pair with every load, exchange, barrier and
                   epilogue kept and no wgmma issued: whether the exchange
                   chain or the products set the pair's pace;
  pair_release_cluster  coder_bwd_pair with its remote arrivals on the
                   peer's empty barriers at release.cluster semantics in
                   place of the default: what a cluster-scope release costs;
  pair_relu_no_products  pair_no_products in the SAEs' source, whose
                   coder_bwd_pair<Act::Relu> the ReLU SAE's rows run;
  pair_gated_no_products  pair_no_products in the gated SAE's source
                   (coder_bwd_pair<Act::Gated>: E's one product, D's three):
                   whether the exchange chain or D's products set the gated
                   pair's pace.
Then times, in turns (REPS launches a turn, two turns each), each unsplit: at
PERF.md's row 24 (the transcoder's TP backward at a (2, 2) rank's shard: T
16,384, 256 -> 480, H 8,192) and row 12 (T 32,768, 256 -> 480, H 16,384) the
held route (both passes), pass E alone and pass D alone, as built and in each
held ablation, and coder_bwd_tc as built; at row 16 (sae_mlp's TP backward at
the shard: T 16,384, C 256, H 8,192) and row 2 (T 32,768, C 256, H 16,384)
coder_bwd_tc (route="tc") as built and in each tc ablation, and at row 16
the cluster pair (fused_sae.bwd_route's body there) as built and in
pair_relu_no_products; at row 20 (the JumpReLU TP backward at the shard: T 16,384, C 256,
H 8,192) and row 5 (T 32,768, H 16,384) the cluster pair as built and in its
ablation, and coder_bwd_tc as built on the same launch; at row 18 (the gated
TP backward at the shard: T 16,384, C 256, H 8,192) and row 7 (T 32,768, H
16,384) the gated pair as built and in pair_gated_no_products, and
coder_bwd_tc as built on the same launch. Then the route and
split over widths and shapes (pair_grid: fused_sae.bwd_route gives the pair
every bf16 one-level JumpReLU backward, every ReLU or Matryoshka SAE backward
at C <= 256 and every one-level gated backward at 128 < C <= 256, and
grid_split splits its launches by one dictionary's CTAs): for the JumpReLU
backward, the ReLU SAE's and the gated SAE's (the pair at every width), at C
8, 64, 128,
192 and 256, T 4,096 and 32,768 and H at expansions 2, 16 and 64 (the ReLU
SAE's also with three prefix levels at C 256: the Matryoshka SAE's), the
wrapper's launch on the pair at the rule's split, the pair unsplit and
coder_bwd_tc at its own rule's split (CUDA events, in turns), and each
route's body alone on the device (torch.profiler: where a launch is this
short, the wrapper's host work, not the card, sets the wall time); and at T
4,096 and 16,384, H 512 and 2,048, C 64 and 256, one dictionary and a sweep of
8, the JumpReLU pair body's own device time (torch.profiler) at the rule's
split and unsplit. Prints one JSON line of the times (each one's share of its
row's base: the held route, the pair, or coder_bwd_tc at the ReLU SAE's tc
rows; the grids' milliseconds), then nvidia-smi's name and power limit.
"""

from __future__ import annotations

import argparse
import json
import shutil
import subprocess
import time
from pathlib import Path

import torch

import chip_smoke as c
from sparse_vision_tpu_torch.ops import (
    fused_gated_sae,
    fused_jumprelu_sae,
    fused_matryoshka_sae,
    fused_sae,
    fused_sae_tp,
    fused_transcoder,
    native,
)

WORK = Path(__file__).resolve().parent / "_smoke_work" / "bwd_probe"
REPS = 20
# each body an ablation edits: where its text starts and ends in coder.cuh, and
# the source whose library the probe builds and times for it
BODIES = {"held": ("coder_bwd_held(const __grid_constant__", "// Backward, bf16, cluster pair",
                   "fused_transcoder"),
          "tc": ("coder_bwd_tc(const __grid_constant__",
                 "// Backward, bf16, gradient tiles held in registers", "fused_sae"),
          "pair": ("coder_bwd_pair(const __grid_constant__", "bool bad_shape(int n_tokens",
                   "fused_jumprelu_sae"),
          # the same body's Act::Relu instantiation, in the SAEs' source
          "pair_relu": ("coder_bwd_pair(const __grid_constant__", "bool bad_shape(int n_tokens",
                        "fused_sae"),
          # and its Act::Gated one, in the gated SAE's
          "pair_gated": ("coder_bwd_pair(const __grid_constant__", "bool bad_shape(int n_tokens",
                         "fused_gated_sae")}
# (body, [(old, new, count)]) of each ablation: substitutions in the body's
# text or (with a leading "=") in the constants above it
VARIANTS = {
    "no_products": ("held", [
        ("wgmma_ss<0, 1>(pre,", "if (false) wgmma_ss<0, 1>(pre,", 1),
        ("wgmma_rs<0>(dp, a[kk]", "if (false) wgmma_rs<0>(dp, a[kk]", 1),
        ("wgmma_rs<1>(g[p], a[kk]", "if (false) wgmma_rs<1>(g[p], a[kk]", 1),
        ("wgmma_ss<1, 1>(g[p],", "if (false) wgmma_ss<1, 1>(g[p],", 1)]),
    "one_set": ("held", [("=constexpr int kHeldSets = 2;", "constexpr int kHeldSets = 1;", 1)]),
    "tc_no_products": ("tc", [
        ("wgmma_rs<0>(d, af[kk]", "if (false) wgmma_rs<0>(d, af[kk]", 1),
        ("wgmma_ss<0, 1>(pre,", "if (false) wgmma_ss<0, 1>(pre,", 1),
        ("wgmma_ss<1, 1>(g,", "if (false) wgmma_ss<1, 1>(g,", 1),
        ("wgmma_rs<1>(g, af[kk]", "if (false) wgmma_rs<1>(g, af[kk]", 1)]),
    "tc_no_updates": ("tc", [
        ("      update_pairs(", "      if (false) update_pairs(", 1),
        ("prev[j][h][e] = first || col + 8 * h >= Cout ? 0.f : dwd[o];",
         "prev[j][h][e] = 0.f;", 1),
        ("if (col + 8 * h < Cout) dwd[o] = prev[j][h][e] + g[j][2 * h + e];",
         "if (false) dwd[o] = prev[j][h][e] + g[j][2 * h + e];", 1)]),
    "pair_no_products": ("pair", [
        ("wgmma_ss<1, 0>(acc,", "if (false) wgmma_ss<1, 0>(acc,", 1),
        ("wgmma_ss<0, 0>(acc,", "if (false) wgmma_ss<0, 0>(acc,", 1),
        ("wgmma_ss<1, 0>(g[q],", "if (false) wgmma_ss<1, 0>(g[q],", 1)]),
    "pair_release_cluster": ("pair", [
        ("=mbarrier.arrive.shared::cluster.b64 _, [%0];",
         "mbarrier.arrive.release.cluster.shared::cluster.b64 _, [%0];", 1)]),
    "pair_relu_no_products": ("pair_relu", [
        ("wgmma_ss<1, 0>(acc,", "if (false) wgmma_ss<1, 0>(acc,", 1),
        ("wgmma_ss<0, 0>(acc,", "if (false) wgmma_ss<0, 0>(acc,", 1),
        ("wgmma_ss<1, 0>(g[q],", "if (false) wgmma_ss<1, 0>(g[q],", 1)]),
    "pair_gated_no_products": ("pair_gated", [
        ("wgmma_ss<1, 0>(acc,", "if (false) wgmma_ss<1, 0>(acc,", 1),
        ("wgmma_ss<0, 0>(acc,", "if (false) wgmma_ss<0, 0>(acc,", 1),
        ("wgmma_ss<1, 0>(g[q],", "if (false) wgmma_ss<1, 0>(g[q],", 1)]),
}
# the transcoder wrappers' route names: both passes, pass E alone, pass D alone
PASSES = {"held": "held", "E": "held E", "D": "held D"}


def _ablate(text: str, name: str) -> str:
    """coder.cuh with VARIANTS[name]'s body ablated as it says."""
    body_name, subs = VARIANTS[name]
    start, end, _ = BODIES[body_name]
    i0 = text.index(start)
    i1 = text.index(end, i0)
    head, body, tail = text[:i0], text[i0:i1], text[i1:]
    for old, new, count in subs:
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
    """{variant: {source: library path}} (the source its body's BODIES entry
    names), every nvcc started together."""
    shutil.rmtree(WORK, ignore_errors=True)
    procs, libs = [], {}
    for v in variants:
        src = WORK / v / "csrc"
        shutil.copytree(native.CSRC_DIR, src)
        (src / "coder.cuh").write_text(_ablate((src / "coder.cuh").read_text(), v))
        name = BODIES[VARIANTS[v][0]][2]
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
            if ("coder_bwd_held" in kernel or "coder_bwd_tc<true, Act::Relu" in kernel
                    or "coder_bwd_pair" in kernel):
                c.log(f"[probe] {v}: {regs} registers, {spill} spill bytes: {kernel}")
    return libs


_own_path = native.library_path


def use(libs: dict | None) -> None:
    """Load the ablated libraries (None: the package's own builds)."""
    native.load.cache_clear()
    fused_transcoder._lib.cache_clear()
    fused_sae._lib.cache_clear()
    fused_jumprelu_sae._lib.cache_clear()
    fused_gated_sae._lib.cache_clear()
    native.library_path = (_own_path if libs is None
                           else (lambda name: libs.get(name) or _own_path(name)))


# pair_grid's shapes: widths, expansions (H = C times it, at least 128, in
# multiples of 128) and token counts of the route grid; (T, H, C) of the split
# grid, each at one dictionary and at a sweep of SPLIT_N
GRID_C = (8, 64, 128, 192, 256)
GRID_EXP = (2, 16, 64)
GRID_T = (4096, 32768)
SPLIT_SHAPES = [(t, h, c_) for t in (4096, 16384) for h in (512, 2048) for c_ in (64, 256)]
SPLIT_N = 8


def _jump_ops(t: int, c_: int, h: int, n: int = 0) -> tuple:
    """A bf16 JumpReLU backward's operands on chip_smoke.py's dyadic grid: one
    dictionary (n 0) or a sweep of n combos."""
    if n:
        ops = c._sweep_ops("jumprelu_sae", torch.bfloat16, n, t, c_, h)
        return c._sweep_bwd_ops("jumprelu_sae", torch.bfloat16, ops, None,
                                fused_jumprelu_sae.jumprelu_sweep_fwd_plain(*ops))
    gen = torch.Generator(device=c.DEVICE).manual_seed(c_ + h)
    return c._pair_ops(gen, t, c_, h, torch.bfloat16)


def levels_of(h: int) -> tuple:
    """Three prefix levels of H latents in multiples of 128, near the default
    prefixes' 1/16 and 1/4 (the Matryoshka SAE's shape in the SAE grid)."""
    q1 = max(128, -(-h // 16 // 128) * 128)
    q2 = max(q1 + 128, -(-h // 4 // 128) * 128)
    return q1, q2, h


def _sae_ops(t: int, c_: int, h: int, levels: tuple | None = None) -> tuple:
    """A bf16 ReLU SAE backward's operands on chip_smoke.py's dyadic grid
    (x_cent, W_enc, b_enc, W_dec, the rounded error, coeffs), or the
    Matryoshka SAE's at ``levels`` (its suffix-weighted S, coeffs (1, c_l1),
    the levels)."""
    bf = torch.bfloat16
    gen = torch.Generator(device=c.DEVICE).manual_seed(c_ + h + 1)
    x, we, be, wd, bd = c._sae_ops(gen, t, c_, h, bf)
    x_cent = x - bd.to(bf)
    lam = c.LAMBDA / (t * h)
    if levels is None:
        res = (fused_sae.fused_sae_forward_plain(x, we, be, wd, bd)[0] - x.float()).to(bf)
        return (x_cent, we, be, wd, res, torch.tensor([2.0 / (t * c_), lam], device=c.DEVICE))
    prefix = fused_matryoshka_sae.fused_matryoshka_forward_plain(x, we, be, wd, bd, levels)[0]
    return (x_cent, we, be, wd, c._suffix_error(prefix, x, bf),
            torch.tensor([1.0, lam], device=c.DEVICE), levels)


def _gated_ops(t: int, c_: int, h: int) -> tuple:
    """A bf16 gated backward's operands on chip_smoke.py's dyadic grid (its
    forward's plain version gives the errors)."""
    gen = torch.Generator(device=c.DEVICE).manual_seed(c_ + h + 2)
    ops = c._gated_pair_ops(gen, t, c_, h, torch.bfloat16, 0)
    return c._gated_bwd_operands(ops, t, c_, h)


# pair_grid's epilogues: the JumpReLU backward's, the ReLU SAE's (the
# Matryoshka SAE's where the shape has levels) and the gated SAE's, each with
# its wrapper
GRID_ACTS = ("jump", "sae", "gated")


def pair_grid(act: str) -> tuple:
    """The route grid of ``act`` (the wrapper's ms on the pair at the rule's
    split, the pair unsplit where the rule splits, coder_bwd_tc at its rule's
    split; two turns, the second in reverse order; and the two bodies' own
    device ms at the rule's splits) and, for the JumpReLU backward, the split
    grid (the pair body's device ms at the rule's split and unsplit, one
    dictionary and SPLIT_N)."""
    n_sm = fused_sae.sm_count(torch.cuda.current_device())
    grid, split = [], []
    shapes = sorted({(t, c_, max(128, -(-c_ * e // 128) * 128), None)
                     for c_ in GRID_C for e in GRID_EXP for t in GRID_T},
                    key=lambda s: (s[1], s[2], s[0]))
    if act == "sae":  # the Matryoshka SAE's levels at the widest pair
        shapes += [(t, 256, h, levels_of(h)) for t in GRID_T
                   for h in sorted({256 * e for e in GRID_EXP})]
    with torch.no_grad():
        for t, c_, h, lv in shapes:
            if act == "jump":
                assert fused_sae.bwd_route(c_, c_, act="jump") == "pair"
                k, a = fused_jumprelu_sae.bwd_kernel, _jump_ops(t, c_, h)
            elif act == "gated":  # the pair at every width: the rule keeps tc at C <= 128
                k, a = fused_gated_sae.bwd_kernel, _gated_ops(t, c_, h)
            else:
                assert fused_sae.bwd_route(c_, c_, len(lv or (h,)), act="sae") == "pair"
                k = fused_sae.bwd_kernel if lv is None else fused_matryoshka_sae.bwd_kernel
                a = _sae_ops(t, c_, h, lv)
            sp = fused_sae.grid_split(t, h, c_, backward=True, n_sm=n_sm, pair=True)
            st = fused_sae.grid_split(t, h, c_, backward=True, n_sm=n_sm)
            fns = {"pair": lambda: k(*a, route="pair"), "tc": lambda: k(*a, route="tc")}
            if sp > 1:
                fns["pair unsplit"] = lambda: k(*a, n_split=1, route="pair")
            ms = dict.fromkeys(fns, 0.0)
            for order in (list(fns), list(fns)[::-1]):
                for name in order:
                    ms[name] += c.time_ms(fns[name], REPS) / 2
            body = {name: c._body_ms(fns[name], f"coder_bwd_{name}<", REPS)
                    for name in ("pair", "tc")}
            row = dict(act=act, t=t, c=c_, h=h, levels=lv, pair_split=sp, tc_split=st, **ms,
                       **{f"{k} body": v for k, v in body.items()})
            c.log(f"[grid {act}] T={t} C={c_} H={h}" + (f" levels {lv}" if lv else "")
                  + f": pair (split {sp}) {ms['pair']:.4f} ms, "
                  + (f"unsplit {ms['pair unsplit']:.4f}, " if sp > 1 else "")
                  + f"coder_bwd_tc (split {st}) {ms['tc']:.4f} ({ms['tc'] / ms['pair']:.2f}x); "
                  f"bodies on the device {body['pair']:.4f} / {body['tc']:.4f} "
                  f"({body['tc'] / body['pair']:.2f}x)")
            grid.append(row)
            del a
            torch.cuda.empty_cache()
        k = fused_jumprelu_sae.bwd_kernel
        for t, h, c_ in SPLIT_SHAPES if act == "jump" else ():
            sp = fused_sae.grid_split(t, h, c_, backward=True, n_sm=n_sm, pair=True)
            for n, kern in ((0, k), (SPLIT_N, fused_jumprelu_sae.sweep_bwd_kernel)):
                a = _jump_ops(t, c_, h, n)
                ms = {s: c._body_ms(lambda s=s: kern(*a, n_split=s), "coder_bwd_pair<", REPS)
                      for s in sorted({1, sp})}
                split.append(dict(t=t, c=c_, h=h, n=max(n, 1), split=sp, body_ms=ms))
                c.log(f"[grid] split N={max(n, 1)} T={t} C={c_} H={h}: coder_bwd_pair "
                      + ", ".join(f"split {s} {v:.4f} ms" for s, v in ms.items()))
                del a
    return grid, split


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--rows", help="comma-separated rows to time (default: all), e.g. "
                                   "'row 18,row 7'")
    ap.add_argument("--variants", help="comma-separated ablations to build (default: all)")
    ap.add_argument("--acts", help="comma-separated pair_grid epilogues (default: GRID_ACTS)")
    args = ap.parse_args()
    variants = args.variants.split(",") if args.variants else list(VARIANTS)
    acts = args.acts.split(",") if args.acts else list(GRID_ACTS)
    t0 = time.perf_counter()
    smi = c.phase_device()
    native.build(sorted({b[2] for b in BODIES.values()}))
    libs = build(variants)
    c.log(f"[probe] builds in {time.perf_counter() - t0:.1f} s")
    gen = torch.Generator(device="cuda").manual_seed(0)
    bf = torch.bfloat16

    def ops(t, h, c_out):
        x = torch.randn(t, 256, device="cuda", generator=gen).to(bf)
        we = (0.05 * torch.randn(256, h, device="cuda", generator=gen)).to(bf)
        be = 0.01 * torch.randn(h, device="cuda", generator=gen)
        wd = (0.05 * torch.randn(h, c_out, device="cuda", generator=gen)).to(bf)
        err = torch.randn(t, c_out, device="cuda", generator=gen).to(bf)
        return x, we, be, wd, err, torch.tensor([1e-3, 1e-4], device="cuda")

    def jops(t, h):
        """The JumpReLU backward's operands at C 256: pre of std ~1, thresholds
        around 1, an f32 error, (c_rec, c_l0) and the bandwidth."""
        x, we, be, wd, _, _ = ops(t, h, 256)
        thr = 0.5 + torch.rand(h, device="cuda", generator=gen)
        bd = 0.1 * torch.randn(256, device="cuda", generator=gen)
        err = torch.randn(t, 256, device="cuda", generator=gen)
        return (x, 4 * we, be, thr, wd, bd, err, torch.tensor([1e-3, 1e-4], device="cuda"),
                1.0)

    out = {}
    with torch.no_grad():
        # row: (body, wrapper, operands); the held rows' wrappers take a route
        rows = {"row 24": ("held", fused_transcoder.tp_bwd_kernel, ops(16384, 8192, 480)),
                "row 12": ("held", fused_transcoder.bwd_kernel, ops(32768, 16384, 480)),
                "row 16": ("tc", fused_sae_tp.bwd_kernel, ops(16384, 8192, 256)),
                "row 2": ("tc", fused_sae.bwd_kernel, ops(32768, 16384, 256)),
                "row 16 pair": ("pair_relu", fused_sae_tp.bwd_kernel, ops(16384, 8192, 256)),
                "row 20": ("pair", fused_sae_tp.jumprelu_bwd_kernel, jops(16384, 8192)),
                "row 5": ("pair", fused_jumprelu_sae.bwd_kernel, jops(32768, 16384)),
                "row 18": ("pair_gated", fused_sae_tp.gated_bwd_kernel,
                           _gated_ops(16384, 256, 8192)),
                "row 7": ("pair_gated", fused_gated_sae.bwd_kernel,
                          _gated_ops(32768, 256, 16384))}
        if args.rows:
            rows = {r: rows[r] for r in args.rows.split(",")}
        points = [("as is", None)] + [(v, libs[v]) for v in variants]
        times = {r: {} for r in rows}
        for turn in range(2):
            for p, lib in (points if turn == 0 else points[::-1]):
                use(lib)
                for r, (body, k, a) in rows.items():
                    if lib is not None and VARIANTS[p][0] != body:
                        continue
                    if body == "held":
                        routes = {f"{p} {q}": route for q, route in PASSES.items()}
                        if lib is None:
                            routes["tc"] = "tc"
                    elif body.startswith("pair"):  # the wrapper's own route, the pair
                        routes = {f"{p} pair": None}
                        if lib is None:
                            routes["tc"] = "tc"
                    else:
                        routes = {f"{p} tc": "tc"}
                    for name, route in routes.items():
                        kw = {} if route is None else {"route": route}
                        times[r].setdefault(name, []).append(c.time_ms(
                            lambda: k(*a, n_split=1, **kw), REPS))
        use(None)
        for r, (body, _, _) in rows.items():
            base = sum(times[r][f"as is {'pair' if body.startswith('pair') else body}"]) / 2
            out[r] = {p: {"ms": sum(v) / 2, "share": sum(v) / 2 / base}
                      for p, v in times[r].items()}
            c.log(f"[probe] {r}: " + ", ".join(f"{p} {v['ms']:.3f} ms ({v['share']:.3f})"
                                              for p, v in out[r].items()))
    grid, split = [], []
    for act in acts:
        g, sp = pair_grid(act)
        grid += g
        split += sp
    print(json.dumps({"bwd_probe": out, "pair_grid": grid, "pair_split": split}))
    print(smi)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
