"""The grid split of the bf16 coder bodies (sparse_vision_tpu_torch/csrc/coder.cuh,
"Splits"): the rule that picks the number of splits (ops/fused_sae.grid_split)
and the wrappers that pass it to the C entry points.

The split changes how a launch is cut on the card, not what it computes, and
the JAX package has nothing like it (its Pallas grids run in order on one
core), so these tests hold the port to its own contract:
- the rule at the shapes of PERF.md's kernel table (rows 1-34) and of
  chip_smoke.py phase 12's widths, on a card of 132 SMs: no split where a
  dictionary's grid fills the card (rows 1-24), 2 at the crosscoder's (2, 2)
  rank shard (rows 25-26), 4 at 32 and 96 latent blocks;
- its invariants over a grid of shapes: a split keeps at least two 512-token
  steps (backward) or one 512-latent group (forward), the splits' ranges as
  the bodies compute them cover every step or group once, a grid of at least
  120 of the 132 SMs' blocks is not split, and the register-held forwards
  (C_out <= 512) never are;
- every wrapper, given CPU tensors and a stand-in library that checks and
  records each call, passes one dictionary's split whatever the sweep's N (so
  a combo runs as a one-dictionary launch), a split workspace exactly when it
  splits, and returns the unsplit shapes;
- the argtypes of every C entry point match its declaration in csrc/, the
  forward and backward entry points ending in (..., n_split, stream) and the
  backwards taking split_ws.
The kernels themselves run only on the card (chip_smoke.py holds each split
launch to its plain version there).
"""

import contextlib
import ctypes
import re
from pathlib import Path

import pytest
import torch

from sparse_vision_tpu_torch.ops import (
    fused_crosscoder,
    fused_gated_sae,
    fused_jumprelu_sae,
    fused_matryoshka_sae,
    fused_sae,
    fused_transcoder,
    native,
)
from sparse_vision_tpu_torch.ops.fused_sae import grid_split

torch.set_num_threads(1)

N_SM = 132  # an H100 SXM

# (label, T, H, C_out, backward) -> the split; PERF.md section 6's rows (one
# dictionary's shape: the sweep rows 27-34 a combo's) and phase 12's widths
TABLE = {
    "rows 1-10 forward (T 32,768, C 256, H 16,384)": (32768, 16384, 256, False, 1),
    "rows 1-10 backward": (32768, 16384, 256, True, 1),
    "rows 11-12 forward (256 -> 480)": (32768, 16384, 480, False, 1),
    "rows 11-12 backward": (32768, 16384, 480, True, 1),
    "rows 13-14 forward (T 16,384, ΣC 2,896, H 8,192)": (16384, 8192, 2896, False, 1),
    "rows 13-14 backward": (16384, 8192, 2896, True, 1),
    "rows 15-22 forward (shard T 16,384, C 256, H 8,192)": (16384, 8192, 256, False, 1),
    "rows 15-22 backward": (16384, 8192, 256, True, 1),
    "rows 23-24 forward (shard 256 -> 480)": (16384, 8192, 480, False, 1),
    "rows 23-24 backward": (16384, 8192, 480, True, 1),
    "row 25 (crosscoder TP forward, T 8,192, H 4,096)": (8192, 4096, 2896, False, 2),
    "row 26 (crosscoder TP backward)": (8192, 4096, 2896, True, 2),
    "rows 27, 29, 31, 33 (sweep forwards, T 4,096, C 256, H 2,048)": (4096, 2048, 256, False, 1),
    "rows 28, 30, 32, 34 (sweep backwards)": (4096, 2048, 256, True, 4),
    "phase 12 SAE C 768 / H 6,144 forward": (32768, 6144, 768, False, 1),
    "phase 12 SAE C 768 / H 6,144 backward (96 blocks)": (32768, 6144, 768, True, 4),
    "phase 12 SAE C 512 / H 4,096 forward": (32768, 4096, 512, False, 1),
    "phase 12 SAE C 512 / H 4,096 backward (64 blocks)": (32768, 4096, 512, True, 2),
    "phase 12 transcoder 768 -> 768 / H 6,144 forward": (32768, 6144, 768, False, 1),
    "phase 12 transcoder 768 -> 768 / H 6,144 backward": (32768, 6144, 768, True, 4),
    "the crosscoder's (2,) shard forward (T 8,192, H 8,192)": (8192, 8192, 2896, False, 2),
    "the crosscoder's (2,) shard backward": (8192, 8192, 2896, True, 1),
    # chip_smoke.kernels_coder_ragged's held transcoder launches (ROADMAP C8):
    # C_in 136 -> C_out 264 at H 640 whole and split, phase 10's mixed3a ->
    # mixed3b (H 2,048) split in 3
    "C8 held backward 136 -> 264, T 1,152 (a partial step)": (1152, 640, 264, True, 1),
    "C8 held backward 136 -> 264, T 2,176": (2176, 640, 264, True, 2),
    "C8 phase 10 mixed3a -> mixed3b backward (T 3,072, H 2,048)": (3072, 2048, 480, True, 3),
}


@pytest.mark.parametrize("label", list(TABLE))
def test_rule_at_table_shapes(label):
    t, h, c_out, backward, want = TABLE[label]
    assert grid_split(t, h, c_out, backward=backward, n_sm=N_SM) == want


def _ranges(n: int, s: int) -> list:
    """The parts of n steps (or groups) that splits 0..s-1 take, as the bodies
    compute them: [z*n/s, (z+1)*n/s)."""
    return [(z * n // s, (z + 1) * n // s) for z in range(s)]


INVARIANT_SHAPES = [
    (t, h, c_out, backward)
    for t in (1152, 2048, 3072, 8192, 16384, 32768)
    for h in (640, 2176, 4096, 6144, 8192, 16384)
    for c_out, backward in ((256, True), (520, False), (768, True), (2896, False))
]


@pytest.mark.parametrize("t,h,c_out,backward", INVARIANT_SHAPES)
def test_rule_invariants(t, h, c_out, backward):
    s = grid_split(t, h, c_out, backward=backward, n_sm=N_SM)
    assert 1 <= s <= fused_sae.MAX_SPLIT
    if backward:
        blocks = h // fused_sae.BLOCK_H
        n = -(-t // fused_sae.BF16_STEP_T)  # token steps
        least = fused_sae.SPLIT_MIN_STEPS
    else:
        blocks = t // fused_sae.FWD_TILE_T
        n = -(-h // fused_sae.FWD_GROUP_H)  # latent groups
        least = 1
    if s > 1:  # each split keeps its minimum work
        assert all(hi - lo >= least for lo, hi in _ranges(n, s))
    # the splits' parts cover every step or group once, in order
    parts = _ranges(n, s)
    assert parts[0][0] == 0 and parts[-1][1] == n
    assert all(a[1] == b[0] for a, b in zip(parts, parts[1:]))
    if 11 * blocks >= 10 * N_SM:  # 120 of 132: a grid that fills the card stays whole
        assert s == 1
    if not backward and c_out <= fused_sae.HOLD_COUT:
        assert s == 1
    # the split depends on one dictionary's shape alone: the same answer at
    # every call, and a sweep's N is not an argument
    assert grid_split(t, h, c_out, backward=backward, n_sm=N_SM) == s


# ---------------------------------------------------------------------------
# the wrappers against a stand-in library
# ---------------------------------------------------------------------------

CSRC = Path(fused_sae.__file__).resolve().parent.parent / "csrc"
# the module that binds each entry point's library, by the entry point's prefix
PREFIX_MODULE = {"svt_sae_": fused_sae, "svt_matryoshka_": fused_matryoshka_sae,
                 "svt_gated_": fused_gated_sae, "svt_jumprelu_": fused_jumprelu_sae,
                 "svt_coder_": fused_transcoder}


def _declarations() -> dict:
    """{entry point: [(C type, name), ...]} of every extern "C" function in csrc/*.cu."""
    out = {}
    for src in sorted(CSRC.glob("*.cu")):
        text = src.read_text()
        for m in re.finditer(r'extern "C" int (svt_\w+)\(([^)]*)\)', text):
            params = [" ".join(p.split()) for p in m.group(2).split(",")]
            out[m.group(1)] = [(p.rsplit(" ", 1)[0], p.rsplit(" ", 1)[1]) for p in params]
    return out


DECLS = _declarations()


def _ctype(c_type: str):
    if "*" in c_type or c_type == "cudaStream_t":
        return ctypes.c_void_p
    return {"int": ctypes.c_int, "float": ctypes.c_float}[c_type]


class _Entry:
    """A stand-in C entry point: argtypes and restype set as on a ctypes
    function; a call checks the arguments' count and kinds against argtypes,
    records them and returns 0 (cudaSuccess) without writing any output."""

    def __init__(self, name: str):
        self.__name__ = name
        self.argtypes = self.restype = None
        self.calls = []

    def __call__(self, *args):
        assert len(args) == len(self.argtypes), (self.__name__, len(args), len(self.argtypes))
        for i, (a, t) in enumerate(zip(args, self.argtypes)):
            if t is ctypes.c_int:
                assert type(a) is int, (self.__name__, i, a)
            elif t is ctypes.c_float:
                assert type(a) is float, (self.__name__, i, a)
            else:
                assert a is None or type(a) is int or isinstance(a, (ctypes.c_void_p,
                                                                     ctypes.Array)), (
                    self.__name__, i, a)
        self.calls.append(args)
        return 0


class _Lib:
    def __getattr__(self, name):
        if not name.startswith("svt_"):
            raise AttributeError(name)
        entry = _Entry(name)
        setattr(self, name, entry)
        return entry


@pytest.fixture
def libs(monkeypatch):
    """Every op module's library replaced by a stand-in, bound by the module's
    own _lib (its argtypes); launches on CPU tensors as on a card of N_SM SMs."""
    loaded = {}
    monkeypatch.setattr(native, "load", lambda name: loaded.setdefault(name, _Lib()))
    bound = {}
    for mod in set(PREFIX_MODULE.values()):
        lib = mod._lib.__wrapped__()
        bound[mod] = lib
        monkeypatch.setattr(mod, "_lib", lambda lib=lib: lib)
    monkeypatch.setattr(torch.cuda, "device", lambda dev: contextlib.nullcontext())
    monkeypatch.setattr(fused_sae, "_stream", lambda dev: ctypes.c_void_p(None))
    monkeypatch.setattr(fused_sae, "sm_count", lambda index: N_SM)
    # the stand-in launches count on the wrappers: restore every count after the test
    for mod in (fused_sae, fused_matryoshka_sae, fused_gated_sae, fused_jumprelu_sae,
                fused_transcoder, fused_crosscoder):
        for k in mod.KERNELS + getattr(mod, "SWEEP_KERNELS", ()):
            monkeypatch.setattr(k, "launches", k.launches)
    return bound


@pytest.mark.parametrize("entry", sorted(DECLS))
def test_argtypes_match_entry_points(libs, entry):
    mod = next(m for p, m in PREFIX_MODULE.items() if entry.startswith(p))
    params = DECLS[entry]
    fn = getattr(libs[mod], entry)
    assert fn.argtypes == [_ctype(t) for t, _ in params], entry
    assert fn.restype is ctypes.c_int
    names = [n for _, n in params]
    if entry.endswith("_dx"):  # the dx route does not split
        assert "n_split" not in names
        return
    if entry.endswith("_clusters"):  # an occupancy query: no launch, no stream
        assert names == ["out"]
        return
    assert names[-2:] == ["n_split", "stream"] and params[-2][0] == "int", entry
    assert ("split_ws" in names) == entry.endswith("_bwd"), entry


# a shape at which both bodies split: the in-place forward (C 520 > 512; T/128
# = 16 blocks, 2 latent groups) and the backward (H/64 = 10 blocks, 4 steps)
ST, SC, SH = 2048, 520, 640
C_IN = 264  # the coders' input width
BOUNDS = (128, 640)  # Matryoshka prefixes
BF16 = torch.bfloat16


def _z(*shape, dtype=torch.float32):
    return torch.zeros(shape, dtype=dtype)


def _weights(n):
    """W_enc, b_enc, W_dec of one dictionary (n 0) or n stacked ones."""
    lead = (n,) if n else ()
    return _z(*lead, SC, SH, dtype=BF16), _z(*lead, SH), _z(*lead, SH, SC, dtype=BF16)


def _launch(name: str, backward: bool, n: int, **kw):
    """One launch of ``name``'s forward or backward wrapper at (ST, SC, SH) on
    zeros: one dictionary (n 0) or a sweep of n combos; ``kw`` to the wrapper."""
    x = _z(ST, SC, dtype=BF16)
    lead = (n,) if n else ()
    if name in ("transcoder", "crosscoder"):  # no sweep kernels: their sweeps are stock
        mod = fused_transcoder if name == "transcoder" else fused_crosscoder
        ops = (_z(ST, C_IN, dtype=BF16), _z(C_IN, SH, dtype=BF16), _z(SH),
               _z(SH, SC, dtype=BF16))
        if not backward:
            return mod.fwd_kernel(*ops, _z(SC), **kw)
        err = _z(ST, SC, dtype=BF16)
        coeffs = (_z(2),) if mod is fused_transcoder else (_z(1), _z(SH))
        return mod.bwd_kernel(*ops, err, *coeffs, **kw)
    mod = {"sae_mlp": fused_sae, "matryoshka_sae": fused_matryoshka_sae,
           "jumprelu_sae": fused_jumprelu_sae, "gated_sae": fused_gated_sae}[name]
    kernel = ((mod.sweep_bwd_kernel if backward else mod.sweep_fwd_kernel) if n
              else (mod.bwd_kernel if backward else mod.fwd_kernel))
    we, be, wd = _weights(n)
    if name in ("sae_mlp", "matryoshka_sae"):
        extra = (BOUNDS,) if name == "matryoshka_sae" else ()
        if not backward:
            return kernel(x, we, be, wd, _z(*lead, SC), *extra, **kw)
        levels = (len(BOUNDS),) if extra else ()
        x_cent = _z(*lead, ST, SC, dtype=BF16)
        return kernel(x_cent, we, be, wd, _z(*lead, *levels, ST, SC, dtype=BF16),
                      _z(*lead, 2), *extra, **kw)
    if name == "jumprelu_sae":
        ops = (x, we, be, _z(*lead, SH) + 1.0, wd, _z(*lead, SC))
        if not backward:
            return kernel(*ops, **kw)
        return kernel(*ops, _z(*lead, ST, SC), _z(*lead, 2), 0.5, **kw)
    ops = (x, we, be, _z(*lead, SH), _z(*lead, SH) + 1.0, wd, _z(*lead, SC))
    if not backward:
        return kernel(*ops, **kw)
    return kernel(*ops, _z(*lead, ST, SC), _z(*lead, ST, SC), _z(*lead, 3), **kw)


WRAPPERS = ("sae_mlp", "matryoshka_sae", "jumprelu_sae", "gated_sae", "transcoder",
            "crosscoder")
STEM = {"sae_mlp": "svt_sae", "matryoshka_sae": "svt_matryoshka", "jumprelu_sae":
        "svt_jumprelu", "gated_sae": "svt_gated", "transcoder": "svt_coder",
        "crosscoder": "svt_coder"}
# the index of recon and row_active in each forward wrapper's outputs, and of
# dW_dec in each backward wrapper's (dW_enc is first everywhere)
RECON_ROW = {"sae_mlp": (1, 3), "matryoshka_sae": (1, 3), "jumprelu_sae": (0, 2),
             "gated_sae": (0, 3), "transcoder": (0, 2), "crosscoder": (0, 2)}
DW_DEC = {"sae_mlp": 2, "matryoshka_sae": 2, "jumprelu_sae": 3, "gated_sae": 4,
          "transcoder": 2, "crosscoder": 2}


@pytest.mark.parametrize("backward", (False, True), ids=("forward", "backward"))
@pytest.mark.parametrize("name", WRAPPERS)
def test_wrappers_pass_one_dictionarys_split(libs, name, backward):
    want = grid_split(ST, SH, SC, backward=backward, n_sm=N_SM)
    assert want > 1  # the shape splits both bodies
    pass_ = "bwd" if backward else "fwd"
    lib = libs[next(m for p, m in PREFIX_MODULE.items() if STEM[name] + "_" == p)]
    sweeps = () if name in ("transcoder", "crosscoder") else (1, 3)
    for n in (0, *sweeps):
        entry = f"{STEM[name]}_sweep_{pass_}" if n else f"{STEM[name]}_{pass_}"
        names = [p for _, p in DECLS[entry]]
        for forced in (None, 1):  # the rule's split; the unsplit launch chip_smoke.py times
            outs = _launch(name, backward, n, **({} if forced is None else {"n_split": 1}))
            args = getattr(lib, entry).calls[-1]
            s = want if forced is None else 1
            assert args[names.index("n_split")] == s, (entry, n, forced)
            if backward:  # the workspace exactly when the launch splits
                assert (args[names.index("split_ws")] is None) == (s == 1)
            # the partials are summed: every output has its unsplit shape
            lead = (n,) if n else ()
            if backward:
                c_in = C_IN if STEM[name] == "svt_coder" else SC
                assert outs[0].shape == (*lead, c_in, SH)
                assert outs[DW_DEC[name]].shape == (*lead, SH, SC)
            else:
                recon, row = RECON_ROW[name]
                p = (len(BOUNDS),) if name == "matryoshka_sae" else ()
                assert outs[recon].shape == (*lead, *p, ST, SC)
                assert outs[row].shape == (*lead, ST)


def test_f32_launches_never_split(libs):
    """The f32 SIMT bodies are the check path: their launches pass n_split 1
    and no workspace at a shape whose bf16 launches split."""
    fused_sae.bwd_kernel(_z(ST, SC), _z(SC, SH), _z(SH), _z(SH, SC), _z(ST, SC), _z(2))
    args = libs[fused_sae].svt_sae_bwd.calls[-1]
    names = [p for _, p in DECLS["svt_sae_bwd"]]
    assert args[names.index("n_split")] == 1 and args[names.index("split_ws")] is None


def test_split_checks_script_stands_alone():
    """chip_split_checks.py runs on the card beside chip_smoke.py: it imports
    neither JAX nor the JAX package."""
    import ast

    path = CSRC.parent.parent / "chip_split_checks.py"
    names = set()
    for node in ast.walk(ast.parse(path.read_text())):
        if isinstance(node, ast.Import):
            names.update(a.name.split(".")[0] for a in node.names)
        elif isinstance(node, ast.ImportFrom) and node.module:
            names.add(node.module.split(".")[0])
    assert names.isdisjoint({"jax", "jaxlib", "sparse_vision_tpu"}), names
    assert "chip_smoke" in names


@pytest.mark.parametrize("variant", ("no_products", "one_set", "tc_no_products",
                                     "tc_no_updates", "pair_no_products",
                                     "pair_release_cluster", "pair_relu_no_products",
                                     "pair_gated_no_products"))
def test_bwd_probe_ablations_match_the_bodies(variant):
    """chip_bwd_probe.py's ablations are text substitutions of csrc/coder.cuh:
    each still finds every text it replaces in its body (or the constants
    above it) exactly as often as it says, and changes that body only."""
    import chip_bwd_probe

    text = (CSRC / "coder.cuh").read_text()
    out = chip_bwd_probe._ablate(text, variant)
    assert out != text
    start, end, source = chip_bwd_probe.BODIES[chip_bwd_probe.VARIANTS[variant][0]]
    i0, i1 = text.index(start), text.index(end, text.index(start))
    assert out.endswith(text[i1:])  # nothing after the body changes
    assert (source + ".cu") in {p.name for p in CSRC.glob("*.cu")}


# ---------------------------------------------------------------------------
# the held backward route (fused_sae.bwd_route) through the transcoder's wrappers
# ---------------------------------------------------------------------------

HT, HC, HH, HOUT = 2048, 256, 640, 480  # a held shape that splits: 10 latent blocks, 4 steps


def _held_launch(kernel=None, dtype=BF16, **kw):
    """One transcoder backward launch (``kernel``, default the single-device
    wrapper) at (HT, HC -> HOUT, HH) on zeros."""
    ops = (_z(HT, HC, dtype=dtype), _z(HC, HH, dtype=dtype), _z(HH),
           _z(HH, HOUT, dtype=dtype), _z(HT, HOUT, dtype=dtype), _z(2))
    return (kernel or fused_transcoder.bwd_kernel)(*ops, **kw)


@pytest.mark.parametrize("tp", (False, True), ids=("one card", "TP shard"))
def test_held_route_flag_split_and_counts(libs, monkeypatch, tp):
    """At a width the rule gives the held route, the transcoder's backward
    wrappers pass ``held`` 3 (both passes) with the rule's split and a
    workspace, count one launch of their own and one of each pass; route "tc"
    passes 0 and counts no pass; "held E" / "held D" pass 1 / 2 and count that
    pass alone."""
    for k in fused_transcoder.HELD_PASSES:
        monkeypatch.setattr(k, "launches", 0)
    kernel = fused_transcoder.tp_bwd_kernel if tp else fused_transcoder.bwd_kernel
    monkeypatch.setattr(kernel, "launches", 0)
    assert fused_sae.bwd_route(HC, HOUT) == "held"
    names = [p for _, p in DECLS["svt_coder_bwd"]]
    want_s = grid_split(HT, HH, HOUT, backward=True, n_sm=N_SM)
    assert want_s == 2
    for i, (route, flag, counts) in enumerate(((None, 3, (1, 1)), ("tc", 0, (1, 1)),
                                               ("held E", 1, (2, 1)), ("held D", 2, (2, 2)))):
        _held_launch(kernel, **({} if route is None else {"route": route}))
        args = libs[fused_transcoder].svt_coder_bwd.calls[-1]
        assert args[names.index("held")] == flag, route
        assert args[names.index("n_split")] == want_s
        assert args[names.index("split_ws")] is not None
        assert tuple(k.launches for k in fused_transcoder.HELD_PASSES) == counts, route
        assert kernel.launches == i + 1


def test_held_route_not_taken_in_f32_or_past_its_widths(libs, monkeypatch):
    """The f32 check path, the crosscoder and a C_out past HELD_COUT pass
    ``held`` 0."""
    for k in fused_transcoder.HELD_PASSES:
        monkeypatch.setattr(k, "launches", 0)
    names = [p for _, p in DECLS["svt_coder_bwd"]]
    _held_launch(dtype=torch.float32)
    assert libs[fused_transcoder].svt_coder_bwd.calls[-1][names.index("held")] == 0
    for name in ("transcoder", "crosscoder"):  # C_in 264 -> C_out 520: coder_bwd_tc
        _launch(name, True, 0)
        assert libs[fused_transcoder].svt_coder_bwd.calls[-1][names.index("held")] == 0
    assert all(k.launches == 0 for k in fused_transcoder.HELD_PASSES)


@pytest.mark.parametrize("n", (1, 3))
def test_held_workspace_holds_a_ticket_array_a_pass(n):
    """The held route's split workspace is coder_bwd_tc's with a second [N, H /
    64] array of int32 tickets (pass D's), zeroed like the first."""
    s, h = 2, 640
    tc = fused_sae.split_workspace(s, n, h, HC, HOUT, "cpu")
    for route in ("held", "held D"):
        held = fused_sae.split_workspace(s, n, h, HC, HOUT, "cpu", route)
        extra = n * (h // fused_sae.BLOCK_H)
        assert held.numel() == tc.numel() + extra
        assert not held[-2 * extra:].any()
    assert fused_sae.split_workspace(1, n, h, HC, HOUT, "cpu", "held") is None
