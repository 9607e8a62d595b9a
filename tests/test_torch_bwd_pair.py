"""The cluster-pair backward route (sparse_vision_tpu_torch/csrc/coder.cuh
coder_bwd_pair): the rule that picks it (ops/fused_sae.bwd_route), the grid
split of its launches (ops/fused_sae.grid_split), the JumpReLU, ReLU,
Matryoshka and gated SAE wrappers that pass both to the C entry points, and
its plain versions against the JAX package's JumpReLU, ReLU, Matryoshka and
gated backward kernels.

On the card the route is one launch in which two CTAs of a thread block
cluster share a 64-latent block: E holds dW_enc, D holds dW_dec in registers
for the whole token sweep and they trade post and dpre through distributed
shared memory. It computes the function of coder_bwd_tc's JumpReLU epilogue,
so its plain version is jumprelu_bwd_tc_plain (fused_jumprelu_sae.ROUTE_PLAIN);
chip_smoke.py holds the kernel to it. Here that plain version is held to the
JAX op's backward kernel (fused_jumprelu_sae.py:_bwd_kernel through the op's
custom VJP), run in interpret mode as tests/test_jumprelu.py runs it, on the
same numpy inputs; the thresholds are set from the pre-activations so that
every latent has a token in the straight-through window.

Tolerances (tests/test_torch_fused_jumprelu_sae.py's): f32 rtol 1e-4, atol
1e-7 (the frameworks sum the tokens in other orders); bf16 rtol 1e-4, atol
1e-6, dW_enc to 2^-8 of its largest entry (the interpret-mode kernel's
transposed bf16 product), db_dec to 1e-2 of its largest entry (the JAX kernel
rounds each token tile's db_enc partial, the port the whole db_enc once).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from sparse_vision_tpu.models.sae import init_gated_sae, init_sae_mlp
from sparse_vision_tpu.ops.fused_gated_sae import fused_gated_sae_loss_terms as jax_gated
from sparse_vision_tpu.ops.fused_jumprelu_sae import fused_jumprelu_sae_loss_terms as jax_fused
from sparse_vision_tpu.ops.fused_matryoshka_sae import make_fused_matryoshka_sae_op
from sparse_vision_tpu.ops.fused_sae import fused_sae_loss_terms as jax_relu
from sparse_vision_tpu_torch import convert
from sparse_vision_tpu_torch.ops import (
    fused_crosscoder,
    fused_gated_sae,
    fused_jumprelu_sae,
    fused_matryoshka_sae,
    fused_sae,
    fused_sae_tp,
    fused_transcoder,
)
from sparse_vision_tpu_torch.ops.fused_sae import bwd_route, grid_split
from test_torch_bwd_held import _t
from test_torch_grid_split import DECLS, N_SM, _z, libs  # noqa: F401 (libs: a fixture)

torch.set_num_threads(1)

BF16 = torch.bfloat16
F32 = torch.float32

# (label, C_in, C_out, prefix levels, epilogue, dtype) -> the body, at the
# shapes of PERF.md's kernel table and the rule's boundaries. It reads no T or
# H: on the card, each at its own split, the pair's body beat coder_bwd_tc's
# at every width from 8 to 256 and every T and H of chip_bwd_probe.py's route
# grid, with the JumpReLU epilogue and with the ReLU SAE's ("sae", also at
# three prefix levels), and with the gated SAE's at C 192 and 256 (at C 64
# and 128 it lost or tied at large H, so the gated rule starts past 128);
# past C 256 its gradient tile does not fit in a CTA's registers. The coders
# ("relu": the transcoder and the crosscoder, whose entry point has no pair)
# keep their routes at equal widths
ROUTES = {
    "row 5 JumpReLU backward (C 256)": (256, 256, 1, "jump", BF16, "pair"),
    "row 20 JumpReLU TP backward (shard, C 256)": (256, 256, 1, "jump", BF16, "pair"),
    "row 32 JumpReLU sweep backward (C 256)": (256, 256, 1, "jump", BF16, "pair"),
    "the ragged JumpReLU shape, C 136": (136, 136, 1, "jump", BF16, "pair"),
    "C 8, the narrowest bf16 width": (8, 8, 1, "jump", BF16, "pair"),
    "C 64, GoogLeNet's conv2d0": (64, 64, 1, "jump", BF16, "pair"),
    "C 192, GoogLeNet's conv2d2 and vit_tiny": (192, 192, 1, "jump", BF16, "pair"),
    "C 264, past the pair's registers": (264, 264, 1, "jump", BF16, "tc"),
    "C 480 (kernels_act_widths)": (480, 480, 1, "jump", BF16, "tc"),
    "C 832 (kernels_act_widths)": (832, 832, 1, "jump", BF16, "tc"),
    "JumpReLU with 3 levels (no such op: the levels are the ReLU SAE's)": (
        256, 256, 3, "jump", BF16, "tc"),
    "unequal widths": (256, 136, 1, "jump", BF16, "tc"),
    "rows 2, 16, 28 ReLU backward (C 256)": (256, 256, 1, "sae", BF16, "pair"),
    "rows 7, 18, 30 gated backward (C 256)": (256, 256, 1, "gated", BF16, "pair"),
    "the gated SAE's ragged shape, C 136": (136, 136, 1, "gated", BF16, "pair"),
    "the gated SAE at C 192": (192, 192, 1, "gated", BF16, "pair"),
    "the gated SAE at C 128 (lost or tied at large H)": (128, 128, 1, "gated", BF16, "tc"),
    "the gated SAE at C 64 (lost at expansion 64)": (64, 64, 1, "gated", BF16, "tc"),
    "the gated SAE past the pair's registers, C 264": (264, 264, 1, "gated", BF16, "tc"),
    "the gated SAE at C 480 (kernels_act_widths)": (480, 480, 1, "gated", BF16, "tc"),
    "gated with 3 levels (no such op: the levels are the Matryoshka SAE's)": (
        256, 256, 3, "gated", BF16, "tc"),
    "rows 9, 22, 34 Matryoshka backward (3 levels)": (256, 256, 3, "sae", BF16, "pair"),
    "the ReLU SAE's ragged shape, C 136": (136, 136, 1, "sae", BF16, "pair"),
    "the ReLU SAE at C 8": (8, 8, 1, "sae", BF16, "pair"),
    "the ReLU SAE past the pair's registers, C 264": (264, 264, 1, "sae", BF16, "tc"),
    "the ReLU SAE at C 480 (kernels_sae_widths)": (480, 480, 1, "sae", BF16, "tc"),
    "the Matryoshka SAE at C 832 (kernels_sae_widths)": (832, 832, 3, "sae", BF16, "tc"),
    "a transcoder at 256 -> 256 keeps coder_bwd_tc": (256, 256, 1, "relu", BF16, "tc"),
    "a transcoder at 136 -> 136 keeps coder_bwd_tc": (136, 136, 1, "relu", BF16, "tc"),
    "row 12 transcoder backward (256 -> 480)": (256, 480, 1, "relu", BF16, "held"),
    "row 5 in f32 (the check path)": (256, 256, 1, "jump", F32, "simt"),
    "C 136 in f32": (136, 136, 1, "jump", F32, "simt"),
    "row 2 in f32": (256, 256, 1, "sae", F32, "simt"),
    "row 7 in f32": (256, 256, 1, "gated", F32, "simt"),
}


@pytest.mark.parametrize("label", list(ROUTES))
def test_route_at_table_shapes(label):
    c_in, c_out, levels, act, dtype, want = ROUTES[label]
    assert bwd_route(c_in, c_out, levels, act, dtype) == want
    name = "bfloat16" if dtype == BF16 else "float32"
    assert bwd_route(c_in, c_out, levels, act, name) == want


@pytest.mark.parametrize("c", (8, 64, 128, 136, 248, 256, 264, 512))
@pytest.mark.parametrize("act", ("jump", "relu", "gated", "sae"))
@pytest.mark.parametrize("levels", (1, 3))
def test_route_boundary(c, act, levels):
    """The pair takes exactly a bf16 JumpReLU backward of one level, a gated
    one of one level past GATED_PAIR_MIN_C and a ReLU or Matryoshka SAE
    backward of any levels whose width its registers hold (C <= PAIR_C),
    never the coders'; f32 is SIMT's."""
    pair = ((act == "sae" or (act == "jump" and levels == 1)
             or (act == "gated" and levels == 1 and c > fused_sae.GATED_PAIR_MIN_C))
            and c <= fused_sae.PAIR_C)
    assert (bwd_route(c, c, levels, act) == "pair") == pair
    assert bwd_route(c, c, levels, act, F32) == "simt"


# (label, T, H, the split) of the pair's launches: one dictionary's 2·H/64
# CTAs, never a sweep's N
PAIR_SPLITS = {
    "row 5 (T 32,768, H 16,384: 512 CTAs)": (32768, 16384, 1),
    "row 20 (shard T 16,384, H 8,192: 256 CTAs)": (16384, 8192, 1),
    "row 32 (T 4,096, H 2,048: 64 CTAs a combo)": (4096, 2048, 2),
    "the ragged shape (T 1,152, H 640: one step a split at most)": (1152, 640, 1),
    "the split check (T 2,176, H 640: 20 CTAs)": (2176, 640, 2),
    "H 4,096 (128 CTAs, 120 or more: whole)": (32768, 4096, 1),
    "H 1,024 (32 CTAs)": (32768, 1024, 4),
    "chip_smoke.py's sweep of short sweeps (T 4,096, H 512: 16 CTAs)": (4096, 512, 4),
}


@pytest.mark.parametrize("label", list(PAIR_SPLITS))
def test_pair_split_at_table_shapes(label):
    t, h, want = PAIR_SPLITS[label]
    assert grid_split(t, h, 256, backward=True, n_sm=N_SM, pair=True) == want


@pytest.mark.parametrize("t", (1152, 2176, 4096, 16384, 32768))
@pytest.mark.parametrize("h", (640, 1024, 2048, 4096, 8192, 16384))
def test_pair_split_invariants(t, h):
    """The pair's split is coder_bwd_tc's rule on twice the blocks: at most
    MAX_SPLIT, two steps a split kept, and whole once its CTAs fill 120 of the
    132 SMs."""
    s = grid_split(t, h, 256, backward=True, n_sm=N_SM, pair=True)
    assert 1 <= s <= fused_sae.MAX_SPLIT
    steps = -(-t // fused_sae.BF16_STEP_T)
    if s > 1:
        assert steps // s >= fused_sae.SPLIT_MIN_STEPS
    if 11 * fused_sae.PAIR_CTAS * (h // fused_sae.BLOCK_H) >= 10 * N_SM:
        assert s == 1
    # the dictionary's own shape decides: the same answer at every call
    assert grid_split(t, h, 256, backward=True, n_sm=N_SM, pair=True) == s


def test_probe_grids_time_pair_launches():
    """chip_bwd_probe.py's route grids (the evidence for the rule's widths)
    time launches at shapes the bodies take, from C 8 to PAIR_C, at T 4,096
    and 32,768, for the JumpReLU backward, which the rule gives the pair at
    every width, and the gated one, whose pair the grid times at every width
    and the rule takes on both sides of GATED_PAIR_MIN_C; its split grid has
    launches the rule splits in 2 and in 4, each at one dictionary and a
    sweep."""
    import chip_bwd_probe as probe

    assert {"jump", "gated"} <= set(probe.GRID_ACTS)
    widths = set()
    for c in probe.GRID_C:
        for e in probe.GRID_EXP:
            h = max(128, -(-c * e // 128) * 128)
            for t in probe.GRID_T:
                assert fused_sae.bodies_take(t, h, c, c)
                assert fused_gated_sae.bwd_takes(t, h, c)
                assert bwd_route(c, c, act="jump") == "pair"
                widths.add(c)
    gated = {bwd_route(c, c, act="gated") for c in probe.GRID_C}
    assert gated == {"pair", "tc"}
    assert min(widths) == fused_sae.BF16_WIDTH and max(widths) == fused_sae.PAIR_C
    assert set(probe.GRID_T) == {4096, 32768}
    splits = {grid_split(t, h, c, backward=True, n_sm=N_SM, pair=True)
              for t, h, c in probe.SPLIT_SHAPES}
    assert splits == {2, 4} and probe.SPLIT_N > 1


@pytest.mark.parametrize("i", range(3))
def test_smoke_pair_widths_take_the_pair(i):
    """chip_smoke.py's PAIR_WIDTHS are launches the rule gives the JumpReLU
    pair (C 64 and 192, the backbones' narrower widths), on both sides of the
    split rule's boundary: whole at expansion 64, split in 4 at C 64, H
    1,024; the rule gives the gated backward the pair at 192, not at 64."""
    import chip_smoke

    t, c, h = chip_smoke.PAIR_WIDTHS[i]
    assert bwd_route(c, c, act="jump") == "pair" and fused_sae.bodies_take(t, h, c, c)
    assert bwd_route(c, c, act="gated") == ("pair" if c == 192 else "tc")
    want = 4 if h == 1024 else 1
    assert grid_split(t, h, c, backward=True, n_sm=N_SM, pair=True) == want
    assert len(chip_smoke.PAIR_WIDTHS) == 3


@pytest.mark.parametrize("name", ("jumprelu_sae", "sae_mlp", "gated_sae"))
def test_smoke_pair_split_shape_and_stress_take_the_pair(name):
    """chip_smoke.py's ragged split check (T 2,176, C 136, H 640) and its
    PAIR_STRESS sweep are launches the rule gives each SAE's pair, the first
    split in 2 by the pair's rule, the second in 4, one dictionary's CTAs."""
    import chip_smoke

    act = {"jumprelu_sae": "jump", "sae_mlp": "sae", "gated_sae": "gated"}[name]
    t, c, h = chip_smoke.PAIR_SPLIT_T, chip_smoke.RAGGED_C, chip_smoke.RAGGED_H
    assert bwd_route(c, c, act=act) == "pair" and fused_sae.bodies_take(t, h, c, c)
    assert grid_split(t, h, c, backward=True, n_sm=N_SM, pair=True) == 2
    n, t, c, h = chip_smoke.PAIR_STRESS
    assert n > 1 and bwd_route(c, c, act=act) == "pair"
    assert grid_split(t, h, c, backward=True, n_sm=N_SM, pair=True) == 4
    assert name in chip_smoke.PAIR_STRESS_NAMES


@pytest.mark.parametrize("n", (1, 3))
def test_pair_workspace_holds_a_ticket_array_a_rank(n):
    """The pair's split workspace is coder_bwd_tc's with a second [N, H / 64]
    array of int32 tickets (E's), zeroed like the first."""
    s, h, c = 2, 640, 136
    tc = fused_sae.split_workspace(s, n, h, c, c, "cpu")
    pair = fused_sae.split_workspace(s, n, h, c, c, "cpu", "pair")
    extra = n * (h // fused_sae.BLOCK_H)
    assert pair.numel() == tc.numel() + extra
    assert not pair[-2 * extra:].any()
    assert fused_sae.split_workspace(1, n, h, c, c, "cpu", "pair") is None


# ---------------------------------------------------------------------------
# the wrappers against a stand-in library (test_torch_grid_split.py's)
# ---------------------------------------------------------------------------

# row 32's T and H at a ragged C: the pair splits in 2, coder_bwd_tc in 4
PT, PC, PH = 4096, 136, 2048


def _pair_launch(kernel, n: int = 0, dtype=BF16, **kw):
    """One JumpReLU backward launch through ``kernel`` at (PT, PC, PH) on zeros:
    one dictionary (n 0) or a sweep of n combos."""
    lead = (n,) if n else ()
    ops = (_z(PT, PC, dtype=dtype), _z(*lead, PC, PH, dtype=dtype), _z(*lead, PH),
           _z(*lead, PH) + 1.0, _z(*lead, PH, PC, dtype=dtype), _z(*lead, PC))
    return kernel(*ops, _z(*lead, PT, PC), _z(*lead, 2), 0.5, **kw)


WRAPPERS = {"one card": (fused_jumprelu_sae.bwd_kernel, 0),
            "TP shard": (fused_sae_tp.jumprelu_bwd_kernel, 0),
            "sweep of 3": (fused_jumprelu_sae.sweep_bwd_kernel, 3)}


@pytest.mark.parametrize("which", list(WRAPPERS))
def test_pair_route_flag_split_and_counts(libs, monkeypatch, which):
    """Where the rule gives the pair route, the JumpReLU backward wrappers pass
    ``pair`` 1 with the pair's split and a workspace of two ticket arrays,
    and count one launch of their own and one of coder_bwd_pair; route "tc"
    passes 0 with coder_bwd_tc's split and counts no pair launch; the
    unsplit launch passes no workspace."""
    kernel, n = WRAPPERS[which]
    monkeypatch.setattr(fused_jumprelu_sae.pair_kernel, "launches", 0)
    monkeypatch.setattr(kernel, "launches", 0)
    assert bwd_route(PC, PC, act="jump") == "pair"
    entry = "svt_jumprelu_sweep_bwd" if n else "svt_jumprelu_bwd"
    names = [p for _, p in DECLS[entry]]
    pair_s = grid_split(PT, PH, PC, backward=True, n_sm=N_SM, pair=True)
    tc_s = grid_split(PT, PH, PC, backward=True, n_sm=N_SM)
    assert (pair_s, tc_s) == (2, 4)
    ws = fused_sae.split_workspace  # the workspaces the wrapper allocates, by route
    sizes = []
    monkeypatch.setattr(fused_jumprelu_sae, "split_workspace",
                        lambda *a, **k: sizes.append((a, k)) or ws(*a, **k))
    for i, (kw, flag, s, pairs) in enumerate((({}, 1, pair_s, 1), ({"route": "tc"}, 0, tc_s, 1),
                                              ({"n_split": 1}, 1, 1, 2))):
        outs = _pair_launch(kernel, n, **kw)
        args = getattr(libs[fused_jumprelu_sae], entry).calls[-1]
        assert args[names.index("pair")] == flag, kw
        assert args[names.index("n_split")] == s, kw
        assert (args[names.index("split_ws")] is None) == (s == 1), kw
        assert sizes[-1][0][0] == s and sizes[-1][0][1] == max(n, 1)
        assert sizes[-1][0][-1] == ("pair" if flag else "tc")
        assert kernel.launches == i + 1
        assert fused_jumprelu_sae.pair_kernel.launches == pairs, kw
        lead = (n,) if n else ()
        assert outs[0].shape == (*lead, PC, PH) and outs[3].shape == (*lead, PH, PC)


def test_pair_route_not_taken_in_f32_or_past_its_width(libs, monkeypatch):
    """The f32 check path and a width past PAIR_C pass ``pair`` 0 and count no
    pair launch."""
    monkeypatch.setattr(fused_jumprelu_sae.pair_kernel, "launches", 0)
    names = [p for _, p in DECLS["svt_jumprelu_bwd"]]
    _pair_launch(fused_jumprelu_sae.bwd_kernel, dtype=F32)
    assert libs[fused_jumprelu_sae].svt_jumprelu_bwd.calls[-1][names.index("pair")] == 0
    c = 264
    ops = (_z(PT, c, dtype=BF16), _z(c, PH, dtype=BF16), _z(PH), _z(PH) + 1.0,
           _z(PH, c, dtype=BF16), _z(c))
    fused_jumprelu_sae.bwd_kernel(*ops, _z(PT, c), _z(2), 0.5)
    assert libs[fused_jumprelu_sae].svt_jumprelu_bwd.calls[-1][names.index("pair")] == 0
    assert fused_jumprelu_sae.pair_kernel.launches == 0


@pytest.mark.parametrize("mod", (fused_jumprelu_sae, fused_sae, fused_gated_sae),
                         ids=("jump", "relu", "gated"))
def test_pair_clusters_query_is_bound(libs, mod):
    """svt_jumprelu_pair_clusters, svt_sae_pair_clusters and
    svt_gated_pair_clusters (the build phase's cluster occupancy of each
    instantiation) are bound with their one pointer argument."""
    entry = {fused_jumprelu_sae: "svt_jumprelu_pair_clusters", fused_sae: "svt_sae_pair_clusters",
             fused_gated_sae: "svt_gated_pair_clusters"}[mod]
    assert getattr(libs[mod], entry).argtypes == [mod._P]
    assert mod.pair_clusters() == 0  # the stand-in writes nothing


# ---------------------------------------------------------------------------
# the ReLU and Matryoshka SAEs' wrappers on the pair (the stand-in library)
# ---------------------------------------------------------------------------

SAE_LEVELS = (128, 1024, PH)  # Matryoshka prefixes at (PT, PC, PH)

# the six SAE backward wrappers: (kernel, sweep N or 0, prefix levels or None)
SAE_WRAPPERS = {"sae_mlp one card": (fused_sae.bwd_kernel, 0, None),
                "sae_mlp TP shard": (fused_sae_tp.bwd_kernel, 0, None),
                "sae_mlp sweep of 3": (fused_sae.sweep_bwd_kernel, 3, None),
                "matryoshka one card": (fused_matryoshka_sae.bwd_kernel, 0, SAE_LEVELS),
                "matryoshka TP shard": (fused_sae_tp.matryoshka_bwd_kernel, 0, SAE_LEVELS),
                "matryoshka sweep of 3": (fused_matryoshka_sae.sweep_bwd_kernel, 3, SAE_LEVELS)}


def _sae_launch(kernel, n: int, levels, dtype=BF16, **kw):
    """One SAE backward launch through ``kernel`` at (PT, PC, PH) on zeros: the
    ReLU SAE's (levels None) or the Matryoshka SAE's S at ``levels``; one
    dictionary (n 0) or a sweep of n combos."""
    lead = (n,) if n else ()
    p = (len(levels),) if levels else ()
    ops = (_z(*lead, PT, PC, dtype=dtype), _z(*lead, PC, PH, dtype=dtype), _z(*lead, PH),
           _z(*lead, PH, PC, dtype=dtype), _z(*lead, *p, PT, PC, dtype=dtype), _z(*lead, 2))
    return kernel(*ops, *((levels,) if levels else ()), **kw)


def _sae_entry(n: int, levels) -> str:
    return f"svt_{'matryoshka' if levels else 'sae'}_{'sweep_' if n else ''}bwd"


@pytest.mark.parametrize("which", list(SAE_WRAPPERS))
def test_sae_pair_route_flag_split_and_counts(libs, monkeypatch, which):
    """Where the rule gives the SAEs' backward the pair (C <= 256, any levels),
    each of the six wrappers passes ``pair`` 1 with the pair's split and a
    workspace of two ticket arrays (the ReLU SAE's also its err_s workspace,
    the Matryoshka SAE none: its pair reads S as it is), and counts one launch
    of its own and one of coder_bwd_pair<Act::Relu> (fused_sae.pair_kernel);
    route "tc" passes 0 with coder_bwd_tc's split, no err_s and no pair
    launch; the unsplit launch passes no workspace."""
    kernel, n, levels = SAE_WRAPPERS[which]
    monkeypatch.setattr(fused_sae.pair_kernel, "launches", 0)
    monkeypatch.setattr(kernel, "launches", 0)
    assert bwd_route(PC, PC, len(levels or (1,)), act="sae") == "pair"
    entry = _sae_entry(n, levels)
    names = [p for _, p in DECLS[entry]]
    pair_s = grid_split(PT, PH, PC, backward=True, n_sm=N_SM, pair=True)
    tc_s = grid_split(PT, PH, PC, backward=True, n_sm=N_SM)
    assert (pair_s, tc_s) == (2, 4)
    mod = fused_matryoshka_sae if levels else fused_sae
    ws = fused_sae.split_workspace  # the workspaces the wrapper allocates, by route
    sizes = []
    monkeypatch.setattr(mod, "split_workspace",
                        lambda *a, **k: sizes.append((a, k)) or ws(*a, **k))
    for i, (kw, flag, s, pairs) in enumerate((({}, 1, pair_s, 1), ({"route": "tc"}, 0, tc_s, 1),
                                              ({"n_split": 1}, 1, 1, 2))):
        outs = _sae_launch(kernel, n, levels, **kw)
        args = getattr(libs[mod], entry).calls[-1]
        assert args[names.index("pair")] == flag, kw
        assert args[names.index("n_split")] == s, kw
        assert (args[names.index("split_ws")] is None) == (s == 1), kw
        if not levels:
            assert (args[names.index("err_s")] is None) == (flag == 0), kw
        assert sizes[-1][0][0] == s and sizes[-1][0][1] == max(n, 1)
        assert sizes[-1][0][-1] == ("pair" if flag else "tc")
        assert kernel.launches == i + 1
        assert fused_sae.pair_kernel.launches == pairs, kw
        lead = (n,) if n else ()
        assert outs[0].shape == (*lead, PC, PH) and outs[2].shape == (*lead, PH, PC)


@pytest.mark.parametrize("which", list(SAE_WRAPPERS))
def test_sae_pair_route_not_taken_in_f32(libs, monkeypatch, which):
    """The f32 check path passes ``pair`` 0, no err_s, and counts no pair
    launch; a route the SAEs' entry points do not have raises before any
    launch."""
    kernel, n, levels = SAE_WRAPPERS[which]
    monkeypatch.setattr(fused_sae.pair_kernel, "launches", 0)
    monkeypatch.setattr(kernel, "launches", kernel.launches)
    entry = _sae_entry(n, levels)
    names = [p for _, p in DECLS[entry]]
    mod = fused_matryoshka_sae if levels else fused_sae
    _sae_launch(kernel, n, levels, dtype=F32)
    args = getattr(libs[mod], entry).calls[-1]
    assert args[names.index("pair")] == 0 and args[names.index("n_split")] == 1
    if not levels:
        assert args[names.index("err_s")] is None
    assert fused_sae.pair_kernel.launches == 0
    calls = len(getattr(libs[mod], entry).calls)
    with pytest.raises(ValueError, match="held"):
        _sae_launch(kernel, n, levels, route="held")
    assert len(getattr(libs[mod], entry).calls) == calls


@pytest.mark.parametrize("c", (256, 136))
@pytest.mark.parametrize("name", ("transcoder", "crosscoder"))
def test_coders_keep_their_route_at_equal_widths(libs, monkeypatch, name, c):
    """A transcoder (or crosscoder) backward at C_in = C_out <= 256 runs
    coder_bwd_tc: svt_coder_bwd gets ``held`` 0, no pair counter moves, and
    the cluster pair, which its entry point does not have, raises."""
    monkeypatch.setattr(fused_sae.pair_kernel, "launches", 0)
    monkeypatch.setattr(fused_jumprelu_sae.pair_kernel, "launches", 0)
    for k in fused_transcoder.HELD_PASSES:
        monkeypatch.setattr(k, "launches", 0)
    assert bwd_route(c, c) == "tc"
    mod = fused_transcoder if name == "transcoder" else fused_crosscoder
    ops = (_z(PT, c, dtype=BF16), _z(c, PH, dtype=BF16), _z(PH), _z(PH, c, dtype=BF16),
           _z(PT, c, dtype=BF16))
    coeffs = (_z(2),) if name == "transcoder" else (_z(1), _z(PH))
    mod.bwd_kernel(*ops, *coeffs)
    names = [p for _, p in DECLS["svt_coder_bwd"]]
    args = libs[fused_transcoder].svt_coder_bwd.calls[-1]
    assert args[names.index("held")] == 0
    assert args[names.index("n_split")] == grid_split(PT, PH, c, backward=True, n_sm=N_SM)
    assert fused_sae.pair_kernel.launches == fused_jumprelu_sae.pair_kernel.launches == 0
    assert all(k.launches == 0 for k in fused_transcoder.HELD_PASSES)
    with pytest.raises(ValueError, match="pair"):  # both coders launch through this
        fused_transcoder.coder_backward_launch(mod.bwd_kernel, *ops, _z(2), _z(PH),
                                               route="pair")


# ---------------------------------------------------------------------------
# the pair route's plain version against the JAX backward kernel
# ---------------------------------------------------------------------------

T, C, H_EXP = 128, 64, 4
H = C * H_EXP
LAMBDA, EPS = 0.05, 0.5
JTILES = dict(tile_t=64, tile_h=128, interpret=True, bandwidth=EPS)
JDT = {"float32": jnp.float32, "bfloat16": jnp.bfloat16}
TDT = {"float32": F32, "bfloat16": BF16}


def _grid(a, step):
    return (np.round(np.asarray(a, np.float64) / step) * step).astype(np.float32)


@pytest.fixture(scope="module")
def window_setup():
    """Parameters and tokens on a dyadic grid (exact pre-activations in f32 and
    in bf16-operand products), with each latent's threshold 1/8 above its
    pre-activation at one token (or 1/8 when that is negative): every latent
    has a token inside the window |pre − θ| <= ε/2 = 1/4, and none at the
    window's edge or at θ itself."""
    rng = np.random.default_rng(11)
    w_enc = _grid(rng.normal(size=(C, H)) / np.sqrt(C), 2.0 ** -8)
    b_enc = ((2 * rng.integers(-40, 40, size=H) + 1) * 2.0 ** -11).astype(np.float32)
    b_enc[:8] = -50.0 - 2.0 ** -11  # latents that never fire
    w_dec = (rng.normal(size=(H, C)) / np.sqrt(H)).astype(np.float32)
    b_dec = _grid(0.2 * rng.normal(size=C), 0.25)
    x = _grid(rng.normal(size=(T, C)), 0.25)
    pre = (x - b_dec) @ w_enc.astype(np.float64) + b_enc
    at = pre[np.arange(H) % T, np.arange(H)]
    thr = np.maximum(at, 0.0) + 0.125
    params = {"W_enc": w_enc, "b_enc": b_enc, "W_dec": w_dec, "b_dec": b_dec,
              "log_threshold": np.log(thr).astype(np.float32)}
    return params, x


@pytest.mark.parametrize("cd", ["float32", "bfloat16"])
def test_pair_plain_matches_jax(window_setup, cd):
    """jumprelu_bwd_tc_plain under the pair route (backward_plain(...,
    route="pair")) against the gradients of the JAX op's loss rec + λ·L0 (its
    backward kernel, interpret mode) on the error of the JAX forward: dW_enc,
    db_enc, d log θ = dθ·θ, dW_dec and db_dec."""
    params, x = window_setup
    jp = {k: jnp.asarray(v) for k, v in params.items()}
    jx = jnp.asarray(x)
    jgrad = jax.grad(lambda p: jax_fused(p, jx, LAMBDA, H_EXP, compute_dtype=JDT[cd],
                                         **JTILES)["loss"])(jp)
    td = TDT[cd]
    tx = _t(x, td)
    we, wd = _t(params["W_enc"], td), _t(params["W_dec"], td)
    be, bd = torch.from_numpy(params["b_enc"]), torch.from_numpy(params["b_dec"])
    thr = torch.exp(torch.from_numpy(params["log_threshold"])).float()
    ops = (tx, we, be, thr, wd, bd)
    err = fused_jumprelu_sae.fused_jumprelu_forward_plain(*ops)[0] - torch.from_numpy(x)
    coeffs = torch.tensor([2.0 / (T * C), LAMBDA / T])
    dw_enc, db_enc, dthr, dw_dec, db_dec = fused_jumprelu_sae.backward_plain(
        *ops, err, coeffs, EPS, route="pair")
    got = {"W_enc": dw_enc, "b_enc": db_enc, "log_threshold": dthr * thr, "W_dec": dw_dec,
           "b_dec": db_dec}
    for k, v in got.items():
        ref = np.asarray(jgrad[k])
        if cd == "float32":
            rtol, atol = 1e-4, 1e-7
        else:
            rtol, atol = {"W_enc": (0, 2.0 ** -8 * np.abs(ref).max()),
                          "b_dec": (0, 1e-2 * np.abs(ref).max())}.get(k, (1e-4, 1e-6))
        np.testing.assert_allclose(v.numpy(), ref, rtol=rtol, atol=atol, err_msg=k)
        assert np.abs(ref).max() > 0, k
    # every latent that can fire has a token in the window: dθ moves it
    assert int((dthr[8:] != 0).sum()) == H - 8
    assert 0 < int((db_enc != 0).sum()) < H


@pytest.mark.parametrize("cd", [F32, BF16])
def test_route_plain_names_the_route(cd):
    """backward_plain takes the route's plain version: bwd_route's for the
    operands (pair / tc in bf16, simt in f32) or the one named; "pair" and
    "tc" are the same function, bit for bit."""
    g = torch.Generator().manual_seed(0)
    t, c, h = 256, 40, 128
    x = torch.randn(t, c, generator=g).to(cd)
    we = (torch.randn(c, h, generator=g) / 7).to(cd)
    wd = (torch.randn(h, c, generator=g) / 11).to(cd)
    ops = (x, we, 0.1 * torch.randn(h, generator=g), 0.3 + torch.rand(h, generator=g), wd,
           0.1 * torch.randn(c, generator=g))
    args = (*ops, torch.randn(t, c, generator=g), torch.tensor([1e-3, 1e-2]), 0.5)
    want = (fused_jumprelu_sae.jumprelu_bwd_tc_plain if cd == BF16
            else fused_jumprelu_sae.fused_jumprelu_backward_plain)(*args)
    for route in (None, "pair" if cd == BF16 else "simt"):
        got = fused_jumprelu_sae.backward_plain(*args, route=route)
        assert all(torch.equal(a, b) for a, b in zip(got, want)), route
    tc = fused_jumprelu_sae.backward_plain(*args, route="tc")
    pair = fused_jumprelu_sae.backward_plain(*args, route="pair")
    assert all(torch.equal(a, b) for a, b in zip(tc, pair))


# ---------------------------------------------------------------------------
# the ReLU and Matryoshka SAEs' pair route: its plain version against JAX
# ---------------------------------------------------------------------------

# T 1,152 (two 512-token steps and a partial one: three direct rows of db_dec
# from the pre-pass), C 16; H 256 for the ReLU SAE, 384 for three Matryoshka
# levels (the JAX kernel's latent quantum is 128)
ST_, SC_ = 1152, 16
SAE_CASES = {"one level (the ReLU SAE)": (256, None),
             "three levels (the Matryoshka SAE)": (384, (128, 256, 384))}
LAMBDA_R = 0.7


def _jax_sae_grads(params, x, h: int, levels, cd):
    """The JAX op's parameter gradients of rec + λ·l1 (the ReLU SAE) or
    mean(prefix MSE) + λ·l1 (the Matryoshka SAE), its kernels in interpret
    mode as the JAX package's tests run them."""
    jx = jnp.asarray(x)
    if levels is None:
        def loss(p):
            return jax_relu(p, jx, LAMBDA_R, h // SC_, compute_dtype=JDT[cd], tile_t=64,
                            tile_h=128, interpret=True)["loss"]
    else:
        op = make_fused_matryoshka_sae_op(levels, 64, 128, JDT[cd], True, False)

        def loss(p):
            out = op(p, jx)
            return out["prefix_losses"].mean() + LAMBDA_R * out["l1_loss"]
    return jax.device_get(jax.grad(loss)(params))


@pytest.mark.parametrize("case", list(SAE_CASES))
def test_sae_pair_plain_matches_jax(monkeypatch, case):
    """The port's bf16 op on the CPU, whose backward takes the pair route's
    plain version (backward_plain: scale_err_plain's pre-pass on the bf16
    error, round(c_rec·err) and its per-step direct rows of db_dec, or the
    direct rows of S_0 alone, then the body's function on the rounded error at
    a unit scale), against the JAX op's gradients (its backward kernel in
    interpret mode, through its custom VJP), at tests/test_torch_fused_sae.py's
    bf16 tolerances: dW_enc to 2^-8 of its largest entry, db_dec to 1e-2, the
    rest rtol 1e-4, atol 1e-6."""
    h, levels = SAE_CASES[case]
    mod = fused_matryoshka_sae if levels else fused_sae
    assert bwd_route(SC_, SC_, len(levels or (h,)), act="sae", dtype=BF16) == "pair"
    ran = []
    pair_plain = mod.ROUTE_PLAIN["pair"]
    monkeypatch.setitem(mod.ROUTE_PLAIN, "pair",
                        lambda *a: ran.append(a[4].dtype) or pair_plain(*a))
    params = init_sae_mlp(jax.random.key(1), SC_, h // SC_)
    b_enc = (params["b_enc"] - 0.1).at[:16].add(-100.0)  # 16 latents never fire
    params = jax.device_get({**params, "b_enc": b_enc, "b_dec": params["b_dec"] + 0.05})
    x = np.random.default_rng(2).normal(size=(ST_, SC_)).astype(np.float32)
    jgrad = _jax_sae_grads(params, x, h, levels, "bfloat16")
    tp = {k: v.requires_grad_(True) for k, v in convert.sae_params_from_jax(params).items()}
    tx = torch.from_numpy(x)
    if levels is None:
        loss = fused_sae.fused_sae_loss_terms(tp, tx, LAMBDA_R, h // SC_,
                                              compute_dtype=BF16)["loss"]
    else:
        out = fused_matryoshka_sae.fused_matryoshka_sae(tp, tx, levels, compute_dtype=BF16)
        loss = out["prefix_losses"].mean() + LAMBDA_R * out["l1_loss"]
    got = dict(zip(tp, torch.autograd.grad(loss, list(tp.values()))))
    assert ran == [BF16]  # one backward, on the pair route's plain version, bf16 error
    for k in ("W_enc", "b_enc", "W_dec", "b_dec"):
        ref = np.asarray(jgrad[k])
        rtol, atol = {"W_enc": (0, 2.0 ** -8 * np.abs(ref).max()),
                      "b_dec": (0, 1e-2 * np.abs(ref).max())}.get(k, (1e-4, 1e-6))
        np.testing.assert_allclose(got[k].numpy(), ref, rtol=rtol, atol=atol, err_msg=k)
        assert np.abs(ref).max() > 0, k
    assert 0 < int((got["b_enc"] != 0).sum()) < h


@pytest.mark.parametrize("levels", (None, (128, 256, 384)), ids=("one level", "three levels"))
def test_sae_pair_plain_is_the_tc_function(levels):
    """The pair route's plain version computes the tc route's function: the
    gradients bit for bit (the pre-pass rounds c_rec·err as the tc body does),
    db_dec's direct term per 512-token step, whose sum is the tc route's one
    row to f32 summation order."""
    g = torch.Generator().manual_seed(0)
    t, c, h = ST_, 24, 384
    x = torch.randn(t, c, generator=g).to(BF16)
    we = (torch.randn(c, h, generator=g) / 5).to(BF16)
    be = 0.1 * torch.randn(h, generator=g)
    wd = (torch.randn(h, c, generator=g) / 9).to(BF16)
    if levels is None:
        mod, extra = fused_sae, ()
        err, coeffs = torch.randn(t, c, generator=g).to(BF16), torch.tensor([3e-3, 1e-4])
    else:
        mod, extra = fused_matryoshka_sae, (levels,)
        err = (1e-3 * torch.randn(len(levels), t, c, generator=g)).to(BF16)
        coeffs = torch.tensor([1.0, 1e-4])
    pair = mod.backward_plain(x, we, be, wd, err, coeffs, *extra, route="pair")
    tc = mod.backward_plain(x, we, be, wd, err, coeffs, *extra, route="tc")
    assert all(torch.equal(a, b) for a, b in zip(pair[:3], tc[:3]))
    steps = -(-t // fused_sae.BF16_STEP_T)
    assert pair[3].shape == (steps + 1, c) and tc[3].shape == (2, c)
    torch.testing.assert_close(pair[3][steps:], tc[3][1:], rtol=0, atol=0)  # centring rows
    torch.testing.assert_close(pair[3][:steps].sum(0), tc[3][0], rtol=1e-5, atol=1e-6)
    # the route bwd_route names for the operands, by default
    default = mod.backward_plain(x, we, be, wd, err, coeffs, *extra)
    assert all(torch.equal(a, b) for a, b in zip(default, pair))


def test_probe_sae_grid_times_pair_launches():
    """chip_bwd_probe.py's route grid for the ReLU SAE (the evidence for the
    rule's "sae" widths) times only launches that the rule gives the pair at
    shapes the bodies take, C 8 to PAIR_C, one level, and three prefix levels
    in multiples of 128 at C 256."""
    import chip_bwd_probe as probe

    assert "sae" in probe.GRID_ACTS
    for c in probe.GRID_C:
        assert bwd_route(c, c, act="sae") == "pair"
    for e in probe.GRID_EXP:
        h = 256 * e
        lv = probe.levels_of(h)
        assert fused_matryoshka_sae.can_fuse_matryoshka(4096, h, lv, 256)
        assert len(lv) == 3 and bwd_route(256, 256, 3, act="sae") == "pair"


def test_route_slices_script_stands_alone():
    """chip_route_slices.py runs on the card beside chip_smoke.py: it imports
    neither JAX nor the JAX package, and runs each route twice in turns that
    mirror (pair, tc, tc, pair), so that neither route always runs first."""
    import ast
    from pathlib import Path

    import chip_route_slices

    path = Path(chip_route_slices.__file__)
    names = set()
    for node in ast.walk(ast.parse(path.read_text())):
        if isinstance(node, ast.Import):
            names.update(a.name.split(".")[0] for a in node.names)
        elif isinstance(node, ast.ImportFrom) and node.module:
            names.add(node.module.split(".")[0])
    assert names.isdisjoint({"jax", "jaxlib", "sparse_vision_tpu"}), names
    assert "chip_smoke" in names
    order = chip_route_slices.ORDER
    assert sorted(order) == ["pair", "pair", "tc", "tc"] and order == order[::-1]


# ---------------------------------------------------------------------------
# the gated SAE's pair route: its wrappers (the stand-in library) and its plain
# version against JAX
# ---------------------------------------------------------------------------

def _gated_launch(kernel, n: int = 0, dtype=BF16, c: int = PC, **kw):
    """One gated backward launch through ``kernel`` at (PT, c, PH) on zeros:
    one dictionary (n 0) or a sweep of n combos."""
    lead = (n,) if n else ()
    ops = (_z(PT, c, dtype=dtype), _z(*lead, c, PH, dtype=dtype), _z(*lead, PH), _z(*lead, PH),
           _z(*lead, PH) + 1.0, _z(*lead, PH, c, dtype=dtype), _z(*lead, c))
    return kernel(*ops, _z(*lead, PT, c), _z(*lead, PT, c), _z(*lead, 3), **kw)


GATED_WRAPPERS = {"one card": (fused_gated_sae.bwd_kernel, 0),
                  "TP shard": (fused_sae_tp.gated_bwd_kernel, 0),
                  "sweep of 3": (fused_gated_sae.sweep_bwd_kernel, 3)}


@pytest.mark.parametrize("which", list(GATED_WRAPPERS))
def test_gated_pair_route_flag_split_and_counts(libs, monkeypatch, which):
    """Where the rule gives the gated backward the pair (bf16, C <= 256, one
    level), its three wrappers pass ``pair`` 1 with the pair's split and a
    workspace of two ticket arrays, and count one launch of their own and one
    of coder_bwd_pair<Act::Gated> (fused_gated_sae.pair_kernel); route "tc"
    passes 0 with coder_bwd_tc's split and counts no pair launch; the unsplit
    launch passes no workspace."""
    kernel, n = GATED_WRAPPERS[which]
    monkeypatch.setattr(fused_gated_sae.pair_kernel, "launches", 0)
    monkeypatch.setattr(kernel, "launches", 0)
    assert bwd_route(PC, PC, act="gated") == "pair"
    entry = "svt_gated_sweep_bwd" if n else "svt_gated_bwd"
    names = [p for _, p in DECLS[entry]]
    pair_s = grid_split(PT, PH, PC, backward=True, n_sm=N_SM, pair=True)
    tc_s = grid_split(PT, PH, PC, backward=True, n_sm=N_SM)
    assert (pair_s, tc_s) == (2, 4)
    ws = fused_sae.split_workspace  # the workspaces the wrapper allocates, by route
    sizes = []
    monkeypatch.setattr(fused_gated_sae, "split_workspace",
                        lambda *a, **k: sizes.append((a, k)) or ws(*a, **k))
    for i, (kw, flag, s, pairs) in enumerate((({}, 1, pair_s, 1), ({"route": "tc"}, 0, tc_s, 1),
                                              ({"n_split": 1}, 1, 1, 2))):
        outs = _gated_launch(kernel, n, **kw)
        args = getattr(libs[fused_gated_sae], entry).calls[-1]
        assert args[names.index("pair")] == flag, kw
        assert args[names.index("n_split")] == s, kw
        assert (args[names.index("split_ws")] is None) == (s == 1), kw
        assert sizes[-1][0][0] == s and sizes[-1][0][1] == max(n, 1)
        assert sizes[-1][0][-1] == ("pair" if flag else "tc")
        assert kernel.launches == i + 1
        assert fused_gated_sae.pair_kernel.launches == pairs, kw
        lead = (n,) if n else ()
        assert outs[0].shape == (*lead, PC, PH) and outs[4].shape == (*lead, PH, PC)


@pytest.mark.parametrize("which", list(GATED_WRAPPERS))
def test_gated_pair_route_not_taken_in_f32_or_past_its_width(libs, monkeypatch, which):
    """The f32 check path and a width past PAIR_C (C 264) pass ``pair`` 0 and
    count no pair launch; a route the gated entry points do not have raises
    before any launch."""
    kernel, n = GATED_WRAPPERS[which]
    monkeypatch.setattr(fused_gated_sae.pair_kernel, "launches", 0)
    monkeypatch.setattr(kernel, "launches", kernel.launches)
    entry = "svt_gated_sweep_bwd" if n else "svt_gated_bwd"
    names = [p for _, p in DECLS[entry]]
    lib = libs[fused_gated_sae]
    _gated_launch(kernel, n, dtype=F32)
    args = getattr(lib, entry).calls[-1]
    assert args[names.index("pair")] == 0 and args[names.index("n_split")] == 1
    assert bwd_route(264, 264, act="gated") == "tc"
    _gated_launch(kernel, n, c=264)
    args = getattr(lib, entry).calls[-1]
    assert args[names.index("pair")] == 0
    assert args[names.index("n_split")] == grid_split(PT, PH, 264, backward=True, n_sm=N_SM)
    assert fused_gated_sae.pair_kernel.launches == 0
    calls = len(getattr(lib, entry).calls)
    with pytest.raises(ValueError, match="held"):
        _gated_launch(kernel, n, route="held")
    assert len(getattr(lib, entry).calls) == calls


# T 1,152 (two 512-token steps and a partial one), C 16, H 256
GT, GC, GH = 1152, 16, 256
LAMBDA_G = 0.7
GKEYS = ("W_gate", "b_gate", "b_mag", "r_mag", "W_dec", "b_dec")


@pytest.fixture(scope="module")
def gated_ties():
    """Gated parameters and tokens on a dyadic grid (x and b_dec in quarters,
    W_gate and W_dec in 1/256ths, b_gate and b_mag odd multiples of 2^-11,
    exp(r_mag) 1, 2 or 1/2, as tests/test_torch_fused_gated_sae.py's ``wide``
    fixture): the gate product, both decodes and so the residuals are exact in
    f32 in both packages, so a bf16 rounding of c·err, which 1,152 tokens'
    summation orders could otherwise flip, rounds the same value. Planted
    ties: 8 latents whose W_gate column and b_gate are 0, so that pre_gate is
    exactly 0 at every token (the gate's 0.5) while b_mag > 0 keeps pre_mag >
    0 (d_premag = denc·0.5 flows into dW_dec, b_mag and r_mag); 16 gates that
    never open."""
    params = jax.device_get(init_gated_sae(jax.random.key(3), GC, GH // GC))
    rng = np.random.default_rng(7)

    def odd(n):
        return ((2 * rng.integers(-40, 40, size=n) + 1) * 2.0 ** -11).astype(np.float32)

    ties = np.arange(20, 28)
    w_gate = _grid(params["W_gate"], 2.0 ** -8)
    w_gate[:, ties] = 0.0
    b_gate, b_mag = odd(GH), odd(GH)
    b_gate[ties] = 0.0
    b_mag[ties] = 0.25
    b_gate[:16] = -50.0 - 2.0 ** -11
    r_mag = (np.log(2.0) * rng.integers(-1, 2, size=GH)).astype(np.float32)
    params = {**params, "W_gate": w_gate, "W_dec": _grid(params["W_dec"], 2.0 ** -8),
              "b_gate": b_gate, "b_mag": b_mag, "r_mag": r_mag,
              "b_dec": _grid(0.2 * rng.normal(size=GC), 0.25)}
    x = _grid(np.random.default_rng(4).normal(size=(GT, GC)), 0.25)
    return params, x, ties


def test_gated_pair_plain_matches_jax(monkeypatch, gated_ties):
    """The port's bf16 gated op on the CPU, whose backward takes the pair
    route's plain version (ROUTE_PLAIN["pair"]: the pre-pass on both errors,
    round(c_rec·err_rec) with its per-step direct rows of db_dec and
    round(c_aux·err_via), then the gated epilogue), against the JAX op's
    gradients (its _bwd_kernel in interpret mode, through the op's custom
    VJP), at tests/test_torch_fused_gated_sae.py's bf16 tolerances: dW_gate to
    2^-8 of its largest entry, db_dec to 1e-2, the rest rtol 1e-4, atol 1e-6.
    The planted ties (pre_gate == 0) get the 0.5 gate on both sides: their
    b_mag gradient is half the full gate's and their db_gate is 0. C 16 is
    below GATED_PAIR_MIN_C, so the rule is made to name the pair here, as it
    does from C 136."""
    params, x, ties = gated_ties
    assert bwd_route(GC, GC, act="gated", dtype=BF16) == "tc"
    assert bwd_route(136, 136, act="gated", dtype=BF16) == "pair"
    monkeypatch.setattr(fused_gated_sae, "bwd_route", lambda *a, **k: "pair")
    ran = []
    pair_plain = fused_gated_sae.ROUTE_PLAIN["pair"]
    monkeypatch.setitem(fused_gated_sae.ROUTE_PLAIN, "pair",
                        lambda *a: ran.append(a[0].dtype) or pair_plain(*a))
    jx = jnp.asarray(x)
    jgrad = jax.device_get(jax.grad(lambda p: jax_gated(
        p, jx, LAMBDA_G, GH // GC, compute_dtype=jnp.bfloat16, tile_t=64, tile_h=128,
        interpret=True)["loss"])({k: jnp.asarray(v) for k, v in params.items()}))
    tp = {k: v.requires_grad_(True) for k, v in convert.sae_params_from_jax(params).items()}
    loss = fused_gated_sae.fused_gated_sae_loss_terms(tp, torch.from_numpy(x), LAMBDA_G,
                                                      GH // GC, compute_dtype=BF16)["loss"]
    got = dict(zip(tp, torch.autograd.grad(loss, list(tp.values()))))
    assert ran == [BF16]  # one backward, on the pair route's plain version
    for k in GKEYS:
        ref = np.asarray(jgrad[k])
        rtol, atol = {"W_gate": (0, 2.0 ** -8 * np.abs(ref).max()),
                      "b_dec": (0, 1e-2 * np.abs(ref).max())}.get(k, (1e-4, 1e-6))
        np.testing.assert_allclose(got[k].numpy(), ref, rtol=rtol, atol=atol, err_msg=k)
        assert np.abs(ref).max() > 0, k
    # the ties: pre_gate exactly 0, so d_pregate is 0 and the 0.5 gate scales d_premag
    assert not got["b_gate"][ties].any() and got["b_mag"][ties].abs().min() > 0
    assert 0 < int((got["b_gate"] != 0).sum()) < GH


def test_gated_route_plain_names_the_route():
    """The gated backward_plain takes the route's plain version: bwd_route's
    for the operands (pair in bf16 at C <= 256, simt in f32) or the one named;
    "pair" and "tc" are the same function, bit for bit."""
    g = torch.Generator().manual_seed(0)
    t, c, h = 256, 40, 128
    for cd in (F32, BF16):
        x = torch.randn(t, c, generator=g).to(cd)
        wg = (torch.randn(c, h, generator=g) / 7).to(cd)
        wd = (torch.randn(h, c, generator=g) / 11).to(cd)
        ops = (x, wg, 0.1 * torch.randn(h, generator=g), 0.1 * torch.randn(h, generator=g),
               torch.exp(0.1 * torch.randn(h, generator=g)), wd, 0.1 * torch.randn(c, generator=g))
        args = (*ops, torch.randn(t, c, generator=g), torch.randn(t, c, generator=g),
                torch.tensor([1e-3, 1e-2, 2e-3]))
        want = (fused_gated_sae.gated_bwd_tc_plain if cd == BF16
                else fused_gated_sae.fused_gated_backward_plain)(*args)
        for route in (None, "pair" if cd == BF16 else "simt"):
            got = fused_gated_sae.backward_plain(*args, route=route)
            assert all(torch.equal(a, b) for a, b in zip(got, want)), (cd, route)
        if cd == BF16:
            tc = fused_gated_sae.backward_plain(*args, route="tc")
            assert all(torch.equal(a, b) for a, b in zip(tc, want))
