"""The cluster-pair backward route (sparse_vision_tpu_torch/csrc/coder.cuh
coder_bwd_pair): the rule that picks it (ops/fused_sae.bwd_route), the grid
split of its launches (ops/fused_sae.grid_split), the JumpReLU wrappers that
pass both to the C entry points, and its plain version against the JAX
package's JumpReLU backward kernel.

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

from sparse_vision_tpu.ops.fused_jumprelu_sae import fused_jumprelu_sae_loss_terms as jax_fused
from sparse_vision_tpu_torch.ops import fused_jumprelu_sae, fused_sae, fused_sae_tp
from sparse_vision_tpu_torch.ops.fused_sae import bwd_route, grid_split
from test_torch_bwd_held import _t
from test_torch_grid_split import DECLS, N_SM, _z, libs  # noqa: F401 (libs: a fixture)

torch.set_num_threads(1)

BF16 = torch.bfloat16
F32 = torch.float32

# (label, C_in, C_out, prefix levels, activation, dtype) -> the body, at the
# shapes of PERF.md's kernel table and the rule's boundaries. It reads no T or
# H: on the card, each at its own split, the pair's body beat coder_bwd_tc's
# at every width from 8 to 256 and every T and H of chip_bwd_probe.py's route
# grid; past C 256 its gradient tile does not fit in a CTA's registers
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
    "rows 2, 16, 28 ReLU backward (C 256)": (256, 256, 1, "relu", BF16, "tc"),
    "rows 7, 18, 30 gated backward (C 256)": (256, 256, 1, "gated", BF16, "tc"),
    "rows 9, 22, 34 Matryoshka backward (3 levels)": (256, 256, 3, "relu", BF16, "tc"),
    "row 12 transcoder backward (256 -> 480)": (256, 480, 1, "relu", BF16, "held"),
    "row 5 in f32 (the check path)": (256, 256, 1, "jump", F32, "simt"),
    "C 136 in f32": (136, 136, 1, "jump", F32, "simt"),
}


@pytest.mark.parametrize("label", list(ROUTES))
def test_route_at_table_shapes(label):
    c_in, c_out, levels, act, dtype, want = ROUTES[label]
    assert bwd_route(c_in, c_out, levels, act, dtype) == want
    name = "bfloat16" if dtype == BF16 else "float32"
    assert bwd_route(c_in, c_out, levels, act, name) == want


@pytest.mark.parametrize("c", (8, 64, 136, 248, 256, 264, 512))
@pytest.mark.parametrize("act", ("jump", "relu", "gated"))
@pytest.mark.parametrize("levels", (1, 3))
def test_route_boundary(c, act, levels):
    """The pair takes exactly a bf16 JumpReLU backward of one level whose
    width its registers hold (C <= PAIR_C); f32 is SIMT's."""
    pair = act == "jump" and levels == 1 and c <= fused_sae.PAIR_C
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
    """chip_bwd_probe.py's route grid (the evidence for the rule's widths)
    times only launches that the rule gives the pair at shapes the bodies
    take, from C 8 to PAIR_C, at T 4,096 and 32,768; its split grid has
    launches the rule splits in 2 and in 4, each at one dictionary and a
    sweep."""
    import chip_bwd_probe as probe

    widths = set()
    for c in probe.GRID_C:
        for e in probe.GRID_EXP:
            h = max(128, -(-c * e // 128) * 128)
            for t in probe.GRID_T:
                assert fused_sae.bodies_take(t, h, c, c)
                assert bwd_route(c, c, act="jump") == "pair"
                widths.add(c)
    assert min(widths) == fused_sae.BF16_WIDTH and max(widths) == fused_sae.PAIR_C
    assert set(probe.GRID_T) == {4096, 32768}
    splits = {grid_split(t, h, c, backward=True, n_sm=N_SM, pair=True)
              for t, h, c in probe.SPLIT_SHAPES}
    assert splits == {2, 4} and probe.SPLIT_N > 1


@pytest.mark.parametrize("i", range(3))
def test_smoke_pair_widths_take_the_pair(i):
    """chip_smoke.py's PAIR_WIDTHS are launches the rule gives the pair (C 64
    and 192, the backbones' narrower widths), on both sides of the split
    rule's boundary: whole at expansion 64, split in 4 at C 64, H 1,024."""
    import chip_smoke

    t, c, h = chip_smoke.PAIR_WIDTHS[i]
    assert bwd_route(c, c, act="jump") == "pair" and fused_sae.bodies_take(t, h, c, c)
    want = 4 if h == 1024 else 1
    assert grid_split(t, h, c, backward=True, n_sm=N_SM, pair=True) == want
    assert len(chip_smoke.PAIR_WIDTHS) == 3


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


def test_pair_clusters_query_is_bound(libs):
    """svt_jumprelu_pair_clusters (the build phase's cluster occupancy) is
    bound with its one pointer argument."""
    lib = libs[fused_jumprelu_sae]
    assert lib.svt_jumprelu_pair_clusters.argtypes == [fused_jumprelu_sae._P]
    assert fused_jumprelu_sae.pair_clusters() == 0  # the stand-in writes nothing


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
