"""The held backward route (sparse_vision_tpu_torch/csrc/coder.cuh coder_bwd_held):
the rule that picks it (ops/fused_sae.bwd_route) and its two passes' plain
versions against the JAX package's backward kernels.

On the card the route is two launches over the same latent blocks: pass E
holds dW_enc in registers for its whole token sweep (with db_enc), pass D
holds dW_dec (with db_dec's direct rows) and recomputes pre. The rule gives it
to the transcoder (C_in <= 256 < C_out <= 512); the SAE's backward keeps
coder_bwd_tc, but its passes compute the same function on x_cent, so the
plain versions are held to the SAE's JAX kernel too. Each pass has a plain
PyTorch version (coder_bwd_enc_plain, coder_bwd_dec_plain) that
chip_smoke.py holds the pass to; together they are coder_backward_plain, the
CPU path of every backward route. Here each pass's plain version is held to the matching outputs of the
JAX op's backward kernel (fused_sae.py:_bwd_kernel through the op's custom
VJP, fused_transcoder.py:_bwd_kernel through _run_bwd_kernel), run in
interpret mode as the JAX package's own tests run it, on the same numpy inputs.

Tolerances: f32 rtol 1e-4 (the frameworks sum the tokens in other orders); in
bf16 dW_enc to 2^-8 of its largest entry (a pre-activation within rounding of
0 may switch a latent on one side only, and round(dpre) then differs by a bf16
ulp), the rest rtol 1e-4; db_dec (the SAE's) to 1e-2 of its largest entry in
bf16, where the JAX kernel rounds each token tile's db_enc partial and the port
rounds the whole db_enc once (ops/fused_sae.py's module docstring).
"""

import jax
import jax.numpy as jnp
import ml_dtypes
import numpy as np
import pytest
import torch

from sparse_vision_tpu.models.sae import init_sae_mlp
from sparse_vision_tpu.ops import fused_transcoder as jax_transcoder
from sparse_vision_tpu.ops.fused_sae import make_fused_sae_op
from sparse_vision_tpu_torch import convert
from sparse_vision_tpu_torch.ops import fused_sae
from sparse_vision_tpu_torch.ops.fused_sae import bwd_route

torch.set_num_threads(1)

BF16 = torch.bfloat16
F32 = torch.float32

# (label, C_in, C_out, prefix levels, epilogue, dtype) -> the body; the
# shapes of PERF.md section 4 (the training widths, on a rank's shard and in the
# sweep alike: the rule reads no T or H). At C 256 the held passes were no
# faster than coder_bwd_tc on the card, nor was a coder_bwd_tc that held both
# tiles in registers (PERF.md, "Findings"); the cluster pair was, so the SAEs'
# rows 2, 16 and 28 (epilogue "sae") take it, and the coders ("relu", whose
# entry point has no pair) keep coder_bwd_tc at C_out 256
ROUTES = {
    "row 2 sae_mlp backward (C 256)": (256, 256, 1, "sae", BF16, "pair"),
    "row 12 transcoder backward (256 -> 480)": (256, 480, 1, "relu", BF16, "held"),
    "row 16 sae_mlp TP backward (shard, C 256)": (256, 256, 1, "sae", BF16, "pair"),
    "row 24 transcoder TP backward (shard, 256 -> 480)": (256, 480, 1, "relu", BF16, "held"),
    "row 28 sae_mlp sweep backward (C 256)": (256, 256, 1, "sae", BF16, "pair"),
    "rows 14, 26 crosscoder backward (ΣC 2,896)": (2896, 2896, 1, "relu", BF16, "tc"),
    "rows 5, 20, 32 JumpReLU backward": (256, 256, 1, "jump", BF16, "pair"),
    "rows 7, 18, 30 gated backward": (256, 256, 1, "gated", BF16, "pair"),
    "rows 9, 22, 34 Matryoshka backward (3 levels)": (256, 256, 3, "sae", BF16, "pair"),
    "phase 12 SAE C 512": (512, 512, 1, "sae", BF16, "tc"),
    "phase 12 SAE C 768": (768, 768, 1, "sae", BF16, "tc"),
    "phase 12 transcoder 768 -> 768": (768, 768, 1, "relu", BF16, "tc"),
    "phase 10 transcoder 528 -> 832": (528, 832, 1, "relu", BF16, "tc"),
    "ragged coder pair, C_in 264 -> 136": (264, 136, 1, "relu", BF16, "tc"),
    "C8's ragged held transcoder, 136 -> 264": (136, 264, 1, "relu", BF16, "held"),
    "C_out 520 (past the held 512)": (256, 520, 1, "relu", BF16, "tc"),
    "row 2 in f32 (the check path)": (256, 256, 1, "sae", F32, "simt"),
    "row 12 in f32": (256, 480, 1, "relu", F32, "simt"),
    "crosscoder in f32": (2896, 2896, 1, "relu", F32, "simt"),
}


@pytest.mark.parametrize("label", list(ROUTES))
def test_route_at_table_shapes(label):
    c_in, c_out, levels, act, dtype, want = ROUTES[label]
    assert bwd_route(c_in, c_out, levels, act, dtype) == want
    # the dtype may also come by name, as RunConfig.compute_dtype gives it
    name = "bfloat16" if dtype == BF16 else "float32"
    assert bwd_route(c_in, c_out, levels, act, name) == want


@pytest.mark.parametrize("c_in", (8, 128, 256, 264))
@pytest.mark.parametrize("c_out", (8, 256, 264, 480, 512, 520))
def test_route_boundary(c_in, c_out):
    """The held route takes exactly the widths whose tiles its registers hold
    and at which it beat coder_bwd_tc: C_in <= 256 < C_out <= 512."""
    held = c_in <= fused_sae.HELD_CIN and fused_sae.HELD_MIN_COUT < c_out <= fused_sae.HELD_COUT
    assert (bwd_route(c_in, c_out) == "held") == held
    # the JumpReLU epilogue takes the cluster pair at one width up to 256 (one
    # level), the gated one from 136 to 256 (one level), and the ReLU and
    # Matryoshka SAEs' at any levels (tests/test_torch_bwd_pair.py); the
    # coders' levels never leave coder_bwd_tc
    pair = c_in == c_out <= fused_sae.PAIR_C
    assert bwd_route(c_in, c_out, act="jump") == ("pair" if pair else "tc")
    assert bwd_route(c_in, c_out, act="sae") == ("pair" if pair else "tc")
    assert bwd_route(c_in, c_out, levels=2, act="sae") == ("pair" if pair else "tc")
    gated = pair and c_in > fused_sae.GATED_PAIR_MIN_C
    assert bwd_route(c_in, c_out, act="gated") == ("pair" if gated else "tc")
    assert bwd_route(c_in, c_out, levels=2, act="gated") == "tc"
    assert bwd_route(c_in, c_out, levels=2) == "tc"


# ---------------------------------------------------------------------------
# the passes' plain versions against the JAX backward kernels
# ---------------------------------------------------------------------------

T, C, H_EXP = 128, 64, 4
LAMBDA = 0.7
JTILES = dict(tile_t=64, tile_h=128, interpret=True)
JDT = {"float32": jnp.float32, "bfloat16": jnp.bfloat16}
TDT = {"float32": F32, "bfloat16": BF16}


def _t(a: np.ndarray, dtype) -> torch.Tensor:
    """numpy f32 -> torch in ``dtype``, through ml_dtypes' bf16 as JAX rounds."""
    if dtype == BF16:
        return torch.from_numpy(np.asarray(a, np.float32).astype(ml_dtypes.bfloat16)
                                .view(np.uint16)).view(BF16)
    return torch.from_numpy(np.asarray(a, np.float32))


def _close(got, want, name, cd, dw_enc=False, db_dec=False):
    want = np.asarray(want, np.float32)
    if cd == "float32":
        rtol, atol = 1e-4, 1e-6 * np.abs(want).max()
    elif dw_enc:
        rtol, atol = 0.0, 2.0 ** -8 * np.abs(want).max()
    elif db_dec:
        rtol, atol = 0.0, 1e-2 * np.abs(want).max()
    else:
        rtol, atol = 1e-4, 1e-6
    np.testing.assert_allclose(got.numpy(), want, rtol=rtol, atol=atol, err_msg=name)


@pytest.fixture(scope="module")
def sae_setup():
    params = init_sae_mlp(jax.random.key(0), C, H_EXP)
    # 16 latents can never fire (dead), the rest fire on part of the tokens
    b_enc = (params["b_enc"] - 0.1).at[:16].add(-100.0)
    params = jax.device_get({**params, "b_enc": b_enc, "b_dec": params["b_dec"] + 0.05})
    x = np.random.default_rng(1).normal(size=(T, C)).astype(np.float32)
    return params, x


@pytest.mark.parametrize("cd", ["float32", "bfloat16"])
def test_sae_passes_match_jax(sae_setup, cd):
    """sae_mlp at T 128, C 64, H 256 (the passes on x_cent): pass E's (dW_enc,
    db_enc) and pass D's (dW_dec, db_dec's direct term, with the centring row
    of pass E's db_enc) against the gradients of the JAX op's loss rec + λ·l1
    (its backward kernel, interpret mode), on the error of the JAX forward."""
    params, x = sae_setup
    op = make_fused_sae_op(compute_dtype=JDT[cd], **JTILES)
    jx = jnp.asarray(x)
    grads = jax.grad(lambda p: op(p, jx)["rec_loss"] + LAMBDA * op(p, jx)["l1_loss"])(params)
    err = np.asarray(op(params, jx)["recon"]) - x
    td = TDT[cd]
    tp = convert.sae_params_from_jax(params)
    h = tp["b_enc"].shape[0]
    x_cent = fused_sae.center_plain(_t(x, td), tp["b_dec"])
    we, be, wd = tp["W_enc"].to(td), tp["b_enc"], tp["W_dec"].to(td)
    c_rec, c_l1 = torch.tensor(2.0 / (T * C)), torch.tensor(LAMBDA / (T * h))
    dw_enc, db_enc = fused_sae.coder_bwd_enc_plain(x_cent, we, be, wd, _t(err, td), c_rec, c_l1)
    dw_dec, direct = fused_sae.coder_bwd_dec_plain(x_cent, we, be, _t(err, td), c_rec)
    _close(dw_enc, grads["W_enc"], "pass E dW_enc", cd, dw_enc=True)
    _close(db_enc, grads["b_enc"], "pass E db_enc", cd)
    _close(dw_dec, grads["W_dec"], "pass D dW_dec", cd)
    db_dec = direct + fused_sae.centring_rows_plain(db_enc, we)[0]
    _close(db_dec, grads["b_dec"], "pass D db_dec (+ pass E's centring row)", cd, db_dec=True)
    # some latents fire, some never do: the mask matters on both sides
    assert 0 < int((db_enc != 0).sum()) < h


@pytest.mark.parametrize("cd", ["float32", "bfloat16"])
@pytest.mark.parametrize("c_in,c_out", [(32, 40), (64, 24)])
def test_transcoder_passes_match_jax(cd, c_in, c_out):
    """The transcoder at ragged widths (32 -> 40, the 256 -> 480 of rows 12 and
    24 cut to size; and 64 -> 24), T 128, H 256: each pass's plain version
    against the JAX backward kernel (_run_bwd_kernel, interpret mode) on the
    same x, weights, error and coefficients."""
    rng = np.random.default_rng(3)
    t, h = T, 256
    x = rng.normal(size=(t, c_in)).astype(np.float32)
    we = (rng.normal(size=(c_in, h)) / np.sqrt(c_in)).astype(np.float32)
    be = (0.1 * rng.normal(size=(h,)) - 0.05).astype(np.float32)
    be[:16] -= 100.0  # never fire
    wd = (rng.normal(size=(h, c_out)) / np.sqrt(h)).astype(np.float32)
    bd = (0.1 * rng.normal(size=(c_out,))).astype(np.float32)
    err = (0.3 * rng.normal(size=(t, c_out))).astype(np.float32)
    coeffs = np.array([[2.0 / (t * c_out), LAMBDA / (t * h)]], np.float32)
    jcd = JDT[cd]

    def cast(a):
        return a.astype(jcd) if jcd != jnp.float32 else a

    params = {"W_enc": jnp.asarray(we), "b_enc": jnp.asarray(be), "W_dec": jnp.asarray(wd),
              "b_dec": jnp.asarray(bd)}
    j_dw_enc, j_db_enc, j_dw_dec, j_db_dec = jax_transcoder._run_bwd_kernel(
        params, jnp.asarray(x), jnp.asarray(err), jnp.asarray(coeffs), 64, 128, jcd, True, cast)
    td = TDT[cd]
    tx, twe, twd, terr = _t(x, td), _t(we, td), _t(wd, td), _t(err, td)
    tbe = torch.from_numpy(be)
    c_rec, c_l1 = torch.tensor(coeffs[0, 0]), torch.tensor(coeffs[0, 1])
    dw_enc, db_enc = fused_sae.coder_bwd_enc_plain(tx, twe, tbe, twd, terr, c_rec, c_l1)
    dw_dec, db_dec = fused_sae.coder_bwd_dec_plain(tx, twe, tbe, terr, c_rec)
    _close(dw_enc, j_dw_enc, "pass E dW_enc", cd, dw_enc=True)
    _close(db_enc, j_db_enc[0], "pass E db_enc", cd)
    _close(dw_dec, j_dw_dec, "pass D dW_dec", cd)
    _close(db_dec, j_db_dec[0], "pass D db_dec", cd)
    assert 0 < int((db_enc != 0).sum()) < h


@pytest.mark.parametrize("cd", [F32, BF16])
def test_passes_compose_to_the_backward_plain(cd):
    """Pass E's and pass D's plain versions together are coder_backward_plain,
    bit for bit: the CPU path of every backward route."""
    g = torch.Generator().manual_seed(0)
    t, c_in, c_out, h = 256, 48, 40, 128
    x = torch.randn(t, c_in, generator=g).to(cd)
    we = (torch.randn(c_in, h, generator=g) / 7).to(cd)
    be = 0.1 * torch.randn(h, generator=g)
    wd = (torch.randn(h, c_out, generator=g) / 11).to(cd)
    err = torch.randn(t, c_out, generator=g).to(cd)
    c_rec, ct = torch.tensor(1e-3), 1e-4 * torch.rand(h, generator=g)
    whole = fused_sae.coder_backward_plain(x, we, be, wd, err, c_rec, ct)
    parts = (*fused_sae.coder_bwd_enc_plain(x, we, be, wd, err, c_rec, ct),
             *fused_sae.coder_bwd_dec_plain(x, we, be, err, c_rec))
    assert all(torch.equal(a, b) for a, b in zip(whole, parts))
