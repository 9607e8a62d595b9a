"""The port's fused SAE op (plain versions of the CUDA kernels, the CPU path)
against the JAX fused_sae_loss_terms run as tests/test_fused_sae.py runs it:
Pallas interpret mode, small tiles.

Tolerances:
- f32 compute: forward values rtol 1e-5; dead, activity and sparsity exact;
  gradients of rec + λ·l1 at rtol 1e-4, atol 1e-7 (tests/test_fused_sae.py).
- bf16 compute: the cast points are the same on both sides, so the forward,
  db_enc and dW_dec agree to f32 summation order (rtol 1e-4: a bf16 rounding of
  an operand may flip when its f32 value moved by one ulp). Two outputs need
  more room, for reasons on the JAX side:
  * dW_enc: the interpret-mode Pallas kernel's transposed bf16 product
    (x_centᵀ·dpre) differs from the same formula written in plain jnp by up to
    0.2% of max|dW_enc|; the port equals that plain-jnp formula exactly
    (test_bf16_backward_equals_jnp_replica). Tolerance: one bf16 ulp (2^-8) of
    max|dW_enc|.
  * db_dec: its centring term multiplies a bf16-rounded db_enc; the TPU kernel
    rounds each token tile's partial sum, the port the whole batch's sum once,
    so each term can differ by a bf16 half-ulp of db_enc: 1e-2 of max|db_dec|.
- dx (compute_dx=True, the dx entry point's plain version): f32 rtol 1e-4, atol
  1e-7 (tests/test_fused_sae.py:52); bf16 one bf16 ulp of max|dx|, since its
  product round(dpre)·W_encᵀ is a transposed bf16 product in the Pallas kernel;
  with a bf16 x (bf16_cache) autograd rounds the port's dx to bf16, which the
  same ulp covers (the JAX op returns it in f32).
- C = 480 (a width the coder bodies take and the old SAE kernels did not): the
  same tolerances, with the [T, C] reconstructions atol 2e-5 besides (both
  sides sum 512 latents' products in f32, in other orders).
The CPU path is the one the card runs, with the entry points' plain versions
where the CUDA calls stand: the centring, the partial rows and their
reductions are the same glue (test_entry_points_compose_to_the_reference).
"""

import functools

import jax
import jax.numpy as jnp
import ml_dtypes
import numpy as np
import pytest
import torch

from sparse_vision_tpu.models.sae import init_sae_mlp
from sparse_vision_tpu.ops.fused_sae import fused_sae_loss_terms as jax_fused
from sparse_vision_tpu_torch import convert
from sparse_vision_tpu_torch.ops import fused_sae

T, C, H_EXP = 128, 64, 4
LAMBDA = 0.7
JTILES = dict(tile_t=64, tile_h=128, interpret=True)
CASES = {
    # name: (compute dtype, x dtype)
    "f32": ("float32", "float32"),
    "bf16": ("bfloat16", "float32"),
    "bf16_cache": ("bfloat16", "bfloat16"),  # x straight from a bf16 activation cache
}
JDT = {"float32": jnp.float32, "bfloat16": jnp.bfloat16}
TDT = {"float32": torch.float32, "bfloat16": torch.bfloat16}


@pytest.fixture(scope="module")
def setup():
    params = init_sae_mlp(jax.random.key(0), C, H_EXP)
    # 16 latents can never fire (dead), the rest fire on part of the tokens
    b_enc = (params["b_enc"] - 0.1).at[:16].add(-100.0)
    params = jax.device_get({**params, "b_enc": b_enc, "b_dec": params["b_dec"] + 0.05})
    x = np.random.default_rng(1).normal(size=(T, C)).astype(np.float32)
    return params, x


def _inputs(setup, x_dtype):
    params, x = setup
    if x_dtype == "bfloat16":
        xb = x.astype(ml_dtypes.bfloat16)
        return params, jnp.asarray(xb), torch.from_numpy(xb.view(np.uint16)).view(torch.bfloat16)
    return params, jnp.asarray(x), torch.from_numpy(x)


def _run(setup, case):
    cd, xd = CASES[case]
    params, jx, tx = _inputs(setup, xd)
    jout = jax_fused(params, jx, LAMBDA, H_EXP, compute_dtype=JDT[cd], **JTILES)
    jgrad = jax.grad(lambda p: jax_fused(p, jx, LAMBDA, H_EXP, compute_dtype=JDT[cd],
                                         **JTILES)["loss"])(params)
    tp = {k: v.requires_grad_(True) for k, v in convert.sae_params_from_jax(params).items()}
    tout = fused_sae.fused_sae_loss_terms(tp, tx, LAMBDA, H_EXP, compute_dtype=TDT[cd])
    tgrad = dict(zip(tp, torch.autograd.grad(tout["loss"], list(tp.values()))))
    return jout, jgrad, tout, tgrad


@pytest.mark.parametrize("case", list(CASES))
def test_forward_matches_jax(setup, case):
    jout, _, tout, _ = _run(setup, case)
    rtol = 1e-5 if case == "f32" else 1e-4
    for k in ("loss", "rec_loss", "l1_loss", "nrmse_loss", "rmse_loss", "aux_loss"):
        np.testing.assert_allclose(float(tout[k].detach()), float(jout[k]), rtol=rtol, err_msg=k)
    np.testing.assert_allclose(tout["decoded"].detach().numpy(), np.asarray(jout["decoded"]),
                               rtol=rtol, atol=1e-6)
    np.testing.assert_array_equal(tout["dead"].numpy(), np.asarray(jout["dead"]))
    np.testing.assert_array_equal(tout["activity_freq"].numpy(),
                                  np.asarray(jout["activity_freq"]))
    np.testing.assert_allclose(float(tout["sparsity"]), float(jout["sparsity"]), rtol=1e-6)
    assert bool(jout["dead"].any()) and not bool(jout["dead"].all())


@pytest.mark.parametrize("case", list(CASES))
def test_gradients_match_jax(setup, case):
    _, jgrad, _, tgrad = _run(setup, case)
    for k in ("W_enc", "b_enc", "W_dec", "b_dec"):
        ref = np.asarray(jgrad[k])
        if case == "f32":
            rtol, atol = 1e-4, 1e-7
        else:
            rtol, atol = {"W_enc": (0, 2.0**-8 * np.abs(ref).max()),
                          "b_dec": (0, 1e-2 * np.abs(ref).max())}.get(k, (1e-4, 1e-6))
        np.testing.assert_allclose(tgrad[k].numpy(), ref, rtol=rtol, atol=atol, err_msg=k)


@pytest.mark.parametrize("case", ["f32", "bf16"])
def test_dx_matches_jax(setup, case):
    """With compute_dx=True both ops give x its gradient; without it the port's
    is None (the JAX op's zero cotangent)."""
    cd, _ = CASES[case]
    params, x = setup
    jgx = jax.grad(lambda xx: jax_fused(params, xx, LAMBDA, H_EXP, compute_dtype=JDT[cd],
                                        compute_dx=True, **JTILES)["loss"])(jnp.asarray(x))
    tp = convert.sae_params_from_jax(params)
    tx = torch.from_numpy(x).requires_grad_(True)
    tgx = {}
    for compute_dx in (True, False):
        out = fused_sae.fused_sae_loss_terms(tp, tx, LAMBDA, H_EXP, compute_dtype=TDT[cd],
                                             compute_dx=compute_dx)
        (tgx[compute_dx],) = torch.autograd.grad(out["loss"], [tx], allow_unused=True)
    assert tgx[False] is None
    ref = np.asarray(jgx)
    rtol, atol = (1e-4, 1e-7) if case == "f32" else (0, 2.0**-8 * np.abs(ref).max())
    np.testing.assert_allclose(tgx[True].numpy(), ref, rtol=rtol, atol=atol)
    assert np.abs(ref).max() > 0


# bf16 widths of the dx route that the first port's SIMT dx kernels refused
DX_WIDTHS = (72, 136)
DX_T, DX_H = 256, 256


@functools.cache
def _dx_setup(c):
    rng = np.random.default_rng(c)
    params = {
        "W_enc": (rng.normal(size=(c, DX_H)) / np.sqrt(c)).astype(np.float32),
        "b_enc": (-0.05 + 0.05 * rng.normal(size=DX_H)).astype(np.float32),
        "W_dec": (rng.normal(size=(DX_H, c)) / np.sqrt(DX_H)).astype(np.float32),
        "b_dec": (0.1 * rng.normal(size=c)).astype(np.float32),
    }
    params["b_enc"][:8] -= 100.0  # 8 latents never fire
    return params, rng.normal(size=(DX_T, c)).astype(np.float32)


@pytest.mark.parametrize("case", list(CASES))
@pytest.mark.parametrize("c", DX_WIDTHS)
def test_dx_matches_jax_at_a_coder_width(c, case):
    """compute_dx=True at widths the dx route takes (the coder bodies' rule) and
    the first port's dx kernels did not, against the JAX op in interpret mode,
    with the module docstring's dx tolerances."""
    cd, xd = CASES[case]
    params, jx, tx = _inputs(_dx_setup(c), xd)
    jp = {k: jnp.asarray(v) for k, v in params.items()}
    jgx = jax.grad(lambda xx: jax_fused(jp, xx, LAMBDA, 1, compute_dtype=JDT[cd],
                                        compute_dx=True, **JTILES)["loss"])(jx)
    tx = tx.requires_grad_(True)
    out = fused_sae.fused_sae_loss_terms(convert.sae_params_from_jax(params), tx, LAMBDA, 1,
                                         compute_dtype=TDT[cd], compute_dx=True)
    (tgx,) = torch.autograd.grad(out["loss"], [tx])
    ref = np.asarray(jgx, dtype=np.float32)
    rtol, atol = (1e-4, 1e-7) if cd == "float32" else (0, 2.0**-8 * np.abs(ref).max())
    np.testing.assert_allclose(tgx.float().numpy(), ref, rtol=rtol, atol=atol)
    assert np.abs(ref).max() > 0


@pytest.mark.parametrize("t,h,c,dtype,ok", [
    # every GoogLeNet width above 256 in bf16: mixed3b 480, 4d 528, 4e/5a 832, 5b 1024
    (8192, 4096, 480, torch.bfloat16, True), (8192, 4096, 528, torch.bfloat16, True),
    (8192, 4096, 832, torch.bfloat16, True), (8192, 4096, 1024, torch.bfloat16, True),
    (8192, 4096, 484, torch.bfloat16, False),  # TMA: bf16 widths multiples of 8
    (256, 256, 33, torch.float32, True),  # f32: any width
    (200, 256, 64, torch.float32, False), (256, 200, 64, torch.bfloat16, False),  # T, H
])
def test_dx_takes_the_coder_bodies_widths(t, h, c, dtype, ok):
    """The dx wrapper checks its operands by the coder bodies' rule (bodies_take;
    the op pads H before it reaches the wrapper) before any library is loaded,
    so a shape it refuses raises ValueError on every machine (meta tensors
    here)."""
    ops = (torch.empty(t, c, dtype=dtype, device="meta"),
           torch.empty(c, h, dtype=dtype, device="meta"), torch.empty(h, device="meta"),
           torch.empty(h, c, dtype=dtype, device="meta"))
    assert fused_sae.bodies_take(t, h, c, c, dtype) is ok
    if ok:
        assert fused_sae._check_operands(*ops) == (t, c, h)
    else:
        with pytest.raises(ValueError, match="not supported"):
            fused_sae.dx_kernel(*ops, torch.empty(t, c, dtype=dtype, device="meta"),
                                torch.empty(2, device="meta"))
    assert fused_sae.dx_kernel.launches == 0


def test_bf16_backward_equals_jnp_replica(setup):
    """In bf16 the port's backward equals the Pallas backward body's formulas
    (fused_sae.py:_bwd_kernel) written in plain jnp, on one token tile, to f32
    rounding."""
    params, x = setup
    bf = jnp.bfloat16
    tp = convert.sae_params_from_jax(params)
    t, h = T, C * H_EXP
    rng = np.random.default_rng(2)
    err = (0.1 * rng.normal(size=(T, C))).astype(ml_dtypes.bfloat16)
    c = np.array([2.0 / (t * C), LAMBDA / (t * h)], np.float32)
    jx = jnp.asarray(x).astype(bf)
    xc = (jx - jnp.asarray(params["b_dec"]).astype(bf)).astype(bf)
    w_enc, w_dec = jnp.asarray(params["W_enc"]).astype(bf), jnp.asarray(params["W_dec"]).astype(bf)
    pre = jnp.dot(xc, w_enc, preferred_element_type=jnp.float32) + params["b_enc"]
    post = jnp.maximum(pre, 0.0)
    drecon = c[0] * jnp.asarray(err).astype(jnp.float32)
    dims_t = (((0,), (0,)), ((), ()))
    dpost = jax.lax.dot_general(drecon.astype(bf), w_dec, (((1,), (1,)), ((), ())),
                                preferred_element_type=jnp.float32) + c[1]
    dpre = jnp.where(pre > 0, dpost, 0.0)
    db_enc = jnp.sum(dpre, axis=0)
    ref = (
        jax.lax.dot_general(xc, dpre.astype(bf), dims_t, preferred_element_type=jnp.float32),
        db_enc,
        jax.lax.dot_general(post.astype(bf), drecon.astype(bf), dims_t,
                            preferred_element_type=jnp.float32),
        jnp.sum(drecon, axis=0) - jnp.dot(db_enc.astype(bf), w_enc.T,
                                           preferred_element_type=jnp.float32),
    )
    got = fused_sae.fused_sae_backward_plain(
        torch.from_numpy(x).to(torch.bfloat16), tp["W_enc"].to(torch.bfloat16), tp["b_enc"],
        tp["W_dec"].to(torch.bfloat16), tp["b_dec"],
        torch.from_numpy(err.view(np.uint16)).view(torch.bfloat16), torch.from_numpy(c))
    for a, b, name in zip(got, ref, ("W_enc", "b_enc", "W_dec", "b_dec")):
        np.testing.assert_allclose(a.numpy(), np.asarray(b), rtol=1e-5, atol=1e-8, err_msg=name)


def test_plain_backward_matches_autograd_of_plain_forward(setup):
    """The explicit backward and dx equal autograd through the plain forward (f32)."""
    params, x = setup
    tp = convert.sae_params_from_jax(params)
    xt = torch.from_numpy(x)
    t, h = T, C * H_EXP
    coeffs = torch.tensor([2.0 / (t * C), LAMBDA / (t * h)])
    leaves = {k: v.clone().requires_grad_(True) for k, v in tp.items()}
    xg = xt.clone().requires_grad_(True)
    recon, _, _, l1 = fused_sae.fused_sae_forward_plain(
        xg, leaves["W_enc"], leaves["b_enc"], leaves["W_dec"], leaves["b_dec"])
    loss = (recon - xg).square().mean() + LAMBDA * l1 / (t * h)
    auto = torch.autograd.grad(
        loss, [leaves[k] for k in ("W_enc", "b_enc", "W_dec", "b_dec")] + [xg])
    err = (recon - xt).detach()
    ops = (xt, tp["W_enc"], tp["b_enc"], tp["W_dec"], tp["b_dec"], err, coeffs)
    x_cent = fused_sae.center_plain(xt, tp["b_dec"])
    mine = fused_sae.fused_sae_backward_plain(*ops) + (
        fused_sae.fused_sae_dx_plain(x_cent, tp["W_enc"], tp["b_enc"], tp["W_dec"], err, coeffs),)
    for a, b, name in zip(mine, auto, ("W_enc", "b_enc", "W_dec", "b_dec", "x")):
        np.testing.assert_allclose(a.numpy(), b.numpy(), rtol=1e-4, atol=1e-7, err_msg=name)


def test_non_cpu_tensor_never_takes_the_plain_path(setup):
    """Only a CPU tensor runs the plain version; any other device must launch a
    kernel or raise (here: a meta tensor raises)."""
    params, x = setup
    tp = {k: v.to("meta") for k, v in convert.sae_params_from_jax(params).items()}
    with pytest.raises(ValueError, match="no kernel for device"):
        fused_sae.fused_sae_forward(torch.empty(T, C, device="meta"), tp["W_enc"],
                                    tp["b_enc"], tp["W_dec"], tp["b_dec"])
    with pytest.raises(ValueError, match="no kernel for device"):
        fused_sae.fused_sae_backward(torch.empty(T, C, device="meta"), tp["W_enc"],
                                     tp["b_enc"], tp["W_dec"],
                                     torch.empty(T, C, device="meta"),
                                     torch.empty(2, device="meta"))
    with pytest.raises(ValueError, match="no kernel for device"):
        fused_sae.fused_sae_dx(torch.empty(T, C, device="meta"), tp["W_enc"], tp["b_enc"],
                               tp["W_dec"], torch.empty(T, C, device="meta"),
                               torch.empty(2, device="meta"))


@pytest.mark.parametrize("t,h,c,dtype,ok", [
    (32768, 16384, 256, torch.bfloat16, True), (512, 1024, 128, torch.bfloat16, True),
    (128, 128, 64, torch.float32, True), (128, 128, 64, "bfloat16", True),
    (64, 64, 64, torch.bfloat16, False),  # T a multiple of 128
    (100, 1024, 256, torch.bfloat16, False),
    # any H > 0: the op pads the latent axis to a multiple of 128 (mixed4d: 2,112)
    (512, 1000, 256, torch.bfloat16, True), (512, 2112, 528, torch.bfloat16, True),
    (512, 0, 256, torch.float32, False),
    (512, 1024, 96, torch.bfloat16, True), (512, 1024, 512, torch.bfloat16, True),
    # every GoogLeNet tap: mixed3b 480, mixed4a-4c 512, mixed4d 528, 4e/5a 832, 5b 1024
    (32768, 16384, 480, torch.bfloat16, True), (32768, 16384, 528, torch.bfloat16, True),
    (32768, 16384, 832, torch.bfloat16, True), (32768, 16384, 1024, torch.bfloat16, True),
    (32768, 16384, 484, torch.bfloat16, False),  # TMA: bf16 widths multiples of 8
    (32768, 16384, 484, torch.float32, True), (32768, 16384, 33, "float32", True),
    (512, 1024, 0, torch.float32, False),
])
def test_can_fuse_states_the_kernel_constraints(t, h, c, dtype, ok):
    assert fused_sae.can_fuse(t, h, c, dtype) is ok


def test_kernel_wrapper_validates_before_launch(setup):
    """Shape and dtype checks run before any library is loaded, so a bad call
    fails the same way on every machine."""
    params, x = setup
    tp = convert.sae_params_from_jax(params)
    with pytest.raises(ValueError, match="not supported"):
        fused_sae.fwd_kernel(torch.from_numpy(x[:100]), tp["W_enc"], tp["b_enc"],
                             tp["W_dec"], tp["b_dec"])
    with pytest.raises(ValueError, match="contiguous"):
        fused_sae.fwd_kernel(torch.from_numpy(x), tp["W_enc"].to(torch.bfloat16),
                             tp["b_enc"], tp["W_dec"], tp["b_dec"])
    with pytest.raises(ValueError, match="err must be"):
        fused_sae.dx_kernel(torch.from_numpy(x), tp["W_enc"], tp["b_enc"], tp["W_dec"],
                            torch.zeros(T, C + 1), torch.zeros(2))
    assert all(k.launches == 0 for k in fused_sae.KERNELS)


def test_library_name_follows_source_and_shared_header(tmp_path, monkeypatch):
    """ops/native names each built library by a hash of its source and of the
    shared headers in csrc/, so an edit to either rebuilds."""
    import shutil

    from sparse_vision_tpu_torch.ops import native

    csrc = tmp_path / "csrc"
    shutil.copytree(native.CSRC_DIR, csrc)
    monkeypatch.setattr(native, "CSRC_DIR", csrc)
    names = {name: native.library_path(name) for name in native.SOURCES}
    assert len(set(names.values())) == len(native.SOURCES)
    with open(csrc / "sae_common.cuh", "a") as f:
        f.write("// edited\n")
    assert all(native.library_path(n) != p for n, p in names.items())
    edited = native.library_path("fused_gated_sae")
    with open(csrc / "fused_gated_sae.cu", "a") as f:
        f.write("// edited\n")
    assert native.library_path("fused_gated_sae") != edited


# ---------------------------------------------------------------------------
# any width: C = 480, T = 256, H = 512 (mixed3b's width; not a template width)
# ---------------------------------------------------------------------------

WT, WC, WH = 256, 480, 512


@pytest.fixture(scope="module")
def wide():
    rng = np.random.default_rng(3)
    params = {
        "W_enc": (rng.normal(size=(WC, WH)) / np.sqrt(WC)).astype(np.float32),
        "b_enc": (-0.05 + 0.05 * rng.normal(size=WH)).astype(np.float32),
        "W_dec": (rng.normal(size=(WH, WC)) / np.sqrt(WH)).astype(np.float32),
        "b_dec": (0.1 * rng.normal(size=WC)).astype(np.float32),
    }
    params["b_enc"][:8] -= 100.0  # 8 latents never fire
    x = rng.normal(size=(WT, WC)).astype(np.float32)
    return params, x


@pytest.mark.parametrize("case", ["f32", "bf16"])
def test_wide_matches_jax(wide, case):
    """The op at C = 480 against the JAX op in interpret mode: forward values and
    every gradient, with the tolerances of the module docstring."""
    cd, _ = CASES[case]
    params, x = wide
    jp = {k: jnp.asarray(v) for k, v in params.items()}
    jout = jax_fused(jp, jnp.asarray(x), LAMBDA, 1, compute_dtype=JDT[cd], **JTILES)
    jgrad = jax.grad(lambda p: jax_fused(p, jnp.asarray(x), LAMBDA, 1, compute_dtype=JDT[cd],
                                         **JTILES)["loss"])(jp)
    tp = {k: v.requires_grad_(True) for k, v in convert.sae_params_from_jax(params).items()}
    tout = fused_sae.fused_sae_loss_terms(tp, torch.from_numpy(x), LAMBDA, 1,
                                          compute_dtype=TDT[cd])
    tgrad = dict(zip(tp, torch.autograd.grad(tout["loss"], list(tp.values()))))
    rtol = 1e-5 if case == "f32" else 1e-4
    for k in ("loss", "rec_loss", "l1_loss", "nrmse_loss", "rmse_loss"):
        np.testing.assert_allclose(float(tout[k].detach()), float(jout[k]), rtol=rtol, err_msg=k)
    np.testing.assert_allclose(tout["decoded"].detach().numpy(), np.asarray(jout["decoded"]),
                               rtol=rtol, atol=2e-5)
    np.testing.assert_array_equal(tout["dead"].numpy(), np.asarray(jout["dead"]))
    np.testing.assert_array_equal(tout["activity_freq"].numpy(),
                                  np.asarray(jout["activity_freq"]))
    assert bool(jout["dead"].any()) and not bool(jout["dead"].all())
    for k in ("W_enc", "b_enc", "W_dec", "b_dec"):
        ref = np.asarray(jgrad[k])
        if case == "f32":
            rtol, atol = 1e-4, 1e-7
        else:
            rtol, atol = {"W_enc": (0, 2.0**-8 * np.abs(ref).max()),
                          "b_dec": (0, 1e-2 * np.abs(ref).max())}.get(k, (1e-4, 1e-6))
        np.testing.assert_allclose(tgrad[k].numpy(), ref, rtol=rtol, atol=atol, err_msg=k)


@pytest.mark.parametrize("case", ["f32", "bf16"])
def test_entry_points_compose_to_the_reference(wide, case):
    """The op's glue around its entry points (x_cent from the forward, the
    partial rows of db_dec and their reduction), run on the CPU with the entry
    points' plain versions, equals the reference plain versions the kernels are
    held to on the card, to f32 summation order."""
    params, x = wide
    cd = TDT[CASES[case][0]]
    tp = convert.sae_params_from_jax(params)
    ops = (torch.from_numpy(x).to(cd), tp["W_enc"].to(cd), tp["b_enc"], tp["W_dec"].to(cd),
           tp["b_dec"])
    x_cent, *fwd = fused_sae.fused_sae_forward(*ops)
    torch.testing.assert_close(x_cent, ops[0] - tp["b_dec"].to(cd), rtol=0, atol=0)
    for a, b in zip(fwd, fused_sae.fused_sae_forward_plain(*ops)):
        torch.testing.assert_close(a, b, rtol=1e-5, atol=1e-6)
    err = (fwd[0] - ops[0].float()).to(cd)
    coeffs = torch.tensor([2.0 / (WT * WC), LAMBDA / (WT * WH)])
    got = fused_sae.fused_sae_backward(x_cent, ops[1], ops[2], ops[3], err, coeffs)
    want = fused_sae.fused_sae_backward_plain(*ops, err, coeffs)
    for a, b, name in zip(got, want, ("W_enc", "b_enc", "W_dec", "b_dec")):
        torch.testing.assert_close(a, b, rtol=1e-5, atol=1e-7 * float(b.abs().max()), msg=name)
    parts = fused_sae.sae_bwd_plain(x_cent, ops[1], ops[2], ops[3], err, coeffs)[3]
    assert parts.shape == (2, WC)  # the direct row, then the centring row


@pytest.mark.parametrize("op", ["sae_mlp", "transcoder", "crosscoder"])
def test_check_fusable_refuses_a_bf16_width_before_any_dump(op, monkeypatch, tmp_path):
    """A bf16 width the TMA bodies refuse (484: not a multiple of 8) is refused by
    can_fuse and by Pipeline.check_fusable, which the SAE, transcoder and
    crosscoder trainers call before they dump a cache; f32 takes it."""
    import types

    from sparse_vision_tpu_torch.config import RunConfig
    from sparse_vision_tpu_torch.data import activation_cache
    from sparse_vision_tpu_torch.ops import fused_transcoder
    from sparse_vision_tpu_torch.train.pipeline import Pipeline

    can_fuse = {"sae_mlp": lambda t, h, c_in, _, dt: fused_sae.can_fuse(t, h, c_in, dt),
                "transcoder": fused_transcoder.can_fuse,
                "crosscoder": fused_transcoder.can_fuse}[op]
    assert not can_fuse(32768, 16384, 484, 484, torch.bfloat16)
    assert can_fuse(32768, 16384, 484, 484, torch.float32)
    cfg = RunConfig(sae_model_name="sae_mlp", use_pallas=True, compute_dtype="bfloat16",
                    cache_tokens_per_step=32768)
    pipe = types.SimpleNamespace(cfg=cfg, device=torch.device("cuda"), num_units=16384,
                                 sae_input_size=484, mesh=None)
    pipe.check_fusable = functools.partial(Pipeline.check_fusable, pipe)
    with pytest.raises(ValueError, match="C_in=484"):
        pipe.check_fusable(can_fuse, 484, 484)
    assert pipe.check_fusable(can_fuse, 480, 480)
    if op == "sae_mlp":  # train_sae_cached asks before its dump
        def no_dump(*args, **kwargs):
            raise AssertionError("the cache was dumped before the width check")

        monkeypatch.setattr(activation_cache, "dump_activations", no_dump)
        pipe._cache_dir = lambda layer: str(tmp_path / layer)
        with pytest.raises(ValueError, match="C_in=484"):
            Pipeline.train_sae_cached(pipe)


# ---------------------------------------------------------------------------
# latent padding: H = 2,112 (the registry's mixed4d SAE, 528 x 4) and H = 200
# ---------------------------------------------------------------------------

PADDED = {2112: (128, 528), 200: (128, 56)}  # H: (T, C)
# the padded op against the unpadded plain math: the same cast points, products
# over H_pad that may sum in another order, so within PAD_RTOL / PAD_ATOL of
# each array's largest magnitude in f32. In bf16 an f32 ulp of the
# reconstruction can flip the bf16 rounding of the saved error (measured on
# the transcoder at H 2,112: 4.8e-7 moved one error entry by 2^-8, dW_enc by
# 8.8e-4 of its largest entry), so bf16 arrays are held to one bf16 ulp
# (PAD_ATOL_BF16) of their largest magnitude
PAD_RTOL, PAD_ATOL, PAD_ATOL_BF16 = 1e-5, 1e-6, 2.0**-8
# against the JAX op in bf16 the [T, C] reconstruction sums 2,112 rounded
# latents: a pre-activation that the frameworks sum in another order can round
# post to the neighbouring bf16 value, ~2^-9 of it times a W_dec entry (~0.02)
# per flip (measured: 2.3e-4 at most, on 0.5% of the entries; the unpadded
# plain math above holds it to PAD_ATOL); the flips reach dW_dec through the
# rounded error, which is then held to one bf16 ulp of its largest entry, as
# dW_enc is
PAD_BF16_RECON_ATOL = 1e-3


@functools.cache
def _padded_setup(h):
    t, c = PADDED[h]
    rng = np.random.default_rng(h)
    params = {
        "W_enc": (rng.normal(size=(c, h)) / np.sqrt(c)).astype(np.float32),
        "b_enc": (-0.05 + 0.05 * rng.normal(size=h)).astype(np.float32),
        "W_dec": (rng.normal(size=(h, c)) / np.sqrt(h)).astype(np.float32),
        "b_dec": (0.1 * rng.normal(size=c)).astype(np.float32),
    }
    params["b_enc"][:8] -= 100.0  # 8 latents never fire
    return params, rng.normal(size=(t, c)).astype(np.float32)


def _plain_reference(params, x, cd):
    """Loss terms and gradients of the unpadded plain math at the true H."""
    tp = convert.sae_params_from_jax(params)
    t, c = x.shape
    h = tp["b_enc"].shape[0]
    xc, we, wd = torch.from_numpy(x).to(cd), tp["W_enc"].to(cd), tp["W_dec"].to(cd)
    recon, act, _, l1_sum = fused_sae.fused_sae_forward_plain(xc, we, tp["b_enc"], wd,
                                                              tp["b_dec"])
    err = recon - torch.from_numpy(x)
    coeffs = torch.tensor([2.0 / (t * c), LAMBDA / (t * h)])
    grads = fused_sae.fused_sae_backward_plain(xc, we, tp["b_enc"], wd, tp["b_dec"],
                                               err.to(cd), coeffs)
    return ({"rec_loss": err.square().mean(), "l1_loss": l1_sum / (t * h), "decoded": recon,
             "act": act}, dict(zip(("W_enc", "b_enc", "W_dec", "b_dec"), grads)))


def _padded_op(params, x, cd):
    tp = {k: v.requires_grad_(True) for k, v in convert.sae_params_from_jax(params).items()}
    out = fused_sae.fused_sae_loss_terms(tp, torch.from_numpy(x), LAMBDA, 4, compute_dtype=cd)
    return tp, out, dict(zip(tp, torch.autograd.grad(out["loss"], list(tp.values()))))


def _close(got, want, name, cd=torch.float32):
    atol = (PAD_ATOL if cd == torch.float32 else PAD_ATOL_BF16) * float(want.abs().max())
    torch.testing.assert_close(got.detach().float(), want.float(), rtol=PAD_RTOL, atol=atol,
                               msg=name)


@pytest.mark.parametrize("case", ["f32", "bf16"])
@pytest.mark.parametrize("h", list(PADDED))
def test_padded_op_matches_the_unpadded_plain_math(h, case):
    """At an H the kernels do not tile, the op pads the latent axis to 128k and
    slices back: its loss terms, statistics and gradients equal the plain math
    at the true H (the normalisers use the true H), and nothing it returns has
    the padded width."""
    cd = TDT[CASES[case][0]]
    params, x = _padded_setup(h)
    tp, out, grads = _padded_op(params, x, cd)
    ref, ref_grads = _plain_reference(params, x, cd)
    t, c = x.shape
    for k in ("rec_loss", "l1_loss", "decoded"):
        _close(out[k], ref[k], k, cd)
    torch.testing.assert_close(out["activity_freq"], ref["act"] / t, rtol=0, atol=0)
    assert out["dead"].shape == (h,) and bool(out["dead"].any())
    for k, g in grads.items():
        assert g.shape == tp[k].shape, k
        _close(g, ref_grads[k], k, cd)


@pytest.mark.parametrize("case", ["f32", "bf16"])
@pytest.mark.parametrize("h", list(PADDED))
def test_padded_latents_are_exactly_zero(h, case):
    """The entry points at H_pad on the padded operands: every padded latent's
    activity, Σpost and gradients are exactly zero, so slicing loses nothing,
    and its zero rows leave db_dec's centring term as the unpadded one."""
    cd = TDT[CASES[case][0]]
    params, x = _padded_setup(h)
    tp = convert.sae_params_from_jax(params)
    t, c = x.shape
    hp = fused_sae.padded_h(h)
    assert hp % fused_sae.TILE_H == 0 and hp - h < fused_sae.TILE_H
    we, b_enc, wd = fused_sae.padded_operands(tp["W_enc"], tp["b_enc"], tp["W_dec"], cd)
    assert we.shape == (c, hp) and b_enc.shape == (hp,) and wd.shape == (hp, c)
    xc = torch.from_numpy(x).to(cd)
    x_cent, recon, act_part, _, zsum_part = fused_sae.sae_fwd_plain(xc, we, b_enc, wd,
                                                                    tp["b_dec"])
    assert not act_part[:, h:].any() and not zsum_part[:, h:].any()
    err = (recon - torch.from_numpy(x)).to(cd)
    coeffs = torch.tensor([2.0 / (t * c), LAMBDA / (t * h)])
    dw_enc, db_enc, dw_dec, parts = fused_sae.sae_bwd_plain(x_cent, we, b_enc, wd, err, coeffs)
    assert not dw_enc[:, h:].any() and not db_enc[h:].any() and not dw_dec[h:].any()
    unpadded = fused_sae.centring_rows_plain(db_enc[:h], we[:, :h])
    _close(parts[1:], unpadded, "centring row", cd)


@pytest.mark.parametrize("case", ["f32", "bf16"])
@pytest.mark.parametrize("h", list(PADDED))
def test_padded_op_matches_jax(h, case):
    """The padded op against the JAX op in interpret mode (one latent tile of
    the whole H, which Pallas takes at any H), with the module docstring's
    tolerances; the bf16 reconstruction within PAD_BF16_RECON_ATOL."""
    cd = CASES[case][0]
    params, x = _padded_setup(h)
    jp = {k: jnp.asarray(v) for k, v in params.items()}
    tiles = dict(tile_t=64, tile_h=4096, interpret=True)

    def jloss(p):
        return jax_fused(p, jnp.asarray(x), LAMBDA, 4, compute_dtype=JDT[cd], **tiles)

    jout, jgrad = jloss(jp), jax.grad(lambda p: jloss(p)["loss"])(jp)
    _, tout, tgrad = _padded_op(params, x, TDT[cd])
    rtol = 1e-5 if case == "f32" else 1e-4
    for k in ("loss", "rec_loss", "l1_loss", "nrmse_loss", "rmse_loss"):
        np.testing.assert_allclose(float(tout[k].detach()), float(jout[k]), rtol=rtol, err_msg=k)
    np.testing.assert_allclose(tout["decoded"].detach().numpy(), np.asarray(jout["decoded"]),
                               rtol=rtol, atol=2e-5 if case == "f32" else PAD_BF16_RECON_ATOL)
    np.testing.assert_array_equal(tout["activity_freq"].numpy(),
                                  np.asarray(jout["activity_freq"]))
    np.testing.assert_allclose(float(tout["sparsity"]), float(jout["sparsity"]), rtol=1e-6)
    for k in ("W_enc", "b_enc", "W_dec", "b_dec"):
        ref = np.asarray(jgrad[k])
        if case == "f32":
            rtol, atol = 1e-4, 1e-7
        else:
            # dW_dec = round(post)ᵀ·round(drecon): the flipped roundings above
            rtol, atol = {"W_enc": (0, 2.0**-8 * np.abs(ref).max()),
                          "W_dec": (0, 2.0**-8 * np.abs(ref).max()),
                          "b_dec": (0, 1e-2 * np.abs(ref).max())}.get(k, (1e-4, 1e-6))
        np.testing.assert_allclose(tgrad[k].numpy(), ref, rtol=rtol, atol=atol, err_msg=k)
