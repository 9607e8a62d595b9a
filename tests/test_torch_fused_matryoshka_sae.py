"""The port's fused Matryoshka-SAE op (plain versions of the CUDA kernels, the CPU
path) against the JAX fused_matryoshka_sae_loss_terms run as
tests/test_fused_matryoshka.py runs it: Pallas interpret mode, small tiles.

T = 64 tokens, C = 32, H = 2,048 latents with the default prefixes 1/16, 1/4, 1
(boundaries 128, 512, 2,048: multiples of the 128-latent quantum of both the JAX
kernel and the port's); 16 latents never fire. Also C = 480 (a width the coder
bodies take and the old SAE kernels did not) at T = 256, H = 512, prefixes 128 /
512, with the same tolerances.

Tolerances:
- f32 compute: forward values rtol 1e-5, and the [T, C] reconstructions atol
  2e-5 besides (about 1e-6 of max|recon|: both sides sum 2,048 latents'
  products in f32, in other orders); dead, activity and sparsity exact;
  parameter and x gradients rtol 1e-4, atol 1e-7 (tests/test_fused_matryoshka.py).
- bf16 compute: the cast points are the same on both sides, so the forward
  agrees to f32 summation order (rtol 1e-4), and db_enc and dW_dec at rtol 1e-4,
  atol 1e-6. As for the ReLU op (tests/test_torch_fused_sae.py), dW_enc gets
  one bf16 ulp (2^-8) of max|dW_enc| (the interpret-mode Pallas kernel's
  transposed bf16 product), and db_dec 1e-2 of max|db_dec| (its centring term
  rounds db_enc to bf16 per TPU tile in JAX, once per batch in the port). dx
  gets one bf16 ulp of max|dx|: its product round(dpre)·W_encᵀ is a transposed
  bf16 product in the Pallas kernel too; with a bf16 x (bf16_cache) autograd
  rounds the port's dx to bf16, which the same ulp covers.
- C = 480, bf16: the reconstruction gets one bf16 ulp of max|recon| (sums of
  480 products in other f32 orders can flip a bf16 rounding of post).
"""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from sparse_vision_tpu.models.sae import init_sae
from sparse_vision_tpu.ops.fused_matryoshka_sae import (
    fused_matryoshka_sae_loss_terms as jax_loss_terms,
)
from sparse_vision_tpu.ops.fused_matryoshka_sae import make_fused_matryoshka_sae_op
from sparse_vision_tpu_torch import convert
from sparse_vision_tpu_torch.models.sae import matryoshka_prefix_counts
from sparse_vision_tpu_torch.ops import fused_matryoshka_sae as fm
from sparse_vision_tpu_torch.ops import fused_sae

T, C, H_EXP = 64, 32, 64
H = C * H_EXP
PREFIXES = (0.0625, 0.25, 1.0)
BOUNDS = (128, 512, 2048)
LAMBDA = 0.7
JTILES = dict(tile_t=32, tile_h=128, interpret=True)
JDT = {"f32": jnp.float32, "bf16": jnp.bfloat16}
TDT = {"f32": torch.float32, "bf16": torch.bfloat16}
KEYS = ("loss", "rec_loss", "l1_loss", "nrmse_loss", "rmse_loss", "aux_loss")


@functools.cache
def _setup():
    params = init_sae("matryoshka_sae", jax.random.key(0), C, H_EXP)
    b_enc = (params["b_enc"] - 0.1).at[:16].add(-100.0)
    params = jax.device_get({**params, "b_enc": b_enc, "b_dec": params["b_dec"] + 0.05})
    x = np.random.default_rng(1).normal(size=(T, C)).astype(np.float32)
    return params, x


@functools.cache
def _jax(case):
    params, x = _setup()
    op = make_fused_matryoshka_sae_op(BOUNDS, 32, 128, JDT[case], True, True)
    out = op(params, jnp.asarray(x))
    terms = jax_loss_terms(params, jnp.asarray(x), LAMBDA, H_EXP, PREFIXES,
                           compute_dtype=JDT[case], compute_dx=True, **JTILES)
    gp, gx = jax.grad(
        lambda p, xx: jax_loss_terms(p, xx, LAMBDA, H_EXP, PREFIXES, compute_dtype=JDT[case],
                                     compute_dx=True, **JTILES)["loss"],
        argnums=(0, 1))(params, jnp.asarray(x))
    return jax.device_get((out, terms, gp, gx))


def _torch(case):
    params, x = _setup()
    tp = {k: v.requires_grad_(True) for k, v in convert.sae_params_from_jax(params).items()}
    tx = torch.from_numpy(x).requires_grad_(True)
    out = fm.fused_matryoshka_sae(tp, tx, BOUNDS, compute_dtype=TDT[case])
    terms = fm.fused_matryoshka_sae_loss_terms(tp, tx, LAMBDA, H_EXP, PREFIXES,
                                               compute_dtype=TDT[case], compute_dx=True)
    grads = torch.autograd.grad(terms["loss"], [*tp.values(), tx])
    return out, terms, dict(zip(tp, grads[:-1])), grads[-1]


def test_boundaries_are_the_prefix_counts():
    assert matryoshka_prefix_counts(H, PREFIXES) == BOUNDS
    assert fm.can_fuse_matryoshka(2 * T, H, BOUNDS, C)


@pytest.mark.parametrize("case", ["f32", "bf16"])
def test_forward_matches_jax(case):
    jout, jterms, _, _ = _jax(case)
    tout, tterms, _, _ = _torch(case)
    rtol = 1e-5 if case == "f32" else 1e-4
    np.testing.assert_allclose(tout["prefix_losses"].detach().numpy(),
                               jout["prefix_losses"], rtol=rtol)
    np.testing.assert_allclose(float(tout["l1_loss"].detach()), float(jout["l1_loss"]),
                               rtol=rtol)
    np.testing.assert_allclose(tout["recon"].numpy(), jout["recon"], rtol=rtol, atol=2e-5)
    np.testing.assert_array_equal(tout["dead"].numpy(), jout["dead"])
    np.testing.assert_array_equal(tout["activity_freq"].numpy(), jout["activity_freq"])
    np.testing.assert_array_equal(tout["row_active"].numpy(), jout["row_active"])
    assert jout["dead"][:16].all() and not jout["dead"].all()
    for k in KEYS:
        np.testing.assert_allclose(float(tterms[k].detach()), float(jterms[k]), rtol=rtol,
                                   atol=1e-7, err_msg=k)
    np.testing.assert_allclose(tterms["decoded"].numpy(), jterms["decoded"], rtol=rtol,
                               atol=2e-5)
    np.testing.assert_array_equal(tterms["dead"].numpy(), jterms["dead"])
    np.testing.assert_allclose(float(tterms["sparsity"]), float(jterms["sparsity"]), rtol=1e-6)


@pytest.mark.parametrize("case", ["f32", "bf16"])
def test_gradients_match_jax(case):
    """Parameter gradients and, with compute_dx=True, the x gradient (the dx
    kernel's plain version)."""
    _, _, jgrad, jgx = _jax(case)
    _, _, tgrad, tgx = _torch(case)
    for k in ("W_enc", "b_enc", "W_dec", "b_dec"):
        ref = np.asarray(jgrad[k])
        if case == "f32":
            rtol, atol = 1e-4, 1e-7
        else:
            rtol, atol = {"W_enc": (0, 2.0**-8 * np.abs(ref).max()),
                          "b_dec": (0, 1e-2 * np.abs(ref).max())}.get(k, (1e-4, 1e-6))
        np.testing.assert_allclose(tgrad[k].numpy(), ref, rtol=rtol, atol=atol, err_msg=k)
    if case == "f32":
        rtol, atol = 1e-4, 1e-7
    else:
        rtol, atol = 0, 2.0**-8 * np.abs(jgx).max()
    np.testing.assert_allclose(tgx.numpy(), jgx, rtol=rtol, atol=atol, err_msg="x")
    assert np.abs(jgx).max() > 0


def test_x_gradient_is_none_without_compute_dx():
    params, x = _setup()
    tp = {k: v.requires_grad_(True) for k, v in convert.sae_params_from_jax(params).items()}
    tx = torch.from_numpy(x).requires_grad_(True)
    terms = fm.fused_matryoshka_sae_loss_terms(tp, tx, LAMBDA, H_EXP, PREFIXES,
                                               compute_dtype=torch.float32)
    grads = torch.autograd.grad(terms["loss"], [tp["W_enc"], tx], allow_unused=True)
    assert grads[0] is not None and grads[1] is None


def test_plain_backward_and_dx_match_autograd_of_plain_forward():
    """The explicit backward and dx equal autograd through the plain forward
    (f32), for prefix-loss cotangents g_p and an L1 cotangent."""
    params, x = _setup()
    tp = convert.sae_params_from_jax(params)
    leaves = {k: v.clone().requires_grad_(True) for k, v in tp.items()}
    xt = torch.from_numpy(x).requires_grad_(True)
    g = torch.tensor([0.5, 1.5, 1.0])
    prefix_recon, _, _, l1 = fm.fused_matryoshka_forward_plain(
        xt, leaves["W_enc"], leaves["b_enc"], leaves["W_dec"], leaves["b_dec"], BOUNDS)
    errs = prefix_recon - xt[None]
    loss = (g * errs.square().mean((1, 2))).sum() + LAMBDA * l1 / (T * H)
    names = ("W_enc", "b_enc", "W_dec", "b_dec")
    auto = torch.autograd.grad(loss, [leaves[k] for k in names] + [xt])
    errs = errs.detach()
    s = ((g * 2.0 / (T * C))[:, None, None] * errs).flip(0).cumsum(0).flip(0)
    coeffs = torch.tensor([1.0, LAMBDA / (T * H)])
    ops = (torch.from_numpy(x), tp["W_enc"], tp["b_enc"], tp["W_dec"], tp["b_dec"], s, coeffs,
           BOUNDS)
    x_cent = fused_sae.center_plain(ops[0], tp["b_dec"])
    mine = fm.fused_matryoshka_backward_plain(*ops) + (
        fm.fused_matryoshka_dx_plain(x_cent, *ops[1:4], *ops[5:]),)
    for a, b, name in zip(mine, auto, names + ("x",)):
        np.testing.assert_allclose(a.numpy(), b.numpy(), rtol=1e-4, atol=1e-7, err_msg=name)


def test_one_level_is_the_relu_op():
    """With one prefix (the whole dictionary) the plain Matryoshka kernels are the
    ReLU kernels' plain versions: the same cast points, exact in bf16."""
    params, x = _setup()
    tp = convert.sae_params_from_jax(params)
    bf = torch.bfloat16
    ops = (torch.from_numpy(x).to(bf), tp["W_enc"].to(bf), tp["b_enc"], tp["W_dec"].to(bf),
           tp["b_dec"])
    recon, *stats = fused_sae.fused_sae_forward_plain(*ops)
    prefix_recon, *mstats = fm.fused_matryoshka_forward_plain(*ops, (H,))
    torch.testing.assert_close(prefix_recon[0], recon, rtol=0, atol=0)
    for a, b in zip(mstats, stats):
        torch.testing.assert_close(a, b, rtol=0, atol=0)
    err = (0.01 * torch.randn(T, C, generator=torch.Generator().manual_seed(0))).to(bf)
    coeffs = torch.tensor([0.3, 1e-4])
    for a, b in zip(fm.fused_matryoshka_backward_plain(*ops, err[None], coeffs, (H,)),
                    fused_sae.fused_sae_backward_plain(*ops, err, coeffs)):
        torch.testing.assert_close(a, b, rtol=1e-6, atol=1e-9)
    x_cent = fused_sae.center_plain(ops[0], tp["b_dec"])
    torch.testing.assert_close(
        fm.fused_matryoshka_dx_plain(x_cent, *ops[1:4], err[None], coeffs, (H,)),
        fused_sae.fused_sae_dx_plain(x_cent, *ops[1:4], err, coeffs), rtol=1e-6, atol=1e-9)


@pytest.mark.parametrize("t,h,bounds,c,ok", [
    (32768, 16384, (1024, 4096, 16384), 256, True),
    (512, 1024, (128, 1024), 128, True),
    (512, 1024, (64, 1024), 128, False),        # 64: not a multiple of 128 (as in JAX)
    (512, 1024, (1024,), 64, True),
    (512, 1024, (32, 1024), 256, False),        # a boundary inside a 128-latent group
    (512, 1024, (256, 512), 256, False),        # the last boundary is not H
    (512, 1024, (512, 256, 1024), 256, False),  # not increasing
    (512, 1024, (512, 512, 1024), 256, False),  # repeated
    (512, 1024, (), 256, False),
    (512, 2048, tuple(range(128, 2049, 128)), 256, True),   # 16 levels
    (512, 4096, tuple(range(128, 2177, 128)) + (4096,), 256, False),  # 18 levels
    (100, 1024, (512, 1024), 256, False),       # the ReLU op's constraints
    (512, 1024, (512, 1024), 96, True),
    (8192, 4096, (1024, 2048, 4096), 480, True),
    (8192, 4096, (1024, 2048, 4096), 832, True),
    (8192, 4096, (1024, 2048, 4096), 1024, True),
    (8192, 4096, (1024, 2048, 4096), 484, False),  # bf16 widths multiples of 8
])
def test_can_fuse_matryoshka_states_the_kernel_constraints(t, h, bounds, c, ok):
    assert fm.can_fuse_matryoshka(t, h, bounds, c) is ok
    assert fm.can_fuse_matryoshka(t, h, bounds, c, torch.float32) is (ok or c == 484)


def test_non_cpu_tensor_never_takes_the_plain_path():
    """Only a CPU tensor runs the plain version; any other device must launch a
    kernel or raise (here: a meta tensor raises)."""
    params, _ = _setup()
    tp = {k: v.to("meta") for k, v in convert.sae_params_from_jax(params).items()}
    ops = (torch.empty(T, C, device="meta"), tp["W_enc"], tp["b_enc"], tp["W_dec"], tp["b_dec"])
    s = torch.empty(3, T, C, device="meta")
    coeffs = torch.empty(2, device="meta")
    with pytest.raises(ValueError, match="no kernel for device"):
        fm.fused_matryoshka_forward(*ops, BOUNDS)
    with pytest.raises(ValueError, match="no kernel for device"):
        fm.fused_matryoshka_backward(*ops[:4], s, coeffs, BOUNDS)
    with pytest.raises(ValueError, match="no kernel for device"):
        fm.fused_matryoshka_dx(*ops[:4], s, coeffs, BOUNDS)


def test_kernel_wrapper_validates_before_launch():
    """Shape, dtype and boundary checks run before any library is loaded, so a bad
    call fails the same way on every machine."""
    params, x = _setup()
    tp = convert.sae_params_from_jax(params)
    xt = torch.from_numpy(np.tile(x, (2, 4)))  # T = 128, C = 128: the kernels' shape
    w_enc = torch.randn(128, H)
    w_dec = torch.randn(H, 128)
    b_dec = torch.zeros(128)
    ops = (xt, w_enc, tp["b_enc"], w_dec, b_dec)
    with pytest.raises(ValueError, match="prefix boundaries"):
        fm.fwd_kernel(*ops, (100, H))
    with pytest.raises(ValueError, match="not supported"):
        fm.fwd_kernel(torch.from_numpy(x), tp["W_enc"], tp["b_enc"], tp["W_dec"],
                      tp["b_dec"], BOUNDS)  # T = 64
    with pytest.raises(ValueError, match="S must be"):
        fm.bwd_kernel(*ops[:4], torch.zeros(2, 2 * T, 128), torch.zeros(2), BOUNDS)
    with pytest.raises(ValueError, match="coeffs must be"):
        fm.dx_kernel(*ops[:4], torch.zeros(3, 2 * T, 128), torch.zeros(3), BOUNDS)
    assert all(k.launches == 0 for k in fm.KERNELS)


# ---------------------------------------------------------------------------
# any width: C = 480, T = 256, H = 512, prefixes 128 / 512
# ---------------------------------------------------------------------------

WT, WC, WH = 256, 480, 512
WPREFIXES = (0.25, 1.0)
WBOUNDS = (128, 512)


@functools.cache
def _wide():
    rng = np.random.default_rng(4)
    params = {
        "W_enc": (rng.normal(size=(WC, WH)) / np.sqrt(WC)).astype(np.float32),
        "b_enc": (-0.05 + 0.05 * rng.normal(size=WH)).astype(np.float32),
        "W_dec": (rng.normal(size=(WH, WC)) / np.sqrt(WH)).astype(np.float32),
        "b_dec": (0.1 * rng.normal(size=WC)).astype(np.float32),
    }
    params["b_enc"][:8] -= 100.0  # 8 latents never fire
    return params, rng.normal(size=(WT, WC)).astype(np.float32)


@pytest.mark.parametrize("case", ["f32", "bf16"])
def test_wide_matches_jax(case):
    """The op at C = 480 against the JAX op in interpret mode: loss terms,
    statistics and every parameter gradient."""
    params, x = _wide()
    assert matryoshka_prefix_counts(WH, WPREFIXES) == WBOUNDS
    jp = {k: jnp.asarray(v) for k, v in params.items()}

    def jloss(p):
        return jax_loss_terms(p, jnp.asarray(x), LAMBDA, 1, WPREFIXES, compute_dtype=JDT[case],
                              **JTILES)

    jterms = jloss(jp)
    jgrad = jax.grad(lambda p: jloss(p)["loss"])(jp)
    tp = {k: v.requires_grad_(True) for k, v in convert.sae_params_from_jax(params).items()}
    tterms = fm.fused_matryoshka_sae_loss_terms(tp, torch.from_numpy(x), LAMBDA, 1, WPREFIXES,
                                                compute_dtype=TDT[case])
    tgrad = dict(zip(tp, torch.autograd.grad(tterms["loss"], list(tp.values()))))
    rtol = 1e-5 if case == "f32" else 1e-4
    for k in KEYS:
        np.testing.assert_allclose(float(tterms[k].detach()), float(jterms[k]), rtol=rtol,
                                   atol=1e-7, err_msg=k)
    # bf16: both sides sum 480 products per pre-activation in other f32 orders, so
    # a bf16 rounding of post may flip; one flip moves recon by a bf16 ulp (2^-8)
    # of post·W_dec, within a bf16 ulp of max|recon|
    ref = np.asarray(jterms["decoded"])
    atol = 2e-5 if case == "f32" else 2.0**-8 * np.abs(ref).max()
    np.testing.assert_allclose(tterms["decoded"].detach().numpy(), ref, rtol=rtol, atol=atol)
    np.testing.assert_array_equal(tterms["dead"].numpy(), np.asarray(jterms["dead"]))
    assert bool(jterms["dead"].any()) and not bool(jterms["dead"].all())
    for k in ("W_enc", "b_enc", "W_dec", "b_dec"):
        ref = np.asarray(jgrad[k])
        if case == "f32":
            rtol, atol = 1e-4, 1e-7
        else:
            rtol, atol = {"W_enc": (0, 2.0**-8 * np.abs(ref).max()),
                          "b_dec": (0, 1e-2 * np.abs(ref).max())}.get(k, (1e-4, 1e-6))
        np.testing.assert_allclose(tgrad[k].numpy(), ref, rtol=rtol, atol=atol, err_msg=k)


@pytest.mark.parametrize("case", ["f32", "bf16"])
def test_entry_points_compose_to_the_reference(case):
    """The op's glue around its entry points, run on the CPU with their plain
    versions, equals the reference plain versions, with S's levels different
    from each other (the direct db_dec term is Σ_t S_0 only, and each level's
    latents read their own S_q)."""
    params, x = _wide()
    cd = TDT[case]
    tp = convert.sae_params_from_jax(params)
    ops = (torch.from_numpy(x).to(cd), tp["W_enc"].to(cd), tp["b_enc"], tp["W_dec"].to(cd),
           tp["b_dec"])
    x_cent, *fwd = fm.fused_matryoshka_forward(*ops, WBOUNDS)
    torch.testing.assert_close(x_cent, ops[0] - tp["b_dec"].to(cd), rtol=0, atol=0)
    for a, b in zip(fwd, fm.fused_matryoshka_forward_plain(*ops, WBOUNDS)):
        torch.testing.assert_close(a, b, rtol=1e-5, atol=1e-6)
    g = torch.Generator().manual_seed(5)
    s = torch.stack([1e-3 * torch.randn(WT, WC, generator=g),
                     1e-2 * torch.randn(WT, WC, generator=g)]).to(cd)
    coeffs = torch.tensor([1.0, LAMBDA / (WT * WH)])
    got = fm.fused_matryoshka_backward(x_cent, ops[1], ops[2], ops[3], s, coeffs, WBOUNDS)
    want = fm.fused_matryoshka_backward_plain(*ops, s, coeffs, WBOUNDS)
    for a, b, name in zip(got, want, ("W_enc", "b_enc", "W_dec", "b_dec")):
        torch.testing.assert_close(a, b, rtol=1e-5, atol=1e-7 * float(b.abs().max()), msg=name)
    # the levels' errors matter: S_1 in place of S_0 moves db_dec
    other = fm.fused_matryoshka_backward(x_cent, ops[1], ops[2], ops[3], s.flip(0), coeffs,
                                         WBOUNDS)
    assert not torch.allclose(other[3], got[3], rtol=1e-2)


# ---------------------------------------------------------------------------
# dx at bf16 widths the first port's SIMT dx kernels refused: C = 72 and 136,
# T = 256, H = 256, prefixes 128 / 256
# ---------------------------------------------------------------------------

DX_WIDTHS = (72, 136)
DX_T, DX_H = 256, 256
DX_PREFIXES = (0.5, 1.0)
DX_BOUNDS = (128, 256)


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


@pytest.mark.parametrize("case", ["f32", "bf16", "bf16_cache"])
@pytest.mark.parametrize("c", DX_WIDTHS)
def test_dx_matches_jax_at_a_coder_width(c, case):
    """compute_dx=True at widths the dx route takes and the first port's dx
    kernels did not, against the JAX op in interpret mode, with the module
    docstring's dx tolerances; bf16_cache feeds x in bf16 to both."""
    import ml_dtypes

    params, x = _dx_setup(c)
    assert matryoshka_prefix_counts(DX_H, DX_PREFIXES) == DX_BOUNDS
    cd = "f32" if case == "f32" else "bf16"
    if case == "bf16_cache":
        xb = x.astype(ml_dtypes.bfloat16)
        jx, tx = jnp.asarray(xb), torch.from_numpy(xb.view(np.uint16)).view(torch.bfloat16)
    else:
        jx, tx = jnp.asarray(x), torch.from_numpy(x)
    jp = {k: jnp.asarray(v) for k, v in params.items()}
    jgx = jax.grad(lambda xx: jax_loss_terms(jp, xx, LAMBDA, 1, DX_PREFIXES,
                                             compute_dtype=JDT[cd], compute_dx=True,
                                             **JTILES)["loss"])(jx)
    tx = tx.requires_grad_(True)
    terms = fm.fused_matryoshka_sae_loss_terms(convert.sae_params_from_jax(params), tx, LAMBDA,
                                               1, DX_PREFIXES, compute_dtype=TDT[cd],
                                               compute_dx=True)
    (tgx,) = torch.autograd.grad(terms["loss"], [tx])
    ref = np.asarray(jgx, dtype=np.float32)
    rtol, atol = (1e-4, 1e-7) if cd == "f32" else (0, 2.0**-8 * np.abs(ref).max())
    np.testing.assert_allclose(tgx.float().numpy(), ref, rtol=rtol, atol=atol)
    assert np.abs(ref).max() > 0


@pytest.mark.parametrize("c,bounds,dtype", [
    (484, DX_BOUNDS, torch.bfloat16),  # TMA: bf16 widths multiples of 8
    (72, (64, 256), torch.bfloat16),   # a boundary inside a 128-latent group
    (72, (64, 256), torch.float32),
])
def test_dx_wrapper_refuses_before_launch(c, bounds, dtype):
    """The dx wrapper takes the forward's rule (the coder bodies' widths, prefix
    boundaries multiples of 128) and raises ValueError before any library is
    loaded (meta tensors here)."""
    ops = (torch.empty(DX_T, c, dtype=dtype, device="meta"),
           torch.empty(c, DX_H, dtype=dtype, device="meta"), torch.empty(DX_H, device="meta"),
           torch.empty(DX_H, c, dtype=dtype, device="meta"),
           torch.empty(len(bounds), DX_T, c, dtype=dtype, device="meta"),
           torch.empty(2, device="meta"))
    with pytest.raises(ValueError, match="not supported"):
        fm.dx_kernel(*ops, bounds)
    assert fm.dx_kernel.launches == 0
