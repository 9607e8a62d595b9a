"""The port's fused Gated-SAE op (plain versions of the CUDA kernels, the CPU
path) against the JAX fused_gated_sae_loss_terms run as
tests/test_fused_gated_sae.py runs it: Pallas interpret mode, small tiles.

Tolerances:
- f32 compute: forward values rtol 1e-5; dead, activity and sparsity exact;
  gradients of rec + λ·l1 + aux at rtol 1e-4, atol 1e-7
  (tests/test_fused_gated_sae.py:39-65).
- bf16 compute: the cast points are the same on both sides, so the forward and
  the per-latent gradients agree to f32 summation order (rtol 1e-4: a bf16
  rounding of an operand may flip when its f32 value moved by one ulp). Two
  outputs need more room, for reasons on the JAX side:
  * dW_gate: the interpret-mode Pallas kernel's transposed bf16 product
    (x_centᵀ·dg) differs from the same formula in plain jnp by up to a bf16
    ulp of its largest entry (tests/test_torch_fused_sae.py, the ReLU op's
    dW_enc). Tolerance: one bf16 ulp (2^-8) of max|dW_gate|.
  * db_dec: its centring term multiplies a bf16-rounded row sum of dg; the TPU
    kernel rounds each token tile's partial sum, the port the whole batch's sum
    once, so each term can differ by a bf16 half-ulp: 1e-2 of max|db_dec|.
- The port's fused op against the port's stock gated path (f32): the fused op
  computes the magnitude path as (x·W_gate)·exp(r_mag), the stock path as
  x·(W_gate·exp(r_mag)); equal algebraically, f32 rounding differs: decoded
  rtol 1e-4, atol 1e-5, as tests/test_fused_gated_sae.py:40-44 allows.
"""

import jax
import jax.numpy as jnp
import ml_dtypes
import numpy as np
import pytest
import torch

from sparse_vision_tpu.models.sae import init_gated_sae
from sparse_vision_tpu.ops.fused_gated_sae import fused_gated_sae_loss_terms as jax_fused
from sparse_vision_tpu_torch import convert
from sparse_vision_tpu_torch.models.sae import heaviside_gate, sae_inference_and_loss
from sparse_vision_tpu_torch.ops import fused_gated_sae
from sparse_vision_tpu_torch.ops.metrics import measure_inactive_units

T, C, H_EXP = 128, 64, 4
H = C * H_EXP
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
KEYS = ("W_gate", "b_gate", "b_mag", "r_mag", "W_dec", "b_dec")


def _make_setup(c, h_exp):
    params = init_gated_sae(jax.random.key(0), c, h_exp)
    # gate/magnitude asymmetry away from zero; 16 gates that never open (dead)
    rng = np.random.default_rng(5)
    params = jax.device_get({
        **params,
        "b_gate": (params["b_gate"] - 0.05).at[:16].add(-100.0),
        "b_mag": params["b_mag"] + 0.03,
        "r_mag": params["r_mag"] + 0.1 * rng.normal(size=c * h_exp).astype(np.float32),
        "b_dec": params["b_dec"] + 0.05,
    })
    x = np.random.default_rng(1).normal(size=(T, c)).astype(np.float32)
    return params, x


@pytest.fixture(scope="module")
def setup():
    return _make_setup(C, H_EXP)


def _inputs(setup, x_dtype):
    params, x = setup
    if x_dtype == "bfloat16":
        xb = x.astype(ml_dtypes.bfloat16)
        return params, jnp.asarray(xb), torch.from_numpy(xb.view(np.uint16)).view(torch.bfloat16)
    return params, jnp.asarray(x), torch.from_numpy(x)


def _grads(loss_fn, params):
    p = {k: v.clone().requires_grad_(True) for k, v in params.items()}
    out = loss_fn(p)
    return out, dict(zip(p, torch.autograd.grad(out["loss"], list(p.values()))))


@pytest.fixture(scope="module")
def runs(setup):
    """Both ops' forward outputs and parameter gradients, per case."""
    res = {}
    for case, (cd, xd) in CASES.items():
        params, jx, tx = _inputs(setup, xd)

        def jloss(p):
            return jax_fused(p, jx, LAMBDA, H_EXP, compute_dtype=JDT[cd], **JTILES)

        jout = jloss(params)
        jgrad = jax.grad(lambda p: jloss(p)["loss"])(params)
        tout, tgrad = _grads(lambda p: fused_gated_sae.fused_gated_sae_loss_terms(
            p, tx, LAMBDA, H_EXP, compute_dtype=TDT[cd]), convert.sae_params_from_jax(params))
        res[case] = (jout, jgrad, tout, tgrad)
    return res


def _assert_forward_matches(jout, tout, case):
    rtol = 1e-5 if case == "f32" else 1e-4
    for k in ("loss", "rec_loss", "l1_loss", "aux_loss", "nrmse_loss", "rmse_loss"):
        np.testing.assert_allclose(float(tout[k].detach()), float(jout[k]), rtol=rtol, err_msg=k)
    np.testing.assert_allclose(tout["decoded"].detach().numpy(), np.asarray(jout["decoded"]),
                               rtol=rtol, atol=1e-6)
    np.testing.assert_array_equal(tout["dead"].numpy(), np.asarray(jout["dead"]))
    np.testing.assert_array_equal(tout["activity_freq"].numpy(),
                                  np.asarray(jout["activity_freq"]))
    np.testing.assert_allclose(float(tout["sparsity"]), float(jout["sparsity"]), rtol=1e-6)
    assert bool(jout["dead"].any()) and not bool(jout["dead"].all())


@pytest.mark.parametrize("case", list(CASES))
def test_forward_matches_jax(runs, case):
    jout, _, tout, _ = runs[case]
    _assert_forward_matches(jout, tout, case)


@pytest.mark.parametrize("case", list(CASES))
def test_gradients_match_jax(runs, case):
    _, jgrad, _, tgrad = runs[case]
    for k in KEYS:
        ref = np.asarray(jgrad[k])
        if case == "f32":
            rtol, atol = 1e-4, 1e-7
        else:
            rtol, atol = {"W_gate": (0, 2.0**-8 * np.abs(ref).max()),
                          "b_dec": (0, 1e-2 * np.abs(ref).max())}.get(k, (1e-4, 1e-6))
        np.testing.assert_allclose(tgrad[k].numpy(), ref, rtol=rtol, atol=atol, err_msg=k)
        assert np.abs(ref).max() > 0, k


def test_fused_matches_the_ports_stock_path(setup):
    """Fused op (f32) against autograd through the port's own gated_sae_apply +
    gated_sae_loss_terms: loss terms, statistics and every parameter gradient."""
    params, x = setup
    tp = convert.sae_params_from_jax(params)
    xt = torch.from_numpy(x)
    fout, fgrad = _grads(lambda p: fused_gated_sae.fused_gated_sae_loss_terms(
        p, xt, LAMBDA, H_EXP, compute_dtype=torch.float32), tp)
    sout, sgrad = _grads(lambda p: sae_inference_and_loss("gated_sae", p, xt, LAMBDA), tp)
    for k in ("loss", "rec_loss", "l1_loss", "aux_loss", "nrmse_loss", "rmse_loss"):
        np.testing.assert_allclose(float(fout[k].detach()), float(sout[k].detach()),
                                   rtol=1e-5, err_msg=k)
    np.testing.assert_allclose(fout["decoded"].detach().numpy(),
                               sout["decoded"].detach().numpy(), rtol=1e-4, atol=1e-5)
    dead, sparsity, freq = measure_inactive_units(sout["encoded"].detach(), H_EXP)
    np.testing.assert_array_equal(fout["dead"].numpy(), dead.numpy())
    np.testing.assert_allclose(fout["activity_freq"].numpy(), freq.numpy(), rtol=1e-6)
    np.testing.assert_allclose(float(fout["sparsity"]), float(sparsity), rtol=1e-6)
    for k in KEYS:
        np.testing.assert_allclose(fgrad[k].numpy(), sgrad[k].numpy(), rtol=1e-4, atol=1e-7,
                                   err_msg=k)


def test_plain_backward_matches_autograd_of_the_fused_algebra(setup):
    """The explicit backward equals autograd through the fused op's algebra (one
    gate product feeding both paths) written in torch, f32, with all three
    coefficients (rec, l1, aux) non-zero and different."""
    params, x = setup
    tp = convert.sae_params_from_jax(params)
    xt = torch.from_numpy(x)
    g_rec, g_l1, g_aux = 1.0, LAMBDA, 0.6
    p = {k: v.clone().requires_grad_(True) for k, v in tp.items()}
    g = (xt - p["b_dec"]) @ p["W_gate"]
    pre_gate = g + p["b_gate"]
    pre_mag = g * torch.exp(p["r_mag"]) + p["b_mag"]
    enc = heaviside_gate(pre_gate) * torch.relu(pre_mag)
    recon = enc @ p["W_dec"] + p["b_dec"]
    via = torch.relu(pre_gate) @ p["W_dec"].detach() + p["b_dec"].detach()
    loss = (g_rec * (recon - xt).square().mean() + g_l1 * torch.relu(pre_gate).mean()
            + g_aux * (via - xt).square().mean())
    auto = dict(zip(KEYS, torch.autograd.grad(loss, [p[k] for k in KEYS])))
    err_rec = (recon - xt).detach()
    err_via = (via - xt).detach()
    coeffs = torch.tensor([2.0 * g_rec / (T * C), g_l1 / (T * H), 2.0 * g_aux / (T * C)])
    mine = fused_gated_sae.fused_gated_backward_plain(
        xt, tp["W_gate"], tp["b_gate"], tp["b_mag"], torch.exp(tp["r_mag"]), tp["W_dec"],
        tp["b_dec"], err_rec, err_via, coeffs)
    for name, a in zip(KEYS, mine):
        np.testing.assert_allclose(a.numpy(), auto[name].numpy(), rtol=1e-4, atol=1e-7,
                                   err_msg=name)


def test_non_cpu_tensor_never_takes_the_plain_path(setup):
    """Only a CPU tensor runs the plain version; any other device must launch a
    kernel or raise (here: a meta tensor raises)."""
    params, _ = setup
    tp = {k: v.to("meta") for k, v in convert.sae_params_from_jax(params).items()}
    ops = (tp["W_gate"], tp["b_gate"], tp["b_mag"], tp["r_mag"], tp["W_dec"], tp["b_dec"])
    x = torch.empty(T, C, device="meta")
    with pytest.raises(ValueError, match="no kernel for device"):
        fused_gated_sae.fused_gated_forward(x, *ops)
    with pytest.raises(ValueError, match="no kernel for device"):
        fused_gated_sae.fused_gated_backward(x, *ops, x, x, torch.empty(3, device="meta"))


@pytest.mark.parametrize("t,h,c,ok", [
    (32768, 16384, 256, True), (512, 1024, 128, True), (32, 64, 64, False),
    (16, 64, 64, False), (100, 1024, 256, False), (512, 1000, 256, False),
    (512, 1024, 96, True), (512, 1024, 512, True),  # any width: C 96, 512
])
def test_can_fuse_states_the_kernel_constraints(t, h, c, ok):
    """The coder SIMT bodies' rule (T and H multiples of 128, any C): the
    forward, and the backward with f32 operands."""
    assert fused_gated_sae.can_fuse(t, h, c, torch.float32) is ok


@pytest.mark.parametrize("t,h,c,fuse,bwd", [
    (32768, 16384, 256, True, True), (512, 1024, 128, True, True),
    (128, 128, 64, True, True), (32, 64, 64, False, False),  # T, H multiples of 128
    (8192, 4096, 832, True, True), (1152, 640, 136, True, True),  # any width of 8
    (512, 1024, 132, False, False), (512, 1088, 256, False, False),
])
def test_bf16_backward_takes_the_coder_bodies_widths(t, h, c, fuse, bwd):
    """In bf16 the backward runs the coder body (T and H multiples of 128, C of
    8), and so does the forward: can_fuse asks both rules, the same in bf16."""
    assert fused_gated_sae.bwd_takes(t, h, c, torch.bfloat16) is bwd
    assert fused_gated_sae.can_fuse(t, h, c, torch.bfloat16) is fuse
    assert fused_gated_sae.can_fuse(t, h, c, "bfloat16") is fuse


@pytest.mark.parametrize("dtype,t,h,c,ok", [
    # bf16: the coder bodies' rule, T and H multiples of 128, C of 8 (one launch
    # to C = 256, two wider)
    ("bfloat16", 32768, 16384, 256, True), ("bfloat16", 8192, 4096, 832, True),
    ("bfloat16", 32768, 16384, 1024, True), ("bfloat16", 1152, 640, 136, True),
    ("bfloat16", 512, 1024, 132, False), ("bfloat16", 32, 64, 64, False),
    ("bfloat16", 512, 1088, 256, False),
    # f32: the coder SIMT bodies', T and H multiples of 128, any C
    ("float32", 32768, 16384, 256, True), ("float32", 32, 64, 64, False),
    ("float32", 8192, 4096, 832, True), ("float32", 512, 1024, 72, True),
    ("float32", 16, 64, 64, False), ("float32", 512, 1000, 256, False),
])
def test_fwd_takes_states_each_routes_rule(dtype, t, h, c, ok):
    """The forward takes the coder bodies' widths, in bf16 multiples of 8 and in
    f32 any; the dtype is a torch dtype or RunConfig's name."""
    assert fused_gated_sae.fwd_takes(t, h, c, dtype) is ok
    assert fused_gated_sae.fwd_takes(t, h, c, TDT[dtype]) is ok


WIDE_C, WIDE_H_EXP = 72, 16  # a width the first port's SIMT bodies refused; H = 1,152


def _grid(a, step):
    return (np.round(np.asarray(a) / step) * step).astype(np.float32)


@pytest.fixture(scope="module")
def wide():
    """Inputs on a dyadic grid (x and b_dec in quarters, W_gate and W_dec in
    1/256ths, b_gate and b_mag odd multiples of 2^-11, r_mag 0): the gate
    product, both decodes and so the residuals are exact in f32 in both
    packages, and a bf16 rounding of c·err, which at this width's 1,152
    latents a summation order could otherwise flip, rounds the same value."""
    h = WIDE_C * WIDE_H_EXP
    params = jax.device_get(init_gated_sae(jax.random.key(0), WIDE_C, WIDE_H_EXP))
    rng = np.random.default_rng(5)

    def odd(n):
        return ((2 * rng.integers(-40, 40, size=n) + 1) * 2.0 ** -11).astype(np.float32)

    b_gate = odd(h)
    b_gate[:16] = -50.0 - 2.0 ** -11  # 16 gates that never open (dead)
    params = {
        **params,
        "W_gate": _grid(params["W_gate"], 2.0 ** -8),
        "W_dec": _grid(params["W_dec"], 2.0 ** -8),
        "b_gate": b_gate,
        "b_mag": odd(h),
        "r_mag": np.zeros(h, np.float32),
        "b_dec": _grid(0.2 * rng.normal(size=WIDE_C), 0.25),
    }
    return params, _grid(np.random.default_rng(1).normal(size=(T, WIDE_C)), 0.25)


@pytest.fixture(scope="module")
def wide_runs(wide):
    """The JAX op's forward outputs and gradients and the port's forward
    outputs at C = 72, per case."""
    res = {}
    for case, (cd, xd) in CASES.items():
        params, jx, tx = _inputs(wide, xd)

        def jloss(p):
            return jax_fused(p, jx, LAMBDA, WIDE_H_EXP, compute_dtype=JDT[cd], **JTILES)

        tout = fused_gated_sae.fused_gated_sae_loss_terms(
            convert.sae_params_from_jax(params), tx, LAMBDA, WIDE_H_EXP, compute_dtype=TDT[cd])
        res[case] = (jloss(params), jax.grad(lambda p: jloss(p)["loss"])(params), tout)
    return res


@pytest.mark.parametrize("case", list(CASES))
def test_forward_matches_jax_at_a_coder_width(wide_runs, case):
    """test_forward_matches_jax at C = 72, a width only the coder bodies take
    (the bf16 forward's route on the card: recon and via_gate held together)."""
    jout, _, tout = wide_runs[case]
    _assert_forward_matches(jout, tout, case)


def _route_grads(params, tx, cd):
    """Parameter gradients of rec + λ·l1 + aux through the forward's plain
    version and the bf16 backward route's (gated_bwd_tc_plain: centre,
    pre-pass on both errors, coder_bwd_tc's gated epilogue), fed as the op's
    autograd function feeds its backward."""
    f = fused_gated_sae
    tp = convert.sae_params_from_jax(params)
    xc, wg, wd = tx.to(cd), tp["W_gate"].to(cd), tp["W_dec"].to(cd)
    er = torch.exp(tp["r_mag"]).float()
    ops = (xc, wg, tp["b_gate"], tp["b_mag"], er, wd, tp["b_dec"])
    recon, via = f.fused_gated_forward_plain(*ops)[:2]
    t, c = tx.shape
    h = er.shape[0]
    g = torch.tensor([1.0, LAMBDA, 1.0])  # the cotangents of rec_loss, l1_loss, aux_loss
    coeffs = torch.stack([g[0] * 2.0 / (t * c), g[1] / (t * h), g[2] * 2.0 / (t * c)])
    grads = f.gated_bwd_tc_plain(*ops, recon - tx, via - tx, coeffs)
    return dict(zip(KEYS, grads))


@pytest.mark.parametrize("width", ["C64", "C72"])
@pytest.mark.parametrize("case", list(CASES))
def test_bf16_route_plain_matches_jax(runs, setup, wide, wide_runs, case, width):
    """The plain version of the tensor-core backward route (centre → pre-pass →
    gated epilogue) against the JAX op's gradients in interpret mode, in f32
    and bf16, with test_gradients_match_jax's tolerances; also at C = 72, a
    width only the coder bodies take."""
    cd, xd = CASES[case]
    if width == "C64":
        jgrad = runs[case][1]
        params, _, tx = _inputs(setup, xd)
    else:
        jgrad = wide_runs[case][1]
        params, _, tx = _inputs(wide, xd)
    tgrad = _route_grads(params, tx, TDT[cd])
    for k in KEYS:
        ref = np.asarray(jgrad[k])
        if case == "f32":
            rtol, atol = 1e-4, 1e-7
        else:
            rtol, atol = {"W_gate": (0, 2.0**-8 * np.abs(ref).max()),
                          "b_dec": (0, 1e-2 * np.abs(ref).max())}.get(k, (1e-4, 1e-6))
        np.testing.assert_allclose(tgrad[k].numpy(), ref, rtol=rtol, atol=atol, err_msg=k)
        assert np.abs(ref).max() > 0, k


def test_kernel_wrapper_validates_before_launch(setup):
    """Shape and dtype checks run before any library is loaded, so a bad call
    fails the same way on every machine."""
    params, x = setup
    tp = convert.sae_params_from_jax(params)
    er = torch.exp(tp["r_mag"])
    with pytest.raises(ValueError, match="not supported"):
        fused_gated_sae.fwd_kernel(torch.from_numpy(x[:48]), tp["W_gate"], tp["b_gate"],
                                   tp["b_mag"], er, tp["W_dec"], tp["b_dec"])
    with pytest.raises(ValueError, match="contiguous"):
        fused_gated_sae.fwd_kernel(torch.from_numpy(x), tp["W_gate"].to(torch.bfloat16),
                                   tp["b_gate"], tp["b_mag"], er, tp["W_dec"], tp["b_dec"])
    err = torch.zeros(T, C, dtype=torch.bfloat16)  # the backward takes f32 errors only
    with pytest.raises(ValueError, match="err_rec"):
        fused_gated_sae.bwd_kernel(torch.from_numpy(x), tp["W_gate"], tp["b_gate"],
                                   tp["b_mag"], er, tp["W_dec"], tp["b_dec"], err, err,
                                   torch.zeros(3))
    assert fused_gated_sae.fwd_kernel.launches == 0 and fused_gated_sae.bwd_kernel.launches == 0
