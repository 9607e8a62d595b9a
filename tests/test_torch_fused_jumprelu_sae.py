"""The port's fused JumpReLU-SAE op (plain versions of the CUDA kernels, the CPU
path) against the JAX fused_jumprelu_sae_loss_terms run as tests/test_jumprelu.py
runs it: Pallas interpret mode, small tiles.

Inputs lie on a dyadic grid (x in quarters, W_enc in 1/256ths, b_enc and b_dec
in 1/2048ths), so every pre-activation is exact in f32 and in bf16-operand
products on both sides: the strict mask ``pre > θ`` and the inclusive STE window
``|pre − θ| ≤ ε/2`` then select the same entries in both packages, and the
comparisons measure the arithmetic that follows, not a threshold flip. The
bandwidth (0.5) and thresholds (0.3-0.7) put many pre-activations inside the
window, so the threshold gradient is non-zero for most latents (checked).

Tolerances:
- f32 compute: forward values rtol 1e-5; dead, activity and sparsity exact;
  gradients of rec + λ·L0 at rtol 1e-4, atol 1e-7 (tests/test_jumprelu.py:150).
- bf16 compute: the cast points are the same on both sides, so the forward and
  the per-latent gradients (db_enc, log_threshold, dW_dec) agree to f32
  summation order: rtol 1e-4 (a bf16 rounding of a decoder-side operand may flip
  when its f32 value moved by one ulp). Two outputs need more room, for reasons
  on the JAX side:
  * dW_enc: the interpret-mode Pallas kernel's transposed bf16 product
    (x_centᵀ·dpre) differs from the same formula in plain jnp by up to a bf16
    ulp of its largest entry (tests/test_torch_fused_sae.py, the ReLU op's
    dW_enc). Tolerance: one bf16 ulp (2^-8) of max|dW_enc|.
  * db_dec: its centring term multiplies a bf16-rounded db_enc; the TPU kernel
    rounds each token tile's partial sum, the port the whole batch's sum once,
    so each term can differ by a bf16 half-ulp: 1e-2 of max|db_dec|.
- The port's fused op against the port's stock JumpReLU path (f32): the same
  formulas through two routes (explicit backward vs autograd through the STE
  Functions): values rtol 1e-5, gradients rtol 1e-4, atol 1e-7.
"""

import jax
import jax.numpy as jnp
import ml_dtypes
import numpy as np
import pytest
import torch

from sparse_vision_tpu.models.sae import init_jumprelu_sae
from sparse_vision_tpu.ops.fused_jumprelu_sae import fused_jumprelu_sae_loss_terms as jax_fused
from sparse_vision_tpu_torch import convert
from sparse_vision_tpu_torch.models.sae import sae_inference_and_loss
from sparse_vision_tpu_torch.ops import fused_jumprelu_sae, fused_sae
from sparse_vision_tpu_torch.ops.metrics import measure_inactive_units

T, C, H_EXP = 128, 64, 4
H = C * H_EXP
LAMBDA, EPS = 0.05, 0.5
JTILES = dict(tile_t=64, tile_h=128, interpret=True, bandwidth=EPS)
CASES = {
    # name: (compute dtype, x dtype)
    "f32": ("float32", "float32"),
    "bf16": ("bfloat16", "float32"),
    "bf16_cache": ("bfloat16", "bfloat16"),  # x straight from a bf16 activation cache
}
JDT = {"float32": jnp.float32, "bfloat16": jnp.bfloat16}
TDT = {"float32": torch.float32, "bfloat16": torch.bfloat16}
KEYS = ("W_enc", "b_enc", "W_dec", "b_dec", "log_threshold")


def _grid(a, step):
    return (np.round(np.asarray(a) / step) * step).astype(np.float32)


def _make_setup(c, h_exp):
    h = c * h_exp
    params = jax.device_get(init_jumprelu_sae(jax.random.key(0), c, h_exp))
    rng = np.random.default_rng(5)
    b_enc = (2 * rng.integers(-40, 40, size=h) + 1) * 2.0 ** -11
    b_enc[:16] = -50.0 - 2.0 ** -11  # 16 latents that never fire (dead)
    params = {
        **params,
        "W_enc": _grid(params["W_enc"], 2.0 ** -8),
        "b_enc": b_enc.astype(np.float32),
        "b_dec": _grid(0.2 * rng.normal(size=c), 0.25),
        "log_threshold": np.log(rng.uniform(0.3, 0.7, size=h)).astype(np.float32),
    }
    x = _grid(np.random.default_rng(1).normal(size=(T, c)), 0.25)
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
        tout, tgrad = _grads(lambda p: fused_jumprelu_sae.fused_jumprelu_sae_loss_terms(
            p, tx, LAMBDA, H_EXP, compute_dtype=TDT[cd], bandwidth=EPS),
            convert.sae_params_from_jax(params))
        res[case] = (jout, jgrad, tout, tgrad)
    return res


def _assert_forward_matches(jout, tout, case):
    rtol = 1e-5 if case == "f32" else 1e-4
    for k in ("loss", "rec_loss", "l0_loss", "l1_loss", "aux_loss", "nrmse_loss", "rmse_loss"):
        np.testing.assert_allclose(float(tout[k].detach()), float(jout[k]), rtol=rtol, err_msg=k)
    np.testing.assert_allclose(tout["decoded"].detach().numpy(), np.asarray(jout["decoded"]),
                               rtol=rtol, atol=1e-6)
    np.testing.assert_array_equal(tout["dead"].numpy(), np.asarray(jout["dead"]))
    np.testing.assert_array_equal(tout["activity_freq"].numpy(),
                                  np.asarray(jout["activity_freq"]))
    np.testing.assert_allclose(float(tout["sparsity"]), float(jout["sparsity"]), rtol=1e-6)
    assert bool(jout["dead"][:16].all()) and not bool(jout["dead"].all())


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
            rtol, atol = {"W_enc": (0, 2.0**-8 * np.abs(ref).max()),
                          "b_dec": (0, 1e-2 * np.abs(ref).max())}.get(k, (1e-4, 1e-6))
        np.testing.assert_allclose(tgrad[k].numpy(), ref, rtol=rtol, atol=atol, err_msg=k)
        assert np.abs(ref).max() > 0, k
    # the STE window caught pre-activations of most live latents
    assert (np.asarray(jgrad["log_threshold"]) != 0).sum() > H // 2


def test_fused_matches_the_ports_stock_path(setup):
    """Fused op (f32) against autograd through the port's own jumprelu_sae_apply +
    jumprelu_loss_terms (the STE autograd.Functions): loss terms, statistics and
    every parameter gradient, log_threshold included."""
    params, x = setup
    tp = convert.sae_params_from_jax(params)
    xt = torch.from_numpy(x)
    fout, fgrad = _grads(lambda p: fused_jumprelu_sae.fused_jumprelu_sae_loss_terms(
        p, xt, LAMBDA, H_EXP, compute_dtype=torch.float32, bandwidth=EPS), tp)
    sout, sgrad = _grads(lambda p: sae_inference_and_loss(
        "jumprelu_sae", p, xt, LAMBDA, jumprelu_bandwidth=EPS), tp)
    for k in ("loss", "rec_loss", "l0_loss", "l1_loss", "nrmse_loss", "rmse_loss"):
        np.testing.assert_allclose(float(fout[k].detach()), float(sout[k].detach()),
                                   rtol=1e-5, err_msg=k)
    np.testing.assert_allclose(fout["decoded"].detach().numpy(),
                               sout["decoded"].detach().numpy(), rtol=1e-5, atol=1e-6)
    dead, sparsity, freq = measure_inactive_units(sout["encoded"].detach(), H_EXP)
    np.testing.assert_array_equal(fout["dead"].numpy(), dead.numpy())
    np.testing.assert_allclose(fout["activity_freq"].numpy(), freq.numpy(), rtol=1e-6)
    np.testing.assert_allclose(float(fout["sparsity"]), float(sparsity), rtol=1e-6)
    for k in KEYS:
        np.testing.assert_allclose(fgrad[k].numpy(), sgrad[k].numpy(), rtol=1e-4, atol=1e-7,
                                   err_msg=k)


def test_only_rec_and_l0_carry_gradients(setup):
    """The differentiability contract: l1_loss is a metric (no gradient path),
    and the L0 term moves only the thresholds."""
    params, x = setup
    tp = convert.sae_params_from_jax(params)
    p = {k: v.clone().requires_grad_(True) for k, v in tp.items()}
    out = fused_jumprelu_sae.fused_jumprelu_sae_loss_terms(
        p, torch.from_numpy(x), LAMBDA, H_EXP, compute_dtype=torch.float32, bandwidth=EPS)
    assert not out["l1_loss"].requires_grad and not out["decoded"].requires_grad
    g = dict(zip(KEYS, torch.autograd.grad(out["l0_loss"], [p[k] for k in KEYS],
                                           allow_unused=True)))
    assert float(g["log_threshold"].abs().max()) > 0
    for k in ("W_enc", "b_enc", "W_dec", "b_dec"):
        assert g[k] is None or float(g[k].abs().max()) == 0.0, k


def test_non_cpu_tensor_never_takes_the_plain_path(setup):
    """Only a CPU tensor runs the plain version; any other device must launch a
    kernel or raise (here: a meta tensor raises)."""
    params, _ = setup
    tp = {k: v.to("meta") for k, v in convert.sae_params_from_jax(params).items()}
    ops = (tp["W_enc"], tp["b_enc"], tp["log_threshold"], tp["W_dec"], tp["b_dec"])
    x = torch.empty(T, C, device="meta")
    with pytest.raises(ValueError, match="no kernel for device"):
        fused_jumprelu_sae.fused_jumprelu_forward(x, *ops)
    with pytest.raises(ValueError, match="no kernel for device"):
        fused_jumprelu_sae.fused_jumprelu_backward(x, *ops, x, torch.empty(2, device="meta"),
                                                   EPS)


@pytest.mark.parametrize("t,h,c,ok", [
    (32768, 16384, 256, True), (512, 1024, 128, True), (64, 64, 64, False),
    (32, 64, 64, False), (100, 1024, 256, False), (512, 1000, 256, False),
    (512, 1024, 96, True), (512, 1024, 512, True),  # any width: C 96, 512
])
def test_can_fuse_states_the_kernel_constraints(t, h, c, ok):
    """The coder SIMT bodies' rule (T and H multiples of 128, any C): the
    forward, and the backward with f32 operands."""
    assert fused_jumprelu_sae.can_fuse(t, h, c, torch.float32) is ok


@pytest.mark.parametrize("t,h,c,fuse,bwd", [
    (32768, 16384, 256, True, True), (512, 1024, 128, True, True),
    (128, 128, 64, True, True), (64, 64, 64, False, False),  # T, H multiples of 128
    (8192, 4096, 832, True, True), (1152, 640, 72, True, True),  # any width of 8
    (512, 1024, 76, False, False), (512, 1088, 256, False, False),
])
def test_bf16_backward_takes_the_coder_bodies_widths(t, h, c, fuse, bwd):
    """In bf16 the backward runs the coder body (T and H multiples of 128, C of
    8), and so does the forward: can_fuse asks both rules, the same in bf16."""
    assert fused_jumprelu_sae.bwd_takes(t, h, c, torch.bfloat16) is bwd
    assert fused_jumprelu_sae.can_fuse(t, h, c, torch.bfloat16) is fuse
    assert fused_jumprelu_sae.can_fuse(t, h, c, "bfloat16") is fuse


@pytest.mark.parametrize("dtype,t,h,c,ok", [
    # bf16: the coder bodies' rule, T and H multiples of 128, C of 8
    ("bfloat16", 32768, 16384, 256, True), ("bfloat16", 8192, 4096, 832, True),
    ("bfloat16", 32768, 16384, 1024, True), ("bfloat16", 1152, 640, 72, True),
    ("bfloat16", 512, 1024, 76, False), ("bfloat16", 64, 64, 64, False),
    ("bfloat16", 512, 1088, 256, False),
    # f32: the coder SIMT bodies', T and H multiples of 128, any C
    ("float32", 32768, 16384, 256, True), ("float32", 64, 64, 64, False),
    ("float32", 8192, 4096, 832, True), ("float32", 512, 1024, 72, True),
    ("float32", 32, 64, 64, False), ("float32", 512, 1000, 256, False),
])
def test_fwd_takes_states_each_routes_rule(dtype, t, h, c, ok):
    """The forward takes the coder bodies' widths, in bf16 multiples of 8 and in
    f32 any; the dtype is a torch dtype or RunConfig's name."""
    assert fused_jumprelu_sae.fwd_takes(t, h, c, dtype) is ok
    assert fused_jumprelu_sae.fwd_takes(t, h, c, TDT[dtype]) is ok


@pytest.mark.parametrize("t", [128, 1152])
def test_scale_err_plain_rounds_once_and_sums_each_step(t):
    """The pre-pass's plain version: round(c·err) exactly, and one f32 column
    sum of the unrounded c·err per 512-token step (a partial last step at
    1,152 tokens)."""
    rng = np.random.default_rng(t)
    err = torch.from_numpy(rng.normal(size=(t, 72)).astype(np.float32))
    c = torch.tensor(3.0e-3)
    dr, part = fused_sae.scale_err_plain(err, c, torch.bfloat16)
    assert dr.dtype == torch.bfloat16 and torch.equal(dr, (c * err).to(torch.bfloat16))
    steps = [(c * err)[i:i + 512] for i in range(0, t, 512)]
    assert part.shape == (len(steps), 72)
    ref = np.stack([s.double().sum(0).numpy() for s in steps])
    np.testing.assert_allclose(part.numpy(), ref, rtol=1e-5, atol=1e-7)
    dr32, _ = fused_sae.scale_err_plain(err, c, torch.float32)
    assert torch.equal(dr32, c * err)


WIDE_C, WIDE_H_EXP = 72, 16  # a width the first port's SIMT bodies refused; H = 1,152


@pytest.fixture(scope="module")
def wide():
    return _make_setup(WIDE_C, WIDE_H_EXP)


@pytest.fixture(scope="module")
def wide_forwards(wide):
    """The JAX op's and the port's forward outputs at C = 72, per case, with
    W_dec on the 1/256 grid as well: the f32 decode over 1,152 latents is then
    exact in both packages, whose sums run in other orders (at random W_dec
    they differ by ~2e-6 on entries near 0, past test_forward_matches_jax's
    atol of 1e-6)."""
    params, x = wide
    params = {**params, "W_dec": _grid(params["W_dec"], 2.0 ** -8)}
    res = {}
    for case, (cd, xd) in CASES.items():
        _, jx, tx = _inputs((params, x), xd)
        jout = jax_fused(params, jx, LAMBDA, WIDE_H_EXP, compute_dtype=JDT[cd], **JTILES)
        tout = fused_jumprelu_sae.fused_jumprelu_sae_loss_terms(
            convert.sae_params_from_jax(params), tx, LAMBDA, WIDE_H_EXP, compute_dtype=TDT[cd],
            bandwidth=EPS)
        res[case] = (jout, tout)
    return res


@pytest.mark.parametrize("case", list(CASES))
def test_forward_matches_jax_at_a_coder_width(wide_forwards, case):
    """test_forward_matches_jax at C = 72, a width only the coder bodies take
    (the bf16 forward's route on the card)."""
    jout, tout = wide_forwards[case]
    _assert_forward_matches(jout, tout, case)


def _route_grads(params, tx, cd):
    """Parameter gradients of rec + λ·L0 through the forward's plain version and
    the bf16 backward route's (jumprelu_bwd_tc_plain: centre, pre-pass,
    coder_bwd_tc's JumpReLU epilogue), fed as the op's autograd function feeds
    its backward."""
    f = fused_jumprelu_sae
    tp = convert.sae_params_from_jax(params)
    xc, we, wd = tx.to(cd), tp["W_enc"].to(cd), tp["W_dec"].to(cd)
    thr = torch.exp(tp["log_threshold"]).float()
    ops = (xc, we, tp["b_enc"], thr, wd, tp["b_dec"])
    err = f.fused_jumprelu_forward_plain(*ops)[0] - tx
    t, c = tx.shape
    g = torch.tensor([1.0, LAMBDA])  # the cotangents of rec_loss and l0_loss
    coeffs = torch.stack([g[0] * 2.0 / (t * c), g[1] / t])
    dw_enc, db_enc, dthr, dw_dec, db_dec = f.jumprelu_bwd_tc_plain(*ops, err, coeffs, EPS)
    return {"W_enc": dw_enc, "b_enc": db_enc, "W_dec": dw_dec, "b_dec": db_dec,
            "log_threshold": dthr * thr}


@pytest.mark.parametrize("width", ["C64", "C72"])
@pytest.mark.parametrize("case", list(CASES))
def test_bf16_route_plain_matches_jax(runs, setup, wide, case, width):
    """The plain version of the tensor-core backward route (centre → pre-pass →
    JumpReLU epilogue) against the JAX op's gradients in interpret mode, in f32
    and bf16, with test_gradients_match_jax's tolerances; also at C = 72, a
    width only the coder bodies take."""
    cd, xd = CASES[case]
    if width == "C64":
        jgrad = runs[case][1]
        params, _, tx = _inputs(setup, xd)
    else:
        params, jx, tx = _inputs(wide, xd)
        jgrad = jax.grad(lambda p: jax_fused(p, jx, LAMBDA, WIDE_H_EXP, compute_dtype=JDT[cd],
                                             **JTILES)["loss"])(params)
    tgrad = _route_grads(params, tx, TDT[cd])
    for k in KEYS:
        ref = np.asarray(jgrad[k])
        if case == "f32":
            rtol, atol = 1e-4, 1e-7
        else:
            rtol, atol = {"W_enc": (0, 2.0**-8 * np.abs(ref).max()),
                          "b_dec": (0, 1e-2 * np.abs(ref).max())}.get(k, (1e-4, 1e-6))
        np.testing.assert_allclose(tgrad[k].numpy(), ref, rtol=rtol, atol=atol, err_msg=k)
        assert np.abs(ref).max() > 0, k
    assert (np.asarray(jgrad["log_threshold"]) != 0).sum() > tgrad["b_enc"].numel() // 2


def test_kernel_wrapper_validates_before_launch(setup):
    """Shape and dtype checks run before any library is loaded, so a bad call
    fails the same way on every machine."""
    params, x = setup
    tp = convert.sae_params_from_jax(params)
    thr = torch.exp(tp["log_threshold"])
    ops = (tp["b_enc"], thr, tp["W_dec"], tp["b_dec"])
    with pytest.raises(ValueError, match="not supported"):
        fused_jumprelu_sae.fwd_kernel(torch.from_numpy(x[:96]), tp["W_enc"], *ops)
    with pytest.raises(ValueError, match="contiguous"):
        fused_jumprelu_sae.fwd_kernel(torch.from_numpy(x), tp["W_enc"].to(torch.bfloat16),
                                      *ops)
    err = torch.zeros(T, C, dtype=torch.bfloat16)  # the backward takes an f32 error only
    with pytest.raises(ValueError, match="err"):
        fused_jumprelu_sae.bwd_kernel(torch.from_numpy(x), tp["W_enc"], *ops, err,
                                      torch.zeros(2), EPS)
    assert fused_jumprelu_sae.fwd_kernel.launches == 0
    assert fused_jumprelu_sae.bwd_kernel.launches == 0
