"""The port's fused transcoder op (plain versions of the CUDA kernels, the CPU
path) against the JAX fused_transcoder_loss_terms run as
tests/test_fused_transcoder.py runs it: Pallas interpret mode, tile_t=32,
tile_h=128. C_in 64 -> C_out 96 (not a multiple of 64), 256 latents.

Tolerances:
- f32 compute: forward values rtol 1e-5; dead, activity and sparsity exact;
  gradients rtol 1e-4, atol 1e-7 (tests/test_fused_transcoder.py).
- bf16 compute: the cast points are the same on both sides, so values and
  gradients agree to f32 summation order (rtol 1e-4, atol 1e-6), except dW_enc:
  the interpret-mode Pallas kernel's transposed bf16 product xᵀ·dpre differs
  from the same formula in plain jnp by up to a bf16 ulp of max|dW_enc|
  (tests/test_torch_fused_sae.py), so its tolerance is 2^-8 of max|dW_enc|.
"""

import functools

import jax
import jax.numpy as jnp
import ml_dtypes
import numpy as np
import pytest
import torch

from sparse_vision_tpu.models.sae import init_transcoder
from sparse_vision_tpu.ops.fused_transcoder import fused_transcoder_loss_terms as jax_fused
from sparse_vision_tpu_torch import convert
from sparse_vision_tpu_torch.models.sae import transcoder_inference_and_loss
from sparse_vision_tpu_torch.ops import fused_crosscoder, fused_transcoder

T, C_IN, EF, C_OUT = 64, 64, 4, 96
H = C_IN * EF
LAMBDA = 0.7
JTILES = dict(tile_t=32, tile_h=128, interpret=True)
CASES = {
    # name: (compute dtype, x and y dtype)
    "f32": ("float32", "float32"),
    "bf16": ("bfloat16", "float32"),
    "bf16_cache": ("bfloat16", "bfloat16"),  # x and y straight from bf16 caches
}
JDT = {"float32": jnp.float32, "bfloat16": jnp.bfloat16}
TDT = {"float32": torch.float32, "bfloat16": torch.bfloat16}


@pytest.fixture(scope="module")
def setup():
    params = init_transcoder(jax.random.key(0), C_IN, EF, C_OUT)
    # 16 latents can never fire (dead), the rest fire on part of the tokens
    b_enc = (params["b_enc"] - 0.1).at[:16].add(-100.0)
    params = jax.device_get({**params, "b_enc": b_enc, "b_dec": params["b_dec"] + 0.05})
    rng = np.random.default_rng(1)
    x = rng.normal(size=(T, C_IN)).astype(np.float32)
    y = rng.normal(size=(T, C_OUT)).astype(np.float32)
    return params, x, y


def _pair(a, dtype):
    """The same array for JAX and for the port, in ``dtype``."""
    if dtype == "bfloat16":
        b = a.astype(ml_dtypes.bfloat16)
        return jnp.asarray(b), torch.from_numpy(b.view(np.uint16)).view(torch.bfloat16)
    return jnp.asarray(a), torch.from_numpy(a)


@pytest.fixture(scope="module", params=list(CASES))
def runs(request, setup):
    params, x, y = setup
    cd, xd = CASES[request.param]
    (jx, tx), (jy, ty) = _pair(x, xd), _pair(y, xd)

    def jloss(p):
        return jax_fused(p, jx, jy, LAMBDA, EF, compute_dtype=JDT[cd], **JTILES)

    jout, jgrad = jloss(params), jax.grad(lambda p: jloss(p)["loss"])(params)
    tp = {k: v.requires_grad_(True) for k, v in convert.sae_params_from_jax(params).items()}
    tout = fused_transcoder.fused_transcoder_loss_terms(tp, tx, ty, LAMBDA, EF,
                                                        compute_dtype=TDT[cd])
    tgrad = dict(zip(tp, torch.autograd.grad(tout["loss"], list(tp.values()))))
    return request.param, jout, jgrad, tout, tgrad


def test_forward_matches_jax(runs):
    case, jout, _, tout, _ = runs
    rtol = 1e-5 if case == "f32" else 1e-4
    for k in ("loss", "rec_loss", "l1_loss", "nrmse_loss", "rmse_loss", "aux_loss"):
        np.testing.assert_allclose(float(tout[k].detach()), float(jout[k]), rtol=rtol, err_msg=k)
    np.testing.assert_allclose(tout["decoded"].numpy(), np.asarray(jout["decoded"]),
                               rtol=rtol, atol=1e-6)
    np.testing.assert_array_equal(tout["dead"].numpy(), np.asarray(jout["dead"]))
    np.testing.assert_array_equal(tout["activity_freq"].numpy(),
                                  np.asarray(jout["activity_freq"]))
    np.testing.assert_allclose(float(tout["sparsity"]), float(jout["sparsity"]), rtol=1e-6)
    assert bool(jout["dead"].any()) and not bool(jout["dead"].all())


def test_gradients_match_jax(runs):
    case, _, jgrad, _, tgrad = runs
    for k in ("W_enc", "b_enc", "W_dec", "b_dec"):
        ref = np.asarray(jgrad[k])
        if case == "f32":
            rtol, atol = 1e-4, 1e-7
        elif k == "W_enc":
            rtol, atol = 0, 2.0**-8 * np.abs(ref).max()
        else:
            rtol, atol = 1e-4, 1e-6
        np.testing.assert_allclose(tgrad[k].numpy(), ref, rtol=rtol, atol=atol, err_msg=k)
        assert np.abs(ref).max() > 0, k


def test_fused_op_equals_the_ports_stock_path(setup):
    """f32: the fused op's loss terms and gradients equal autograd through
    models/sae.transcoder_inference_and_loss."""
    params, x, y = setup
    tx, ty = torch.from_numpy(x), torch.from_numpy(y)

    def grads(loss_fn):
        p = {k: v.requires_grad_(True) for k, v in convert.sae_params_from_jax(params).items()}
        out = loss_fn(p)
        return out, dict(zip(p, torch.autograd.grad(out["loss"], list(p.values()))))

    fo, fg = grads(lambda p: fused_transcoder.fused_transcoder_loss_terms(
        p, tx, ty, LAMBDA, EF, compute_dtype="float32"))
    so, sg = grads(lambda p: transcoder_inference_and_loss(p, tx, ty, LAMBDA))
    for k in ("loss", "rec_loss", "l1_loss", "nrmse_loss", "rmse_loss"):
        np.testing.assert_allclose(float(fo[k].detach()), float(so[k].detach()), rtol=1e-5,
                                   err_msg=k)
    for k in fg:
        np.testing.assert_allclose(fg[k].numpy(), sg[k].numpy(), rtol=1e-4, atol=1e-7,
                                   err_msg=k)


def test_plain_backward_matches_autograd_of_plain_forward(setup):
    """The explicit backward equals autograd through the plain forward (f32)."""
    params, x, y = setup
    tp = convert.sae_params_from_jax(params)
    xt, yt = torch.from_numpy(x), torch.from_numpy(y)
    coeffs = torch.tensor([2.0 / (T * C_OUT), LAMBDA / (T * H)])
    leaves = {k: v.clone().requires_grad_(True) for k, v in tp.items()}
    recon, _, _, l1 = fused_transcoder.fused_transcoder_forward_plain(
        xt, leaves["W_enc"], leaves["b_enc"], leaves["W_dec"], leaves["b_dec"])
    loss = (recon - yt).square().mean() + LAMBDA * l1 / (T * H)
    auto = torch.autograd.grad(loss, [leaves[k] for k in ("W_enc", "b_enc", "W_dec", "b_dec")])
    err = (recon - yt).detach()
    mine = fused_transcoder.fused_transcoder_backward_plain(
        xt, tp["W_enc"], tp["b_enc"], tp["W_dec"], err, coeffs)
    for a, b, name in zip(mine, auto, ("W_enc", "b_enc", "W_dec", "b_dec")):
        np.testing.assert_allclose(a.numpy(), b.numpy(), rtol=1e-4, atol=1e-7, err_msg=name)


def test_non_cpu_tensor_never_takes_the_plain_path(setup):
    """Only a CPU tensor runs the plain version; any other device must launch a
    kernel or raise (here: a meta tensor raises)."""
    params, _, _ = setup
    tp = {k: v.to("meta") for k, v in convert.sae_params_from_jax(params).items()}
    x = torch.empty(T, C_IN, device="meta")
    with pytest.raises(ValueError, match="no kernel for device"):
        fused_transcoder.fused_transcoder_forward(x, tp["W_enc"], tp["b_enc"], tp["W_dec"],
                                                  tp["b_dec"])
    with pytest.raises(ValueError, match="no kernel for device"):
        fused_transcoder.fused_transcoder_backward(x, tp["W_enc"], tp["b_enc"], tp["W_dec"],
                                                   torch.empty(T, C_OUT, device="meta"),
                                                   torch.empty(2, device="meta"))


@pytest.mark.parametrize("t,h,ok", [
    (32768, 16384, True), (16384, 8192, True), (128, 128, True),
    (64, 16384, False), (0, 128, False), (128, 0, False),
    # any H > 0: the op pads the latent axis (the mixed4d -> mixed4e pair: 2,112)
    (32768, 16320, True), (32768, 2112, True),
])
def test_can_fuse_states_the_kernel_constraints(t, h, ok):
    assert fused_transcoder.can_fuse(t, h) is ok


def test_kernel_wrapper_validates_before_launch(setup):
    """Shape and dtype checks run before any library is loaded, so a bad call
    fails the same way on every machine."""
    params, x, y = setup
    tp = convert.sae_params_from_jax(params)
    xt = torch.from_numpy(np.concatenate([x, x]))  # 128 tokens: a shape the kernels take
    with pytest.raises(ValueError, match="not supported"):
        fused_transcoder.fwd_kernel(xt[:100], tp["W_enc"], tp["b_enc"], tp["W_dec"],
                                    tp["b_dec"])
    with pytest.raises(ValueError, match="contiguous"):
        fused_transcoder.fwd_kernel(xt, tp["W_enc"].to(torch.bfloat16), tp["b_enc"],
                                    tp["W_dec"], tp["b_dec"])
    with pytest.raises(ValueError, match="err must be"):
        fused_transcoder.bwd_kernel(xt, tp["W_enc"], tp["b_enc"], tp["W_dec"],
                                    torch.zeros(128, C_OUT + 1), torch.zeros(2))
    assert all(k.launches == 0 for k in fused_transcoder.KERNELS)


@pytest.mark.parametrize("c_in,c_out", [(100, 96), (64, 100), (260, 2897)])
def test_bf16_widths_must_be_multiples_of_8(c_in, c_out):
    """The bf16 kernels copy rows in 16-byte chunks: a bf16 width that is not a
    multiple of 8 raises before any library is loaded, through both ops'
    wrappers; the f32 kernels take any width."""
    t = h = 128
    x, w_enc, b_enc = torch.zeros(t, c_in), torch.zeros(c_in, h), torch.zeros(h)
    w_dec, b_dec = torch.zeros(h, c_out), torch.zeros(c_out)
    bf = torch.bfloat16
    with pytest.raises(ValueError, match="multiple of 8"):
        fused_transcoder.fwd_kernel(x.to(bf), w_enc.to(bf), b_enc, w_dec.to(bf), b_dec)
    with pytest.raises(ValueError, match="multiple of 8"):
        fused_transcoder.bwd_kernel(x.to(bf), w_enc.to(bf), b_enc, w_dec.to(bf),
                                    torch.zeros(t, c_out, dtype=bf), torch.zeros(2))
    with pytest.raises(ValueError, match="multiple of 8"):
        fused_crosscoder.bwd_kernel(x.to(bf), w_enc.to(bf), b_enc, w_dec.to(bf),
                                    torch.zeros(t, c_out, dtype=bf), torch.zeros(1),
                                    torch.zeros(h))
    assert fused_transcoder._check_operands(x, w_enc, b_enc, w_dec, b_dec) == (t, c_in, c_out, h)
    kernels = fused_transcoder.KERNELS + fused_crosscoder.KERNELS
    assert all(k.launches == 0 for k in kernels)


# ---------------------------------------------------------------------------
# latent padding: H = 2,112 (the mixed4d -> mixed4e pair, 528 -> 832) and 200
# ---------------------------------------------------------------------------

PADDED = {2112: (128, 528, 832), 200: (128, 56, 96)}  # H: (T, C_in, C_out)
# the padded op against the unpadded plain math: the same cast points, products
# over H_pad that may sum in another order, so within PAD_RTOL / PAD_ATOL of
# each array's largest magnitude in f32. In bf16 an f32 ulp of the
# reconstruction can flip the bf16 rounding of the saved error (measured on
# the transcoder at H 2,112: 4.8e-7 moved one error entry by 2^-8, dW_enc by
# 8.8e-4 of its largest entry), so bf16 arrays are held to one bf16 ulp
# (PAD_ATOL_BF16) of their largest magnitude
PAD_RTOL, PAD_ATOL, PAD_ATOL_BF16 = 1e-5, 1e-6, 2.0**-8
# against the JAX op in bf16: a post rounded to the neighbouring bf16 value
# where the frameworks sum a pre-activation in another order moves the
# prediction (measured at most 2.3e-4 for the SAE op at this H) and, through
# the rounded error, dW_dec (one bf16 ulp of its largest entry, as dW_enc); in
# f32 the prediction within 2e-5 (both sides sum 2,112 latents' products in
# other orders; measured 1.2e-6), as tests/test_torch_fused_sae.py's wide case
PAD_BF16_RECON_ATOL = 1e-3


@functools.cache
def _padded_setup(h):
    t, c_in, c_out = PADDED[h]
    rng = np.random.default_rng(h)
    params = {
        "W_enc": (rng.normal(size=(c_in, h)) / np.sqrt(c_in)).astype(np.float32),
        "b_enc": (-0.05 + 0.05 * rng.normal(size=h)).astype(np.float32),
        "W_dec": (rng.normal(size=(h, c_out)) / np.sqrt(h)).astype(np.float32),
        "b_dec": (0.1 * rng.normal(size=c_out)).astype(np.float32),
    }
    params["b_enc"][:8] -= 100.0  # 8 latents never fire
    return (params, rng.normal(size=(t, c_in)).astype(np.float32),
            rng.normal(size=(t, c_out)).astype(np.float32))


def _padded_op(params, x, y, cd):
    tp = {k: v.requires_grad_(True) for k, v in convert.sae_params_from_jax(params).items()}
    out = fused_transcoder.fused_transcoder_loss_terms(tp, torch.from_numpy(x),
                                                       torch.from_numpy(y), LAMBDA, 4,
                                                       compute_dtype=cd)
    return tp, out, dict(zip(tp, torch.autograd.grad(out["loss"], list(tp.values()))))


def _close(got, want, name, cd=torch.float32):
    atol = (PAD_ATOL if cd == torch.float32 else PAD_ATOL_BF16) * float(want.abs().max())
    torch.testing.assert_close(got.detach().float(), want.float(), rtol=PAD_RTOL, atol=atol,
                               msg=name)


@pytest.mark.parametrize("case", ["f32", "bf16"])
@pytest.mark.parametrize("h", list(PADDED))
def test_padded_op_matches_the_unpadded_plain_math(h, case):
    """At an H the kernels do not tile, the op pads the latent axis to 128k and
    slices back: loss terms, statistics and gradients equal the plain math at
    the true H, the padded latents' entry-point outputs are exactly zero, and
    nothing the op returns has the padded width."""
    cd = TDT[CASES[case][0]]
    params, x, y = _padded_setup(h)
    tp, out, grads = _padded_op(params, x, y, cd)
    p = convert.sae_params_from_jax(params)
    t, c_out = y.shape
    xc, we, wd = torch.from_numpy(x).to(cd), p["W_enc"].to(cd), p["W_dec"].to(cd)
    recon, act, _, l1_sum = fused_transcoder.fused_transcoder_forward_plain(
        xc, we, p["b_enc"], wd, p["b_dec"])
    err = recon - torch.from_numpy(y)
    for k, want in (("rec_loss", err.square().mean()), ("l1_loss", l1_sum / (t * h)),
                    ("decoded", recon)):
        _close(out[k], want, k, cd)
    torch.testing.assert_close(out["activity_freq"], act / t, rtol=0, atol=0)
    assert out["dead"].shape == (h,) and bool(out["dead"].any())
    coeffs = torch.tensor([2.0 / (t * c_out), LAMBDA / (t * h)])
    want = fused_transcoder.fused_transcoder_backward_plain(xc, we, p["b_enc"], wd, err.to(cd),
                                                            coeffs)
    for (k, g), w in zip(grads.items(), want):
        assert g.shape == tp[k].shape, k
        _close(g, w, k, cd)
    # the entry points at H_pad: every padded latent exactly zero
    hp = fused_transcoder.padded_h(h)
    wep, bep, wdp = fused_transcoder.padded_operands(p["W_enc"], p["b_enc"], p["W_dec"], cd)
    assert wep.shape[1] == bep.shape[0] == wdp.shape[0] == hp > h
    _, act_p, _, zsum = fused_transcoder.coder_forward_plain(xc, wep, bep, wdp, p["b_dec"])
    assert not act_p[h:].any() and not zsum[h:].any()
    dw_enc, db_enc, dw_dec, _ = fused_transcoder.fused_transcoder_backward_plain(
        xc, wep, bep, wdp, err.to(cd), coeffs)
    assert not dw_enc[:, h:].any() and not db_enc[h:].any() and not dw_dec[h:].any()


@pytest.mark.parametrize("case", ["f32", "bf16"])
@pytest.mark.parametrize("h", list(PADDED))
def test_padded_op_matches_jax(h, case):
    """The padded op against the JAX op in interpret mode (one latent tile of
    the whole H), with the module docstring's tolerances and
    PAD_BF16_RECON_ATOL."""
    cd = CASES[case][0]
    params, x, y = _padded_setup(h)
    jp = {k: jnp.asarray(v) for k, v in params.items()}
    tiles = dict(tile_t=64, tile_h=4096, interpret=True)

    def jloss(p):
        return jax_fused(p, jnp.asarray(x), jnp.asarray(y), LAMBDA, 4, compute_dtype=JDT[cd],
                         **tiles)

    jout, jgrad = jloss(jp), jax.grad(lambda p: jloss(p)["loss"])(jp)
    _, tout, tgrad = _padded_op(params, x, y, TDT[cd])
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
        elif k in ("W_enc", "W_dec"):
            rtol, atol = 0, 2.0**-8 * np.abs(ref).max()
        else:
            rtol, atol = 1e-4, 1e-6
        np.testing.assert_allclose(tgrad[k].numpy(), ref, rtol=rtol, atol=atol, err_msg=k)
