"""The port's fused crosscoder op (plain versions of the CUDA kernels, the CPU
path) against the JAX fused_crosscoder_loss_terms run as
tests/test_fused_crosscoder.py runs it: Pallas interpret mode, tile_t=32,
tile_h=128. Three layers of 40, 64 and 72 channels (ΣC = 176, not a multiple of
the kernels' channel chunks), 640 latents. The gradients include both routes
of the decoder-norm-weighted L1: the per-latent zsum cotangent into the kernel
backward, and n_j = Σ_l ‖W_dec_l[j]‖ into every W_dec_l by autograd.

Tolerances as tests/test_torch_fused_transcoder.py: f32 forward rtol 1e-5,
gradients rtol 1e-4, atol 1e-7; bf16 rtol 1e-4, atol 1e-6, and dW_enc (the
interpret-mode kernel's transposed bf16 product) 2^-8 of its max. Statistics
(dead, activity, sparsity) exact.
"""

import jax
import jax.numpy as jnp
import ml_dtypes
import numpy as np
import pytest
import torch

from sparse_vision_tpu.models.crosscoder import init_crosscoder
from sparse_vision_tpu.ops.fused_crosscoder import fused_crosscoder_loss_terms as jax_fused
from sparse_vision_tpu_torch import convert
from sparse_vision_tpu_torch.models.crosscoder import crosscoder_inference_and_loss
from sparse_vision_tpu_torch.ops import fused_crosscoder

T, DIMS, EF = 64, (40, 64, 72), 16
H = DIMS[0] * EF
CSUM = sum(DIMS)
LAMBDA = 0.7
JTILES = dict(tile_t=32, tile_h=128, interpret=True)
CASES = {
    # name: (compute dtype, input dtype)
    "f32": ("float32", "float32"),
    "bf16": ("bfloat16", "float32"),
    "bf16_cache": ("bfloat16", "bfloat16"),  # inputs straight from bf16 caches
}
JDT = {"float32": jnp.float32, "bfloat16": jnp.bfloat16}
TDT = {"float32": torch.float32, "bfloat16": torch.bfloat16}


@pytest.fixture(scope="module")
def setup():
    params = init_crosscoder(jax.random.key(0), DIMS, EF)
    # 16 latents can never fire (dead), the rest fire on part of the tokens
    params["b_enc"] = (params["b_enc"] - 0.02).at[:16].add(-100.0)
    params = jax.device_get(params)
    rng = np.random.default_rng(1)
    for i, d in enumerate(DIMS):
        params[f"b_dec_{i}"] = (0.05 * rng.normal(size=d)).astype(np.float32)
    xs = tuple(rng.normal(size=(T, d)).astype(np.float32) for d in DIMS)
    return params, xs


def _pair(a, dtype):
    if dtype == "bfloat16":
        b = a.astype(ml_dtypes.bfloat16)
        return jnp.asarray(b), torch.from_numpy(b.view(np.uint16)).view(torch.bfloat16)
    return jnp.asarray(a), torch.from_numpy(a)


@pytest.fixture(scope="module", params=list(CASES))
def runs(request, setup):
    params, xs = setup
    cd, xd = CASES[request.param]
    pairs = [_pair(x, xd) for x in xs]
    jxs, txs = tuple(p[0] for p in pairs), tuple(p[1] for p in pairs)

    def jloss(p):
        return jax_fused(p, jxs, LAMBDA, EF, compute_dtype=JDT[cd], **JTILES)

    jout, jgrad = jloss(params), jax.grad(lambda p: jloss(p)["loss"])(params)
    tp = {k: v.requires_grad_(True) for k, v in convert.sae_params_from_jax(params).items()}
    tout = fused_crosscoder.fused_crosscoder_loss_terms(tp, txs, LAMBDA, EF,
                                                        compute_dtype=TDT[cd])
    tgrad = dict(zip(tp, torch.autograd.grad(tout["loss"], list(tp.values()))))
    return request.param, jout, jgrad, tout, tgrad


def test_forward_matches_jax(runs):
    case, jout, _, tout, _ = runs
    rtol = 1e-5 if case == "f32" else 1e-4
    for k in ("loss", "rec_loss", "l1_loss", "nrmse_loss", "rmse_loss", "aux_loss"):
        np.testing.assert_allclose(float(tout[k].detach()), float(jout[k]), rtol=rtol, err_msg=k)
    np.testing.assert_array_equal(tout["dead"].numpy(), np.asarray(jout["dead"]))
    np.testing.assert_array_equal(tout["activity_freq"].numpy(),
                                  np.asarray(jout["activity_freq"]))
    np.testing.assert_allclose(float(tout["sparsity"]), float(jout["sparsity"]), rtol=1e-6)
    assert bool(jout["dead"].any()) and not bool(jout["dead"].all())


def test_gradients_match_jax(runs):
    case, _, jgrad, _, tgrad = runs
    assert set(tgrad) == set(jgrad)
    for k, ref in jgrad.items():
        ref = np.asarray(ref)
        if case == "f32":
            rtol, atol = 1e-4, 1e-7
        elif k.startswith("W_enc"):
            rtol, atol = 0, 2.0**-8 * np.abs(ref).max()
        else:
            rtol, atol = 1e-4, 1e-6
        np.testing.assert_allclose(tgrad[k].numpy(), ref, rtol=rtol, atol=atol, err_msg=k)
        assert np.abs(ref).max() > 0, k


def test_fused_op_equals_the_ports_stock_path(setup):
    """f32: the fused op's loss terms and gradients (the n_j path included)
    equal autograd through models/crosscoder.crosscoder_inference_and_loss."""
    params, xs = setup
    txs = tuple(torch.from_numpy(x) for x in xs)

    def grads(loss_fn):
        p = {k: v.requires_grad_(True) for k, v in convert.sae_params_from_jax(params).items()}
        out = loss_fn(p)
        return out, dict(zip(p, torch.autograd.grad(out["loss"], list(p.values()))))

    fo, fg = grads(lambda p: fused_crosscoder.fused_crosscoder_loss_terms(
        p, txs, LAMBDA, EF, compute_dtype="float32"))
    so, sg = grads(lambda p: crosscoder_inference_and_loss(p, txs, LAMBDA))
    for k in ("loss", "rec_loss", "l1_loss", "nrmse_loss", "rmse_loss"):
        np.testing.assert_allclose(float(fo[k].detach()), float(so[k].detach()), rtol=1e-5,
                                   err_msg=k)
    for k in fg:
        np.testing.assert_allclose(fg[k].numpy(), sg[k].numpy(), rtol=1e-4, atol=1e-7,
                                   err_msg=k)


def test_plain_backward_matches_autograd_of_plain_forward(setup):
    """The explicit cat-space backward equals autograd through the plain forward
    with a per-latent L1 weight (f32)."""
    params, xs = setup
    tp = convert.sae_params_from_jax(params)
    x = torch.from_numpy(np.concatenate(xs, 1))
    w_enc = torch.cat([tp[f"W_enc_{i}"] for i in range(3)], 0)
    w_dec = torch.cat([tp[f"W_dec_{i}"] for i in range(3)], 1)
    b_dec = torch.cat([tp[f"b_dec_{i}"] for i in range(3)])
    y = torch.from_numpy(np.random.default_rng(2).normal(size=(T, CSUM)).astype(np.float32))
    n_j = torch.linspace(0.5, 1.5, H)
    leaves = [t.clone().requires_grad_(True) for t in (w_enc, tp["b_enc"], w_dec, b_dec)]
    recon, _, _, zsum = fused_crosscoder.fused_crosscoder_forward_plain(x, *leaves)
    loss = (recon - y).square().mean() + LAMBDA * zsum @ n_j / (T * H)
    auto = torch.autograd.grad(loss, leaves)
    err = (recon - y).detach()
    coeffs = torch.tensor([2.0 / (T * CSUM)])
    mine = fused_crosscoder.fused_crosscoder_backward_plain(
        x, w_enc, tp["b_enc"], w_dec, err, coeffs, LAMBDA * n_j / (T * H))
    for a, b, name in zip(mine, auto, ("W_enc", "b_enc", "W_dec", "b_dec")):
        np.testing.assert_allclose(a.numpy(), b.numpy(), rtol=1e-4, atol=1e-7, err_msg=name)


def test_non_cpu_tensor_never_takes_the_plain_path(setup):
    x = torch.empty(T, CSUM, device="meta")
    w_enc, w_dec = torch.empty(CSUM, H, device="meta"), torch.empty(H, CSUM, device="meta")
    b_enc, b_dec = torch.empty(H, device="meta"), torch.empty(CSUM, device="meta")
    with pytest.raises(ValueError, match="no kernel for device"):
        fused_crosscoder.fused_crosscoder_forward(x, w_enc, b_enc, w_dec, b_dec)
    with pytest.raises(ValueError, match="no kernel for device"):
        fused_crosscoder.fused_crosscoder_backward(x, w_enc, b_enc, w_dec, x,
                                                   torch.empty(1, device="meta"), b_enc)


def test_kernel_wrapper_validates_before_launch(setup):
    """Shape and dtype checks run before any library is loaded."""
    x = torch.zeros(128, CSUM)
    w_enc, w_dec = torch.zeros(CSUM, H), torch.zeros(H, CSUM)
    b_enc, b_dec = torch.zeros(H), torch.zeros(CSUM)
    with pytest.raises(ValueError, match="not supported"):
        fused_crosscoder.fwd_kernel(x[:64], w_enc, b_enc, w_dec, b_dec)
    with pytest.raises(ValueError, match="b_dec must be"):
        fused_crosscoder.fwd_kernel(x, w_enc, b_enc, w_dec, b_dec[1:])
    with pytest.raises(ValueError, match="coeffs must be"):
        fused_crosscoder.bwd_kernel(x, w_enc, b_enc, w_dec, x, torch.zeros(2), b_enc)
    with pytest.raises(ValueError, match="ct must be"):
        fused_crosscoder.bwd_kernel(x, w_enc, b_enc, w_dec, x, torch.zeros(1), b_enc[1:])
    assert all(k.launches == 0 for k in fused_crosscoder.KERNELS)
