"""The port's attribution-patching primitives (sparse_vision_tpu_torch/interp/
patching.py) on the gradient-semantics experiments of tests/test_patching.py,
rerun on the port through torch.func (pass_through is an autograd.Function with
setup_context), and held against the JAX package's values on the same weights
and inputs (the JAX net's, carried over with convert.py):

  1. without the detach, the encoder-output gradient is exactly zero;
  2. with the detach, it is the layer gradient chained through the decoder, and
     an un-passed-through downstream splice distorts the upstream gradient;
  3. pass-through pins the gradient at the spliced output to the clean one;
  and the decoder-vjp node-IE gradient equals the literal detach + pass-through
  one; loss_and_tap_grads equals per-layer gradients (a dense net, and a conv
  net whose taps and gradients are NHWC).

Tolerance: f32 on a tiny net, rtol 1e-5 / atol 1e-7 against JAX.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from sparse_vision_tpu.interp import patching as jp
from sparse_vision_tpu.models import layers as jl
from sparse_vision_tpu.models.sae import init_sae_mlp, sae_mlp_apply as j_sae_apply
from sparse_vision_tpu_torch import convert
from sparse_vision_tpu_torch.interp import patching as tp
from sparse_vision_tpu_torch.models import layers as tl
from sparse_vision_tpu_torch.models.sae import sae_mlp_apply as t_sae_apply

RTOL, ATOL = 1e-5, 1e-7


def _dense(mod):
    return mod.SeqNet([mod.linear("layer1", 4), mod.relu("act1"), mod.linear("layer2", 3),
                       mod.relu("act2"), mod.linear("layer3", 2)])


def _close(got, want):
    np.testing.assert_allclose(np.asarray(got), np.asarray(want), rtol=RTOL, atol=ATOL)


@pytest.fixture(scope="module")
def setup():
    jnet, tnet = _dense(jl), _dense(tl)
    jparams, _ = jnet.init(jax.random.key(0), (5,))
    jsaes = {"layer1": init_sae_mlp(jax.random.key(1), 4, 2),
             "layer2": init_sae_mlp(jax.random.key(2), 3, 2)}
    x = np.array(jax.random.normal(jax.random.key(3), (6, 5)))
    y = np.array(jax.random.normal(jax.random.key(4), (6, 2)))
    tparams, _ = convert.backbone_from_jax(jax.device_get(jparams), {})
    tsaes = {k: convert.sae_params_from_jax(jax.device_get(v)) for k, v in jsaes.items()}
    j = (jnet, jparams, jsaes, jnp.asarray(x), jnp.asarray(y),
         lambda lg, t: jnp.mean(jnp.square(lg - t)))
    t = (tnet, tparams, tsaes, torch.from_numpy(x), torch.from_numpy(y),
         lambda lg, tg: torch.square(lg - tg).mean())
    return j, t


def _splice(m, apply, sae_params, eps=None, stop_grad=True, grad_clean=None):
    """The reference intervention as a splice, in the framework of module ``m``."""

    def sp(act):
        enc, dec, _ = apply(sae_params, act)
        if eps is not None:  # the encoder output as a differentiable input
            dec = (enc + eps) @ sae_params["W_dec"] + sae_params["b_dec"]
        out = m.splice_with_error(act, dec) if stop_grad else dec + (act - dec)
        return out if grad_clean is None else m.pass_through(out, grad_clean)

    return sp


def test_pass_through_is_the_identity_with_the_clean_cotangent():
    y = torch.randn(3, 4, generator=torch.Generator().manual_seed(0))
    clean = torch.arange(12.0).reshape(3, 4)
    out, vjp = torch.func.vjp(lambda a: tp.pass_through(a, clean), y)
    assert torch.equal(out, y)
    assert torch.equal(vjp(torch.ones_like(y))[0], clean)
    # and under vmap over cotangents (the edge pass's use of torch.func)
    stacked = torch.func.vmap(vjp)(torch.ones(5, 3, 4))[0]
    assert torch.equal(stacked, clean.expand(5, 3, 4))


def test_splice_with_error_matches_jax(setup):
    rng = np.random.default_rng(0)
    x, r = (rng.standard_normal((4, 3)).astype(np.float32) for _ in range(2))
    jg = jax.grad(lambda rr: jnp.sum(jp.splice_with_error(jnp.asarray(x), rr) ** 2))(
        jnp.asarray(r))
    tr = torch.from_numpy(r).requires_grad_()
    out = tp.splice_with_error(torch.from_numpy(x), tr)
    (tg,) = torch.autograd.grad((out ** 2).sum(), tr)
    _close(out.detach(), x)  # recon + (x - recon): x up to one rounding
    _close(tg, jg)


def test_exp1_no_detach_encoder_grad_is_zero(setup):
    (jnet, jparams, jsaes, jx, jy, jcrit), (tnet, tparams, tsaes, tx, ty, tcrit) = setup
    enc0, _, _ = t_sae_apply(tsaes["layer1"], tnet.apply(tparams, tx)[1]["layer1"])

    def f(eps):
        sp = _splice(tp, t_sae_apply, tsaes["layer1"], eps=eps, stop_grad=False)
        logits, _, _ = tnet.apply(tparams, tx, splice={"layer1": sp})
        return tcrit(logits, ty), logits

    g, logits = torch.func.grad(f, has_aux=True)(torch.zeros_like(enc0))
    assert float(g.abs().max()) <= 1e-12
    _close(logits, tnet.apply(tparams, tx)[0])
    _close(logits, jnet.apply(jparams, jx)[0])


def test_exp2_detach_chains_the_encoder_grad_through_the_decoder(setup):
    (jnet, jparams, jsaes, jx, jy, jcrit), (tnet, tparams, tsaes, tx, ty, tcrit) = setup
    taps = tnet.apply(tparams, tx)[1]
    enc0, _, _ = t_sae_apply(tsaes["layer2"], taps["layer2"])
    _, _, grads = tp.loss_and_tap_grads(tnet, tparams, None, tx, ty, tcrit, ["layer2"])

    def f(eps):
        sp = _splice(tp, t_sae_apply, tsaes["layer2"], eps=eps)
        return tcrit(tnet.apply(tparams, tx, splice={"layer2": sp})[0], ty)

    g_enc = torch.func.grad(f)(torch.zeros_like(enc0))
    _close(g_enc, grads["layer2"] @ tsaes["layer2"]["W_dec"].T)

    jenc0, _, _ = j_sae_apply(jsaes["layer2"], jnet.apply(jparams, jx)[1]["layer2"])

    def jf(eps):
        sp = _splice(jp, j_sae_apply, jsaes["layer2"], eps=eps)
        return jcrit(jnet.apply(jparams, jx, splice={"layer2": sp})[0], jy)

    _close(g_enc, jax.grad(jf)(jnp.zeros_like(jenc0)))


def test_exp2_upstream_grad_distorted_without_pass_through(setup):
    (jnet, jparams, jsaes, jx, jy, jcrit), (tnet, tparams, tsaes, tx, ty, tcrit) = setup
    _, taps, clean = tp.loss_and_tap_grads(tnet, tparams, None, tx, ty, tcrit, ["layer1"])

    def f(eps1):
        sp2 = _splice(tp, t_sae_apply, tsaes["layer2"])
        splice = {"layer1": lambda a: a + eps1, "layer2": sp2}
        return tcrit(tnet.apply(tparams, tx, splice=splice)[0], ty)

    g1 = torch.func.grad(f)(torch.zeros_like(taps["layer1"]))
    assert not np.allclose(g1.numpy(), clean["layer1"].numpy(), rtol=1e-4)

    def jf(eps1):
        sp2 = _splice(jp, j_sae_apply, jsaes["layer2"])
        splice = {"layer1": lambda a: a + eps1, "layer2": sp2}
        return jcrit(jnet.apply(jparams, jx, splice=splice)[0], jy)

    _close(g1, jax.grad(jf)(jnp.zeros(taps["layer1"].shape)))


def test_exp3_pass_through_sets_the_clean_gradient(setup):
    (jnet, jparams, jsaes, jx, jy, jcrit), (tnet, tparams, tsaes, tx, ty, tcrit) = setup
    _, taps, clean = tp.loss_and_tap_grads(tnet, tparams, None, tx, ty, tcrit,
                                           ["layer1", "layer2"])
    _, _, jclean = jp.loss_and_tap_grads(jnet, jparams, None, jx, jy, jcrit,
                                         ["layer1", "layer2"])

    def run(m, net, params, saes, apply, x, y, crit, cl, eps1, through: bool):
        base = _splice(m, apply, saes["layer1"])
        if through:
            sp1 = lambda a: m.pass_through(base(a) + eps1, cl["layer1"])
        else:
            sp1 = lambda a: base(a) + eps1
        sp2 = _splice(m, apply, saes["layer2"], grad_clean=cl["layer2"])
        logits = net.apply(params, x, splice={"layer1": sp1, "layer2": sp2})[0]
        return crit(logits, y), logits

    zeros = torch.zeros_like(taps["layer1"])
    for through in (True, False):
        g1, logits = torch.func.grad(
            lambda e: run(tp, tnet, tparams, tsaes, t_sae_apply, tx, ty, tcrit, clean, e,
                          through), has_aux=True)(zeros)
        _close(logits, tnet.apply(tparams, tx)[0])
        pinned = np.allclose(g1.numpy(), clean["layer1"].numpy(), rtol=1e-5)
        assert pinned == through
        jg1 = jax.grad(lambda e: run(jp, jnet, jparams, jsaes, j_sae_apply, jx, jy, jcrit,
                                     jclean, e, through)[0])(jnp.zeros(zeros.shape))
        _close(g1, jg1)


def test_node_ie_gradient_equivalence(setup):
    """The engine's decoder vjp at the clean layer gradient equals the literal
    detach + pass-through gradient w.r.t. the encoder output."""
    (jnet, jparams, jsaes, jx, jy, jcrit), (tnet, tparams, tsaes, tx, ty, tcrit) = setup
    _, taps, grads = tp.loss_and_tap_grads(tnet, tparams, None, tx, ty, tcrit, ["layer1"])
    p = tsaes["layer1"]
    enc0, _, _ = t_sae_apply(p, taps["layer1"])

    def f(eps):
        sp = _splice(tp, t_sae_apply, p, eps=eps, grad_clean=grads["layer1"])
        return tcrit(tnet.apply(tparams, tx, splice={"layer1": sp})[0], ty)

    g_literal = torch.func.grad(f)(torch.zeros_like(enc0))
    _, vjp = torch.func.vjp(lambda e: e @ p["W_dec"] + p["b_dec"], enc0)
    (g_fast,) = vjp(grads["layer1"])
    _close(g_literal, g_fast)

    _, jtaps, jgrads = jp.loss_and_tap_grads(jnet, jparams, None, jx, jy, jcrit, ["layer1"])
    jp1 = jsaes["layer1"]
    _, jvjp = jax.vjp(lambda e: e @ jp1["W_dec"] + jp1["b_dec"],
                      j_sae_apply(jp1, jtaps["layer1"])[0])
    _close(g_fast, jvjp(jgrads["layer1"])[0])


def _conv(mod):
    return mod.SeqNet([mod.conv("conv1", 5, kernel=3, padding=1), mod.relu("relu1"),
                       mod.conv("conv2", 6, kernel=3, stride=2), mod.relu("relu2"),
                       mod.flatten("flatten"), mod.linear("fc", 4)])


@pytest.mark.parametrize("kind", ["dense", "conv"])
def test_loss_and_tap_grads_matches_per_layer_grad_and_jax(kind, setup):
    if kind == "dense":
        (jnet, jparams, _, jx, jy, jcrit), (tnet, tparams, _, tx, ty, tcrit) = setup
        layers = ["layer1", "layer2"]
    else:
        from sparse_vision_tpu.ops.losses import cross_entropy as j_ce
        from sparse_vision_tpu_torch.ops.losses import cross_entropy as t_ce

        jnet, tnet = _conv(jl), _conv(tl)
        jparams, _ = jnet.init(jax.random.key(5), (5, 5, 3))
        tparams, _ = convert.backbone_from_jax(jax.device_get(jparams), {})
        rng = np.random.default_rng(6)
        x = rng.standard_normal((3, 5, 5, 3)).astype(np.float32)
        y = rng.integers(0, 4, 3).astype(np.int32)
        jx, jy, tx, ty = jnp.asarray(x), jnp.asarray(y), torch.from_numpy(x), torch.from_numpy(y)
        jcrit, tcrit = j_ce, t_ce
        layers = ["relu1", "conv2"]
    loss, taps, grads = tp.loss_and_tap_grads(tnet, tparams, None, tx, ty, tcrit, layers)
    jloss, jtaps, jgrads = jp.loss_and_tap_grads(jnet, jparams, None, jx, jy, jcrit, layers)
    _close(loss, jloss)
    for name in layers:
        assert grads[name].shape == taps[name].shape == jgrads[name].shape

        def single(eps, name=name):
            return tcrit(tnet.apply(tparams, tx, splice={name: lambda a: a + eps})[0], ty)

        np.testing.assert_allclose(grads[name].numpy(),
                                   torch.func.grad(single)(torch.zeros_like(taps[name])).numpy(),
                                   rtol=1e-6, atol=1e-9)
        _close(taps[name], jtaps[name])
        _close(grads[name], jgrads[name])
