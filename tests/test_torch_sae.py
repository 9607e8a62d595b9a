"""The port's SAE variants (sae_mlp, gated_sae, jumprelu_sae, matryoshka_sae;
the TopK family's and sae_conv's layouts and the refusals: their math is held in
test_torch_topk_sae.py, test_torch_batch_topk.py and test_torch_uncached.py),
losses and metrics against the JAX package on the same inputs.

Inputs come from numpy.random.default_rng; JAX-initialized parameters reach the
port through convert.py. Tolerance: rtol 1e-5 (f32 on both sides; the two
frameworks sum in different orders), atol 1e-6 for elementwise arrays whose
entries can be near zero. Gradients through the gated and JumpReLU paths:
rtol 1e-4, atol 1e-7 (tests/test_fused_gated_sae.py:39-65).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from sparse_vision_tpu.models import sae as jsae
from sparse_vision_tpu.ops import losses as jlosses
from sparse_vision_tpu.ops import metrics as jmetrics
from sparse_vision_tpu_torch import convert
from sparse_vision_tpu_torch.models import sae as tsae
from sparse_vision_tpu_torch.ops import losses as tlosses
from sparse_vision_tpu_torch.ops import metrics as tmetrics

RTOL, ATOL = 1e-5, 1e-6
C, K, LAMBDA = 32, 4, 0.7


def close(t, j, rtol=RTOL, atol=ATOL, msg=""):
    t = t.detach().numpy() if isinstance(t, torch.Tensor) else np.asarray(t)
    np.testing.assert_allclose(t, np.asarray(j), rtol=rtol, atol=atol, err_msg=msg)


@pytest.fixture(scope="module")
def params():
    p = jsae.init_sae_mlp(jax.random.key(0), C, K)
    p = {**p, "b_enc": p["b_enc"] - 0.05, "b_dec": p["b_dec"] + 0.01}
    np_p = jax.device_get(p)
    return np_p, convert.sae_params_from_jax(np_p)


def test_init_sae_mlp_layout_and_bounds():
    gen = torch.Generator().manual_seed(0)
    p = tsae.init_sae_mlp(gen, C, K)
    assert p["W_enc"].shape == (C, C * K) and p["W_dec"].shape == (C * K, C)
    assert p["b_enc"].shape == (C * K,) and p["b_dec"].shape == (C,)
    assert float(p["W_enc"].abs().max()) <= (6.0 / C) ** 0.5
    np.testing.assert_allclose(torch.linalg.vector_norm(p["W_dec"], dim=1).numpy(), 1.0,
                               rtol=1e-6)
    assert float(p["b_enc"].abs().sum()) == 0.0


def test_kaiming_uniform_bound_and_device():
    gen = torch.Generator().manual_seed(3)
    w = tsae.kaiming_uniform(gen, (64, 16), fan_in=16)
    assert w.device.type == "cpu" and w.shape == (64, 16)
    assert float(w.abs().max()) <= (6.0 / 16) ** 0.5


def test_sae_mlp_apply_matches_jax(params):
    np_p, tp = params
    x = np.random.default_rng(1).normal(size=(200, C)).astype(np.float32)
    j = jsae.sae_mlp_apply(np_p, jnp.asarray(x))
    t = tsae.sae_mlp_apply(tp, torch.from_numpy(x))
    for a, b, name in zip(t, j, ("encoded", "decoded", "pre")):
        close(a, b, msg=name)


@pytest.mark.parametrize("shape", [(2, 5, 5, C), (120, C)])
def test_sae_inference_and_loss_matches_jax(params, shape):
    np_p, tp = params
    act = np.random.default_rng(2).normal(size=shape).astype(np.float32)
    j = jsae.sae_inference_and_loss("sae_mlp", np_p, jnp.asarray(act), LAMBDA)
    t = tsae.sae_inference_and_loss("sae_mlp", tp, torch.from_numpy(act), LAMBDA)
    for k in ("loss", "rec_loss", "l1_loss", "nrmse_loss", "rmse_loss", "aux_loss"):
        close(t[k], j[k], msg=k)
    for k in ("encoded", "encoded_pre", "decoded"):
        assert tuple(t[k].shape) == tuple(j[k].shape), k
        close(t[k], j[k], msg=k)


def test_tokens_keep_nhwc_order():
    act = np.arange(2 * 3 * 4 * 5, dtype=np.float32).reshape(2, 3, 4, 5)
    tok, transformed = tsae.tokens_from_act(torch.from_numpy(act))
    jtok, _ = jsae.tokens_from_act(jnp.asarray(act))
    assert transformed
    np.testing.assert_array_equal(tok.numpy(), np.asarray(jtok))
    back = tsae.act_from_tokens(tok, act.shape)
    np.testing.assert_array_equal(back.numpy(), act)


def test_sae_encode_decode_match_jax(params):
    np_p, tp = params
    tok = np.random.default_rng(3).normal(size=(50, C)).astype(np.float32)
    enc_t = tsae.sae_encode("sae_mlp", tp, torch.from_numpy(tok))
    enc_j = jsae.sae_encode("sae_mlp", np_p, jnp.asarray(tok))
    close(enc_t, enc_j)
    close(tsae.sae_decode("sae_mlp", tp, enc_t), jsae.sae_decode("sae_mlp", np_p, enc_j))


def test_unported_sae_raises(params):
    """An unknown variant name raises the JAX package's ValueError; topk_sae and
    sae_conv have no token encoder, and sae_conv no token decoder, in either."""
    np_p, tp = params
    msg = "Unknown SAE model name no_such_sae"
    with pytest.raises(ValueError, match=msg):
        tsae.sae_inference_and_loss("no_such_sae", tp, torch.zeros(4, C), LAMBDA)
    with pytest.raises(ValueError, match=msg):
        jsae.sae_inference_and_loss("no_such_sae", np_p, jnp.zeros((4, C)), LAMBDA)
    for name in ("topk_sae", "sae_conv"):
        for pkg, x in ((tsae, torch.zeros(4, C)), (jsae, jnp.zeros((4, C)))):
            with pytest.raises(ValueError, match="has no token encoder"):
                pkg.sae_encode(name, tp if pkg is tsae else np_p, x)
    with pytest.raises(ValueError, match="has no token decoder"):
        tsae.sae_decode("sae_conv", tp, torch.zeros(4, C * K))


def test_rmse_nrmse_excludes_zero_range_dims():
    rng = np.random.default_rng(4)
    tgt = rng.normal(size=(64, 8)).astype(np.float32)
    tgt[:, 3] = 1.5  # constant dim: excluded from NRMSE
    dec = tgt + 0.1 * rng.normal(size=tgt.shape).astype(np.float32)
    t = tlosses.rmse_nrmse(torch.from_numpy(dec), torch.from_numpy(tgt))
    j = jlosses.rmse_nrmse(jnp.asarray(dec), jnp.asarray(tgt))
    close(t[0], j[0])
    close(t[1], j[1])
    assert np.isfinite(float(t[1]))


@pytest.mark.parametrize("name", ["cross_entropy", "negative_log_likelihood"])
def test_criteria_match_jax(name):
    rng = np.random.default_rng(5)
    logits = rng.normal(size=(16, 10)).astype(np.float32)
    labels = rng.integers(0, 10, size=16).astype(np.int32)
    if name == "negative_log_likelihood":
        logits = np.array(jax.nn.softmax(jnp.asarray(logits), axis=-1))
    t = tlosses.get_criterion(name)(torch.from_numpy(logits), torch.from_numpy(labels))
    j = jlosses.get_criterion(name)(jnp.asarray(logits), jnp.asarray(labels))
    close(t, j)


@pytest.mark.parametrize("shape", [(3, 4, 4, 16), (3, 6, 16), (12, 16)])
def test_measure_inactive_units_and_variance_match_jax(shape):
    rng = np.random.default_rng(6)
    x = np.maximum(rng.normal(size=shape) - 0.8, 0).astype(np.float32)
    x[..., 2] = 0.0  # a dead unit
    recon = (x + 0.05 * rng.normal(size=shape)).astype(np.float32)
    dt, st, ft = tmetrics.measure_inactive_units(torch.from_numpy(x), 2)
    dj, sj, fj = jmetrics.measure_inactive_units(jnp.asarray(x), 2)
    np.testing.assert_array_equal(dt.numpy(), np.asarray(dj))
    close(st, sj)
    close(ft, fj)
    close(tmetrics.variance_explained(torch.from_numpy(x), torch.from_numpy(recon)),
          jmetrics.variance_explained(jnp.asarray(x), jnp.asarray(recon)))
    close(tmetrics.spatial_mean(torch.from_numpy(x)), jmetrics.spatial_mean(jnp.asarray(x)))


def test_logit_metrics_match_jax():
    rng = np.random.default_rng(7)
    a = rng.normal(size=(32, 10)).astype(np.float32)
    b = (a + 0.5 * rng.normal(size=a.shape)).astype(np.float32)
    labels = rng.integers(0, 10, size=32)
    ta, tb = torch.from_numpy(a), torch.from_numpy(b)
    ja, jb = jnp.asarray(a), jnp.asarray(b)
    close(tmetrics.kld_original_vs_modified(ta, tb), jmetrics.kld_original_vs_modified(ja, jb))
    close(tmetrics.perc_same_classification(ta, tb), jmetrics.perc_same_classification(ja, jb))
    close(tmetrics.accuracy(ta, torch.from_numpy(labels)), jmetrics.accuracy(ja, jnp.asarray(labels)))
    dead = rng.random(20) < 0.3
    close(tmetrics.perc_dead(torch.from_numpy(dead)), jmetrics.perc_dead(jnp.asarray(dead)))
    acc = tmetrics.update_dead_accumulator(None, torch.from_numpy(dead))
    acc = tmetrics.update_dead_accumulator(acc, torch.from_numpy(~dead))
    assert not bool(acc.any())


# ---------------------------------------------------------------------------
# gated_sae and jumprelu_sae
# ---------------------------------------------------------------------------

EPS = 0.5  # STE bandwidth: wide enough that the window catches pre-activations


def _variant_params(name):
    """JAX-initialized params moved away from zero (gate/magnitude asymmetry,
    thresholds spread over the pre-activations' range); numpy and torch copies."""
    rng = np.random.default_rng(11)
    h = C * K
    if name == "gated_sae":
        p = jax.device_get(jsae.init_gated_sae(jax.random.key(0), C, K))
        p = {**p, "b_gate": rng.normal(0.0, 0.1, h).astype(np.float32),
             "b_mag": rng.normal(0.0, 0.1, h).astype(np.float32),
             "r_mag": rng.normal(0.0, 0.2, h).astype(np.float32),
             "b_dec": rng.normal(0.0, 0.05, C).astype(np.float32)}
    else:
        p = jax.device_get(jsae.init_jumprelu_sae(jax.random.key(0), C, K))
        p = {**p, "log_threshold": np.log(rng.uniform(0.1, 0.6, h)).astype(np.float32),
             "b_dec": rng.normal(0.0, 0.05, C).astype(np.float32)}
    return p, convert.sae_params_from_jax(p)


def _jax_and_torch_grads(name, np_p, tp, x, jax_loss, torch_loss):
    jg = jax.grad(lambda p: jax_loss(p, jnp.asarray(x)))(jax.tree.map(jnp.asarray, np_p))
    p = {k: v.clone().requires_grad_(True) for k, v in tp.items()}
    tg = torch.autograd.grad(torch_loss(p, torch.from_numpy(x)), list(p.values()))
    return jg, dict(zip(p, tg))


@pytest.mark.parametrize("name", ["gated_sae", "jumprelu_sae"])
def test_init_sae_layout_and_unit_decoder_rows(name):
    gen = torch.Generator().manual_seed(0)
    p = tsae.init_sae(name, gen, C, K, jumprelu_threshold_init=0.25)
    jp = tsae.init_sae(name, torch.Generator().manual_seed(0), C, K)
    j = jax.device_get(jsae.init_sae(name, jax.random.key(0), C, K,
                                     jumprelu_threshold_init=0.25))
    assert set(p) == set(j) == set(jp)
    for k, v in p.items():
        assert tuple(v.shape) == tuple(j[k].shape) and v.dtype == torch.float32, k
    np.testing.assert_allclose(torch.linalg.vector_norm(p["W_dec"], dim=1).numpy(), 1.0,
                               rtol=1e-6)
    first = "W_gate" if name == "gated_sae" else "W_enc"
    assert float(p[first].abs().max()) <= (6.0 / C) ** 0.5
    zeros = [k for k in p if k.startswith("b_") or k == "r_mag"]
    assert all(float(p[k].abs().sum()) == 0.0 for k in zeros)
    if name == "jumprelu_sae":
        close(p["log_threshold"], j["log_threshold"])  # log(0.25) in f32, as JAX takes it
        close(jp["log_threshold"], np.full(C * K, np.log(np.float32(1e-3))))


def test_init_sae_refuses_unported_names():
    """init_sae raises the JAX package's ValueError for an unknown name."""
    with pytest.raises(ValueError, match="Unknown SAE model name no_such_sae"):
        tsae.init_sae("no_such_sae", torch.Generator().manual_seed(0), C, K)
    with pytest.raises(ValueError, match="Unknown SAE model name no_such_sae"):
        jsae.init_sae("no_such_sae", jax.random.key(0), C, K)


@pytest.mark.parametrize("name,shapes", [
    ("topk_sae", {"W_enc": (C, C * K), "b_enc": (C * K,), "W_dec": (C * K, C), "b_dec": (C,)}),
    ("batch_topk_sae", {"W_enc": (C, C * K), "b_enc": (C * K,), "W_dec": (C * K, C),
                        "b_dec": (C,), "threshold": ()}),
    ("sae_conv", {"W_enc": (3, 3, C, C * K), "b_enc": (C * K,), "W_dec": (3, 3, C * K, C),
                  "b_dec": (C,)}),
])
def test_init_sae_new_variants_have_the_jax_layout(name, shapes):
    """The TopK family's and sae_conv's parameter shapes and init bounds are the
    JAX package's (the draws differ: a torch generator, not a JAX key)."""
    tp = tsae.init_sae(name, torch.Generator().manual_seed(0), C, K)
    jp = jsae.init_sae(name, jax.random.key(0), C, K)
    assert {k: tuple(v.shape) for k, v in tp.items()} == shapes
    assert {k: tuple(v.shape) for k, v in jp.items()} == shapes
    for k, v in tp.items():
        bound = float(np.abs(np.asarray(jp[k])).max())
        if name == "sae_conv":  # U(±1/sqrt(9·c_in)) for weights and biases
            bound = 1.0 / np.sqrt(9 * (C if k in ("W_enc", "b_enc") else C * K))
            assert float(v.abs().max()) <= bound and float(v.abs().max()) > 0.9 * bound, k
        elif k == "W_dec":
            close(torch.linalg.vector_norm(v, dim=-1), np.ones(C * K))
        elif k in ("b_enc", "b_dec", "threshold"):
            assert float(v.abs().max()) == bound == 0.0, k


def test_intervene_on_decoder_weights_matches_jax(params):
    np_p, tp = params
    value = np.linspace(-1.0, 1.0, C).astype(np.float32)
    got = tsae.intervene_on_decoder_weights(tp, 5, torch.from_numpy(value))
    want = jsae.intervene_on_decoder_weights({k: jnp.asarray(v) for k, v in np_p.items()}, 5,
                                             jnp.asarray(value))
    for k in want:
        close(got[k], want[k], rtol=0, atol=0, msg=k)
    assert not torch.equal(tp["W_dec"][5], got["W_dec"][5])  # the input is not changed


def test_gated_sae_apply_matches_jax():
    np_p, tp = _variant_params("gated_sae")
    x = np.random.default_rng(1).normal(size=(200, C)).astype(np.float32)
    j = jsae.gated_sae_apply(np_p, jnp.asarray(x))
    t = tsae.gated_sae_apply(tp, torch.from_numpy(x))
    for a, b, name in zip(t, j, ("encoded", "decoded", "relu_pi_gate", "via_gate")):
        close(a, b, msg=name)


def test_heaviside_gate_is_half_at_zero_and_detached():
    pi = torch.tensor([-1.0, 0.0, 2.0], requires_grad=True)
    g = tsae.heaviside_gate(pi)
    assert g.tolist() == [0.0, 0.5, 1.0] and not g.requires_grad


def test_jumprelu_sae_apply_matches_jax():
    np_p, tp = _variant_params("jumprelu_sae")
    x = np.random.default_rng(1).normal(size=(200, C)).astype(np.float32)
    j = jsae.jumprelu_sae_apply(np_p, jnp.asarray(x), EPS)
    t = tsae.jumprelu_sae_apply(tp, torch.from_numpy(x), EPS)
    for a, b, name in zip(t, j, ("encoded", "decoded", "pre")):
        close(a, b, msg=name)
    post = t[0].detach()
    assert bool(((post == 0) | (post > torch.exp(tp["log_threshold"]))).all())


@pytest.mark.parametrize("name", ["gated_sae", "jumprelu_sae"])
@pytest.mark.parametrize("shape", [(2, 5, 5, C), (120, C)])
def test_variant_inference_and_loss_match_jax(name, shape):
    np_p, tp = _variant_params(name)
    act = np.random.default_rng(2).normal(size=shape).astype(np.float32)
    j = jsae.sae_inference_and_loss(name, np_p, jnp.asarray(act), LAMBDA,
                                    jumprelu_bandwidth=EPS)
    t = tsae.sae_inference_and_loss(name, tp, torch.from_numpy(act), LAMBDA,
                                    jumprelu_bandwidth=EPS)
    keys = ("loss", "rec_loss", "l1_loss", "nrmse_loss", "rmse_loss", "aux_loss")
    for k in keys + (("l0_loss",) if name == "jumprelu_sae" else ()):
        close(t[k], j[k], msg=k)
    for k in ("encoded", "decoded"):
        assert tuple(t[k].shape) == tuple(j[k].shape), k
        close(t[k], j[k], msg=k)
    if name == "gated_sae":
        assert t["encoded_pre"] is None and j["encoded_pre"] is None
    else:
        close(t["encoded_pre"], j["encoded_pre"])
    enc = np.random.default_rng(3).normal(size=(50, C)).astype(np.float32)
    enc_t = tsae.sae_encode(name, tp, torch.from_numpy(enc))
    close(enc_t, jsae.sae_encode(name, np_p, jnp.asarray(enc)))
    close(tsae.sae_decode(name, tp, enc_t), jsae.sae_decode(name, np_p, jnp.asarray(enc_t)))


@pytest.mark.parametrize("name", ["gated_sae", "jumprelu_sae"])
def test_variant_gradients_match_jax_grad(name):
    """Autograd through the port's stock path (the detached gate and frozen
    via_gate decoder; the STE autograd.Functions) against jax.grad of the JAX
    apply + loss terms, for every parameter."""
    np_p, tp = _variant_params(name)
    x = np.random.default_rng(4).normal(size=(160, C)).astype(np.float32)

    def jloss(p, xx):
        return jsae.sae_inference_and_loss(name, p, xx, LAMBDA, jumprelu_bandwidth=EPS)["loss"]

    def tloss(p, xx):
        return tsae.sae_inference_and_loss(name, p, xx, LAMBDA, jumprelu_bandwidth=EPS)["loss"]

    jg, tg = _jax_and_torch_grads(name, np_p, tp, x, jloss, tloss)
    for k in np_p:
        ref = np.asarray(jg[k])
        close(tg[k], ref, rtol=1e-4, atol=1e-7, msg=k)
        assert np.abs(ref).max() > 0, k


def test_jumprelu_ste_functions_match_jax():
    """The two STE autograd.Functions against the JAX custom VJPs on crafted
    pre-activations: inside and outside the inclusive window, above and below
    the strict threshold; jumprelu_l0 gives pre no gradient."""
    eps = 1e-3
    thr = np.array([0.5, 0.2], np.float32)
    pre = np.array([[0.5 + 0.2 * eps, 0.2 - 10 * eps],
                    [0.5 - 0.4 * eps, 0.2 + 0.1 * eps],
                    [2.0, -1.0]], np.float32)
    ct = np.random.default_rng(6).normal(size=pre.shape).astype(np.float32)
    jp, jt = jnp.asarray(pre), jnp.asarray(thr)
    tp = torch.from_numpy(pre).requires_grad_(True)
    tt = torch.from_numpy(thr).requires_grad_(True)

    out_t = tsae.jumprelu(tp, tt, eps)
    close(out_t, jsae._jumprelu(jp, jt, eps))
    jgp, jgt = jax.grad(lambda p, t: jnp.sum(jsae._jumprelu(p, t, eps) * ct),
                        argnums=(0, 1))(jp, jt)
    gp, gt = torch.autograd.grad((out_t * torch.from_numpy(ct)).sum(), [tp, tt])
    close(gp, jgp, msg="d pre")
    close(gt, jgt, msg="d threshold")
    assert float(gt.abs().max()) > 0

    l0_t = tsae.jumprelu_l0(tp, tt, eps)
    close(l0_t, jsae.jumprelu_l0(jp, jt, eps))
    jgp, jgt = jax.grad(lambda p, t: 3.0 * jsae.jumprelu_l0(p, t, eps), argnums=(0, 1))(jp, jt)
    gp, gt = torch.autograd.grad(3.0 * l0_t, [tp, tt])
    close(gt, jgt, msg="d threshold (L0)")
    assert float(gp.abs().max()) == 0.0 and float(np.abs(np.asarray(jgp)).max()) == 0.0


# ---------------------------------------------------------------------------
# matryoshka_sae
# ---------------------------------------------------------------------------

PREFIXES = (0.25, 0.5, 1.0)


@pytest.mark.parametrize("h,fractions,counts", [
    (128, (0.0625, 0.25, 1.0), (8, 32, 128)),  # tests/test_matryoshka.py:18-26
    (10, (1.0,), (10,)),
    (100, (0.5, 0.9), (50, 100)),  # the last prefix is forced to the whole dictionary
    (16384, (0.0625, 0.25, 1.0), (1024, 4096, 16384)),
])
def test_matryoshka_prefix_counts_match_jax(h, fractions, counts):
    assert tsae.matryoshka_prefix_counts(h, fractions) == counts
    assert jsae.matryoshka_prefix_counts(h, fractions) == counts


@pytest.mark.parametrize("fractions", [(0.5, 0.5, 1.0), (0.0, 1.0), (), (0.5, 1.5)])
def test_matryoshka_prefix_counts_refuse_what_jax_refuses(fractions):
    """Repeated counts, fractions outside (0, 1] and no fraction at all raise in
    both packages."""
    with pytest.raises(ValueError):
        jsae.matryoshka_prefix_counts(100, fractions)
    with pytest.raises(ValueError):
        tsae.matryoshka_prefix_counts(100, fractions)


def test_init_matryoshka_sae_is_the_relu_layout():
    p = tsae.init_sae("matryoshka_sae", torch.Generator().manual_seed(0), C, K)
    q = tsae.init_sae_mlp(torch.Generator().manual_seed(0), C, K)
    assert set(p) == set(q) == set(jsae.init_sae("matryoshka_sae", jax.random.key(0), C, K))
    for k in p:
        torch.testing.assert_close(p[k], q[k], rtol=0, atol=0)


def test_matryoshka_sae_apply_matches_jax(params):
    np_p, tp = params
    x = np.random.default_rng(1).normal(size=(200, C)).astype(np.float32)
    counts = tsae.matryoshka_prefix_counts(C * K, PREFIXES)
    j = jsae.matryoshka_sae_apply(np_p, jnp.asarray(x), counts)
    t = tsae.matryoshka_sae_apply(tp, torch.from_numpy(x), counts)
    for a, b, name in zip(t[:3], j[:3], ("encoded", "decoded", "pre")):
        close(a, b, msg=name)
    assert len(t[3]) == len(j[3]) == 3
    for p, (a, b) in enumerate(zip(t[3], j[3])):
        close(a, b, msg=f"prefix {p}")


@pytest.mark.parametrize("shape", [(2, 5, 5, C), (120, C)])
def test_matryoshka_inference_and_loss_match_jax(params, shape):
    np_p, tp = params
    act = np.random.default_rng(2).normal(size=shape).astype(np.float32)
    j = jsae.sae_inference_and_loss("matryoshka_sae", np_p, jnp.asarray(act), LAMBDA,
                                    matryoshka_prefixes=PREFIXES)
    t = tsae.sae_inference_and_loss("matryoshka_sae", tp, torch.from_numpy(act), LAMBDA,
                                    matryoshka_prefixes=PREFIXES)
    for k in ("loss", "rec_loss", "l1_loss", "nrmse_loss", "rmse_loss", "aux_loss"):
        close(t[k], j[k], msg=k)
    assert float(t["aux_loss"]) != 0.0  # the prefix surcharge
    for k in ("encoded", "encoded_pre", "decoded"):
        assert tuple(t[k].shape) == tuple(j[k].shape), k
        close(t[k], j[k], msg=k)
    tok = np.random.default_rng(3).normal(size=(50, C)).astype(np.float32)
    enc_t = tsae.sae_encode("matryoshka_sae", tp, torch.from_numpy(tok))
    close(enc_t, jsae.sae_encode("matryoshka_sae", np_p, jnp.asarray(tok)))
    close(tsae.sae_decode("matryoshka_sae", tp, enc_t),
          jsae.sae_decode("matryoshka_sae", np_p, jnp.asarray(enc_t.numpy())))


def test_matryoshka_gradients_match_jax_grad(params):
    """Autograd through the port's stock Matryoshka path against jax.grad, for
    every parameter and the input."""
    np_p, tp = params
    x = np.random.default_rng(4).normal(size=(160, C)).astype(np.float32)

    def jloss(p, xx):
        return jsae.sae_inference_and_loss("matryoshka_sae", p, xx, LAMBDA,
                                           matryoshka_prefixes=PREFIXES)["loss"]

    jg, jgx = jax.grad(jloss, argnums=(0, 1))(jax.tree.map(jnp.asarray, np_p), jnp.asarray(x))
    p = {k: v.clone().requires_grad_(True) for k, v in tp.items()}
    tx = torch.from_numpy(x).requires_grad_(True)
    loss = tsae.sae_inference_and_loss("matryoshka_sae", p, tx, LAMBDA,
                                       matryoshka_prefixes=PREFIXES)["loss"]
    tg = torch.autograd.grad(loss, [*p.values(), tx])
    for k, g in zip(p, tg):
        close(g, jg[k], rtol=1e-4, atol=1e-7, msg=k)
    close(tg[-1], jgx, rtol=1e-4, atol=1e-7, msg="x")


def test_matryoshka_loss_terms_match_jax():
    rng = np.random.default_rng(8)
    tgt = rng.normal(size=(40, 8)).astype(np.float32)
    enc = np.maximum(rng.normal(size=(40, 24)), 0).astype(np.float32)
    recons = [(tgt + s * rng.normal(size=tgt.shape)).astype(np.float32) for s in (0.5, 0.2, 0.1)]
    t = tlosses.matryoshka_loss_terms(torch.from_numpy(enc), [torch.from_numpy(r) for r in recons],
                                      torch.from_numpy(tgt), LAMBDA)
    j = jlosses.matryoshka_loss_terms(jnp.asarray(enc), [jnp.asarray(r) for r in recons],
                                      jnp.asarray(tgt), LAMBDA)
    assert set(t) == set(j)
    for k in t:
        close(t[k], j[k], msg=k)
    assert float(t["aux_loss"]) > 0  # coarser prefixes reconstruct worse here
