"""The port's TopK SAE (sparse_vision_tpu_torch/models/sae.py topk_sae_apply, its
splice branch and ops/fast_topk_sae.py) against the JAX package's on the same
numpy inputs and JAX-initialized weights (convert.py), mirroring
tests/test_topk_sae.py without its sharded case.

Selection: torch.topk and lax.top_k may keep different latents where values tie
at the k-th, so the selected sets are compared on untied (continuous) inputs and
L0 <= k is held exactly on a total tie. Tolerances (f32, sums in another order):
values rtol 1e-5 / atol 1e-6; gradients rtol 1e-5 / atol 1e-7 (the port's gather
decode against JAX's fast and stock paths); train trajectories: losses rtol
2e-4, params rtol 2e-3 / atol 2e-5 (tests/test_training_parity.py:114-119), the
dead accumulators equal.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from sparse_vision_tpu.models import sae as jsae
from sparse_vision_tpu.ops import optim as joptim
from sparse_vision_tpu.ops.fast_topk_sae import fast_topk_sae_loss_terms as j_fast
from sparse_vision_tpu.train.steps import init_sae_train_state as j_init
from sparse_vision_tpu.train.steps import make_sae_train_step_from_acts as j_make
from sparse_vision_tpu_torch import convert
from sparse_vision_tpu_torch.models import sae as tsae
from sparse_vision_tpu_torch.ops import optim as toptim
from sparse_vision_tpu_torch.ops.fast_topk_sae import GatherDecode
from sparse_vision_tpu_torch.ops.fast_topk_sae import fast_topk_sae_loss_terms as t_fast
from sparse_vision_tpu_torch.train import steps as tsteps

D, EXP, K = 16, 4, 5
TERMS = ("loss", "rec_loss", "l1_loss", "nrmse_loss", "rmse_loss")


@pytest.fixture(scope="module", autouse=True)
def one_torch_thread():
    """The port's work here is small: one intra-op thread is as fast alone, and
    much faster when the test workers oversubscribe the cores."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def close(t, j, rtol=1e-5, atol=1e-6, msg=""):
    t = t.detach().numpy() if isinstance(t, torch.Tensor) else np.asarray(t)
    np.testing.assert_allclose(t, np.asarray(j), rtol=rtol, atol=atol, err_msg=msg)


def _params(seed, d=D, exp=EXP):
    """JAX-initialized topk_sae weights with non-zero biases, as numpy."""
    p = jax.device_get(jsae.init_sae("topk_sae", jax.random.key(seed), d, exp))
    rng = np.random.default_rng(seed)
    p = {k: np.array(v) for k, v in p.items()}
    p["b_enc"] = rng.normal(0.0, 0.1, p["b_enc"].shape).astype(np.float32)
    p["b_dec"] = rng.normal(0.0, 0.1, p["b_dec"].shape).astype(np.float32)
    return p


def _j(p):
    return {k: jnp.asarray(v) for k, v in p.items()}


def _grad_params(p):
    return {k: v.clone().requires_grad_(True) for k, v in convert.sae_params_from_jax(p).items()}


def _x(seed, shape):
    return np.random.default_rng(seed).normal(size=shape).astype(np.float32)


def test_topk_matches_jax_and_numpy_golden():
    p, x = _params(0), _x(0, (32, D))
    enc, dec, pre = tsae.topk_sae_apply(convert.sae_params_from_jax(p), torch.from_numpy(x), K)
    jenc, jdec, jpre = jsae.topk_sae_apply(_j(p), jnp.asarray(x), K)
    gpre = (x - p["b_dec"]) @ p["W_enc"] + p["b_enc"]
    genc = np.zeros_like(gpre)
    for t in range(gpre.shape[0]):
        idx = np.argsort(gpre[t])[::-1][:K]
        genc[t, idx] = np.maximum(gpre[t, idx], 0.0)
    for got, want, golden, name in ((pre, jpre, gpre, "pre"), (enc, jenc, genc, "enc"),
                                    (dec, jdec, genc @ p["W_dec"] + p["b_dec"], "dec")):
        close(got, want, msg=name)
        close(got, golden, msg=name)
    np.testing.assert_array_equal(enc.numpy() != 0, np.asarray(jenc) != 0)


def test_topk_l0_bounded_by_k():
    p, x = _params(1), _x(1, (64, D))
    enc, _, _ = tsae.topk_sae_apply(convert.sae_params_from_jax(p), torch.from_numpy(x), K)
    l0 = (enc != 0).sum(1).numpy()
    assert (l0 <= K).all() and l0.max() == K


def test_topk_l0_exact_under_ties():
    """x == b_dec and b_enc == 0 make every pre-activation 0: the index scatter
    keeps at most k of the tied latents (here none, through the ReLU), and a
    positive total tie keeps exactly k in both packages."""
    p = convert.sae_params_from_jax(_params(4))
    p["b_enc"] = torch.zeros_like(p["b_enc"])
    x = p["b_dec"].expand(4, D)
    enc, _, _ = tsae.topk_sae_apply(p, x, K)
    assert ((enc != 0).sum(1) <= K).all()
    p["b_enc"] = torch.full_like(p["b_enc"], 0.5)  # every pre-activation 0.5
    enc, _, _ = tsae.topk_sae_apply(p, x, K)
    jp = {k: jnp.asarray(v.numpy()) for k, v in p.items()}
    jenc, _, _ = jsae.topk_sae_apply(jp, jnp.asarray(x.numpy()), K)
    assert ((enc != 0).sum(1) == K).all()
    assert ((np.asarray(jenc) != 0).sum(1) == K).all()


def test_topk_k_validated():
    p = convert.sae_params_from_jax(_params(5))
    for fn in (lambda: tsae.topk_sae_apply(p, torch.zeros(2, D), D * EXP + 1),
               lambda: t_fast(p, torch.zeros(2, D), 0.0, EXP, D * EXP + 1)):
        with pytest.raises(ValueError, match="exceeds the latent count"):
            fn()


@pytest.mark.parametrize("shape", [(2, 3, 3, D), (24, D)])
def test_topk_inference_and_loss_matches_jax(shape):
    """Maps reshape through the token path; the L1 term is reported and left out
    of the loss (lambda 0.7 here) in both packages."""
    p, act = _params(2), _x(2, shape)
    out = tsae.sae_inference_and_loss("topk_sae", convert.sae_params_from_jax(p),
                                      torch.from_numpy(act), 0.7, topk=K)
    jout = jsae.sae_inference_and_loss("topk_sae", _j(p), jnp.asarray(act), 0.7, topk=K)
    assert float(out["loss"]) == float(out["rec_loss"]) and float(out["l1_loss"]) > 0
    for key in (*TERMS, "aux_loss", "encoded", "encoded_pre", "decoded"):
        assert tuple(out[key].shape) == tuple(jout[key].shape), key
        close(out[key], jout[key], msg=key)


def test_topk_gradients_flow_only_through_selected():
    p, x = _params(3), _x(3, (8, D))
    tp = _grad_params(p)
    enc, dec, _ = tsae.topk_sae_apply(tp, torch.from_numpy(x), K)
    g = torch.autograd.grad(torch.square(dec - torch.from_numpy(x)).mean(), list(tp.values()))
    g = dict(zip(tp, g))
    jg = jax.grad(lambda q: jnp.mean(jnp.square(jsae.topk_sae_apply(q, jnp.asarray(x), K)[1]
                                                - jnp.asarray(x))))(_j(p))
    for k in jg:
        close(g[k], jg[k], atol=1e-7, msg=k)
    selected = (enc > 0).any(0).numpy()
    assert (g["b_enc"].numpy()[~selected] == 0).all()
    assert np.abs(g["b_enc"].numpy()[selected]).max() > 0


def test_topk_approx_selects_exactly_like_jax_off_the_tpu():
    """sae_topk_approx: lax.approx_max_k is exact off the TPU (recall 1 here),
    and the port selects exactly for it: the same codes as JAX's approx path."""
    p, tok = _params(6, 64, 8), _x(6, (128, 64))
    out = tsae.sae_inference_and_loss("topk_sae", convert.sae_params_from_jax(p),
                                      torch.from_numpy(tok), 0.0, topk=8, topk_approx=True)
    jout = jsae.sae_inference_and_loss("topk_sae", _j(p), jnp.asarray(tok), 0.0, topk=8,
                                       topk_approx=True)
    np.testing.assert_array_equal(out["encoded"].numpy() != 0, np.asarray(jout["encoded"]) != 0)
    close(out["encoded"], jout["encoded"])
    assert ((out["encoded"] != 0).sum(1) <= 8).all()


def test_fast_topk_matches_jax_fast_and_stock_terms_and_grads():
    """The gather decode's terms, statistics and gradients against JAX's fast
    path and its stock path (exact selection)."""
    d, exp, k, t = 32, 8, 8, 96
    p, tok = _params(7, d, exp), _x(7, (t, d))
    tp = _grad_params(p)
    fast = t_fast(tp, torch.from_numpy(tok), 0.1, exp, k)
    jfast = j_fast(_j(p), jnp.asarray(tok), 0.1, exp, k)
    jstock = jsae.sae_inference_and_loss("topk_sae", _j(p), jnp.asarray(tok), 0.1, topk=k)
    for key in TERMS:
        close(fast[key], jfast[key], msg=key)
        close(fast[key], jstock[key], msg=key)
    close(fast["decoded"], jfast["decoded"])
    np.testing.assert_array_equal(fast["dead"].numpy(), np.asarray(jfast["dead"]))
    close(fast["activity_freq"], jfast["activity_freq"], rtol=0, atol=0)
    close(fast["sparsity"], jfast["sparsity"])
    g = dict(zip(tp, torch.autograd.grad(fast["loss"], list(tp.values()))))
    jg_fast = jax.grad(lambda q: j_fast(q, jnp.asarray(tok), 0.1, exp, k)["loss"])(_j(p))
    jg_stock = jax.grad(lambda q: jsae.sae_inference_and_loss(
        "topk_sae", q, jnp.asarray(tok), 0.1, topk=k)["loss"])(_j(p))
    for key in jg_fast:
        close(g[key], jg_fast[key], atol=1e-7, msg=key)
        close(g[key], jg_stock[key], atol=1e-7, msg=key)


def test_gather_decode_matches_the_dense_product_and_its_gradients():
    """GatherDecode against the dense scatter-and-product, with indices that
    repeat across tokens (several rows accumulate into one decoder row)."""
    rng = np.random.default_rng(8)
    t, k, h, c = 40, 6, 24, 10
    idx = torch.from_numpy(np.stack([rng.choice(h, k, replace=False) for _ in range(t)]))
    act = torch.from_numpy(rng.random((t, k)).astype(np.float32)).requires_grad_(True)
    w = torch.from_numpy(rng.standard_normal((h, c)).astype(np.float32)).requires_grad_(True)
    g = torch.from_numpy(rng.standard_normal((t, c)).astype(np.float32))
    out = GatherDecode.apply(act, idx, w)
    d_act, d_w = torch.autograd.grad(out, (act, w), g)
    dense_act = act.detach().clone().requires_grad_(True)
    dense_w = w.detach().clone().requires_grad_(True)
    dense = torch.zeros(t, h).scatter(1, idx, dense_act) @ dense_w
    r_act, r_w = torch.autograd.grad(dense, (dense_act, dense_w), g)
    for got, want in ((out, dense), (d_act, r_act), (d_w, r_w)):
        close(got, want.detach(), atol=1e-6)


@pytest.mark.parametrize("fused", [True, False])
def test_topk_train_steps_match_jax(fused):
    """Four steps of make_sae_train_step_from_acts (the fast path with
    ``fused``, else the stock math) against the JAX step on the same batches,
    with AuxK (k_aux 32) across a restart of the rolling dead window
    (dead_neurons_steps 2) and 8 latents that never fire."""
    d, exp, k = 32, 4, 8
    p = _params(9, d, exp)
    p["b_enc"][:8] -= 100.0
    batches = [_x(10 + s, (64, d)) for s in range(4)]
    jtx = joptim.get_optimizer("constrained_adam", 1e-3)
    jts = j_init(_j(p), jtx, d * exp)
    jstep = j_make("topk_sae", 0.0, jtx, 2, exp, fused=fused, topk=k, aux_k=32)
    ttx = toptim.get_optimizer("constrained_adam", 1e-3)
    tts = tsteps.init_sae_train_state(convert.sae_params_from_jax(p), ttx, d * exp)
    tstep = tsteps.make_sae_train_step_from_acts("topk_sae", 0.0, ttx, 2, exp, fused=fused,
                                                 topk=k, aux_k=32)
    for x in batches:
        jts, jm = jstep(jts, jnp.asarray(x))
        tts, tm = tstep(tts, torch.from_numpy(x))
        assert set(tm) == set(jm)
        for key in jm:
            close(tm[key], jm[key], rtol=2e-4, msg=key)
        np.testing.assert_array_equal(tts.dead_acc.numpy(), np.asarray(jts.dead_acc))
    for key in p:
        close(tts.params[key], jts.params[key], rtol=2e-3, atol=2e-5, msg=key)


def test_topk_cached_run_exports_weights_that_read_back(tmp_path):
    """A cached topk_sae run of the port's Pipeline (32 px GoogLeNet, the fast
    path on the CPU) whose code keeps k latents a token at eval, and whose
    exported weights a standalone eval reads back bitwise."""
    import dataclasses
    import glob
    import os

    from sparse_vision_tpu_torch.config import RunConfig
    from sparse_vision_tpu_torch.data.datasets import make_synthetic
    from sparse_vision_tpu_torch.train.pipeline import Pipeline

    size = (32, 32, 3)
    tr = make_synthetic(num_samples=32, img_size=size, num_classes=1000, seed=3)
    va = make_synthetic(num_samples=16, img_size=size, num_classes=1000, seed=4)
    datasets = (tr, va, tr.category_names, size)
    cfg = RunConfig(model_name="inceptionv1", dataset_name="imagenet", sae_layer="mixed3a",
                    sae_model_name="topk_sae", sae_expansion_factor=2, sae_topk=8,
                    sae_batch_size=16, use_activation_cache=True, cache_tokens_per_step=128,
                    cache_dtype="float32", compute_dtype="float32", sae_epochs=1,
                    dead_neurons_steps=1000, seed=3, directory_path=str(tmp_path))
    pipe = Pipeline(cfg, device="cpu", datasets=datasets)
    means = pipe.run()
    assert len(pipe.train_log) == 4 and np.isfinite(means["sae_rec_loss"])
    images = torch.from_numpy(va.images[:4])
    _, taps, _ = pipe.net.apply(pipe.frozen_params, images, state=pipe.net_state)
    code = tsae.sae_inference_and_loss("topk_sae", pipe.ts.params, taps["mixed3a"], 0.0,
                                       topk=cfg.sae_topk, training=False)["encoded"]
    assert code.shape == (4, 4, 4, pipe.num_units)
    assert int((code != 0).sum(-1).max()) == cfg.sae_topk  # per token, as in training
    npz = glob.glob(os.path.join(pipe.paths["sae_weights"], "*_model_weights.npz"))
    back = Pipeline(dataclasses.replace(cfg, training=False, sae_weights_path=npz[0],
                                        directory_path=str(tmp_path / "re")),
                    device="cpu", datasets=datasets)
    for k, v in pipe.ts.params.items():
        assert torch.equal(back.ts.params[k], v), k
