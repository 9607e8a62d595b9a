"""The port's ConstrainedAdam and Adam against the JAX package's optax
transformations over 6 steps with the same gradients (made with numpy).

Tolerance: rtol 1e-5 on parameters and both moments (f32 on both sides; the
bias corrections and square roots round in different places), atol 1e-8 for
ConstrainedAdam. Adam's b2 = 0.9999 makes the bias correction 1 - b2**count
cancel in f32 (about 1e-4 at step 1), so one ulp of difference in b2**count
between XLA's and torch's pow is a ~6e-4 relative difference in an update of
size lr = 1e-3: atol 1e-6 on the parameters there.
"""

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from sparse_vision_tpu.models.sae import init_sae_mlp
from sparse_vision_tpu.ops import optim as joptim
from sparse_vision_tpu_torch import convert
from sparse_vision_tpu_torch.ops import optim as toptim

C, K, STEPS, LR = 16, 4, 6, 1e-3


def _adam_state(state):
    """The optax ScaleByAdamState inside either optimizer's state."""
    if isinstance(state, optax.ScaleByAdamState):
        return state
    return next(s for s in state if isinstance(s, optax.ScaleByAdamState))


@pytest.mark.parametrize("name", ["constrained_adam", "adam"])
def test_optimizer_trajectory_matches_optax(name):
    params = jax.device_get(init_sae_mlp(jax.random.key(0), C, K))
    rng = np.random.default_rng(0)
    grads = [{k: rng.normal(size=v.shape).astype(np.float32) * 0.1 for k, v in params.items()}
             for _ in range(STEPS)]
    jtx = joptim.get_optimizer(name, LR)
    jp = jax.tree.map(jnp.asarray, params)
    js = jtx.init(jp)
    ttx = toptim.get_optimizer(name, LR)
    tp = convert.sae_params_from_jax(params)
    ts = ttx.init(tp)
    for g in grads:
        ju, js = jtx.update(jax.tree.map(jnp.asarray, g), js, jp)
        jp = optax.apply_updates(jp, ju)
        tu, ts = ttx.update({k: torch.from_numpy(v) for k, v in g.items()}, ts, tp)
        tp = toptim.apply_updates(tp, tu)
        atol = 1e-8 if name == "constrained_adam" else 1e-6
        for k in params:
            np.testing.assert_allclose(tp[k].numpy(), np.asarray(jp[k]), rtol=1e-5, atol=atol,
                                       err_msg=k)
    adam = _adam_state(js)
    assert ts["count"] == int(adam.count) == STEPS
    for k in params:
        np.testing.assert_allclose(ts["mu"][k].numpy(), np.asarray(adam.mu[k]), rtol=1e-5, atol=1e-8)
        np.testing.assert_allclose(ts["nu"][k].numpy(), np.asarray(adam.nu[k]), rtol=1e-5, atol=1e-8)
    if name == "constrained_adam":
        np.testing.assert_allclose(torch.linalg.vector_norm(tp["W_dec"], dim=1).numpy(), 1.0,
                                   rtol=1e-5)


def test_projection_removes_the_parallel_component():
    rng = np.random.default_rng(1)
    w = torch.from_numpy(rng.normal(size=(8, 5)).astype(np.float32))
    g = torch.from_numpy(rng.normal(size=(8, 5)).astype(np.float32))
    out = toptim.project_away_parallel_grad(g, w)
    unit = w / torch.linalg.vector_norm(w, dim=1, keepdim=True)
    np.testing.assert_allclose((out * unit).sum(1).numpy(), 0.0, atol=1e-6)
    ref = joptim.project_away_parallel_grad(jnp.asarray(g.numpy()), jnp.asarray(w.numpy()))
    np.testing.assert_allclose(out.numpy(), np.asarray(ref), rtol=1e-5, atol=1e-7)


def test_constrained_mask_and_unported_optimizer():
    assert toptim.sae_constrained_mask({"W_enc": 0, "W_dec": 0, "b_dec": 0}) == {
        "W_enc": False, "W_dec": True, "b_dec": False}
    with pytest.raises(ValueError, match="Unsupported optimizer"):
        toptim.get_optimizer("rmsprop", 1e-3)
