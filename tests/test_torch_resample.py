"""The port's resample schedule and resample_dead_neurons against the JAX package.

The Kaiming draws cannot be reproduced across frameworks, so the port takes them
as arguments and the test hands in the exact draws the JAX function makes from
its key. Tolerance: rtol 1e-5, atol 1e-7 (f32 norms and means on both sides).
"""

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from sparse_vision_tpu.models.sae import init_sae_mlp, kaiming_uniform
from sparse_vision_tpu.ops import optim as joptim
from sparse_vision_tpu.ops.resample import resample_dead_neurons as jresample
from sparse_vision_tpu.ops.resample import should_reset_measurement as j_reset
from sparse_vision_tpu.ops.resample import should_resample as j_resample
from sparse_vision_tpu_torch import convert
from sparse_vision_tpu_torch.ops import resample as tres

C, K = 16, 4


@pytest.mark.parametrize("n", [1, 2, 3, 4, 5, 7])
def test_schedule_matches_jax(n):
    for i in range(1, 41):
        assert tres.should_resample(i, n) == bool(j_resample(jnp.int32(i), n)), (i, n)
        assert tres.should_reset_measurement(i, n) == bool(j_reset(jnp.int32(i), n)), (i, n)


def test_schedule_for_the_north_star_run():
    """dead_neurons_steps=4 over 12 steps: reset at 4 and 12, resample at 9."""
    assert [i for i in range(1, 13) if tres.should_reset_measurement(i, 4)] == [4, 12]
    assert [i for i in range(1, 13) if tres.should_resample(i, 4)] == [9]


def _jax_draws(key, d, h):
    """The draws jax resample_dead_neurons makes from ``key`` (resample.py:64-88)."""
    k_enc, k_dec = jax.random.split(key)
    return (np.array(kaiming_uniform(k_enc, (h, d), fan_in=d)),
            np.array(kaiming_uniform(k_dec, (d, h), fan_in=h)))


@pytest.mark.parametrize("dead_kind", ["some", "none", "all"])
def test_resample_matches_jax(dead_kind):
    h = C * K
    params = init_sae_mlp(jax.random.key(0), C, K)
    rng = np.random.default_rng(0)
    params = {**params, "b_enc": jnp.asarray(rng.normal(size=h).astype(np.float32) * 0.1)}
    tx = joptim.get_optimizer("constrained_adam", 1e-3)
    state = tx.init(params)
    for _ in range(3):  # non-zero moments
        g = {k: jnp.asarray(rng.normal(size=v.shape).astype(np.float32)) for k, v in params.items()}
        u, state = tx.update(g, state, params)
        params = optax.apply_updates(params, u)
    dead = {"some": rng.random(h) < 0.3, "none": np.zeros(h, bool), "all": np.ones(h, bool)}[dead_kind]
    key = jax.random.key(7)
    jp, js = jresample(params, state, jnp.asarray(dead), key)

    np_params = jax.device_get(params)
    tp = convert.sae_params_from_jax(np_params)
    ts = convert.adam_state_from_jax(jax.device_get(state.mu), jax.device_get(state.nu), state.count)
    enc, dec = _jax_draws(key, C, h)
    tp2, ts2 = tres.resample_dead_neurons(tp, ts, torch.from_numpy(dead),
                                          torch.from_numpy(enc), torch.from_numpy(dec))
    for k in np_params:
        np.testing.assert_allclose(tp2[k].numpy(), np.asarray(jp[k]), rtol=1e-5, atol=1e-7,
                                   err_msg=k)
        np.testing.assert_allclose(ts2["mu"][k].numpy(), np.asarray(js.mu[k]), rtol=1e-5,
                                   atol=1e-7, err_msg=f"mu {k}")
        np.testing.assert_allclose(ts2["nu"][k].numpy(), np.asarray(js.nu[k]), rtol=1e-5,
                                   atol=1e-7, err_msg=f"nu {k}")
    assert ts2["count"] == int(js.count) == 3
    np.testing.assert_allclose(torch.linalg.vector_norm(tp2["W_dec"], dim=1).numpy(), 1.0,
                               rtol=1e-5)


def test_kaiming_draws_shapes_and_bounds():
    gen = torch.Generator().manual_seed(0)
    enc, dec = tres.kaiming_draws(gen, C, C * K, C)
    assert enc.shape == (C * K, C) and dec.shape == (C, C * K)
    assert float(enc.abs().max()) <= (6.0 / C) ** 0.5
    assert float(dec.abs().max()) <= (6.0 / (C * K)) ** 0.5
