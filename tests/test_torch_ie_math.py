"""The port's IE formulas (sparse_vision_tpu_torch/interp/ie_math.py) against the
JAX package's on the same numpy inputs, made from a seed: broadcast_average for
conv ([H, W, C]), token-position ([N, C]) and 2-D ([C]) averages, the
channel-wise and all-channel IE, and the sample-weighted running mean.
Tolerance: f32 sums in another order, rtol 1e-6 / atol 1e-7 (the broadcast is
exact)."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from sparse_vision_tpu.interp import ie_math as j_ie
from sparse_vision_tpu_torch.interp import ie_math as t_ie

B = 3
AVG_SHAPES = {"conv": (4, 5, 6), "positions": (7, 6), "dense": (6,)}


def _tokens(avg_shape) -> int:
    return B * int(np.prod(avg_shape[:-1])) if len(avg_shape) > 1 else B


@pytest.mark.parametrize("kind", list(AVG_SHAPES))
def test_broadcast_average_matches_jax(kind):
    avg = np.random.default_rng(0).standard_normal(AVG_SHAPES[kind]).astype(np.float32)
    want = np.asarray(j_ie.broadcast_average(jnp.asarray(avg), B))
    got = t_ie.broadcast_average(torch.from_numpy(avg), B).numpy()
    assert got.shape == want.shape
    np.testing.assert_array_equal(got, want)


def test_broadcast_average_refuses_other_ranks():
    with pytest.raises(ValueError, match="rank 4"):
        t_ie.broadcast_average(torch.zeros(1, 2, 3, 4), B)


@pytest.mark.parametrize("kind", list(AVG_SHAPES))
@pytest.mark.parametrize("fn", ["ie_channel_wise", "ie_all_channels"])
def test_ie_formulas_match_jax(kind, fn):
    rng = np.random.default_rng(1)
    shape = AVG_SHAPES[kind]
    t, c = _tokens(shape), shape[-1]
    act = rng.standard_normal((t, c)).astype(np.float32)
    avg = rng.standard_normal(shape).astype(np.float32)
    grad = rng.standard_normal((t, c)).astype(np.float32)
    want = np.asarray(getattr(j_ie, fn)(jnp.asarray(act), jnp.asarray(avg), jnp.asarray(grad), B))
    got = getattr(t_ie, fn)(*map(torch.from_numpy, (act, avg, grad)), B).numpy()
    assert got.shape == want.shape
    np.testing.assert_allclose(got, want, rtol=1e-6, atol=1e-7)


def test_running_mean_matches_jax():
    rng = np.random.default_rng(2)
    vals = [rng.standard_normal(5).astype(np.float32) for _ in range(3)]
    sizes = [4, 4, 2]
    jm = tm = None
    n = 0
    for v, b in zip(vals, sizes):
        jm = j_ie.running_mean(jm, jnp.asarray(v), n, b)
        tm = t_ie.running_mean(tm, torch.from_numpy(v), n, b)
        n += b
    np.testing.assert_allclose(tm.numpy(), np.asarray(jm), rtol=1e-6)
    np.testing.assert_allclose(tm.numpy(), np.average(vals, axis=0, weights=sizes), rtol=1e-6)
