"""The port's streaming top-k states (sparse_vision_tpu_torch/ops/topk.py) against
the JAX package's ops/topk.py on the same seeded, tie-free activations: values
and both index buffers exactly, for the largest and the smallest k, through a
stream of batches (fewer samples than k at first, so sentinels are in play) and
through merges of partial states; and on activations with exact ties (a gated
code's zeros), where the port keeps JAX's order: the lower position first."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from sparse_vision_tpu.ops import topk as jtopk
from sparse_vision_tpu_torch.ops import topk as ttopk

K, U, B = 25, 96, 16


def _batches(n_batches, seed=0):
    """Distinct values everywhere (a permutation scaled), so no order of ties can
    differ; filename indices are a permutation too."""
    rng = np.random.default_rng(seed)
    vals = (rng.permutation(n_batches * B * U).reshape(n_batches, B, U).astype(np.float32)
            - n_batches * B * U / 2) / 7.0
    fns = rng.permutation(10_000)[:n_batches * B].reshape(n_batches, B).astype(np.int32)
    return vals, fns


def _same(t, j):
    assert t.largest == j.largest
    np.testing.assert_array_equal(t.values.numpy(), np.asarray(j.values))
    np.testing.assert_array_equal(t.dataset_indices.numpy(), np.asarray(j.dataset_indices))
    np.testing.assert_array_equal(t.filename_indices.numpy(), np.asarray(j.filename_indices))
    assert t.values.dtype == torch.float32 and t.dataset_indices.dtype == torch.int32


@pytest.mark.parametrize("largest", [True, False])
def test_update_topk_matches_jax_over_a_stream(largest):
    vals, fns = _batches(5)
    t = ttopk.init_topk(K, U, largest=largest)
    j = jtopk.init_topk(K, U, largest=largest)
    _same(t, j)
    for i in range(len(vals)):
        t = ttopk.update_topk(t, torch.from_numpy(vals[i]), i * B, torch.from_numpy(fns[i]))
        j = jtopk.update_topk(j, jnp.asarray(vals[i]), jnp.int32(i * B), jnp.asarray(fns[i]))
        _same(t, j)  # the first batch leaves K - B sentinel rows
    assert (t.dataset_indices >= 0).all()


@pytest.mark.parametrize("largest", [True, False])
def test_merge_topk_states_matches_jax(largest):
    vals, fns = _batches(4, seed=1)
    parts_t, parts_j = [], []
    for lo, hi in ((0, 2), (2, 4)):
        t = ttopk.init_topk(K, U, largest=largest)
        j = jtopk.init_topk(K, U, largest=largest)
        for i in range(lo, hi):
            t = ttopk.update_topk(t, torch.from_numpy(vals[i]), i * B, torch.from_numpy(fns[i]))
            j = jtopk.update_topk(j, jnp.asarray(vals[i]), jnp.int32(i * B),
                                  jnp.asarray(fns[i]))
        parts_t.append(t)
        parts_j.append(j)
    merged = ttopk.merge_topk_states(*parts_t)
    _same(merged, jtopk.merge_topk_states(*parts_j))
    # the merge of two halves is the stream over all four batches
    whole = ttopk.init_topk(K, U, largest=largest)
    for i in range(4):
        whole = ttopk.update_topk(whole, torch.from_numpy(vals[i]), i * B,
                                  torch.from_numpy(fns[i]))
    _same(merged, jtopk.TopKState(jnp.asarray(whole.values.numpy()),
                                  jnp.asarray(whole.dataset_indices.numpy()),
                                  jnp.asarray(whole.filename_indices.numpy()), largest))


def test_the_state_keeps_the_dtype_and_device_of_its_buffers():
    s = ttopk.init_topk(3, 5, largest=False)
    s = ttopk.update_topk(s, torch.ones(2, 5, dtype=torch.float64), 4,
                          torch.tensor([7, 9], dtype=torch.int64))
    assert s.values.dtype == torch.float32 and s.filename_indices.dtype == torch.int32
    assert sorted(s.dataset_indices[:, 0].tolist())[1:] == [4, 5]
    assert s.values.device == s.dataset_indices.device == torch.device("cpu")


@pytest.mark.parametrize("largest", [True, False])
def test_ties_keep_the_lower_position_first_as_in_jax(largest):
    rng = np.random.default_rng(2)
    vals = rng.integers(-2, 3, size=(3, B, U)).astype(np.float32)  # five values: many ties
    vals[:, :, :8] = 0.0  # units that never fire
    t = ttopk.init_topk(K, U, largest=largest)
    j = jtopk.init_topk(K, U, largest=largest)
    for i in range(3):
        fns = np.arange(i * B, (i + 1) * B, dtype=np.int32)[::-1].copy()
        t = ttopk.update_topk(t, torch.from_numpy(vals[i]), i * B, torch.from_numpy(fns))
        j = jtopk.update_topk(j, jnp.asarray(vals[i]), jnp.int32(i * B), jnp.asarray(fns))
        _same(t, j)
