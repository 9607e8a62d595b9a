"""Activation caches are byte-compatible between the JAX package and the port, in
both directions, for float32, bfloat16 and int8 shards; and the port's reader
yields the same blocks in the same order as the JAX reader for the same seed.
All comparisons are exact (bit patterns for bf16)."""

import os

import ml_dtypes
import numpy as np
import pytest
import torch

from sparse_vision_tpu.data.activation_cache import ActivationCache as JCache
from sparse_vision_tpu.data.activation_cache import _ShardWriter as JWriter
from sparse_vision_tpu_torch.data.activation_cache import ActivationCache as TCache
from sparse_vision_tpu_torch.data.activation_cache import _ShardWriter as TWriter

DIM, SHARD = 16, 512
DTYPES = ["float32", "bfloat16", "int8"]


def _chunks():
    rng = np.random.default_rng(0)
    return [(rng.normal(size=(n, DIM)) * 3).astype(np.float32) for n in (300, 300, 257, 400, 243)]


def _write_jax(out, dtype):
    w = JWriter(str(out), SHARD, quantize=dtype == "int8")
    for c in _chunks():
        w.add(c if dtype == "float32" else c.astype(ml_dtypes.bfloat16))
    return w.finish("mixed3a", np.float32 if dtype == "float32" else ml_dtypes.bfloat16)


def _write_torch(out, dtype):
    w = TWriter(str(out), SHARD, quantize=dtype == "int8")
    for c in _chunks():
        t = torch.from_numpy(c)
        w.add(t if dtype == "float32" else t.to(torch.bfloat16))
    return w.finish("mixed3a")


def _bits(a) -> np.ndarray:
    """Exact comparison form of a block: raw bits for bf16, values otherwise."""
    if isinstance(a, torch.Tensor):
        return a.view(torch.int16).numpy().view(np.uint16) if a.dtype == torch.bfloat16 \
            else a.numpy()
    a = np.asarray(a)
    return a.view(np.uint16) if a.dtype == ml_dtypes.bfloat16 else a


@pytest.mark.parametrize("dtype", DTYPES)
def test_port_writes_the_jax_bytes(tmp_path, dtype):
    jmeta = _write_jax(tmp_path / "jax", dtype)
    tmeta = _write_torch(tmp_path / "torch", dtype)
    assert tmeta == jmeta
    names = sorted(os.listdir(tmp_path / "jax"))
    assert names == sorted(os.listdir(tmp_path / "torch"))
    assert "meta.json" in names and len(names) > 3
    for n in names:
        assert (tmp_path / "jax" / n).read_bytes() == (tmp_path / "torch" / n).read_bytes(), n


@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("writer", ["jax", "torch"])
def test_each_reader_reads_the_other_writers_cache(tmp_path, dtype, writer):
    (_write_jax if writer == "jax" else _write_torch)(tmp_path, dtype)
    jc, tc = JCache(str(tmp_path)), TCache(str(tmp_path))
    assert tc.meta == jc.meta and tc.dim == jc.dim and tc.total_tokens == jc.total_tokens
    jblocks = list(jc.batches(64, shuffle=False, prefetch=False))
    tblocks = list(tc.batches(64, shuffle=False))
    assert len(jblocks) == len(tblocks) == jc.total_tokens // 64
    for a, b in zip(jblocks, tblocks):
        np.testing.assert_array_equal(_bits(b), _bits(a))
    expect = torch.bfloat16 if dtype == "bfloat16" else torch.float32
    assert tblocks[0].dtype == expect


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("tps,k", [(64, 4), (48, 3)])  # aligned and unaligned shards
@pytest.mark.parametrize("seed", [0, 5])
def test_shuffled_stacks_match_jax_order(tmp_path, dtype, tps, k, seed):
    _write_jax(tmp_path, dtype)
    jst = list(JCache(str(tmp_path)).stacks(tps, k, shuffle=True, seed=seed, prefetch=False))
    tst = list(TCache(str(tmp_path)).stacks(tps, k, shuffle=True, seed=seed))
    assert [s.shape[0] for s in tst] == [s.shape[0] for s in jst]
    for a, b in zip(jst, tst):
        assert tuple(b.shape) == a.shape
        np.testing.assert_array_equal(_bits(b), _bits(a))


def test_shuffled_batches_match_jax_order(tmp_path):
    _write_jax(tmp_path, "float32")
    jb = list(JCache(str(tmp_path)).batches(100, shuffle=True, seed=3, prefetch=False))
    tb = list(TCache(str(tmp_path)).batches(100, shuffle=True, seed=3))
    assert len(jb) == len(tb)
    for a, b in zip(jb, tb):
        np.testing.assert_array_equal(b.numpy(), a)


def test_empty_dump_raises(tmp_path):
    with pytest.raises(ValueError, match="ZERO batches"):
        TWriter(str(tmp_path), SHARD).finish("mixed3a")
