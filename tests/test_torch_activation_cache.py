"""Activation caches are byte-compatible between the JAX package and the port, in
both directions, for float32, bfloat16 and int8 shards; the port's reader
yields the same blocks in the same order as the JAX reader for the same seed;
the one-pass multi-layer dump writes the JAX package's bytes for every layer,
byte for byte what one-layer dumps write; and the zipped readers of such caches
(train/paired_caches.py) pair the same token rows, refusing caches of another
geometry. All comparisons are exact (bit patterns for bf16)."""

import os

import ml_dtypes
import numpy as np
import pytest
import torch

from sparse_vision_tpu.data.activation_cache import ActivationCache as JCache
from sparse_vision_tpu.data.activation_cache import _ShardWriter as JWriter
from sparse_vision_tpu.data.activation_cache import dump_activations_multi as j_dump_multi
from sparse_vision_tpu.data.datasets import make_synthetic as j_synth
from sparse_vision_tpu_torch.data.activation_cache import ActivationCache as TCache
from sparse_vision_tpu_torch.data.activation_cache import _ShardWriter as TWriter
from sparse_vision_tpu_torch.data.activation_cache import dump_activations as t_dump
from sparse_vision_tpu_torch.data.activation_cache import dump_activations_multi as t_dump_multi
from sparse_vision_tpu_torch.data.datasets import make_synthetic as t_synth

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


class _TwoStageNet:
    """A two-stage stand-in backbone whose taps are exact in f32 in both
    frameworks (a power-of-two scale and one sum), so the two dumps see the same
    activations: "a" [B, 8, 8, 3], "b" [B, 8, 8, 2] (deeper)."""

    stage_names = ("a", "b", "c")

    def index_of(self, name):
        return self.stage_names.index(name)

    def apply(self, params, x, state=None, stop_at=None):
        a = x * 2.0
        taps = {"a": a}
        if stop_at != "a":
            taps["b"] = a[..., :2] + a[..., 1:]
        if stop_at not in ("a", "b"):
            raise AssertionError("the dump must stop at the deepest requested layer")
        return a, taps, state


def _image_set(make):
    return make(num_samples=20, img_size=(8, 8, 3), num_classes=3, seed=0)


@pytest.mark.parametrize("dtype", DTYPES)
def test_multi_layer_dump_writes_the_jax_bytes(tmp_path, dtype):
    jdt = {"float32": np.float32, "bfloat16": ml_dtypes.bfloat16, "int8": "int8"}[dtype]
    layers = ["a", "b"]
    jdirs = {l: str(tmp_path / "jax" / l) for l in layers}
    tdirs = {l: str(tmp_path / "torch" / l) for l in layers}
    kw = dict(batch_size=4, shard_tokens=SHARD)
    jmetas = j_dump_multi(_TwoStageNet(), {}, None, _image_set(j_synth), layers, jdirs,
                          dtype=jdt, **kw)
    tmetas = t_dump_multi(_TwoStageNet(), {}, None, _image_set(t_synth), layers, tdirs,
                          dtype=dtype, device="cpu", **kw)
    assert tmetas == jmetas
    for l in layers:
        names = sorted(os.listdir(jdirs[l]))
        assert names == sorted(os.listdir(tdirs[l])) and len(names) > 2
        for n in names:
            assert (tmp_path / "jax" / l / n).read_bytes() == \
                (tmp_path / "torch" / l / n).read_bytes(), (l, n)


def test_multi_layer_dump_equals_one_layer_dumps(tmp_path):
    """The caches of one pass are the caches of separate passes: same shards,
    same meta, so their token rows pair up."""
    tdirs = {l: str(tmp_path / "multi" / l) for l in ("a", "b")}
    t_dump_multi(_TwoStageNet(), {}, None, _image_set(t_synth), ["b", "a"], tdirs,
                 batch_size=4, shard_tokens=SHARD, dtype="bfloat16", device="cpu")
    for l in ("a", "b"):
        t_dump(_TwoStageNet(), {}, None, _image_set(t_synth), l, str(tmp_path / l),
               batch_size=4, shard_tokens=SHARD, dtype="bfloat16", device="cpu")
        names = sorted(os.listdir(tdirs[l]))
        assert names == sorted(os.listdir(tmp_path / l))
        for n in names:
            assert (tmp_path / "multi" / l / n).read_bytes() == (tmp_path / l / n).read_bytes()


def test_zipped_shuffled_readers_pair_the_rows_of_one_pass(tmp_path):
    """train/paired_caches: the caches of one pass, read with one seed, give
    stacks whose rows are the same tokens in every layer (here "b" is a
    function of "a" row by row)."""
    from types import SimpleNamespace

    from sparse_vision_tpu_torch.train.paired_caches import epoch_stacks, open_validated

    dirs = {l: str(tmp_path / l) for l in ("a", "b")}
    t_dump_multi(_TwoStageNet(), {}, None, _image_set(t_synth), ["a", "b"], dirs,
                 batch_size=4, shard_tokens=SHARD, device="cpu")
    caches = open_validated(dirs, ("a", "b"))
    pipe = SimpleNamespace(cfg=SimpleNamespace(cache_tokens_per_step=48, seed=3),
                           CACHE_SCAN_K=3)
    pairs = list(epoch_stacks(pipe, caches, epoch=1))
    assert len(pairs) > 2
    for a, b in pairs:
        assert a.shape[:2] == b.shape[:2]
        torch.testing.assert_close(b, a[..., :2] + a[..., 1:], rtol=0, atol=0)
    # a different epoch shuffles differently, and the pairing still holds
    first = list(epoch_stacks(pipe, caches, epoch=2))[0]
    assert not torch.equal(first[0], pairs[0][0])


def test_open_validated_refuses_caches_of_another_geometry(tmp_path):
    from sparse_vision_tpu_torch.train.paired_caches import open_validated

    for layer, shard in (("a", SHARD), ("b", SHARD // 2)):
        t_dump(_TwoStageNet(), {}, None, _image_set(t_synth), layer, str(tmp_path / layer),
               batch_size=4, shard_tokens=shard, device="cpu")
    with pytest.raises(ValueError, match="shard_tokens differs"):
        open_validated({l: str(tmp_path / l) for l in ("a", "b")}, ("a", "b"))
