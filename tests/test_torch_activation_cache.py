"""Activation caches are byte-compatible between the JAX package and the port, in
both directions, for float32, bfloat16 and int8 shards; the port's reader
yields the same blocks in the same order as the JAX reader for the same seed;
the one-pass multi-layer dump writes the JAX package's bytes for every layer,
byte for byte what one-layer dumps write; and the zipped readers of such caches
(train/paired_caches.py) pair the same token rows, refusing caches of another
geometry. The host side of the cached path: the read-ahead and synchronous
engines yield the JAX blocks, an int8 cache read for device dequantization
yields the JAX int8 bytes and scales, stream_stacks (and its zip) over a queue
of published shard paths yields the JAX generators' blocks and forwards a
producer's error, the overlapped dump leaves the JAX bytes with no temp file,
and token_rms matches, recorded or computed lazily. All comparisons are exact
(bit patterns for bf16)."""

import json
import os
import queue
import threading
import time

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

    layers = ("a", "b")
    dirs = {l: str(tmp_path / l) for l in layers}
    t_dump_multi(_TwoStageNet(), {}, None, _image_set(t_synth), ["a", "b"], dirs,
                 batch_size=4, shard_tokens=SHARD, device="cpu")
    caches = open_validated(dirs, layers)
    pipe = SimpleNamespace(cfg=SimpleNamespace(cache_tokens_per_step=48, seed=3),
                           CACHE_SCAN_K=3)

    def stacks(epoch):
        it, got = epoch_stacks(pipe, layers, dirs, epoch, 0, None, None, caches)
        assert got is caches
        return list(it)

    pairs = stacks(1)
    assert len(pairs) > 2
    for a, b in pairs:
        assert a.shape[:2] == b.shape[:2]
        torch.testing.assert_close(b, a[..., :2] + a[..., 1:], rtol=0, atol=0)
    # a different epoch shuffles differently, and the pairing still holds
    first = stacks(2)[0]
    assert not torch.equal(first[0], pairs[0][0])


def test_open_validated_refuses_caches_of_another_geometry(tmp_path):
    from sparse_vision_tpu_torch.train.paired_caches import open_validated

    for layer, shard in (("a", SHARD), ("b", SHARD // 2)):
        t_dump(_TwoStageNet(), {}, None, _image_set(t_synth), layer, str(tmp_path / layer),
               batch_size=4, shard_tokens=shard, device="cpu")
    with pytest.raises(ValueError, match="shard_tokens differs"):
        open_validated({l: str(tmp_path / l) for l in ("a", "b")}, ("a", "b"))


# ---------------------------------------------------------------------------
# the host side of the cached path
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("engine", [False, True])  # synchronous, read-ahead thread
@pytest.mark.parametrize("tps,k", [(64, 4), (48, 3)])
def test_each_engine_yields_the_jax_blocks(tmp_path, dtype, engine, tps, k):
    _write_jax(tmp_path, dtype)
    jc, tc = JCache(str(tmp_path)), TCache(str(tmp_path))
    jst = list(jc.stacks(tps, k, shuffle=True, seed=4, prefetch=False))
    tst = list(tc.stacks(tps, k, shuffle=True, seed=4, prefetch=engine))
    jb = list(jc.batches(tps, shuffle=True, seed=4, prefetch=False))
    tb = list(tc.batches(tps, shuffle=True, seed=4, prefetch=engine))
    assert [tuple(s.shape) for s in tst] == [s.shape for s in jst]
    assert len(tb) == len(jb)
    for a, b in list(zip(jst, tst)) + list(zip(jb, tb)):
        np.testing.assert_array_equal(_bits(b), _bits(a))


@pytest.mark.parametrize("engine", [False, True])
def test_device_dequant_yields_the_jax_int8_bytes_and_scales(tmp_path, engine):
    _write_jax(tmp_path, "int8")
    jc, tc = JCache(str(tmp_path)), TCache(str(tmp_path))
    for jit, tit in (
            (jc.stacks(64, 4, shuffle=True, seed=1, prefetch=False, dequantize="device"),
             tc.stacks(64, 4, shuffle=True, seed=1, prefetch=engine, dequantize="device")),
            (jc.batches(64, shuffle=True, seed=1, prefetch=False, dequantize="device"),
             tc.batches(64, shuffle=True, seed=1, prefetch=engine, dequantize="device"))):
        jl, tl = list(jit), list(tit)
        assert len(tl) == len(jl) > 4
        for (jq, js), (tq, ts) in zip(jl, tl):
            assert tq.dtype == torch.int8 and ts.dtype == torch.float32
            np.testing.assert_array_equal(tq.numpy(), jq)
            np.testing.assert_array_equal(ts.numpy(), js)
    # a stack never spans shards: the short last shard's tail flushes alone
    assert {s.shape[0] for s, _ in tc.stacks(64, 4, dequantize="device")} == {4, 3}
    with pytest.raises(ValueError, match="dequantize='device'"):
        next(tc.stacks(48, 3, dequantize="device"))


def test_native_reader_is_not_ported(tmp_path):
    _write_jax(tmp_path, "float32")
    with pytest.raises(NotImplementedError, match="native"):
        next(TCache(str(tmp_path)).batches(64, prefetch="native"))


@pytest.mark.parametrize("break_mode", ["missing", "truncated"])
def test_read_ahead_raises_a_bad_shard_on_the_consumer(tmp_path, break_mode):
    _write_jax(tmp_path, "float32")
    victim = tmp_path / "acts_00001.npy"
    if break_mode == "missing":
        os.remove(victim)
    else:
        victim.write_bytes(victim.read_bytes()[:200])
    out = {}

    def run():
        try:
            for _ in TCache(str(tmp_path)).batches(64, prefetch=True):
                pass
        except BaseException as e:  # noqa: BLE001
            out["exc"] = e

    t = threading.Thread(target=run, daemon=True)
    t.start()
    t.join(30.0)
    assert not t.is_alive(), "the consumer hung on a bad shard"
    assert isinstance(out.get("exc"), (IOError, ValueError, EOFError))


def test_an_abandoned_reader_releases_its_thread(tmp_path):
    _write_jax(tmp_path, "float32")
    before = set(threading.enumerate())
    gen = TCache(str(tmp_path)).batches(64, prefetch=True)
    next(gen)
    gen.close()
    deadline = time.monotonic() + 5.0
    while time.monotonic() < deadline:
        leaked = [t for t in set(threading.enumerate()) - before if t.is_alive()]
        if not leaked:
            break
        time.sleep(0.05)
    assert not leaked, f"read-ahead thread leaked: {leaked}"


def _published(cache_dir, end=None) -> queue.Queue:
    """A queue holding the cache's shard paths, then ``end``."""
    q = queue.Queue()
    for i in range(json.loads((cache_dir / "meta.json").read_text())["num_shards"]):
        q.put(str(cache_dir / f"acts_{i:05d}.npy"))
    q.put(end)
    return q


@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("tps,k", [(64, 4), (48, 3)])
def test_stream_stacks_yields_the_jax_blocks(tmp_path, dtype, tps, k):
    from sparse_vision_tpu.data.activation_cache import stream_stacks as j_stream
    from sparse_vision_tpu.data.activation_cache import stream_stacks_zip as j_zip
    from sparse_vision_tpu_torch.data.activation_cache import stream_stacks, stream_stacks_zip

    _write_jax(tmp_path / "a", dtype)
    jst = list(j_stream(_published(tmp_path / "a"), tps, k, logical_dtype=dtype))
    tst = list(stream_stacks(_published(tmp_path / "a"), tps, k, logical_dtype=dtype))
    assert [tuple(s.shape) for s in tst] == [s.shape for s in jst]
    for a, b in zip(jst, tst):
        np.testing.assert_array_equal(_bits(b), _bits(a))
    _write_jax(tmp_path / "b", dtype)
    jz = list(j_zip([_published(tmp_path / d) for d in "ab"], tps, k, logical_dtype=dtype))
    tz = list(stream_stacks_zip([_published(tmp_path / d) for d in "ab"], tps, k,
                                logical_dtype=dtype))
    assert len(tz) == len(jz) == len(jst)
    for a, b in zip(jz, tz):
        for x, y in zip(a, b):
            np.testing.assert_array_equal(_bits(y), _bits(x))


def test_stream_stacks_forwards_a_producer_error(tmp_path):
    from sparse_vision_tpu_torch.data.activation_cache import stream_stacks

    _write_jax(tmp_path, "float32")
    got = []
    with pytest.raises(OSError, match="disk full"):
        for s in stream_stacks(_published(tmp_path, OSError("disk full")), 64, 4):
            got.append(s)
    assert len(got) == 5  # every published shard was streamed first


@pytest.mark.parametrize("dtype", DTYPES)
def test_overlapped_dump_leaves_the_jax_bytes(tmp_path, dtype):
    from sparse_vision_tpu_torch.data.activation_cache import overlapped_multi_dump

    jdt = {"float32": np.float32, "bfloat16": ml_dtypes.bfloat16, "int8": "int8"}[dtype]
    layers = ["a", "b"]
    jdirs = {l: str(tmp_path / "jax" / l) for l in layers}
    tdirs = {l: str(tmp_path / "torch" / l) for l in layers}
    kw = dict(batch_size=4, shard_tokens=SHARD)
    j_dump_multi(_TwoStageNet(), {}, None, _image_set(j_synth), layers, jdirs, dtype=jdt, **kw)
    qs, thread = overlapped_multi_dump(_TwoStageNet(), {}, None, _image_set(t_synth), layers,
                                       tdirs, dtype=dtype, device="cpu", **kw)
    for l in layers:
        paths = []
        while (item := qs[l].get(timeout=60)) is not None:
            assert os.path.exists(item)  # published: complete, and its scales first
            paths.append(item)
        assert len(paths) == len([n for n in os.listdir(jdirs[l]) if n.startswith("acts_")])
    thread.join(60)
    assert not thread.is_alive()
    for l in layers:
        names = sorted(os.listdir(jdirs[l]))
        assert names == sorted(os.listdir(tdirs[l])) and not any(".tmp" in n for n in names)
        for n in names:
            assert (tmp_path / "jax" / l / n).read_bytes() == \
                (tmp_path / "torch" / l / n).read_bytes(), (l, n)


def test_overlapped_dump_forwards_its_error_to_every_queue(tmp_path):
    from sparse_vision_tpu_torch.data.activation_cache import overlapped_multi_dump

    class Broken(_TwoStageNet):
        def apply(self, *a, **kw):
            raise RuntimeError("backbone failed")

    qs, thread = overlapped_multi_dump(Broken(), {}, None, _image_set(t_synth), ["a", "b"],
                                       {l: str(tmp_path / l) for l in "ab"}, batch_size=4,
                                       shard_tokens=SHARD, device="cpu")
    for q in qs.values():
        assert isinstance(q.get(timeout=60), RuntimeError)
    thread.join(60)


@pytest.mark.parametrize("dtype", DTYPES)
def test_token_rms_matches_recorded_and_lazily(tmp_path, dtype):
    _write_jax(tmp_path / "jax", dtype)
    _write_torch(tmp_path / "torch", dtype)
    recorded = JCache(str(tmp_path / "jax")).token_rms
    assert TCache(str(tmp_path / "torch")).token_rms == recorded
    for d in ("jax", "torch"):  # a cache written before the field existed
        mp = tmp_path / d / "meta.json"
        meta = json.loads(mp.read_text())
        del meta["token_rms"]
        mp.write_text(json.dumps(meta))
    lazy = JCache(str(tmp_path / "jax")).token_rms
    assert TCache(str(tmp_path / "torch")).token_rms == lazy != recorded
    # persisted back, as the JAX reader does
    assert json.loads((tmp_path / "torch" / "meta.json").read_text())["token_rms"] == lazy
