"""The port's prefetch (sparse_vision_tpu_torch/data/prefetch.py) against the JAX
package's (sparse_vision_tpu/data/prefetch.py) on the CPU: the same batches in
the same order with the same values (exact), a producer error re-raised on the
consumer within seconds, and an abandoned generator releasing its thread (the
stop-event contract of tests/test_activation_cache.py:78-96). The CUDA staging
(pinned buffers, side stream, events) runs only on the card: chip_smoke.py's
cache phase holds every staged stack bitwise to a synchronous copy."""

import threading
import time

import numpy as np
import pytest
import torch

from sparse_vision_tpu.data.datasets import make_synthetic as j_synth
from sparse_vision_tpu.data.prefetch import prefetch as j_prefetch
from sparse_vision_tpu_torch.data.datasets import Batch
from sparse_vision_tpu_torch.data.datasets import make_synthetic as t_synth
from sparse_vision_tpu_torch.data.prefetch import device_put_batch, prefetch


def _sets():
    kw = dict(num_samples=40, img_size=(8, 8, 3), num_classes=5, seed=2)
    return j_synth(**kw), t_synth(**kw)


@pytest.mark.parametrize("shuffle", [False, True])
@pytest.mark.parametrize("buffer_size", [1, 2])
def test_batches_match_the_jax_prefetch(shuffle, buffer_size):
    jds, tds = _sets()
    jb = list(j_prefetch(jds.batches(8, shuffle=shuffle, seed=5), buffer_size=buffer_size))
    tb = list(prefetch(tds.batches(8, shuffle=shuffle, seed=5), "cpu", buffer_size))
    assert len(tb) == len(jb) == 5
    for a, b in zip(jb, tb):
        assert isinstance(b, Batch) and isinstance(b.images, torch.Tensor)
        np.testing.assert_array_equal(b.images.numpy(), np.asarray(a.images))
        np.testing.assert_array_equal(b.labels.numpy(), np.asarray(a.labels))


def test_tuples_and_other_leaves_pass_through():
    """A dispatch of run_epochs: a tuple of stacks and a scale or None."""
    items = [((torch.arange(6.0).reshape(2, 3),), None),
             ((torch.ones(2, 3, dtype=torch.int8),), np.full(3, 0.5, np.float32))]
    got = list(prefetch(iter(items), "cpu"))
    assert got[0][1] is None and torch.equal(got[0][0][0], items[0][0][0])
    assert got[1][0][0].dtype == torch.int8
    np.testing.assert_array_equal(got[1][1].numpy(), items[1][1])
    assert device_put_batch(items[1], "cpu")[1].dtype == torch.float32


def _consume(gen, timeout=30.0):
    """Drain gen on a worker thread: (finished, items, exception)."""
    out = {"done": False, "items": [], "exc": None}

    def run():
        try:
            for b in gen:
                out["items"].append(b)
        except BaseException as e:  # noqa: BLE001
            out["exc"] = e
        out["done"] = True

    t = threading.Thread(target=run, daemon=True)
    t.start()
    t.join(timeout)
    return out["done"], out["items"], out["exc"]


@pytest.mark.parametrize("impl", ["jax", "torch"])
def test_a_producer_error_is_raised_on_the_consumer(impl):
    jds, tds = _sets()

    def failing(ds):
        for i, b in enumerate(ds.batches(8, shuffle=False)):
            if i == 2:
                raise OSError("decode failed")
            yield b

    gen = (j_prefetch(failing(jds)) if impl == "jax" else prefetch(failing(tds), "cpu"))
    done, items, exc = _consume(gen)
    assert done, "the consumer hung on a producer error"
    assert len(items) == 2 and isinstance(exc, OSError) and "decode failed" in str(exc)


def test_an_abandoned_generator_releases_its_thread():
    _, tds = _sets()
    before = set(threading.enumerate())
    gen = prefetch(tds.batches(4, shuffle=False), "cpu", buffer_size=1)
    next(gen)  # the producer is running, parked on the full queue
    gen.close()
    deadline = time.monotonic() + 5.0
    while time.monotonic() < deadline:
        leaked = [t for t in set(threading.enumerate()) - before if t.is_alive()]
        if not leaked:
            break
        time.sleep(0.05)
    assert not leaked, f"producer thread leaked: {leaked}"


def test_the_default_device_raises_without_a_gpu(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        next(prefetch(iter([torch.zeros(1)])))
