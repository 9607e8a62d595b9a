"""The port's checkpoints (sparse_vision_tpu_torch/train/checkpoint.py): the JAX
package's tree and epoch naming in torch files that load with
weights_only=True; the asynchronous save snapshots the state on the calling
thread, and a half-written file is never visible under an epoch's name."""

import os
import threading

import numpy as np
import pytest
import torch

from sparse_vision_tpu_torch.train import checkpoint as ckpt


def _tree(seed=0, h=64, d=16):
    g = torch.Generator().manual_seed(seed)
    params = {"W_enc": torch.randn(d, h, generator=g), "b_enc": torch.randn(h, generator=g),
              "W_dec": torch.randn(h, d, generator=g), "b_dec": torch.randn(d, generator=g)}
    return {"params": params,
            "opt_state": {"mu": {k: v * 0.5 for k, v in params.items()},
                          "nu": {k: v * v for k, v in params.items()}, "count": 7},
            "step": 7, "dead_acc": torch.arange(h) % 3 == 0}


def _assert_equal(a, b):
    if isinstance(a, dict):
        assert set(a) == set(b)
        for k in a:
            _assert_equal(a[k], b[k])
    elif isinstance(a, torch.Tensor):
        assert a.dtype == b.dtype and torch.equal(a, b)
    else:
        assert type(a) is type(b) is int and a == b


def test_round_trip_keeps_values_dtypes_and_ints(tmp_path):
    tree = _tree()
    path = ckpt.save_checkpoint(str(tmp_path / "ck"), 3, tree)
    assert path == str(tmp_path / "ck" / "epoch_3")
    got = ckpt.load_checkpoint(str(tmp_path / "ck"), 3, like=tree)
    _assert_equal(got, tree)
    assert got["dead_acc"].dtype == torch.bool
    # the file is plain weights: it loads with weights_only=True
    raw = torch.load(path, map_location="cpu", weights_only=True)
    _assert_equal(raw, tree)


def test_load_refuses_a_tree_unlike_the_template(tmp_path):
    ckpt.save_checkpoint(str(tmp_path), 1, _tree())
    wrong = _tree(h=32)
    with pytest.raises(ValueError, match="W_enc"):
        ckpt.load_checkpoint(str(tmp_path), 1, like=wrong)
    missing = _tree()
    del missing["dead_acc"]
    with pytest.raises(ValueError, match="keys"):
        ckpt.load_checkpoint(str(tmp_path), 1, like=missing)


def test_save_refuses_leaves_that_are_not_tensors_or_ints(tmp_path):
    for leaf in (np.int32(3), np.float32(1.0), torch.Generator(), True):
        with pytest.raises(TypeError):
            ckpt.save_checkpoint(str(tmp_path), 1, {"step": leaf})


def test_latest_epoch(tmp_path):
    d = str(tmp_path / "ck")
    assert ckpt.latest_epoch(d) is None
    os.makedirs(d)
    assert ckpt.latest_epoch(d) is None
    for e in (1, 10, 2):
        ckpt.save_checkpoint(d, e, {"step": e})
    open(os.path.join(d, "epoch_x"), "w").close()
    open(os.path.join(d, ".epoch_11.tmp1"), "w").close()
    assert ckpt.latest_epoch(d) == 10


def test_async_save_snapshots_at_the_call_and_lands_after_wait(tmp_path, monkeypatch):
    d = str(tmp_path / "ck")
    tree = _tree()
    want = {"params": {k: v.clone() for k, v in tree["params"].items()}}
    gate, seen = threading.Event(), []
    real_save = torch.save

    def slow_save(obj, f, *a, **kw):  # hold the writer until the test lets it go
        assert gate.wait(30)
        seen.append(sorted(os.listdir(d)))
        return real_save(obj, f, *a, **kw)

    monkeypatch.setattr(torch, "save", slow_save)
    path = ckpt.save_checkpoint(d, 1, {"params": tree["params"]}, blocking=False)
    for v in tree["params"].values():  # the next epoch's in-place updates
        v.add_(1.0)
    assert not os.path.exists(path)  # nothing under the epoch's name before the write
    assert ckpt.latest_epoch(d) is None
    gate.set()
    ckpt.wait_for_saves()
    assert seen == [[]]
    assert os.listdir(d) == ["epoch_1"]  # the temporary file was replaced
    _assert_equal(ckpt.load_checkpoint(d, 1), want)


def test_wait_for_saves_raises_a_failed_write(tmp_path, monkeypatch):
    def broken(*a, **kw):
        raise OSError("disk full")

    monkeypatch.setattr(torch, "save", broken)
    ckpt.save_checkpoint(str(tmp_path), 1, {"step": 1}, blocking=False)
    with pytest.raises(OSError, match="disk full"):
        ckpt.wait_for_saves()
    assert ckpt.latest_epoch(str(tmp_path)) is None
    ckpt.wait_for_saves()  # reported once
