"""utils/profiling.py against the JAX package's utils/profiling.py, and
``profile_dir`` through Pipeline.run: one torch.profiler trace (Chrome-trace
JSON) per training epoch, of the epoch's steps only, and a run's results
bitwise equal with and without it (tracing observes; it changes nothing).
Small: custom_cnn_1 on 28 px single-channel stand-in images, as
tests/test_torch_e2e_finetune.py.
"""

import glob
import json
import os

import numpy as np
import pytest
import torch

from sparse_vision_tpu.utils import profiling as j_prof
from sparse_vision_tpu_torch.config import RunConfig as TConfig
from sparse_vision_tpu_torch.data.datasets import make_synthetic as t_synth
from sparse_vision_tpu_torch.train.pipeline import Pipeline as TPipeline
from sparse_vision_tpu_torch.utils import profiling as t_prof

SIZE = (28, 28, 1)
CFG = dict(model_name="custom_cnn_1", dataset_name="mnist", sae_layer="conv2",
           sae_model_name="sae_mlp", sae_expansion_factor=2, sae_lambda_sparse=0.5,
           sae_optimizer_name="constrained_adam", sae_learning_rate=1e-3, sae_batch_size=16,
           use_activation_cache=True, cache_tokens_per_step=784, cache_dtype="float32",
           compute_dtype="float32", sae_epochs=2, dead_neurons_steps=1000, seed=3,
           log_every=10**9)


@pytest.fixture(scope="module", autouse=True)
def one_torch_thread():
    """Small passes: one intra-op thread is as fast alone and much faster when
    the test workers oversubscribe the cores."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _datasets():
    tr = t_synth(num_samples=64, img_size=SIZE, num_classes=10, seed=3)
    va = t_synth(num_samples=32, img_size=SIZE, num_classes=10, seed=4)
    return tr, va, tr.category_names, SIZE


def _run(folder, **kw):
    pipe = TPipeline(TConfig(**{**CFG, **kw}, directory_path=str(folder)), device="cpu",
                     datasets=_datasets())
    return pipe, pipe.run()


def _traces(folder) -> list:
    return sorted(glob.glob(os.path.join(str(folder), "*.json")))


def test_profile_dir_writes_one_trace_per_epoch_and_changes_nothing(tmp_path):
    plain, plain_means = _run(tmp_path / "plain")
    traced, traced_means = _run(tmp_path / "traced", profile_dir=str(tmp_path / "traces"))
    paths = _traces(tmp_path / "traces")
    assert [os.path.basename(p).split("_epoch_")[1].split("_")[0] for p in paths] == ["0", "1"]
    for p in paths:
        with open(p) as f:
            events = json.load(f)["traceEvents"]
        names = {e.get("name", "") for e in events}
        # the cached steps' products are in the trace; the evals' (and the
        # dump's) backbone convolutions are not
        assert any(n.split("::")[-1] in ("mm", "addmm") for n in names), sorted(names)[:20]
        assert not any("conv" in n for n in names)
    assert [t["profiled"] for t in traced.train_timing] == [True, True]
    assert [t["profiled"] for t in plain.train_timing] == [False, False]
    assert traced_means == plain_means
    assert [e for e, _ in traced.eval_log] == [e for e, _ in plain.eval_log]
    for (_, a), (_, b) in zip(traced.train_log, plain.train_log):
        assert {k: float(v) for k, v in a.items()} == {k: float(v) for k, v in b.items()}
    for k, v in plain.ts.params.items():
        assert torch.equal(traced.ts.params[k], v), k


def test_original_model_epochs_are_traced(tmp_path):
    pipe, _ = _run(tmp_path / "run", original_model=True, sae_model_name="None",
                   sae_layer="None", model_epochs=1, batch_size=32,
                   profile_dir=str(tmp_path / "traces"))
    assert len(_traces(tmp_path / "traces")) == 1
    assert [t["profiled"] for t in pipe.train_timing] == [True]


def test_maybe_profile_is_a_no_op_without_a_directory(tmp_path):
    with t_prof.maybe_profile("", "cpu") as prof:
        assert prof is None
    with t_prof.maybe_profile(None) as prof:
        assert prof is None
    with t_prof.maybe_profile(str(tmp_path), "cpu", name="region") as prof:
        torch.ones(8) @ torch.ones(8)
    (path,) = _traces(tmp_path)
    assert os.path.basename(path).startswith("region_")
    with open(path) as f:
        assert "traceEvents" in json.load(f)


def test_cuda_tracing_without_cupti_raises(tmp_path, monkeypatch):
    """A CUDA device on a build whose profiler cannot trace CUDA raises, rather
    than write a trace without the device."""
    from torch.profiler import ProfilerActivity

    monkeypatch.setattr(torch.profiler, "supported_activities",
                        lambda: {ProfilerActivity.CPU})
    with pytest.raises(RuntimeError, match="CUPTI"):
        with t_prof.maybe_profile(str(tmp_path), "cuda"):
            pass
    assert _traces(tmp_path) == []


def test_timeit_device_keys_match_jax():
    def fn(x):
        return {"y": x * 2.0}

    got = t_prof.timeit_device(fn, torch.ones(4), iters=3, trials=3)
    want = j_prof.timeit_device(lambda x: {"y": x * 2.0}, np.ones(4, np.float32), iters=3,
                                trials=3)
    assert set(got) == set(want) == {"median_s", "min_s", "all_s"}
    assert len(got["all_s"]) == len(want["all_s"]) == 3
    assert got["all_s"] == sorted(got["all_s"]) and got["min_s"] == got["all_s"][0]
    assert got["median_s"] == got["all_s"][1]
