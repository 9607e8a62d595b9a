"""Resume, held against the JAX package, at tests/test_torch_pipeline.py's small
config (32 px, 64 / 32 images, 8 steps of 128 tokens an epoch, CACHE_SCAN_K 2)
for sae_mlp, gated_sae, the transcoder and the crosscoder.

Each package trains one epoch (checkpoint ``epoch_1``), then a fresh Pipeline
resumes from it to epoch 2 (``sae_checkpoint_epoch=1, sae_epochs=2``). The
port's resumed run is held to JAX's resumed run on its final params, its last
eval's means, the results CSV's rows of epochs 1 and 2 and the epoch-2
``filename_indices`` file, under test_torch_pipeline.py's tolerances (params
rtol 2e-3 / atol 2e-5, means rtol 1e-4, indices exact); and it is
``torch.equal`` to the port's uninterrupted two-epoch run from the same cache
bytes. A third port run resumes from JAX's own Orbax checkpoint of epoch 1,
read here and carried over with convert.checkpoint_from_jax, and is held to
JAX's resumed run the same way. No resample fires (dead_neurons_steps 1000), so
the generator, which neither package checkpoints, plays no part. These runs
live in a file of their own so that they and test_torch_pipeline.py's runs
can go to two workers.
"""

import os
import shutil

import jax
import numpy as np
import pytest
import torch

from sparse_vision_tpu.config import RunConfig as JConfig
from sparse_vision_tpu.data.datasets import make_synthetic as j_synth
from sparse_vision_tpu.eval_tools import results as jres
from sparse_vision_tpu.train import checkpoint as jckpt
from sparse_vision_tpu.train.pipeline import Pipeline as JPipeline
from sparse_vision_tpu_torch import convert
from sparse_vision_tpu_torch.config import RunConfig as TConfig
from sparse_vision_tpu_torch.data.datasets import make_synthetic as t_synth
from sparse_vision_tpu_torch.eval_tools import results as tres
from sparse_vision_tpu_torch.train import checkpoint as tckpt
from sparse_vision_tpu_torch.train.pipeline import Pipeline as TPipeline
from sparse_vision_tpu_torch.utils.paths import folder_paths, sae_run_name
from test_torch_pipeline import CFG, VARIANTS, _check_means, _datasets, _Recorder, _run_both

RESUMED = ("sae_mlp", "gated_sae", "transcoder", "crosscoder")


def _port(cfg: dict, directory: str, backbone, sae=None, caches_from=None):
    """A port Pipeline on ``cfg`` in ``directory`` (CACHE_SCAN_K 2), with a copy
    of the activation caches of the Pipeline ``caches_from`` when given."""
    tcfg = TConfig(**cfg, directory_path=directory)
    if caches_from is not None:
        shutil.copytree(
            os.path.join(caches_from.paths["evaluation_results"], "activation_cache"),
            os.path.join(folder_paths(tcfg)["evaluation_results"], "activation_cache"))
    pipe = TPipeline(tcfg, device="cpu", datasets=_datasets(t_synth), backbone=backbone,
                     sae_params=sae)
    pipe.CACHE_SCAN_K = 2
    return pipe


@pytest.fixture(scope="module", params=RESUMED)
def resumed(request, tmp_path_factory):
    """The first epoch of each package (j1, t1), JAX's and the port's resumed
    runs (j2, t2), the port's uninterrupted run (tu) and the port's run resumed
    from JAX's checkpoint (tj), with each run's last means."""
    name = request.param
    cfg = {**CFG, "sae_model_name": name, **VARIANTS[name]}
    j1, _, _, t1, _ = _run_both(cfg, tmp_path_factory)
    backbone = convert.backbone_from_jax(jax.device_get(j1.frozen_params),
                                         jax.device_get(j1.net_state))
    two = {**cfg, "sae_epochs": 2}
    resume = {**two, "sae_checkpoint_epoch": 1}

    j2 = JPipeline(JConfig(**resume, directory_path=j1.cfg.directory_path),
                   logger=_Recorder(), datasets=_datasets(j_synth))
    j2.CACHE_SCAN_K = 2
    assert int(j2.ts.step) == 8
    runs = {"j1": j1, "t1": t1, "j2": j2, "j2_means": j2.train_sae()}

    t2 = _port(resume, t1.cfg.directory_path, backbone)
    assert t2.ts.step == 8
    runs.update(t2=t2, t2_means=t2.train_sae())

    sae0 = {k: v.clone() for k, v in t1.sae_params.items()}  # both runs' init (JAX's)
    tu = _port(two, str(tmp_path_factory.mktemp("uninterrupted")), backbone, sae=sae0,
               caches_from=t1)
    runs.update(tu=tu, tu_means=tu.train_sae())

    tj_dir = str(tmp_path_factory.mktemp("from_jax"))
    tree = convert.checkpoint_from_jax(jckpt.load_checkpoint(j1._sae_ckpt_dir(), 1))
    tcfg = TConfig(**resume, directory_path=tj_dir)
    tckpt.save_checkpoint(os.path.join(folder_paths(tcfg)["checkpoints"], sae_run_name(tcfg)),
                          1, tree)
    tj = _port(resume, tj_dir, backbone, caches_from=t1)
    runs.update(tj=tj, tj_means=tj.train_sae())
    return runs


def _check_params(tpipe, jpipe):
    assert tpipe.ts.step == int(jpipe.ts.step) == 16
    for k, v in jpipe.ts.params.items():
        np.testing.assert_allclose(tpipe.ts.params[k].numpy(), np.asarray(v), rtol=2e-3,
                                   atol=2e-5, err_msg=k)


def _means(runs, t, j):
    return (None, None, runs[f"{j}_means"], None, runs[f"{t}_means"])


def test_resumed_run_matches_the_jax_resumed_run(resumed):
    _check_params(resumed["t2"], resumed["j2"])
    _check_means(_means(resumed, "t2", "j2"))
    # the resumed Adam state and dead accumulator came from the checkpoint
    t2, j2 = resumed["t2"], resumed["j2"]
    assert t2.ts.opt_state["count"] == 16
    np.testing.assert_array_equal(t2.ts.dead_acc.numpy(), np.asarray(j2.ts.dead_acc))


def test_resumed_run_is_torch_equal_to_the_uninterrupted_run(resumed):
    t2, tu = resumed["t2"], resumed["tu"]
    assert t2.ts.step == tu.ts.step == 16
    for k in tu.ts.params:
        assert torch.equal(t2.ts.params[k], tu.ts.params[k]), k
        for m in ("mu", "nu"):
            assert torch.equal(t2.ts.opt_state[m][k], tu.ts.opt_state[m][k]), (m, k)
    assert t2.ts.opt_state["count"] == tu.ts.opt_state["count"]
    assert torch.equal(t2.ts.dead_acc, tu.ts.dead_acc)
    assert resumed["t2_means"] == resumed["tu_means"]
    # the second epoch's steps, loss by loss
    tail = {s: m for s, m in tu.train_log if s > 8}
    assert [s for s, _ in t2.train_log] == list(range(9, 17)) == sorted(tail)
    for s, m in t2.train_log:
        assert {k: float(v) for k, v in m.items()} == {k: float(v) for k, v in tail[s].items()}


def test_resumed_results_rows_match_jax(resumed):
    t2, j2 = resumed["t2"], resumed["j2"]
    folder = t2.paths["evaluation_results"]
    trows = tres.read_results(os.path.join(folder, "sae_eval_results.csv"))
    jrows = jres.read_results(os.path.join(j2.paths["evaluation_results"],
                                           "sae_eval_results.csv"))
    assert [r["epochs"] for r in trows] == [r["epochs"] for r in jrows] == [1.0, 2.0]
    assert sorted(f for f in os.listdir(folder) if f.endswith(".json")) == [
        f"{t2.run_id}_epoch_{e}.json" for e in (1, 2)]
    for tr, jr in zip(trows, jrows):
        assert set(tr) == set(jr)
        for k, jv in jr.items():
            if isinstance(jv, str) or jv is None or k in ("perc_dead_units", "epochs"):
                assert tr[k] == jv, k
            elif k == "loss_diff":
                np.testing.assert_allclose(tr[k], jv, atol=1e-5, err_msg=k)
            else:
                np.testing.assert_allclose(tr[k], jv, rtol=1e-4, atol=1e-7, err_msg=k)
    # the epoch-2 row is the last eval
    assert trows[1]["rec_loss"] == pytest.approx(resumed["t2_means"]["sae_rec_loss"],
                                                 rel=1e-6)


def _ranked_values(pipe, as_input) -> np.ndarray:
    """[N, U]: every validation sample's channel-averaged activation under the
    run's final params, the values its top-k files rank (a sample's filename
    index is its position here)."""
    bs = pipe.cfg.eval_batch_size or pipe._auto_eval_batch_size()
    acts = [np.asarray(pipe._sae_eval_step_fn(pipe.ts.params, pipe.frozen_params,
                                              pipe.net_state, as_input(b.images),
                                              as_input(b.labels))[1]["topk_acts"])
            for b in pipe.val_ds.batches(bs, shuffle=False)]
    return np.concatenate(acts)


# at most this share of the top-k files' entries may differ from JAX's
SWAP_SHARE = 1e-3


def test_resumed_filename_indices_match_jax(resumed):
    """Dead units exact, activity frequencies to 1e-6, and the top-k indices
    exact but for swaps of samples whose activations the two runs order
    differently: the runs' final weights differ within the params tolerance,
    which can switch a latent (a gated SAE's gate) on or off for a token of a
    sample. Each swap must be of two samples that JAX's values put no further
    apart than twice the largest difference between the two runs' values
    (itself under 1% of the largest value), and swaps must be rarer than
    SWAP_SHARE (2 of 12,800 entries for gated_sae, none for the others,
    measured).

    The two gated_sae entries, traced (same seed, CPU): latent 225's gate
    pre-activation on token 12 of validation sample 25 is +1.85e-7 under the
    port's final weights and -4.00e-7 under JAX's, so the port's gate opens
    there (code 7.9e-3) and JAX's stays shut. Over the sample's 16 tokens
    that lifts its mean from JAX's 5.4372e-3 to 5.9316e-3, past sample 29
    (5.5010e-3 in both runs), and the two trade ranks 4 and 5 of the unit's
    bottom-k. That one token is the largest value drift (4.94e-4 of a 0.101
    maximum), and no other gate differs on the two samples."""
    t2, j2 = resumed["t2"], resumed["j2"]
    assert t2.run_id == j2.run_id

    def load(pipe):
        path = os.path.join(pipe.paths["evaluation_results"], "filename_indices",
                            f"{pipe.run_id}_epoch_2.npz")
        with np.load(path) as z:
            return {k: z[k] for k in z.files}

    got, want = load(t2), load(j2)
    assert set(got) == set(want) == {"max_filename_indices", "min_filename_indices",
                                     "dead_units", "activity_freq"}
    for k in got:
        assert got[k].dtype == want[k].dtype and got[k].shape == want[k].shape, k
    assert got["max_filename_indices"].shape == (25, t2.num_units)
    np.testing.assert_array_equal(got["dead_units"], want["dead_units"])
    np.testing.assert_allclose(got["activity_freq"], want["activity_freq"], atol=1e-6)
    vt = _ranked_values(t2, torch.from_numpy)
    vj = _ranked_values(j2, jax.numpy.asarray)
    drift = float(np.abs(vt - vj).max())
    assert drift <= 1e-2 * np.abs(vj).max()  # 5e-3 of it for gated_sae, measured
    for k in ("max_filename_indices", "min_filename_indices"):
        rows, units = np.nonzero(got[k] != want[k])
        assert len(rows) <= SWAP_SHARE * got[k].size, (k, len(rows))
        gap = np.abs(vj[got[k][rows, units], units] - vj[want[k][rows, units], units])
        assert np.all(gap <= 2 * drift), (k, gap.max(), drift)


def test_the_port_resumes_from_the_jax_packages_checkpoint(resumed):
    _check_params(resumed["tj"], resumed["j2"])
    _check_means(_means(resumed, "tj", "j2"))
