"""The port's MIS (interp/mis.py, Pipeline.mis_epoch and the mis modes of
Pipeline.run) against the JAX package's.

- Task construction and scoring on numpy inputs: make_fair_batches,
  build_unit_tasks, score_task and prepare_machine_interpretability_score
  equal JAX's; compute_mis with any similarity callable equals JAX's exactly;
  with the default embedding similarity (float64 unit-norm embeddings, tasks
  gathered and reduced for many units at once) every task decision equals
  JAX's pair-by-pair f32 cosines (measured: 0 of 1,280 tasks differ; the
  bound, MAX_TASK_FLIPS, is for means that tie within f32 rounding).
- mis="1" then mis="2" through both packages' Pipeline.run on one trained
  layer: mixed3a at 32 px, 256 latents, 256 train images (MIS needs 200
  distinct samples a side), trained in both packages from the same initial
  weights, then both evaluated on JAX's trained weights (its epoch-1
  checkpoint, carried into the port's run folder with
  convert.checkpoint_from_jax), so the comparison holds the MIS path alone.
  The top-k files agree but for swaps of samples whose channel means the two
  frameworks order differently (at most MAX_SWAP_SHARE of the entries;
  measured 2 and 4 of 51,200: the frameworks' f32 convolutions differ by ~1e-6
  relative); the per-unit CSV agrees on every unit whose samples agree but
  where the embeddings, which differ by the same rounding, move a near-tie
  decision (at most MAX_UNIT_FLIPS units; measured 2 of the 254 units whose
  samples agree); median_mis within one step of 1/20 (measured equal); the
  rest of the results row as tests/test_torch_pipeline.py's eval means (rtol
  1e-4).
- mis_distribution_check and load_reference_mis_stats on the port's own copy
  of the asset equal JAX's.
"""

import csv
import json
import os

import jax
import numpy as np
import pytest
import torch

from sparse_vision_tpu.config import RunConfig as JConfig
from sparse_vision_tpu.data.datasets import make_synthetic as j_synth
from sparse_vision_tpu.interp import mis as jmis
from sparse_vision_tpu.train import checkpoint as j_ckpt
from sparse_vision_tpu.train.pipeline import Pipeline as JPipeline
from sparse_vision_tpu_torch import cli, convert
from sparse_vision_tpu_torch.config import RunConfig as TConfig
from sparse_vision_tpu_torch.data.datasets import fetch_images_batches
from sparse_vision_tpu_torch.data.datasets import make_synthetic as t_synth
from sparse_vision_tpu_torch.interp import mis as tmis
from sparse_vision_tpu_torch.train import checkpoint as t_ckpt
from sparse_vision_tpu_torch.train import pipeline as t_pipeline
from sparse_vision_tpu_torch.train.pipeline import Pipeline as TPipeline
from test_torch_pipeline import quick_jax_pipeline

SIZE = (32, 32, 3)
MAX_TASK_FLIPS = 2  # of the synthetic case's 1,280 tasks
MAX_SWAP_SHARE = 1e-3  # top-k entries that may differ between the frameworks
MAX_UNIT_FLIPS = 4  # units (of 256) whose MIS may differ with equal samples


@pytest.fixture(scope="module", autouse=True)
def one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


# ---------------------------------------------------------------------------
# task construction and scoring
# ---------------------------------------------------------------------------

def test_task_construction_equals_jax():
    items = list(range(37))
    for n in (1, 4, 5):
        for rev in (False, True):
            assert tmis.make_fair_batches(items, n, rev) == jmis.make_fair_batches(items, n, rev)
    rng = np.random.default_rng(0)
    mx, mn = rng.permutation(500)[:200].tolist(), rng.permutation(500)[:200].tolist()
    tasks = tmis.build_unit_tasks(mx, mn, 20)
    assert tasks == jmis.build_unit_tasks(mx, mn, 20)
    assert len(tasks) == 20 and all(len(t) == 20 for t in tasks)
    assert [t[9] for t in tasks] == mn[-20:] and [t[-1] for t in tasks] == mx[:20]
    emb = {i: rng.normal(size=8) for i in range(500)}
    sim = jmis.embedding_similarity(emb)
    for t in tasks:
        assert tmis.score_task(t, sim) == jmis.score_task(t, sim)
    assert (tmis.prepare_machine_interpretability_score(sim)(tasks, True)
            == jmis.prepare_machine_interpretability_score(sim)(tasks, True))


def _synthetic(units=64, samples=300, k=200, dim=32, seed=1):
    """Per-unit max/min index columns (overlapping, as on a small dataset) and
    f32 embeddings with a unit-dependent structure, so tasks are neither all
    solved nor all failed."""
    rng = np.random.default_rng(seed)
    emb = rng.normal(size=(samples, dim)).astype(np.float32)
    acts = emb @ rng.normal(size=(dim, units)).astype(np.float32) \
        + rng.normal(size=(samples, units)).astype(np.float32)
    order = np.argsort(-acts, axis=0, kind="stable")
    return order[:k], order[::-1][:k], {i: emb[i] for i in range(samples)}


def test_compute_mis_equals_jax(tmp_path):
    """The per-unit rows, the summary and the CSV: exactly JAX's with a plain
    similarity callable; with the default embedding similarity every task
    decision is JAX's, counted (MAX_TASK_FLIPS)."""
    mx, mn, emb = _synthetic()
    names = {i: i for i in emb}
    jsim = jmis.embedding_similarity(emb)
    want = jmis.compute_mis(mx, mn, names, 20, jsim, out_csv=str(tmp_path / "j" / "m.csv"),
                            layer_name="l")
    plain = tmis.compute_mis(mx, mn, names, 20, lambda a, b: jsim(a, b),
                             out_csv=str(tmp_path / "p" / "m.csv"), layer_name="l")
    assert plain == want
    assert (tmp_path / "p" / "m.csv").read_text() == (tmp_path / "j" / "m.csv").read_text()
    got = tmis.compute_mis(mx, mn, names, 20, tmis.embedding_similarity(emb),
                           out_csv=str(tmp_path / "t" / "m.csv"), layer_name="l")
    jscores = np.asarray([jmis.prepare_machine_interpretability_score(jsim)(
        jmis.build_unit_tasks(mx[:, u], mn[:, u], 20), True)[2] for u in range(mx.shape[1])])
    tscores = tmis._unit_scores(mx, mn, names, 20, tmis.embedding_similarity(emb))
    assert tscores.shape == jscores.shape == (64, 20)
    assert int((tscores != jscores).sum()) <= MAX_TASK_FLIPS
    if (tscores == jscores).all():
        assert got == want
    confs = [r["MIS_confidence"] for r in want["per_unit"]]
    assert 0 < np.mean(confs) < 1  # neither all solved nor all failed
    with pytest.raises(KeyError):  # a sample without an embedding
        tmis.compute_mis(mx, mn, names, 20, tmis.embedding_similarity({0: emb[0]}))


def test_reference_stats_and_distribution_check_equal_jax():
    assert tmis.load_reference_mis_stats() == jmis.load_reference_mis_stats()
    conf = np.random.default_rng(2).uniform(0, 1, 300)
    for group in ("mixed3a", "mixed4d"):
        assert tmis.mis_distribution_check(conf, group) == jmis.mis_distribution_check(conf, group)
    with pytest.raises(ValueError, match="no confidences"):
        tmis.mis_distribution_check([])


def test_fetch_images_batches_takes_in_memory_datasets_only():
    """The in-memory branch (tests/test_torch_datasets.py holds the file and tar
    branches); an object that is no dataset of any kind raises."""
    ds = t_synth(num_samples=10, img_size=(4, 4, 3), num_classes=10, seed=0)
    got = list(fetch_images_batches(ds, [7, 2, 9, 0, 5], 2))
    assert [c.tolist() for c, _ in got] == [[7, 2], [9, 0], [5]]
    np.testing.assert_array_equal(got[1][1], ds.images[[9, 0]])
    with pytest.raises(AttributeError, match="decode_fn"):
        next(fetch_images_batches(object(), [0], 2, workers=0))


# ---------------------------------------------------------------------------
# mis="1" then mis="2" through both Pipelines
# ---------------------------------------------------------------------------

CFG = dict(model_name="inceptionv1", dataset_name="imagenet", sae_layer="mixed3a",
           sae_model_name="sae_mlp", sae_expansion_factor=1, sae_lambda_sparse=1.0,
           sae_optimizer_name="constrained_adam", sae_learning_rate=1e-3, sae_batch_size=64,
           eval_batch_size=32, use_activation_cache=True, cache_tokens_per_step=512,
           cache_dtype="float32", compute_dtype="float32", sae_epochs=1,
           dead_neurons_steps=1000, seed=3)


def _datasets(make):
    tr = make(num_samples=256, img_size=SIZE, num_classes=1000, seed=3)
    va = make(num_samples=32, img_size=SIZE, num_classes=1000, seed=4)
    return tr, va, tr.category_names, SIZE


@pytest.fixture(scope="module")
def mis_runs(tmp_path_factory):
    jdir, tdir = str(tmp_path_factory.mktemp("jax")), str(tmp_path_factory.mktemp("torch"))
    with quick_jax_pipeline():
        jtrain = JPipeline(JConfig(**CFG, directory_path=jdir), datasets=_datasets(j_synth))
        backbone = convert.backbone_from_jax(jax.device_get(jtrain.frozen_params),
                                             jax.device_get(jtrain.net_state))
        sae = convert.sae_params_from_jax(jax.device_get(jtrain.ts.params))
        jtrain.run()
    ttrain = TPipeline(TConfig(**CFG, directory_path=tdir), device="cpu",
                       datasets=_datasets(t_synth), backbone=backbone, sae_params=sae)
    ttrain.run()
    # one trained layer for both: JAX's epoch-1 checkpoint in the port's folder
    t_ckpt.save_checkpoint(ttrain._sae_ckpt_dir(), 1, convert.checkpoint_from_jax(
        j_ckpt.load_checkpoint(jtrain._sae_ckpt_dir(), 1)))
    out = {"backbone": backbone, "tdir": tdir, "jdir": jdir}
    for mode in ("1", "2"):
        mcfg = dict(CFG, training=False, mis=mode, sae_checkpoint_epoch=1)
        with quick_jax_pipeline():
            jp = JPipeline(JConfig(**mcfg, directory_path=jdir), datasets=_datasets(j_synth))
            out[f"j{mode}"] = jp.run()
        tp = TPipeline(TConfig(**mcfg, directory_path=tdir), device="cpu",
                       datasets=_datasets(t_synth), backbone=backbone)
        out[f"t{mode}"] = tp.run()
        out[f"jpipe{mode}"], out[f"tpipe{mode}"] = jp, tp
    return out


def _topk(pipe):
    path = os.path.join(pipe.paths["evaluation_results"], "filename_indices",
                        f"{pipe.run_id}_epoch_1.npz")
    with np.load(path) as z:
        return z["max_filename_indices"], z["min_filename_indices"]


def test_mis_epoch_collects_200_samples_a_side_as_jax_does(mis_runs):
    """mis="1": an eval on the train data whose top-k file holds 200 samples a
    side for every unit, as JAX's, but for swaps of near-equal samples."""
    jt, tt = _topk(mis_runs["jpipe1"]), _topk(mis_runs["tpipe1"])
    for j, t in zip(jt, tt):
        assert t.shape == j.shape == (200, 256) and (t >= 0).all()
        assert (t != j).mean() <= MAX_SWAP_SHARE
    for k, v in mis_runs["j1"].items():
        if k not in ("perc_same", "perc_dead_units", "accuracy", "loss_diff", "kld"):
            np.testing.assert_allclose(mis_runs["t1"][k], v, rtol=1e-4, atol=1e-7, err_msg=k)


def _csv(path):
    with open(path) as f:
        return list(csv.DictReader(f))


def test_mis_scores_csv_median_and_results_row_match_jax(mis_runs):
    """mis="2": one CSV row per unit, each unit's MIS as JAX's where the two
    top-k files agree (at most MAX_UNIT_FLIPS differ), median_mis in the
    results row."""
    jp, tp = mis_runs["jpipe2"], mis_runs["tpipe2"]
    jcsv = _csv(os.path.join(jp.paths["evaluation_results"], "MIS",
                             f"{jp.run_id}_mis_epoch_1.csv"))
    tcsv = _csv(os.path.join(tp.paths["evaluation_results"], "MIS",
                             f"{tp.run_id}_mis_epoch_1.csv"))
    assert len(tcsv) == len(jcsv) == 256
    jt, tt = _topk(jp), _topk(tp)
    same = (jt[0] == tt[0]).all(0) & (jt[1] == tt[1]).all(0)
    differ = [u for u in range(256) if same[u] and tcsv[u] != jcsv[u]]
    assert len(differ) <= MAX_UNIT_FLIPS, differ
    assert [r["unit_idx"] for r in tcsv] == [str(u) for u in range(256)]
    tres, jres = mis_runs["t2"], mis_runs["j2"]
    assert np.isfinite(tres["median_mis"]) and 0 < tres["average_mis"] < 1
    # each unit's confidence moves in steps of 1/20: a differing unit moves the
    # median by at most one step
    assert abs(tres["median_mis"] - jres["median_mis"]) <= 0.05 + 1e-12
    if not differ and same.all():
        assert tres["median_mis"] == jres["median_mis"]
    rows = {}
    for name, pipe in (("j", jp), ("t", tp)):
        with open(os.path.join(pipe.paths["evaluation_results"],
                               f"{pipe.run_id}_epoch_1.json")) as f:
            rows[name] = json.load(f)
    assert set(rows["t"]) == set(rows["j"])
    assert rows["t"]["median_mis"] == tres["median_mis"]
    for k, v in rows["j"].items():
        if isinstance(v, float) and k not in ("median_mis", "loss_diff"):
            np.testing.assert_allclose(rows["t"][k], v, rtol=1e-4, atol=1e-7, err_msg=k)
        elif not isinstance(v, float):
            assert rows["t"][k] == v, k


def test_mis_modes_refuse_training_and_run_from_the_cli(mis_runs, monkeypatch, capsys):
    with pytest.raises(ValueError, match="MIS is computed on a frozen SAE"):
        TPipeline(TConfig(**CFG, mis="1", directory_path=mis_runs["tdir"]), device="cpu",
                  datasets=_datasets(t_synth))
    monkeypatch.setattr(t_pipeline, "load_data", lambda cfg, class_filter=None: _datasets(t_synth))
    monkeypatch.setattr(t_pipeline, "init_backbone", lambda *a: mis_runs["backbone"])
    cfg = dict(CFG, training=False, mis="2", sae_checkpoint_epoch=1,
               directory_path=mis_runs["tdir"])
    capsys.readouterr()
    out = cli.main(["--run_pipeline", "--config", json.dumps(cfg), "--device", "cpu"])
    printed = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    assert printed == out
    assert out["median_mis"] == mis_runs["t2"]["median_mis"] and out["mis"] == "2"
    assert os.path.exists(out["wrote"][0])
