"""Machine Interpretability Score (port of sparse_vision_tpu/interp/mis.py; after
Zimmermann et al.).

For each unit take the k most- and least-activating train samples (the
filename indices that ``Pipeline.mis_epoch`` saves, ``mis="1"``), build
``n_mis`` binary 2-AFC tasks, each with reference images at both extremes and
one query per side (queries last), score them with a similarity model, and
record each unit's MIS and confidence in a CSV and the layer's median in the
run's results row (``compute_mis_for_run``, ``mis="2"``).

The similarity is pluggable. The default is cosine similarity in an
embedding space: the frozen backbone's penultimate stage, spatially averaged
(the reference's dreamsim pickles are not available). ``embedding_similarity``
returns a callable ``sim(a, b)`` as the JAX package's does, which also scores
whole task arrays at once: each similarity is the dot product of the two
float64 unit-norm embeddings, the unit's tasks are gathered by index and
reduced with numpy, a few units at a time. The decisions are JAX's but where
two similarity means tie to within f32 rounding (tests/test_torch_mis.py
counts them).

Task layout (reference utils.py:2262-2294): ``batch = mins + maxs``, each half
ending with its query.
"""

from __future__ import annotations

import csv
import json
import os
from typing import Callable, Sequence

import numpy as np
import torch

UNITS_PER_CHUNK = 32  # units whose tasks are gathered at once (memory bound)


def make_fair_batches(items: list, n_batches: int, reverse: bool = False) -> list:
    """Distribute ``items`` (sorted by ascending activation) round-robin over
    ``n_batches``, so every batch spans the activation range and ends with one
    of the last ``n_batches`` items (the query position). ``reverse=True``
    flips each batch (the min side, whose query then also lands last)."""
    batches = [items[i::n_batches] for i in range(n_batches)]
    if reverse:
        batches = [list(reversed(b)) for b in batches]
    return batches


def build_unit_tasks(max_filenames: Sequence, min_filenames: Sequence, n_mis: int) -> list:
    """The n_mis 2-AFC task batches of one unit (reference utils.py:2262-2294).
    ``max_filenames`` runs by descending activation, ``min_filenames`` by
    ascending, n_mis·(k_mis + 1) each. Max queries are the first n_mis (the
    strongest), min queries the last n_mis of the min list (the mildest, the
    reference's choice). Queries last in each half; batch = mins + maxs."""
    max_filenames = list(max_filenames)
    min_filenames = list(min_filenames)
    max_queries, max_refs = max_filenames[:n_mis], max_filenames[n_mis:]
    min_queries, min_refs = min_filenames[-n_mis:], min_filenames[:-n_mis]
    max_lists = make_fair_batches(max_refs + max_queries, n_mis)
    min_lists = make_fair_batches(min_queries + min_refs, n_mis, reverse=True)
    return [mins + maxs for mins, maxs in zip(min_lists, max_lists)]


def score_task(batch: list, similarity: Callable) -> float:
    """One 2-AFC task: solved for a query when it is more similar to its own
    half's references than to the other half's. The mean of the two query
    decisions, in {0, 0.5, 1}."""
    half = len(batch) // 2
    mins, maxs = batch[:half], batch[half:]
    min_refs, min_query = mins[:-1], mins[-1]
    max_refs, max_query = maxs[:-1], maxs[-1]
    s_min_own = np.mean([similarity(min_query, r) for r in min_refs])
    s_min_other = np.mean([similarity(min_query, r) for r in max_refs])
    s_max_own = np.mean([similarity(max_query, r) for r in max_refs])
    s_max_other = np.mean([similarity(max_query, r) for r in min_refs])
    return (int(s_min_own > s_min_other) + int(s_max_own > s_max_other)) / 2.0


def prepare_machine_interpretability_score(similarity: Callable):
    """``f(task_batches) -> (mis, confidence)``: the mean task score and its
    certainty |2·mis − 1| (reference utils.py:2296-2301)."""

    def compute(task_batches: list, include_individual_scores: bool = False):
        scores = [score_task(b, similarity) for b in task_batches]
        mis = float(np.mean(scores))
        confidence = abs(2.0 * mis - 1.0)
        if include_individual_scores:
            return mis, confidence, scores
        return mis, confidence

    return compute


class EmbeddingSimilarity:
    """Cosine similarity between precomputed embeddings keyed by sample: a
    callable ``sim(a, b)``, and ``task_scores`` for whole task arrays."""

    def __init__(self, embeddings: dict):
        self.row = {k: i for i, k in enumerate(embeddings)}
        e = np.stack([np.asarray(v, np.float64) for v in embeddings.values()])
        self.unit = e / (np.linalg.norm(e, axis=1, keepdims=True) + 1e-12)

    def __call__(self, a, b) -> float:
        return float(self.unit[self.row[a]] @ self.unit[self.row[b]])

    def task_scores(self, rows: np.ndarray) -> np.ndarray:
        """``rows`` [..., L]: tasks as embedding rows in build_unit_tasks'
        layout. Returns each task's score_task value [...]."""
        half = rows.shape[-1] // 2
        mins, maxs = rows[..., :half], rows[..., half:]

        def mean_sim(query, refs):
            return np.einsum("...d,...rd->...r", self.unit[query], self.unit[refs]).mean(-1)

        min_q, max_q = mins[..., -1], maxs[..., -1]
        solved_min = mean_sim(min_q, mins[..., :-1]) > mean_sim(min_q, maxs[..., :-1])
        solved_max = mean_sim(max_q, maxs[..., :-1]) > mean_sim(max_q, mins[..., :-1])
        return (solved_min.astype(np.float64) + solved_max) / 2.0


def embedding_similarity(embeddings: dict) -> EmbeddingSimilarity:
    """The default similarity: cosine similarity between the embeddings keyed
    by sample (a stand-in for the reference's dreamsim pickles)."""
    return EmbeddingSimilarity(embeddings)


def load_reference_mis_stats() -> dict:
    """Summary statistics of the reference thesis's per-unit MIS table
    (dreamsim scores on InceptionV1 units), keyed by layer group: n_units, the
    median and mean MIS_confidence, its quantiles and the share of units at
    the 1.0 ceiling. The port's own copy of the JAX package's asset."""
    path = os.path.join(os.path.dirname(__file__), "..", "data", "assets",
                        "mis_reference_stats.json")
    with open(os.path.normpath(path)) as f:
        return json.load(f)


def mis_distribution_check(confidences: Sequence[float], group: str = "mixed3a") -> dict:
    """The shape of a layer's per-unit MIS_confidence distribution against the
    reference's for ``group``: quantile gaps and the headline statistics side
    by side. The default similarity is a stand-in for dreamsim, so absolute
    scores do not compare; a broken similarity (confidences near 0, or
    uniform) shows in the shape."""
    stats = load_reference_mis_stats()["groups"][group]
    conf = np.asarray(list(confidences), np.float64)
    if conf.size == 0:
        raise ValueError("no confidences given")
    qs = sorted(float(q) for q in stats["confidence_quantiles"])
    ours_q = {q: float(np.quantile(conf, q)) for q in qs}
    ref_q = {float(q): v for q, v in stats["confidence_quantiles"].items()}
    gaps = {q: round(ours_q[q] - ref_q[q], 4) for q in qs}
    return {
        "group": group,
        "n_units": int(conf.size),
        "median_confidence": float(np.median(conf)),
        "reference_median_confidence": stats["median_confidence"],
        "mean_confidence": float(np.mean(conf)),
        "reference_mean_confidence": stats["mean_confidence"],
        "quantile_gaps_vs_reference": gaps,
        "max_abs_quantile_gap": float(max(abs(g) for g in gaps.values())),
        "above_chance_fraction": float((conf > 0.05).mean()),
    }


def _embed_fn(pipeline):
    """The frozen backbone's penultimate stage, spatially averaged."""
    from sparse_vision_tpu_torch.ops.metrics import spatial_mean

    net = pipeline.net
    penult = net.stage_names[-2]

    @torch.no_grad()
    def embed(x):
        _, taps, _ = net.apply(pipeline.frozen_params, x, state=pipeline.net_state,
                               stop_at=penult)
        return spatial_mean(taps[penult])

    return embed


def compute_mis_for_run(pipeline, n_mis: int = 20, k_mis: int = 9, embed_fn=None) -> dict:
    """Mode ``mis="2"``: read the per-unit max/min sample indices that the
    ``mis="1"`` epoch saved, embed every sample they name (in chunks of 64, decoded by
    ``cfg.data_workers`` threads where the dataset is file-backed and
    staged through data/prefetch.py; the embeddings stay on the device until
    one readback), score every unit, write the per-unit CSV under
    ``evaluation_results/MIS/`` and record the layer's median in the run's
    results row. ``embed_fn`` ([B, H, W, C] images -> [B, D]) replaces the
    default embedder. Absolute scores depend on the embedder; check the shape
    with ``mis_distribution_check``."""
    from sparse_vision_tpu_torch.data.datasets import Batch, fetch_images_batches
    from sparse_vision_tpu_torch.data.prefetch import prefetch
    from sparse_vision_tpu_torch.eval_tools import results as results_store

    cfg = pipeline.cfg
    epoch = cfg.sae_checkpoint_epoch
    fn_dir = os.path.join(pipeline.paths["evaluation_results"], "filename_indices")
    with np.load(os.path.join(fn_dir, f"{pipeline.run_id}_epoch_{epoch}.npz")) as data:
        max_idx, min_idx = data["max_filename_indices"], data["min_filename_indices"]
    need = n_mis * (k_mis + 1)
    if max_idx.shape[0] != need:
        raise ValueError(
            f"MIS scoring needs top-k indices with k={need} rows (one mis='1' collection "
            f"epoch), but the saved file for epoch {epoch} has k={max_idx.shape[0]}: "
            "run the mis='1' mode first (a regular eval epoch saves k=25).")
    if (max_idx < 0).any() or (min_idx < 0).any():
        raise ValueError(
            f"MIS needs {need} distinct samples per extreme but the collected top-k "
            "contains unfilled sentinel rows: the train dataset is smaller than "
            f"{need}; reduce n_mis/k_mis or use a larger dataset.")
    needed = sorted(set(max_idx.ravel().tolist()) | set(min_idx.ravel().tolist()))

    embed = embed_fn or _embed_fn(pipeline)

    def chunks():
        for chunk_idx, imgs in fetch_images_batches(pipeline.train_ds, needed, 64,
                                                    workers=cfg.data_workers):
            yield Batch(imgs, chunk_idx, chunk_idx.astype(np.int32))

    embs = torch.cat([embed(b.images) for b in prefetch(chunks(), pipeline.device)])
    embs = embs.float().cpu().numpy()
    out_csv = os.path.join(pipeline.paths["evaluation_results"], "MIS",
                           f"{pipeline.run_id}_mis_epoch_{epoch}.csv")
    result = compute_mis(max_idx, min_idx, {i: i for i in needed}, n_mis,
                         embedding_similarity(dict(zip(needed, embs))), out_csv=out_csv,
                         layer_name=cfg.sae_layer)
    # the layer's median in the run's results row (reference utils.py:2325-2342)
    folder = pipeline.paths["evaluation_results"]
    run_json = os.path.join(folder, f"{pipeline.run_id}_epoch_{epoch}.json")
    row = {}
    if os.path.exists(run_json):
        with open(run_json) as f:
            row = json.load(f)
    row["median_mis"] = result["median_mis"]
    row.setdefault("lambda_sparse", cfg.sae_lambda_sparse)
    row.setdefault("expansion_factor", cfg.sae_expansion_factor)
    row.setdefault("batch_size", cfg.sae_batch_size)
    row.setdefault("optimizer_name", cfg.sae_optimizer_name)
    row.setdefault("learning_rate", cfg.sae_learning_rate)
    row.setdefault("epochs", epoch)
    results_store.store_run_result(folder, f"{pipeline.run_id}_epoch_{epoch}", row)
    results_store.merge_results(folder)
    return result


def _unit_scores(max_idx, min_idx, idx_to_filename: dict, n_mis: int, similarity) -> np.ndarray:
    """Every unit's task scores [U, n_mis]: the task layout of build_unit_tasks
    as positions into each unit's (max, min) column, gathered for all units;
    EmbeddingSimilarity.task_scores scores them a chunk of units at a time,
    any other similarity task by task."""
    k_total, units = max_idx.shape
    pos = np.asarray(build_unit_tasks(range(k_total), range(k_total, 2 * k_total), n_mis))
    samples = np.concatenate([max_idx, min_idx]).T  # [U, 2K]
    if not isinstance(similarity, EmbeddingSimilarity):
        return np.asarray([[score_task([idx_to_filename[int(i)] for i in task], similarity)
                            for task in samples[u][pos]] for u in range(units)])
    uniq, inverse = np.unique(samples, return_inverse=True)
    rows = np.asarray([similarity.row[idx_to_filename[int(i)]] for i in uniq])[inverse]
    rows = rows.reshape(samples.shape)
    return np.concatenate([similarity.task_scores(rows[s:s + UNITS_PER_CHUNK][:, pos])
                           for s in range(0, units, UNITS_PER_CHUNK)])


def compute_mis(max_filename_indices: np.ndarray, min_filename_indices: np.ndarray,
                idx_to_filename: dict, n_mis: int, similarity: Callable,
                out_csv: str | None = None, layer_name: str = "") -> dict:
    """Per-unit MIS over a layer (reference utils.py:2262-2342): the tasks of
    each unit ([k_total, U] indices, max descending and min ascending), their
    scores, the per-unit CSV, and the median and mean of the confidences
    (median_mis is the median of the confidence list, as the reference's)."""
    scores = _unit_scores(max_filename_indices, min_filename_indices, idx_to_filename, n_mis,
                          similarity)
    rows = []
    for unit_idx, s in enumerate(scores):
        mis = float(np.mean(s))
        rows.append({"unit_idx": unit_idx, "MIS": mis, "MIS_confidence": abs(2.0 * mis - 1.0),
                     "layer_name": layer_name})
    confs = [r["MIS_confidence"] for r in rows]
    result = {"per_unit": rows, "median_mis": float(np.median(confs)),
              "average_mis": float(np.mean(confs))}
    if out_csv:
        os.makedirs(os.path.dirname(out_csv) or ".", exist_ok=True)
        with open(out_csv, "w", newline="") as f:
            w = csv.DictWriter(f, fieldnames=["unit_idx", "MIS", "MIS_confidence", "layer_name"])
            w.writeheader()
            w.writerows(rows)
    return result
