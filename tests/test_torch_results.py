"""The port's results store (sparse_vision_tpu_torch/eval_tools/results.py)
against the JAX package's eval_tools/results.py: for the same rows, the per-run
JSON files and the merged CSV are byte-equal, a row whose key columns match is
replaced in place, and read_results parses both the same way."""

import os

import pytest

from sparse_vision_tpu.eval_tools import results as jres
from sparse_vision_tpu_torch.eval_tools import results as tres


def _rows():
    base = {"lambda_sparse": 5.0, "expansion_factor": 64, "batch_size": 256,
            "optimizer_name": "constrained_adam", "learning_rate": 0.001, "median_mis": None,
            "rec_loss": 0.1234567, "l1_loss": 1e-7, "nrmse_loss": 0.5, "rmse_loss": 0.25,
            "aux_loss": 0.0, "rel_sparsity": 3.75, "var_expl": 0.9871, "perc_dead_units": 0.0,
            "loss_diff": -2.384185791015625e-07}
    return [
        ("run_a_epoch_1", {**base, "epochs": 1}),
        ("run_a_epoch_2", {**base, "epochs": 2, "rec_loss": 0.05}),
        ("run_b_epoch_1", {**base, "epochs": 1, "lambda_sparse": 0.5, "extra": "dropped"}),
        # the same key as run_a_epoch_2: it replaces that row
        ("run_c_epoch_2", {**base, "epochs": 2, "rec_loss": 0.01, "var_expl": None}),
    ]


def _files(folder):
    return {n: open(os.path.join(folder, n), "rb").read() for n in sorted(os.listdir(folder))}


def test_json_files_and_merged_csv_are_byte_equal_to_jax(tmp_path):
    jdir, tdir = str(tmp_path / "j"), str(tmp_path / "t")
    for name, row in _rows():
        jres.store_run_result(jdir, name, row)
        tres.store_run_result(tdir, name, row)
        jres.merge_results(jdir)
        tres.merge_results(tdir)
        assert _files(tdir) == _files(jdir)
    csv_path = os.path.join(tdir, "sae_eval_results.csv")
    assert tres.read_results(csv_path) == jres.read_results(csv_path)
    rows = tres.read_results(csv_path)
    assert len(rows) == 3  # run_c replaced run_a's epoch-2 row
    by_key = {(r["lambda_sparse"], r["epochs"]): r for r in rows}
    assert by_key[(5.0, 2.0)]["rec_loss"] == 0.01 and by_key[(5.0, 2.0)]["var_expl"] is None
    assert by_key[(5.0, 1.0)]["optimizer_name"] == "constrained_adam"


def test_merge_keeps_rows_of_an_existing_csv_and_writes_to_a_given_path(tmp_path):
    jdir, tdir = str(tmp_path / "j"), str(tmp_path / "t")
    for folder, mod in ((jdir, jres), (tdir, tres)):
        name, row = _rows()[0]
        mod.store_run_result(folder, name, row)
        mod.merge_results(folder, os.path.join(folder, "out.csv"))
        os.remove(os.path.join(folder, f"{name}.json"))
        name, row = _rows()[2]
        mod.store_run_result(folder, name, row)
        mod.merge_results(folder, os.path.join(folder, "out.csv"))
    assert _files(tdir) == _files(jdir)
    assert len(tres.read_results(os.path.join(tdir, "out.csv"))) == 2


def test_no_temporary_file_is_left(tmp_path):
    name, row = _rows()[0]
    tres.store_run_result(str(tmp_path), name, row)
    tres.merge_results(str(tmp_path))
    assert sorted(os.listdir(tmp_path)) == [f"{name}.json", "sae_eval_results.csv"]
    with pytest.raises(FileNotFoundError):
        tres.read_results(str(tmp_path / "missing.csv"))
