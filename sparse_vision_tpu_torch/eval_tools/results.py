"""Durable store of a run's scalar eval results (the port's copy of
sparse_vision_tpu/eval_tools/results.py, with ``csv`` and ``json`` only).

Each run writes its row as a JSON file of its own (no shared-file locking);
``merge_results`` folds every such file into one CSV keyed on
(lambda_sparse, expansion_factor, batch_size, optimizer_name, learning_rate,
epochs), replacing a row whose key columns match.
"""

from __future__ import annotations

import csv
import json
import os
from typing import Optional

RESULT_COLUMNS = [
    "lambda_sparse",
    "expansion_factor",
    "batch_size",
    "optimizer_name",
    "learning_rate",
    "rec_loss",
    "l1_loss",
    "nrmse_loss",
    "rmse_loss",
    "aux_loss",
    "rel_sparsity",
    "var_expl",
    "perc_dead_units",
    "loss_diff",
    "median_mis",
    "epochs",
]

KEY_COLUMNS = [
    "lambda_sparse",
    "expansion_factor",
    "batch_size",
    "optimizer_name",
    "learning_rate",
    "epochs",
]


def store_run_result(folder_path: str, run_name: str, row: dict) -> str:
    """Write one run's scalar results as JSON (one file per run; no locking),
    through a temporary file and os.replace, so a merge never reads half a
    file."""
    os.makedirs(folder_path, exist_ok=True)
    path = os.path.join(folder_path, f"{run_name}.json")
    clean = {c: row.get(c) for c in RESULT_COLUMNS}
    tmp = path + f".tmp{os.getpid()}"
    with open(tmp, "w") as f:
        json.dump(clean, f, sort_keys=True, indent=1)
    os.replace(tmp, path)
    return path


def merge_results(folder_path: str, csv_path: Optional[str] = None) -> str:
    """Fold every per-run JSON into the CSV, replacing rows whose key columns
    match. The CSV is published through a temporary file and os.replace; each
    merge regenerates it from every per-run file it sees, so the last merge
    holds the complete table and no reader sees a truncated file."""
    csv_path = csv_path or os.path.join(folder_path, "sae_eval_results.csv")
    rows: dict[tuple, dict] = {}
    if os.path.exists(csv_path):
        with open(csv_path) as f:
            for row in csv.DictReader(f):
                rows[tuple(row[k] for k in KEY_COLUMNS)] = row
    for fn in sorted(os.listdir(folder_path)):
        if not fn.endswith(".json"):
            continue
        with open(os.path.join(folder_path, fn)) as f:
            row = json.load(f)
        row = {c: ("" if row.get(c) is None else str(row[c])) for c in RESULT_COLUMNS}
        rows[tuple(row[k] for k in KEY_COLUMNS)] = row
    tmp = csv_path + f".tmp{os.getpid()}"
    with open(tmp, "w", newline="") as f:
        w = csv.DictWriter(f, fieldnames=RESULT_COLUMNS)
        w.writeheader()
        for key in sorted(rows):
            w.writerow(rows[key])
    os.replace(tmp, csv_path)
    return csv_path


def read_results(csv_path: str) -> list[dict]:
    with open(csv_path) as f:
        out = []
        for row in csv.DictReader(f):
            parsed = {}
            for k, v in row.items():
                if v == "":
                    parsed[k] = None
                    continue
                try:
                    parsed[k] = float(v)
                except ValueError:
                    parsed[k] = v
            out.append(parsed)
        return out
