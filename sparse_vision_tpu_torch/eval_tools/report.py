"""A self-contained HTML feature report of a finished run (port of
sparse_vision_tpu/eval_tools/report.py).

One static HTML file folds one run's eval artifacts together:
- its results rows (the per-run JSON files, else the merged CSV);
- the sparse-probing summary, when probing has written its JSON;
- the last evaluated epoch's figures embedded as base64 PNGs (the
  channel-frequency histogram, the top-k and bottom-k sample grids, the
  per-unit activation histograms);
- a sortable per-unit table (activity frequency, dead flag, MIS and its
  confidence where the per-unit MIS CSV exists) from the filename-indices npz;
- with ``ie_dir``, the circuit section: the node-IE histograms
  (eval_tools/figures.plot_ie_histograms), the top nodes and edges by |IE|
  from interp/ie.py's npz files, and faithfulness.png.

Entry points: ``write_feature_report(evaluation_results_dir, run_id, out)``,
or the CLI's ``--feature_report OUT.html`` (after ``--run_pipeline`` when both
are given).
"""

from __future__ import annotations

import base64
import csv
import glob
import html
import json
import os

import numpy as np

_PAGE = """<!DOCTYPE html>
<html><head><meta charset="utf-8"><title>{title}</title><style>
body {{ font-family: system-ui, sans-serif; margin: 2rem auto; max-width: 1100px;
       color: #1a1a1a; }}
h1 {{ font-size: 1.4rem; }} h2 {{ font-size: 1.1rem; margin-top: 2rem; }}
table {{ border-collapse: collapse; width: 100%; font-size: 0.85rem; }}
th, td {{ border: 1px solid #ddd; padding: 4px 8px; text-align: right; }}
th {{ background: #f5f5f5; cursor: pointer; position: sticky; top: 0; }}
tr:nth-child(even) {{ background: #fafafa; }}
img {{ max-width: 100%; border: 1px solid #eee; margin: 0.5rem 0; }}
.dead {{ color: #b00; font-weight: 600; }}
.meta {{ color: #666; font-size: 0.8rem; }}
#units {{ max-height: 480px; overflow-y: auto; display: block; }}
</style></head><body>
<h1>{title}</h1>
<p class="meta">run_id: <code>{run_id}</code> &middot; epoch {epoch} &middot;
generated by sparse_vision_tpu_torch eval_tools/report.py</p>
{summary}
{figures}
{circuit}
{units}
<script>
// one-click column sort for every table with class "sortable"
document.querySelectorAll("table.sortable th").forEach((th, idx) => {{
  th.addEventListener("click", () => {{
    const tb = th.closest("table").querySelector("tbody");
    const rows = Array.from(tb.rows);
    const asc = th.dataset.asc !== "1";
    th.dataset.asc = asc ? "1" : "0";
    rows.sort((a, b) => {{
      const x = a.cells[idx].innerText, y = b.cells[idx].innerText;
      const nx = parseFloat(x), ny = parseFloat(y);
      const c = (isNaN(nx) || isNaN(ny)) ? x.localeCompare(y) : nx - ny;
      return asc ? c : -c;
    }});
    rows.forEach(r => tb.appendChild(r));
  }});
}});
</script>
</body></html>
"""


def _img_tag(path: str, caption: str) -> str:
    with open(path, "rb") as f:
        b64 = base64.b64encode(f.read()).decode()
    return (f"<h2>{html.escape(caption)}</h2>"
            f'<img src="data:image/png;base64,{b64}" alt="{html.escape(caption)}">')


def _latest_epoch(evaluation_results_dir: str, run_id: str) -> int:
    pat = os.path.join(evaluation_results_dir, "filename_indices",
                       f"{run_id}_epoch_*.npz")
    epochs = [int(p.rsplit("_epoch_", 1)[1][:-4]) for p in glob.glob(pat)]
    if not epochs:
        raise FileNotFoundError(
            f"no filename-indices npz for run {run_id!r} under "
            f"{evaluation_results_dir} — run an eval epoch first"
        )
    return max(epochs)


def _results_rows(evaluation_results_dir: str, run_id: str) -> list[dict]:
    """The run's row(s): prefer its per-run JSON, fall back to the merged CSV."""
    rows = []
    for p in sorted(glob.glob(os.path.join(
            evaluation_results_dir, f"{run_id}_epoch_*.json"))):
        with open(p) as f:
            rows.append(json.load(f))
    if rows:
        return rows
    csv_path = os.path.join(evaluation_results_dir, "sae_eval_results.csv")
    if os.path.exists(csv_path):
        with open(csv_path) as f:
            rows = [r for r in csv.DictReader(f)]
    return rows


def _mis_per_unit(evaluation_results_dir: str, run_id: str, epoch: int) -> dict:
    p = os.path.join(evaluation_results_dir, "MIS",
                     f"{run_id}_mis_epoch_{epoch}.csv")
    if not os.path.exists(p):
        return {}
    out = {}
    with open(p) as f:
        for r in csv.DictReader(f):
            out[int(r["unit_idx"])] = (float(r["MIS"]),
                                       float(r["MIS_confidence"]))
    return out


def _circuit_section(ie_dir: str) -> str:
    """Optional circuit-tier section from ie_related_quantities artifacts
    (interp/ie.py persistence: node_ie.npz, edge_ie.npz, faithfulness.png)."""
    import tempfile

    parts = []
    node_path = os.path.join(ie_dir, "node_ie.npz")
    if os.path.exists(node_path):
        with np.load(node_path) as z:
            feats = {k.split(":", 1)[1]: np.asarray(z[k])
                     for k in z.files if k.startswith("features:")}
        # on-the-fly |IE| histogram figure (eval_tools/figures.plot_ie_histograms)
        try:
            from sparse_vision_tpu_torch.eval_tools.figures import plot_ie_histograms

            with tempfile.TemporaryDirectory() as td:
                p = plot_ie_histograms(feats, os.path.join(td, "ie.png"))
                parts.append(_img_tag(p, "Node IE distributions"))
        except Exception as e:  # the figure is optional; the tables follow
            print(f"[report] node-IE histograms skipped: {e}")
        rows = []
        for layer in sorted(feats):
            v = feats[layer]
            for i in np.argsort(-np.abs(v))[:8]:
                rows.append(f"<tr><td>{html.escape(layer)}</td><td>{int(i)}"
                            f"</td><td>{float(v[i]):.6f}</td></tr>")
        parts.append(
            "<h2>Top nodes by |IE|</h2><table class='sortable'><thead><tr>"
            "<th>layer</th><th>feature</th><th>IE</th></tr></thead><tbody>"
            + "".join(rows) + "</tbody></table>")
    edge_path = os.path.join(ie_dir, "edge_ie.npz")
    if os.path.exists(edge_path):
        with np.load(edge_path) as z:
            idx = {k.split(":", 1)[1]: np.asarray(z[k])
                   for k in z.files if k.startswith("idx:")}
            rows = []
            for pair in (k for k in z.files if not k.startswith("idx:")):
                m = np.asarray(z[pair])
                up = pair.split("->")[0] if "->" in pair else None
                down = pair.split("->")[-1] if "->" in pair else None
                flat = np.argsort(-np.abs(m), axis=None)[:8]
                for f in flat:
                    u, dn = np.unravel_index(int(f), m.shape)
                    # map matrix positions back to original feature ids where
                    # the saved index lists cover them (the +1 rows/cols are
                    # the error/loss nodes)
                    uid = (int(idx[up][u]) if up in idx and u < len(idx[up])
                           else f"err/loss[{u}]")
                    did = (int(idx[down][dn]) if down in idx and dn < len(idx[down])
                           else f"err/loss[{dn}]")
                    rows.append(
                        f"<tr><td>{html.escape(str(pair))}</td><td>{uid}</td>"
                        f"<td>{did}</td><td>{float(m[u, dn]):.6f}</td></tr>")
            if rows:
                parts.append(
                    "<h2>Top edges by |IE|</h2><table class='sortable'>"
                    "<thead><tr><th>pair</th><th>upstream</th><th>downstream"
                    "</th><th>edge IE</th></tr></thead><tbody>"
                    + "".join(rows) + "</tbody></table>")
    faith_png = os.path.join(ie_dir, "faithfulness.png")
    if os.path.exists(faith_png):
        parts.append(_img_tag(faith_png, "Faithfulness vs threshold"))
    return "\n".join(parts)


def write_feature_report(evaluation_results_dir: str, run_id: str,
                         out_html: str, epoch: int | None = None,
                         ie_dir: str | None = None) -> str:
    """Render one run's persisted eval artifacts into a single HTML file."""
    if epoch is None:
        epoch = _latest_epoch(evaluation_results_dir, run_id)
    npz_path = os.path.join(evaluation_results_dir, "filename_indices",
                            f"{run_id}_epoch_{epoch}.npz")
    with np.load(npz_path) as z:
        dead = np.asarray(z["dead_units"], bool)
        freq = (np.asarray(z["activity_freq"], np.float64)
                if "activity_freq" in z.files else None)

    # ---- headline metrics table -----------------------------------------
    rows = _results_rows(evaluation_results_dir, run_id)
    if rows:
        cols = list(rows[0].keys())
        head = "".join(f"<th>{html.escape(str(c))}</th>" for c in cols)
        body = "".join(
            "<tr>" + "".join(
                f"<td>{html.escape('' if r.get(c) is None else str(r.get(c)))}</td>"
                for c in cols) + "</tr>"
            for r in rows
        )
        summary = (f"<h2>Run metrics</h2><table class='sortable'><thead><tr>"
                   f"{head}</tr></thead><tbody>{body}</tbody></table>")
    else:
        summary = "<h2>Run metrics</h2><p class='meta'>no results rows found</p>"

    # ---- optional sparse-probing summary (eval_tools/probing.py artifacts) --
    probing_json = os.path.join(evaluation_results_dir, "probing",
                                f"{run_id}_probing_epoch_{epoch}.json")
    if os.path.exists(probing_json):
        with open(probing_json) as f:
            probing = json.load(f)
        sides = [s for s in ("sae", "original") if s in probing]
        keys: list = []
        for s in sides:
            keys += [k for k in probing[s] if k not in keys]
        head = "".join(
            f"<th>{html.escape(k)} AUC</th><th>{html.escape(k)} bal-acc</th>"
            for k in keys)
        body = ""
        for s in sides:
            cells = ""
            for k in keys:
                ent = probing[s].get(k)
                cells += ("<td></td><td></td>" if ent is None else
                          f"<td>{ent['mean_auc']:.4f}</td>"
                          f"<td>{ent['mean_balanced_acc']:.4f}</td>")
            label = "SAE latents" if s == "sae" else "raw channels"
            body += f"<tr><td>{label}</td>{cells}</tr>"
        summary += (
            "<h2>Sparse probing (mean over classes, held-out split)</h2>"
            "<table class='sortable'><thead><tr><th>features</th>"
            + head + "</tr></thead><tbody>" + body + "</tbody></table>"
        )

    # ---- embedded final-epoch figures ------------------------------------
    figures = []
    for sub, pat, caption in (
        ("channel_frequency_histograms", f"{run_id}_epoch_{epoch}.png",
         "Channel activation frequency"),
        ("top_k_samples", f"{run_id}_top_k_samples_epoch_{epoch}.png",
         "Top-k activating samples"),
        ("top_k_samples", f"{run_id}_small_k_samples_epoch_{epoch}.png",
         "Bottom-k activating samples"),
        ("activation_histograms", f"{run_id}_epoch_{epoch}.png",
         "Per-unit activation histograms"),
    ):
        p = os.path.join(evaluation_results_dir, sub, pat)
        if os.path.exists(p):
            figures.append(_img_tag(p, caption))

    # ---- per-unit table ---------------------------------------------------
    mis = _mis_per_unit(evaluation_results_dir, run_id, epoch)
    unit_rows = []
    for u in range(dead.shape[0]):
        f_cell = "" if freq is None else f"{freq[u]:.4f}"
        m = mis.get(u)
        unit_rows.append(
            f"<tr><td>{u}</td><td>{f_cell}</td>"
            f"<td class='dead'>{'dead' if dead[u] else ''}</td>"
            f"<td>{'' if m is None else f'{m[0]:.4f}'}</td>"
            f"<td>{'' if m is None else f'{m[1]:.4f}'}</td></tr>"
        )
    units = (
        f"<h2>Per-unit stats ({dead.shape[0]} latents, "
        f"{int(dead.sum())} dead{', MIS scored' if mis else ''})</h2>"
        "<table class='sortable' id='units'><thead><tr><th>unit</th>"
        "<th>activity freq</th><th>dead</th><th>MIS</th><th>MIS conf</th>"
        "</tr></thead><tbody>" + "".join(unit_rows) + "</tbody></table>"
    )

    # ---- optional circuit tier (node/edge IE + faithfulness artifacts) ----
    circuit = (_circuit_section(ie_dir)
               if ie_dir and os.path.isdir(ie_dir) else "")

    page = _PAGE.format(
        title=f"Feature report — {run_id}", run_id=html.escape(run_id),
        epoch=epoch, summary=summary, figures="\n".join(figures),
        circuit=circuit, units=units,
    )
    os.makedirs(os.path.dirname(out_html) or ".", exist_ok=True)
    tmp = out_html + ".tmp"
    with open(tmp, "w") as f:
        f.write(page)
    os.replace(tmp, out_html)
    return out_html
