"""The eval figures and the feature report against the JAX package's: the
streaming histograms (ops/histograms.py), the top-k image gather and grid
(eval_tools/viz.py), the figures of the last eval (train/pipeline.py),
faithfulness.png (interp/ie.py), eval_tools/figures.py and
eval_tools/report.py.

The figure data is compared exactly. To hold the eval's figure data bitwise,
the port's eval step replays the JAX run's eval-step outputs batch by batch
(each batch's images checked equal first): the top-k states, frequencies,
unit choice, image gather and histogram counts built from them must then be
JAX's bit for bit. The PNG files are compared by their set under the run
folder and their pixel sizes; the port draws with PIL and JAX with
matplotlib, so no text pixel is compared (the two machines' PIL builds draw
other glyphs). The top-k tiles read back bitwise (draw.tile_pixels). The HTML
report is compared with its embedded images blanked.

Small: custom_cnn_1 on 28 px single-channel stand-in images (conv2's 64
channels, 128 latents at 2x), 64 train / 32 val images; the image gathers and
grids also on 16 px RGB arrays, image files and tar shards.
"""

import base64
import contextlib
import csv
import io
import json
import os
import re

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from PIL import Image

from sparse_vision_tpu.config import RunConfig as JConfig
from sparse_vision_tpu.data import datasets as J
from sparse_vision_tpu.eval_tools import figures as j_fig
from sparse_vision_tpu.eval_tools import report as j_report
from sparse_vision_tpu.eval_tools import viz as j_viz
from sparse_vision_tpu.interp import ie as j_ie
from sparse_vision_tpu.ops import histograms as j_hist
from sparse_vision_tpu.train.pipeline import Pipeline as JPipeline
from sparse_vision_tpu_torch import cli, convert
from sparse_vision_tpu_torch.config import RunConfig as TConfig
from sparse_vision_tpu_torch.data import datasets as T
from sparse_vision_tpu_torch.eval_tools import draw
from sparse_vision_tpu_torch.eval_tools import figures as t_fig
from sparse_vision_tpu_torch.eval_tools import report as t_report
from sparse_vision_tpu_torch.eval_tools import viz as t_viz
from sparse_vision_tpu_torch.interp import ie as t_ie
from sparse_vision_tpu_torch.ops import histograms as t_hist
from sparse_vision_tpu_torch.train import pipeline as t_pipeline
from sparse_vision_tpu_torch.train.pipeline import Pipeline as TPipeline
from test_torch_pipeline import quick_jax_pipeline

SIZE = (28, 28, 1)
CFG = dict(model_name="custom_cnn_1", dataset_name="mnist", sae_layer="conv2",
           sae_model_name="sae_mlp", sae_expansion_factor=2, sae_lambda_sparse=0.5,
           sae_optimizer_name="constrained_adam", sae_learning_rate=1e-3, sae_batch_size=16,
           use_activation_cache=True, cache_tokens_per_step=784, cache_dtype="float32",
           compute_dtype="float32", sae_epochs=1, dead_neurons_steps=1000, seed=3,
           batch_size=16, log_every=10**9)
# the JAX Pipeline's own figure methods, before quick_jax_pipeline stubs them
_J_FIGURES = {n: getattr(JPipeline, n) for n in ("_channel_frequency_figure",
                                                 "_final_eval_figures")}


@pytest.fixture(scope="module", autouse=True)
def one_torch_thread():
    """Small passes: one intra-op thread is as fast alone and much faster when
    the test workers oversubscribe the cores."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _size(path) -> tuple:
    with Image.open(path) as im:
        return im.size


# ---------------------------------------------------------------------------
# ops/histograms.py
# ---------------------------------------------------------------------------

def _hist_case(case: str):
    """(mins [U], maxs [U], batches of [B, U]) for one case."""
    rng = np.random.default_rng(7)
    f32 = np.float32
    if case == "edges":  # values at min, at max, below, above and inside
        mins, maxs = np.array([-1.0, 0.0, 2.5], f32), np.array([1.0, 3.0, 7.25], f32)
        a = np.stack([mins, maxs, mins - 1, maxs + 1, (mins + maxs) / 2,
                      np.nextafter(maxs, -np.inf), np.nextafter(mins, np.inf)]).astype(f32)
        return mins, maxs, [a, a[::-1].copy()]
    if case == "zero_span":  # a constant unit's in-range values all in bin 0
        mins, maxs = np.array([0.5, 0.0], f32), np.array([0.5, 1.0], f32)
        a = np.array([[0.5, 0.0], [0.5, 1.0], [0.25, 0.5], [0.75, 2.0]], f32)
        return mins, maxs, [a]
    if case == "sentinel":  # ±inf extrema (an empty top-k state) and ±inf values
        mins = np.array([-np.inf, 0.0, -np.inf, 1.0], f32)
        maxs = np.array([1.0, np.inf, np.inf, 1.0], f32)
        a = np.array([[0.5, 0.5, 0.0, 1.0], [-np.inf, np.inf, np.inf, np.inf],
                      [np.inf, -np.inf, -np.inf, -np.inf], [1.0, 0.0, 3.0, 0.0]], f32)
        return mins, maxs, [a, a[::-1].copy()]
    acts = [rng.normal(size=(32, 10)).astype(f32) for _ in range(3)]
    return np.min(acts[0], 0), np.max(acts[0], 0), acts  # later batches leave the range


@pytest.mark.parametrize("case", ["edges", "zero_span", "sentinel", "random"])
def test_update_histogram_matches_jax_exactly(case):
    mins, maxs, batches = _hist_case(case)
    js = j_hist.init_histogram(100, jnp.asarray(mins), jnp.asarray(maxs))
    ts = t_hist.init_histogram(100, torch.from_numpy(mins), torch.from_numpy(maxs))
    update = jax.jit(j_hist.update_histogram)
    for a in batches:
        js = update(js, jnp.asarray(a))
        ts = t_hist.update_histogram(ts, torch.from_numpy(a))
    np.testing.assert_array_equal(ts.counts.numpy(), np.asarray(js.counts))
    assert ts.counts.dtype == torch.float32 and ts.counts.shape == (100, len(mins))
    if case != "sentinel":  # plotting positions: JAX's f32 linspace, the port's f64
        span = max(float(maxs[0] - mins[0]), abs(float(mins[0])), abs(float(maxs[0])))
        np.testing.assert_allclose(t_hist.bin_edges(ts, 0),
                                   np.asarray(j_hist.bin_edges(js, 0)), rtol=0,
                                   atol=1e-6 * span)


def test_plot_histograms_size_matches_jax(tmp_path):
    mins, maxs, batches = _hist_case("random")
    js = j_hist.update_histogram(j_hist.init_histogram(100, jnp.asarray(mins),
                                                       jnp.asarray(maxs)), batches[0])
    ts = t_hist.update_histogram(t_hist.init_histogram(100, torch.from_numpy(mins),
                                                       torch.from_numpy(maxs)),
                                 torch.from_numpy(batches[0]))
    jp = j_hist.plot_histograms(js, list(range(10)), str(tmp_path / "j.png"), "t")
    tp = t_hist.plot_histograms(ts, list(range(10)), str(tmp_path / "t.png"), "t")
    assert _size(tp) == _size(jp) == (2700, 1800)


# ---------------------------------------------------------------------------
# eval_tools/viz.py and the unit choice
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("dead", [[0, 0, 0, 0], [1, 0, 1, 0, 0, 1, 1, 1, 1, 1, 1, 1],
                                  [1, 1, 1, 0, 1], [1, 1, 1]])
def test_select_figure_units_matches_jax(dead):
    dead = np.asarray(dead, bool)
    for n in (2, 10):
        want = JPipeline._select_figure_units(None, dead, n=n)
        got = TPipeline._select_figure_units(dead, n=n)
        np.testing.assert_array_equal(got, want)
        assert got.dtype == want.dtype == np.int64


def _decode(path):
    return np.asarray(Image.open(path).convert("RGB"), np.float32)


def _decode_bytes(data):
    return np.asarray(Image.open(io.BytesIO(data)).convert("RGB"), np.float32)


@pytest.fixture(scope="module")
def image_sets(tmp_path_factory):
    """The same 12 RGB images as an in-memory dataset, PNG files and tar
    shards, in each package."""
    d = tmp_path_factory.mktemp("images")
    rng = np.random.default_rng(5)
    arrs = rng.integers(0, 256, (12, 16, 16, 3), dtype=np.uint8)
    paths = []
    for i, a in enumerate(arrs):
        paths.append(str(d / f"{i:02d}.png"))
        Image.fromarray(a).save(paths[-1])
    labels = [i % 3 for i in range(12)]
    tars = T.write_tar_shards(paths, labels, str(d / "tars"), shard_size=5)
    images = arrs.astype(np.float32) / 255.0
    return {
        "array": (T.ArrayDataset(images, np.asarray(labels), ["x"] * 3),
                  J.ArrayDataset(images, np.asarray(labels), ["x"] * 3)),
        "files": (T.LazyImageDataset(paths, labels, ["x"], _decode),
                  J.LazyImageDataset(paths, labels, ["x"], _decode)),
        "tars": (T.TarShardDataset(tars, ["x"], _decode_bytes),
                 J.TarShardDataset(tars, ["x"], _decode_bytes)),
    }


# [k, U]: unit 0 full, unit 1 two sentinels at the tail, unit 2 dead (all -1)
TOPK_INDICES = np.array([[3, 7, -1], [11, 0, -1], [5, -1, -1], [8, -1, -1]], np.int32)


@pytest.mark.parametrize("kind", ["array", "files", "tars"])
def test_gather_topk_images_matches_jax(kind, image_sets):
    tds, jds = image_sets[kind]
    got = t_viz.gather_topk_images(tds, TOPK_INDICES, [0, 1, 2])
    want = j_viz.gather_topk_images(jds, TOPK_INDICES, [0, 1, 2])
    assert list(got) == list(want) == [0, 1, 2]
    for u in want:
        assert got[u].dtype == want[u].dtype
        np.testing.assert_array_equal(got[u], want[u], err_msg=f"unit {u}")
    assert got[2].shape == (0, 16, 16, 3) and got[1].shape[0] == 2


def _check_tiles(path, images, values) -> int:
    """Every tile of a top-k grid read back bitwise; returns how many."""
    with Image.open(path) as im:
        px = np.asarray(im.convert("RGB"))
    boxes = t_viz.topk_tile_boxes(images, values)
    for (u, c), (x, y, scale, stride) in boxes.items():
        want = draw.tile_pixels(images[u][c][::stride, ::stride], scale)
        got = px[y:y + want.shape[0], x:x + want.shape[1]]
        np.testing.assert_array_equal(got, want, err_msg=f"tile ({u}, {c})")
    return len(boxes)


@pytest.mark.parametrize("case", ["grid", "short_unit", "no_unit"])
def test_show_top_k_samples_size_and_tiles(case, image_sets, tmp_path):
    """The grid's pixel size equals JAX's figure's, its tiles read back
    bitwise; a unit with fewer images is bounded by them; no unit left
    draws the title-only figure."""
    tds, _ = image_sets["array"]
    units = {"grid": [0, 1], "short_unit": [0, 1, 2], "no_unit": [2]}[case]
    images = t_viz.gather_topk_images(tds, TOPK_INDICES, units)
    values = {u: np.linspace(1.0, 0.1, 4).astype(np.float32) + u for u in units}
    if case == "grid":
        images[1] = images[0]
    tp = t_viz.show_top_k_samples(images, values, str(tmp_path / "t.png"), title="t")
    jp = j_viz.show_top_k_samples(images, values, str(tmp_path / "j.png"), title="t")
    assert _size(tp) == _size(jp)
    tiles = _check_tiles(tp, images, values)
    assert tiles == {"grid": 8, "short_unit": 6, "no_unit": 0}[case]


def test_a_single_channel_tile_reads_back_gray():
    img = np.arange(16, dtype=np.float32).reshape(4, 4, 1)
    tile = draw.tile_pixels(img, 3)
    assert tile.shape == (12, 12, 3)
    assert (tile[..., 0] == tile[..., 2]).all() and tile[0, 0, 0] == 0 and tile[-1, -1, 0] == 255


# ---------------------------------------------------------------------------
# the figures of an eval through both Pipelines
# ---------------------------------------------------------------------------

def _datasets(make):
    tr = make(num_samples=64, img_size=SIZE, num_classes=10, seed=3)
    va = make(num_samples=32, img_size=SIZE, num_classes=10, seed=4)
    return tr, va, tr.category_names, SIZE


def _np(tree):
    return jax.tree.map(np.asarray, jax.device_get(tree))


def _recording(fn, calls: list):
    """``fn`` that also keeps each call's images and outputs as numpy."""

    def step(*args):
        out = fn(*args)
        calls.append((np.asarray(args[-2]), _np(out)))
        return out

    return step


def _replaying(calls: list):
    """An eval step that returns the recorded outputs in order, as tensors,
    after checking that it is given the recorded batch's images."""
    queue = list(calls)

    def step(*args):
        images, out = queue.pop(0)
        np.testing.assert_array_equal(args[-2].numpy(), images)
        return jax.tree.map(lambda a: torch.from_numpy(np.array(a)), out)

    return step


@contextlib.contextmanager
def _capturing(mp, pipeline_cls, viz_mod, hist_mod, into: dict):
    """Record what an eval hands its figure functions, and still draw."""
    into.update(freq=[], topk=[], hist=[])
    cf, show, plot = (pipeline_cls._channel_frequency_figure, viz_mod.show_top_k_samples,
                      hist_mod.plot_histograms)

    def cf_rec(self, freq, epoch, *a, **kw):
        into["freq"].append((np.array(freq), epoch))
        return cf(self, freq, epoch, *a, **kw)

    def show_rec(images, values, path, title=""):
        into["topk"].append(({int(u): np.array(v) for u, v in images.items()},
                             {int(u): np.array(v) for u, v in values.items()},
                             os.path.basename(path), title))
        return show(images, values, path, title=title)

    def plot_rec(state, units, path, title):
        into["hist"].append(({k: np.asarray(jax.device_get(v)) if not isinstance(v, torch.Tensor)
                              else v.numpy() for k, v in state._asdict().items()},
                             [int(u) for u in units], os.path.basename(path), title))
        return plot(state, units, path, title)

    mp.setattr(pipeline_cls, "_channel_frequency_figure", cf_rec)
    mp.setattr(viz_mod, "show_top_k_samples", show_rec)
    mp.setattr(hist_mod, "plot_histograms", plot_rec)
    yield


def _figure_runs(cfg: dict, tmp_path_factory, original: bool) -> dict:
    """Both Pipelines' runs of ``cfg`` with their figures drawn and captured;
    the port's eval step replays JAX's (module docstring)."""
    jcap, tcap, calls = {}, {}, []
    jdir, tdir = tmp_path_factory.mktemp("jax"), tmp_path_factory.mktemp("torch")
    with quick_jax_pipeline(), pytest.MonkeyPatch.context() as mp:
        for n, f in _J_FIGURES.items():
            mp.setattr(JPipeline, n, f)
        with _capturing(mp, JPipeline, j_viz, j_hist, jcap):
            jpipe = JPipeline(JConfig(**cfg, directory_path=str(jdir)),
                              datasets=_datasets(J.make_synthetic))
            backbone = convert.backbone_from_jax(*jax.device_get((jpipe.frozen_params,
                                                                  jpipe.net_state)))
            sae = None
            if original:
                jpipe._model_topk_eval_step_cache = _recording(
                    jpipe._model_topk_eval_step_fn, calls)
            else:
                sae = convert.sae_params_from_jax(jax.device_get(jpipe.ts.params))
                jpipe._sae_eval_step_cache = _recording(jpipe._sae_eval_step_fn, calls)
                jpipe.CACHE_SCAN_K = 2
            jpipe.run()
    tpipe = TPipeline(TConfig(**cfg, directory_path=str(tdir)), device="cpu",
                      datasets=_datasets(T.make_synthetic), backbone=backbone, sae_params=sae)
    replay = _replaying(calls)
    with pytest.MonkeyPatch.context() as mp, _capturing(mp, TPipeline, t_viz, t_hist, tcap):
        if original:
            mp.setattr(t_pipeline, "make_model_eval_step", lambda *a, **kw: replay)
        else:
            tpipe._sae_eval_step_cache = replay
            tpipe.CACHE_SCAN_K = 2
        tpipe.run()
    return dict(jcap=jcap, tcap=tcap, jdir=str(jdir), tdir=str(tdir), tpipe=tpipe,
                calls=len(calls))


@pytest.fixture(scope="module")
def sae_figures(tmp_path_factory):
    return _figure_runs(CFG, tmp_path_factory, original=False)


@pytest.fixture(scope="module")
def original_figures(tmp_path_factory):
    cfg = {**CFG, "original_model": True, "training": False, "sae_model_name": "None"}
    return _figure_runs(cfg, tmp_path_factory, original=True)


def _same_capture(t: dict, j: dict) -> None:
    assert [e for _, e in t["freq"]] == [e for _, e in j["freq"]]
    for (tf, _), (jf, _) in zip(t["freq"], j["freq"]):
        assert tf.dtype == jf.dtype == np.float64
        np.testing.assert_array_equal(tf, jf)
    assert len(t["topk"]) == len(j["topk"]) == 2
    for (ti, tv, tn, tt), (ji, jv, jn, jt) in zip(t["topk"], j["topk"]):
        assert (tn, tt) == (jn, jt)
        assert list(ti) == list(ji) == list(tv) == list(jv)
        for u in ji:
            np.testing.assert_array_equal(ti[u], ji[u], err_msg=f"{tn} images of {u}")
            np.testing.assert_array_equal(tv[u], jv[u], err_msg=f"{tn} values of {u}")
    assert len(t["hist"]) == len(j["hist"]) == 1
    (ts, tu, tn, tt), (js, ju, jn, jt) = t["hist"][0], j["hist"][0]
    assert (tu, tn, tt) == (ju, jn, jt)
    for k in ("counts", "mins", "maxs"):
        np.testing.assert_array_equal(ts[k], js[k], err_msg=k)
    assert ts["counts"].sum() > 0


def test_eval_modified_figure_data_is_jax_bitwise(sae_figures):
    """Epochs 0 and 1 draw the channel-frequency histogram; the last eval
    the top and small grids of 5 images for 10 units, then 100-bin
    histograms filled by one more pass over the eval data."""
    _same_capture(sae_figures["tcap"], sae_figures["jcap"])
    assert [e for _, e in sae_figures["tcap"]["freq"]] == [0, 1]
    assert sae_figures["calls"] == 3 * 2  # two evals and the histogram pass, 2 batches each


def test_eval_original_figure_data_is_jax_bitwise(original_figures):
    _same_capture(original_figures["tcap"], original_figures["jcap"])
    assert original_figures["tcap"]["hist"][0][3].endswith("(conv2, original), epoch 0")


def _pngs(folder: str) -> dict:
    out = {}
    for root, _, files in os.walk(folder):
        for f in files:
            if f.endswith(".png"):
                p = os.path.join(root, f)
                out[os.path.relpath(p, folder)] = _size(p)
    return out


@pytest.mark.parametrize("which", ["sae_figures", "original_figures"])
def test_figure_files_match_jax_and_tiles_read_back(which, request):
    runs = request.getfixturevalue(which)
    tp, jp = _pngs(runs["tdir"]), _pngs(runs["jdir"])
    assert tp == jp
    assert len(tp) == (5 if which == "sae_figures" else 4)
    for images, values, name, _ in runs["tcap"]["topk"]:
        (rel,) = [r for r in tp if r.endswith(name)]
        assert _check_tiles(os.path.join(runs["tdir"], rel), images, values) == 50


def test_faithfulness_png_size_matches_jax(tmp_path):
    rows = [dict(variant=v, feature_node_threshold=t, error_node_threshold=t,
                 faithfulness_sae_errors_zero_ablated=0.1 * i,
                 faithfulness_sae_errors_mean_ablated="" if i == 1 else 0.2 * i,
                 faithfulness=0.3 * i, m_C=1, m_empty=0, m_M=2)
            for i, t in enumerate((1e-3, 1e-2, 1e-1)) for v in ("sae", "model")]
    path = str(tmp_path / "faithfulness.csv")
    t_ie.store_faithfulness(path, rows)
    jp = j_ie.plot_faithfulness(path, str(tmp_path / "j.png"))
    tp = t_ie.plot_faithfulness(path, str(tmp_path / "t.png"))
    assert _size(tp) == _size(jp) == (3000, 750)


# ---------------------------------------------------------------------------
# eval_tools/figures.py
# ---------------------------------------------------------------------------

@pytest.fixture(scope="module")
def mis_csv(tmp_path_factory):
    """A per-unit MIS CSV of two layers and a bottleneck variant, with empty
    confidences."""
    rng = np.random.default_rng(11)
    path = str(tmp_path_factory.mktemp("mis") / "mis.csv")
    with open(path, "w", newline="") as f:
        w = csv.writer(f)
        w.writerow(["unit_idx", "layer_name", "MIS", "MIS_confidence"])
        for layer in ("mixed3a", "mixed3a_bottleneck", "mixed4a"):
            for u in range(12):
                conf = "" if u in (4, 9) else f"{rng.uniform():.6f}"
                w.writerow([u, layer, f"{rng.uniform():.6f}", conf])
    return path


@pytest.mark.parametrize("layer", [None, "mixed3a", "mixed4"])
def test_mis_adjustments_match_jax(mis_csv, layer):
    dead_mask = np.zeros(24 if layer is None else 12, bool)
    dead_mask[[1, 4, 7]] = True
    for dead in (dead_mask, np.array([2, 3]), np.zeros(0, np.int64)):
        got = t_fig.mis_adjusted_for_dead_units(mis_csv, dead, layer)
        want = j_fig.mis_adjusted_for_dead_units(mis_csv, dead, layer)
        assert got.keys() == want.keys()
        for k in want:
            if want[k] is None or got[k] is None:
                assert got[k] == want[k], k
            else:
                np.testing.assert_allclose(got[k], want[k], rtol=1e-12, err_msg=k)
        np.testing.assert_allclose(t_fig.adjusted_median_mis(mis_csv, dead, layer),
                                   j_fig.adjusted_median_mis(mis_csv, dead, layer), rtol=1e-12)
    drops = {1: np.array([0, 5]), 3: np.array([2])}
    got = t_fig.mis_adjusted_series({1: mis_csv, 2: mis_csv, 3: mis_csv}, drops, layer)
    want = j_fig.mis_adjusted_series({1: mis_csv, 2: mis_csv, 3: mis_csv}, drops, layer)
    assert got.keys() == want.keys()
    np.testing.assert_allclose(list(got.values()), list(want.values()), rtol=1e-12)


def test_class_counts_match_jax():
    labels = np.random.default_rng(2).integers(0, 7, 200)
    np.testing.assert_array_equal(t_fig.class_counts(labels, 9), j_fig.class_counts(labels, 9))


_FEATS = {f"mixed{name}": np.random.default_rng(i).normal(size=40).astype(np.float32) * 1e-3
          for i, name in enumerate(("3a", "3b", "4a", "4b", "4c"))}
PLOTS = {
    "ie_histograms": lambda m, p: m.plot_ie_histograms(_FEATS, p),
    "node_count": lambda m, p: m.plot_node_count_vs_threshold(_FEATS, [1e-5, 1e-4, 1e-3], p),
    "mis_over_epochs": lambda m, p: m.plot_mis_over_epochs(
        {"a": {1: 0.7, 2: 0.8}, "b": {1: 0.75, 3: 0.9}}, p, baseline=0.834),
    "pixel_vs_channel": lambda m, p: m.plot_pixel_vs_channel_sparsity(
        {1: 0.3, 2: 0.2}, {1: 0.5, 2: 0.4}, p),
    "class_counts": lambda m, p: m.plot_class_counts(np.arange(30) % 6, 6, p),
}


@pytest.mark.parametrize("name", list(PLOTS))
def test_figures_sizes_match_jax(name, tmp_path):
    jp = PLOTS[name](j_fig, str(tmp_path / "j.png"))
    tp = PLOTS[name](t_fig, str(tmp_path / "t.png"))
    assert _size(tp) == _size(jp)


# ---------------------------------------------------------------------------
# eval_tools/report.py and the CLI's --feature_report
# ---------------------------------------------------------------------------

def _blank_images(page: str) -> str:
    page = re.sub(r"data:image/png;base64,[A-Za-z0-9+/=]*", "data:image/png;base64,", page)
    return page.replace("sparse_vision_tpu_torch eval_tools", "sparse_vision_tpu eval_tools")


@pytest.fixture(scope="module")
def report_folder(sae_figures, mis_csv):
    """The port's sae_mlp run folder with a per-unit MIS CSV of its last
    epoch and a circuit folder (node and edge IE, faithfulness.png)."""
    tpipe = sae_figures["tpipe"]
    ev = tpipe.paths["evaluation_results"]
    os.makedirs(os.path.join(ev, "MIS"), exist_ok=True)
    with open(os.path.join(ev, "MIS", f"{tpipe.run_id}_mis_epoch_1.csv"), "w",
              newline="") as f:
        w = csv.writer(f)
        w.writerow(["unit_idx", "MIS", "MIS_confidence"])
        for u in range(0, tpipe.num_units, 3):
            w.writerow([u, 0.5 + u / 1000, 0.25 + u / 2000])
    ie_dir = tpipe.paths["ie_related_quantities"]
    os.makedirs(ie_dir, exist_ok=True)
    np.savez(os.path.join(ie_dir, "node_ie.npz"),
             **{f"features:{k}": v for k, v in _FEATS.items()})
    rng = np.random.default_rng(3)
    np.savez(os.path.join(ie_dir, "edge_ie.npz"),
             **{"mixed3a->mixed3b": rng.normal(size=(5, 5)), "idx:mixed3a": np.arange(4),
                "idx:mixed3b": np.arange(10, 14)})
    path = os.path.join(ie_dir, "faithfulness.csv")
    t_ie.store_faithfulness(path, [dict(variant="sae", feature_node_threshold=1e-3,
                                        error_node_threshold=1e-3, faithfulness=0.5)])
    t_ie.plot_faithfulness(path, os.path.join(ie_dir, "faithfulness.png"))
    return tpipe, ev, ie_dir


def test_feature_report_matches_jax(report_folder, tmp_path):
    tpipe, ev, ie_dir = report_folder
    jp = j_report.write_feature_report(ev, tpipe.run_id, str(tmp_path / "j.html"),
                                       ie_dir=ie_dir)
    tp = t_report.write_feature_report(ev, tpipe.run_id, str(tmp_path / "t.html"),
                                       ie_dir=ie_dir)
    with open(jp) as f:
        want = f.read()
    with open(tp) as f:
        got = f.read()
    assert _blank_images(got) == _blank_images(want)
    for h2 in ("Run metrics", "Channel activation frequency", "Top-k activating samples",
               "Bottom-k activating samples", "Per-unit activation histograms",
               "Node IE distributions", "Top nodes by |IE|", "Top edges by |IE|",
               "Faithfulness vs threshold", "MIS scored"):
        assert h2 in got, h2
    # the embedded figures are the run's own files
    with open(os.path.join(ev, "activation_histograms", f"{tpipe.run_id}_epoch_1.png"),
              "rb") as f:
        assert base64.b64encode(f.read()).decode() in got


def test_cli_writes_the_feature_report(report_folder, tmp_path, capsys):
    tpipe, _, _ = report_folder
    out = str(tmp_path / "report.html")
    got = cli.main(["--feature_report", out, "--config", tpipe.cfg.to_json()])
    assert got == {"feature_report": out} and os.path.getsize(out) > 0
    assert json.loads(capsys.readouterr().out.strip().splitlines()[-1]) == got
