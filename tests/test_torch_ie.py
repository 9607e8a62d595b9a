"""Circuit discovery as a whole: the JAX Pipeline and the port's Pipeline run
``compute_ie`` "1", "2", "3" and "40" (each a Pipeline.run of its own, as the CLI
runs them) on GoogLeNet at 32 px over the eight registry layers, each layer's
SAE loaded through its package's registry from a checkpoint that this test
writes in both formats from the same arrays. The .npz and CSV artifacts are
held against each other; a JAX-written averages.npz / node_ie.npz drives the
port's modes 3 and 4 to JAX's result; the registry contract, the label table
and fault C5 (the translated label 1000 outside the 1,000-logit head) are
checked on their own.

Sizes: 32 train images at 32 px (mixed3a 4 x 4 x 256 ... mixed5b 1 x 1 x 1024),
batches of 16, 4 top features per layer, cotangent chunks of 2; the registry
widths (2,048 ... 4,096 latents) with non-zero b_enc / b_dec. The data is
make_synthetic(seed=3), whose first 512 labels hold no class 543 (so this is
not the C5 case); the C5 test uses seed 0, whose image 17 is of class 543.

The backbone is the JAX pipeline's random GoogLeNet with its conv weights
scaled by sqrt(6): at torch's default init (U(+-1/sqrt(fan_in))) the signal
shrinks ~6x per conv layer, every image gets the same logits, and the
faithfulness denominator m(M) - m(empty) is 0. Both packages get the scaled
weights (convert.backbone_from_jax).

Tolerances: the two frameworks' f32 convolutions differ by ~1e-6 relative
(test_torch_googlenet.py), which the passes carry; an array's atol is a
fraction of its largest magnitude (an average or IE near zero keeps the
rounding of the large ones): averages rtol 1e-4 / atol 1e-5 of the largest,
dead masks exactly, sparsity rtol 1e-5; node and edge IE rtol 1e-3 / atol
1e-5 of the largest (products of two gradients); faithfulness losses rtol
1e-6 (measured: 1.9e-7 at most) and their ratios within that carried through
the ratio. That ratio tolerance is only as fine as m(M) - m(empty) is large:
measured, m(M) - m(empty) is -5.0e-3 of a 7.39 loss (6.77e-4 of it, in both
packages), so faithfulness 1 is held to 5.9e-3; the test asserts at least
MIN_GAP of the loss. Where one package reads the other's files, the
top-feature indices are equal.

Edge IE through tied maxima: at 32 px the inception pool branch (3 x 3,
stride 1, padding 1) covers the whole 2 x 2 map of mixed4a..mixed4e, so its
branch of mixed4b..mixed4e holds four equal values per channel, and the next
block's pool branch takes the max of them. The splice recon + (x - recon)
returns x up to one rounding, which breaks those ties by rounding noise, and
the gradient goes to whichever copy wins: the pairs mixed4b..mixed4e -> next
are a subgradient choice in both packages. Measured on the port alone, the
splice written as x + (recon - recon.detach()) (the same value and gradient,
no rounding) moves those four matrices by up to 2.7% of their largest entry
and leaves the other four equal. Measured against JAX, the port's own chain and
its mode 3 from JAX's files put those four pairs 1.35e-2 (mixed4b), 2.79e-3
(mixed4c), 1.83e-2 (mixed4d) and 1.02e-2 (mixed4e) of the matrix's largest
entry from JAX's, and the other four within 2.5e-6. The tied pairs are held at
TIED_TOL, just above the largest, the others at IE_TOL.
"""

import csv
import dataclasses
import math
import os
import shutil

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from sparse_vision_tpu.config import RunConfig as JConfig
from sparse_vision_tpu.data.datasets import make_synthetic as j_synth
from sparse_vision_tpu.interp import ie as j_ie
from sparse_vision_tpu.interp import registry as j_reg
from sparse_vision_tpu.models.backbone import layer_dimensions as j_layer_dimensions
from sparse_vision_tpu.train import checkpoint as j_ckpt
from sparse_vision_tpu.train.pipeline import Pipeline as JPipeline
from sparse_vision_tpu_torch import convert
from sparse_vision_tpu_torch import cli
from sparse_vision_tpu_torch.config import RunConfig as TConfig
from sparse_vision_tpu_torch.data.datasets import make_synthetic as t_synth
from sparse_vision_tpu_torch.interp import ie as t_ie
from sparse_vision_tpu_torch.interp import registry as t_reg
from sparse_vision_tpu_torch.train import checkpoint as t_ckpt
from sparse_vision_tpu_torch.train.pipeline import Pipeline as TPipeline
from sparse_vision_tpu_torch.utils.paths import folder_paths
from test_torch_pipeline import quick_jax_pipeline

SIZE = (32, 32, 3)
MODES = ("1", "2", "3", "40")
CFG = dict(model_name="inceptionv1", dataset_name="imagenet", sae_layer="mixed3a",
           training=False, sae_batch_size=16, ie_top_features=4, ie_cotangent_chunk=2,
           seed=3)
GAIN = math.sqrt(6.0)  # Kaiming's ReLU gain over torch's default uniform bound
AVG_TOL = (1e-4, 1e-5)  # rtol, atol as a fraction of the array's largest magnitude
IE_TOL = (1e-3, 1e-5)
TIED = ("mixed4b", "mixed4c", "mixed4d", "mixed4e")  # upstream layers of the tied pairs
TIED_TOL = (0, 0.025)
LOSS_RTOL = 1e-6
MIN_GAP = 5e-4  # least |m(M) - m(empty)| / |m(M)|, so the ratios are resolved


@pytest.fixture(scope="module", autouse=True)
def one_torch_thread():
    """The port's passes here are small: one intra-op thread is as fast alone,
    and much faster when the test workers oversubscribe the cores."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _datasets(make, seed=3, n=32):
    tr = make(num_samples=n, img_size=SIZE, num_classes=1000, seed=seed)
    return tr, tr, tr.category_names, SIZE


def _scaled(tree):
    return {k: _scaled(v) if isinstance(v, dict) else (v * GAIN if k == "w" and v.ndim == 4 else v)
            for k, v in tree.items()}


def _registry_saes(widths: dict) -> dict:
    """sae_mlp params at each registry layer's width, non-zero biases, numpy."""
    out = {}
    for i, (name, c) in enumerate(widths.items()):
        h = c * j_reg.LAYER_SAE_CONFIGS[name].expansion_factor
        rng = np.random.default_rng(100 + i)
        w_enc = rng.uniform(-1, 1, (c, h)).astype(np.float32) * np.sqrt(6 / c, dtype=np.float32)
        w_dec = rng.standard_normal((h, c)).astype(np.float32)
        w_dec /= np.linalg.norm(w_dec, axis=1, keepdims=True)
        out[name] = {"W_enc": w_enc, "W_dec": w_dec,
                     "b_enc": (0.1 * rng.standard_normal(h)).astype(np.float32),
                     "b_dec": (0.1 * rng.standard_normal(c)).astype(np.float32)}
    return out


def _write_checkpoints(saes: dict, jroot: str, troots: tuple) -> None:
    """Each layer's checkpoint at its registry epoch, in the JAX format under
    ``jroot`` and in the port's under each of ``troots``."""
    for name, p in saes.items():
        e = j_reg.LAYER_SAE_CONFIGS[name].checkpoint_epoch
        h = p["b_enc"].shape[0]
        j_ckpt.save_checkpoint(
            j_reg.layer_ckpt_dir(jroot, name), e,
            {"params": {k: jnp.asarray(v) for k, v in p.items()}, "opt_state": {},
             "step": jnp.int32(0), "dead_acc": jnp.ones(h, bool)})
        for troot in troots:
            t_ckpt.save_checkpoint(
                t_reg.layer_ckpt_dir(troot, name), e,
                {"params": convert.sae_params_from_jax(p), "opt_state": {}, "step": 0,
                 "dead_acc": torch.ones(h, dtype=torch.bool)})


def _jpipe(cfg: JConfig, backbone):
    with quick_jax_pipeline():
        p = JPipeline(cfg, datasets=_datasets(j_synth, cfg.seed))
    if backbone is not None:
        p.frozen_params = backbone
    return p


def _tpipe(cfg: TConfig, backbone):
    return TPipeline(cfg, device="cpu", datasets=_datasets(t_synth, cfg.seed), backbone=backbone)


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    jdir, tdir, xdir = (str(tmp_path_factory.mktemp(n)) for n in ("jax", "torch", "cross"))
    jcfg = JConfig(**CFG, directory_path=jdir)
    first = _jpipe(dataclasses.replace(jcfg, compute_ie="1"), None)
    jback = _scaled(first.frozen_params)
    tback = convert.backbone_from_jax(jax.device_get(jback), jax.device_get(first.net_state))
    dims = j_layer_dimensions(first.net, "imagenet")
    widths = {n: dims[n][-1] for n in j_reg.CIRCUIT_LAYERS}
    saes = _registry_saes(widths)
    tcfg = TConfig(**CFG, directory_path=tdir)
    troot = _tpipe(tcfg, tback).paths["checkpoints"]
    xcfg = TConfig(**CFG, directory_path=xdir)
    _write_checkpoints(saes, first.paths["checkpoints"],
                       (troot, _tpipe(xcfg, tback).paths["checkpoints"]))

    out = {"saes": saes, "widths": widths, "roots": (first.paths["checkpoints"], troot)}
    for flag in MODES:
        jp = _jpipe(dataclasses.replace(jcfg, compute_ie=flag), jback)
        out[("j", flag)] = jp.run()
        tp = _tpipe(dataclasses.replace(tcfg, compute_ie=flag), tback)
        out[("t", flag)] = tp.run()
    out["jdir"] = jp.paths["ie_related_quantities"]
    out["tdir"] = tp.paths["ie_related_quantities"]
    # the port's modes 3 and 4 from the JAX package's averages and node IE
    xp = _tpipe(dataclasses.replace(xcfg, compute_ie="3"), tback)
    out["xdir"] = xp.paths["ie_related_quantities"]
    os.makedirs(out["xdir"], exist_ok=True)
    for f in ("averages.npz", "node_ie.npz"):
        shutil.copy(os.path.join(out["jdir"], f), out["xdir"])
    xp.run()
    _tpipe(dataclasses.replace(xcfg, compute_ie="40"), tback).run()
    out["tback"], out["tcfg"] = tback, tcfg
    return out


def _close(got, want, tol, msg):
    rtol, atol_frac = tol
    np.testing.assert_allclose(got, want, rtol=rtol, atol=atol_frac * np.abs(want).max(),
                               err_msg=msg)


def _npz(path) -> dict:
    with np.load(path) as z:
        return {k: z[k] for k in z.files}


def _rows(path) -> list:
    with open(path) as f:
        return list(csv.DictReader(f))


def test_registry_saes_load_equal_through_both_registries(runs):
    jroot, troot = runs["roots"]
    for name, c in runs["widths"].items():
        j = j_reg.load_frozen_sae(name, c, checkpoint_dir=j_reg.layer_ckpt_dir(jroot, name))
        t = t_reg.load_frozen_sae(name, c, checkpoint_dir=t_reg.layer_ckpt_dir(troot, name),
                                  device="cpu")
        assert (t.model_name, t.expansion_factor) == (j.model_name, j.expansion_factor)
        assert set(t.params) == set(j.params)
        for k, v in j.params.items():
            np.testing.assert_array_equal(t.params[k].numpy(), np.asarray(v), err_msg=k)


def test_averages_and_their_csvs_match_jax(runs):
    j = _npz(os.path.join(runs["jdir"], "averages.npz"))
    t = _npz(os.path.join(runs["tdir"], "averages.npz"))
    assert set(t) == set(j)
    for k, want in j.items():
        assert t[k].shape == want.shape and t[k].dtype == want.dtype, k
        if k.startswith("dead:"):
            np.testing.assert_array_equal(t[k], want, err_msg=k)
        elif k.startswith("sparsity:"):
            np.testing.assert_allclose(t[k], want, rtol=1e-5, err_msg=k)
        else:
            _close(t[k], want, AVG_TOL, k)
    assert j["enc:mixed3a"].shape == (4, 4, 2048)
    for f in ("perc_dead_units.csv", "sparsity.csv"):
        jr, tr = _rows(os.path.join(runs["jdir"], f)), _rows(os.path.join(runs["tdir"], f))
        assert [r["Layer"] for r in tr] == [r["Layer"] for r in jr] == list(j_reg.CIRCUIT_LAYERS)
        for a, b in zip(tr, jr):
            col = [c for c in a if c != "Layer"][0]
            np.testing.assert_allclose(float(a[col]), float(b[col]), rtol=1e-5, err_msg=f)


def test_node_ie_matches_jax(runs):
    j = _npz(os.path.join(runs["jdir"], "node_ie.npz"))
    t = _npz(os.path.join(runs["tdir"], "node_ie.npz"))
    assert set(t) == set(j)
    for k, want in j.items():
        assert t[k].shape == want.shape, k
        _close(t[k], want, IE_TOL, k)
        assert np.isfinite(t[k]).all() and np.abs(t[k]).max() > 0, k


@pytest.mark.parametrize("which", ["tdir", "xdir"])
def test_edge_ie_matches_jax(runs, which):
    """The port's own chain (tdir), and the port's mode 3 from the JAX package's
    averages.npz and node_ie.npz (xdir)."""
    j = _npz(os.path.join(runs["jdir"], "edge_ie.npz"))
    t = _npz(os.path.join(runs[which], "edge_ie.npz"))
    assert set(t) == set(j)
    for k, want in j.items():
        assert t[k].shape == want.shape, k
        if k.startswith("idx:"):
            np.testing.assert_array_equal(t[k], want, err_msg=k)
        else:
            _close(t[k], want, TIED_TOL if k in TIED else IE_TOL, k)
            assert np.isfinite(t[k]).all() and np.abs(t[k]).max() > 0, k
    assert j["mixed3a"].shape == (5, 5) and j["mixed5b"].shape == (5, 1)


@pytest.mark.parametrize("which", ["tdir", "xdir"])
def test_faithfulness_csv_matches_jax(runs, which):
    jr = _rows(os.path.join(runs["jdir"], "faithfulness.csv"))
    tr = _rows(os.path.join(runs[which], "faithfulness.csv"))
    assert [r["variant"] for r in tr] == [r["variant"] for r in jr] == ["model", "sae"]
    for a, b in zip(tr, jr):
        assert list(a) == t_ie.FAITHFULNESS_COLUMNS
        m = {k: float(b[k]) for k in ("m_C", "m_M", "m_empty")}
        denom, top = abs(m["m_M"] - m["m_empty"]), max(map(abs, m.values()))
        assert denom >= MIN_GAP * abs(m["m_M"]), (b["variant"], m)
        for k, v in b.items():
            if k == "variant" or v == "":
                assert a[k] == v, k
            elif k.startswith("faithfulness"):
                tol = LOSS_RTOL * top * (2 + 2 * abs(float(v))) / denom
                assert abs(float(a[k]) - float(v)) <= tol, (k, a[k], v)
            else:
                np.testing.assert_allclose(float(a[k]), float(v), rtol=LOSS_RTOL, err_msg=k)


def test_run_ie_returns_what_the_jax_run_returns(runs):
    tavg, jnode, tedges, trows = (runs[("t", f)] for f in ("1", "2", "3", "40"))
    assert set(tavg.enc) == set(j_reg.CIRCUIT_LAYERS) == set(jnode.features)
    assert set(tedges) == set(runs[("j", "3")])
    assert [r["variant"] for r in trows] == ["sae", "model"]
    assert trows[0]["feature_node_threshold"] == t_ie.FAITHFULNESS_THRESHOLDS[0] == 1e-10


def test_cli_runs_a_mode_and_names_its_files(runs, tmp_path, capsys, monkeypatch):
    import json

    import sparse_vision_tpu_torch.train.pipeline as pipeline_mod

    cfg = dataclasses.replace(runs["tcfg"], compute_ie="41", directory_path=str(tmp_path))
    folder = folder_paths(cfg)["ie_related_quantities"]
    os.makedirs(folder)
    for f in ("averages.npz", "node_ie.npz"):
        shutil.copy(os.path.join(runs["tdir"], f), folder)
    # the CLI's Pipeline loads the synthetic data: the 32 px stand-in here
    monkeypatch.setattr(pipeline_mod, "load_data",
                        lambda c, class_filter=None: _datasets(t_synth, c.seed))
    out = cli.main(["--run_pipeline", "--config", cfg.to_json(), "--device", "cpu"])
    assert out == {"compute_ie": "41", "wrote": [os.path.join(folder, f) for f in (
        "faithfulness.csv", "faithfulness.png")]}
    from PIL import Image

    with Image.open(out["wrote"][1]) as im:  # the JAX figure's 20 x 5 in at 150 dpi
        assert im.size == (3000, 750)
    assert json.loads(capsys.readouterr().out.strip().splitlines()[-1]) == out
    rows = _rows(out["wrote"][0])
    assert [float(r["feature_node_threshold"]) for r in rows] == [1e-9, 1e-9]


def test_registry_checkpoint_contract(tmp_path):
    """layer_ckpt_dir names exactly the directory the port's Pipeline saves a
    registry-hyperparameter run into (the same name as the JAX package's), and
    load_frozen_sae restores the registry's epoch there, else the newest."""
    reg = t_reg.LAYER_SAE_CONFIGS["mixed3a"]
    cfg = dataclasses.replace(t_reg.registry_config("mixed3a"), model_name="inceptionv1",
                              dataset_name="imagenet", directory_path=str(tmp_path),
                              use_activation_cache=True)
    p = _tpipe(cfg, None)
    root = p.paths["checkpoints"]
    assert t_reg.layer_ckpt_dir(root, "mixed3a") == p._sae_ckpt_dir()
    assert t_reg.layer_ckpt_dir(root, "mixed3a") == j_reg.layer_ckpt_dir(root, "mixed3a")
    for name in j_reg.LAYER_SAE_CONFIGS:
        assert (t_reg.layer_ckpt_dir(root, name, "gated_sae")
                == j_reg.layer_ckpt_dir(root, name, "gated_sae"))
    assert t_reg.LAYER_SAE_CONFIGS == {
        k: t_reg.LayerSAEConfig(**dataclasses.asdict(v)) for k, v in j_reg.LAYER_SAE_CONFIGS.items()}
    assert t_reg.CIRCUIT_LAYERS == j_reg.CIRCUIT_LAYERS

    width = 16
    h = width * reg.expansion_factor
    g = torch.Generator().manual_seed(42)
    trained = {"W_enc": torch.randn(width, h, generator=g), "b_enc": torch.randn(h, generator=g),
               "W_dec": torch.randn(h, width, generator=g), "b_dec": torch.randn(width, generator=g)}
    tree = {"params": trained, "opt_state": {}, "step": 7, "dead_acc": torch.ones(h, dtype=bool)}
    ckpt_dir = p._sae_ckpt_dir()
    t_ckpt.save_checkpoint(ckpt_dir, reg.checkpoint_epoch, tree)
    t_ckpt.save_checkpoint(ckpt_dir, reg.checkpoint_epoch + 5,
                           {**tree, "params": {k: v + 1 for k, v in trained.items()}})
    frozen = t_reg.load_frozen_sae("mixed3a", width, checkpoint_dir=ckpt_dir, device="cpu")
    assert frozen.expansion_factor == reg.expansion_factor
    for k, v in trained.items():  # the registry's epoch, not the newer one
        assert torch.equal(frozen.params[k], v), k
    os.remove(os.path.join(ckpt_dir, f"epoch_{reg.checkpoint_epoch}"))
    newest = t_reg.load_frozen_sae("mixed3a", width, checkpoint_dir=ckpt_dir, device="cpu")
    assert torch.equal(newest.params["W_dec"], trained["W_dec"] + 1)
    fresh = t_reg.load_frozen_sae("mixed3a", width, device="cpu")
    assert fresh.params["W_enc"].shape == (width, h)


def test_label_table_matches_jax():
    from sparse_vision_tpu.data import labels as j_labels
    from sparse_vision_tpu_torch.data import labels as t_labels

    want = np.asarray(j_labels.torch_to_tf_label_table())
    table = t_labels.torch_to_tf_label_table()
    assert table.dtype == torch.int32
    np.testing.assert_array_equal(table.numpy(), want)
    assert want.min() == 1 and want.max() == 1000 and int(want[543]) == 1000
    labels = np.random.default_rng(0).integers(0, 1000, 64).astype(np.int32)
    np.testing.assert_array_equal(
        t_labels.remap_torch_to_tf_labels(torch.from_numpy(labels)).numpy(),
        np.asarray(j_labels.remap_torch_to_tf_labels(jnp.asarray(labels))))


def test_c5_class_543_gives_nan_in_jax_and_a_value_error_in_the_port(tmp_path):
    """Fault C5: class 543 translates to GoogLeNet label 1000, outside the
    1,000-logit head. make_synthetic(seed=0)'s image 17 is of class 543, so its
    one batch of 32 is the C5 case. In the JAX node-IE pass the loss is NaN, and
    image 17's tap gradients are exactly zero (the out-of-range gather's vjp
    drops them), so the node IE comes out finite without that image; the port
    raises a ValueError naming the class before the batch reaches a pass."""
    from sparse_vision_tpu.interp.patching import loss_and_tap_grads

    cfg = dict(CFG, seed=0, sae_batch_size=32)
    assert int(t_synth(num_samples=32, img_size=SIZE, num_classes=1000, seed=0).labels[17]) == 543
    jp = _jpipe(JConfig(**cfg, directory_path=str(tmp_path / "j")), None)
    eng = j_ie.build_engine(jp)
    batches = list(j_ie._batches(jp))
    assert len(batches) == 1 and int(batches[0][1][17]) == 1000
    loss, _, grads = jax.jit(lambda p, st, x, y: loss_and_tap_grads(
        eng.net, p, st, x, y, eng.criterion, eng.layers))(eng.params, eng.state, *batches[0])
    assert np.isnan(float(loss))
    for n in eng.layers:
        g = np.asarray(grads[n])
        assert not g[17].any() and g[16].any() and np.isfinite(g).all(), n

    tp = _tpipe(TConfig(**cfg, compute_ie="1", directory_path=str(tmp_path / "t")), None)
    teng = t_ie.build_engine(tp)
    b = next(tp.train_ds.batches(32, shuffle=False))
    avgs = teng.compute_averages([(torch.from_numpy(b.images), None)])
    with pytest.raises(ValueError, match=r"class 543 translates to GoogLeNet label 1000"):
        teng.compute_node_ie(t_ie._batches(tp), avgs)
    with pytest.raises(ValueError, match="class 543"):
        tp.run()  # every mode reads its batches the same way
