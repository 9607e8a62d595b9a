"""The port's original-model training and eval against the JAX package's:
the model optimizers over a nested parameter tree, the model train and eval
steps, Pipeline.run with original_model=True (two epochs, and a resume after
the first), its guards, the model_weights restore of every Pipeline, and the
original-model MIS collection then scoring. Inputs come from numpy seeds; the
JAX weights reach the port through convert.backbone_from_jax.

Tolerances:
- sgd and sgd_w_scheduler: the same f32 operations in the same order on both
  sides, so parameters within 1e-6 relative (f32 rounding of the step-LR
  factor 0.1 ** (epoch // 7) in two pow implementations).
- Adam: rtol 1e-5 and atol 1e-6 at lr 1e-3, as tests/test_torch_optim.py
  (b2 = 0.9999 makes 1 - b2 ** count cancel in f32: one ulp of b2 ** count
  moves an update of size lr by ~6e-4 of itself).
- Steps and Pipelines: the frameworks' f32 matmuls and convolutions sum in
  other orders (~1e-7 relative for the MLP, ~1e-6 through convolutions), and
  training carries that forward. Losses and eval means rtol 1e-4 (MODEL_RTOL);
  parameters and batch-norm statistics rtol 1e-4 with atol 1e-5 of each
  array's largest magnitude (PARAMS_RTOL, PARAMS_ATOL_FRAC). Under Adam each
  weight may also move by the ulp of b2 ** count above, ADAM_ULP_SHARE of lr,
  at every step: atol adds that times lr times the steps taken (_adam_atol).
  And a gradient entry that cancels to below Adam's eps (1e-8) moves its
  weight by lr * g / eps: the ~1e-9 by which the frameworks' f32 sums of such
  an entry differ then moves the weight by up to ~lr / 10 a step (the rms
  crosscoder's case, tests/test_torch_pipeline.py): Adam runs hold every
  weight within one step, lr, and at most ADAM_OFF weights past the bound
  above (_close_params). Accuracy counts are compared exactly.
- Top-k files: the sample indices exactly (fc1's 16 channels over 512 samples
  hold no near-ties at these weights), the frequencies rtol 1e-6.
"""

import os

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from sparse_vision_tpu.config import RunConfig as JConfig
from sparse_vision_tpu.data.datasets import make_synthetic as j_synth
from sparse_vision_tpu.models import backbone as j_backbone
from sparse_vision_tpu.ops import losses as j_losses
from sparse_vision_tpu.ops import optim as joptim
from sparse_vision_tpu.train import checkpoint as j_ckpt
from sparse_vision_tpu.train import steps as j_steps
from sparse_vision_tpu.train.pipeline import Pipeline as JPipeline
from sparse_vision_tpu_torch import convert
from sparse_vision_tpu_torch.config import RunConfig as TConfig
from sparse_vision_tpu_torch.data.datasets import make_synthetic as t_synth
from sparse_vision_tpu_torch.models import backbone as t_backbone
from sparse_vision_tpu_torch.ops import losses as t_losses
from sparse_vision_tpu_torch.ops import optim as toptim
from sparse_vision_tpu_torch.train import checkpoint as t_ckpt
from sparse_vision_tpu_torch.train import steps as t_steps
from sparse_vision_tpu_torch.train.pipeline import Pipeline as TPipeline
from test_torch_pipeline import _Recorder, quick_jax_pipeline

MODEL_RTOL = 1e-4
PARAMS_RTOL, PARAMS_ATOL_FRAC = 1e-4, 1e-5
ADAM_ULP_SHARE = 6e-4
ADAM_OFF = 8  # weights of an Adam run past the SGD bound (measured: at most 1)
F64_RTOL = 1e-6  # both frameworks in f64: rtol, and atol of each array's largest


def _adam_atol(opt: str, lr: float, steps: int) -> float:
    """The absolute bound Adam's b2 ** count adds to a weight (docstring)."""
    return ADAM_ULP_SHARE * lr * steps if opt == "adam" else 0.0


def _close_params(got: dict, want: dict, opt: str, lr: float, steps: int, what: str) -> None:
    """The parameters at PARAMS_RTOL / PARAMS_ATOL_FRAC; under Adam every
    weight within lr and at most ADAM_OFF past that bound (docstring)."""
    if opt != "adam":
        return _close_tree(got, want, PARAMS_RTOL, PARAMS_ATOL_FRAC, what)
    off = 0
    for path, w in _leaves(want):
        w, g = np.asarray(w), _get(got, path).detach().cpu().numpy()
        np.testing.assert_allclose(g, w, rtol=0, atol=lr, err_msg=f"{what} {'/'.join(path)}")
        atol = PARAMS_ATOL_FRAC * np.abs(w).max() + _adam_atol(opt, lr, steps)
        off += int((np.abs(g - w) > atol + PARAMS_RTOL * np.abs(w)).sum())
    assert off <= ADAM_OFF, f"{what}: {off} weights past the bound"


@pytest.fixture(scope="module", autouse=True)
def one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _leaves(tree, path=()):
    for k, v in tree.items():
        if isinstance(v, dict):
            yield from _leaves(v, path + (k,))
        else:
            yield path + (k,), v


def _get(tree, path):
    for k in path:
        tree = tree[k]
    return tree


def _close_tree(got: dict, want: dict, rtol: float, atol_frac: float, what: str = "",
                atol: float = 0.0) -> None:
    """Every leaf of ``want`` (numpy or tensors in the port's layout) against
    ``got``'s, at rtol, and atol_frac of the leaf's largest magnitude plus
    ``atol``."""
    pairs = list(_leaves(want))
    assert len(pairs) == len(list(_leaves(got))), what
    for path, w in pairs:
        w = np.asarray(w)
        g = _get(got, path)
        g = g.detach().cpu().numpy() if isinstance(g, torch.Tensor) else np.asarray(g)
        np.testing.assert_allclose(g, w, rtol=rtol,
                                   atol=atol_frac * max(np.abs(w).max(), 1e-30) + atol,
                                   err_msg=f"{what} {'/'.join(path)}")


# ---------------------------------------------------------------------------
# the model optimizers over a nested tree
# ---------------------------------------------------------------------------

def _tree(rng):
    return {"conv1": {"w": rng.normal(size=(3, 3, 2, 4)).astype(np.float32),
                      "b": rng.normal(size=(4,)).astype(np.float32)},
            "fc": {"w": rng.normal(size=(5, 3)).astype(np.float32)}}


def _torch_tree(tree):
    return {k: _torch_tree(v) if isinstance(v, dict) else torch.from_numpy(np.array(v))
            for k, v in tree.items()}


@pytest.mark.parametrize("name", ["sgd", "sgd_w_scheduler", "adam"])
def test_model_optimizers_match_optax_on_a_nested_tree(name):
    """8 steps with the same gradients: for sgd_w_scheduler the epoch counter
    starts at 5 and advances after every second step, so the LR drops by 10x
    at epoch 7 (across the StepLR boundary) and the momentum trace carries
    over it; advance_epoch leaves the other optimizers' states as they are."""
    rng = np.random.default_rng(0)
    params = _tree(rng)
    grads = [_tree(rng) for _ in range(8)]
    lr = 1e-3 if name == "adam" else 0.05  # Adam at tests/test_torch_optim.py's bound
    jtx, ttx = joptim.get_optimizer(name, lr), toptim.get_optimizer(name, lr)
    jp, tp = jax.tree.map(jnp.asarray, params), _torch_tree(params)
    js, ts = jtx.init(jp), ttx.init(tp)
    if name == "sgd_w_scheduler":
        js = js._replace(epoch=jnp.int32(5))
        ts = ts._replace(epoch=5)
    rtol, atol = (1e-5, 1e-6) if name == "adam" else (1e-6, 0.0)
    for i, g in enumerate(grads):
        ju, js = jtx.update(jax.tree.map(jnp.asarray, g), js, jp)
        jp = optax.apply_updates(jp, ju)
        tu, ts = ttx.update(_torch_tree(g), ts, tp)
        tp = toptim.apply_updates(tp, tu)
        _close_tree(tp, jax.device_get(jp), rtol, 0.0, f"step {i}", atol=atol)
        if i % 2:
            before = ts
            js, ts = joptim.advance_epoch(js), toptim.advance_epoch(ts)
            if name != "sgd_w_scheduler":
                assert ts is before
    if name == "sgd_w_scheduler":
        assert ts.epoch == int(js.epoch) == 9
        _close_tree(ts.inner, jax.device_get(js.inner.trace), rtol, 0.0, "trace", atol=atol)
    if name == "adam":
        adam = js[0]
        assert ts["count"] == int(adam.count) == 8
        _close_tree(ts["mu"], jax.device_get(adam.mu), 1e-5, 0.0, "mu", atol=1e-8)


def test_unknown_optimizer_raises_as_in_jax():
    with pytest.raises(ValueError, match="Unsupported optimizer"):
        joptim.get_optimizer("rmsprop", 1e-3)
    with pytest.raises(ValueError, match="Unsupported optimizer"):
        toptim.get_optimizer("rmsprop", 1e-3)


# ---------------------------------------------------------------------------
# the model steps
# ---------------------------------------------------------------------------

def _net_and_init(name: str, dataset: str, seed: int = 0):
    jnet = j_backbone.make_backbone(name, dataset)
    tnet = t_backbone.make_backbone(name, dataset)
    size = tuple(jnet.input_size)
    params, state = jax.device_get(jax.jit(lambda k: jnet.init(k, size))(jax.random.key(seed)))
    return jnet, tnet, params, state, size


def _port_layout(tree: dict) -> dict:
    """A JAX backbone tree in the port's layout (convert.backbone_from_jax's
    transposes), its dtype kept."""
    out = {}
    for k, v in tree.items():
        a = v if isinstance(v, dict) else np.asarray(v)
        if isinstance(a, dict):
            out[k] = _port_layout(a)
        elif (k == "w" or k.endswith("_w")) and a.ndim in (2, 4):
            out[k] = a.T if a.ndim == 2 else a.transpose(3, 2, 0, 1)
        else:
            out[k] = a
    return out


@pytest.mark.parametrize("name,dataset,opt,lr,dtype", [
    ("custom_mlp_9", "mnist", "adam", 1e-2, np.float32),
    ("resnet18", "cifar_10", "sgd_w_scheduler", 1e-2, np.float64),
], ids=["mlp9-adam", "resnet18-sgd_w_scheduler-f64"])
def test_model_train_step_matches_jax(name, dataset, opt, lr, dtype):
    """Two train steps in train mode (batch norm on the batch's statistics,
    ResNet-18 at 32 px on 8 images): the loss and accuracy of each, then the
    parameters and the running statistics. ResNet-18 in f64 on both sides: at
    this random init its f32 gradients are ill-conditioned (channels of nearly
    constant conv output, whose batch norm divides by a small deviation), and
    each framework's f32 gradient lies up to 20% of a layer's largest entry
    from the f64 one (measured: JAX's in layer4.1.conv2, the port's 9% in
    layer3.1.conv1), so f32 runs of the two part at the first update. In f64
    the conditioning still shows (measured: the second loss 2.2e-9 apart,
    parameters 2.3e-8 and running statistics 6.8e-10 of an array's largest),
    well inside F64_RTOL."""
    jnet, tnet, params, state, size = _net_and_init(name, dataset)
    params, state = jax.tree.map(lambda a: np.asarray(a, dtype), (params, state))
    rng = np.random.default_rng(1)
    batches = [(rng.normal(size=(8, *size)).astype(dtype),
                rng.integers(0, 10, size=8).astype(np.int32)) for _ in range(2)]
    f64 = dtype == np.float64
    tol = F64_RTOL if f64 else MODEL_RTOL
    with jax.enable_x64(f64):
        jtx, ttx = joptim.get_optimizer(opt, lr), toptim.get_optimizer(opt, lr)
        jts = j_steps.ModelTrainState(params, state, jtx.init(params),
                                      jnp.zeros((), jnp.int32))
        tp, tsn = convert.backbone_from_jax(params, state)
        if f64:
            tp, tsn = (toptim.tree_map(torch.Tensor.double, t) for t in (tp, tsn))
        tts = t_steps.ModelTrainState(tp, tsn, ttx.init(tp), 0)
        jstep = j_steps.make_model_train_step(jnet, jtx, j_losses.cross_entropy)
        tstep = t_steps.make_model_train_step(tnet, ttx, t_losses.cross_entropy)
        for x, y in batches:
            jts, jm = jstep(jts, jnp.asarray(x), jnp.asarray(y))
            tts, tm = tstep(tts, torch.from_numpy(x), torch.from_numpy(y))
            np.testing.assert_allclose(float(tm["model_loss"]), float(jm["model_loss"]),
                                       rtol=tol)
            assert float(tm["accuracy"]) == float(jm["accuracy"])
        jp, js = jax.device_get((jts.params, jts.net_state))
    assert tts.step == int(jts.step) == 2
    want_p, want_s = _port_layout(jp), _port_layout(js)
    if f64:
        _close_tree(tts.params, want_p, F64_RTOL, F64_RTOL, "params")
        _close_tree(tts.net_state, want_s, F64_RTOL, F64_RTOL, "net_state")
        assert not torch.equal(tts.net_state["bn1"]["mean"], tsn["bn1"]["mean"])  # moved
        return
    _close_params(tts.params, want_p, opt, lr, 2, "params")
    _close_tree(tts.net_state, want_s, PARAMS_RTOL, PARAMS_ATOL_FRAC, "net_state")


@pytest.mark.parametrize("topk_layer", [None, "conv2"], ids=["plain", "topk"])
def test_model_eval_step_matches_jax(topk_layer):
    """custom_cnn_1's eval step; with topk_layer the channel means of conv2
    (spatial), its frequencies and dead channels, and no taps."""
    jnet, tnet, params, state, size = _net_and_init("custom_cnn_1", "cifar_10")
    rng = np.random.default_rng(2)
    x = rng.normal(size=(8, *size)).astype(np.float32)
    y = rng.integers(0, 10, size=8).astype(np.int32)
    jm, jarr, jtaps = jax.device_get(j_steps.make_model_eval_step(
        jnet, j_losses.cross_entropy, topk_layer=topk_layer)(params, state, x, y))
    tp, tsn = convert.backbone_from_jax(params, state)
    tm, tarr, ttaps = t_steps.make_model_eval_step(tnet, t_losses.cross_entropy,
                                                   topk_layer=topk_layer)(
        tp, tsn, torch.from_numpy(x), torch.from_numpy(y))
    assert set(tm) == set(jm) == {"model_loss", "accuracy"}
    np.testing.assert_allclose(float(tm["model_loss"]), float(jm["model_loss"]), rtol=MODEL_RTOL)
    assert float(tm["accuracy"]) == float(jm["accuracy"])
    assert set(tarr) == set(jarr)
    assert int(tarr["correct"]) == int(jarr["correct"])
    assert set(ttaps) == set(jtaps)
    if topk_layer is None:
        assert "conv2" in ttaps
        return
    assert ttaps == {}
    np.testing.assert_allclose(tarr["topk_acts"].numpy(), jarr["topk_acts"], rtol=1e-4,
                               atol=1e-4 * np.abs(jarr["topk_acts"]).max())
    np.testing.assert_array_equal(tarr["dead"].numpy(), jarr["dead"])
    np.testing.assert_allclose(tarr["freq"].numpy(), jarr["freq"], rtol=1e-6)


# ---------------------------------------------------------------------------
# Pipeline.run with original_model=True
# ---------------------------------------------------------------------------

# model_name -> dataset, optimizer, learning rate
RUNS = {
    "mlp9-adam": ("custom_mlp_9", "mnist", "adam", 1e-3),
    "mlp9-sgd": ("custom_mlp_9", "mnist", "sgd", 5e-2),
    "cnn1-sgd_w_scheduler": ("custom_cnn_1", "cifar_10", "sgd_w_scheduler", 1e-2),
}


class _EvalRecorder(_Recorder):
    def __init__(self):
        super().__init__()
        self.evals = []

    def log_eval(self, epoch, metrics):
        self.evals.append((epoch, {k: float(v) for k, v in metrics.items()}))


def _cfg(run: str, **kw) -> dict:
    name, dataset, opt, lr = RUNS[run]
    return dict(model_name=name, dataset_name=dataset, sae_model_name="None", sae_layer="fc1"
                if name == "custom_mlp_9" else "conv2", original_model=True,
                model_optimizer_name=opt, model_learning_rate=lr, batch_size=64,
                model_epochs=2, seed=5, log_every=10**9, **kw)


def _datasets(make, cfg: dict):
    size = t_backbone.make_backbone(cfg["model_name"], cfg["dataset_name"]).input_size
    tr = make(num_samples=512, img_size=tuple(size), num_classes=10, seed=5)
    va = make(num_samples=256, img_size=tuple(size), num_classes=10, seed=6)
    return tr, va, tr.category_names, tuple(size)


def _jax(cfg: dict, folder, backbone=None):
    rec = _EvalRecorder()
    with quick_jax_pipeline():
        pipe = JPipeline(JConfig(**cfg, directory_path=str(folder)), logger=rec,
                         datasets=_datasets(j_synth, cfg))
        out = pipe.run()
    return pipe, rec, out


def _port(cfg: dict, folder, backbone=None):
    pipe = TPipeline(TConfig(**cfg, directory_path=str(folder)), device="cpu",
                     datasets=_datasets(t_synth, cfg), backbone=backbone)
    return pipe, pipe.run()


_TRAINED: dict = {}


def _trained(run: str, tmp_path_factory) -> dict:
    """For one entry of RUNS, in each package: two epochs uninterrupted, and
    one epoch then a fresh Pipeline resumed to two; the port from the JAX
    Pipeline's initial weights (given explicitly to the first runs; the resumed
    one reads its own model_weights/). Then a standalone eval of each
    package's trained model (its top-k file). Run once per module."""
    if run in _TRAINED:
        return _TRAINED[run]
    cfg = _cfg(run)
    dirs = {k: tmp_path_factory.mktemp(k) for k in ("j2", "j1", "t2", "t1")}
    j2 = _jax(cfg, dirs["j2"])
    with quick_jax_pipeline():  # the initial weights: a fresh Pipeline's, same seed
        j0 = JPipeline(JConfig(**cfg, directory_path=str(tmp_path_factory.mktemp("j0"))),
                       datasets=_datasets(j_synth, cfg))
    backbone = convert.backbone_from_jax(*jax.device_get((j0.frozen_params, j0.net_state)))
    t2 = _port(cfg, dirs["t2"], backbone)
    j1a = _jax({**cfg, "model_epochs": 1}, dirs["j1"])
    t1a = _port({**cfg, "model_epochs": 1}, dirs["t1"], backbone)
    j1 = _jax(cfg, dirs["j1"])
    t1 = _port(cfg, dirs["t1"])
    evals = {"j": _jax({**cfg, "training": False}, dirs["j2"]),
             "t": _port({**cfg, "training": False}, dirs["t2"])}
    _TRAINED[run] = dict(cfg=cfg, dirs=dirs, j2=j2, t2=t2, j1a=j1a, t1a=t1a, j1=j1, t1=t1,
                         evals=evals)
    return _TRAINED[run]


@pytest.fixture(scope="module", params=list(RUNS))
def trained(request, tmp_path_factory):
    return _trained(request.param, tmp_path_factory)


@pytest.fixture(scope="module")
def mlp_sgd(tmp_path_factory):
    return _trained("mlp9-sgd", tmp_path_factory)


def _check_run(jrun, trun, cfg: dict) -> None:
    jpipe, rec, _ = jrun
    tpipe, _ = trun
    tsteps = {s: {k: float(v) for k, v in m.items()} for s, m in tpipe.train_log}
    assert sorted(tsteps) == sorted(rec.train)
    for s, jm in rec.train.items():
        np.testing.assert_allclose(tsteps[s]["model_loss"], jm["model_loss"], rtol=MODEL_RTOL,
                                   err_msg=f"step {s}")
        assert tsteps[s]["accuracy"] == pytest.approx(jm["accuracy"], abs=1e-6), s
    assert [e for e, _ in tpipe.eval_log] == [e for e, _ in rec.evals]
    for (e, tm), (_, jm) in zip(tpipe.eval_log, rec.evals):
        np.testing.assert_allclose(tm["model_loss"], jm["model_loss"], rtol=MODEL_RTOL,
                                   err_msg=f"eval {e}")
        assert tm["accuracy"] == pytest.approx(jm["accuracy"], abs=1e-6), e
    want = convert.backbone_from_jax(*jax.device_get((jpipe.frozen_params, jpipe.net_state)))
    _close_params(tpipe.frozen_params, want[0], cfg["model_optimizer_name"],
                  cfg["model_learning_rate"], tpipe.mts.step, "params")
    _close_tree(tpipe.net_state, want[1], PARAMS_RTOL, PARAMS_ATOL_FRAC, "net_state")


def test_original_training_matches_jax(trained):
    """Per-step losses, the evals before and after each epoch, the trained
    weights; the model learns."""
    _check_run(trained["j2"], trained["t2"], trained["cfg"])
    tpipe = trained["t2"][0]
    assert [e for e, _ in tpipe.eval_log] == [0, 1, 2]
    assert tpipe.eval_log[-1][1]["accuracy"] > tpipe.eval_log[0][1]["accuracy"]
    assert len(tpipe.train_log) == 2 * (512 // 64)


def test_model_weights_checkpoints_match_jax(trained):
    """model_weights/epoch_1 and epoch_2 of each package: the port's is
    {"params", "net_state"} in the port's layout, JAX's an Orbax directory."""
    dirs = trained["dirs"]
    jpipe, tpipe = trained["j2"][0], trained["t2"][0]
    cfg = trained["cfg"]
    for e in (1, 2):
        jtree = j_ckpt.load_checkpoint(jpipe.paths["model_weights"], e)
        ttree = t_ckpt.load_checkpoint(tpipe.paths["model_weights"], e)
        assert set(ttree) == {"params", "net_state"}
        want = convert.backbone_from_jax(jtree["params"], jtree.get("net_state") or {})
        _close_params(ttree["params"], want[0], cfg["model_optimizer_name"],
                      cfg["model_learning_rate"], 8 * e, f"epoch {e}")
        _close_tree(ttree["net_state"], want[1], PARAMS_RTOL, PARAMS_ATOL_FRAC, f"epoch {e}")
    assert str(dirs["t2"]) in tpipe.paths["model_weights"]
    for path, v in _leaves(tpipe.frozen_params):
        assert torch.equal(_get(t_ckpt.load_checkpoint(tpipe.paths["model_weights"], 2)
                                ["params"], path), v)


def test_resume_from_epoch_1_matches_jax(trained):
    """The run resumed after epoch 1 against JAX's resumed run: the restore
    line's epoch, the second epoch's steps and eval, the weights; the port's
    first epoch bitwise its uninterrupted run's (the same seed and data), and
    under plain sgd, which keeps no state, the whole resumed run bitwise the
    uninterrupted one (the others restart their optimizer state at the
    resume, as the JAX package does)."""
    _check_run(trained["j1"], trained["t1"], trained["cfg"])
    t1, t2, t1a = trained["t1"][0], trained["t2"][0], trained["t1a"][0]
    assert t1._model_ckpt_epoch == 1 and trained["j1"][0]._model_ckpt_epoch == 1
    assert [e for e, _ in t1.eval_log] == [2] and [s for s, _ in t1.train_log] == list(
        range(1, 9))
    for path, v in _leaves(t_ckpt.load_checkpoint(t1.paths["model_weights"], 1)):
        assert torch.equal(_get(t_ckpt.load_checkpoint(t2.paths["model_weights"], 1), path), v)
    if trained["cfg"]["model_optimizer_name"] == "sgd":
        for path, v in _leaves(t2.frozen_params):
            assert torch.equal(_get(t1.frozen_params, path), v)
    if trained["cfg"]["model_optimizer_name"] == "sgd_w_scheduler":
        assert t1.mts.opt_state.epoch == t2.mts.opt_state.epoch == 2
        assert t1a.mts.opt_state.epoch == 1


def test_trained_run_says_it_is_done(trained, capsys):
    """A Pipeline whose model_weights/ already reach model_epochs trains
    nothing (JAX's message) and keeps the restored weights."""
    cfg = trained["cfg"]
    tpipe, _ = _port(cfg, trained["dirs"]["t2"])
    assert "already trained to epoch 2; nothing to do" in capsys.readouterr().out
    assert tpipe.train_log == [] and tpipe.eval_log == []


def test_standalone_eval_topk_file_matches_jax(trained):
    """A standalone original-model eval (training=False) on the trained model
    in each package's folder: the means and the four arrays of its top-k file."""
    (jpipe, rec, jmeans), (tpipe, tmeans) = trained["evals"]["j"], trained["evals"]["t"]
    assert jpipe._model_ckpt_epoch == tpipe._model_ckpt_epoch == 2
    for k in ("model_loss", "accuracy"):
        np.testing.assert_allclose(tmeans[k], jmeans[k], rtol=MODEL_RTOL, err_msg=k)
    name = f"{tpipe.run_id}_epoch_0.npz"
    assert name == f"{jpipe.run_id}_epoch_0.npz"
    rel = os.path.join("filename_indices", name)
    with np.load(os.path.join(jpipe.paths["evaluation_results"], rel)) as j, \
            np.load(os.path.join(tpipe.paths["evaluation_results"], rel)) as t:
        assert set(t.files) == set(j.files) == {"max_filename_indices", "min_filename_indices",
                                                "dead_units", "activity_freq"}
        assert t["max_filename_indices"].shape == (25, tpipe.num_units)
        for k in ("max_filename_indices", "min_filename_indices", "dead_units"):
            np.testing.assert_array_equal(t[k], j[k], err_msg=k)
        np.testing.assert_allclose(t["activity_freq"], j["activity_freq"], rtol=1e-6)


def test_final_eval_names_the_figures_it_does_not_draw(trained, capsys):
    """The standalone eval draws every figure of a final eval (none is
    skipped): the channel-frequency histogram, the top and small grids and
    the activation histograms, under the JAX package's names."""
    tpipe, _ = _port({**trained["cfg"], "training": False}, trained["dirs"]["t2"])
    out = capsys.readouterr().out
    assert "skipped" not in out
    folder, e = tpipe.paths["evaluation_results"], tpipe.cfg.sae_checkpoint_epoch
    for rel in (f"channel_frequency_histograms/{tpipe.run_id}_epoch_{e}.png",
                f"top_k_samples/{tpipe.run_id}_top_k_samples_epoch_{e}.png",
                f"top_k_samples/{tpipe.run_id}_small_k_samples_epoch_{e}.png",
                f"activation_histograms/{tpipe.run_id}_epoch_{e}.png"):
        assert os.path.exists(os.path.join(folder, rel)), rel


# ---------------------------------------------------------------------------
# guards, the model_weights restore, original-model MIS
# ---------------------------------------------------------------------------

def test_ie_and_mis_guards_match_jax(tmp_path):
    """IE runs on a dictionary only; original-model MIS needs sae_layer to name
    a backbone layer; a top-k eval too."""
    cfg = _cfg("mlp9-sgd", training=False)
    for pkg, run in (("j", _jax), ("t", _port)):
        with pytest.raises(ValueError, match="original model"):
            run({**cfg, "compute_ie": "1"}, tmp_path / pkg)
        with pytest.raises(ValueError, match="name a backbone layer"):
            run({**cfg, "mis": "1", "sae_layer": "None"}, tmp_path / pkg)
    tpipe = TPipeline(TConfig(**{**cfg, "sae_layer": "None"}, directory_path=str(tmp_path)),
                      device="cpu", datasets=_datasets(t_synth, cfg))
    assert tpipe.num_units == 0
    with pytest.raises(ValueError, match="name a backbone layer"):
        tpipe.eval_original(collect_topk=True)


def test_an_sae_pipeline_takes_the_trained_backbone(mlp_sgd, capsys):
    """A port SAE Pipeline in a folder where the port trained the original
    model runs on those weights, bitwise; in one where the JAX package
    trained it (Orbax directories) it raises, naming the converter."""
    trained = mlp_sgd
    cfg = {**_cfg("mlp9-sgd"), "original_model": False, "sae_model_name": "sae_mlp",
           "sae_layer": "fc1"}
    tpipe = TPipeline(TConfig(**cfg, directory_path=str(trained["dirs"]["t2"])), device="cpu",
                      datasets=_datasets(t_synth, cfg))
    assert "Loaded original-model weights from epoch 2." in capsys.readouterr().out
    want = t_ckpt.load_checkpoint(tpipe.paths["model_weights"], 2)
    for path, v in _leaves(want["params"]):
        assert torch.equal(_get(tpipe.frozen_params, path), v)
    assert tpipe._model_ckpt_epoch == 2
    with pytest.raises(ValueError, match="convert.backbone_from_jax"):
        TPipeline(TConfig(**cfg, directory_path=str(trained["dirs"]["j2"])), device="cpu",
                  datasets=_datasets(t_synth, cfg))
    # an explicit backbone wins over the directory
    fresh = TPipeline(TConfig(**cfg, directory_path=str(trained["dirs"]["t2"])), device="cpu",
                      datasets=_datasets(t_synth, cfg), backbone=trained["t1a"][0].mts[:2])
    assert fresh._model_ckpt_epoch == 0


def test_original_model_mis_collect_then_score_matches_jax(mlp_sgd, tmp_path):
    """As tests/test_cli_modes.py's original-model MIS: mis="1" then "2" over
    fc1's 16 channels of the trained MLP, in both packages on JAX's trained
    weights (carried into the port's folder through convert.backbone_from_jax
    and save_checkpoint): the 200 most and least activating train samples of
    each channel, then one MIS row per channel and the median."""
    trained = mlp_sgd
    cfg = trained["cfg"]
    jdir = trained["dirs"]["j2"]
    jtree = j_ckpt.load_checkpoint(trained["j2"][0].paths["model_weights"], 2)
    params, state = convert.backbone_from_jax(jtree["params"], jtree.get("net_state") or {})
    probe = TPipeline(TConfig(**cfg, directory_path=str(tmp_path)), device="cpu",
                      datasets=_datasets(t_synth, cfg))
    t_ckpt.save_checkpoint(probe.paths["model_weights"], 2, {"params": params,
                                                             "net_state": state})
    got = {}
    for mis in ("1", "2"):
        run = {**cfg, "training": False, "mis": mis}
        got["j", mis] = _jax(run, jdir)
        got["t", mis] = _port(run, tmp_path)
    jpipe, tpipe = got["j", "1"][0], got["t", "1"][0]
    assert tpipe.num_units == jpipe.num_units == 16
    rel = os.path.join("filename_indices", f"{tpipe.run_id}_epoch_0.npz")
    with np.load(os.path.join(jpipe.paths["evaluation_results"], rel)) as j, \
            np.load(os.path.join(tpipe.paths["evaluation_results"], rel)) as t:
        assert t["max_filename_indices"].shape == (200, 16)
        assert (t["max_filename_indices"] >= 0).all()
        for k in ("max_filename_indices", "min_filename_indices", "dead_units"):
            np.testing.assert_array_equal(t[k], j[k], err_msg=k)
    jres, tres = got["j", "2"][2], got["t", "2"][1]
    assert len(tres["per_unit"]) == len(jres["per_unit"]) == 16
    assert 0.0 <= tres["median_mis"] <= 1.0
    assert abs(tres["median_mis"] - jres["median_mis"]) <= 1 / 20 + 1e-9
    assert os.listdir(os.path.join(tpipe.paths["evaluation_results"], "MIS"))


def test_validate_slice_takes_the_original_model_fields(tmp_path, monkeypatch):
    """original_model, the model optimizers and sae_model_name="None" pass;
    an unknown model optimizer is refused, naming the field."""
    cfg = _cfg("mlp9-sgd")
    for opt in ("adam", "sgd", "sgd_w_scheduler"):
        TPipeline(TConfig(**{**cfg, "model_optimizer_name": opt}, directory_path=str(tmp_path)),
                  device="cpu", datasets=_datasets(t_synth, cfg))
    with pytest.raises(NotImplementedError, match="model_optimizer_name"):
        TPipeline(TConfig(**{**cfg, "model_optimizer_name": "rmsprop"},
                          directory_path=str(tmp_path)),
                  device="cpu", datasets=_datasets(t_synth, cfg))
    # on CUDA unless asked for the CPU
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        TPipeline(TConfig(**cfg, directory_path=str(tmp_path)), datasets=_datasets(t_synth, cfg))


def test_cli_trains_the_original_model(tmp_path, capsys):
    """The port's CLI on an original-model config (on the CPU, the stand-in
    data): one JSON line with the epoch reached, the last eval and the
    model_weights folder, which holds the checkpoint."""
    import json

    from sparse_vision_tpu_torch import cli

    cfg = TConfig(**{**_cfg("mlp9-sgd"), "model_epochs": 1}, directory_path=str(tmp_path))
    out = cli.main(["--run_pipeline", "--device", "cpu", "--config", cfg.to_json()])
    assert json.loads(capsys.readouterr().out.strip().splitlines()[-1]) == out
    assert out["epoch"] == 1 and set(out["last_eval"]) == {"model_loss", "accuracy"}
    assert t_ckpt.latest_epoch(out["model_weights"]) == 1
