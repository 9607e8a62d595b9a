"""The port's transcoder and crosscoder on a mesh of gloo ranks on the CPU, held
to the JAX package.

One (2, 2) world and one (2,) world (tests/torch_mesh_workers.coder_tp_worker)
run everything the tests read, side by side; the JAX side runs here, on four
of the eight CPU devices (tests/conftest.py), with the Pallas kernels in
interpret mode.

- (a) The TP ops (ops/fused_transcoder.fused_transcoder_tp_loss_terms,
  ops/fused_crosscoder.fused_crosscoder_tp_loss_terms): the transcoder C_in 32
  -> C_out 48, the crosscoder over layers of 32, 24 and 16 channels (ΣC 72),
  128 latents (64 a rank), 64 tokens (32 a rank). Loss terms, the global
  rmse / nrmse, every gradient (gathered) and the statistics against JAX's TP
  ops under shard_map and against JAX's single-device ops. f32 at JAX's own
  TP tolerances (tests/test_tensor_parallel.py:130: rtol 1e-5, atol 1e-6);
  bf16 against JAX's bf16 TP ops at test_torch_tensor_parallel.py's
  BF16_RTOL and BF16_ATOL of each array's largest entry.
- (b) The latent-sharded resamples (the transcoder's through
  resample_dead_neurons_tp, whose surgery takes the rectangular decoder;
  resample_dead_neurons_crosscoder_tp) with JAX's draws handed in, against
  JAX's under shard_map, rtol 1e-6.
- (c) Both TP steps across the resample at step 5 (dead_neurons_steps 2, 8
  latents forced dead, JAX's draws) against JAX's make_tp_transcoder_train_step
  and make_tp_crosscoder_train_step.
- (d) Pipeline.run at mesh_shape (2, 2) and (2,) on JAX's own configs
  (tests/test_transcoder.py:147-176, tests/test_crosscoder.py:143-155,
  255-287; compute f32) against the port's one-rank run and JAX's
  single-device run, rtol 1e-4; the crosscoder's decoder-norm CSV equal to
  the gathered parameters' norms.
"""

import csv
import dataclasses
from concurrent.futures import ThreadPoolExecutor

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch
from jax.sharding import PartitionSpec as P

import torch_mesh_workers as workers
from sparse_vision_tpu.config import RunConfig as JConfig
from sparse_vision_tpu.models.crosscoder import init_crosscoder
from sparse_vision_tpu.models.sae import init_transcoder, kaiming_uniform
from sparse_vision_tpu.ops import fused_crosscoder as j_cc
from sparse_vision_tpu.ops import fused_transcoder as j_tc
from sparse_vision_tpu.ops import optim as joptim
from sparse_vision_tpu.ops import resample as j_resample
from sparse_vision_tpu.parallel.mesh import make_mesh as j_make_mesh
from sparse_vision_tpu.parallel.mesh import sae_param_sharding
from sparse_vision_tpu.parallel.sharded_steps import shard_map
from sparse_vision_tpu.parallel.tensor_parallel import put_tokens_tp as j_put_tokens
from sparse_vision_tpu.parallel.tensor_parallel import put_tp_state as j_put_tp
from sparse_vision_tpu.train.crosscoder import make_tp_crosscoder_train_step as j_cc_step
from sparse_vision_tpu.train.pipeline import Pipeline as JPipeline
from sparse_vision_tpu.train.steps import init_sae_train_state as j_init
from sparse_vision_tpu.train.transcoder import make_tp_transcoder_train_step as j_tc_step
from sparse_vision_tpu_torch import convert
from sparse_vision_tpu_torch.config import RunConfig as TConfig
from sparse_vision_tpu_torch.models.crosscoder import crosscoder_decoder_norms
from sparse_vision_tpu_torch.parallel.distributed import spawn
from sparse_vision_tpu_torch.train.pipeline import Pipeline as TPipeline
from test_torch_pipeline import quick_jax_pipeline

MESH, MESH_DP = (2, 2), (2,)
C_IN, C_OUT, DIMS, K, TOK = 32, 48, (32, 24, 16), 4, 64
H = C_IN * K  # 128 latents, 64 a rank
LAMBDA, WINDOW, STEPS = 0.1, 2, 7  # the resample at 2n+1 = 5
RESAMPLE_AT = 2 * WINDOW + 1
F32 = dict(rtol=1e-5, atol=1e-6)
BF16_RTOL, BF16_ATOL = 1e-5, 1e-5  # test_torch_tensor_parallel.py's, atol of the largest entry
NAMES = ("transcoder", "crosscoder")
OPTIMIZER = {"transcoder": "constrained_adam", "crosscoder": "adam"}
JCD = {torch.float32: jnp.float32, torch.bfloat16: jnp.bfloat16}
SCALARS = ("loss", "rec_loss", "l1_loss", "sparsity", "nrmse_loss", "rmse_loss")
# JAX's Pipeline configs of tests/test_transcoder.py:85-97, 164-176 and
# tests/test_crosscoder.py:143-155, 255-270 (their TP runs: one epoch, the
# resample window 3), compute f32 in the port
PIPES = {
    "transcoder": dict(model_name="custom_mlp_8", sae_model_name="transcoder",
                       sae_layer="fc1", transcoder_target_layer="fc2",
                       sae_optimizer_name="constrained_adam"),
    "crosscoder": dict(model_name="custom_mlp_3", sae_model_name="crosscoder",
                       sae_layer="fc1", crosscoder_layers="fc2,fc3",
                       sae_optimizer_name="adam"),
}
PIPE = dict(dataset_name="synthetic", sae_epochs=1, sae_batch_size=64, batch_size=64,
            sae_learning_rate=1e-3, sae_lambda_sparse=0.05, sae_expansion_factor=2,
            dead_neurons_steps=3, use_activation_cache=True, cache_tokens_per_step=64,
            log_every=1000)
MEANS = ("sae_rec_loss", "sae_loss", "perc_dead_units", "sparsity")


def _jcfg(name: str, root, **kw) -> JConfig:
    return JConfig(**PIPE, **PIPES[name], directory_path=str(root), **kw)


def _tcfg(name: str, **kw) -> TConfig:
    return TConfig(**PIPE, **PIPES[name], compute_dtype="float32", **kw)


def _params(name: str, dead: int = 0) -> dict:
    key = jax.random.key(0)
    params = (init_transcoder(key, C_IN, K, C_OUT) if name == "transcoder"
              else init_crosscoder(key, DIMS, K))
    params = {k: np.array(v) for k, v in jax.device_get(params).items()}
    rng = np.random.default_rng(1)
    # b_enc about 0 with a spread, so about half the latents fire on a token;
    # b_dec non-zero, so the (m−1)·b_dec correction is held
    params["b_enc"] = (0.05 * rng.normal(size=H)).astype(np.float32)
    for k in params:
        if k.startswith("b_dec"):
            params[k] = (0.1 * rng.normal(size=params[k].shape)).astype(np.float32)
    if dead:  # these latents never fire, so the resample has work
        params["b_enc"][:dead] = -1e3
    return params


def _inputs(name: str, step: int) -> tuple:
    rng = np.random.default_rng(100 + step)
    if name == "transcoder":
        return (rng.normal(size=(TOK, C_IN)).astype(np.float32),
                rng.normal(size=(TOK, C_OUT)).astype(np.float32))
    return tuple(rng.normal(size=(TOK, d)).astype(np.float32) for d in DIMS)


def _draws_from(name: str, key) -> object:
    """The draws JAX's resample makes from ``key`` at H latents."""
    if name == "transcoder":
        k_enc, k_dec = jax.random.split(key)
        return (np.array(kaiming_uniform(k_enc, (H, C_IN), fan_in=C_IN)),
                np.array(kaiming_uniform(k_dec, (C_OUT, H), fan_in=H)))
    keys = jax.random.split(key, 2 * len(DIMS))
    return [(np.array(kaiming_uniform(keys[2 * i], (H, d), fan_in=d)),
             np.array(kaiming_uniform(keys[2 * i + 1], (d, H), fan_in=H)))
            for i, d in enumerate(DIMS)]


def _step_draws(name: str, step: int):
    """The draws JAX's TP step makes at 1-based ``step``: one split of its rng a
    step, the sub-key handed to the resample."""
    key = jax.random.key(0)
    for _ in range(step):
        key, sub = jax.random.split(key)
    return _draws_from(name, sub)


RESAMPLE_KEY = 5


def _resample_spec(name: str) -> tuple:
    """(params, Adam mu, nu, dead mask, JAX's draws) of (b): moments of distinct
    values, a third of the latents dead (some on each rank)."""
    params = _params(name)
    mu = {k: v + 1.0 for k, v in params.items()}
    nu = {k: np.abs(v) * 2.0 for k, v in params.items()}
    dead = np.arange(H) % 3 == 1
    return params, mu, nu, dead, _draws_from(name, jax.random.key(RESAMPLE_KEY))


@pytest.fixture(scope="module", autouse=True)
def one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def world(tmp_path_factory, one_torch_thread):
    """The ranks' results of both worlds; while they run, JAX's single-device
    Pipelines (whose weights every port run starts from) and the port's
    one-rank Pipelines train here."""
    root = tmp_path_factory.mktemp("coder_tp")
    jpipes, backbones, sae = {}, {}, {}
    with quick_jax_pipeline():
        for name in NAMES:
            jpipes[name] = JPipeline(_jcfg(name, root / f"jax_{name}"))
            backbones[name] = convert.backbone_from_jax(
                jax.device_get(jpipes[name].frozen_params), jax.device_get(jpipes[name].net_state))
            sae[name] = convert.sae_params_from_jax(jax.device_get(jpipes[name].ts.params))
    pipelines = {name: _tcfg(name).to_json() for name in NAMES}
    common = {"backbones": backbones, "sae": sae, "pipelines": pipelines,
              "root": str(root / "torch")}
    tp_job = {
        **common, "lambda": LAMBDA, "expansion": K, "window": WINDOW,
        "ops": {(name, cd): (_params(name), _inputs(name, 0)) for name in NAMES
                for cd in JCD},
        "resample": {name: _resample_spec(name) for name in NAMES},
        "steps": {name: {"params": _params(name, dead=8), "optimizer": OPTIMIZER[name],
                         "batches": [_inputs(name, s) for s in range(STEPS)],
                         "draws": {RESAMPLE_AT: _step_draws(name, RESAMPLE_AT)}}
                  for name in NAMES},
    }
    with ThreadPoolExecutor(2) as pool:
        futures = {shape: pool.submit(spawn, workers.coder_tp_worker, shape, job, device="cpu",
                                      backend="gloo", timeout_s=600)
                   for shape, job in ((MESH, tp_job), (MESH_DP, common))}
        jmeans, one = {}, {}
        with quick_jax_pipeline():
            for name in NAMES:
                jmeans[name] = jpipes[name].run()
        for name in NAMES:
            pipe = TPipeline(dataclasses.replace(_tcfg(name),
                                                 directory_path=str(root / f"one_{name}")),
                             device="cpu", backbone=backbones[name], sae_params=sae[name])
            one[name] = (pipe, pipe.run())
        return {"ranks": {shape: f.result() for shape, f in futures.items()},
                "jpipes": jpipes, "jmeans": jmeans, "one": one}


def _jax_terms(name: str, tp: bool, cd):
    opts = dict(compute_dtype=cd, interpret=True)
    if name == "transcoder":
        if tp:
            return lambda p, x, y: j_tc.fused_transcoder_tp_loss_terms(p, x, y, LAMBDA, K, *MESH,
                                                                       **opts)
        return lambda p, x, y: j_tc.fused_transcoder_loss_terms(p, x, y, LAMBDA, K, **opts)
    if tp:
        return lambda p, *xs: j_cc.fused_crosscoder_tp_loss_terms(p, xs, LAMBDA, K, *MESH, **opts)
    return lambda p, *xs: j_cc.fused_crosscoder_loss_terms(p, xs, LAMBDA, K, **opts)


def _jax_op(name: str, tp: bool, cd, params: dict, inputs: tuple) -> dict:
    """JAX's op (``tp``: its TP op under shard_map on MESH): loss terms,
    gradients (global), statistics, the prediction (the transcoder's)."""
    terms = _jax_terms(name, tp, cd)

    def body(p, *rows):
        def loss(p):
            out = terms(p, *rows)
            return out["loss"], out

        (_, out), g = jax.value_and_grad(loss, has_aux=True)(p)
        decoded = out.get("decoded", jnp.zeros(()))
        return ({k: out[k] for k in SCALARS}, g, out["dead"], out["activity_freq"], decoded)

    if tp:
        mesh = j_make_mesh(MESH)
        specs = {k: s.spec for k, s in sae_param_sharding(mesh, params).items()}
        row = P("data", None)
        body = shard_map(body, mesh=mesh, in_specs=(specs,) + (row,) * len(inputs),
                         out_specs=(P(), specs, P("model"), P("model"),
                                    row if name == "transcoder" else P()),
                         check_vma=False)
    scalars, g, dead, freq, decoded = jax.jit(body)(params, *inputs)
    return {**{k: np.asarray(v) for k, v in scalars.items()},
            "grads": {k: np.asarray(v) for k, v in g.items()}, "dead": np.asarray(dead),
            "activity_freq": np.asarray(freq), "decoded": np.asarray(decoded)}


def _check_op(port: dict, want: dict, rtol: float, atol: float, scale_atol: bool):
    for k in SCALARS:
        np.testing.assert_allclose(float(port[k]), float(want[k]), rtol=max(rtol, 1e-6),
                                   atol=1e-7, err_msg=k)
    for k, w in want["grads"].items():
        a = atol * np.abs(w).max() if scale_atol else atol
        np.testing.assert_allclose(port["grads"][k].double().numpy(), w, rtol=rtol, atol=a,
                                   err_msg=f"d{k}")
    np.testing.assert_array_equal(port["dead"].numpy(), want["dead"])
    np.testing.assert_allclose(port["activity_freq"].numpy(), want["activity_freq"], rtol=1e-6)


def _rows(rank: int):
    d = rank // MESH[1]
    return slice(d * TOK // MESH[0], (d + 1) * TOK // MESH[0])


@pytest.mark.parametrize("cd", [torch.float32, torch.bfloat16], ids=["f32", "bf16"])
@pytest.mark.parametrize("name", NAMES)
def test_tp_op_matches_jax_tp_op(world, name, cd):
    want = _jax_op(name, True, JCD[cd], _params(name), _inputs(name, 0))
    tol = (F32["rtol"], F32["atol"], False) if cd == torch.float32 \
        else (BF16_RTOL, BF16_ATOL, True)
    for rank, res in enumerate(world["ranks"][MESH]):
        port = res["op", name, cd]
        _check_op(port, want, *tol)
        if name == "transcoder":  # the data index's token rows of the full prediction
            scale = 1.0 if cd == torch.float32 else np.abs(want["decoded"]).max()
            np.testing.assert_allclose(port["decoded"].numpy(), want["decoded"][_rows(rank)],
                                       rtol=tol[0], atol=tol[1] * scale)


@pytest.mark.parametrize("name", NAMES)
def test_tp_op_matches_jax_single_device_op(world, name):
    want = _jax_op(name, False, jnp.float32, _params(name), _inputs(name, 0))
    ranks = world["ranks"][MESH]
    _check_op(ranks[0]["op", name, torch.float32], want, F32["rtol"], F32["atol"], False)
    if name == "transcoder":
        got = torch.cat([r["op", name, torch.float32]["decoded"] for r in ranks[::MESH[1]]])
        np.testing.assert_allclose(got.numpy(), want["decoded"], **F32)


def _jax_resample(name: str, params, mu, nu, dead) -> dict:
    """JAX's latent-sharded resample under shard_map on MESH, from
    jax.random.key(RESAMPLE_KEY): params and Adam moments, gathered."""
    mesh = j_make_mesh(MESH)
    specs = {k: s.spec for k, s in sae_param_sharding(mesh, params).items()}
    state = optax.ScaleByAdamState(count=jnp.zeros((), jnp.int32), mu=mu, nu=nu)
    state_specs = optax.ScaleByAdamState(count=P(), mu=specs, nu=specs)
    fn = (j_resample.resample_dead_neurons_tp if name == "transcoder"
          else j_resample.resample_dead_neurons_crosscoder_tp)
    body = shard_map(lambda p, o, d, k: fn(p, o, d, k, MESH[1]), mesh=mesh,
                     in_specs=(specs, state_specs, P("model"), P()),
                     out_specs=(specs, state_specs), check_vma=False)
    p, o = jax.jit(body)(params, state, jnp.asarray(dead), jax.random.key(RESAMPLE_KEY))
    return {"params": jax.device_get(p), "mu": jax.device_get(o.mu),
            "nu": jax.device_get(o.nu)}


@pytest.mark.parametrize("name", NAMES)
def test_tp_resample_matches_jax(world, name):
    params, mu, nu, dead, _ = _resample_spec(name)
    want = _jax_resample(name, params, mu, nu, dead)
    for res in world["ranks"][MESH]:
        got = res["resample", name]
        for part in ("params", "mu", "nu"):
            for k, w in want[part].items():
                np.testing.assert_allclose(got[part][k].numpy(), np.asarray(w), rtol=1e-6,
                                           atol=1e-7, err_msg=f"{part} {k}")
        # the dead latents were redrawn, the live ones kept (the transcoder's
        # surgery, sae_mlp's, then sets every decoder row to unit norm)
        for k in params:
            if k.startswith("W_dec"):
                w, before = got["params"][k].numpy(), params[k]
                assert not np.allclose(w[dead], before[dead])
                if name == "transcoder":
                    before = before / np.linalg.norm(before, axis=1, keepdims=True)
                np.testing.assert_allclose(w[~dead], before[~dead], rtol=1e-6, atol=1e-7)


def _jax_steps(name: str) -> tuple:
    """JAX's TP step of ``name`` over STEPS batches from _params(name, dead=8)."""
    mesh = j_make_mesh(MESH)
    tx = joptim.get_optimizer(OPTIMIZER[name], 1e-3)
    params = jax.tree.map(jnp.asarray, _params(name, dead=8))
    ts = j_put_tp(mesh, j_init(params, tx, H, seed=0))
    make = j_tc_step if name == "transcoder" else j_cc_step
    step = make(mesh, ts, LAMBDA, tx, WINDOW, K,
                fused_opts=dict(interpret=True, compute_dtype=jnp.float32))
    metrics, dead = [], []
    for s in range(STEPS):
        rows = tuple(j_put_tokens(mesh, a) for a in _inputs(name, s))
        ts, m = step(ts, *rows) if name == "transcoder" else step(ts, rows)
        metrics.append({k: float(v) for k, v in m.items()})
        dead.append(np.asarray(ts.dead_acc))
    return ts, metrics, dead


@pytest.mark.parametrize("name", NAMES)
def test_tp_step_across_resample_matches_jax_tp_step(world, name):
    jts, jmetrics, jdead = _jax_steps(name)
    for res in world["ranks"][MESH]:
        port = res["steps", name]
        for s, (pm, jm) in enumerate(zip(port["metrics"], jmetrics), start=1):
            for k in ("sae_loss", "sae_rec_loss", "sae_l1_loss", "sparsity", "perc_dead"):
                np.testing.assert_allclose(pm[k], jm[k], rtol=1e-4, atol=1e-7,
                                           err_msg=f"step {s}: {k}")
        for s, (pd, jd) in enumerate(zip(port["dead"], jdead), start=1):
            np.testing.assert_array_equal(pd.numpy(), jd, err_msg=f"dead_acc at step {s}")
        for k, v in jts.params.items():
            np.testing.assert_allclose(port["params"][k].numpy(), np.asarray(v), **F32,
                                       err_msg=f"final {k}")
        assert port["step"] == int(jts.step) == STEPS
        # the resample revived the latents forced dead
        assert float(port["params"]["b_enc"][:8].min()) > -1.0


@pytest.mark.parametrize("shape", [MESH, MESH_DP], ids=["2x2", "2"])
@pytest.mark.parametrize("name", NAMES)
def test_pipeline_on_a_mesh_matches_one_rank_and_jax(world, name, shape):
    one, one_means = world["one"][name]
    jpipe, jmeans = world["jpipes"][name], world["jmeans"][name]
    ranks = world["ranks"][shape]
    for res in ranks:
        run = res["pipeline", name]
        assert run["step"] == one.ts.step == int(jpipe.ts.step) > 0
        np.testing.assert_array_equal(run["dead"].numpy(), one.ts.dead_acc.numpy())
        for k, v in one.ts.params.items():
            np.testing.assert_allclose(run["params"][k].numpy(), v.numpy(), rtol=1e-4,
                                       atol=1e-6, err_msg=k)
    means = ranks[0]["pipeline", name]["means"]
    assert all(r["pipeline", name]["means"] is None for r in ranks[1:])  # rank 0 evaluates
    for k in MEANS:
        np.testing.assert_allclose(means[k], one_means[k], rtol=1e-4, err_msg=k)
        np.testing.assert_allclose(means[k], jmeans[k], rtol=1e-4, err_msg=k)
    if name == "crosscoder":
        run = ranks[0]["pipeline", name]
        with open(run["csv"], newline="") as f:
            rows = list(csv.reader(f))
        norms = crosscoder_decoder_norms(run["params"]).numpy()
        got = np.array([[float(v) for v in r[1:1 + norms.shape[0]]] for r in rows[1:]]).T
        np.testing.assert_allclose(got, norms, rtol=1e-6)
        assert all(r["pipeline", name]["csv"] is None for r in ranks[1:])  # rank 0 writes
