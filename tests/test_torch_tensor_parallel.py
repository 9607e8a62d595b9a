"""The port's tensor-parallel trainer on a (2, 2) mesh of four gloo ranks on the
CPU, held to the JAX package.

One spawned world (tests/torch_mesh_workers.tp_worker) runs everything the
tests read; the JAX side runs here, on four of the eight CPU devices
(tests/conftest.py), with the Pallas kernels in interpret mode.

- The ReLU and gated TP ops (ops/fused_sae_tp.py) at D 32, 4x (128 latents, 64
  a rank), 64 tokens (32 a rank): loss terms, every gradient (gathered) and
  the statistics against JAX's TP ops under shard_map and against JAX's
  single-device fused ops. f32 at JAX's own TP tolerances
  (tests/test_tensor_parallel.py:130: rtol 1e-5, atol 1e-6); bf16 against
  JAX's bf16 TP op at rtol BF16_RTOL and BF16_ATOL of each array's largest
  entry. At these sizes each JAX kernel is one tile, so both round the same
  values to bf16 at the same cast points and differ by f32 summation order
  only: 1.4e-7 of an array's largest entry at most, measured, where bf16
  against f32 moves dW_enc by 0.12 of its largest entry.
- The sae_mlp TP step across the resample at step 5 (dead_neurons_steps 2,
  8 latents forced dead), JAX's draws handed in, against JAX's
  make_tp_fused_train_step; the gated TP step across the rolling window's
  restarts (steps 2, 4, 6) against JAX's SINGLE-DEVICE fused step (ROADMAP
  C1: JAX's TP step resets the accumulator only when it can resample, which
  test_c1_jax_tp_gated_dead_acc_differs shows).
- Pipeline.run with mesh_shape=(2, 2) on JAX's own TP config
  (tests/test_tensor_parallel.py:137-176; compute f32) against the port's
  one-rank run and JAX's mesh run (the GSPMD stock step on the CPU), rtol
  1e-4; a TP checkpoint resume equal to the straight run.
"""

import dataclasses
from concurrent.futures import ThreadPoolExecutor

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.sharding import PartitionSpec as P

import torch_mesh_workers as workers
from sparse_vision_tpu.config import RunConfig as JConfig
from sparse_vision_tpu.models.sae import init_sae, kaiming_uniform
from sparse_vision_tpu.ops import optim as joptim
from sparse_vision_tpu.ops.fused_gated_sae import fused_gated_sae_loss_terms as j_gated_terms
from sparse_vision_tpu.ops.fused_sae import fused_sae_loss_terms as j_relu_terms
from sparse_vision_tpu.ops.fused_sae_tp import (
    fused_gated_sae_tp_loss_terms as j_gated_tp_terms,
)
from sparse_vision_tpu.ops.fused_sae_tp import fused_sae_tp_loss_terms as j_relu_tp_terms
from sparse_vision_tpu.parallel.mesh import make_mesh as j_make_mesh
from sparse_vision_tpu.parallel.mesh import sae_param_sharding
from sparse_vision_tpu.parallel.sharded_steps import shard_map
from sparse_vision_tpu.parallel.tensor_parallel import make_tp_fused_train_step as j_tp_step
from sparse_vision_tpu.parallel.tensor_parallel import put_tokens_tp as j_put_tokens
from sparse_vision_tpu.parallel.tensor_parallel import put_tp_state as j_put_tp
from sparse_vision_tpu.train.pipeline import Pipeline as JPipeline
from sparse_vision_tpu.train.steps import init_sae_train_state as j_init
from sparse_vision_tpu.train.steps import make_sae_train_step_from_acts as j_make
from sparse_vision_tpu_torch import convert
from sparse_vision_tpu_torch.config import RunConfig as TConfig
from sparse_vision_tpu_torch.parallel.distributed import spawn
from sparse_vision_tpu_torch.parallel.tensor_parallel import make_tp_fused_train_step
from sparse_vision_tpu_torch.train.pipeline import Pipeline as TPipeline
from sparse_vision_tpu_torch.train.pipeline import validate_mesh_mode

D, K, TPS, MESH = 32, 4, 64, (2, 2)
H = D * K
LAMBDA, WINDOW, STEPS = 0.1, 2, 7  # the resample at 2n+1 = 5, restarts at 2, 4, 6
RESAMPLE_AT = 2 * WINDOW + 1
F32 = dict(rtol=1e-5, atol=1e-6)
BF16_RTOL, BF16_ATOL = 1e-5, 1e-5
JCD = {torch.float32: jnp.float32, torch.bfloat16: jnp.bfloat16}
# JAX's Pipeline config of tests/test_tensor_parallel.py:137-176
PIPE = dict(dataset_name="synthetic", sae_epochs=2, sae_optimizer_name="constrained_adam",
            sae_batch_size=64, sae_lambda_sparse=0.1, sae_expansion_factor=2,
            dead_neurons_steps=3, use_activation_cache=True, cache_tokens_per_step=128,
            log_every=1000, compute_dtype="float32")


def _tokens(step: int) -> np.ndarray:
    return np.random.default_rng(100 + step).normal(size=(TPS, D)).astype(np.float32)


def _params(name: str, dead: int = 0) -> dict:
    params = jax.device_get(init_sae(name, jax.random.key(0), D, K))
    if dead:  # these latents never fire, so the resample has work
        params = {**params, "b_enc": params["b_enc"].copy()}
        params["b_enc"][:dead] = -1e3
    return {k: np.asarray(v) for k, v in params.items()}


def _jax_draws(step: int) -> tuple:
    """The draws the JAX step makes at 1-based ``step``: one split of its rng a
    step, the sub-key split into (enc, dec) by the resample."""
    key = jax.random.key(0)
    for _ in range(step):
        key, sub = jax.random.split(key)
    k_enc, k_dec = jax.random.split(sub)
    return (np.array(kaiming_uniform(k_enc, (H, D), fan_in=D)),
            np.array(kaiming_uniform(k_dec, (D, H), fan_in=H)))


@pytest.fixture(scope="module")
def world(tmp_path_factory, one_torch_thread):
    """The port's results of every test, rank by rank; while the world runs,
    JAX's mesh Pipeline (whose weights every port run starts from) and the
    port's one-rank Pipeline train here."""
    root = tmp_path_factory.mktemp("tp")
    jpipe = JPipeline(JConfig(**PIPE, directory_path=str(root / "jax"), mesh_shape=MESH))
    backbone = convert.backbone_from_jax(jax.device_get(jpipe.frozen_params),
                                         jax.device_get(jpipe.net_state))
    sae = convert.sae_params_from_jax(jax.device_get(jpipe.ts.params))
    job = {
        "ops": {(name, cd): (_params(name), _tokens(0))
                for name in ("sae_mlp", "gated_sae") for cd in JCD},
        "lambda": LAMBDA, "expansion": K, "window": WINDOW,
        "batches": [_tokens(s) for s in range(STEPS)],
        "relu_params": _params("sae_mlp", dead=8), "gated_params": _params("gated_sae"),
        "draws": {RESAMPLE_AT: _jax_draws(RESAMPLE_AT)},
        "cfg": TConfig(**PIPE, mesh_shape=MESH).to_json(),
        "backbone": backbone, "sae": sae, "root": str(root / "torch"),
    }
    with ThreadPoolExecutor(1) as pool:
        ranks = pool.submit(spawn, workers.tp_worker, MESH, job, device="cpu", backend="gloo",
                            timeout_s=600)
        jmeans = jpipe.train_sae()
        tpipe = TPipeline(TConfig(**PIPE, directory_path=str(root / "one")), device="cpu",
                          backbone=backbone, sae_params=sae)
        tmeans = tpipe.run()
        return {"ranks": ranks.result(), "jpipe": jpipe, "jmeans": jmeans, "tpipe": tpipe,
                "tmeans": tmeans}


@pytest.fixture(scope="module", autouse=True)
def one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _jax_tp_op(name: str, cd, params: dict, x: np.ndarray) -> dict:
    """JAX's TP op under shard_map on (2, 2): loss terms, gradients (global),
    statistics."""
    mesh = j_make_mesh(MESH)
    specs = {k: s.spec for k, s in sae_param_sharding(mesh, params).items()}
    terms = j_relu_tp_terms if name == "sae_mlp" else j_gated_tp_terms

    def body(p, xl):
        def loss(p):
            out = terms(p, xl, LAMBDA, K, *MESH, compute_dtype=cd, interpret=True)
            return out["loss"], out

        (_, out), g = jax.value_and_grad(loss, has_aux=True)(p)
        scalars = {k: out[k] for k in ("loss", "rec_loss", "l1_loss", "sparsity")
                   if k in out}
        if "aux_loss" in out:
            scalars["aux_loss"] = out["aux_loss"]
        return scalars, g, out["dead"], out["activity_freq"], out["decoded"]

    f = shard_map(body, mesh=mesh, in_specs=(specs, P("data", None)),
                  out_specs=(P(), specs, P("model"), P("model"), P("data", None)),
                  check_vma=False)
    scalars, g, dead, freq, decoded = jax.jit(f)(params, x)
    return {**{k: np.asarray(v) for k, v in scalars.items()},
            "grads": {k: np.asarray(v) for k, v in g.items()}, "dead": np.asarray(dead),
            "activity_freq": np.asarray(freq), "decoded": np.asarray(decoded)}


def _jax_single_op(name: str, params: dict, x: np.ndarray) -> dict:
    terms = j_relu_terms if name == "sae_mlp" else j_gated_terms

    def loss(p):
        out = terms(p, jnp.asarray(x), LAMBDA, K, compute_dtype=jnp.float32, interpret=True)
        return out["loss"], out

    (_, out), g = jax.value_and_grad(loss, has_aux=True)(params)
    return {**{k: np.asarray(out[k]) for k in ("loss", "rec_loss", "l1_loss", "sparsity",
                                                "dead", "activity_freq", "decoded")},
            "grads": {k: np.asarray(v) for k, v in g.items()}}


def _check_op(port: dict, jax_out: dict, rtol: float, atol: float, scale_atol: bool):
    for k in ("loss", "rec_loss", "l1_loss", "sparsity"):
        np.testing.assert_allclose(float(port[k]), float(jax_out[k]), rtol=max(rtol, 1e-6),
                                   err_msg=k)
    if "aux_loss" in jax_out:
        np.testing.assert_allclose(float(port["aux_loss"]), float(jax_out["aux_loss"]),
                                   rtol=max(rtol, 1e-6), err_msg="aux_loss")
    for k, want in jax_out["grads"].items():
        a = atol * np.abs(want).max() if scale_atol else atol
        np.testing.assert_allclose(port["grads"][k].double().numpy(), want, rtol=rtol,
                                   atol=a, err_msg=f"d{k}")
    np.testing.assert_array_equal(port["dead"].numpy(), jax_out["dead"])
    np.testing.assert_allclose(port["activity_freq"].numpy(), jax_out["activity_freq"],
                               rtol=1e-6)


@pytest.mark.parametrize("cd", [torch.float32, torch.bfloat16], ids=["f32", "bf16"])
@pytest.mark.parametrize("name", ["sae_mlp", "gated_sae"])
def test_tp_op_matches_jax_tp_op(world, name, cd):
    params, x = _params(name), _tokens(0)
    want = _jax_tp_op(name, JCD[cd], params, x)
    for rank, res in enumerate(world["ranks"]):
        port = res["ops"][name, cd]
        if cd == torch.float32:
            _check_op(port, want, F32["rtol"], F32["atol"], scale_atol=False)
        else:
            _check_op(port, want, BF16_RTOL, BF16_ATOL, scale_atol=True)
        # the rank's data index's token rows of the full reconstruction
        d = rank // MESH[1]
        rows = slice(d * TPS // MESH[0], (d + 1) * TPS // MESH[0])
        tol = F32 if cd == torch.float32 else dict(rtol=BF16_RTOL, atol=BF16_ATOL)
        np.testing.assert_allclose(port["decoded"].numpy(), want["decoded"][rows], **tol)


@pytest.mark.parametrize("name", ["sae_mlp", "gated_sae"])
def test_tp_op_matches_jax_single_device_op(world, name):
    params, x = _params(name), _tokens(0)
    want = _jax_single_op(name, params, x)
    port = world["ranks"][0]["ops"][name, torch.float32]
    _check_op(port, want, F32["rtol"], F32["atol"], scale_atol=False)
    np.testing.assert_allclose(torch.cat([r["ops"][name, torch.float32]["decoded"]
                                          for r in world["ranks"][::MESH[1]]]).numpy(),
                               want["decoded"], **F32)


def _jax_steps(step_fn, ts, put=None):
    metrics, dead = [], []
    for s in range(STEPS):
        x = _tokens(s)
        ts, m = step_fn(ts, put(x) if put else jnp.asarray(x))
        metrics.append({k: float(v) for k, v in m.items()})
        dead.append(np.asarray(ts.dead_acc))
    return ts, metrics, dead


def _check_steps(port: dict, jts, jmetrics, jdead, keys):
    for s, (pm, jm) in enumerate(zip(port["metrics"], jmetrics), start=1):
        for k in keys:
            np.testing.assert_allclose(pm[k], jm[k], rtol=1e-4, atol=1e-7,
                                       err_msg=f"step {s}: {k}")
    for s, (pd, jd) in enumerate(zip(port["dead"], jdead), start=1):
        np.testing.assert_array_equal(pd.numpy(), jd, err_msg=f"dead_acc at step {s}")
    for k, v in jts.params.items():
        np.testing.assert_allclose(port["params"][k].numpy(), np.asarray(v), **F32,
                                   err_msg=f"final {k}")
    assert port["step"] == int(jts.step) == STEPS


def test_relu_tp_step_across_resample_matches_jax_tp_step(world):
    mesh = j_make_mesh(MESH)
    params = _params("sae_mlp", dead=8)
    tx = joptim.get_optimizer("constrained_adam", 1e-3)
    ts = j_put_tp(mesh, j_init(jax.tree.map(jnp.asarray, params), tx, H, seed=0))
    step = j_tp_step(mesh, ts, LAMBDA, tx, WINDOW, K,
                     fused_opts=dict(interpret=True, compute_dtype=jnp.float32))
    jts, jm, jd = _jax_steps(step, ts, lambda x: j_put_tokens(mesh, x))
    for res in world["ranks"]:
        port = res["relu_steps"]
        _check_steps(port, jts, jm, jd,
                     ("sae_loss", "sae_rec_loss", "sae_l1_loss", "sparsity", "perc_dead"))
        # the resample revived the latents forced dead, and the decoder rows
        # kept unit norm on their shards
        assert float(port["params"]["b_enc"][:8].min()) > -1.0
        np.testing.assert_allclose(port["norms"].numpy(), 1.0, atol=1e-5)


def _jax_gated(tp: bool):
    params = _params("gated_sae")
    tx = joptim.get_optimizer("constrained_adam", 1e-3)
    opts = dict(interpret=True, compute_dtype=jnp.float32)
    ts = j_init(jax.tree.map(jnp.asarray, params), tx, H, seed=0)
    if not tp:
        return _jax_steps(j_make("gated_sae", LAMBDA, tx, WINDOW, K, fused=True,
                                 fused_opts=opts), ts)
    mesh = j_make_mesh(MESH)
    ts = j_put_tp(mesh, ts)
    step = j_tp_step(mesh, ts, LAMBDA, tx, WINDOW, K, fused_opts=opts,
                     sae_model_name="gated_sae")
    return _jax_steps(step, ts, lambda x: j_put_tokens(mesh, x))


def test_gated_tp_step_matches_jax_single_device_step(world):
    jts, jm, jd = _jax_gated(tp=False)
    for res in world["ranks"]:
        _check_steps(res["gated_steps"], jts, jm, jd,
                     ("sae_loss", "sae_rec_loss", "sae_l1_loss", "sparsity", "perc_dead"))


def test_c1_jax_tp_gated_dead_acc_differs(world):
    """ROADMAP C1: at the window's first restart (step 2) JAX's TP gated step
    keeps the accumulated mask, its single-device step restarts it all-True;
    the port's TP step restarts it as the single-device step does."""
    _, _, single = _jax_gated(tp=False)
    _, _, tp = _jax_gated(tp=True)
    port = world["ranks"][0]["gated_steps"]["dead"]
    assert single[WINDOW - 1].all()
    assert not np.array_equal(tp[WINDOW - 1], single[WINDOW - 1])
    for s in range(STEPS):
        np.testing.assert_array_equal(port[s].numpy(), single[s], err_msg=f"step {s + 1}")


def test_pipeline_tp_matches_one_rank_and_jax_mesh(world):
    jpipe, jmeans, tpipe, tmeans = (world[k] for k in ("jpipe", "jmeans", "tpipe", "tmeans"))
    for res in world["ranks"]:
        mesh_run = res["pipeline"]
        assert mesh_run["step"] == tpipe.ts.step == int(jpipe.ts.step) > 0
        np.testing.assert_array_equal(mesh_run["dead"].numpy(), tpipe.ts.dead_acc.numpy())
        np.testing.assert_array_equal(mesh_run["dead"].numpy(), np.asarray(jpipe.ts.dead_acc))
        for k, v in tpipe.ts.params.items():
            for want in (v.numpy(), np.asarray(jpipe.ts.params[k])):
                np.testing.assert_allclose(mesh_run["params"][k].numpy(), want, rtol=1e-4,
                                           atol=1e-6, err_msg=k)
    means = world["ranks"][0]["pipeline"]["means"]
    assert all(r["pipeline"]["means"] is None for r in world["ranks"][1:])  # rank 0 evaluates
    for k in ("sae_rec_loss", "sae_loss", "perc_dead_units"):
        np.testing.assert_allclose(means[k], tmeans[k], rtol=1e-4, err_msg=k)
        np.testing.assert_allclose(means[k], jmeans[k], rtol=1e-4, err_msg=k)


def test_tp_resume_equals_straight_run(world):
    for res in world["ranks"]:
        straight, resumed = res["straight"], res["resumed"]
        assert resumed["step"] == straight["step"] > 0
        for k, v in straight["params"].items():
            assert torch.equal(resumed["params"][k], v), k
        for part in ("mu", "nu"):
            for k, v in straight["opt_state"][part].items():
                assert torch.equal(resumed["opt_state"][part][k], v), (part, k)
        assert torch.equal(resumed["dead"], straight["dead"])


@pytest.mark.parametrize("name, item", [
    ("jumprelu_sae", "B1.3"), ("matryoshka_sae", "B1.4"), ("topk_sae", "A6"),
    ("batch_topk_sae", "GSPMD"), ("transcoder", "B1.5"), ("crosscoder", "B1.6")])
def test_unported_mesh_variants_raise(name, item):
    cfg = TConfig(**PIPE, sae_model_name=name, mesh_shape=MESH)
    with pytest.raises(NotImplementedError, match=item):
        validate_mesh_mode(cfg)
    if name in ("jumprelu_sae", "matryoshka_sae", "topk_sae"):
        with pytest.raises(NotImplementedError, match=item):
            make_tp_fused_train_step(None, LAMBDA, None, WINDOW, K, sae_model_name=name)


def test_other_modes_on_a_mesh_raise():
    for fields in (dict(use_pallas=False), dict(use_activation_cache=False),
                   dict(training=False), dict(overlap_dump_train=True),
                   dict(sae_e2e_finetune_epochs=1)):
        with pytest.raises(NotImplementedError, match="ROADMAP A6"):
            validate_mesh_mode(dataclasses.replace(TConfig(**PIPE, mesh_shape=MESH), **fields))


def test_a_mesh_without_a_world_raises(tmp_path):
    """mesh_shape of more than one rank needs the ranks: spawn or the CLI."""
    with pytest.raises(ValueError, match="spawn"):
        TPipeline(TConfig(**PIPE, mesh_shape=MESH, directory_path=str(tmp_path)), device="cpu")
