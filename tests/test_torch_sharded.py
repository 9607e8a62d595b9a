"""The port's data-parallel trainer on meshes (2,) and (4,) of gloo ranks on the
CPU, held to the JAX package's make_sharded_fused_train_step on as many of the
eight CPU devices (tests/conftest.py).

Every variant of the single-device cached step: sae_mlp (crossing the
resample at step 5, dead_neurons_steps 2, 8 latents forced dead, JAX's draws
handed in), gated_sae, jumprelu_sae, matryoshka_sae (prefixes 1/2, 1: 128 and
256 latents, the JAX kernel's tile), topk_sae and batch_topk_sae (k 8, AuxK
16: the global batch's selection, the threshold's pmin, AuxK in the windows'
mature halves), each crossing the rolling window's restarts. The fused
variants run JAX's Pallas kernels in interpret mode and the port's plain
versions, in f32; the TopK family runs both packages' fast paths. 128
channels, 2x (256 latents), 256 tokens a step (128 or 64 a rank), 5 steps.
Tolerances (tests/test_torch_steps.py): losses rtol 2e-4, final params rtol
2e-3 and atol 2e-5 (Adam's first steps divide by sqrt(nu) and amplify f32
rounding of tiny gradients), dead accumulators equal, the same against the
port's own one-rank step (its sums run over the whole batch, here over shards
first: the same amplification).

One world per mesh (tests/torch_mesh_workers.dp_worker). The (2,) world also
runs Pipeline.run at mesh_shape=(2,) on JAX's data-parallel config
(tests/test_sharded_fused.py:171-210, compute f32), held to the port's
one-rank run at rtol 1e-4 (the port's one-rank Pipeline is held to JAX's in
tests/test_torch_pipeline.py; JAX's mesh Pipeline is held to the port's in
tests/test_torch_tensor_parallel.py).
"""

from concurrent.futures import ThreadPoolExecutor

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import torch_mesh_workers as workers
from sparse_vision_tpu.models.sae import init_sae, kaiming_uniform
from sparse_vision_tpu.ops import optim as joptim
from sparse_vision_tpu.parallel.mesh import make_mesh as j_make_mesh
from sparse_vision_tpu.parallel.sharded_steps import make_sharded_fused_train_step as j_dp_step
from sparse_vision_tpu.parallel.sharded_steps import put_sharded as j_put_sharded
from sparse_vision_tpu.train.steps import init_sae_train_state as j_init
from sparse_vision_tpu_torch import convert
from sparse_vision_tpu_torch.config import RunConfig as TConfig
from sparse_vision_tpu_torch.ops import optim as toptim
from sparse_vision_tpu_torch.parallel.distributed import spawn
from sparse_vision_tpu_torch.train import steps as tsteps
from sparse_vision_tpu_torch.train.pipeline import Pipeline as TPipeline

C, K, T, STEPS, WINDOW, TOPK = 128, 2, 256, 5, 2, 8
H = C * K
RESAMPLE_AT = 2 * WINDOW + 1
PREFIXES = (0.5, 1.0)
JOPTS = dict(tile_t=32, tile_h=128, compute_dtype=jnp.float32, interpret=True)
VARIANTS = {  # name -> (λ, extra fused options, AuxK)
    "sae_mlp": (0.5, {}, 0),
    "gated_sae": (0.5, {}, 0),
    "jumprelu_sae": (0.02, {"bandwidth": 0.05}, 0),
    "matryoshka_sae": (0.5, {}, 0),
    "topk_sae": (0.0, None, 16),
    "batch_topk_sae": (0.0, None, 16),
}
PIPE = dict(model_name="custom_mlp_9", sae_model_name="sae_mlp", sae_layer="fc1",
            dataset_name="synthetic", sae_epochs=2, sae_learning_rate=1e-3,
            sae_optimizer_name="constrained_adam", sae_batch_size=64, sae_lambda_sparse=0.1,
            sae_expansion_factor=2, dead_neurons_steps=3, use_activation_cache=True,
            cache_tokens_per_step=128, log_every=1000, compute_dtype="float32")


def _batches() -> list:
    rng = np.random.default_rng(1)
    return [rng.normal(size=(T, C)).astype(np.float32) for _ in range(STEPS)]


def _params(name: str) -> dict:
    params = {k: np.array(v) for k, v in jax.device_get(
        init_sae(name, jax.random.key(0), C, K, jumprelu_threshold_init=0.5)).items()}
    if name == "sae_mlp":  # these latents never fire, so the resample has work
        params["b_enc"][:8] = -1e3
    return params


def _jax_draws(step: int) -> tuple:
    key = jax.random.key(0)
    for _ in range(step):
        key, sub = jax.random.split(key)
    k_enc, k_dec = jax.random.split(sub)
    return (np.array(kaiming_uniform(k_enc, (H, C), fan_in=C)),
            np.array(kaiming_uniform(k_dec, (C, H), fan_in=H)))


def _job(root=None) -> dict:
    job = {"batches": _batches(), "window": WINDOW, "expansion": K, "topk": TOPK,
           "prefixes": PREFIXES, "variants": {}}
    for name, (lam, opts, aux_k) in VARIANTS.items():
        spec = {"params": _params(name), "lambda": lam, "aux_k": aux_k,
                "fused_opts": None if opts is None else {"compute_dtype": "float32", **opts}}
        if name == "sae_mlp":
            spec["draws"] = {RESAMPLE_AT: _jax_draws(RESAMPLE_AT)}
        job["variants"][name] = spec
    return job


@pytest.fixture(scope="module", autouse=True)
def one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def worlds(tmp_path_factory):
    """Each mesh's rank results; the (2,) world's with its Pipeline run."""
    root = tmp_path_factory.mktemp("dp")
    jobs = {(2,): _job(), (4,): _job()}
    jobs[(2,)].update(cfg=TConfig(**PIPE, mesh_shape=(2,)).to_json(), backbone=None, sae=None,
                      root=str(root / "mesh"))
    with ThreadPoolExecutor(len(jobs)) as pool:  # the two worlds side by side
        futures = {shape: pool.submit(spawn, workers.dp_worker, shape, job, device="cpu",
                                      backend="gloo", timeout_s=600)
                   for shape, job in jobs.items()}
    return {"root": root, **{shape: f.result() for shape, f in futures.items()}}


def _jax_trajectory(name: str, n: int):
    lam, opts, aux_k = VARIANTS[name]
    mesh = j_make_mesh((n,))
    tx = joptim.get_optimizer("constrained_adam", 1e-3)
    jopts = None if opts is None else {**JOPTS, **opts}
    step = j_dp_step(mesh, lam, tx, WINDOW, K, fused_opts=jopts, sae_model_name=name,
                     topk=TOPK, matryoshka_prefixes=PREFIXES, aux_k=aux_k)
    params = jax.tree.map(jnp.asarray, _params(name))
    ts = j_init(params, tx, H, seed=0)
    metrics, dead = [], []
    for x in _batches():
        ts, xs = j_put_sharded(mesh, ts, jnp.asarray(x))
        ts, m = step(ts, xs)
        metrics.append({k: float(v) for k, v in m.items()})
        dead.append(np.asarray(ts.dead_acc))
    return ts, metrics, dead


def _port_one_rank(name: str):
    lam, opts, aux_k = VARIANTS[name]
    tx = toptim.get_optimizer("constrained_adam", 1e-3)
    step = tsteps.make_sae_train_step_from_acts(
        name, lam, tx, WINDOW, K, fused=True,
        fused_opts=None if opts is None else {"compute_dtype": "float32", **opts},
        topk=TOPK, matryoshka_prefixes=PREFIXES, aux_k=aux_k)
    ts = tsteps.init_sae_train_state(convert.sae_params_from_jax(_params(name)), tx, H)
    for i, x in enumerate(_batches(), start=1):
        draws = _jax_draws(i) if name == "sae_mlp" and i == RESAMPLE_AT else None
        ts, _ = step(ts, torch.from_numpy(x),
                     resample_draws=None if draws is None else tuple(map(torch.from_numpy,
                                                                         draws)))
    return ts


@pytest.mark.parametrize("n", [2, 4])
@pytest.mark.parametrize("name", list(VARIANTS))
def test_data_parallel_step_matches_jax(worlds, name, n):
    jts, jmetrics, jdead = _jax_trajectory(name, n)
    one = _port_one_rank(name)
    for res in worlds[(n,)]:
        port = res[name]
        for s, (pm, jm) in enumerate(zip(port["metrics"], jmetrics), start=1):
            for k in ("sae_loss", "sae_rec_loss", "sae_l1_loss", "sparsity", "perc_dead"):
                np.testing.assert_allclose(pm[k], jm[k], rtol=2e-4, atol=1e-7,
                                           err_msg=f"step {s}: {k}")
        for s, (pd, jd) in enumerate(zip(port["dead"], jdead), start=1):
            np.testing.assert_array_equal(pd.numpy(), jd, err_msg=f"dead_acc at step {s}")
        for k, v in jts.params.items():
            got = port["params"][k].numpy()
            np.testing.assert_allclose(got, np.asarray(v), rtol=2e-3, atol=2e-5,
                                       err_msg=f"final {k} vs JAX")
            np.testing.assert_allclose(got, one.params[k].numpy(), rtol=2e-3, atol=2e-5,
                                       err_msg=f"final {k} vs one rank")
    if name == "sae_mlp":  # the resample revived the latents forced dead
        assert float(worlds[(n,)][0][name]["params"]["b_enc"][:8].min()) > -1.0


def test_replicas_stay_equal(worlds):
    """Every rank ends with the same parameters, bitwise: the update sees the
    same all-reduced gradients on each."""
    for shape in ((2,), (4,)):
        first = worlds[shape][0]
        for res in worlds[shape][1:]:
            for name in VARIANTS:
                for k, v in first[name]["params"].items():
                    assert torch.equal(res[name]["params"][k], v), (shape, name, k)


def test_pipeline_data_parallel_matches_one_rank(worlds):
    tpipe = TPipeline(TConfig(**PIPE, directory_path=str(worlds["root"] / "one")), device="cpu")
    tmeans = tpipe.run()
    for res in worlds[(2,)]:
        mesh_run = res["pipeline"]
        assert mesh_run["step"] == tpipe.ts.step > 0
        np.testing.assert_array_equal(mesh_run["dead"].numpy(), tpipe.ts.dead_acc.numpy())
        for k, v in tpipe.ts.params.items():
            np.testing.assert_allclose(mesh_run["params"][k].numpy(), v.numpy(), rtol=1e-4,
                                       atol=1e-6, err_msg=k)
    means = worlds[(2,)][0]["pipeline"]["means"]
    assert worlds[(2,)][1]["pipeline"]["means"] is None  # rank 0 evaluates
    for k in ("sae_rec_loss", "sae_loss", "perc_dead_units"):
        np.testing.assert_allclose(means[k], tmeans[k], rtol=1e-4, err_msg=k)
