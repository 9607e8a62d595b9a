"""The port's tensor-parallel trainer on a (2, 2) mesh of four gloo ranks on the
CPU, held to the JAX package.

One spawned world (tests/torch_mesh_workers.tp_worker) runs everything the
tests read; the JAX side runs here, on four of the eight CPU devices
(tests/conftest.py), with the Pallas kernels in interpret mode.

- The TP ops (the ReLU, gated, JumpReLU and Matryoshka ones of
  ops/fused_sae_tp.py, the TopK one of ops/fast_topk_sae.py) at D 32, 4x
  (128 latents, 64 a rank), 64 tokens (32 a rank), Matryoshka at 32x (1,024
  latents, 512 a rank) with prefixes (0.125, 0.75, 1): boundaries (128, 768,
  1,024), union (128, 256, 512), n_contrib (1, 2, 2), so a boundary cuts rank
  1's shard and the prefixes' b_dec corrections differ. Loss terms, every
  gradient (gathered) and the statistics against JAX's TP ops under shard_map
  and against JAX's single-device ops. f32 at JAX's own TP tolerances
  (tests/test_tensor_parallel.py:130: rtol 1e-5, atol 1e-6); bf16 against
  JAX's bf16 TP op at rtol BF16_RTOL and BF16_ATOL of each array's largest
  entry. At these sizes each JAX kernel of the ReLU, gated and JumpReLU ops is
  one tile, so both round the same values to bf16 at the same cast points and
  differ by f32 summation order only: 1.4e-7 of an array's largest entry at
  most, measured, where bf16 against f32 moves dW_enc by 0.12 of its largest
  entry. Where an f32 summation order differs and a bf16 rounding follows, an
  entry can round to the neighbouring bf16 value, and the gap is set from
  the measured one (about 3x): JAX's Matryoshka kernels sum the decode in
  128-latent tiles, the port's plain version per prefix level, and S (the
  backward's bf16 suffix-weighted error) then parts at a few entries (dW_enc
  8.0e-5 of its largest entry, measured; MAT_BF16_ATOL); the TopK op has no
  kernel, and the b_dec gradient's centring part sums the bf16-rounded input
  gradient over the tokens (4.6e-5, measured; TOPK_BF16_ATOL). Matryoshka's
  reconstruction at 1,024 latents reaches 13, where an f32 ulp is 9.5e-7, so
  its f32 atol is taken of each array's largest entry too (measured gap
  1.8e-7 of it).
- The sae_mlp TP step across the resample at step 5 (dead_neurons_steps 2,
  8 latents forced dead), JAX's draws handed in, against JAX's
  make_tp_fused_train_step; the gated, JumpReLU, Matryoshka and TopK TP
  steps across the rolling window's restarts (steps 2, 4, 6) against JAX's
  SINGLE-DEVICE steps (ROADMAP C1: JAX's TP step resets the accumulator only
  when it can resample, which test_c1_jax_tp_gated_dead_acc_differs and
  test_c1_jax_tp_matryoshka_dead_acc_differs show).
- Pipeline.run with mesh_shape=(2, 2) on JAX's own TP config
  (tests/test_tensor_parallel.py:137-176; compute f32) against the port's
  one-rank run and JAX's mesh run (the GSPMD stock step on the CPU), rtol
  1e-4; a TP checkpoint resume equal to the straight run; the Matryoshka
  config at 1,024 latents (the prefixes above) against the port's one-rank
  run.
"""

import dataclasses
import functools
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
from sparse_vision_tpu.models.sae import matryoshka_prefix_counts as j_prefix_counts
from sparse_vision_tpu.ops import fused_sae_tp as j_tp
from sparse_vision_tpu.ops import optim as joptim
from sparse_vision_tpu.ops.fast_topk_sae import fast_topk_sae_loss_terms as j_topk_terms
from sparse_vision_tpu.ops.fast_topk_sae import fast_topk_sae_tp_loss_terms as j_topk_tp_terms
from sparse_vision_tpu.ops.fused_gated_sae import fused_gated_sae_loss_terms as j_gated_terms
from sparse_vision_tpu.ops.fused_jumprelu_sae import fused_jumprelu_sae_loss_terms as j_jr_terms
from sparse_vision_tpu.ops.fused_matryoshka_sae import (
    fused_matryoshka_sae_loss_terms as j_mat_terms,
)
from sparse_vision_tpu.ops.fused_sae import fused_sae_loss_terms as j_relu_terms
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
from sparse_vision_tpu_torch.ops.fused_sae_tp import can_fuse_matryoshka_tp, tp_snapshot_union
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
MAT_BF16_ATOL, TOPK_BF16_ATOL = 2.5e-4, 1.5e-4  # of each array's largest entry
NAMES = ("sae_mlp", "gated_sae", "jumprelu_sae", "matryoshka_sae", "topk_sae")
MAT_K, MAT_PREFIXES = 32, (0.125, 0.75, 1.0)  # 1,024 latents: boundaries (128, 768, 1,024)
TOPK = 8
# the JumpReLU op's STE window: θ 0.3 and ε 0.5 against N(0, 1) tokens put many
# pre-activations on both sides of it, so dθ is held; the steps run at the
# JAX package's defaults (θ0 1e-3, ε 1e-3)
BANDWIDTH = 0.5
EXPANSION = {**dict.fromkeys(NAMES, K), "matryoshka_sae": MAT_K}
OP_OPTS = {"jumprelu_sae": dict(bandwidth=BANDWIDTH),
           "matryoshka_sae": dict(prefixes=MAT_PREFIXES), "topk_sae": dict(k=TOPK)}
JCD = {torch.float32: jnp.float32, torch.bfloat16: jnp.bfloat16}
# JAX's Pipeline config of tests/test_tensor_parallel.py:137-176
PIPE = dict(dataset_name="synthetic", sae_epochs=2, sae_optimizer_name="constrained_adam",
            sae_batch_size=64, sae_lambda_sparse=0.1, sae_expansion_factor=2,
            dead_neurons_steps=3, use_activation_cache=True, cache_tokens_per_step=128,
            log_every=1000, compute_dtype="float32")


# the TP steps held to JAX's single-device steps, and their port options
STEP_KW = {"gated_sae": {},
           "jumprelu_sae": {},
           "matryoshka_sae": dict(matryoshka_prefixes=MAT_PREFIXES),
           "topk_sae": dict(topk=TOPK)}
# the Matryoshka Pipeline: custom_mlp_9's fc1 (16 channels) at 64x, 1,024 latents
MAT_PIPE = {**PIPE, "sae_model_name": "matryoshka_sae", "sae_expansion_factor": 64,
            "sae_matryoshka_prefixes": ",".join(map(str, MAT_PREFIXES))}


def _tokens(step: int) -> np.ndarray:
    return np.random.default_rng(100 + step).normal(size=(TPS, D)).astype(np.float32)


def _params(name: str, dead: int = 0, op: bool = False) -> dict:
    params = jax.device_get(init_sae(name, jax.random.key(0), D, EXPANSION[name]))
    if dead:  # these latents never fire, so the resample has work
        params = {**params, "b_enc": params["b_enc"].copy()}
        params["b_enc"][:dead] = -1e3
    params = {k: np.asarray(v) for k, v in params.items()}
    if name == "jumprelu_sae" and op:
        params["log_threshold"] = np.full_like(params["log_threshold"], np.log(0.3))
    return params


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
        "ops": {(name, cd): (_params(name, op=True), _tokens(0)) for name in NAMES
                for cd in JCD},
        "op_opts": OP_OPTS, "lambda": LAMBDA, "expansion": EXPANSION, "window": WINDOW,
        "batches": [_tokens(s) for s in range(STEPS)],
        "relu_params": _params("sae_mlp", dead=8),
        "draws": {RESAMPLE_AT: _jax_draws(RESAMPLE_AT)},
        "variant_steps": {name: {"params": _params(name), "expansion": EXPANSION[name],
                                 "kw": STEP_KW[name]} for name in STEP_KW},
        "cfg": TConfig(**PIPE, mesh_shape=MESH).to_json(),
        "matryoshka_cfg": TConfig(**MAT_PIPE, mesh_shape=MESH).to_json(),
        "backbone": backbone, "sae": sae, "root": str(root / "torch"),
    }
    with ThreadPoolExecutor(1) as pool:
        ranks = pool.submit(spawn, workers.tp_worker, MESH, job, device="cpu", backend="gloo",
                            timeout_s=600)
        jmeans = jpipe.train_sae()
        tpipe = TPipeline(TConfig(**PIPE, directory_path=str(root / "one")), device="cpu",
                          backbone=backbone, sae_params=sae)
        tmeans = tpipe.run()
        mat_pipe = TPipeline(TConfig(**MAT_PIPE, directory_path=str(root / "one_mat")),
                             device="cpu", backbone=backbone)
        mat_means = mat_pipe.run()
        return {"ranks": ranks.result(), "jpipe": jpipe, "jmeans": jmeans, "tpipe": tpipe,
                "tmeans": tmeans, "mat_pipe": mat_pipe, "mat_means": mat_means}


@pytest.fixture(scope="module", autouse=True)
def one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


SCALARS = ("loss", "rec_loss", "l1_loss", "sparsity", "aux_loss", "l0_loss")


def _jax_terms(name: str, tp: bool, cd):
    """JAX's loss terms of ``name`` (``tp``: its TP op, called as ``f(p, x)``
    inside shard_map on MESH), at this file's options."""
    if name == "topk_sae":
        if tp:
            return lambda p, x: j_topk_tp_terms(p, x, LAMBDA, K, *MESH, k=TOPK, compute_dtype=cd)
        return lambda p, x: j_topk_terms(p, x, LAMBDA, K, TOPK)
    opts = dict(compute_dtype=cd, interpret=True)
    if name == "jumprelu_sae":
        opts["bandwidth"] = BANDWIDTH
    args = (MAT_PREFIXES,) if name == "matryoshka_sae" else ()
    if tp:
        fn = {"sae_mlp": j_tp.fused_sae_tp_loss_terms,
              "gated_sae": j_tp.fused_gated_sae_tp_loss_terms,
              "jumprelu_sae": j_tp.fused_jumprelu_sae_tp_loss_terms,
              "matryoshka_sae": j_tp.fused_matryoshka_sae_tp_loss_terms}[name]
        return lambda p, x: fn(p, x, LAMBDA, EXPANSION[name], *MESH, *args, **opts)
    fn = {"sae_mlp": j_relu_terms, "gated_sae": j_gated_terms, "jumprelu_sae": j_jr_terms,
          "matryoshka_sae": j_mat_terms}[name]
    return lambda p, x: fn(p, x, LAMBDA, EXPANSION[name], *args, **opts)


def _build_jax_matryoshka_tp_op(cd) -> None:
    """Make JAX's Matryoshka TP op outside any trace: its lru_cache'd factory
    makes jnp arrays, which, first made under jit, leak as tracers into the
    next trace that takes the op from the cache."""
    boundaries = j_prefix_counts(H * MAT_K // K, MAT_PREFIXES)
    j_tp.make_fused_matryoshka_sae_tp_op(boundaries, *MESH, 2048, 2048, cd, True,
                                         data_axis="data", model_axis="model")


def _jax_tp_op(name: str, cd, params: dict, x: np.ndarray) -> dict:
    """JAX's TP op under shard_map on (2, 2): loss terms, gradients (global),
    statistics."""
    if name == "matryoshka_sae":
        _build_jax_matryoshka_tp_op(cd)
    mesh = j_make_mesh(MESH)
    specs = {k: s.spec for k, s in sae_param_sharding(mesh, params).items()}
    terms = _jax_terms(name, True, cd)

    def body(p, xl):
        def loss(p):
            out = terms(p, xl)
            return out["loss"], out

        (_, out), g = jax.value_and_grad(loss, has_aux=True)(p)
        scalars = {k: out[k] for k in SCALARS if k in out}
        return scalars, g, out["dead"], out["activity_freq"], out["decoded"]

    f = shard_map(body, mesh=mesh, in_specs=(specs, P("data", None)),
                  out_specs=(P(), specs, P("model"), P("model"), P("data", None)),
                  check_vma=False)
    scalars, g, dead, freq, decoded = jax.jit(f)(params, x)
    return {**{k: np.asarray(v) for k, v in scalars.items()},
            "grads": {k: np.asarray(v) for k, v in g.items()}, "dead": np.asarray(dead),
            "activity_freq": np.asarray(freq), "decoded": np.asarray(decoded)}


def _jax_single_op(name: str, params: dict, x: np.ndarray) -> dict:
    terms = _jax_terms(name, False, jnp.float32)

    def loss(p):
        out = terms(p, jnp.asarray(x))
        return out["loss"], out

    (_, out), g = jax.value_and_grad(loss, has_aux=True)(params)
    keys = [k for k in SCALARS if k in out] + ["dead", "activity_freq", "decoded"]
    return {**{k: np.asarray(out[k]) for k in keys},
            "grads": {k: np.asarray(v) for k, v in g.items()}}


def _check_op(port: dict, jax_out: dict, rtol: float, atol: float, scale_atol: bool):
    for k in SCALARS:
        if k in jax_out:
            np.testing.assert_allclose(float(port[k]), float(jax_out[k]),
                                       rtol=max(rtol, 1e-6), err_msg=k)
    for k, want in jax_out["grads"].items():
        a = atol * np.abs(want).max() if scale_atol else atol
        np.testing.assert_allclose(port["grads"][k].double().numpy(), want, rtol=rtol,
                                   atol=a, err_msg=f"d{k}")
    np.testing.assert_array_equal(port["dead"].numpy(), jax_out["dead"])
    np.testing.assert_allclose(port["activity_freq"].numpy(), jax_out["activity_freq"],
                               rtol=1e-6)


def _tol(name: str, cd) -> tuple:
    """(rtol, atol, whether atol is of each array's largest entry) of ``name``
    in ``cd`` (module docstring)."""
    if cd == torch.float32:
        return F32["rtol"], F32["atol"], name == "matryoshka_sae"
    atol = {"matryoshka_sae": MAT_BF16_ATOL, "topk_sae": TOPK_BF16_ATOL}.get(name, BF16_ATOL)
    return BF16_RTOL, atol, True


def _check_decoded(got: np.ndarray, want: np.ndarray, name: str, cd):
    """The reconstruction at JAX's f32 or the file's bf16 tolerance (of its
    largest entry for Matryoshka's, which reaches 13)."""
    rtol, atol = (F32["rtol"], F32["atol"]) if cd == torch.float32 else (BF16_RTOL, BF16_ATOL)
    scale = np.abs(want).max() if name == "matryoshka_sae" else 1.0
    np.testing.assert_allclose(got, want, rtol=rtol, atol=atol * scale, err_msg="decoded")


@pytest.mark.parametrize("cd", [torch.float32, torch.bfloat16], ids=["f32", "bf16"])
@pytest.mark.parametrize("name", NAMES)
def test_tp_op_matches_jax_tp_op(world, name, cd):
    params, x = _params(name, op=True), _tokens(0)
    want = _jax_tp_op(name, JCD[cd], params, x)
    tol = _tol(name, cd)
    for rank, res in enumerate(world["ranks"]):
        port = res["ops"][name, cd]
        _check_op(port, want, *tol)
        # the rank's data index's token rows of the full reconstruction
        d = rank // MESH[1]
        rows = slice(d * TPS // MESH[0], (d + 1) * TPS // MESH[0])
        _check_decoded(port["decoded"].numpy(), want["decoded"][rows], name, cd)


@pytest.mark.parametrize("name", NAMES)
def test_tp_op_matches_jax_single_device_op(world, name):
    params, x = _params(name, op=True), _tokens(0)
    want = _jax_single_op(name, params, x)
    port = world["ranks"][0]["ops"][name, torch.float32]
    _check_op(port, want, *_tol(name, torch.float32))
    _check_decoded(torch.cat([r["ops"][name, torch.float32]["decoded"]
                              for r in world["ranks"][::MESH[1]]]).numpy(), want["decoded"], name,
                   torch.float32)


def _jax_steps(step_fn, ts, put=None, steps=STEPS):
    metrics, dead = [], []
    for s in range(steps):
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


@functools.lru_cache(maxsize=None)
def _jax_variant(name: str, tp: bool, steps: int = STEPS):
    """JAX's trajectory of ``name`` over ``steps`` batches from _params(name):
    its single-device fused step (the fast path for topk_sae), or with ``tp``
    its TP step on MESH."""
    params = _params(name)
    tx = joptim.get_optimizer("constrained_adam", 1e-3)
    opts = dict(interpret=True, compute_dtype=jnp.float32)
    kw = dict(matryoshka_prefixes=MAT_PREFIXES, topk=TOPK)
    if name == "topk_sae":
        opts = {}
    ts = j_init(jax.tree.map(jnp.asarray, params), tx, params["W_dec"].shape[0], seed=0)
    if not tp:
        return _jax_steps(j_make(name, LAMBDA, tx, WINDOW, EXPANSION[name], fused=True,
                                 fused_opts=opts, **kw), ts, steps=steps)
    mesh = j_make_mesh(MESH)
    if name == "matryoshka_sae":
        _build_jax_matryoshka_tp_op(jnp.float32)
    ts = j_put_tp(mesh, ts)
    step = j_tp_step(mesh, ts, LAMBDA, tx, WINDOW, EXPANSION[name], fused_opts=opts,
                     sae_model_name=name, **kw)
    return _jax_steps(step, ts, lambda x: j_put_tokens(mesh, x), steps=steps)


def _jax_gated(tp: bool):
    return _jax_variant("gated_sae", tp)


def test_gated_tp_step_matches_jax_single_device_step(world):
    jts, jm, jd = _jax_gated(tp=False)
    for res in world["ranks"]:
        _check_steps(res["gated_sae_steps"], jts, jm, jd,
                     ("sae_loss", "sae_rec_loss", "sae_l1_loss", "sparsity", "perc_dead"))


def test_c1_jax_tp_gated_dead_acc_differs(world):
    """ROADMAP C1: at the window's first restart (step 2) JAX's TP gated step
    keeps the accumulated mask, its single-device step restarts it all-True;
    the port's TP step restarts it as the single-device step does."""
    _, _, single = _jax_gated(tp=False)
    _, _, tp = _jax_gated(tp=True)
    port = world["ranks"][0]["gated_sae_steps"]["dead"]
    assert single[WINDOW - 1].all()
    assert not np.array_equal(tp[WINDOW - 1], single[WINDOW - 1])
    for s in range(STEPS):
        np.testing.assert_array_equal(port[s].numpy(), single[s], err_msg=f"step {s + 1}")


@pytest.mark.parametrize("name", ["jumprelu_sae", "matryoshka_sae", "topk_sae"])
def test_tp_step_matches_jax_single_device_step(world, name):
    """The JumpReLU, Matryoshka and TopK TP steps across the rolling window's
    restarts (steps 2, 4, 6), every rank against JAX's single-device step
    (ROADMAP C1); the gathered final state holds log_threshold too."""
    jts, jm, jd = _jax_variant(name, False)
    for res in world["ranks"]:
        _check_steps(res[f"{name}_steps"], jts, jm, jd,
                     ("sae_loss", "sae_rec_loss", "sae_l1_loss", "sparsity", "perc_dead"))


def test_c1_jax_tp_matryoshka_dead_acc_differs(world):
    """ROADMAP C1 for Matryoshka: at the window's first restart JAX's TP step
    keeps the accumulated mask (some of the 1,024 latents fired), its
    single-device step restarts it all-True, as the port's TP step does."""
    _, _, single = _jax_variant("matryoshka_sae", False)
    _, _, tp = _jax_variant("matryoshka_sae", True, WINDOW)
    port = world["ranks"][0]["matryoshka_sae_steps"]["dead"]
    assert single[WINDOW - 1].all()
    assert not tp[WINDOW - 1].all()
    np.testing.assert_array_equal(port[WINDOW - 1].numpy(), single[WINDOW - 1])


@pytest.mark.parametrize("m", [2, 4])
def test_tp_snapshot_union_matches_jax(m):
    """tp_snapshot_union and can_fuse_matryoshka_tp against JAX's on
    tests/test_tensor_parallel.py:380-395's boundaries and this file's, at T/d
    128 (a token count both packages' kernels take)."""
    for b in ((128, 512, 1024), (256, 512, 1024), (64, 512, 1024), (128, 512, 1000),
              (128, 768, 1024)):
        if b[-1] % m == 0:
            assert tp_snapshot_union(b, m) == j_tp._tp_snapshot_union(b, m), b
        assert can_fuse_matryoshka_tp(128, b, m, D, torch.float32) == \
            j_tp.can_fuse_matryoshka_tp(128, b, m), b
    assert tp_snapshot_union((128, 768, 1024), 2) == ((128, 256, 512), 512, (1, 2, 2))


def test_topk_tp_k_above_the_shard_raises(world):
    for res in world["ranks"]:
        assert "exceeds the local latent shard" in res["topk_too_large"]


def test_tp_state_takes_the_jumprelu_threshold(world):
    """put_tp_state / gather_tp_state shard log_threshold and its Adam moments
    on the latent axis and give the whole state back."""
    h_l = H // MESH[1]
    for res in world["ranks"]:
        got = res["jumprelu_state"]
        assert got["equal"]
        assert got["shapes"]["log_threshold"] == got["mu_shapes"]["log_threshold"] == (h_l,)
        assert got["shapes"]["W_enc"] == (D, h_l) and got["shapes"]["b_dec"] == (D,)


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


def test_pipeline_tp_matryoshka_matches_one_rank(world):
    """Pipeline.run of the Matryoshka config at 1,024 latents on (2, 2) against
    the port's one-rank run."""
    one, one_means = world["mat_pipe"], world["mat_means"]
    for res in world["ranks"]:
        mesh_run = res["matryoshka_pipeline"]
        assert mesh_run["step"] == one.ts.step > 0
        np.testing.assert_array_equal(mesh_run["dead"].numpy(), one.ts.dead_acc.numpy())
        for k, v in one.ts.params.items():
            np.testing.assert_allclose(mesh_run["params"][k].numpy(), v.numpy(), rtol=1e-4,
                                       atol=1e-6, err_msg=k)
    means = world["ranks"][0]["matryoshka_pipeline"]["means"]
    for k in ("sae_rec_loss", "sae_loss", "perc_dead_units"):
        np.testing.assert_allclose(means[k], one_means[k], rtol=1e-4, err_msg=k)


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


# the fields each coder needs beside its name
CODER_FIELDS = {"transcoder": {"transcoder_target_layer": "fc2"},
                "crosscoder": {"crosscoder_layers": "fc2,fc3", "sae_optimizer_name": "adam"}}


@pytest.mark.parametrize("name, fields, num_units, item", [
    ("batch_topk_sae", {}, None, "GSPMD"),
    ("transcoder", {}, 1025, "do not shard over the model axis"),
    ("crosscoder", {"overlap_dump_train": True}, None, "ROADMAP A6"),
    ("topk_sae", {"sae_aux_k": 16}, None, "GSPMD"),
    # boundaries (64, 256, 1,024) clip to a union (64, 256, 512): not multiples of 128
    ("matryoshka_sae", {"sae_matryoshka_prefixes": "0.0625,0.25,1.0"}, 1024, "GSPMD"),
    ("topk_sae", {"sae_topk": 513}, 1024, "GSPMD")],
    ids=["batch_topk_sae-GSPMD", "transcoder-latents_split", "crosscoder-overlap_A6",
         "topk_auxk-GSPMD", "matryoshka_union-GSPMD", "topk_k_above_shard-GSPMD"])
def test_unported_mesh_variants_raise(name, fields, num_units, item):
    """What a (2, 2) mesh refuses: JAX's GSPMD engine's variants and options,
    and of the coders, latents that do not split over the model axis and the
    overlapped dump (ROADMAP A6)."""
    cfg = TConfig(**{**PIPE, **CODER_FIELDS.get(name, {}), **fields}, sae_model_name=name,
                  mesh_shape=MESH)
    with pytest.raises(NotImplementedError, match=item):
        validate_mesh_mode(cfg, num_units)
    if name == "batch_topk_sae":
        with pytest.raises(ValueError, match="TP fused step supports"):
            make_tp_fused_train_step(None, LAMBDA, None, WINDOW, K, sae_model_name=name)


@pytest.mark.parametrize("name", NAMES + tuple(CODER_FIELDS))
def test_tp_variants_take_a_model_axis(name):
    """Every TP variant, and each coder (whatever use_pallas says: its TP op
    always runs), passes validate_mesh_mode at 1,024 latents on (2, 2) (the
    Matryoshka union of MAT_PREFIXES tiles, TopK's k fits a shard)."""
    fields = {"sae_matryoshka_prefixes": MAT_PIPE["sae_matryoshka_prefixes"]} \
        if name == "matryoshka_sae" else CODER_FIELDS.get(name, {})
    validate_mesh_mode(TConfig(**{**PIPE, **fields}, sae_model_name=name, mesh_shape=MESH),
                       1024)
    if name in CODER_FIELDS:
        validate_mesh_mode(TConfig(**{**PIPE, **fields}, sae_model_name=name, mesh_shape=MESH,
                                   use_pallas=False), 1024)


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
