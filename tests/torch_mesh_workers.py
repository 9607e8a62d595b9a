"""Rank workers of the mesh tests (tests/test_torch_mesh.py,
test_torch_tensor_parallel.py, test_torch_sharded.py, test_torch_coder_tp.py).

Each is ``fn(rank, mesh, *args)`` for parallel/distributed.spawn and runs one
rank of a torch.distributed world (gloo on the CPU). The module imports torch
and the port only: spawn starts every rank from a fresh interpreter that
imports the worker's module, so a worker beside the JAX code of the test files
would import JAX into each rank. Arguments and results are numpy arrays,
torch CPU tensors and plain Python values.
"""

from __future__ import annotations

import dataclasses
import time

import numpy as np
import torch

from sparse_vision_tpu_torch.config import RunConfig
from sparse_vision_tpu_torch.ops import (
    fast_topk_sae,
    fused_crosscoder,
    fused_sae_tp,
    fused_transcoder,
    optim,
    resample,
)
from sparse_vision_tpu_torch.parallel.mesh import BOTH, gather_params, shard_params
from sparse_vision_tpu_torch.parallel.sharded_steps import (
    make_sharded_fused_train_step,
    put_replicated_state,
    put_tokens_sharded,
)
from sparse_vision_tpu_torch.parallel.tensor_parallel import (
    gather_tp_state,
    make_tp_fused_train_step,
    put_tp_state,
)
from sparse_vision_tpu_torch.train import steps as tsteps
from sparse_vision_tpu_torch.train.crosscoder import make_tp_crosscoder_train_step
from sparse_vision_tpu_torch.train.pipeline import Pipeline
from sparse_vision_tpu_torch.train.transcoder import make_tp_transcoder_train_step


def _t(tree):
    """numpy leaves as torch tensors."""
    if isinstance(tree, dict):
        return {k: _t(v) for k, v in tree.items()}
    if isinstance(tree, (tuple, list)):
        return type(tree)(_t(v) for v in tree)
    return torch.from_numpy(np.array(tree)) if isinstance(tree, np.ndarray) else tree


def mesh_worker(rank: int, mesh, params: dict) -> dict:
    """The mesh's layout and collectives on this rank."""
    torch.set_num_threads(1)
    params = _t(params)
    local = shard_params(params, mesh)
    x = torch.arange(6, dtype=torch.float32) + 10.0 * rank
    return {
        "rank": rank, "coords": mesh.coords,
        "shards": local, "gathered": gather_params(local, mesh),
        "psum": {a if isinstance(a, str) else "both": mesh.psum(x, a)
                 for a in ("data", "model", BOTH)},
        "pmin": {a if isinstance(a, str) else "both": mesh.pmin(x, a)
                 for a in ("data", "model", BOTH)},
        "gather_data": mesh.gather(x[:2], 0, "data"),
        "dead_gather": mesh.gather(torch.tensor([rank % 2 == 0, True]), 0),
    }


def raise_on_rank_3(rank: int, mesh) -> None:
    """Rank 3 raises; the others wait in a collective that never completes."""
    if rank == 3:
        raise ValueError("rank 3 fails on purpose")
    mesh.barrier()


def sleep_forever(rank: int, mesh) -> None:
    """Rank 0 never reaches the collective the others wait in."""
    if rank == 0:
        time.sleep(3600)
    mesh.barrier()


TP_TERMS = {"sae_mlp": fused_sae_tp.fused_sae_tp_loss_terms,
            "gated_sae": fused_sae_tp.fused_gated_sae_tp_loss_terms,
            "jumprelu_sae": fused_sae_tp.fused_jumprelu_sae_tp_loss_terms,
            "matryoshka_sae": fused_sae_tp.fused_matryoshka_sae_tp_loss_terms,
            "topk_sae": fast_topk_sae.fast_topk_sae_tp_loss_terms}


def _op_results(rank, mesh, name, params, x, lam, expansion, cd, opts):
    """One TP op's loss terms and gathered gradients on this rank's shard
    (``opts``: the op's own keyword arguments)."""
    local = {k: v.requires_grad_(True) for k, v in shard_params(params, mesh).items()}
    out = TP_TERMS[name](local, put_tokens_sharded(mesh, x), lam, expansion, mesh,
                         compute_dtype=cd, **opts)
    out["loss"].backward()
    return {
        **{k: out[k].detach() for k in ("loss", "rec_loss", "l1_loss", "aux_loss", "sparsity",
                                        "l0_loss") if k in out},
        "grads": gather_params({k: v.grad for k, v in local.items()}, mesh),
        "dead": mesh.gather(out["dead"], 0),
        "activity_freq": mesh.gather(out["activity_freq"], 0),
        "decoded": out["decoded"].detach(),
    }


def _steps(mesh, name, params, batches, lam, window, expansion, draws=None,
           fused_opts=None, **kw):
    """A TP trajectory from full ``params``: per step the metrics and the
    gathered dead accumulator; the final gathered state. ``fused_opts`` is
    added to f32 compute, ``kw`` goes to make_tp_fused_train_step."""
    tx = optim.get_optimizer("constrained_adam", 1e-3)
    h = next(v.shape[0] for k, v in params.items() if k in ("b_enc", "b_gate"))
    ts = put_tp_state(mesh, tsteps.init_sae_train_state(params, tx, h, seed=0))
    step = make_tp_fused_train_step(mesh, lam, tx, window, expansion,
                                    fused_opts={"compute_dtype": "float32",
                                                **(fused_opts or {})},
                                    sae_model_name=name, **kw)
    metrics, dead = [], []
    for i, x in enumerate(batches, start=1):
        ts, m = step(ts, put_tokens_sharded(mesh, _t(x)),
                     resample_draws=None if draws is None else _t(draws.get(i)))
        metrics.append({k: float(v) for k, v in m.items()})
        dead.append(mesh.gather(ts.dead_acc, 0))
    full = gather_tp_state(mesh, ts)
    return {"metrics": metrics, "dead": dead, "params": full.params, "step": full.step,
            "norms": torch.linalg.vector_norm(full.params["W_dec"], dim=1)}


def _pipeline(mesh, cfg: RunConfig, backbone, sae_params, **kw):
    pipe = Pipeline(dataclasses.replace(cfg, **kw), device="cpu", mesh=mesh,
                    backbone=backbone, sae_params=sae_params)
    means = pipe.run()
    return {"means": means, "params": pipe.ts.params, "dead": pipe.ts.dead_acc,
            "step": pipe.ts.step, "opt_state": pipe.ts.opt_state,
            "csv": getattr(pipe, "decoder_norms_path", None)}


def _state_round_trip(mesh, params) -> dict:
    """put_tp_state then gather_tp_state of a train state with distinct Adam
    moments: the shard widths and whether the round trip gives the state back."""
    tx = optim.get_optimizer("constrained_adam", 1e-3)
    ts = tsteps.init_sae_train_state(params, tx, params["b_enc"].shape[0], seed=0)
    opt = {**ts.opt_state, "mu": {k: v + 1.0 for k, v in params.items()},
           "nu": {k: v * 2.0 for k, v in params.items()}}
    ts = ts._replace(opt_state=opt, dead_acc=torch.arange(ts.dead_acc.shape[0]) % 3 == 0)
    local = put_tp_state(mesh, ts)
    back = gather_tp_state(mesh, local)
    same = all(torch.equal(back.params[k], v) for k, v in ts.params.items())
    same &= all(torch.equal(back.opt_state[m][k], v) for m in ("mu", "nu")
                for k, v in ts.opt_state[m].items())
    return {"shapes": {k: tuple(v.shape) for k, v in local.params.items()},
            "mu_shapes": {k: tuple(v.shape) for k, v in local.opt_state["mu"].items()},
            "equal": same and torch.equal(back.dead_acc, ts.dead_acc)}


def tp_worker(rank: int, mesh, job: dict) -> dict:
    """Everything test_torch_tensor_parallel.py holds on one (2, 2) world."""
    torch.set_num_threads(1)
    out = {"ops": {}}
    for (name, cd), (params, x) in job["ops"].items():
        out["ops"][name, cd] = _op_results(rank, mesh, name, _t(params), _t(x),
                                           job["lambda"], job["expansion"][name], cd,
                                           job["op_opts"].get(name, {}))
    try:
        local = shard_params(_t(job["ops"]["topk_sae", torch.float32][0]), mesh)
        fast_topk_sae.fast_topk_sae_tp_loss_terms(
            local, torch.zeros(8, local["W_enc"].shape[0]), 0.0, 4, mesh,
            k=local["b_enc"].shape[0] + 1)
        out["topk_too_large"] = None
    except ValueError as e:
        out["topk_too_large"] = str(e)
    out["jumprelu_state"] = _state_round_trip(mesh, _t(job["ops"]["jumprelu_sae",
                                                                 torch.float32][0]))
    for name, spec in job["variant_steps"].items():
        out[f"{name}_steps"] = _steps(mesh, name, _t(spec["params"]), job["batches"],
                                      job["lambda"], job["window"], spec["expansion"],
                                      **spec["kw"])
    out["relu_steps"] = _steps(mesh, "sae_mlp", _t(job["relu_params"]), job["batches"],
                               job["lambda"], job["window"], job["expansion"]["sae_mlp"],
                               draws=job["draws"])
    cfg = RunConfig.from_json(job["cfg"])
    backbone, sae = _t(job["backbone"]), _t(job["sae"])
    root = job["root"]
    out["pipeline"] = _pipeline(mesh, cfg, backbone, sae, directory_path=f"{root}/mesh")
    resume = dict(dead_neurons_steps=10_000)
    out["straight"] = _pipeline(mesh, cfg, backbone, sae, directory_path=f"{root}/straight",
                                **resume)
    _pipeline(mesh, cfg, backbone, sae, directory_path=f"{root}/resumed", sae_epochs=1,
              **resume)
    out["resumed"] = _pipeline(mesh, cfg, backbone, sae, directory_path=f"{root}/resumed",
                               sae_checkpoint_epoch=1, **resume)
    mat = RunConfig.from_json(job["matryoshka_cfg"])
    out["matryoshka_pipeline"] = _pipeline(mesh, mat, backbone, None,
                                           directory_path=f"{root}/matryoshka")
    return out


def dp_worker(rank: int, mesh, job: dict) -> dict:
    """Every variant's data-parallel trajectory on this rank (test_torch_sharded.py)."""
    torch.set_num_threads(1)
    out = {}
    for name, spec in job["variants"].items():
        tx = optim.get_optimizer("constrained_adam", 1e-3)
        params = _t(spec["params"])
        h = next(v.shape[0] for k, v in params.items() if k in ("b_enc", "b_gate"))
        step = make_sharded_fused_train_step(
            mesh, spec["lambda"], tx, job["window"], job["expansion"],
            fused_opts=spec.get("fused_opts"), sae_model_name=name, topk=job["topk"],
            matryoshka_prefixes=job["prefixes"], aux_k=spec.get("aux_k", 0))
        ts = put_replicated_state(mesh, tsteps.init_sae_train_state(params, tx, h, seed=0))
        metrics, dead = [], []
        for i, x in enumerate(job["batches"], start=1):
            draws = spec.get("draws", {}).get(i)
            ts, m = step(ts, put_tokens_sharded(mesh, _t(x)),
                         resample_draws=None if draws is None else _t(draws))
            metrics.append({k: float(v) for k, v in m.items()})
            dead.append(ts.dead_acc.clone())
        out[name] = {"metrics": metrics, "dead": dead, "params": ts.params}
    if "cfg" in job:
        cfg = RunConfig.from_json(job["cfg"])
        out["pipeline"] = _pipeline(mesh, cfg, _t(job["backbone"]), _t(job["sae"]),
                                    directory_path=job["root"])
    return out


def _coder_op(mesh, name, params, inputs, lam, expansion, cd) -> dict:
    """The transcoder's (``inputs`` = (x, y)) or crosscoder's (``inputs`` = the
    layers' tokens) TP op on this rank's shard: loss terms, gathered gradients
    and statistics, the local prediction (the transcoder's)."""
    local = {k: v.requires_grad_(True) for k, v in shard_params(params, mesh).items()}
    rows = tuple(put_tokens_sharded(mesh, a) for a in inputs)
    if name == "transcoder":
        out = fused_transcoder.fused_transcoder_tp_loss_terms(
            local, *rows, lam, expansion, mesh, compute_dtype=cd)
    else:
        out = fused_crosscoder.fused_crosscoder_tp_loss_terms(
            local, rows, lam, expansion, mesh, compute_dtype=cd)
    out["loss"].backward()
    res = {k: out[k].detach() for k in ("loss", "rec_loss", "l1_loss", "sparsity",
                                         "nrmse_loss", "rmse_loss")}
    res.update(grads=gather_params({k: v.grad for k, v in local.items()}, mesh),
               dead=mesh.gather(out["dead"], 0),
               activity_freq=mesh.gather(out["activity_freq"], 0))
    if "decoded" in out:
        res["decoded"] = out["decoded"].detach()
    return res


def _coder_resample(mesh, name, params, mu, nu, dead, draws) -> dict:
    """The latent-sharded resample of ``name`` (the transcoder's is sae_mlp's,
    resample_dead_neurons_tp) with the full ``draws``; the gathered params and
    Adam moments."""
    tx = optim.get_optimizer("adam", 1e-3)
    ts = tsteps.init_sae_train_state(params, tx, dead.shape[0], seed=0)
    ts = put_tp_state(mesh, ts._replace(opt_state={**ts.opt_state, "mu": mu, "nu": nu},
                                        dead_acc=dead))
    if name == "transcoder":
        p, o = resample.resample_dead_neurons_tp(ts.params, ts.opt_state, ts.dead_acc, *draws,
                                                 mesh)
    else:
        p, o = resample.resample_dead_neurons_crosscoder_tp(ts.params, ts.opt_state,
                                                            ts.dead_acc, draws, mesh)
    full = gather_tp_state(mesh, ts._replace(params=p, opt_state=o))
    return {"params": full.params, "mu": full.opt_state["mu"], "nu": full.opt_state["nu"]}


def _coder_steps(mesh, name, params, batches, lam, window, expansion, optimizer, draws):
    """A TP trajectory of ``name`` from full ``params`` in f32: per step the
    metrics and the gathered dead accumulator; the final gathered params."""
    tx = optim.get_optimizer(optimizer, 1e-3)
    ts = put_tp_state(mesh, tsteps.init_sae_train_state(params, tx, params["b_enc"].shape[0],
                                                        seed=0))
    make = make_tp_transcoder_train_step if name == "transcoder" \
        else make_tp_crosscoder_train_step
    step = make(mesh, lam, tx, window, expansion, fused_opts={"compute_dtype": "float32"})
    metrics, dead = [], []
    for i, inputs in enumerate(batches, start=1):
        rows = tuple(put_tokens_sharded(mesh, _t(a)) for a in inputs)
        args = rows if name == "transcoder" else (rows,)
        ts, m = step(ts, *args, resample_draws=_t(draws.get(i)))
        metrics.append({k: float(v) for k, v in m.items()})
        dead.append(mesh.gather(ts.dead_acc, 0))
    full = gather_tp_state(mesh, ts)
    return {"metrics": metrics, "dead": dead, "params": full.params, "step": full.step}


def coder_tp_worker(rank: int, mesh, job: dict) -> dict:
    """Everything test_torch_coder_tp.py holds on a rank: on the (2, 2) world
    the TP ops, resamples and steps of both coders, and on every world the
    Pipeline runs of ``job["pipelines"]``."""
    torch.set_num_threads(1)
    out = {}
    if mesh.size("model") > 1:
        for (name, cd), (params, inputs) in job["ops"].items():
            out["op", name, cd] = _coder_op(mesh, name, _t(params), _t(inputs), job["lambda"],
                                            job["expansion"], cd)
        for name, spec in job["resample"].items():
            out["resample", name] = _coder_resample(mesh, name, *_t(spec))
        for name, spec in job["steps"].items():
            out["steps", name] = _coder_steps(mesh, name, _t(spec["params"]), spec["batches"],
                                              job["lambda"], job["window"], job["expansion"],
                                              spec["optimizer"], spec["draws"])
    backbones = _t(job["backbones"])
    for name, cfg_json in job["pipelines"].items():
        cfg = RunConfig.from_json(cfg_json)
        out["pipeline", name] = _pipeline(
            mesh, cfg, backbones[name], _t(job["sae"][name]),
            directory_path=f"{job['root']}/{name}_{'x'.join(map(str, mesh.shape))}")
    return out
