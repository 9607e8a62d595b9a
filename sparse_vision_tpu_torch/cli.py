"""Command line of the port.

    python -m sparse_vision_tpu_torch.cli --run_pipeline --config '<RunConfig json>' [--device cpu]
    python -m sparse_vision_tpu_torch.cli --run_pipeline --parameters FILE [--line i] [--vmap_sweep]
    python -m sparse_vision_tpu_torch.cli [--run_pipeline] --feature_report OUT.html --config '<json>'

Without ``--device`` the run goes to CUDA and fails when no GPU is present. The
config runs through ``Pipeline.run``: a training config trains an SAE variant, a
transcoder or a crosscoder (resuming from the checkpoint of
``sae_checkpoint_epoch`` when it is above 0, starting from the weights of
``sae_weights_path`` when it is set) and exports its weights; ``training:
false`` runs one modified-model eval of that dictionary. The last eval's means
print as one JSON line. With ``original_model: true`` the model is the backbone
itself: training (``train_original``) prints the epoch reached, the last
eval's means and the ``model_weights`` folder; ``training: false`` evaluates it.

Circuit discovery on GoogLeNet (``training: false``, the eight registry SAEs
loaded from their checkpoints): ``compute_ie`` "1" dataset averages, "2" node
IE, "3" edge IE (``ie_top_features``, ``ie_cotangent_chunk``), "4<i>"
faithfulness at threshold i of ``interp.circuit.FAITHFULNESS_THRESHOLDS`` (the
CSV and faithfulness.png). A mode prints one JSON line naming the files it
wrote. ``mis`` "1" (with ``training: false`` and the checkpoint's
``sae_checkpoint_epoch``) collects each unit's extreme train samples and prints
the eval means; "2" scores them and prints the median and mean MIS confidence
and the per-unit CSV it wrote.

``--multilayer LAYERS`` trains one registry SAE per layer from one backbone
pass (train/multilayer.py): ``circuit`` (the backbone's circuit layers) or a
comma list; ``transcoders`` trains one transcoder per same-geometry
consecutive circuit pair, ``transcoders:l1,l2,...`` pairs up that chain. It
prints one JSON line with each layer's (or pair's, as "in->out") last eval
means.

``--mesh_shape d[,m]`` trains the config on a mesh of d·m ranks
(parallel/distributed.spawn: one process a rank; rank r on ``cuda:(r %
cards)``): ``d`` data parallel, ``d,m`` tensor parallel (sae_mlp,
gated_sae, jumprelu_sae, matryoshka_sae, topk_sae, the transcoder and the
crosscoder), every rank with its
Pipeline (train/pipeline.py's module docstring); rank 0's result prints.
``--dist_backend`` is "nccl" (one card a rank) or "gloo" (ranks may share a
card, and the only backend on the CPU); its default is nccl on CUDA and gloo
with ``--device cpu``. Without ``--device cpu`` the mesh runs on CUDA and
fails when no GPU is present.

``--parameters FILE`` runs a sweep file in place of ``--config`` (exactly one
of the two): JSONL of RunConfig objects, or the reference's legacy lines, 24
fields (parameters.txt) or 17 (parameters_eval.txt), told apart by the first
line's field count. ``--line i`` runs only its 0-based line i (the reference's
cluster job arrays). Each entry runs as ``--config`` would run it, one by one;
with ``--vmap_sweep`` the cached dictionary-training entries that differ only
in (sae_lambda_sparse, sae_learning_rate, seed) train together, in one step off
one shared activation cache (train/sweep_vmap.py: train_sae_sweep_cached and
its transcoder and crosscoder twins; on the card one forward and one backward
launch of the fused kernels for all combos), and the rest one by one. It
prints one JSON line: {"parameters": FILE, "results": [...]}, an entry per
sweep group (its combos and their last evals) and per single run.

``--feature_report OUT.html`` writes the HTML feature report of the config's
run at its latest evaluated epoch (eval_tools/report.py, with the circuit
section from its ie_related_quantities folder), after the run when
``--run_pipeline`` is also given; the JSON line then names it under
"feature_report".
"""

from __future__ import annotations

import argparse
import dataclasses
import json
import math
import os

from sparse_vision_tpu_torch.config import RunConfig, Sweep, read_jsonl


def _load_parameters(path: str) -> list:
    """A sweep file's configs: JSONL of RunConfig, legacy 24-field
    parameters.txt lines or legacy 17-field parameters_eval.txt lines (told
    apart by the first line's field count)."""
    with open(path) as f:
        first = f.readline().strip()
    if first.startswith("{"):
        return read_jsonl(path)
    parse = (RunConfig.from_legacy_eval_line if len(first.split(",")) == 17
             else RunConfig.from_legacy_line)
    with open(path) as f:
        return [parse(line) for line in f if line.strip()]


def main(argv=None) -> dict:
    ap = argparse.ArgumentParser(prog="sparse_vision_tpu_torch.cli")
    ap.add_argument("--run_pipeline", action="store_true",
                    help="run one config, or every entry of --parameters")
    ap.add_argument("--config", default=None, help="RunConfig as a JSON object")
    ap.add_argument("--parameters", default=None, metavar="FILE",
                    help="sweep file: JSONL of RunConfig, or legacy 24-field parameters.txt "
                         "(17-field parameters_eval.txt) lines")
    ap.add_argument("--line", type=int, default=None,
                    help="run only this 0-based line of --parameters")
    ap.add_argument("--vmap_sweep", action="store_true",
                    help="with --parameters: train the entries that differ only in "
                         "(sae_lambda_sparse, sae_learning_rate, seed) together in one step "
                         "off one shared activation cache (train/sweep_vmap.py); the rest "
                         "run one by one")
    ap.add_argument("--feature_report", default=None, metavar="OUT",
                    help="write the HTML feature report of the config's run at its latest "
                         "evaluated epoch (after the run with --run_pipeline)")
    ap.add_argument("--device", default=None, help="torch device (default: cuda)")
    ap.add_argument("--mesh_shape", default=None, metavar="D[,M]",
                    help="train on a mesh of D (data) x M (model) ranks, one process each")
    ap.add_argument("--dist_backend", default=None, choices=("nccl", "gloo"),
                    help="torch.distributed backend of --mesh_shape (default: nccl on CUDA, "
                         "gloo with --device cpu)")
    ap.add_argument("--multilayer", default=None, metavar="LAYERS",
                    help="train the SAEs of 'circuit' or a comma list of layers, or "
                         "'transcoders[:l1,l2,...]', from one backbone pass "
                         "(train/multilayer.py), at the registry's hyperparameters")
    args = ap.parse_args(argv)
    if not args.run_pipeline and not args.feature_report:
        ap.error("nothing to do: pass --run_pipeline or --feature_report")
    if (args.config is None) == (args.parameters is None):
        ap.error("pass exactly one of --config and --parameters")
    if args.parameters is None and (args.line is not None or args.vmap_sweep):
        ap.error("--line and --vmap_sweep go with --parameters")
    if args.parameters is not None:
        if (not args.run_pipeline or args.feature_report or args.multilayer is not None
                or args.mesh_shape is not None):
            ap.error("--parameters runs with --run_pipeline alone (no --feature_report, "
                     "--multilayer or --mesh_shape: a line's mesh_shape field sets its mesh)")
        out = _run_parameters(args)
        print(json.dumps(out, sort_keys=True))
        return out

    cfg = RunConfig.from_json(args.config)
    if not args.run_pipeline:
        out = {"feature_report": _feature_report(cfg, args.feature_report)}
        print(json.dumps(out, sort_keys=True))
        return out

    if args.multilayer is not None:
        out = _multilayer(cfg, args.multilayer, args.device)
        print(json.dumps(out, sort_keys=True))
        return out
    if args.mesh_shape is not None:
        cfg = dataclasses.replace(
            cfg, mesh_shape=tuple(int(n) for n in args.mesh_shape.split(",") if n))
    out = _run_one(cfg, args)
    if args.feature_report:
        out = {"run": out, "feature_report": _feature_report(cfg, args.feature_report)}
    print(json.dumps(out, sort_keys=True))
    return out


def _run_parameters(args) -> dict:
    """``--parameters``: every entry of the file (or its ``--line``), with
    ``--vmap_sweep`` the sweepable groups through train_sae_sweep_cached."""
    from sparse_vision_tpu_torch.train.sweep_vmap import group_sweepable, train_sae_sweep_cached

    cfgs = _load_parameters(args.parameters)
    if args.line is not None:
        cfgs = [cfgs[args.line]]
    results, singles = [], cfgs
    if args.vmap_sweep:
        groups, singles = group_sweepable(cfgs)
        for base, overrides in groups:
            Sweep.validate(base)
            print(f"=== vmapped sweep ({len(overrides)} combos): {base.to_json()}")
            results.append({"config": json.loads(base.to_json()), "vmap_sweep": overrides,
                            "last_evals": train_sae_sweep_cached(base, overrides,
                                                                 device=args.device)})
    for cfg in singles:
        Sweep.validate(cfg)  # the sweep expansion's guards
        print(f"=== run: {cfg.to_json()}")
        results.append({"config": json.loads(cfg.to_json()), "result": _run_one(cfg, args)})
    return {"parameters": args.parameters, "results": results}


def _run_one(cfg: RunConfig, args):
    """One config through Pipeline.run (on a mesh of its mesh_shape's ranks when
    that is above one), its output as the JSON line shows it."""
    from sparse_vision_tpu_torch.train.pipeline import Pipeline

    if math.prod(cfg.mesh_shape) > 1:
        from sparse_vision_tpu_torch.parallel.distributed import spawn

        backend = args.dist_backend or ("gloo" if args.device == "cpu" else "nccl")
        return spawn(_mesh_rank, cfg.mesh_shape, cfg.to_json(), args.device,
                     device=args.device, backend=backend)[0]
    pipe = Pipeline(cfg, device=args.device)
    out = pipe.run()
    if cfg.compute_ie != "0":
        from sparse_vision_tpu_torch.interp.ie import MODE_FILES

        folder = pipe.paths["ie_related_quantities"]
        out = {"compute_ie": cfg.compute_ie,
               "wrote": [os.path.join(folder, f) for f in MODE_FILES[cfg.compute_ie[0]]]}
    elif cfg.original_model and cfg.training and cfg.mis == "0":
        out = {"original_model": "trained",
               "epoch": max(cfg.model_epochs, pipe._model_ckpt_epoch),
               "last_eval": pipe.eval_log[-1][1] if pipe.eval_log else None,
               "model_weights": pipe.paths["model_weights"]}
    elif cfg.mis == "2":
        folder = os.path.join(pipe.paths["evaluation_results"], "MIS")
        out = {"mis": "2", "median_mis": out["median_mis"], "average_mis": out["average_mis"],
               "wrote": [os.path.join(folder, f"{pipe.run_id}_mis_epoch_"
                                              f"{cfg.sae_checkpoint_epoch}.csv")]}
    return out


def _mesh_rank(rank: int, mesh, cfg_json: str, device):
    """One rank of ``--mesh_shape``: this rank's Pipeline on the config, run;
    rank 0 returns the last eval's means."""
    from sparse_vision_tpu_torch.train.pipeline import Pipeline

    return Pipeline(RunConfig.from_json(cfg_json), device=device, mesh=mesh).run()


def _feature_report(cfg: RunConfig, out_html: str) -> str:
    """eval_tools/report.py's report of ``cfg``'s run, with its IE folder."""
    from sparse_vision_tpu_torch.eval_tools.report import write_feature_report
    from sparse_vision_tpu_torch.utils.paths import folder_paths, run_id

    paths = folder_paths(cfg)
    out = write_feature_report(paths["evaluation_results"], run_id(cfg), out_html,
                               ie_dir=paths["ie_related_quantities"])
    print(f"Wrote feature report -> {out}")
    return out


def _multilayer(cfg: RunConfig, spec: str, device) -> dict:
    """``--multilayer``: {"multilayer": spec, "results": {layer or "in->out":
    last eval means}}."""
    from sparse_vision_tpu_torch.train import multilayer

    if spec.startswith("transcoders"):
        from sparse_vision_tpu_torch.models.backbone import make_backbone

        _, _, layer_list = spec.partition(":")
        pairs = None
        if layer_list:  # 'transcoders:l1,l2,l3' pairs up that chain
            pairs = multilayer.transcoder_pairs(
                make_backbone(cfg.model_name, cfg.dataset_name), cfg.dataset_name,
                [l for l in layer_list.split(",") if l])
            if not pairs:
                raise ValueError(f"--multilayer {spec}: no same-geometry consecutive pair")
        results = multilayer.train_transcoders_multilayer(cfg, pairs=pairs, device=device)
        results = {f"{a}->{b}": means for (a, b), means in results.items()}
    else:
        layers = None if spec == "circuit" else [l for l in spec.split(",") if l]
        results = multilayer.train_saes_multilayer(cfg, layers=layers, device=device)
    return {"multilayer": spec, "results": results}


if __name__ == "__main__":
    main()
