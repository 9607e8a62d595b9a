"""Command line of the port.

    python -m sparse_vision_tpu_torch.cli --run_pipeline --config '<RunConfig json>' [--device cpu]

Without ``--device`` the run goes to CUDA and fails when no GPU is present. A
training config runs ``Pipeline.train_sae`` (an SAE variant, a transcoder or a
crosscoder); ``training: false`` runs one modified-model eval. The final eval means print as one JSON line.
"""

from __future__ import annotations

import argparse
import json

from sparse_vision_tpu_torch.config import RunConfig


def main(argv=None) -> dict:
    ap = argparse.ArgumentParser(prog="sparse_vision_tpu_torch.cli")
    ap.add_argument("--run_pipeline", action="store_true", help="run one config")
    ap.add_argument("--config", required=True, help="RunConfig as a JSON object")
    ap.add_argument("--device", default=None, help="torch device (default: cuda)")
    args = ap.parse_args(argv)
    if not args.run_pipeline:
        ap.error("nothing to do: pass --run_pipeline")

    from sparse_vision_tpu_torch.train.pipeline import Pipeline

    cfg = RunConfig.from_json(args.config)
    pipe = Pipeline(cfg, device=args.device)
    means = pipe.train_sae() if cfg.training else pipe.eval_modified(epoch=0)
    print(json.dumps(means, sort_keys=True))
    return means


if __name__ == "__main__":
    main()
