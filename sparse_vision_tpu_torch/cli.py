"""Command line of the port.

    python -m sparse_vision_tpu_torch.cli --run_pipeline --config '<RunConfig json>' [--device cpu]

Without ``--device`` the run goes to CUDA and fails when no GPU is present. The
config runs through ``Pipeline.run``: a training config trains an SAE variant, a
transcoder or a crosscoder (resuming from the checkpoint of
``sae_checkpoint_epoch`` when it is above 0, starting from the weights of
``sae_weights_path`` when it is set) and exports its weights; ``training:
false`` runs one modified-model eval of that dictionary. The last eval's means
print as one JSON line.
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
    means = Pipeline(cfg, device=args.device).run()
    print(json.dumps(means, sort_keys=True))
    return means


if __name__ == "__main__":
    main()
