"""Command line of the port.

    python -m sparse_vision_tpu_torch.cli --run_pipeline --config '<RunConfig json>' [--device cpu]

Without ``--device`` the run goes to CUDA and fails when no GPU is present. The
config runs through ``Pipeline.run``: a training config trains an SAE variant, a
transcoder or a crosscoder (resuming from the checkpoint of
``sae_checkpoint_epoch`` when it is above 0, starting from the weights of
``sae_weights_path`` when it is set) and exports its weights; ``training:
false`` runs one modified-model eval of that dictionary. The last eval's means
print as one JSON line.

Circuit discovery on GoogLeNet (``training: false``, the eight registry SAEs
loaded from their checkpoints): ``compute_ie`` "1" dataset averages, "2" node
IE, "3" edge IE (``ie_top_features``, ``ie_cotangent_chunk``), "4<i>"
faithfulness at threshold i of ``interp.circuit.FAITHFULNESS_THRESHOLDS`` (the
CSV only; the port draws no figure). A mode prints one JSON line naming the
files it wrote.
"""

from __future__ import annotations

import argparse
import json
import os

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
    out = pipe.run()
    if cfg.compute_ie != "0":
        from sparse_vision_tpu_torch.interp.ie import MODE_FILES

        folder = pipe.paths["ie_related_quantities"]
        out = {"compute_ie": cfg.compute_ie,
               "wrote": [os.path.join(folder, f) for f in MODE_FILES[cfg.compute_ie[0]]]}
    print(json.dumps(out, sort_keys=True))
    return out


if __name__ == "__main__":
    main()
