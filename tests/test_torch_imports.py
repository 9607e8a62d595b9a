"""The port stands alone: no file of sparse_vision_tpu_torch/ and not chip_smoke.py
imports jax, optax, orbax, ml_dtypes or the JAX package (sparse_vision_tpu), nor
safetensors, matplotlib, pandas or wandb, which the GPU machine does not have.
Without a GPU, the default entry points raise instead of running on the CPU,
the mesh's too (parallel/distributed.py, the CLI's --mesh_shape)."""

import ast
import shutil
import subprocess
import sys
from pathlib import Path

import pytest
import torch

ROOT = Path(__file__).resolve().parent.parent
FORBIDDEN = {"jax", "jaxlib", "optax", "orbax", "ml_dtypes", "sparse_vision_tpu",
             "safetensors", "matplotlib", "pandas", "wandb"}
FILES = sorted((ROOT / "sparse_vision_tpu_torch").rglob("*.py")) + [ROOT / "chip_smoke.py"]


def _imported_roots(path: Path) -> set:
    roots = set()
    for node in ast.walk(ast.parse(path.read_text(), filename=str(path))):
        if isinstance(node, ast.Import):
            roots.update(a.name.split(".")[0] for a in node.names)
        elif isinstance(node, ast.ImportFrom) and node.level == 0 and node.module:
            roots.add(node.module.split(".")[0])
    return roots


@pytest.mark.parametrize("path", FILES, ids=lambda p: str(p.relative_to(ROOT)))
def test_no_jax_and_no_jax_package_imports(path):
    bad = _imported_roots(path) & FORBIDDEN
    assert not bad, f"{path.relative_to(ROOT)} imports {sorted(bad)}"


def test_the_walk_sees_every_module():
    names = {p.relative_to(ROOT).as_posix() for p in FILES}
    for must in ("chip_smoke.py", "sparse_vision_tpu_torch/ops/fused_sae.py",
                 "sparse_vision_tpu_torch/ops/fused_gated_sae.py",
                 "sparse_vision_tpu_torch/ops/fused_jumprelu_sae.py",
                 "sparse_vision_tpu_torch/ops/fused_matryoshka_sae.py",
                 "sparse_vision_tpu_torch/ops/fused_transcoder.py",
                 "sparse_vision_tpu_torch/ops/fused_crosscoder.py",
                 "sparse_vision_tpu_torch/models/crosscoder.py",
                 "sparse_vision_tpu_torch/train/paired_caches.py",
                 "sparse_vision_tpu_torch/train/transcoder.py",
                 "sparse_vision_tpu_torch/train/crosscoder.py",
                 "sparse_vision_tpu_torch/train/pipeline.py",
                 "sparse_vision_tpu_torch/data/labels.py",
                 "sparse_vision_tpu_torch/interp/ie_math.py",
                 "sparse_vision_tpu_torch/interp/patching.py",
                 "sparse_vision_tpu_torch/interp/circuit.py",
                 "sparse_vision_tpu_torch/interp/registry.py",
                 "sparse_vision_tpu_torch/interp/ie.py",
                 "sparse_vision_tpu_torch/interp/transcoder_circuit.py",
                 "sparse_vision_tpu_torch/interp/mis.py",
                 "sparse_vision_tpu_torch/train/multilayer.py",
                 "sparse_vision_tpu_torch/ops/fast_topk_sae.py",
                 "sparse_vision_tpu_torch/ops/fast_batch_topk.py",
                 "sparse_vision_tpu_torch/ops/histograms.py",
                 "sparse_vision_tpu_torch/eval_tools/draw.py",
                 "sparse_vision_tpu_torch/eval_tools/viz.py",
                 "sparse_vision_tpu_torch/eval_tools/figures.py",
                 "sparse_vision_tpu_torch/eval_tools/report.py",
                 "sparse_vision_tpu_torch/utils/profiling.py",
                 "sparse_vision_tpu_torch/train/e2e_finetune.py",
                 "sparse_vision_tpu_torch/ops/fused_sae_tp.py",
                 "sparse_vision_tpu_torch/parallel/distributed.py",
                 "sparse_vision_tpu_torch/parallel/mesh.py",
                 "sparse_vision_tpu_torch/parallel/sharded_steps.py",
                 "sparse_vision_tpu_torch/parallel/tensor_parallel.py"):
        assert must in names


@pytest.mark.parametrize("spec", ["mixed4c,mixed4d", "circuit", "transcoders",
                                  "transcoders:mixed4c,mixed4d"])
def test_multilayer_entry_points_default_to_cuda(spec, monkeypatch):
    """train/multilayer.py's functions, load_pair_params and the CLI's
    --multilayer build their Pipelines on CUDA unless given device="cpu"."""
    from sparse_vision_tpu_torch import cli
    from sparse_vision_tpu_torch.config import RunConfig
    from sparse_vision_tpu_torch.interp.transcoder_circuit import load_pair_params
    from sparse_vision_tpu_torch.train import multilayer

    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    cfg = RunConfig(model_name="inceptionv1", dataset_name="imagenet", sae_layer="mixed4c",
                    use_activation_cache=True)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        cli.main(["--run_pipeline", "--config", cfg.to_json(), "--multilayer", spec])
    if spec == "circuit":
        with pytest.raises(RuntimeError, match="device='cpu'"):
            multilayer.train_saes_multilayer(cfg)
        with pytest.raises(RuntimeError, match="device='cpu'"):
            multilayer.train_transcoders_multilayer(cfg)
        with pytest.raises(RuntimeError, match="device='cpu'"):
            load_pair_params(cfg, [("mixed4c", "mixed4d")])


def test_resolve_device_raises_without_a_gpu(monkeypatch):
    from sparse_vision_tpu_torch.device import resolve_device

    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        resolve_device(None)
    assert resolve_device("cpu") == torch.device("cpu")


def test_cli_without_device_raises_without_a_gpu(monkeypatch):
    from sparse_vision_tpu_torch import cli

    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    cfg = ('{"model_name": "inceptionv1", "dataset_name": "imagenet", '
           '"sae_layer": "mixed3a", "use_activation_cache": true}')
    with pytest.raises(RuntimeError, match="device='cpu'"):
        cli.main(["--run_pipeline", "--config", cfg])


@pytest.mark.parametrize("name", ["sae_mlp", "sae_conv", "topk_sae", "batch_topk_sae"])
def test_uncached_training_defaults_to_cuda(name, monkeypatch):
    """A training run without an activation cache (the JAX package's default)
    builds its Pipeline on CUDA unless given device="cpu", through the CLI
    and through Pipeline itself."""
    from sparse_vision_tpu_torch import cli
    from sparse_vision_tpu_torch.config import RunConfig
    from sparse_vision_tpu_torch.train.pipeline import Pipeline

    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    cfg = RunConfig(model_name="inceptionv1", dataset_name="imagenet", sae_layer="mixed3a",
                    sae_model_name=name, use_activation_cache=False)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        cli.main(["--run_pipeline", "--config", cfg.to_json()])
    with pytest.raises(RuntimeError, match="device='cpu'"):
        Pipeline(cfg, datasets=((), (), [], (32, 32, 3)))


def test_mesh_entry_points_default_to_cuda(monkeypatch):
    """parallel/distributed.spawn and initialize, and the CLI's --mesh_shape,
    start their ranks on CUDA unless given device="cpu" (the CLI's --device
    cpu): without a GPU they raise before any rank starts."""
    from sparse_vision_tpu_torch import cli
    from sparse_vision_tpu_torch.parallel import distributed

    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        distributed.spawn(print, (2, 2), backend="gloo")
    with pytest.raises(RuntimeError, match="device='cpu'"):
        distributed.initialize((2, 2), 0, "file:///nonexistent/store", backend="gloo")
    cfg = ('{"model_name": "inceptionv1", "dataset_name": "imagenet", '
           '"sae_layer": "mixed3a", "use_activation_cache": true}')
    for backend in ([], ["--dist_backend", "gloo"]):
        with pytest.raises(RuntimeError, match="device='cpu'"):
            cli.main(["--run_pipeline", "--mesh_shape", "2,2", "--config", cfg, *backend])


def test_nccl_with_more_ranks_than_cards_raises_naming_gloo(monkeypatch):
    """NCCL refuses two ranks on one card: the port raises and names gloo
    rather than switch the backend."""
    from sparse_vision_tpu_torch.parallel import distributed

    monkeypatch.setattr(torch.cuda, "is_available", lambda: True)
    monkeypatch.setattr(torch.cuda, "device_count", lambda: 1)
    with pytest.raises(ValueError, match='backend="gloo"'):
        distributed.spawn(print, (2, 2), device="cuda", backend="nccl")
    with pytest.raises(ValueError, match='backend="gloo"'):
        distributed.initialize((2,), 0, "file:///nonexistent/store", backend="nccl",
                               device="cuda")


def test_chip_smoke_refuses_to_run_without_a_gpu(monkeypatch, capsys):
    import chip_smoke

    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    monkeypatch.setattr(sys, "argv", ["chip_smoke.py"])
    with pytest.raises(SystemExit) as exc:
        chip_smoke.main()
    assert exc.value.code not in (0, None)
    assert capsys.readouterr().out == ""


def test_chip_smoke_alone_in_a_directory_fails(tmp_path):
    shutil.copy(ROOT / "chip_smoke.py", tmp_path / "chip_smoke.py")
    proc = subprocess.run([sys.executable, "chip_smoke.py"], cwd=tmp_path,
                          capture_output=True, text=True, timeout=120)
    assert proc.returncode != 0
    assert '"ok": true' not in proc.stdout
