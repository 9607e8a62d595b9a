"""The port stands alone: no file of sparse_vision_tpu_torch/ and not chip_smoke.py
imports jax, optax, orbax, ml_dtypes or the JAX package (sparse_vision_tpu), nor
safetensors, matplotlib, pandas or wandb, which the GPU machine does not have.
Without a GPU, the default entry points raise instead of running on the CPU."""

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
                 "sparse_vision_tpu_torch/train/pipeline.py"):
        assert must in names


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
