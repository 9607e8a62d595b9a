"""The port's run-ID and path scheme (sparse_vision_tpu_torch/utils/paths.py)
against the JAX package's utils/paths.py: the same names for every ported
variant, the transcoder and the crosscoder, so both packages write a run's
checkpoints, exports, results and top-k files under the same names."""

import pytest

from sparse_vision_tpu.config import RunConfig as JConfig
from sparse_vision_tpu.utils import paths as jpaths
from sparse_vision_tpu_torch.config import RunConfig as TConfig
from sparse_vision_tpu_torch.utils import paths as tpaths

BASE = dict(model_name="inceptionv1", dataset_name="imagenet", sae_layer="mixed3a",
            sae_expansion_factor=64, sae_lambda_sparse=5.0, sae_learning_rate=1e-3,
            sae_batch_size=256, sae_epochs=3, directory_path="runs/x")
CONFIGS = {
    "sae_mlp": {},
    "gated_sae": {},
    "jumprelu_sae": {},
    "matryoshka_sae": {},
    "transcoder": {"transcoder_target_layer": "mixed3b"},
    "crosscoder": {"sae_layer": "mixed4a", "crosscoder_layers": " mixed4b, mixed4c ,",
                   "sae_optimizer_name": "adam"},
}


def _pair(name, **extra):
    cfg = {**BASE, "sae_model_name": name, **CONFIGS[name], **extra}
    return JConfig(**cfg), TConfig(**cfg)


@pytest.mark.parametrize("name", list(CONFIGS))
def test_run_id_and_every_folder_match_jax(name):
    j, t = _pair(name)
    assert tpaths.run_id(t) == jpaths.run_id(j)
    assert tpaths.folder_paths(t) == jpaths.folder_paths(j)
    assert tpaths.sae_params_dict(t) == jpaths.sae_params_dict(j)
    assert tpaths.sae_params_no_epochs(t) == jpaths.sae_params_no_epochs(j)
    assert tpaths.model_params_dict(t) == jpaths.model_params_dict(j)
    # the name JAX gives a run's checkpoint folder, exports and decoder-norm CSV
    assert tpaths.sae_run_name(t) == f"{j.sae_layer}_" + "_".join(
        str(v) for v in jpaths.sae_params_no_epochs(j).values())


@pytest.mark.parametrize("name", list(CONFIGS))
def test_the_run_id_leaves_out_the_epoch_count(name):
    (j3, t3), (j9, t9) = _pair(name), _pair(name, sae_epochs=9, sae_checkpoint_epoch=3)
    assert tpaths.run_id(t3) == tpaths.run_id(t9) == jpaths.run_id(j9)
    assert tpaths.sae_params_dict(t3) != tpaths.sae_params_dict(t9)


def test_original_model_run_id_and_file_paths_match_jax(tmp_path):
    j, t = _pair("sae_mlp", original_model=True)
    assert tpaths.run_id(t) == jpaths.run_id(j)
    params = {"a": 1, "b": None, "c": "x"}
    assert tpaths.join_params(params) == jpaths.join_params(params) == "1_None_x"
    for kwargs in ({"sae_layer": "fc1", "params": params, "file_name": "w"},
                   {"sae_layer": "fc1", "params": params, "params2": {"d": 2},
                    "file_name": ".csv"},
                   {"sae_layer": "fc1", "file_name": None},
                   {"folder_path": str(tmp_path / "f"), "sae_layer": "fc1", "params": "p",
                    "file_name": "w"}):
        assert tpaths.get_file_path(**kwargs) == jpaths.get_file_path(**kwargs)
    assert (tmp_path / "f").is_dir()
