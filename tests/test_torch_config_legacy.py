"""The port's legacy sweep formats (sparse_vision_tpu_torch/config.py) against
the JAX package's config.py, both ways: the reference's 24-field parameters.txt
and 17-field parameters_eval.txt lines, the typed Sweep (its expansion, its
guards and its three writers) and read_jsonl. Every comparison goes through
each package's own to_json (the same field names and defaults), so a field
that parses differently shows as a differing key."""

import dataclasses
import json

import pytest

from sparse_vision_tpu import config as jconfig
from sparse_vision_tpu_torch import config as tconfig

# reference-style lines: defaults, an ImageNet sweep line with a resume epoch,
# an original-model line, and the lower-case and 0/1 booleans the parser takes
LINES = [
    "custom_mlp_9,sae_mlp,fc1,runs,False,1,0.001,64,adam,1,0.001,constrained_adam,64,0.1,2,"
    "mnist,True,False,cross_entropy,sae_loss,200,0,0,0",
    "inceptionv1,gated_sae,mixed3a,/data/runs,False,10,0.0005,256,sgd,5,0.0003,adam,128,5.0,"
    "64,imagenet,False,False,cross_entropy,sae_loss,1000,1,0,3",
    "resnet18,sae_mlp,layer4.1,runs,false,7,0.1,32,sgd_w_scheduler,1,0.001,constrained_adam,"
    "32,0.5,8,tiny_imagenet,1,true,negative_log_likelihood,sae_loss,50,0,42,0",
]
EVAL_LINES = [
    "custom_mlp_9,sae_mlp,fc1,runs,False,1,0.001,64,adam,1,0.001,constrained_adam,64,mnist,"
    "False,200,1",
    "inceptionv1,jumprelu_sae,mixed4c,runs,True,3,0.01,128,sgd,2,0.002,adam,512,imagenet,"
    "True,10,2",
]
CONFIGS = [
    {},
    {"model_name": "inceptionv1", "sae_model_name": "matryoshka_sae", "sae_layer": "mixed3b",
     "sae_lambda_sparse": 2.5, "sae_expansion_factor": 16, "training": False, "mis": "2",
     "sae_checkpoint_epoch": 4, "dataset_name": "imagenet", "use_activation_cache": True},
    {"original_model": True, "sae_model_name": "None", "model_learning_rate": 1e-4,
     "model_optimizer_name": "sgd", "wandb_status": True, "compute_ie": "41"},
]


def _same(tcfg, jcfg) -> None:
    assert json.loads(tcfg.to_json()) == json.loads(jcfg.to_json())


def test_the_legacy_field_orders_are_the_jax_packages():
    assert tconfig.LEGACY_FIELDS == jconfig.LEGACY_FIELDS
    assert tconfig.LEGACY_EVAL_FIELDS == jconfig.LEGACY_EVAL_FIELDS


@pytest.mark.parametrize("line", LINES)
def test_from_legacy_line_matches_jax(line):
    _same(tconfig.RunConfig.from_legacy_line(line), jconfig.RunConfig.from_legacy_line(line))


@pytest.mark.parametrize("line", EVAL_LINES)
def test_from_legacy_eval_line_matches_jax(line):
    _same(tconfig.RunConfig.from_legacy_eval_line(line),
          jconfig.RunConfig.from_legacy_eval_line(line))


def test_legacy_parsers_take_overrides_as_jax():
    over = {"use_activation_cache": True, "cache_tokens_per_step": 128, "seed": 5}
    _same(tconfig.RunConfig.from_legacy_line(LINES[1], **over),
          jconfig.RunConfig.from_legacy_line(LINES[1], **over))
    _same(tconfig.RunConfig.from_legacy_eval_line(EVAL_LINES[0], **over),
          jconfig.RunConfig.from_legacy_eval_line(EVAL_LINES[0], **over))


@pytest.mark.parametrize("fields", CONFIGS)
def test_to_legacy_lines_match_jax_and_parse_back(fields):
    t, j = tconfig.RunConfig(**fields), jconfig.RunConfig(**fields)
    assert t.to_legacy_line() == j.to_legacy_line()
    assert t.to_legacy_eval_line() == j.to_legacy_eval_line()
    # each package reads the other's line to the same config
    _same(tconfig.RunConfig.from_legacy_line(j.to_legacy_line()),
          jconfig.RunConfig.from_legacy_line(t.to_legacy_line()))


@pytest.mark.parametrize("bad", [
    LINES[0] + ",extra",  # 25 fields
    LINES[0].replace(",False,1,0.001", ",maybe,1,0.001", 1),  # a boolean the parser refuses
    LINES[0].replace(",64,adam", ",sixty-four,adam", 1),  # an int that is not one
])
def test_bad_legacy_lines_raise_as_in_jax(bad):
    with pytest.raises(ValueError) as t_err:
        tconfig.RunConfig.from_legacy_line(bad)
    with pytest.raises(ValueError) as j_err:
        jconfig.RunConfig.from_legacy_line(bad)
    assert str(t_err.value) == str(j_err.value)


def _sweeps(axes: dict, **base):
    return (tconfig.Sweep(axes=axes, base=tconfig.RunConfig(**base)),
            jconfig.Sweep(axes=axes, base=jconfig.RunConfig(**base)))


SWEEP_AXES = {"sae_lambda_sparse": [0.1, 1.0, 5.0], "sae_learning_rate": [1e-3, 3e-4],
              "sae_model_name": ["sae_mlp", "gated_sae"]}


def test_sweep_expands_as_jax():
    t, j = _sweeps(SWEEP_AXES, dataset_name="imagenet", model_name="inceptionv1")
    t_list, j_list = list(t), list(j)
    assert len(t_list) == len(j_list) == 12
    for a, b in zip(t_list, j_list):
        _same(a, b)


@pytest.mark.parametrize("fields", [
    {"original_model": True, "compute_ie": "1", "training": False},
    {"compute_ie": "2", "training": True},
    {"mis": "1", "training": True},
])
def test_sweep_guards_raise_as_jax(fields):
    t, j = _sweeps({"sae_lambda_sparse": [0.1]}, **fields)
    with pytest.raises(ValueError) as t_err:
        list(t)
    with pytest.raises(ValueError) as j_err:
        list(j)
    assert str(t_err.value) == str(j_err.value)


@pytest.mark.parametrize("writer", ["write_jsonl", "write_legacy", "write_legacy_eval"])
def test_sweep_files_equal_jax_byte_for_byte(writer, tmp_path):
    t, j = _sweeps(SWEEP_AXES, sae_epochs=3)
    tp, jp = tmp_path / "t.txt", tmp_path / "j.txt"
    assert getattr(t, writer)(str(tp)) == getattr(j, writer)(str(jp))
    assert tp.read_bytes() == jp.read_bytes()


def test_write_legacy_eval_collapses_the_per_lambda_runs_as_jax(tmp_path):
    t, _ = _sweeps({"sae_lambda_sparse": [0.1, 0.2, 0.3], "sae_epochs": [1, 2]})
    assert t.write_legacy_eval(str(tmp_path / "e.txt")) == 2  # λ is no eval field


def test_read_jsonl_reads_what_either_package_wrote(tmp_path):
    t, j = _sweeps(SWEEP_AXES, mesh_shape=(2, 2), use_activation_cache=True)
    j.write_jsonl(str(tmp_path / "j.jsonl"))
    t.write_jsonl(str(tmp_path / "t.jsonl"))
    got_t = tconfig.read_jsonl(str(tmp_path / "j.jsonl"))
    got_j = jconfig.read_jsonl(str(tmp_path / "t.jsonl"))
    assert [c.mesh_shape for c in got_t] == [(2, 2)] * 12
    for a, b in zip(got_t, got_j):
        _same(a, b)


def test_the_configs_are_frozen_dataclasses_of_the_same_fields():
    tf = [f.name for f in dataclasses.fields(tconfig.RunConfig)]
    jf = [f.name for f in dataclasses.fields(jconfig.RunConfig)]
    assert tf == jf
    with pytest.raises(dataclasses.FrozenInstanceError):
        tconfig.RunConfig().seed = 1
