"""The port's weight export and import (sparse_vision_tpu_torch/train/sae_io.py)
against the JAX package's train/sae_io.py on the same seeded numpy weights: the
native .npz, the reference's nn.Linear .pth layout (and its legacy W_enc/W_dec
keys), and SAELens folders, each read by the other package; the port's own
safetensors writer and reader against the safetensors package."""

import json
import os

import jax.numpy as jnp
import numpy as np
import pytest
import torch
from safetensors.numpy import load_file, save_file

from sparse_vision_tpu.train import sae_io as jio
from sparse_vision_tpu_torch.train import sae_io as tio

D, H, D_OUT = 12, 48, 20
SHAPES = {
    "sae_mlp": {"W_enc": (D, H), "b_enc": (H,), "W_dec": (H, D), "b_dec": (D,)},
    "matryoshka_sae": {"W_enc": (D, H), "b_enc": (H,), "W_dec": (H, D), "b_dec": (D,)},
    "jumprelu_sae": {"W_enc": (D, H), "b_enc": (H,), "W_dec": (H, D), "b_dec": (D,),
                     "log_threshold": (H,)},
    "gated_sae": {"W_gate": (D, H), "b_gate": (H,), "b_mag": (H,), "r_mag": (H,),
                  "W_dec": (H, D), "b_dec": (D,)},
    "transcoder": {"W_enc": (D, H), "b_enc": (H,), "W_dec": (H, D_OUT), "b_dec": (D_OUT,)},
    "crosscoder": {"b_enc": (H,), **{f"{w}_{i}": s for i, d in enumerate((D, D_OUT, 8))
                                      for w, s in (("W_enc", (d, H)), ("W_dec", (H, d)),
                                                   ("b_dec", (d,)))}},
}
SAELENS = ("sae_mlp", "matryoshka_sae", "jumprelu_sae", "gated_sae")


def _weights(name, seed=0):
    rng = np.random.default_rng(seed)
    return {k: rng.standard_normal(s).astype(np.float32) for k, s in SHAPES[name].items()}


def _torch(tree):
    return {k: torch.from_numpy(v.copy()) for k, v in tree.items()}


def _assert_same(got, want):
    assert set(got) == set(want)
    for k in want:
        g = got[k].numpy() if isinstance(got[k], torch.Tensor) else np.asarray(got[k])
        w = want[k].numpy() if isinstance(want[k], torch.Tensor) else np.asarray(want[k])
        assert g.dtype == w.dtype and g.shape == w.shape, k
        np.testing.assert_array_equal(g, w, err_msg=k)


def _npz(path):
    with np.load(path) as z:
        return {k: z[k] for k in z.files}


@pytest.mark.parametrize("name", list(SHAPES))
def test_npz_keys_and_arrays_match_jax(name, tmp_path):
    w = _weights(name)
    jp = jio.save_sae_weights({k: jnp.asarray(v) for k, v in w.items()}, str(tmp_path / "j"),
                              file_name="x_model_weights")
    tp = tio.save_sae_weights(_torch(w), str(tmp_path / "t"), file_name="x_model_weights")
    assert os.path.basename(tp) == os.path.basename(jp) == "x_model_weights.npz"
    assert sorted(os.listdir(tmp_path / "t")) == ["x_model_weights.npz"]
    _assert_same(_npz(tp), _npz(jp))


@pytest.mark.parametrize("name", list(SHAPES))
def test_torch_state_dict_matches_jax(name):
    w = _weights(name)
    want = jio.to_torch_state_dict({k: jnp.asarray(v) for k, v in w.items()}, name)
    got = tio.to_torch_state_dict(_torch(w), name)
    _assert_same(got, want)
    assert all(v.is_contiguous() for v in got.values())


def _jax_files(name, w, folder):
    """The JAX package's .npz and .pth exports (its Pipeline's way), and its
    SAELens folder where the variant has one."""
    os.makedirs(folder, exist_ok=True)
    npz = jio.save_sae_weights({k: jnp.asarray(v) for k, v in w.items()}, folder)
    pth = os.path.join(folder, "w.pth")
    torch.save({k: torch.from_numpy(np.array(v)) for k, v in jio.to_torch_state_dict(
        {k: jnp.asarray(v) for k, v in w.items()}, name).items()}, pth)
    out = [npz, pth]
    if name in SAELENS:
        out.append(jio.save_sae_saelens(w, name, os.path.join(folder, "saelens")))
    return out


def _torch_files(name, w, folder):
    npz = tio.save_sae_weights(_torch(w), folder)
    pth = os.path.join(folder, "w.pth")
    torch.save(tio.to_torch_state_dict(_torch(w), name), pth)
    out = [npz, pth]
    if name in SAELENS:
        out.append(tio.save_sae_saelens(_torch(w), name, os.path.join(folder, "saelens")))
    return out


def _within_exp_log(name, got, want):
    """JumpReLU's SAELens threshold is exp(log_threshold): its round trip is not
    bitwise, so that entry is compared to a few ulp and then taken as equal."""
    if name == "jumprelu_sae" and "log_threshold" in want:
        g = np.asarray(got.pop("log_threshold"))
        np.testing.assert_allclose(g, np.asarray(want["log_threshold"]), rtol=1e-6, atol=1e-6)
        want = {k: v for k, v in want.items() if k != "log_threshold"}
    return got, want


@pytest.mark.parametrize("name", list(SHAPES))
def test_the_port_reads_the_jax_packages_files(name, tmp_path):
    w = _weights(name)
    for path in _jax_files(name, w, str(tmp_path)):
        got = tio.load_sae_weights(path, name)
        assert all(isinstance(v, torch.Tensor) for v in got.values())
        got, want = _within_exp_log(name, dict(got), w)
        _assert_same(got, want)
        like = _torch(_weights(name, seed=1))
        got = tio.import_any(path, name, like)
        got, want = _within_exp_log(name, dict(got), w)
        _assert_same(got, want)


@pytest.mark.parametrize("name", list(SHAPES))
def test_the_jax_package_reads_the_ports_files(name, tmp_path):
    w = _weights(name)
    for path in _torch_files(name, w, str(tmp_path)):
        got = {k: np.asarray(v) for k, v in jio.load_sae_weights(path, name).items()}
        got, want = _within_exp_log(name, got, w)
        _assert_same(got, want)


@pytest.mark.parametrize("name", SAELENS)
def test_saelens_folder_matches_jax(name, tmp_path):
    w = _weights(name)
    jdir = jio.save_sae_saelens(w, name, str(tmp_path / "j"))
    tdir = tio.save_sae_saelens(_torch(w), name, str(tmp_path / "t"))
    with open(os.path.join(jdir, "cfg.json")) as f, open(os.path.join(tdir, "cfg.json")) as g:
        assert json.load(g) == json.load(f)
    _assert_same(tio.load_safetensors(os.path.join(tdir, tio.SAELENS_WEIGHTS_FILE)),
                 load_file(os.path.join(jdir, jio.SAELENS_WEIGHTS_FILE)))
    # the variant comes from cfg.json's architecture when none is given
    params, cfg = tio.load_sae_saelens(jdir)
    assert cfg["d_sae"] == H and set(params) >= {"W_dec", "b_dec"}


def test_the_hand_written_safetensors_format_matches_the_package(tmp_path):
    rng = np.random.default_rng(3)
    tensors = {"w": rng.standard_normal((5, 7)).astype(np.float32),
               "a_scalar": np.asarray(2.5, np.float32),
               "h": rng.standard_normal(9).astype(np.float16),
               "d": rng.standard_normal((2, 3)).astype(np.float64),
               "i": rng.integers(-9, 9, (4,)).astype(np.int32),
               "q": rng.integers(-9, 9, (3, 3)).astype(np.int8),
               "m": rng.random(6) > 0.5,
               "empty": np.zeros((0, 4), np.float32)}
    ours = tio.save_safetensors(tensors, str(tmp_path / "ours.safetensors"),
                                metadata={"format": "np"})
    _assert_same(load_file(ours), tensors)
    theirs = str(tmp_path / "theirs.safetensors")
    save_file(tensors, theirs, metadata={"format": "np"})
    _assert_same(tio.load_safetensors(theirs), tensors)
    raw = open(ours, "rb").read()
    n = int.from_bytes(raw[:8], "little")
    assert n % 8 == 0 and json.loads(raw[8:8 + n])["__metadata__"] == {"format": "np"}
    with open(str(tmp_path / "cut.safetensors"), "wb") as f:
        f.write(raw[:-4])
    with pytest.raises(ValueError):
        tio.load_safetensors(str(tmp_path / "cut.safetensors"))


def test_legacy_w_enc_w_dec_state_dicts_migrate_as_in_jax(tmp_path):
    w = _weights("jumprelu_sae")
    legacy = {k: torch.from_numpy(v.copy()) for k, v in w.items()}  # stored in math layout
    want = jio._normalize_state_dict({k: v.numpy() for k, v in legacy.items()}, "jumprelu_sae")
    _assert_same(tio._normalize_state_dict(legacy, "jumprelu_sae"), want)
    path = str(tmp_path / "legacy.pth")
    torch.save(legacy, path)
    _assert_same(tio.import_any(path, "jumprelu_sae", _torch(_weights("jumprelu_sae", 1))), w)
    # ReLU weights imported into JumpReLU keep the template's thresholds
    relu = {k: v for k, v in legacy.items() if k != "log_threshold"}
    torch.save(relu, path)
    like = _torch(_weights("jumprelu_sae", 1))
    got = tio.import_any(path, "jumprelu_sae", like)
    assert torch.equal(got["log_threshold"], like["log_threshold"])


def test_import_refuses_missing_keys_and_other_shapes(tmp_path):
    w = _weights("sae_mlp")
    path = tio.save_sae_weights(_torch(w), str(tmp_path))
    with pytest.raises(KeyError, match="W_gate"):
        tio.import_any(path, "gated_sae", _torch(_weights("gated_sae")))
    wide = {k: torch.zeros(tuple(2 * s for s in v.shape)) for k, v in _torch(w).items()}
    with pytest.raises(ValueError, match="shape mismatch"):
        tio.import_any(path, "sae_mlp", wide)


def test_a_saelens_folder_of_a_variant_not_ported_is_refused(tmp_path):
    w = _weights("sae_mlp")
    folder = tio.save_sae_saelens(_torch(w), "sae_mlp", str(tmp_path / "s"))
    cpath = os.path.join(folder, tio.SAELENS_CFG_FILE)
    with open(cpath) as f:
        cfg = json.load(f)
    with open(cpath, "w") as f:
        json.dump({**cfg, "architecture": "topk"}, f)
    with pytest.raises(ValueError, match="'topk' is not ported"):
        tio.load_sae_saelens(folder)
    with pytest.raises(ValueError, match="no SAELens mapping"):
        tio.save_sae_saelens(_torch(w), "topk_sae", str(tmp_path / "t"))
