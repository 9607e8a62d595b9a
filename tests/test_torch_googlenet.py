"""The port's GoogLeNet against the JAX package's with converted weights
(convert.backbone_from_jax): logits, the mixed3a tap and apply_segment from
mixed3a to the logits. BatchNorm parameters and statistics are randomized so
their conversion is exercised.

Tolerance: rtol 1e-4 with atol 1e-4 of the reference's largest magnitude (f32
convolutions on both sides, summed in different orders through 60 layers).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from sparse_vision_tpu.models import backbone as jbackbone
from sparse_vision_tpu.models.googlenet import make_googlenet as j_make
from sparse_vision_tpu_torch import convert
from sparse_vision_tpu_torch.models import backbone as tbackbone
from sparse_vision_tpu_torch.models.googlenet import make_googlenet as t_make
from sparse_vision_tpu_torch.models.layers import pool_out_dim

SIZE = 64


def close(t, j):
    j = np.asarray(j)
    np.testing.assert_allclose(t.numpy(), j, rtol=1e-4, atol=1e-4 * np.abs(j).max())


def _randomize_bn(tree, rng):
    out = {}
    for k, v in tree.items():
        if isinstance(v, dict):
            out[k] = _randomize_bn(v, rng)
        elif k in ("scale", "var"):
            out[k] = rng.uniform(0.5, 1.5, size=np.shape(v)).astype(np.float32)
        elif k in ("bias", "mean"):
            out[k] = rng.normal(0, 0.1, size=np.shape(v)).astype(np.float32)
        else:
            out[k] = np.asarray(v)
    return out


@pytest.fixture(scope="module")
def nets():
    jnet = j_make()
    params, state = jnet.init(jax.random.key(0), (SIZE, SIZE, 3))
    rng = np.random.default_rng(0)
    params = _randomize_bn(jax.device_get(params), rng)
    state = _randomize_bn(jax.device_get(state), rng)
    x = rng.normal(size=(2, SIZE, SIZE, 3)).astype(np.float32)

    @jax.jit
    def run(p, s, xx):
        logits, taps, _ = jnet.apply(p, xx, state=s)
        seg = jnet.apply_segment(p, taps["mixed3a"], after="mixed3a", upto="fc", state=s)
        return logits, taps["mixed3a"], seg

    jout = jax.device_get(run(params, state, jnp.asarray(x)))
    tnet = t_make()
    tp, ts = convert.backbone_from_jax(params, state)
    return jout, tnet, tp, ts, x


def test_logits_and_mixed3a_tap_match_jax(nets):
    (jlogits, jtap, _), tnet, tp, ts, x = nets
    with torch.no_grad():
        logits, taps, _ = tnet.apply(tp, torch.from_numpy(x), state=ts)
    assert tuple(taps["mixed3a"].shape) == jtap.shape == (2, 8, 8, 256)
    close(taps["mixed3a"], jtap)
    close(logits, jlogits)


def test_apply_segment_after_mixed3a_matches_jax(nets):
    (_, jtap, jseg), tnet, tp, ts, _ = nets
    with torch.no_grad():
        seg = tnet.apply_segment(tp, torch.from_numpy(np.array(jtap)), after="mixed3a",
                                 upto="fc", state=ts)
    close(seg, jseg)


def test_stop_at_and_splice(nets):
    _, tnet, tp, ts, x = nets
    xt = torch.from_numpy(x)
    with torch.no_grad():
        out, taps, _ = tnet.apply(tp, xt, state=ts, stop_at="mixed3a")
        assert "mixed3b" not in taps and torch.equal(out, taps["mixed3a"])
        # splicing the identity changes nothing; splicing zeros reaches the logits
        full, _, _ = tnet.apply(tp, xt, state=ts)
        same, _, _ = tnet.apply(tp, xt, state=ts, splice=("mixed3a", lambda a: a))
        zero, ztaps, _ = tnet.apply(tp, xt, state=ts, splice=("mixed3a", torch.zeros_like))
    assert torch.equal(full, same)
    assert float(ztaps["mixed3a"].abs().max()) == 0.0 and not torch.equal(full, zero)


def test_layer_dimensions_match_jax_at_229px():
    jnet = jbackbone.make_backbone("inceptionv1", "imagenet")
    tnet = tbackbone.make_backbone("inceptionv1", "imagenet")
    jd = jbackbone.layer_dimensions(jnet, "imagenet")
    td = tbackbone.layer_dimensions(tnet, "imagenet")
    assert td == {k: tuple(v) for k, v in jd.items()}
    assert td["mixed3a"] == (28, 28, 256)
    assert tbackbone.get_sae_input_size(tnet, "imagenet", "mixed3a") == 256


@pytest.mark.parametrize("window,stride", [(3, 2), (2, 2)])
def test_maxpool_ceil_rule_matches_torch(window, stride):
    for n in range(4, 40):
        out = torch.nn.functional.max_pool2d(torch.zeros(1, 1, n, n), window, stride,
                                             ceil_mode=True)
        assert out.shape[-1] == pool_out_dim(n, window, stride, 0, True), n


def test_unported_backbone_raises():
    # every name the JAX factory builds is ported (test_torch_backbones.py);
    # one that it refuses, the port refuses as it does
    with pytest.raises(ValueError, match="Unsupported model"):
        tbackbone.make_backbone("alexnet", "imagenet")
