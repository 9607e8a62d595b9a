"""The port's CircuitEngine (sparse_vision_tpu_torch/interp/circuit.py) against the
JAX package's on the same weights (the JAX nets' and SAEs', carried over with
convert.py) and the same batches (numpy, from a seed): dataset averages, node
IE, edge IE (one cotangent chunk, and chunks of 2) and faithfulness (the zero /
mean / circuit SAE variants and the model-neuron variant, at threshold -1,
at a threshold inside the IE values and at 1e9), for sae_mlp, gated_sae,
jumprelu_sae (through the STE functions under torch.func) and batch_topk_sae
(its deployment form, gated at the scalar threshold) SAEs on the tiny conv net
of tests/test_circuit.py, and for jumprelu_sae on a 2-D net.

The SAEs get non-zero biases (and JumpReLU and BatchTopK thresholds that switch
latents off),
so codes, errors and the dead masks are not trivial. Tolerances (f32, tiny
nets, sums in another order): averages rtol 1e-5 / atol 1e-6; IE values
rtol 1e-4 / atol 1e-7; the dead masks and the faithfulness node counts
exactly; faithfulness losses rtol 1e-6 (a few f32 ulps), and each ratio
(m_C - m_empty) / (m_M - m_empty) within that loss tolerance carried through
the ratio: on these random nets m_M - m_empty is ~1e-3 of the losses, so one
ulp of a loss moves the ratio by ~1e-4.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from sparse_vision_tpu.interp.circuit import (
    FAITHFULNESS_THRESHOLDS as J_THRESHOLDS,
)
from sparse_vision_tpu.interp.circuit import CircuitEngine as JEngine
from sparse_vision_tpu.interp.circuit import FrozenSAE as JFrozen
from sparse_vision_tpu.models import layers as jl
from sparse_vision_tpu.models.sae import init_sae
from sparse_vision_tpu.ops.losses import cross_entropy as j_ce
from sparse_vision_tpu_torch import convert
from sparse_vision_tpu_torch.interp.circuit import FAITHFULNESS_THRESHOLDS, CircuitEngine, FrozenSAE
from sparse_vision_tpu_torch.models import layers as tl
from sparse_vision_tpu_torch.ops.losses import cross_entropy as t_ce

K = 2  # expansion factor
B = 3
NETS = {
    # tests/test_circuit.py's net: SAEs at both ReLUs (4 x 4 x 5, 4 x 4 x 6)
    "conv": (lambda m: m.SeqNet([m.conv("conv1", 5, kernel=3, padding=1), m.relu("relu1"),
                                 m.conv("conv2", 6, kernel=3, padding=1), m.relu("relu2"),
                                 m.flatten("flatten"), m.linear("fc", 4)]),
             (4, 4, 3), {"relu1": 5, "relu2": 6}),
    "dense": (lambda m: m.SeqNet([m.linear("l1", 8), m.relu("a1"), m.linear("l2", 6),
                                  m.relu("a2"), m.linear("l3", 4)]),
              (6,), {"a1": 8, "a2": 6}),
}
VARIANTS = ("sae_mlp", "gated_sae", "jumprelu_sae", "batch_topk_sae")
# biases (and JumpReLU log-thresholds) drawn away from their zero init
PERTURBED = {"b_enc": 0.1, "b_dec": 0.1, "b_gate": 0.1, "b_mag": 0.1, "r_mag": 0.1}


@pytest.fixture(scope="module", autouse=True)
def one_torch_thread():
    """The port's passes here are small: one intra-op thread is as fast alone,
    and much faster when the test workers oversubscribe the cores."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _sae(name: str, c: int, seed: int) -> dict:
    p = jax.device_get(init_sae(name, jax.random.key(seed), c, K))
    rng = np.random.default_rng(seed)
    p = {k: np.array(v) for k, v in p.items()}
    for k, scale in PERTURBED.items():
        if k in p:
            p[k] = (scale * rng.standard_normal(p[k].shape)).astype(np.float32)
    if "log_threshold" in p:
        p["log_threshold"] = np.log(rng.uniform(0.02, 0.3, p["log_threshold"].shape)
                                    ).astype(np.float32)
    if "threshold" in p:  # batch_topk's deployment gate, which switches latents off
        p["threshold"] = np.full((), 0.05, np.float32)
    return p


def _threshold(values: np.ndarray) -> float:
    """A threshold inside the IE values: the middle of the widest gap between
    neighbours in their middle half, so no value sits at the threshold."""
    v = np.sort(np.abs(values))
    lo, hi = len(v) // 4, 3 * len(v) // 4
    i = lo + int(np.argmax(v[lo + 1:hi + 1] - v[lo:hi]))
    return float((v[i] + v[i + 1]) / 2)


# every variant on the conv net; the 2-D net with the STE functions' variant
CASES = [("conv", v) for v in VARIANTS] + [("dense", "jumprelu_sae")]


@pytest.fixture(scope="module", params=CASES, ids=lambda p: f"{p[0]}-{p[1]}")
def both(request):
    kind, variant = request.param
    make, in_shape, widths = NETS[kind]
    jnet, tnet = make(jl), make(tl)
    jparams, _ = jnet.init(jax.random.key(0), in_shape)
    tparams, _ = convert.backbone_from_jax(jax.device_get(jparams), {})
    saes = {n: _sae(variant, c, seed) for seed, (n, c) in enumerate(widths.items(), 1)}
    jeng = JEngine(jnet, jparams, {n: JFrozen(variant, {k: jnp.asarray(v) for k, v in p.items()},
                                              K) for n, p in saes.items()}, j_ce)
    teng = CircuitEngine(tnet, tparams, {n: FrozenSAE(variant, convert.sae_params_from_jax(p), K)
                                         for n, p in saes.items()}, t_ce)
    rng = np.random.default_rng(7)
    batches = [(rng.standard_normal((B, *in_shape)).astype(np.float32),
                rng.integers(0, 4, B).astype(np.int32)) for _ in range(3)]
    jb = [(jnp.asarray(x), jnp.asarray(y)) for x, y in batches]
    tb = [(torch.from_numpy(x), torch.from_numpy(y)) for x, y in batches]
    layers = list(widths)
    idx = dict(zip(layers, ([0, 3, 7, 9], [1, 4, 6, 8, 10])))

    out = {"layers": layers, "variant": variant}
    out["j_avg"] = jeng.compute_averages(jb)
    out["t_avg"] = teng.compute_averages(tb)
    out["j_node"] = jeng.compute_node_ie(jb, out["j_avg"])
    out["t_node"] = teng.compute_node_ie(tb, out["t_avg"])
    out["j_edges"] = jeng.compute_edge_ie(jb[:2], out["j_avg"], idx)
    out["t_edges"] = teng.compute_edge_ie(tb[:2], out["t_avg"], idx)
    out["t_edges_chunked"] = teng.compute_edge_ie(tb[:2], out["t_avg"], idx, cotangent_chunk=2)
    jn = out["j_node"]
    mid = _threshold(np.concatenate([np.concatenate([np.asarray(jn.features[n]).ravel(),
                                                     np.asarray(jn.error[n]).ravel(),
                                                     np.asarray(jn.model_neurons[n]).ravel()])
                                     for n in layers]))
    faith = {}
    for thr in (-1.0, mid, 1e9):
        for v in ("sae", "model"):
            faith[(thr, v)] = (
                jeng.compute_faithfulness(jb, jn, thr, model_or_sae=v, averages=out["j_avg"]),
                teng.compute_faithfulness(tb, out["t_node"], thr, model_or_sae=v,
                                          averages=out["t_avg"]))
    out["faith"] = faith
    return out


def _close(got, want, rtol, atol, msg=""):
    np.testing.assert_allclose(np.asarray(got), np.asarray(want), rtol=rtol, atol=atol,
                               err_msg=msg)


def test_averages_match_jax(both):
    j, t = both["j_avg"], both["t_avg"]
    for n in both["layers"]:
        for field in ("enc", "err", "out"):
            got, want = getattr(t, field)[n], getattr(j, field)[n]
            assert tuple(got.shape) == tuple(want.shape)
            _close(got, want, 1e-5, 1e-6, f"{field}:{n}")
        np.testing.assert_array_equal(t.dead[n].numpy(), np.asarray(j.dead[n]), err_msg=n)
        _close(t.sparsity[n], j.sparsity[n], 1e-5, 1e-6, n)


def test_node_ie_matches_jax(both):
    j, t = both["j_node"], both["t_node"]
    for n in both["layers"]:
        for field in ("features", "error", "model_neurons"):
            got, want = getattr(t, field)[n], getattr(j, field)[n]
            assert tuple(got.shape) == tuple(want.shape)
            _close(got, want, 1e-4, 1e-7, f"{field}:{n}")
        assert float(t.features[n].abs().max()) > 0


def test_edge_ie_matches_jax_in_one_chunk_and_in_chunks_of_two(both):
    j, t, tc = both["j_edges"], both["t_edges"], both["t_edges_chunked"]
    first, last = both["layers"]
    assert tuple(t[first].shape) == (5, 6)  # [U_sel+1, D_sel+1]
    assert tuple(t[last].shape) == (6, 1)  # the last layer -> the loss node
    for n in both["layers"]:
        _close(t[n], j[n], 1e-4, 1e-8, n)
        _close(tc[n], t[n], 1e-5, 1e-9, f"chunked {n}")
    assert float(t[first].abs().max()) > 0


LOSS_RTOL = 1e-6


def ratio_tol(r: dict, f: float) -> float:
    """LOSS_RTOL of each loss carried through (m_C - m_empty) / (m_M - m_empty)
    whose value is ``f``."""
    denom = abs(r["m_M"] - r["m_empty"])
    m = max(abs(r["m_C"]), abs(r["m_M"]), abs(r["m_empty"]))
    return LOSS_RTOL * m * (2 + 2 * abs(f)) / denom


def test_faithfulness_matches_jax(both):
    for (thr, variant), (j, t) in both["faith"].items():
        assert set(t) == set(j), (thr, variant)
        for k, want in j.items():
            got = t[k]
            if k in ("num_feature_nodes", "num_error_nodes"):
                assert got == want, (thr, variant, k)
            elif k.startswith("faithfulness"):
                _close(got, want, 0, ratio_tol(j, want), f"{thr} {variant} {k}")
            else:
                _close(got, want, LOSS_RTOL, 0, f"{thr} {variant} {k}")
        if thr == -1.0:  # keep every node: the circuit is the model
            assert abs(t["faithfulness"] - 1.0) <= ratio_tol(t, 1.0)
        if thr == 1e9:  # ablate every node
            assert abs(t["faithfulness"]) <= ratio_tol(t, 0.0)


def test_faithfulness_threshold_grid_matches_jax():
    assert FAITHFULNESS_THRESHOLDS == J_THRESHOLDS
