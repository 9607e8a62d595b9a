"""The port's CircuitEngine on the towers' attention-out taps (rank-3 [B, N, D]
activations) against the JAX package's (mirrors tests/test_vit_circuit.py):
vit_test_split and clip_vit_test_split with sae_mlp SAEs at block0_attn and
block1_attn, the JAX weights carried across by convert.py, the same numpy
batches. Dataset averages per token position ([N, C*K], [N, C]), node IE, edge
IE on the pair and to the loss node (one cotangent chunk, and chunks of 2), the
faithfulness anchors (1 keeping every node, 0 ablating every node) and every
faithfulness field. Then compute_ie "1" and "2" through both Pipelines on
vit_test_split, whose circuit is the one layer ``sae_layer`` with the
pipeline's own SAE (interp/ie.py build_engine): the averages.npz and
node_ie.npz the two write.

The SAEs get non-zero biases, so codes and errors are not trivial. Tolerances
(f32, tiny towers, sums in another order), as tests/test_torch_circuit.py:
averages rtol 1e-5 / atol 1e-6; IE values rtol 1e-4 / atol 1e-7; edges of
chunks against one chunk rtol 1e-5 / atol 1e-9; dead masks exactly;
faithfulness losses rtol 1e-6, each ratio within that tolerance carried
through (m_C - m_empty) / (m_M - m_empty).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from sparse_vision_tpu.config import RunConfig as JConfig
from sparse_vision_tpu.data.datasets import make_synthetic as j_synth
from sparse_vision_tpu.interp.circuit import CircuitEngine as JEngine
from sparse_vision_tpu.interp.circuit import FrozenSAE as JFrozen
from sparse_vision_tpu.models import backbone as jbackbone
from sparse_vision_tpu.models.sae import init_sae
from sparse_vision_tpu.ops.losses import cross_entropy as j_ce
from sparse_vision_tpu.train.pipeline import Pipeline as JPipeline
from sparse_vision_tpu_torch import convert
from sparse_vision_tpu_torch.config import RunConfig as TConfig
from sparse_vision_tpu_torch.data.datasets import make_synthetic as t_synth
from sparse_vision_tpu_torch.interp.circuit import CircuitEngine, FrozenSAE
from sparse_vision_tpu_torch.models import backbone as tbackbone
from sparse_vision_tpu_torch.ops.losses import cross_entropy as t_ce
from sparse_vision_tpu_torch.train.pipeline import Pipeline as TPipeline
from test_torch_circuit import _close, ratio_tol
from test_torch_pipeline import quick_jax_pipeline

B, K = 3, 2
LAYERS = ["block0_attn", "block1_attn"]
N_TOK, DIM = 65, 64  # 32 px / patch 4 -> 64 patches + CLS


@pytest.fixture(scope="module", autouse=True)
def one_torch_thread():
    """Small passes: one intra-op thread is as fast alone and much faster when
    the test workers oversubscribe the cores."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _sae(seed: int) -> dict:
    p = {k: np.array(v) for k, v in jax.device_get(
        init_sae("sae_mlp", jax.random.key(seed), DIM, K)).items()}
    rng = np.random.default_rng(seed)
    p["b_enc"] = (0.05 * rng.standard_normal(p["b_enc"].shape)).astype(np.float32)
    p["b_dec"] = (0.05 * rng.standard_normal(p["b_dec"].shape)).astype(np.float32)
    return p


@pytest.fixture(scope="module", params=["vit_test_split", "clip_vit_test_split"])
def both(request):
    jnet = jbackbone.make_backbone(request.param, "cifar_10")
    tnet = tbackbone.make_backbone(request.param, "cifar_10")
    jparams, _ = jax.jit(lambda k: jnet.init(k, (32, 32, 3)))(jax.random.key(0))
    tparams, _ = convert.backbone_from_jax(jax.device_get(jparams), {})
    saes = {n: _sae(i + 1) for i, n in enumerate(LAYERS)}
    jeng = JEngine(jnet, jparams, {n: JFrozen("sae_mlp", {k: jnp.asarray(v) for k, v in p.items()},
                                              K) for n, p in saes.items()}, j_ce)
    teng = CircuitEngine(tnet, tparams, {n: FrozenSAE("sae_mlp", convert.sae_params_from_jax(p),
                                                      K) for n, p in saes.items()}, t_ce)
    rng = np.random.default_rng(7)
    batches = [(rng.standard_normal((B, 32, 32, 3)).astype(np.float32),
                rng.integers(0, 10, B).astype(np.int32)) for _ in range(3)]
    jb = [(jnp.asarray(x), jnp.asarray(y)) for x, y in batches]
    tb = [(torch.from_numpy(x), torch.from_numpy(y)) for x, y in batches]
    idx = {LAYERS[0]: [0, 3, 7], LAYERS[1]: [1, 4]}
    out = {"j_avg": jeng.compute_averages(jb), "t_avg": teng.compute_averages(tb)}
    out["j_node"] = jeng.compute_node_ie(jb, out["j_avg"])
    out["t_node"] = teng.compute_node_ie(tb, out["t_avg"])
    out["j_edges"] = jeng.compute_edge_ie(jb[:1], out["j_avg"], idx)
    out["t_edges"] = teng.compute_edge_ie(tb[:1], out["t_avg"], idx)
    out["t_edges_chunked"] = teng.compute_edge_ie(tb[:1], out["t_avg"], idx, cotangent_chunk=2)
    out["faith"] = {
        (thr, v): (jeng.compute_faithfulness(jb, out["j_node"], thr, model_or_sae=v,
                                             averages=out["j_avg"]),
                   teng.compute_faithfulness(tb, out["t_node"], thr, model_or_sae=v,
                                             averages=out["t_avg"]))
        for thr in (-1.0, 1e9) for v in ("sae", "model")}
    return out


def test_averages_are_per_token_position_and_match_jax(both):
    j, t = both["j_avg"], both["t_avg"]
    assert tuple(t.enc[LAYERS[0]].shape) == (N_TOK, DIM * K)
    assert tuple(t.err[LAYERS[0]].shape) == tuple(t.out[LAYERS[1]].shape) == (N_TOK, DIM)
    assert tuple(t.dead[LAYERS[0]].shape) == (DIM * K,)
    for n in LAYERS:
        for field in ("enc", "err", "out"):
            got, want = getattr(t, field)[n], getattr(j, field)[n]
            assert tuple(got.shape) == tuple(want.shape)
            _close(got, want, 1e-5, 1e-6, f"{field}:{n}")
        np.testing.assert_array_equal(t.dead[n].numpy(), np.asarray(j.dead[n]), err_msg=n)
        _close(t.sparsity[n], j.sparsity[n], 1e-5, 1e-6, n)


def test_node_ie_matches_jax(both):
    j, t = both["j_node"], both["t_node"]
    for n in LAYERS:
        for field in ("features", "error", "model_neurons"):
            got, want = getattr(t, field)[n], getattr(j, field)[n]
            assert tuple(got.shape) == tuple(want.shape)
            _close(got, want, 1e-4, 1e-7, f"{field}:{n}")
        assert tuple(t.features[n].shape) == (DIM * K,)
        assert float(t.features[n].abs().max()) > 0


def test_edge_ie_matches_jax_in_one_chunk_and_in_chunks_of_two(both):
    j, t, tc = both["j_edges"], both["t_edges"], both["t_edges_chunked"]
    assert tuple(t[LAYERS[0]].shape) == (4, 3)  # +1 error node each side
    assert tuple(t[LAYERS[1]].shape) == (3, 1)  # the last layer -> the loss node
    for n in LAYERS:
        _close(t[n], j[n], 1e-4, 1e-8, n)
        _close(tc[n], t[n], 1e-5, 1e-9, f"chunked {n}")
    assert float(t[LAYERS[0]].abs().max()) > 0


def test_faithfulness_anchors_and_fields_match_jax(both):
    for (thr, variant), (j, t) in both["faith"].items():
        assert set(t) == set(j), (thr, variant)
        for k, want in j.items():
            got = t[k]
            if k in ("num_feature_nodes", "num_error_nodes"):
                assert got == want, (thr, variant, k)
            elif k.startswith("faithfulness"):
                _close(got, want, 0, ratio_tol(j, want), f"{thr} {variant} {k}")
            else:
                _close(got, want, 1e-6, 0, f"{thr} {variant} {k}")
        if thr == -1.0:  # keep every node: the circuit is the model
            assert abs(t["faithfulness"] - 1.0) <= ratio_tol(t, 1.0)
        else:  # ablate every node
            assert abs(t["faithfulness"]) <= ratio_tol(t, 0.0)


# ---------------------------------------------------------------------------
# compute_ie "1" and "2" through both Pipelines (build_engine's one-layer branch)
# ---------------------------------------------------------------------------

def _datasets(make):
    tr = make(num_samples=32, img_size=(32, 32, 3), num_classes=10, seed=3)
    return tr, tr, tr.category_names, (32, 32, 3)


def test_compute_ie_modes_1_and_2_through_both_pipelines_match_jax(tmp_path):
    """Mode 1 then mode 2, each a Pipeline.run of its own (training off), on
    the pipeline's own SAE at block0_attn; the port takes the JAX pipeline's
    backbone and SAE weights. Both write averages.npz and node_ie.npz under the
    same keys; the port's equal the JAX package's."""
    base = dict(model_name="vit_test_split", dataset_name="cifar_10", sae_layer="block0_attn",
                sae_model_name="sae_mlp", sae_expansion_factor=K, sae_batch_size=8,
                training=False, seed=3)
    written = {}
    for flag in ("1", "2"):
        with quick_jax_pipeline():
            jpipe = JPipeline(JConfig(**base, compute_ie=flag,
                                      directory_path=str(tmp_path / "jax")),
                              datasets=_datasets(j_synth))
            jpipe.run()
            backbone = convert.backbone_from_jax(jax.device_get(jpipe.frozen_params),
                                                 jax.device_get(jpipe.net_state))
            sae = convert.sae_params_from_jax(jax.device_get(jpipe.ts.params))
        tpipe = TPipeline(TConfig(**base, compute_ie=flag, directory_path=str(tmp_path / "t")),
                          device="cpu", datasets=_datasets(t_synth), backbone=backbone,
                          sae_params=sae)
        tpipe.run()
        written[flag] = (jpipe.paths["ie_related_quantities"],
                         tpipe.paths["ie_related_quantities"])
    for flag, name, rtol, atol in (("1", "averages.npz", 1e-5, 1e-6),
                                   ("2", "node_ie.npz", 1e-4, 1e-7)):
        jdir, tdir = written[flag]
        with np.load(f"{jdir}/{name}") as jz, np.load(f"{tdir}/{name}") as tz:
            assert sorted(tz.files) == sorted(jz.files)
            assert all(k.endswith(":block0_attn") for k in tz.files)
            for k in jz.files:
                assert tz[k].shape == jz[k].shape, k
                if k.startswith("dead:"):
                    np.testing.assert_array_equal(tz[k], jz[k], err_msg=k)
                else:
                    _close(tz[k], jz[k], rtol, atol, k)
            if flag == "1":
                assert tz["enc:block0_attn"].shape == (N_TOK, DIM * K)
            else:
                assert np.abs(tz["features:block0_attn"]).max() > 0
