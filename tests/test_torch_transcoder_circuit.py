"""The port's interp/transcoder_circuit.py against the JAX package's, function
by function, on the same weights (convert.py) and the same numpy batches:

- on the tiny MLP of tests/test_transcoder_circuit.py: the connection matrix
  and its refusal, the chain grouping, the chain edges for both gates, the
  planted connection, the loss-node edges, the faithfulness anchors of
  hand-built exact transcoders, the splice losses and the edge pass's
  argument checks;
- on GoogLeNet at 32 px: the chain mixed4b -> 4c -> 4d -> 4e of
  registry-width random transcoders (mixed4d -> 4e at 2,112 latents) for
  both gates, with the downstream gates that flip between the frameworks
  counted; the loss-node edges of mixed4d -> 4e; the splice losses with a
  random mask; load_pair_params from each package's checkpoints;
- top_edges on the same matrix.

Tolerances (f32): the connection matrix rtol 1e-6; the MLP's edges rtol 1e-5 /
atol 1e-7 (tests/test_transcoder_circuit.py's loop bound); GoogLeNet's edges
rtol 1e-4 / atol 1e-6 of each matrix's largest entry (the frameworks' f32
convolutions differ by ~1e-6 relative, and the products sum 32 images'
tokens); the "active" gate is a 0/1 decision on a pre-activation, so where the
frameworks' pre-activations straddle 0 a gate flips: the flips are counted
(at most MAX_FLIPS; measured 0) and the edge columns they touch are left out
of the comparison; loss-node edges rtol 1e-4 / atol 1e-6 of the largest
(a backward through the backbone); splice losses rtol 1e-5; faithfulness
anchors as tests/test_transcoder_circuit.py (1 within 1e-5, 0 within 1e-7).
"""

import dataclasses
import math
from types import SimpleNamespace

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from sparse_vision_tpu.config import RunConfig as JConfig
from sparse_vision_tpu.data.datasets import make_synthetic as j_synth
from sparse_vision_tpu.interp import transcoder_circuit as jtc
from sparse_vision_tpu.models import layers as jl
from sparse_vision_tpu.models.backbone import init_backbone as j_init_backbone
from sparse_vision_tpu.models.backbone import make_backbone as j_make_backbone
from sparse_vision_tpu.models.sae import init_transcoder as j_init_transcoder
from sparse_vision_tpu.ops.losses import cross_entropy as j_ce
from sparse_vision_tpu.train import checkpoint as j_ckpt
from sparse_vision_tpu.train import multilayer as j_ml
from sparse_vision_tpu.train import pipeline as j_pipeline
from sparse_vision_tpu_torch import convert
from sparse_vision_tpu_torch.config import RunConfig as TConfig
from sparse_vision_tpu_torch.data.datasets import make_synthetic as t_synth
from sparse_vision_tpu_torch.interp import transcoder_circuit as ttc
from sparse_vision_tpu_torch.models import layers as tl
from sparse_vision_tpu_torch.models.backbone import make_backbone as t_make_backbone
from sparse_vision_tpu_torch.ops.losses import cross_entropy as t_ce
from sparse_vision_tpu_torch.train import checkpoint as t_ckpt
from sparse_vision_tpu_torch.train import multilayer as t_ml
from sparse_vision_tpu_torch.train.pipeline import Pipeline as TPipeline

SIZE = (32, 32, 3)
CHAIN = [("mixed4b", "mixed4c"), ("mixed4c", "mixed4d"), ("mixed4d", "mixed4e")]
GAIN = math.sqrt(6.0)  # as tests/test_torch_ie.py: images get image-dependent logits
EDGE_TOL = (1e-4, 1e-6)  # rtol, atol as a fraction of the matrix's largest entry
MAX_FLIPS = 4  # downstream "active" gates that may differ between the frameworks


@pytest.fixture(scope="module", autouse=True)
def one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _t(p: dict) -> dict:
    return convert.sae_params_from_jax(jax.device_get(p))


# ---------------------------------------------------------------------------
# the tiny MLP of tests/test_transcoder_circuit.py
# ---------------------------------------------------------------------------

def _mlp(m, dims=(10, 8, 6, 4)):
    return m.SeqNet([m.linear("fc1", dims[0]), m.relu("relu1"), m.linear("fc2", dims[1]),
                     m.relu("relu2"), m.linear("fc3", dims[2]), m.relu("relu3"),
                     m.linear("fc4", dims[3])])


def _nets(seed):
    jnet, tnet = _mlp(jl), _mlp(tl)
    jp, js = jnet.init(jax.random.key(seed), (12,))
    tp, ts = convert.backbone_from_jax(jax.device_get(jp), jax.device_get(js))
    return jnet, jp, js, tnet, tp, ts


def test_connection_matrix_and_chains_match_jax():
    p_up = j_init_transcoder(jax.random.key(0), 10, 2, 8)
    p_dn = j_init_transcoder(jax.random.key(1), 8, 3, 6)
    got = ttc.transcoder_connection_matrix(_t(p_up), _t(p_dn))
    assert got.shape == (20, 24)
    np.testing.assert_allclose(got.numpy(), np.asarray(jtc.transcoder_connection_matrix(p_up, p_dn)),
                               rtol=1e-6, atol=1e-7)
    bad = _t(j_init_transcoder(jax.random.key(1), 7, 2, 6))
    with pytest.raises(ValueError, match="middle layer"):
        ttc.transcoder_connection_matrix(_t(p_up), bad)
    pairs = [("a", "b"), ("b", "c"), ("d", "e"), ("e", "f"), ("g", "h")]
    assert ttc.transcoder_chains(pairs) == jtc.transcoder_chains(pairs)
    assert ttc.transcoder_chains(CHAIN) == [CHAIN]


@pytest.mark.parametrize("gate", ["active", "value"])
def test_mlp_chain_edges_match_jax(gate):
    jnet, jp, js, tnet, tp, ts = _nets(0)
    chain = [("fc1", "fc2"), ("fc2", "fc3")]
    tcs = [j_init_transcoder(jax.random.key(10), 10, 2, 8),
           j_init_transcoder(jax.random.key(11), 8, 2, 6)]
    images = np.array(jax.random.normal(jax.random.key(12), (16, 12), jnp.float32))
    want = jtc.compute_transcoder_edges(jnet, jp, js, chain, tcs,
                                        [jnp.asarray(images[:8]), jnp.asarray(images[8:])],
                                        gate=gate)
    got = ttc.compute_transcoder_edges(tnet, tp, ts, chain, [_t(p) for p in tcs],
                                       [images[:8], torch.from_numpy(images[8:])], gate=gate)
    assert len(got) == 1 and got[0].shape == (20, 16) and got[0].dtype == np.float32
    np.testing.assert_allclose(got[0], want[0], rtol=1e-5, atol=1e-7)
    assert np.abs(want[0]).max() > 0


def test_planted_connection_is_the_top_edge():
    """Upstream latent 2 writes e_0 alone, downstream latent 5 reads it alone:
    edge (2, 5) is the top edge and every other edge is exactly 0."""
    _, _, _, tnet, tp, ts = _nets(3)
    tc1 = _t(j_init_transcoder(jax.random.key(20), 10, 2, 8))
    tc2 = _t(j_init_transcoder(jax.random.key(21), 8, 2, 6))
    tc1["W_dec"] = torch.zeros(20, 8)
    tc1["W_dec"][2, 0] = 1.0
    tc2["W_enc"] = torch.zeros(8, 16)
    tc2["W_enc"][0, 5] = 1.0
    tc2["b_enc"] = torch.ones(16)
    images = np.random.default_rng(22).normal(size=(32, 12)).astype(np.float32)
    edges = ttc.compute_transcoder_edges(tnet, tp, ts, [("fc1", "fc2"), ("fc2", "fc3")],
                                         [tc1, tc2], [images])
    assert ttc.top_edges(edges[0], k=1)[0][:2] == (2, 5)
    mask = np.ones_like(edges[0], bool)
    mask[2, 5] = False
    np.testing.assert_array_equal(edges[0][mask], 0.0)


def test_mlp_loss_node_edges_match_jax():
    jnet, jp, js, tnet, tp, ts = _nets(5)
    tc = j_init_transcoder(jax.random.key(30), 8, 2, 6)
    rng = np.random.default_rng(31)
    batches = [SimpleNamespace(images=rng.normal(size=(16, 12)).astype(np.float32),
                               labels=rng.integers(0, 4, 16).astype(np.int32)) for _ in range(2)]
    want = jtc.loss_node_edges(jnet, jp, js, ("fc2", "fc3"), tc,
                               [SimpleNamespace(images=jnp.asarray(b.images),
                                                labels=jnp.asarray(b.labels)) for b in batches],
                               j_ce)
    got = ttc.loss_node_edges(tnet, tp, ts, ("fc2", "fc3"), _t(tc), batches, t_ce)
    assert got.shape == (16,)
    np.testing.assert_allclose(got, want, rtol=1e-4, atol=1e-7)


def test_mlp_faithfulness_anchors_match_jax():
    """Exact transcoders (W_enc = I keeps the ReLU, W_dec = the next linear
    layer) give faithfulness 1 with full masks and exactly 0 with empty ones,
    in both packages, with the same losses."""
    jnet, jp, js, tnet, tp, ts = _nets(7)
    jtcs = [{"W_enc": jnp.eye(10), "b_enc": jnp.zeros((10,)), "W_dec": jp["fc2"]["w"],
             "b_dec": jp["fc2"]["b"]},
            {"W_enc": jnp.eye(8), "b_enc": jnp.zeros((8,)), "W_dec": jp["fc3"]["w"],
             "b_dec": jp["fc3"]["b"]}]
    chain = [("fc1", "fc2"), ("fc2", "fc3")]
    rng = np.random.default_rng(40)
    batches = [SimpleNamespace(images=rng.normal(size=(8, 12)).astype(np.float32),
                               labels=rng.integers(0, 4, 8).astype(np.int32)) for _ in range(2)]
    jb = [SimpleNamespace(images=jnp.asarray(b.images), labels=jnp.asarray(b.labels))
          for b in batches]
    for masks, anchor, tol in (([np.ones(10), np.ones(8)], 1.0, 1e-5),
                               ([np.zeros(10), np.zeros(8)], 0.0, 1e-7)):
        want = jtc.chain_faithfulness(jnet, jp, js, chain, jtcs, masks, jb, j_ce)
        got = ttc.chain_faithfulness(tnet, tp, ts, chain, [_t(p) for p in jtcs], masks,
                                     batches, t_ce)
        np.testing.assert_allclose(got["faithfulness"], anchor, atol=tol)
        assert got["kept_latents"] == want["kept_latents"] == [int(m.sum()) for m in masks]
        for k in ("m_M", "m_C", "m_empty"):
            np.testing.assert_allclose(got[k], want[k], rtol=1e-5, err_msg=k)
    np.testing.assert_allclose(got["m_C"], got["m_empty"], rtol=0, atol=0)


def test_chain_edge_fn_refuses_what_jax_refuses():
    _, _, _, tnet, _, _ = _nets(0)
    tc1 = _t(j_init_transcoder(jax.random.key(0), 10, 2, 8))
    with pytest.raises(ValueError, match="at least 2"):
        ttc.make_chain_edge_fn(tnet, [("fc1", "fc2")], [tc1])
    tc2 = _t(j_init_transcoder(jax.random.key(1), 8, 2, 6))
    with pytest.raises(ValueError, match="gate"):
        ttc.make_chain_edge_fn(tnet, [("fc1", "fc2"), ("fc2", "fc3")], [tc1, tc2],
                               gate="softmax")
    with pytest.raises(ValueError, match="empty"):
        ttc.compute_transcoder_edges(tnet, {}, {}, [("fc1", "fc2"), ("fc2", "fc3")],
                                     [tc1, tc2], [])


def test_top_edges_match_jax():
    edge = np.random.default_rng(5).normal(size=(40, 30)).astype(np.float32)
    for k, thr in ((1, 0.0), (20, 0.0), (20, 2.0), (5000, 0.0)):
        assert ttc.top_edges(edge, k, thr) == jtc.top_edges(edge, k, thr)


# ---------------------------------------------------------------------------
# GoogLeNet at 32 px: the longest chain at the registry widths
# ---------------------------------------------------------------------------

def _scaled(tree):
    return {k: _scaled(v) if isinstance(v, dict) else (v * GAIN if k == "w" and v.ndim == 4 else v)
            for k, v in tree.items()}


@pytest.fixture(scope="module")
def googlenet():
    jnet = j_make_backbone("inceptionv1", "imagenet")
    jp, js = j_init_backbone(jnet, jax.random.key(3), "imagenet")
    jp = _scaled(jp)
    tp, ts = convert.backbone_from_jax(jax.device_get(jp), jax.device_get(js))
    widths = {"mixed4b": 512, "mixed4c": 512, "mixed4d": 528, "mixed4e": 832}
    tcs = []
    for i, (a, b) in enumerate(CHAIN):
        p = jax.device_get(j_init_transcoder(jax.random.key(50 + i), widths[a], 4, widths[b]))
        rng = np.random.default_rng(60 + i)
        p = {k: np.array(v) for k, v in p.items()}
        p["b_enc"] = (0.1 * rng.standard_normal(p["b_enc"].shape)).astype(np.float32)
        p["b_dec"] = (0.1 * rng.standard_normal(p["b_dec"].shape)).astype(np.float32)
        tcs.append(p)
    ds = t_synth(num_samples=32, img_size=SIZE, num_classes=1000, seed=3)
    rng = np.random.default_rng(4)
    batches = [SimpleNamespace(images=ds.images[i:i + 16],
                               labels=rng.integers(0, 1000, 16).astype(np.int32))
               for i in (0, 16)]
    return dict(jnet=jnet, jp=jp, js=js, tnet=t_make_backbone("inceptionv1", "imagenet"),
                tp=tp, ts=ts, tcs=tcs, batches=batches)


def _jb(batches):
    return [SimpleNamespace(images=jnp.asarray(b.images), labels=jnp.asarray(b.labels))
            for b in batches]


def _gates(net, params, state, tcs, images, apply, to_np):
    """The downstream latents' 0/1 gates of every pair but the first."""
    _, taps, _ = apply(net, params, images, state)
    out = []
    for (a, _), p in list(zip(CHAIN, tcs))[1:]:
        tok = to_np(taps[a]).reshape(-1, p["W_enc"].shape[0])
        out.append(tok @ to_np(p["W_enc"]) + to_np(p["b_enc"]) > 0)
    return out


@pytest.mark.parametrize("gate", ["active", "value"])
def test_googlenet_chain_edges_match_jax(googlenet, gate):
    """The chain 4b -> 4c -> 4d -> 4e at the registry widths (the last pair at
    2,112 latents): two [h_k, h_{k+1}] matrices within EDGE_TOL, but for the
    columns of a downstream gate that flips between the frameworks (counted,
    at most MAX_FLIPS)."""
    g = googlenet
    ttcs = [convert.sae_params_from_jax(p) for p in g["tcs"]]
    jtcs = [{k: jnp.asarray(v) for k, v in p.items()} for p in g["tcs"]]
    want = jtc.compute_transcoder_edges(g["jnet"], g["jp"], g["js"], CHAIN, jtcs,
                                        _jb(g["batches"]), gate=gate)
    got = ttc.compute_transcoder_edges(g["tnet"], g["tp"], g["ts"], CHAIN, ttcs, g["batches"],
                                       gate=gate)
    flipped = [np.zeros(p["W_enc"].shape[1], bool) for p in g["tcs"][1:]]
    for b in g["batches"]:
        jg = _gates(g["jnet"], g["jp"], g["js"], g["tcs"], jnp.asarray(b.images),
                    lambda n, p, x, s: n.apply(p, x, state=s), np.asarray)
        with torch.no_grad():
            tg = _gates(g["tnet"], g["tp"], g["ts"], ttcs, torch.from_numpy(b.images),
                        lambda n, p, x, s: n.apply(p, x, state=s), lambda t: t.numpy())
        for f, a, c in zip(flipped, jg, tg):
            f |= (a != c).any(0)
    assert sum(int(f.sum()) for f in flipped) <= MAX_FLIPS
    assert [e.shape for e in got] == [(2048, 2048), (2048, 2112)]
    for k, (a, b) in enumerate(zip(got, want)):
        keep = ~flipped[k]
        scale = float(np.abs(b).max())
        assert scale > 0
        np.testing.assert_allclose(a[:, keep], b[:, keep], rtol=EDGE_TOL[0],
                                   atol=EDGE_TOL[1] * scale, err_msg=f"pair {k}")


def test_googlenet_loss_node_edges_and_splice_match_jax(googlenet):
    """mixed4d -> 4e's loss-node edges [2,112], and the chain splice's three
    losses with a random half of each transcoder's latents kept."""
    g = googlenet
    ttcs = [convert.sae_params_from_jax(p) for p in g["tcs"]]
    jtcs = [{k: jnp.asarray(v) for k, v in p.items()} for p in g["tcs"]]
    want = jtc.loss_node_edges(g["jnet"], g["jp"], g["js"], CHAIN[-1], jtcs[-1],
                               _jb(g["batches"]), j_ce)
    got = ttc.loss_node_edges(g["tnet"], g["tp"], g["ts"], CHAIN[-1], ttcs[-1], g["batches"],
                              t_ce)
    assert got.shape == (2112,) and np.isfinite(got).all()
    np.testing.assert_allclose(got, want, rtol=EDGE_TOL[0],
                               atol=EDGE_TOL[1] * float(np.abs(want).max()))
    rng = np.random.default_rng(9)
    masks = [(rng.random(p["W_enc"].shape[1]) < 0.5).astype(np.float32) for p in g["tcs"]]
    jm = jtc.chain_faithfulness(g["jnet"], g["jp"], g["js"], CHAIN, jtcs, masks,
                                _jb(g["batches"]), j_ce)
    tm = ttc.chain_faithfulness(g["tnet"], g["tp"], g["ts"], CHAIN, ttcs, masks, g["batches"],
                                t_ce)
    assert tm["kept_latents"] == jm["kept_latents"]
    for k in ("m_M", "m_C", "m_empty"):
        np.testing.assert_allclose(tm[k], jm[k], rtol=1e-5, err_msg=k)
    assert len({tm["m_M"], tm["m_C"], tm["m_empty"]}) == 3


def test_load_pair_params_restores_each_pairs_final_checkpoint(googlenet, tmp_path, monkeypatch):
    """Each package's load_pair_params reads back the pair's epoch-sae_epochs
    checkpoint that its Pipeline writes under the pair's run name (the input
    layer's registry config with transcoder_target_layer): the same arrays."""
    g = googlenet
    pairs = CHAIN[1:]
    ds = t_synth(num_samples=16, img_size=SIZE, num_classes=1000, seed=3)
    datasets = (ds, ds, ds.category_names, SIZE)
    jds = j_synth(num_samples=16, img_size=SIZE, num_classes=1000, seed=3)
    monkeypatch.setattr(j_pipeline, "load_data",
                        lambda cfg, class_filter=None: (jds, jds, jds.category_names, SIZE))
    base = dict(model_name="inceptionv1", dataset_name="imagenet", sae_layer="mixed4c",
                sae_epochs=2, use_activation_cache=True, seed=3)
    jbase = JConfig(**base, directory_path=str(tmp_path / "jax"))
    tbase = TConfig(**base, directory_path=str(tmp_path / "torch"))
    kwargs = {"device": "cpu", "datasets": datasets, "backbone": (g["tp"], g["ts"])}
    for (a, b), p in zip(pairs, g["tcs"][1:]):
        jpipe = j_pipeline.Pipeline(dataclasses.replace(j_ml.layer_config(jbase, a),
                                                        sae_model_name="transcoder",
                                                        transcoder_target_layer=b))
        jparams = {k: jnp.asarray(v) for k, v in p.items()}
        j_ckpt.save_checkpoint(jpipe._sae_ckpt_dir(), 2,
                               {"params": jparams, "opt_state": jpipe.ts.opt_state,
                                "step": jpipe.ts.step, "dead_acc": jpipe.ts.dead_acc})
        tpipe = TPipeline(t_ml.pair_config(tbase, a, b), **kwargs)
        tpipe.ts = tpipe.ts._replace(params=convert.sae_params_from_jax(p))
        t_ckpt.save_checkpoint(tpipe._sae_ckpt_dir(), 2, tpipe._ckpt_tree())
    j_ckpt.wait_for_saves() if hasattr(j_ckpt, "wait_for_saves") else None
    t_ckpt.wait_for_saves()
    jgot = jtc.load_pair_params(jbase, pairs)
    tgot = ttc.load_pair_params(tbase, pairs, **kwargs)
    for jp, tp, p in zip(jgot, tgot, g["tcs"][1:]):
        for k, v in p.items():
            np.testing.assert_array_equal(tp[k].numpy(), v, err_msg=k)
            np.testing.assert_array_equal(np.asarray(jp[k]), v, err_msg=k)
