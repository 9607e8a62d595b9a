"""The port's mesh (parallel/mesh.py) and process model (parallel/distributed.py)
on gloo ranks on the CPU, held to the JAX package's mesh on four of the eight
CPU devices (tests/conftest.py).

One (2, 2) world (tests/torch_mesh_workers.mesh_worker) gives every rank's
coordinates, parameter shards, gathered parameters and collectives: rank r
sits where JAX's make_mesh((2, 2)) puts device r, each rank's shards equal
the addressable shards of JAX's sae_param_sharding on that device, and the
psum / pmin of each axis are the numpy sums and minima over the ranks that
share the other index. Two more worlds show that spawn fails, instead of
hanging, when a rank raises or a rank never reaches a collective.
"""

import time

import jax
import numpy as np
import pytest
import torch

import torch_mesh_workers as workers
from sparse_vision_tpu.models.sae import init_sae
from sparse_vision_tpu.parallel.mesh import make_mesh as j_make_mesh
from sparse_vision_tpu.parallel.mesh import sae_param_sharding
from sparse_vision_tpu_torch.parallel import distributed
from sparse_vision_tpu_torch.parallel.distributed import RankError, spawn
from sparse_vision_tpu_torch.parallel.mesh import make_mesh, param_axes

MESH = (2, 2)
NAMES = ("sae_mlp", "gated_sae", "jumprelu_sae")
# every parameter name of those variants
KEYS = ("W_enc", "b_enc", "W_dec", "b_dec", "W_gate", "b_gate", "b_mag", "r_mag",
        "log_threshold")


def _params() -> dict:
    """Every parameter name of the SAE variants the table covers, one dict."""
    out = {}
    for name in NAMES:
        p = jax.device_get(init_sae(name, jax.random.key(0), 16, 8))
        out.update({k: np.array(v) for k, v in p.items()})
    return out


@pytest.fixture(scope="module")
def ranks():
    return spawn(workers.mesh_worker, MESH, _params(), device="cpu", backend="gloo",
                 timeout_s=300)


def _x(rank: int) -> np.ndarray:
    return np.arange(6, dtype=np.float32) + 10.0 * rank


def test_rank_coordinates_follow_jax_device_order(ranks):
    devices = j_make_mesh(MESH).devices  # [[0, 1], [2, 3]]: rank = d·m + k
    for res in ranks:
        assert devices[res["coords"]].id == res["rank"]


@pytest.mark.parametrize("name", KEYS)
def test_shards_equal_jax_addressable_shards(ranks, name):
    params = _params()
    mesh = j_make_mesh(MESH)
    placed = jax.device_put(params[name], sae_param_sharding(mesh, params)[name])
    by_device = {s.device.id: np.asarray(s.data) for s in placed.addressable_shards}
    for res in ranks:
        np.testing.assert_array_equal(res["shards"][name].numpy(), by_device[res["rank"]])


def test_gather_round_trip(ranks):
    params = _params()
    for res in ranks:
        for k, v in params.items():
            assert torch.equal(res["gathered"][k], torch.from_numpy(v)), k


def test_param_axes_table():
    axes = param_axes(_params())
    assert set(axes) == set(KEYS)
    assert {k for k, a in axes.items() if a == 1} == {"W_enc", "W_gate"}
    assert {k for k, a in axes.items() if a is None} == {"b_dec"}


@pytest.mark.parametrize("axis", ["data", "model", "both"])
def test_psum_and_pmin_over_each_axis(ranks, axis):
    m = MESH[1]
    for res in ranks:
        d, k = res["coords"]
        group = {"data": [i * m + k for i in range(MESH[0])],
                 "model": [d * m + j for j in range(m)],
                 "both": list(range(MESH[0] * m))}[axis]
        xs = np.stack([_x(r) for r in group])
        np.testing.assert_array_equal(res["psum"][axis].numpy(), xs.sum(0))
        np.testing.assert_array_equal(res["pmin"][axis].numpy(), xs.min(0))


def test_gather_over_data_and_of_a_bool_mask(ranks):
    m = MESH[1]
    for res in ranks:
        d, k = res["coords"]
        want = np.concatenate([_x(i * m + k)[:2] for i in range(MESH[0])])
        np.testing.assert_array_equal(res["gather_data"].numpy(), want)
        # the 'model' gather of [rank even, True] over the ranks d·m + j
        mask = np.concatenate([[(d * m + j) % 2 == 0, True] for j in range(m)])
        np.testing.assert_array_equal(res["dead_gather"].numpy(), mask)


def test_a_rank_that_raises_fails_the_world():
    t0 = time.monotonic()
    with pytest.raises(RankError, match="rank 3 fails on purpose"):
        spawn(workers.raise_on_rank_3, MESH, device="cpu", backend="gloo", timeout_s=120)
    assert time.monotonic() - t0 < 120  # the waiting ranks were killed, not waited for


def test_a_hung_world_fails_at_its_timeout():
    t0 = time.monotonic()
    with pytest.raises(TimeoutError, match="still running"):
        spawn(workers.sleep_forever, (2,), device="cpu", backend="gloo", timeout_s=8)
    assert time.monotonic() - t0 < 40


def test_one_rank_mesh_without_a_world():
    mesh = make_mesh(())
    assert mesh.shape == (1,) and mesh.world == 1 and mesh.coords == (0, 0)
    x = torch.arange(3.0)
    assert torch.equal(mesh.psum(x, "data"), x) and torch.equal(mesh.gather(x, 0), x)
    with pytest.raises(ValueError, match="spawn"):
        make_mesh(MESH)


def test_backend_rules(monkeypatch):
    """gloo takes any number of ranks; NCCL needs CUDA and a card per rank, and
    its refusal names gloo."""
    distributed.check_backend("gloo", 4, "cpu")
    with pytest.raises(ValueError, match="gloo"):
        distributed.check_backend("nccl", 4, "cpu")
    monkeypatch.setattr(torch.cuda, "device_count", lambda: 1)
    with pytest.raises(ValueError, match='backend="gloo"'):
        distributed.check_backend("nccl", 4, "cuda")
    distributed.check_backend("nccl", 1, "cuda")
    with pytest.raises(ValueError, match="backend must be"):
        distributed.check_backend("mpi", 1, "cpu")


def test_process_local_batch_slice():
    assert distributed.process_local_batch_slice(256, ranks=4) == 64
    with pytest.raises(ValueError, match="not divisible"):
        distributed.process_local_batch_slice(100, ranks=3)
