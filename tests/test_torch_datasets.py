"""The port's dataset loaders (data/datasets.py) against the JAX package's, on
files the tests write: MNIST idx files (plain and .gz), CIFAR-10 pickles, the
Tiny-ImageNet layout, ImageNet class folders (with the class filter) and tar
shards, the per-model decodes (InceptionV1's 229 px, the ViT and CLIP
processors' 224 px, ROADMAP C7), the thread-pool decode against the
synchronous one, fetch_images_batches, cfg.data_workers at every dataset read
of a Pipeline, and ROADMAP C5 through a tar shard. Every comparison of decoded
values is bitwise: both packages run the same numpy and PIL operations.
"""

import gzip
import io
import os
import pickle
import struct
import sys
import threading
from types import SimpleNamespace

import numpy as np
import pytest
import torch
from PIL import Image

from sparse_vision_tpu.config import RunConfig as JConfig
from sparse_vision_tpu.data import datasets as J
from sparse_vision_tpu_torch.config import RunConfig as TConfig
from sparse_vision_tpu_torch.data import datasets as T
from sparse_vision_tpu_torch.data.datasets import ArrayDataset


@pytest.fixture(scope="module", autouse=True)
def one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _same_batches(a, b) -> int:
    a, b = list(a), list(b)
    assert len(a) == len(b)
    for x, y in zip(a, b):
        np.testing.assert_array_equal(x.images, y.images)
        assert x.images.dtype == y.images.dtype == np.float32
        np.testing.assert_array_equal(x.labels, y.labels)
        np.testing.assert_array_equal(x.indices, y.indices)
    return len(a)


def _same_dataset(t, j, batch: int = 4) -> None:
    assert len(t) == len(j) and list(t.category_names) == list(j.category_names)
    np.testing.assert_array_equal(t.labels, j.labels)
    if hasattr(j, "images"):
        np.testing.assert_array_equal(t.images, j.images)
    assert _same_batches(t.batches(batch, shuffle=True, seed=3),
                         j.batches(batch, shuffle=True, seed=3)) == len(j) // batch


# ---------------------------------------------------------------------------
# MNIST and CIFAR-10
# ---------------------------------------------------------------------------

def _idx(path, arr, magic):
    with open(path, "wb") as f:
        f.write(struct.pack(">I", magic))
        f.write(struct.pack(f">{arr.ndim}I", *arr.shape))
        f.write(arr.astype(np.uint8).tobytes())


@pytest.fixture(scope="module")
def mnist_dir(tmp_path_factory):
    """train as plain idx files, t10k gzipped."""
    root = tmp_path_factory.mktemp("data")
    base = root / "mnist"
    base.mkdir()
    rng = np.random.default_rng(0)
    for prefix, n in (("train", 12), ("t10k", 8)):
        imgs = rng.integers(0, 256, (n, 28, 28)).astype(np.uint8)
        labels = rng.integers(0, 10, n).astype(np.uint8)
        _idx(base / f"{prefix}-images-idx3-ubyte", imgs, 0x803)
        _idx(base / f"{prefix}-labels-idx1-ubyte", labels, 0x801)
    for name in ("t10k-images-idx3-ubyte", "t10k-labels-idx1-ubyte"):
        with open(base / name, "rb") as f, gzip.open(str(base / name) + ".gz", "wb") as g:
            g.write(f.read())
        os.remove(base / name)
    return root


def test_mnist_idx_plain_and_gz_match_jax(mnist_dir):
    for split in ("train", "val"):
        t, j = T.load_mnist(str(mnist_dir), split), J.load_mnist(str(mnist_dir), split)
        _same_dataset(t, j)
    raw = T._read_idx(str(mnist_dir / "mnist" / "train-images-idx3-ubyte"))
    want = (raw.astype(np.float32)[..., None] / 255.0 - 0.1307) / 0.3081
    np.testing.assert_array_equal(T.load_mnist(str(mnist_dir), "train").images, want)
    assert T.load_mnist(str(mnist_dir), "val").images.shape == (8, 28, 28, 1)


def test_pipeline_reads_data_dir_as_jax_does(mnist_dir, tmp_path):
    """A port Pipeline with data_dir loads what the JAX package's load_data
    loads (mnist at 28 px), and data_dir passes validate_slice."""
    from sparse_vision_tpu_torch.train.pipeline import Pipeline

    fields = dict(model_name="custom_mlp_9", dataset_name="mnist", data_dir=str(mnist_dir),
                  sae_model_name="None", original_model=True)
    pipe = Pipeline(TConfig(**fields, directory_path=str(tmp_path)), device="cpu")
    jtrain, jval, names, size = J.load_data(JConfig(**fields))
    assert tuple(pipe.img_size) == tuple(size) == (28, 28, 1)
    _same_dataset(pipe.train_ds, jtrain)
    _same_dataset(pipe.val_ds, jval)


def test_cifar10_pickles_match_jax(tmp_path):
    base = tmp_path / "cifar-10" / "cifar-10-batches-py"
    base.mkdir(parents=True)
    rng = np.random.default_rng(1)
    for name in [f"data_batch_{i}" for i in range(1, 6)] + ["test_batch"]:
        with open(base / name, "wb") as f:
            pickle.dump({b"data": rng.integers(0, 256, (4, 3072)).astype(np.uint8),
                         b"labels": rng.integers(0, 10, 4).tolist()}, f)
    for split in ("train", "val"):
        _same_dataset(T.load_cifar10(str(tmp_path), split), J.load_cifar10(str(tmp_path), split))
    t = T.load_cifar10(str(tmp_path), "train")
    assert t.images.shape == (20, 32, 32, 3)
    with open(base / "data_batch_1", "rb") as f:
        first = pickle.load(f, encoding="bytes")[b"data"][0]
    want = (first.reshape(3, 32, 32).transpose(1, 2, 0).astype(np.float32) / 255.0 - 0.1307) \
        / 0.3081  # the MNIST constants on every channel, the reference's quirk
    np.testing.assert_array_equal(t.images[0], want)


# ---------------------------------------------------------------------------
# image files: Tiny-ImageNet, ImageNet folders, the per-model decodes
# ---------------------------------------------------------------------------

def _img(path, size, seed, fmt=None):
    arr = np.random.default_rng(seed).integers(0, 256, (size[1], size[0], 3), dtype=np.uint8)
    Image.fromarray(arr).save(path, format=fmt)


def test_tiny_imagenet_layout_matches_jax(tmp_path):
    root = tmp_path / "tiny-imagenet-200"
    wnids = ["n01443537", "n01629819"]
    (root / "val" / "images").mkdir(parents=True)
    (root / "wnids.txt").write_text("\n".join(wnids) + "\n")
    for k, w in enumerate(wnids):
        d = root / "train" / w / "images"
        d.mkdir(parents=True)
        for i in range(3):
            _img(d / f"{w}_{i}.JPEG", (64, 64), 10 * k + i, "PNG")
    with open(root / "val" / "val_annotations.txt", "w") as f:
        for i, w in enumerate(wnids * 2):
            _img(root / "val" / "images" / f"val_{i}.JPEG", (64, 64), 100 + i, "PNG")
            f.write(f"val_{i}.JPEG\t{w}\t0\t0\t10\t10\n")
    for split in ("train", "val"):
        t = T.load_tiny_imagenet(str(tmp_path), split)
        j = J.load_tiny_imagenet(str(tmp_path), split)
        assert t.paths == j.paths
        _same_dataset(t, j, batch=2)
    b = next(T.load_tiny_imagenet(str(tmp_path), "train").batches(4, shuffle=False))
    assert b.images.shape == (4, 64, 64, 3) and b.images.max() > 1.5  # raw [0, 255]


@pytest.fixture(scope="module")
def imagenet_dir(tmp_path_factory):
    """Two classes of three images in train (sizes that make the resizes
    crop both ways), one class in val."""
    root = tmp_path_factory.mktemp("data")
    for split, wnids in (("train", ("n01440764", "n01443537")), ("val", ("n01440764",))):
        for k, w in enumerate(wnids):
            d = root / "imagenet" / split / w
            d.mkdir(parents=True)
            for i, size in enumerate(((300, 280), (260, 400), (320, 240))):
                _img(d / f"{w}_{i}.JPEG", size, 7 * k + i, "JPEG")
    return root


@pytest.mark.parametrize("model,side", [("inceptionv1", 229), ("vit_base", 224),
                                        ("clip_vit_b16", 224), ("clip_vit_b16_split", 224)])
def test_imagenet_folders_per_model_decode_match_jax(imagenet_dir, model, side):
    """load_data on the folders: InceptionV1's resize-256 / crop-229 / -117, the
    ViT processor's direct bilinear 224 px and the CLIP processor's bicubic
    shortest edge and centre crop at 224 px (C7: with data_dir the tower gets
    224 px; without it, the 229 px stand-in, tests/test_torch_vit.py)."""
    fields = dict(model_name=model, dataset_name="imagenet", data_dir=str(imagenet_dir))
    t = T.load_data(TConfig(**fields))
    j = J.load_data(JConfig(**fields))
    assert tuple(t[3]) == tuple(j[3]) == (side, side, 3)
    for tds, jds in zip(t[:2], j[:2]):
        assert tds.decode_fn.__name__ == jds.decode_fn.__name__
        _same_dataset(tds, jds, batch=2)
    assert next(t[0].batches(2, shuffle=False)).images.shape == (2, side, side, 3)


def test_imagenet_class_filter_matches_jax(imagenet_dir):
    fields = dict(model_name="inceptionv1", dataset_name="imagenet", data_dir=str(imagenet_dir))
    t = T.load_data(TConfig(**fields), class_filter="n01443537")
    j = J.load_data(JConfig(**fields), class_filter="n01443537")
    assert len(t[0]) == 3 and set(t[0].labels.tolist()) == {1}
    _same_dataset(t[0], j[0], batch=3)
    assert t[2] == j[2] == ["n01440764", "n01443537"]


def test_a_pipeline_applies_the_class_filter(imagenet_dir, tmp_path):
    from sparse_vision_tpu_torch.train.pipeline import Pipeline

    cfg = TConfig(model_name="inceptionv1", dataset_name="imagenet", sae_layer="mixed3a",
                  data_dir=str(imagenet_dir), imagenet_class_filter="n01440764",
                  sae_model_name="None", original_model=True, directory_path=str(tmp_path))
    pipe = Pipeline(cfg, device="cpu")
    assert len(pipe.train_ds) == 3 and set(pipe.train_ds.labels.tolist()) == {0}


def test_a_missing_pil_raises_at_the_first_decode(imagenet_dir, monkeypatch):
    """Listing the files needs no PIL; the first decode raises PIL's
    ImportError, with no other decoder behind it."""
    monkeypatch.setitem(sys.modules, "PIL", None)
    monkeypatch.setitem(sys.modules, "PIL.Image", None)
    ds = T.load_imagenet(str(imagenet_dir), "train")
    with pytest.raises(ImportError, match="PIL"):
        next(ds.batches(2, shuffle=False, workers=0))


# ---------------------------------------------------------------------------
# the decode pool, fetch_images_batches
# ---------------------------------------------------------------------------

def _raw(path):
    return np.asarray(Image.open(path).convert("RGB"), np.float32)


def _raw_bytes(data):
    return np.asarray(Image.open(io.BytesIO(data)).convert("RGB"), np.float32)


@pytest.fixture(scope="module")
def jpegs(tmp_path_factory):
    d = tmp_path_factory.mktemp("jpegs")
    paths, labels = [], []
    for i in range(24):
        p = str(d / f"img_{i:03d}.jpg")
        _img(p, (32, 32), i, "JPEG")
        paths.append(p)
        labels.append(i % 5)
    return paths, labels


def test_lazy_pool_equals_synchronous_and_jax(jpegs):
    paths, labels = jpegs
    t = T.LazyImageDataset(paths, labels, ["x"], _raw)
    j = J.LazyImageDataset(paths, labels, ["x"], _raw)
    sync = list(t.batches(5, shuffle=True, seed=1, workers=0))
    assert _same_batches(sync, t.batches(5, shuffle=True, seed=1, workers=3)) == 4
    _same_batches(sync, j.batches(5, shuffle=True, seed=1, workers=0))


def test_lazy_decode_error_propagates(jpegs):
    paths, labels = jpegs
    broken = list(paths)
    broken[3] += ".does_not_exist"
    for workers in (0, 4):
        with pytest.raises(FileNotFoundError):
            list(T.LazyImageDataset(broken, labels, ["x"], _raw).batches(
                8, shuffle=False, workers=workers))


def test_fetch_images_batches_over_files_and_tars_match_jax(jpegs, tmp_path):
    paths, labels = jpegs
    want_idx = [5, 0, 3, 23, 1]
    lazy = T.LazyImageDataset(paths, labels, ["x"], _raw)
    tars = T.write_tar_shards(paths, labels, str(tmp_path), shard_size=10)
    tar = T.TarShardDataset(tars, ["x"], _raw_bytes)
    ref = J.fetch_images(J.LazyImageDataset(paths, labels, ["x"], _raw), want_idx)
    for ds in (lazy, tar):
        np.testing.assert_array_equal(T.fetch_images(ds, want_idx), ref)
        for workers in (0, 2):
            chunks = list(T.fetch_images_batches(ds, want_idx, 2, workers=workers))
            assert [c.tolist() for c, _ in chunks] == [[5, 0], [3, 23], [1]]
            np.testing.assert_array_equal(np.concatenate([i for _, i in chunks]), ref)


# ---------------------------------------------------------------------------
# tar shards
# ---------------------------------------------------------------------------

def test_tar_shards_byte_equal_to_jax_and_read_in_order(jpegs, tmp_path):
    paths, labels = jpegs
    t = T.write_tar_shards(paths, labels, str(tmp_path / "t"), shard_size=10)
    j = J.write_tar_shards(paths, labels, str(tmp_path / "j"), shard_size=10)
    assert [os.path.basename(p) for p in t] == [os.path.basename(p) for p in j] == [
        "train-00000.tar", "train-00001.tar", "train-00002.tar"]
    for a, b in zip(t, j):
        assert open(a, "rb").read() == open(b, "rb").read()
    tds = T.TarShardDataset(t, ["x"], _raw_bytes)
    assert tds.entries == J.TarShardDataset(j, ["x"], _raw_bytes).entries
    ref = T.LazyImageDataset(paths, labels, ["x"], _raw)
    assert _same_batches(tds.batches(6, shuffle=False), ref.batches(6, shuffle=False)) == 4


def test_tar_shuffle_matches_jax_and_covers_the_epoch(jpegs, tmp_path):
    paths, labels = jpegs
    tars = T.write_tar_shards(paths, labels, str(tmp_path), shard_size=10)
    t = T.TarShardDataset(tars, ["x"], _raw_bytes)
    j = J.TarShardDataset(tars, ["x"], _raw_bytes)
    a = list(t.batches(4, shuffle=True, seed=7))
    _same_batches(a, j.batches(4, shuffle=True, seed=7))
    idx = np.concatenate([b.indices for b in a])
    assert len(np.unique(idx)) == len(idx) == 24
    for b in a:
        np.testing.assert_array_equal(b.labels, t.labels[b.indices])
    assert any(not np.array_equal(x.indices, y.indices)
               for x, y in zip(a, t.batches(4, shuffle=True, seed=8)))


def test_tar_index_cache_reused_and_invalidated(jpegs, tmp_path):
    paths, labels = jpegs
    tars = T.write_tar_shards(paths, labels, str(tmp_path), shard_size=10)
    first = T.TarShardDataset(tars, ["x"], _raw_bytes)
    (cache,) = list(tmp_path.glob("_svt_index_*.json"))
    stamp = os.path.getmtime(cache)
    again = T.TarShardDataset(tars, ["x"], _raw_bytes)
    assert os.path.getmtime(cache) == stamp and again.entries == first.entries
    # a JAX dataset reads the port's index file (one format)
    assert J.TarShardDataset(tars, ["x"], _raw_bytes).entries == first.entries
    assert os.path.getmtime(cache) == stamp
    last = first.get_image(len(paths) - 1)
    tars2 = T.write_tar_shards(paths[::-1], labels[::-1], str(tmp_path), shard_size=10)
    os.utime(tars2[0])
    regen = T.TarShardDataset(tars2, ["x"], _raw_bytes)
    np.testing.assert_array_equal(regen.labels, np.asarray(labels[::-1], np.int32))
    np.testing.assert_array_equal(regen.get_image(0), last)


def test_tar_index_files_are_split_specific(jpegs, tmp_path):
    paths, labels = jpegs
    tr = T.write_tar_shards(paths[:12], labels[:12], str(tmp_path), shard_size=10)
    va = T.write_tar_shards(paths[12:], labels[12:], str(tmp_path), shard_size=10,
                            prefix="val")
    T.TarShardDataset(tr, ["x"], _raw_bytes)
    T.TarShardDataset(va, ["x"], _raw_bytes)
    caches = sorted(tmp_path.glob("_svt_index_*.json"))
    assert len(caches) == 2
    stamps = [os.path.getmtime(c) for c in caches]
    T.TarShardDataset(tr, ["x"], _raw_bytes)
    T.TarShardDataset(va, ["x"], _raw_bytes)
    assert [os.path.getmtime(c) for c in caches] == stamps


def test_tar_workers_zero_is_synchronous_and_equals_the_pool(jpegs, tmp_path):
    paths, labels = jpegs
    tars = T.write_tar_shards(paths, labels, str(tmp_path), shard_size=10)
    seen = set()

    def tracking(data):
        seen.add(threading.get_ident())
        return _raw_bytes(data)

    sync = list(T.TarShardDataset(tars, ["x"], tracking).batches(4, shuffle=True, seed=3,
                                                                 workers=0))
    assert seen == {threading.get_ident()}
    pool = T.TarShardDataset(tars, ["x"], _raw_bytes).batches(4, shuffle=True, seed=3,
                                                              workers=4)
    assert _same_batches(sync, pool) == 6


def test_load_data_prefers_tar_shards_and_names_the_classes(jpegs, tmp_path):
    """ImageNet's tar shards first (the CLIP decode at 224 px, bitwise JAX's),
    names from wnids.txt; the class filter stays on the folders; a split
    without shards falls back to them."""
    paths, labels = jpegs
    base = tmp_path / "imagenet"
    T.write_tar_shards(paths, labels, str(base), shard_size=10, prefix="train")
    T.write_tar_shards(paths[:8], labels[:8], str(base), shard_size=10, prefix="val")
    (base / "wnids.txt").write_text("\n".join(f"n{i:08d}" for i in range(5)))
    fields = dict(model_name="clip_vit_b16", dataset_name="imagenet", data_dir=str(tmp_path))
    t = T.load_data(TConfig(**fields))
    j = J.load_data(JConfig(**fields))
    assert isinstance(t[0], T.TarShardDataset) and t[2][0] == "n00000000"
    assert tuple(t[3]) == (224, 224, 3)
    for tds, jds in zip(t[:2], j[:2]):
        _same_dataset(tds, jds, batch=4)
    assert T.load_imagenet_tars(str(tmp_path), "test") is None
    with pytest.raises(FileNotFoundError):  # no class folders to filter
        T.load_data(TConfig(**fields), class_filter="n00000001")


def test_c5_class_543_from_a_tar_shard_raises_in_ie(tmp_path):
    """ROADMAP C5 on real data: a shard whose .cls holds ImageNet class 543
    reaches interp/ie.py's batches on inceptionv1 + ImageNet, which translate
    the labels to GoogLeNet's old convention and raise the ValueError that
    names the class before the batch leaves the host."""
    from sparse_vision_tpu_torch.interp import ie
    from sparse_vision_tpu_torch.models.backbone import make_backbone

    paths = []
    for i in range(4):
        p = str(tmp_path / f"img_{i}.jpg")
        _img(p, (64, 48), i, "JPEG")
        paths.append(p)
    T.write_tar_shards(paths, [1, 543, 7, 9], str(tmp_path / "data" / "imagenet"),
                       prefix="train")
    cfg = TConfig(model_name="inceptionv1", dataset_name="imagenet", sae_layer="mixed3a",
                  data_dir=str(tmp_path / "data"), sae_batch_size=4, data_workers=0)
    train = T.load_imagenet_tars(cfg.data_dir, "train")
    assert train.labels.tolist() == [1, 543, 7, 9]
    pipe = SimpleNamespace(cfg=cfg, net=make_backbone(cfg.model_name, cfg.dataset_name),
                           train_ds=train, device=torch.device("cpu"))
    with pytest.raises(ValueError, match="ImageNet class 543"):
        next(iter(ie._batches(pipe)))


# ---------------------------------------------------------------------------
# cfg.data_workers at every read
# ---------------------------------------------------------------------------

class _Spy(ArrayDataset):
    """Records the ``workers`` of every batches call."""

    def __init__(self, *a):
        super().__init__(*a)
        self.workers = []

    def batches(self, batch_size, shuffle, seed=0, workers=0):
        self.workers.append(workers)
        return super().batches(batch_size, shuffle, seed, workers)


def test_data_workers_reach_every_dataset_read(tmp_path, monkeypatch):
    """The eval loop, the uncached train loop, the cache dump, the original
    model's train and eval, interp/ie.py's batches and the MIS fetch all pass
    cfg.data_workers."""
    from sparse_vision_tpu_torch.interp import ie, mis
    from sparse_vision_tpu_torch.train.pipeline import Pipeline

    def data():
        src = T.make_synthetic(num_samples=32, img_size=(28, 28, 1))
        tr = _Spy(src.images, src.labels, src.category_names)
        va = _Spy(src.images[:16], src.labels[:16], src.category_names)
        return tr, va, tr.category_names, (28, 28, 1)

    base = dict(model_name="custom_mlp_9", dataset_name="mnist", sae_layer="fc1",
                sae_batch_size=16, batch_size=16, data_workers=3, sae_epochs=1,
                model_epochs=1, directory_path=str(tmp_path), log_every=10**9)
    for extra in ({"use_activation_cache": False},
                  {"use_activation_cache": True, "cache_tokens_per_step": 16,
                   "compute_dtype": "float32"},
                  {"original_model": True, "sae_model_name": "None"}):
        ds = data()
        pipe = Pipeline(TConfig(**base, **extra), device="cpu", datasets=ds)
        pipe.run()
        assert ds[0].workers and set(ds[0].workers) == {3}, extra
        assert ds[1].workers and set(ds[1].workers) == {3}, extra
    ds = data()
    pipe = Pipeline(TConfig(**base), device="cpu", datasets=ds)
    list(ie._batches(pipe))
    assert ds[0].workers == [3]
    seen = []
    real = T.fetch_images_batches

    def spy(dataset, indices, batch_size, workers=None):
        seen.append(workers)
        return real(dataset, indices, batch_size, workers)

    monkeypatch.setattr(T, "fetch_images_batches", spy)
    fn_dir = os.path.join(pipe.paths["evaluation_results"], "filename_indices")
    os.makedirs(fn_dir, exist_ok=True)
    idx = np.tile(np.arange(20, dtype=np.int32)[:, None], (1, 4))
    np.savez(os.path.join(fn_dir, f"{pipe.run_id}_epoch_0.npz"), max_filename_indices=idx,
             min_filename_indices=idx[::-1])
    mis.compute_mis_for_run(pipe, n_mis=2, k_mis=9)
    assert seen == [3]
