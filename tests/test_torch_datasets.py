"""The port's CIFAR-2/CIFAR-100/MNIST datasets, its k-means and its ResNet-18
tower against the JAX package's, on the CPU.

- Datasets: ``cifar2``, ``cifar100``, ``cifar100_f``, ``mnist`` and
  ``cifar100_new`` (from a group-label cache) built from tiny fixtures in
  the real on-disk layouts (the ``cifar-10-batches-py`` and
  ``cifar-100-python`` pickles, MNIST's idx files), bit for bit against the
  JAX ``create_dataset``. A cache the JAX package writes is read as it is,
  and one the port writes is read by the JAX package. A CLI regroups an
  uncached ``cifar100_new`` on its ``--device``.
- k-means (the JAX package runs sklearn's ``KMeans(n_init=10)``): the same
  partition as sklearn, up to relabelling (adjusted Rand index 1.0), on
  well-separated blobs; an inertia within 1% of sklearn's on random
  features.
- ResNet-18: the port's tower with the JAX variables carried over by
  `params_from_jax` against the flax tower, rtol 2e-4 / atol 2e-5 (f32
  convolutions summed in other orders, tests/test_resnet_numeric.py's
  tolerance); `resnet18_embed` against the JAX ``resnet18_embed`` on 2
  images resized 32 -> 224, the same tolerance; the resize alone against
  ``jax.image.resize`` within 1e-6; the '/'-joined ``.npz`` layout of
  ``cli.convert_weights --kind resnet18`` and a torchvision state dict with
  its fc head read bit for bit. Narrow stages keep the towers fast; the
  layout map is width-agnostic.
"""

import os
import pickle
import struct

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from scipy.stats import ortho_group
from sklearn.cluster import KMeans
from sklearn.metrics import adjusted_rand_score

from group_attribution_for_diffusion_models_tpu.cli.convert_weights import _flatten
from group_attribution_for_diffusion_models_tpu.data import datasets as jax_datasets
from group_attribution_for_diffusion_models_tpu.models import resnet as jax_resnet
from group_attribution_for_diffusion_models_tpu_torch.data import datasets
from group_attribution_for_diffusion_models_tpu_torch.data.kmeans import kmeans
from group_attribution_for_diffusion_models_tpu_torch.models import resnet

STAGES = (8, 16, 24, 32)
TOWER_RTOL, TOWER_ATOL = 2e-4, 2e-5
RESIZE_ATOL = 1e-6
INERTIA_RTOL = 0.01


@pytest.fixture(scope="module", autouse=True)
def _one_torch_thread():
    """One torch thread while this module runs: the test workers share the CPU."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _write_cifar10(root, per_batch=40, seed=0):
    base = os.path.join(root, "cifar-10-batches-py")
    os.makedirs(base)
    rng = np.random.default_rng(seed)
    for name in [f"data_batch_{i}" for i in range(1, 6)] + ["test_batch"]:
        with open(os.path.join(base, name), "wb") as f:
            pickle.dump({"data": rng.integers(0, 256, (per_batch, 3072), dtype=np.uint8),
                         "labels": rng.integers(0, 10, per_batch).tolist()}, f)


def _write_cifar100(root, per_class=3, seed=1):
    """Every fine class `per_class` times, shuffled (the real pickle's keys)."""
    base = os.path.join(root, "cifar-100-python")
    os.makedirs(base)
    rng = np.random.default_rng(seed)
    for name, n in (("train", per_class), ("test", 1)):
        fine = rng.permutation(np.repeat(np.arange(100), n)).tolist()
        with open(os.path.join(base, name), "wb") as f:
            pickle.dump({"data": rng.integers(0, 256, (len(fine), 3072), dtype=np.uint8),
                         "fine_labels": fine, "coarse_labels": [0] * len(fine)}, f)


def _write_mnist(root, n=30, seed=2):
    base = os.path.join(root, "MNIST", "raw")
    os.makedirs(base)
    rng = np.random.default_rng(seed)
    for prefix, count in (("train", n), ("t10k", 5)):
        with open(os.path.join(base, f"{prefix}-images-idx3-ubyte"), "wb") as f:
            f.write(struct.pack(">IIII", 2051, count, 28, 28))
            f.write(rng.integers(0, 256, (count, 28, 28), dtype=np.uint8).tobytes())
        with open(os.path.join(base, f"{prefix}-labels-idx1-ubyte"), "wb") as f:
            f.write(struct.pack(">II", 2049, count))
            f.write(rng.integers(0, 10, count, dtype=np.uint8).tobytes())


@pytest.fixture(scope="module")
def root(tmp_path_factory):
    path = str(tmp_path_factory.mktemp("datasets"))
    _write_cifar10(path)
    _write_cifar100(path)
    _write_mnist(path)
    return path


@pytest.mark.parametrize("name", ["cifar2", "cifar100", "cifar100_f", "mnist"])
@pytest.mark.parametrize("train", [True, False])
def test_datasets_bitwise(root, name, train):
    got = datasets.create_dataset(name, train=train, dataset_dir=root)
    want = jax_datasets.create_dataset(name, train=train, dataset_dir=root)
    assert got.images.dtype == want.images.dtype == np.float32
    assert got.labels.dtype == want.labels.dtype == np.int64
    np.testing.assert_array_equal(got.images, want.images)
    np.testing.assert_array_equal(got.labels, want.labels)
    if name == "mnist":
        assert got.images.shape[1:] == (32, 32, 1) and (got.images[:, :2] == -1.0).all()
    if name == "cifar100" and train:
        assert got.images.shape == (60, 32, 32, 3)
        assert np.array_equal(np.unique(got.labels), np.arange(20))
    if name == "cifar2":
        assert set(got.labels.tolist()) <= {0, 1}


def _blobs(n_centers, per_center, dim, seed):
    rng = np.random.default_rng(seed)
    centers = rng.standard_normal((n_centers, dim)) * 20.0
    x = np.repeat(centers, per_center, axis=0) + rng.standard_normal(
        (n_centers * per_center, dim)) * 0.1
    return x.astype(np.float32)


def test_cifar100_new_cache_crosses_packages(root, monkeypatch, tmp_path):
    """Both packages regroup the same per-image features (injected in place
    of the ResNet-18 embeddings): the same partition of the 60 animal
    images into 40 groups; the cache one package writes, the other reads."""
    n = len(datasets.create_dataset("cifar100", dataset_dir=root))
    feats = _blobs(40, 2, 16, seed=5)[:n]
    monkeypatch.setattr(jax_resnet, "resnet18_embed", lambda variables, images: feats)
    monkeypatch.setattr(jax_resnet, "unflatten_npz", lambda flat: {})
    monkeypatch.setattr(resnet, "resnet18_embed", lambda model, images: feats)
    monkeypatch.setattr(resnet, "load_resnet18", lambda path, device: None)
    monkeypatch.setenv("GADM_RESNET18_WEIGHTS", str(tmp_path / "w.npz"))
    np.savez(tmp_path / "w.npz", unused=np.zeros(1))
    cache = os.path.join(root, "cifar100_new_targets.npy")

    want = jax_datasets.create_dataset("cifar100_new", dataset_dir=root)  # writes the cache
    jax_written = np.load(cache)
    got = datasets.create_dataset("cifar100_new", dataset_dir=root, device="cpu")
    np.testing.assert_array_equal(got.labels, jax_written)
    np.testing.assert_array_equal(got.images, want.images)

    os.remove(cache)
    port = datasets.create_dataset("cifar100_new", dataset_dir=root, device="cpu")
    assert adjusted_rand_score(port.labels, want.labels) == 1.0
    assert len(np.unique(port.labels)) == datasets.CIFAR100_NEW_GROUPS
    read_by_jax = jax_datasets.create_dataset("cifar100_new", dataset_dir=root)
    np.testing.assert_array_equal(read_by_jax.labels, port.labels)

    np.save(cache, np.zeros(n + 1, np.int64))
    with pytest.raises(ValueError, match=f"holds {n + 1} targets for {n} images"):
        datasets.create_dataset("cifar100_new", dataset_dir=root, device="cpu")
    os.remove(cache)
    monkeypatch.delenv("GADM_RESNET18_WEIGHTS")
    with pytest.raises(ValueError, match="GADM_RESNET18_WEIGHTS"):
        datasets.create_dataset("cifar100_new", dataset_dir=root, device="cpu")


def test_cli_regroups_cifar100_new_on_its_device(monkeypatch, tmp_path):
    """A CLI that loads an uncached cifar100_new runs the regroup's tower on
    its ``--device`` (features injected as above) and writes the cache."""
    from group_attribution_for_diffusion_models_tpu_torch.cli import group_distribution

    data = str(tmp_path / "data")
    _write_cifar100(data)
    monkeypatch.setattr(datasets.constants, "DATASET_DIR", data)
    n = len(datasets.create_dataset("cifar100", dataset_dir=data))
    feats = _blobs(40, 2, 16, seed=5)[:n]
    devices = []
    monkeypatch.setattr(resnet, "load_resnet18", lambda path, device: devices.append(device))
    monkeypatch.setattr(resnet, "resnet18_embed", lambda model, images: feats)
    monkeypatch.setenv("GADM_RESNET18_WEIGHTS", str(tmp_path / "w.npz"))
    np.save(tmp_path / "scores.npy", np.arange(n, dtype=np.float32))
    rows = group_distribution.main(["--scores", str(tmp_path / "scores.npy"),
                                    "--dataset", "cifar100_new", "--device", "cpu"])
    assert devices == ["cpu"]
    cache = np.load(os.path.join(data, "cifar100_new_targets.npy"))
    assert sorted(r["group"] for r in rows) == sorted(str(g) for g in np.unique(cache))
    assert sum(r["count"] for r in rows) == n


def test_every_cli_passes_its_device_to_create_dataset():
    """Each `create_dataset` call of the port's CLIs names a device, so a
    cifar100_new regroup runs where the caller asked."""
    import ast
    import pathlib

    cli = pathlib.Path(datasets.__file__).parents[1] / "cli"
    calls = []
    for path in sorted(cli.glob("*.py")):
        for node in ast.walk(ast.parse(path.read_text())):
            if (isinstance(node, ast.Call) and isinstance(node.func, ast.Name)
                    and node.func.id == "create_dataset"):
                calls.append((path.name, node.lineno,
                              any(k.arg == "device" for k in node.keywords)))
    assert calls
    assert [c for c in calls if not c[2]] == []


@pytest.mark.parametrize("k,per_center,dim", [(8, 50, 16), (40, 12, 64)])
def test_kmeans_partition_matches_sklearn_on_blobs(k, per_center, dim):
    x = _blobs(k, per_center, dim, seed=k)
    labels, centers, inertia = kmeans(x, k, n_init=10, seed=0)
    want = KMeans(n_clusters=k, random_state=0, n_init=10).fit(x)
    assert adjusted_rand_score(labels, want.labels_) == 1.0
    assert labels.dtype == np.int64 and centers.shape == (k, dim)
    assert inertia == pytest.approx(want.inertia_, rel=1e-4)


@pytest.mark.parametrize("seed", [0, 1])
def test_kmeans_inertia_within_one_percent_of_sklearn(seed):
    """Random features (no true clusters, many local optima): the best of 10
    restarts lands within 1% of sklearn's best of 10."""
    rng = np.random.default_rng(seed)
    x = (rng.standard_normal((600, 24)) @ ortho_group.rvs(24, random_state=seed)).astype(
        np.float32)
    _, _, inertia = kmeans(x, 20, n_init=10, seed=0)
    want = KMeans(n_clusters=20, random_state=0, n_init=10).fit(x).inertia_
    assert abs(inertia - want) <= INERTIA_RTOL * want, (inertia, want)
    with pytest.raises(ValueError, match="points for"):
        kmeans(x[:3], 4)


@pytest.fixture(scope="module")
def jax_tower():
    """The flax tower of STAGES with drawn BatchNorm statistics and affines."""
    model = jax_resnet.ResNet18Features(stages=STAGES)
    variables = jax.jit(model.init)(jax.random.PRNGKey(0), jnp.zeros((1, 64, 64, 3)))
    rng = np.random.default_rng(4)

    def draw(path, leaf):
        name = path[-1].key
        if name == "mean":
            return jnp.asarray(rng.standard_normal(leaf.shape) * 0.3, jnp.float32)
        if name == "var":
            return jnp.asarray(rng.uniform(0.5, 1.5, leaf.shape), jnp.float32)
        if name in ("scale", "bias"):
            return jnp.asarray(rng.standard_normal(leaf.shape) * 0.2 + (name == "scale"),
                               jnp.float32)
        return leaf

    variables = jax.tree_util.tree_map_with_path(draw, variables)
    port = resnet.ResNet18Features(stages=STAGES)
    port.load_state_dict(resnet.params_from_jax(variables))
    return model, variables, port.eval()


def test_tower_matches_jax(jax_tower):
    model, variables, port = jax_tower
    x = np.random.default_rng(5).uniform(0, 1, (2, 64, 64, 3)).astype(np.float32)
    want = np.asarray(model.apply(variables, jnp.asarray(x)))
    with torch.no_grad():
        got = port(torch.from_numpy(x).permute(0, 3, 1, 2)).numpy()
    assert got.shape == (2, STAGES[-1])
    np.testing.assert_allclose(got, want, rtol=TOWER_RTOL, atol=TOWER_ATOL)


def test_embed_matches_jax_resnet18_embed(jax_tower):
    _, variables, port = jax_tower
    images = np.random.default_rng(6).uniform(0, 1, (2, 32, 32, 3)).astype(np.float32)
    want = jax_resnet.resnet18_embed(variables, images, stages=STAGES)
    got = resnet.resnet18_embed(port, images)
    assert got.shape == want.shape == (2, STAGES[-1]) and got.dtype == np.float32
    np.testing.assert_allclose(got, want, rtol=TOWER_RTOL, atol=TOWER_ATOL)


@pytest.mark.parametrize("size", [224, 50])
def test_resize_matches_jax_image_resize(size):
    """32 -> 224 (the regroup's) and a ragged upscale, edges included."""
    x = np.random.default_rng(7).uniform(0, 1, (2, 32, 32, 3)).astype(np.float32)
    want = np.asarray(jax.image.resize(jnp.asarray(x), (2, size, size, 3), "bilinear"))
    got = resnet.resize_bilinear(torch.from_numpy(x).permute(0, 3, 1, 2), size)
    got = got.permute(0, 2, 3, 1).numpy()
    assert np.abs(got - want).max() <= RESIZE_ATOL


def test_weight_files_load_bitwise(tmp_path):
    """A torchvision-named state dict (with its fc head and BatchNorm
    counters) loads as it is; the JAX converter's .npz of it gives the same
    tensors; the full-width tower has torchvision's 11,176,512 parameters;
    `init_resnet18` draws the same tower from the same seed."""
    tower = resnet.init_resnet18(seed=3)
    sd = {k: v.clone() for k, v in tower.state_dict().items()}
    for k in sd:
        if k.endswith("running_var"):
            sd[k] = torch.rand(sd[k].shape) + 0.5
    assert sum(p.numel() for p in tower.parameters()) == 11_176_512
    tv = dict(sd, **{"fc.weight": torch.zeros(1000, 512), "fc.bias": torch.zeros(1000),
                     "bn1.num_batches_tracked": torch.tensor(0)})
    torch.save(tv, tmp_path / "resnet18.pth")
    np.savez(tmp_path / "resnet18.npz", **_flatten(jax_resnet.convert_resnet18_state_dict(
        {k: v.numpy() for k, v in tv.items()})))
    for path in ("resnet18.pth", "resnet18.npz"):
        got = resnet.load_resnet18(str(tmp_path / path), device="cpu").state_dict()
        assert sorted(got) == sorted(sd)
        for k in sd:
            assert torch.equal(got[k], sd[k]), (path, k)
    again, other = resnet.init_resnet18(seed=3), resnet.init_resnet18(seed=4)
    assert all(torch.equal(again.state_dict()[k], v) for k, v in tower.state_dict().items())
    assert not torch.equal(other.conv1.weight, tower.conv1.weight)
