"""The port's sample-based behaviors against the JAX package's, on the CPU.

FID, IS and the stats pickle are numpy and scipy in both packages, so they
must agree bit for bit, and a stats file written by either package must be
read by the other. The towers cannot share a random init (flax draws from
threefry), so the port's InceptionV3 and VGG16 are held against the JAX
towers on JAX variables carried over by `params_from_jax`, every BatchNorm
statistic randomised; the port's own random Inception tower is held to the
JAX random tower's scale of pool3 features, which is what keeps a random
tower's FID informative. Precision and recall: the kth-NN radii within 1e-5
relative and the same precision and recall on the JAX package's own cases.
"""

import math
import pickle

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from group_attribution_for_diffusion_models_tpu.attributions.global_scores import (
    fid as jax_fid,
)
from group_attribution_for_diffusion_models_tpu.attributions.global_scores import (
    inception_score as jax_is,
)
from group_attribution_for_diffusion_models_tpu.attributions.global_scores import (
    inception_v3 as jax_inception,
)
from group_attribution_for_diffusion_models_tpu.attributions.global_scores import (
    precision_recall as jax_pr,
)
from group_attribution_for_diffusion_models_tpu.attributions.global_scores import (
    vgg16 as jax_vgg,
)
from group_attribution_for_diffusion_models_tpu_torch.attributions.global_scores import (
    fid,
    inception_score,
    inception_v3,
    precision_recall,
    vgg16,
)

TOWER_TOL = 2e-3  # atol = rtol, as tests/test_inception_numeric.py holds the JAX tower
D = 64


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """One torch thread while this module runs: the test workers share the CPU."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _features(seed, n=200, d=D):
    rng = np.random.default_rng(seed)
    return rng.standard_normal((n, d)) @ rng.standard_normal((d, d)) * 0.3 + rng.normal(size=d)


def _nilpotent(d=D):
    """A (d, d) matrix whose product with the identity has no square root:
    scipy's sqrtm returns inf and the eps retry runs."""
    m = np.zeros((d, d))
    m[0, 1] = 1.0
    return m


FRECHET_CASES = {
    "gaussians": lambda: (*fid.compute_feature_stats(_features(0)),
                          *fid.compute_feature_stats(_features(1))),
    "singular, eps retry": lambda: (np.zeros(D), _nilpotent(), np.ones(D), np.eye(D)),
    "rank-deficient": lambda: (*fid.compute_feature_stats(_features(2, n=8)),
                               *fid.compute_feature_stats(_features(3))),
}


@pytest.mark.parametrize("case", sorted(FRECHET_CASES))
def test_frechet_distance_is_bit_identical(case):
    mu1, s1, mu2, s2 = FRECHET_CASES[case]()
    if case == "singular, eps retry":
        from scipy import linalg

        assert not np.isfinite(linalg.sqrtm(s1 @ s2)).all()
    got = fid.frechet_distance(mu1, s1, mu2, s2)
    assert math.isfinite(got)
    assert got == jax_fid.frechet_distance(mu1, s1, mu2, s2)


def test_frechet_distance_raises_on_an_imaginary_root_as_jax_does():
    """sqrt(-I) = iI: both packages refuse the imaginary diagonal."""
    args = (np.zeros(4), -np.eye(4), np.zeros(4), np.eye(4))
    with pytest.raises(ValueError, match="Imaginary component"):
        jax_fid.frechet_distance(*args)
    with pytest.raises(ValueError, match="Imaginary component"):
        fid.frechet_distance(*args)


def test_fid_from_features_and_stats_are_bit_identical():
    gen, ref = _features(4, n=50).astype(np.float32), _features(5).astype(np.float32)
    mu, sigma = fid.compute_feature_stats(gen)
    want_mu, want_sigma = jax_fid.compute_feature_stats(gen)
    assert np.array_equal(mu, want_mu) and np.array_equal(sigma, want_sigma)
    stats = jax_fid.compute_feature_stats(ref)
    assert (fid.calculate_fid_from_features(gen, ref_features=ref)
            == jax_fid.calculate_fid_from_features(gen, ref_features=ref))
    assert (fid.calculate_fid_from_features(gen, ref_stats=stats)
            == jax_fid.calculate_fid_from_features(gen, ref_stats=stats))
    with pytest.raises(ValueError, match="need ref_features or ref_stats"):
        fid.calculate_fid_from_features(gen)


@pytest.mark.parametrize("n,splits", [(200, 10), (7, 10), (64, 4)])
def test_inception_score_is_bit_identical(n, splits):
    rng = np.random.default_rng(n)
    logits = (rng.standard_normal((n, 1008)) * 4).astype(np.float32)
    assert (inception_score.inception_score_from_logits(logits, splits)
            == jax_is.inception_score_from_logits(logits, splits))


def test_stats_pickles_cross_read_and_the_tower_tag(tmp_path, capsys):
    mu, sigma = fid.compute_feature_stats(_features(6))
    ported = str(tmp_path / "port.pkl")
    fid.save_stats(ported, mu, sigma, tower="random:0")
    got_mu, got_sigma = jax_fid.load_stats(ported)
    assert np.array_equal(got_mu, mu) and np.array_equal(got_sigma, sigma)
    written = str(tmp_path / "jax.pkl")
    jax_fid.save_stats(written, mu, sigma)
    got_mu, got_sigma = fid.load_stats(written)
    assert np.array_equal(got_mu, mu) and np.array_equal(got_sigma, sigma)
    with open(ported, "rb") as f:
        assert sorted(pickle.load(f)) == ["mu", "sigma", "tower"]

    # Reference stats are used only when the tower that made them is the one
    # in use. The JAX CLIs load any file they find (ROADMAP C3): a file of
    # another tower would silently give FIDs against the wrong features.
    assert fid.load_reference_stats(str(tmp_path / "missing.pkl"), "random:0") is None
    assert fid.load_reference_stats(None, "random:0") is None
    got = fid.load_reference_stats(ported, "random:0")
    assert np.array_equal(got[0], mu) and np.array_equal(got[1], sigma)
    capsys.readouterr()
    assert fid.load_reference_stats(ported, "random:1") is None
    assert "made by tower 'random:0', not 'random:1': recomputing" in capsys.readouterr().out
    assert fid.load_reference_stats(written, "random:0") is None
    assert "made by tower None" in capsys.readouterr().out


def test_inception_tag_names_the_weights(tmp_path):
    path = tmp_path / "w.pt"
    path.write_bytes(b"12345")
    assert inception_v3.inception_tag() == "random:0"
    assert inception_v3.inception_tag(None, 3) == "random:3"
    assert inception_v3.inception_tag(str(path)) == f"{path}:5"


def _random_jax_variables(model, sample_shape, rng, bn_stats=True):
    """Seeded numpy values for every flax variable of `model`: kernels with
    std sqrt(2 / fan_in), biases and BatchNorm scales, means and variances
    randomised (a stat-conversion bug must show)."""
    shapes = jax.eval_shape(model.init, jax.random.PRNGKey(0), jnp.zeros(sample_shape))

    def fill(path, s):
        leaf = path[-1].key
        if leaf == "kernel":
            return (rng.standard_normal(s.shape) * math.sqrt(2.0 / np.prod(s.shape[:-1])))
        if leaf in ("scale", "var"):
            return rng.uniform(0.5, 1.5, s.shape)
        return rng.normal(0.0, 0.1, s.shape)  # bias, mean

    return jax.tree_util.tree_map(lambda x: np.asarray(x, np.float32),
                                  jax.tree_util.tree_map_with_path(fill, shapes))


def _images(seed, n=2, size=64):
    return np.random.RandomState(seed).uniform(0.0, 1.0, (n, size, size, 3)).astype(np.float32)


def _port_tower(out):
    return {k: v.numpy() for k, v in out.items()}


def _nchw(images):
    return torch.from_numpy(images).permute(0, 3, 1, 2)


@pytest.mark.parametrize("fid_variant,num_classes", [(True, 1008), (False, 1000)],
                         ids=["fid", "torchvision"])
def test_inception_matches_the_jax_tower_after_params_from_jax(fid_variant, num_classes):
    model = jax_inception.InceptionV3(num_classes=num_classes, fid_variant=fid_variant)
    variables = _random_jax_variables(model, (1, 32, 32, 3), np.random.default_rng(7))
    imgs = _images(1)
    want = jax.jit(model.apply)(variables, jnp.asarray(imgs))
    port = inception_v3.InceptionV3(num_classes=num_classes, fid_variant=fid_variant).eval()
    port.load_state_dict(inception_v3.params_from_jax(variables))
    with torch.no_grad():
        got = _port_tower(port(_nchw(imgs)))
    assert got["pool3"].shape == (2, 2048) and got["logits"].shape == (2, num_classes)
    for key in ("pool3", "logits"):
        np.testing.assert_allclose(got[key], np.asarray(want[key]), atol=TOWER_TOL,
                                   rtol=TOWER_TOL)


def test_torch_state_dicts_load_as_the_jax_converter_reads_them(tmp_path):
    """The port's state dict is pytorch_fid's layout: the JAX converter maps
    it to flax variables that `params_from_jax` maps back unchanged, and a
    file with num_batches_tracked and an auxiliary head loads."""
    port = inception_v3.load_inception(None, seed=3, device="cpu")
    sd = {k: v.clone() for k, v in port.state_dict().items()}
    back = inception_v3.params_from_jax(jax_inception.convert_torch_state_dict(
        {k: v.numpy() for k, v in sd.items()}))
    assert sorted(back) == sorted(sd)
    assert all(torch.equal(back[k], sd[k]) for k in sd)
    saved = dict(sd, **{"Conv2d_1a_3x3.bn.num_batches_tracked": torch.tensor(0),
                        "AuxLogits.fc.weight": torch.zeros(1000, 768)})
    torch.save(saved, tmp_path / "fid.pt")
    loaded = inception_v3.load_inception(str(tmp_path / "fid.pt"), device="cpu")
    assert all(torch.equal(loaded.state_dict()[k], sd[k]) for k in sd)
    with pytest.raises(KeyError, match="unknown params leaf"):
        inception_v3.params_from_jax({"params": {"fc": {"weights": np.zeros(2)}}})


def test_port_random_tower_keeps_the_jax_random_towers_scale():
    """load_inception(None) in both packages: different draws of the same
    distribution, so pool3 features of the same images must have the same
    scale (within 2x); without the He factor they fall about 60x."""
    model = jax_inception.InceptionV3()
    # load_inception's init, jitted (an eager init of the tower takes ~30 s).
    variables = jax.jit(model.init)(jax.random.PRNGKey(0), jnp.zeros((1, 32, 32, 3)))
    variables = jax.tree_util.tree_map_with_path(
        lambda p, x: x * np.sqrt(2.0) if p[-1].key == "kernel" and x.ndim == 4 else x,
        variables)
    imgs = _images(2, n=4, size=32)
    want = np.asarray(jax.jit(model.apply)(variables, jnp.asarray(imgs))["pool3"]).std()
    port = inception_v3.load_inception(None, device="cpu")
    with torch.no_grad():
        got = port(_nchw(imgs))["pool3"].numpy().std()
    assert 0.5 <= got / want <= 2.0, (got, want)
    convs = [m.weight for m in port.modules() if isinstance(m, torch.nn.Conv2d)]
    assert len(convs) == 94
    # The init's std: lecun_normal's truncated draw times sqrt(2).
    w = port.Mixed_6b.branch1x1.conv.weight
    assert w.std().item() == pytest.approx(math.sqrt(2.0 / 768), rel=0.02)
    assert w.abs().max().item() <= 2 * math.sqrt(2.0 / 768) / inception_v3.TRUNC_STD + 1e-6


VGG_CASES = {  # (stages, fc_dim, input_size, image size, n images, preprocess)
    "tiny": (vgg16.TINY_STAGES, 16, 16, 16, 2, "caffe"),
    "tiny, torchvision": (vgg16.TINY_STAGES, 16, 16, 16, 2, "torchvision"),
    "tiny, resized down 32->16": (vgg16.TINY_STAGES, 16, 16, 32, 2, "none"),
    "full width": (vgg16.VGG16_STAGES, 4096, 224, 224, 1, "caffe"),
}


@pytest.mark.parametrize("case", list(VGG_CASES))
def test_vgg16_matches_the_jax_tower_after_params_from_jax(case):
    stages, fc_dim, size, image, n, preprocess = VGG_CASES[case]
    model = jax_vgg.VGG16Features(stages=stages, fc_dim=fc_dim, input_size=size,
                                  preprocess=preprocess)
    variables = _random_jax_variables(model, (1, size, size, 3), np.random.default_rng(8))
    imgs = _images(3, n=n, size=image)
    want = np.asarray(jax.jit(model.apply)(variables, jnp.asarray(imgs)))
    port = vgg16.VGG16Features(stages, fc_dim, size, preprocess).eval()
    port.load_state_dict(vgg16.params_from_jax(variables, stages))
    with torch.no_grad():
        got = port(_nchw(imgs)).numpy()
    assert got.shape == (n, fc_dim)
    # f32 sums in other orders through 13 convs and two dense layers, against
    # features of up to ~1e4 (caffe scaling): relative to the largest.
    np.testing.assert_allclose(got, want, atol=TOWER_TOL * np.abs(want).max(), rtol=TOWER_TOL)


def test_vgg16_loads_a_torchvision_state_dict(tmp_path):
    port = vgg16.load_vgg16(None, tiny=True, device="cpu")
    sd = dict(port.state_dict(), **{"classifier.6.weight": torch.zeros(1000, 16),
                                    "classifier.6.bias": torch.zeros(1000)})
    assert sorted(port.state_dict()) == [
        "classifier.0.bias", "classifier.0.weight", "classifier.3.bias",
        "classifier.3.weight", "features.0.bias", "features.0.weight", "features.3.bias",
        "features.3.weight"]
    torch.save(sd, tmp_path / "vgg.pt")
    loaded = vgg16.load_vgg16(str(tmp_path / "vgg.pt"), tiny=True, device="cpu")
    assert all(torch.equal(loaded.state_dict()[k], v) for k, v in port.state_dict().items())
    # The JAX converter reads the same names.
    params = jax_vgg.convert_vgg16_state_dict({k: v.numpy() for k, v in sd.items()})
    back = vgg16.params_from_jax({"params": params}, vgg16.TINY_STAGES)
    assert all(torch.equal(back[k], v) for k, v in port.state_dict().items())


def _pr_case(name):
    rng = np.random.RandomState({"identical": 4, "disjoint": 5, "mode collapse": 6,
                                 "random": 9}[name])
    if name == "identical":
        f = rng.normal(size=(200, 16))
        return f, f.copy()
    if name == "disjoint":
        return rng.normal(size=(200, 16)), rng.normal(loc=100.0, size=(200, 16))
    if name == "mode collapse":
        real = np.concatenate([rng.normal(0, 0.1, size=(100, 8)),
                               rng.normal(5, 0.1, size=(100, 8))])
        return real, rng.normal(0, 0.1, size=(200, 8))
    return rng.normal(size=(300, 32)), rng.normal(loc=0.3, scale=1.2, size=(250, 32))


@pytest.mark.parametrize("case", ["identical", "disjoint", "mode collapse", "random"])
def test_precision_recall_matches_jax(case):
    """Radii within 1e-5 relative, where the features' spread is comparable to
    their norms. Both packages round a^2 + b^2 - 2ab in f32, each in its own
    order, so a squared distance carries an error of a few 2^-24 of the
    largest squared norm: the disjoint case's generated set (centred at 100)
    and the mode-collapse case's real set (tight clusters at 0 and 5) read
    radii up to 5e-3 and 1e-3 apart, 4-10 of those units. Precision and
    recall are equal in every case."""
    real, gen = _pr_case(case)
    for feats in (real, gen):
        got = precision_recall.build_manifold(feats, device="cpu")
        want = jax_pr.build_manifold(feats)
        np.testing.assert_array_equal(got.features, want.features)
        sq_norm = float((got.features.astype(np.float64) ** 2).sum(axis=1).max())
        np.testing.assert_allclose(got.radii.astype(np.float64) ** 2,
                                   np.asarray(want.radii, np.float64) ** 2,
                                   rtol=2e-5, atol=16 * 2.0**-24 * sq_norm)
    got = precision_recall.compute_precision_recall(real, gen, device="cpu")
    assert got == jax_pr.compute_precision_recall(real, gen)
    if case == "random":
        assert 0.0 < got[0] < 1.0 and 0.0 < got[1] < 1.0


def test_manifold_pickles_cross_read(tmp_path):
    manifold = precision_recall.build_manifold(_features(10, n=40, d=8), device="cpu")
    precision_recall.save_manifold(str(tmp_path / "m.pkl"), manifold)
    back = jax_pr.load_manifold(str(tmp_path / "m.pkl"))
    assert np.array_equal(back.features, manifold.features)
    assert np.array_equal(back.radii, manifold.radii)
    jax_pr.save_manifold(str(tmp_path / "j.pkl"), back)
    again = precision_recall.load_manifold(str(tmp_path / "j.pkl"))
    assert np.array_equal(again.radii, manifold.radii)
