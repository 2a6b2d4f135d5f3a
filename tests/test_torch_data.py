"""The port's copies of JAX's NumPy data modules: arrays, labels, names and
indices bit-equal to the originals'."""

import numpy as np
import pytest

import fast_image_recognition_tpu.data as JD
from fast_image_recognition_tpu.data.splits import FeatureStats as JStats
from fast_image_recognition_tpu_torch import data as PD
from fast_image_recognition_tpu_torch.data.splits import FeatureStats
from test_torch_synthetic import _one_thread  # noqa: F401


@pytest.mark.parametrize("nonneg,l2", [(True, True), (True, False), (False, True)])
def test_synthetic_gallery_bit_equal(nonneg, l2):
    a = PD.make_synthetic_gallery(7, 5, 33, seed=9, within_class_noise=0.2, nonneg=nonneg, l2=l2)
    b = JD.make_synthetic_gallery(7, 5, 33, seed=9, within_class_noise=0.2, nonneg=nonneg, l2=l2)
    for x, y in zip(a, b):
        assert x.dtype == y.dtype
        np.testing.assert_array_equal(x, y)


def test_gallery_and_probes_bit_equal():
    a = PD.make_gallery_and_probes(6, 4, 2, 40, seed=3)
    b = JD.make_gallery_and_probes(6, 4, 2, 40, seed=3)
    assert [x.shape for x in a] == [(24, 40), (24,), (12, 40), (12,)]
    for x, y in zip(a, b):
        assert x.dtype == y.dtype
        np.testing.assert_array_equal(x, y)


def _write_raw(path):
    """Clutter classes, padded class names, a short vector, tiny entries and an all-tiny row."""
    rng = np.random.default_rng(0)
    classes = ["cat", "  dog", "BACKGROUND_Google", "257.clutter", "emu", "fox", "gnu"]
    with open(path, "w") as fh:
        for i in range(40):
            c = classes[i % len(classes)]
            v = rng.uniform(-1, 1, 12).astype(np.float32)
            v[rng.uniform(size=12) < 0.2] = 5e-5
            if i == 1:
                v = v[:9]
            if i == 15:
                v[:] = -3e-5
            fh.write(f"img_{i}.jpg\n{c}\n" + " ".join(repr(float(x)) for x in v) + "\n")


@pytest.mark.parametrize("l2", [True, False])
@pytest.mark.parametrize("max_classes", [None, 3])
def test_load_feature_file_matches_jax(tmp_path, l2, max_classes):
    path = str(tmp_path / "raw.txt")
    _write_raw(path)
    kw = dict(skip_class_substrings=("BACKGROUND_Google", "257.clutter"), max_classes=max_classes, l2_normalize=l2)
    a = PD.load_feature_file(path, 12, **kw)
    b = JD.load_feature_file(path, 12, engine="python", **kw)
    assert a.features.dtype == np.float32 and a.labels.dtype == np.int32
    np.testing.assert_array_equal(a.features, b.features)
    np.testing.assert_array_equal(a.labels, b.labels)
    assert a.class_names == b.class_names and a.file_names == b.file_names
    assert "dog" in a.class_names and not any("clutter" in c for c in a.class_names)
    assert a.num_classes == (3 if max_classes else 5)
    assert not ((a.features != 0) & (np.abs(a.features) < 1e-4 / 10)).any()  # the zeroing held
    assert (a.features[a.file_names.index("img_1.jpg")][9:] == 0).all()
    np.testing.assert_array_equal(a.class_counts(), b.class_counts())
    c, d = a.drop_singleton_classes(), b.drop_singleton_classes()
    np.testing.assert_array_equal(c.features, d.features)
    np.testing.assert_array_equal(c.labels, d.labels)
    np.testing.assert_array_equal(PD.load_feature_file(path, 12, engine="python", **kw).features, a.features)


def test_normalize_and_native_engine(tmp_path):
    raw = np.random.default_rng(1).uniform(-1, 1, (6, 10)).astype(np.float32)
    raw[2] = 0.0
    raw[3, :4] = 2e-5
    for l2 in (True, False):
        np.testing.assert_array_equal(PD.normalize_features(raw, l2=l2), JD.normalize_features(raw, l2=l2))
    path = str(tmp_path / "x.txt")
    PD.write_feature_file(path, raw, np.zeros(6, np.int32), ["a"])
    with pytest.raises(NotImplementedError, match="native"):
        PD.load_feature_file(path, 10, engine="native")


@pytest.mark.parametrize("per_class,fraction", [(3, 0.03), (None, 0.3), (None, 0.01)])
def test_train_test_split_indices_equal(per_class, fraction):
    labels = np.repeat(np.arange(9), [5, 1, 7, 2, 9, 4, 3, 8, 6])
    labels = labels[np.random.default_rng(2).permutation(labels.size)]
    a = PD.train_test_split_images(labels, np.random.default_rng(7), train_images_per_class=per_class,
            train_fraction=fraction, indices_count=20)
    b = JD.train_test_split_images(labels, np.random.default_rng(7), train_images_per_class=per_class,
            train_fraction=fraction, indices_count=20)
    assert a.train_idx.dtype == np.int64
    np.testing.assert_array_equal(a.train_idx, b.train_idx)
    np.testing.assert_array_equal(a.test_idx, b.test_idx)


@pytest.mark.parametrize("fraction", [0.5, 3])
def test_split_by_class_fraction_and_stats_equal(fraction):
    labels = np.repeat(np.arange(5), [4, 6, 1, 8, 3])
    feats = np.random.default_rng(4).standard_normal((labels.size, 6)).astype(np.float32)
    (a, sa) = PD.split_by_class_fraction(labels, np.random.default_rng(5), fraction, features=feats)
    (b, sb) = JD.split_by_class_fraction(labels, np.random.default_rng(5), fraction, features=feats)
    np.testing.assert_array_equal(a.train_idx, b.train_idx)
    np.testing.assert_array_equal(a.test_idx, b.test_idx)
    for f in ("min", "max", "mean", "std"):
        np.testing.assert_array_equal(getattr(sa, f), getattr(sb, f))
    one = FeatureStats.from_rows(feats[:1])
    np.testing.assert_array_equal(one.std, JStats.from_rows(feats[:1]).std)
