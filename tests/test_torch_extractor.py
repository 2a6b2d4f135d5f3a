"""``models/extractor.py`` against JAX's and PIL's: PNG (RGB, RGBA, L, palette)
and BMP (24, 32 bit) decoded as PIL's ``convert("RGB")``, a corrupt file
refused; the resize within 1 level of PIL's bicubic (fixed-point
coefficients: 2 at worst over 60 random shapes); both packages'
``extract_dataset_to_file`` from one B0: names, labels, class lines equal,
rows at cosine >= 0.999; a two-entry ``data`` mesh = unsharded."""

import sys

import numpy as np
import pytest
import torch
from PIL import Image

from fast_image_recognition_tpu.models.extractor import extract_dataset_to_file as jax_extract
from fast_image_recognition_tpu_torch.models import create_efficientnet
from fast_image_recognition_tpu_torch.models import extractor as X
from fast_image_recognition_tpu_torch.parallel.mesh import make_mesh
from test_torch_synthetic import _one_thread  # noqa: F401


@pytest.fixture(scope="module")
def root(tmp_path_factory):
    root, rng = tmp_path_factory.mktemp("ds"), np.random.default_rng(0)

    def img(mode, size=224):
        a = rng.integers(0, 256, (size, size + 7, 4), dtype=np.uint8)
        return Image.fromarray(a, "RGBA").convert(mode)

    files = {"a/rgb.png": img("RGB"), "a/rgba.png": img("RGBA"), "a/small.png": img("RGB", 40),
            "b/gray.png": img("L"), "b/pal.png": img("RGB").quantize(64), "b/gray_alpha.png": img("LA"),
            "c/rgb.bmp": img("RGB"), "c/rgba.bmp": img("RGBA")}
    for name, im in files.items():
        (root / name).parent.mkdir(exist_ok=True)
        im.save(root / name)
    (root / "c" / "broken.png").write_bytes((root / "a" / "rgb.png").read_bytes()[:300])
    return root


def test_decode_equals_pil(root):
    paths, _, _ = X.list_image_dataset(str(root))
    assert len(paths) == 9
    for p in paths:
        if "broken" in p:
            with pytest.raises(Exception):
                X.decode_image(p)
            continue
        with Image.open(p) as im:
            np.testing.assert_array_equal(X.decode_image(p), np.asarray(im.convert("RGB")), err_msg=p)


@pytest.mark.parametrize("hw,res", [((40, 47), 224), ((300, 257), 224), ((100, 60), 64), ((224, 224), 224)])
def test_resize_within_one_level_of_pil(hw, res):
    a = np.random.default_rng(hw[0]).integers(0, 256, (*hw, 3), dtype=np.uint8)
    want = np.asarray(Image.fromarray(a).resize((res, res)), np.int16)
    assert np.abs(X.resize_uint8(a, res).astype(np.int16) - want).max() <= 1


def _read(path):
    lines = open(path).read().split("\n")
    recs = [lines[i : i + 3] for i in range(0, len(lines) - 2, 3)]
    return [r[:2] for r in recs], np.array([[float(v) for v in r[2].split()] for r in recs])


def test_extract_dataset_to_file_matches_jax(root, tmp_path):
    _, v = create_efficientnet("b0", 0, seed=0, resolution=32, device="cpu")
    assert X.extract_dataset_to_file(str(root), str(tmp_path / "port.txt"), variables=v, device="cpu") == 8
    assert jax_extract(str(root), str(tmp_path / "jax.txt"), variables=v) == 8
    (meta_p, rows_p), (meta_j, rows_j) = _read(tmp_path / "port.txt"), _read(tmp_path / "jax.txt")
    assert meta_p == meta_j and [m[1] for m in meta_p] == ["a", "a", "a", "b", "b", "b", "c", "c"]
    assert ((rows_p * rows_j).sum(1) >= 0.999).all()


def test_data_mesh_equals_unsharded(root):
    imgs, kept = X.load_images(X.list_image_dataset(str(root))[0], 64)
    assert kept == [0, 1, 2, 3, 4, 5, 7, 8] and imgs.shape == (8, 64, 64, 3)
    one = X.FeatureExtractor("b0", resolution=64, device="cpu")
    two = X.FeatureExtractor("b0", resolution=64, mesh=make_mesh(data=2, devices=["cpu", "cpu"]))
    np.testing.assert_array_equal(two.extract(imgs[:7], batch_size=5), one.extract(imgs[:7], batch_size=5))


def test_jpeg_without_pil_raises(root, tmp_path, monkeypatch):
    Image.fromarray(np.zeros((8, 8, 3), np.uint8)).save(tmp_path / "x.jpg")
    monkeypatch.setitem(sys.modules, "PIL", None)
    with pytest.raises(ValueError, match="x.jpg.*without PIL"):
        X.load_images([str(root / "a" / "rgb.png"), str(tmp_path / "x.jpg")], 32)
    assert X.load_images([str(root / "c" / "broken.png"), str(root / "a" / "rgb.png")], 32)[1] == [1]
