"""InceptionResNetV2 against JAX's at 75 px (the trained checkpoint dies in
Block17 there, so serving runs a seeded init): fp32 segments 1e-4 of max
|JAX|; folded bf16 0.02 (tests/test_fold_generic.py:102-115); fold trees
1e-6; rows but at picks within 2^-8."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from fast_image_recognition_tpu.models import backbone_info as jax_info
from fast_image_recognition_tpu.models.fold import fold_tf_preprocess_into_valid_stem as jax_pp_fold
from fast_image_recognition_tpu.models.fold import fold_variables as jax_fold
from fast_image_recognition_tpu.models.fold import make_serving_fn as jax_serving_fn
from fast_image_recognition_tpu.models.inception_resnet import InceptionResNetV2 as JaxIRv2
from fast_image_recognition_tpu.serving import RecognitionService as JaxService
from fast_image_recognition_tpu_torch.models import backbone_info, create_backbone
from fast_image_recognition_tpu_torch.models.fold import (fold_tf_preprocess_into_valid_stem, fold_variables,
    make_serving_fn)
from fast_image_recognition_tpu_torch.models.inception_resnet import InceptionResNetV2
from fast_image_recognition_tpu_torch.serving import RecognitionService
from fast_image_recognition_tpu_torch.utils.checkpoint import load_variables
from test_torch_synthetic import _one_thread, _unit, planted_gallery  # noqa: F401

CKPT = "benchmarks/trained_inception_resnet_v2_224_synthetic1024_s0.npz"
NAME, RES, B, N = "inception_resnet_v2", 75, 8, 2048
SEGMENTS = ["stem", "mixed5b", "block35_1", "mixed6a", "block17_1", "mixed7a", "block8_1", "block8_10", "head"]
TAPS = ("block17_10", "block17_20", "block8_5")


def _leaves(tree, pre=()):
    for k, v in sorted(tree.items()):
        yield from _leaves(v, pre + (k,)) if isinstance(v, dict) else [(pre + (k,), v)]


@pytest.fixture(scope="module")
def setup():
    raw = load_variables(CKPT)
    v = {"params": raw["params"], "batch_stats": raw["batch_stats"]}
    x = np.random.default_rng(0).uniform(-1, 1, (B, RES, RES, 3)).astype(np.float32)
    net = InceptionResNetV2(dtype=torch.float32).load_variables(v)
    plan, m32 = net.block_names(), JaxIRv2(dtype=jnp.float32)

    def segments(v, x):  # chained: each block's input is the previous segment's output
        outs = [m32.apply(v, x, method=JaxIRv2.stem)]
        for name in SEGMENTS[1:-1]:
            i = plan.index(name)
            outs.append(m32.apply(v, outs[-1], i, i + 1, method=JaxIRv2.run_blocks))
        return outs + [m32.apply(v, outs[-1], method=JaxIRv2.head_pool)]

    segs = [np.array(o) for o in jax.jit(segments)(v, x)]
    trained = (v, x, net, segs)

    _, v = create_backbone(NAME, seed=0, device="cpu")
    rng = np.random.default_rng(1)
    u = lambda lo, hi, a: rng.uniform(lo, hi, a.shape).astype(np.float32)  # noqa: E731

    def perturb(p, s):
        for k, c in s.items():
            if "var" not in c:
                perturb(p[k], c)
                continue
            c["mean"], c["var"] = u(-0.02, 0.02, c["mean"]), c["var"] * u(0.5, 2, c["var"])
            p[k]["scale"], p[k]["bias"] = u(0.5, 1.5, c["var"]), u(-0.02, 0.02, c["var"])

    perturb(v["params"], v["batch_stats"])
    images = np.random.default_rng(0).integers(0, 256, (B, RES, RES, 3)).astype(np.uint8)
    fn, params = jax_serving_fn(JaxIRv2(), v, jax_info(NAME), resolution=RES, taps=TAPS)
    jax_out = jax.jit(fn)(params, images.astype(np.float32))
    serve = make_serving_fn(v, backbone_info(NAME), resolution=RES, taps=TAPS, device="cpu")
    with torch.no_grad():
        out = serve(torch.from_numpy(images))
    return dict(v=v, images=images, jax=(fn, params, jax_out), serve=serve, out=out, trained=trained)


@pytest.mark.parametrize("k", range(len(SEGMENTS)), ids=SEGMENTS)
def test_fp32_segments_match_jax(setup, k):
    _, x, net, segs = setup["trained"]
    with torch.no_grad():
        if k == 0:
            got = net.stem(torch.from_numpy(x))
        else:
            h = torch.from_numpy(segs[k - 1]).permute(0, 3, 1, 2).contiguous(memory_format=torch.channels_last)
            i = net.block_names().index(SEGMENTS[k]) if SEGMENTS[k] != "head" else None
            got = net.head_pool(h) if i is None else net.run_blocks(h, i, i + 1)
    got = got.numpy() if got.ndim == 2 else got.permute(0, 2, 3, 1).numpy()
    want = segs[k]
    assert got.shape == want.shape and np.abs(want).max() > 0
    assert np.abs(got - want).max() <= 1e-4 * np.abs(want).max()


@pytest.mark.parametrize("key", ("embedding",) + TAPS)
def test_folded_serving_matches_jax(setup, key):
    _, _, jax_out = setup["jax"]
    want = np.asarray(jax_out[key] if key == "embedding" else jax_out["taps"][key], np.float32)
    got = (setup["out"][key] if key == "embedding" else setup["out"]["taps"][key]).numpy()
    assert got.shape == want.shape and (want != 0).mean() > 0.1
    assert np.abs(got - want).max() <= 0.02 * np.abs(want).max()


def test_folded_matches_unfolded(setup):
    """``folded=False``: BN kept, the 'tf' preprocess explicit, fp32 weights cast to bf16 at each call."""
    unfolded = make_serving_fn(setup["v"], backbone_info(NAME), resolution=RES, device="cpu", folded=False)
    with torch.no_grad():
        eu = unfolded(torch.from_numpy(setup["images"]))["embedding"].numpy()
    ef = setup["out"]["embedding"].numpy()
    assert np.abs(ef - eu).max() <= 0.02 * np.abs(eu).max()


@pytest.mark.parametrize("tf_stem", [False, True])
def test_fold_trees_match_jax(setup, tf_stem):
    trained = setup["trained"][0]
    want = jax_fold(JaxIRv2(), trained)
    got = fold_variables("InceptionResNetV2", trained)
    if tf_stem:
        want, got = jax_pp_fold(want), fold_tf_preprocess_into_valid_stem(got)
    pairs = list(zip(_leaves(jax.device_get(want)), _leaves(got)))
    assert len(pairs) == 1100 and all(a[0] == b[0] for a, b in pairs)
    for (path, a), (_, b) in pairs:
        a = np.asarray(a)
        assert b.dtype == np.float32 and np.abs(b - a).max() <= 1e-6 * max(np.abs(a).max(), 1e-30), path


def check_planted_rows(emb, jax_emb, images, info, port_service, **kw):
    """PCA-124 packed service over 2,048 rows in a 96-d span (a planted row, 40 distractors a probe): JAX's
    (on ``jax_emb``) and ``port_service(gallery, **kw)`` pick the same rows but at near-ties, and the planted."""
    emb = _unit(emb)
    gal, planted = planted_gallery(emb, N, np.random.default_rng(1))
    kw.update(pca_dim=124, pca_scan="packed")
    js = JaxService(None, None, info, gal, serving_fn=(lambda e, _: {"embedding": e}, jax_emb), **kw)
    ji = np.asarray(js.identify_device(images))
    pi = port_service(gal, **kw).identify_device(torch.from_numpy(images)).numpy()
    dj, dp = ((emb - gal[ji]) ** 2).sum(1), ((emb - gal[pi]) ** 2).sum(1)
    assert ((ji == pi) | (np.abs(dj - dp) <= 2.0**-8 * dj)).all()
    np.testing.assert_array_equal(pi, planted)


def test_service_rows_match_jax(setup):
    _, _, jax_out = setup["jax"]
    check_planted_rows(setup["out"]["embedding"].numpy(), jax_out["embedding"], setup["images"], jax_info(NAME),
            lambda g, **kw: RecognitionService(None, backbone_info(NAME), g, serving_fn=setup["serve"],
            device="cpu", **kw), resolution=RES)


def test_create_backbone_has_jax_tree():
    """Seeded init: JAX's names and shapes, flax's default law, the seed decides."""
    model = JaxIRv2(num_classes=10)
    want = jax.eval_shape(lambda k: model.init({"params": k}, jnp.zeros((1, RES, RES, 3))), jax.random.PRNGKey(0))
    _, got = create_backbone(NAME, 10, seed=0, resolution=RES, device="cpu")
    assert [(p, a.shape) for p, a in _leaves(want)] == [(p, b.shape) for p, b in _leaves(got)]
    assert (got["batch_stats"]["conv_7b"]["bn"]["var"] == 1).all() and not got["params"]["block8_1"]["up"]["bias"].any()
    w = got["params"]["stem"]["conv1"]["conv"]["kernel"]
    assert abs(w.std() * np.sqrt(27) - 1) < 0.2 and np.abs(w).max() <= 2 / np.sqrt(27) / 0.8796 + 1e-6
    _, again = create_backbone(NAME, 10, seed=1, device="cpu")
    assert not np.array_equal(again["params"]["stem"]["conv1"]["conv"]["kernel"], w)
