"""The zoo and the bind engine against JAX at 32 px (Inceptions 75): fp32
forward, taps, segments 1e-4 of max |JAX|; folded bf16 0.02; fold trees 1e-6;
'caffe' equal, its resize 1e-5 (x 127.5); rows but at picks within 2^-8;
bind engines >= 90 % of predictions, >= 80 % of levels."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import fast_image_recognition_tpu.models as J
from fast_image_recognition_tpu.cascade.engine import SequentialInferencePipeline as JaxPipeline
from fast_image_recognition_tpu.models import efficientnet as jeff
from fast_image_recognition_tpu.models.fold import fold_tf_preprocess_into_valid_stem as jax_pp_fold
from fast_image_recognition_tpu.models.fold import fold_variables as jax_fold
from fast_image_recognition_tpu.models.fold import make_serving_fn as jax_serving_fn
from fast_image_recognition_tpu.models.resnet import resnet_plan as jax_resnet_plan
from fast_image_recognition_tpu_torch.cascade.engine import SequentialInferencePipeline
from fast_image_recognition_tpu_torch.models import backbone_info, build_backbone, create_backbone, resnet_plan
from fast_image_recognition_tpu_torch.models import efficientnet as peff
from fast_image_recognition_tpu_torch.models.fold import (fold_tf_preprocess_into_valid_stem, fold_variables,
    make_serving_fn)
from fast_image_recognition_tpu_torch.serving import build_service
from test_torch_inception_resnet import _leaves, check_planted_rows
from test_torch_mobilenet import _close, check_segments
from test_torch_synthetic import _one_thread  # noqa: F401

FAMILIES = ("resnet50", "resnet50v2", "inception_v3", "vgg19")
NAMES = FAMILIES + ("resnet101v2", "resnet152v2")
B = 8
_CACHE = {}


def _res(name):
    return 75 if name.startswith("inception") else 32


def _vars(name):
    """The seed-0 tree with BN and every bias drawn off flax's defaults."""
    if name not in _CACHE:
        _, v = create_backbone(name, seed=0, resolution=_res(name), device="cpu")
        rng = np.random.default_rng(1)
        u = lambda lo, hi, a: rng.uniform(lo, hi, a.shape).astype(np.float32)  # noqa: E731

        def perturb(p, s):
            for k, c in s.items():
                if "var" not in c:
                    perturb(p[k], c)
                    continue
                c["mean"], c["var"] = u(-0.05, 0.05, c["mean"]), u(0.5, 2, c["var"])
                p[k]["scale"], p[k]["bias"] = u(0.5, 1.5, c["var"]), u(-0.05, 0.1, c["var"])

        def biases(p):
            for c in p.values():
                if "kernel" in c and "bias" in c:
                    c["bias"] = u(-0.05, 0.05, c["bias"])
                elif "kernel" not in c and "scale" not in c:
                    biases(c)

        biases(v["params"])
        if "batch_stats" in v:
            perturb(v["params"], v["batch_stats"])
        _CACHE[name] = v
    return _CACHE[name]


def _served(name):
    """(uint8 images, JAX's folded serving output, the port's folded module, its output)."""
    key = ("served", name)
    if key not in _CACHE:
        v, res, taps = _vars(name), _res(name), tuple(J.default_taps_for(name))
        images = np.random.default_rng(0).integers(0, 256, (B, res, res, 3)).astype(np.uint8)
        fn, params = jax_serving_fn(J.build_backbone(name), v, J.backbone_info(name), resolution=res, taps=taps)
        want = jax.jit(fn)(params, images.astype(np.float32))
        serve = make_serving_fn(v, backbone_info(name), resolution=res, taps=taps, device="cpu")
        with torch.no_grad():
            got = serve(torch.from_numpy(images))
        _CACHE[key] = images, want, serve, got
    return _CACHE[key]


@pytest.mark.parametrize("name", NAMES)
def test_zoo_facts_and_trees_match_jax(name):
    """``backbone_info``, ``build_backbone`` and ``create_backbone``'s tree as JAX's, flax's law, the seed decides."""
    got = backbone_info(name)
    assert got.pop("variant") == name and got == J.backbone_info(name)
    assert type(build_backbone(name)).__name__ == type(J.build_backbone(name)).__name__
    res, jm = _res(name), J.build_backbone(name, 5, dtype=jnp.float32)
    want = jax.eval_shape(lambda: jm.init({"params": jax.random.PRNGKey(0)}, jnp.zeros((1, res, res, 3))))
    _, tree = create_backbone(name, 5, seed=1, resolution=res, device="cpu")
    paths = lambda t: [(p, tuple(a.shape)) for p, a in _leaves(t)]  # noqa: E731
    assert paths(tree) == paths({k: dict(want[k]) for k in want})
    w = next(a for p, a in _leaves(tree["params"]) if p[-1] == "kernel" and a.ndim == 4)
    assert abs(w.std() * np.sqrt(w[..., 0].size) - 1) < 0.2 and not tree["params"]["fc"]["bias"].any()
    assert all(not a.any() for p, a in _leaves(tree["params"]) if p[-1] == "bias")
    assert all((a == 1).all() for p, a in _leaves(tree.get("batch_stats", {})) if p[-1] == "var")
    if name == "vgg19":
        assert set(tree) == {"params"}


@pytest.mark.parametrize("name", FAMILIES)
def test_fp32_forward_taps_and_segments_match_jax(name):
    v, res, taps = _vars(name), _res(name), tuple(J.default_taps_for(name))
    jm, net = J.build_backbone(name, dtype=jnp.float32), build_backbone(name, dtype=torch.float32).load_variables(v)
    assert net.block_names() == jm.block_names() and net.plan_configs() == jm.plan_configs()
    x = np.random.default_rng(2).normal(size=(4, res, res, 3)).astype(np.float32)
    check_segments(jm, net, v, x, taps, len(net.block_names()) // 2)


@pytest.mark.parametrize("name", FAMILIES)
def test_folded_serving_matches_jax(name):
    _, want, _, got = _served(name)
    for t in J.default_taps_for(name):
        _close(got["taps"][t].numpy(), want["taps"][t], 0.02)
    _close(got["embedding"].numpy(), want["embedding"], 0.02)
    assert (np.asarray(want["embedding"]) != 0).mean() > 0.1


@pytest.mark.parametrize("name", FAMILIES)
def test_folded_matches_unfolded(name):
    """``folded=False``: BN kept, the preprocess explicit, fp32 weights cast at each call."""
    images, _, _, got = _served(name)
    unfolded = make_serving_fn(_vars(name), backbone_info(name), resolution=_res(name), device="cpu", folded=False)
    with torch.no_grad():
        eu = unfolded(torch.from_numpy(images))["embedding"].numpy()
    _close(got["embedding"].numpy(), eu, 0.02)


@pytest.mark.parametrize("name,tf_stem", [("resnet50", False), ("resnet50v2", False), ("inception_v3", False),
        ("inception_v3", True), ("vgg19", False)])
def test_fold_trees_match_jax(name, tf_stem):
    """ResNet at its eps (1.001e-5), v2's BNs with no conv affine-only, VGG19 (no BN) returned as it is."""
    v = _vars(name)
    want = jax_fold(J.build_backbone(name), v)
    got = fold_variables(type(build_backbone(name)).__name__, v)
    if tf_stem:
        want, got = jax_pp_fold(want), fold_tf_preprocess_into_valid_stem(got)
    if name == "vgg19":
        assert got is v and want is v
    pairs = list(zip(_leaves(jax.device_get(want)), _leaves(got)))
    assert len(pairs) == len(list(_leaves(v))) and all(a[0] == b[0] for a, b in pairs)
    for (path, a), (_, b) in pairs:
        a = np.asarray(a)
        assert b.dtype == np.float32 and np.abs(b - a).max() <= 1e-6 * max(np.abs(a).max(), 1e-30), path


@pytest.mark.parametrize("size,res", [(32, 32), (64, 32), (24, 37)])
def test_caffe_preprocess_matches_jax(size, res):
    assert peff.CAFFE_MEAN_BGR == jeff.CAFFE_MEAN_BGR
    x = np.random.default_rng(4).integers(0, 256, (2, size, size, 3)).astype(np.uint8)
    want = np.asarray(jeff.preprocess_images_caffe(jnp.asarray(x), res))
    got = peff.preprocess_images_caffe(torch.from_numpy(x), res).numpy()
    assert got.shape == want.shape == (2, res, res, 3)
    if size == res:
        np.testing.assert_array_equal(got, want)
    else:
        np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-5 * 127.5)


@pytest.mark.parametrize("variant", ["resnet50", "resnet50v2", "resnet101v2", "resnet152v2"])
def test_resnet_plan_and_taps_match_jax(variant):
    plan = resnet_plan(variant)
    assert plan == jax_resnet_plan(variant) and J.default_taps_for(variant) == backbone_info(variant)["taps"]
    strided = [c["name"] for c in plan if c["stride"] == 2]
    if variant.endswith("v2"):
        assert all(int(n.split("block")[1]) > 1 for n in strided) and len(strided) == 3
    else:
        assert strided == ["conv3_block1", "conv4_block1", "conv5_block1"]


def test_unknown_names_raise():
    for fn in (backbone_info, build_backbone, create_backbone, J.backbone_info, J.build_backbone):
        with pytest.raises(ValueError):
            fn("resnet18")
    with pytest.raises(ValueError):
        make_serving_fn(_vars("vgg19"), {"family": "alexnet", "resolution": 32}, device="cpu")


def test_service_rows_match_jax():
    """ResNet50V2's packed service from ``build_service`` over the same tree."""
    name = "resnet50v2"
    images, want, _, got = _served(name)
    check_planted_rows(got["embedding"].numpy(), want["embedding"], images, J.backbone_info(name), lambda g,
            **kw: build_service(name, g, variables=_vars(name), device="cpu", **kw), resolution=_res(name))


@pytest.mark.parametrize("name", ["resnet50v2", "inception_resnet_v2"])
def test_bind_engine_matches_jax(name):
    """The fp32 modules in ``bind`` mode, thresholds calibrated by the port on 16 images."""
    v, res, taps = _vars(name), _res(name), J.default_taps_for(name)
    net = build_backbone(name, dtype=torch.float32)
    with torch.no_grad():
        probe = net.load_variables(v)(torch.zeros((1, res, res, 3)), taps=taps)
    dims = [probe["taps"][t].shape[1] for t in taps] + [probe["embedding"].shape[1]]
    rng = np.random.default_rng(5)
    coefs = [rng.normal(0, 0.1, (7, d)).astype(np.float32) for d in dims]
    heads = (taps, coefs, [np.zeros(7, np.float32) for _ in dims])
    x = rng.normal(size=(16, res, res, 3)).astype(np.float32)
    port = SequentialInferencePipeline(net, v, *heads, buckets=(16,), device="cpu")
    th = port.calibrate(x)
    jax_pipe = JaxPipeline(J.build_backbone(name, dtype=jnp.float32), v, *heads, thresholds=th, buckets=(16,))
    got, want = port.predict(x), jax_pipe.predict(x)
    assert (got.predictions == want.predictions).mean() >= 0.9 and (got.exit_level == want.exit_level).mean() >= 0.8
    assert 0 < (want.exit_level == 0).mean() < 1
