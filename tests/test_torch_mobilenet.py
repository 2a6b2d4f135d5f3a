"""MobileNetV2/V1 against JAX's at 64 px: fp32 forward, segments 1e-4 of max
|JAX|; fp32 folded and preprocess fold 2e-4; bf16 serving, cascade taps,
folded engine 0.02, bind engine 1e-4; fused 0.05 of per-op; service rows
and levels equal; engines >= 90 % of predictions, >= 80 % of levels."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import fast_image_recognition_tpu.models as J
import fast_image_recognition_tpu.models.mobilenet as jmb
from fast_image_recognition_tpu.cascade.engine import SequentialInferencePipeline as JaxPipeline
from fast_image_recognition_tpu.models.fold import make_serving_fn as jax_serving_fn
from fast_image_recognition_tpu.models.inference import make_infer_fn as jax_infer_fn
from fast_image_recognition_tpu.serving import CascadeRecognitionService as JaxCascade
from fast_image_recognition_tpu.serving import make_tap_embed_fn as jax_tap_embed_fn
from fast_image_recognition_tpu_torch.cascade.engine import SequentialInferencePipeline
from fast_image_recognition_tpu_torch.models import MobileNetV1, MobileNetV2, backbone_info, create_backbone
from fast_image_recognition_tpu_torch.models import mobilenet as pmb
from fast_image_recognition_tpu_torch.models.efficientnet import TF_MODE_MEAN, TF_MODE_STD
from fast_image_recognition_tpu_torch.models.fold import make_serving_fn
from fast_image_recognition_tpu_torch.models.inference import make_infer_fn
from fast_image_recognition_tpu_torch.serving import build_cascade_service, make_tap_embed_fn
from test_torch_synthetic import _one_thread  # noqa: F401

RES, B = 64, 4
NAMES = ("mobilenetv2", "mobilenetv2_1.4", "mobilenetv2_140", "mobilenetv2_0.35", "mobilenetv1")
TAPS = {"v2": tuple(jmb.default_taps_mobilenet()), "v1": tuple(jmb.default_taps_mobilenet_v1())}
ZOO = {"v2": "mobilenetv2", "v1": "mobilenetv1"}


def _images(n=B, seed=3):
    return np.random.default_rng(seed).integers(0, 256, (n, RES, RES, 3)).astype(np.uint8)


def _close(got, want, tol):
    got, want = np.asarray(got, np.float32), np.asarray(want, np.float32)
    assert got.shape == want.shape and np.abs(want).max() > 0
    assert np.abs(got - want).max() <= tol * np.abs(want).max()


def check_segments(jm, net, v, x, taps, mid):
    """The fp32 forward with its taps, and stem, blocks [0, mid), [mid, n) and head_pool, within 1e-4 of JAX's."""
    n = len(net.block_names())

    @jax.jit
    def ref(v, x):
        h = jm.apply(v, x, method=type(jm).stem)
        h1 = jm.apply(v, h, 0, mid, method=type(jm).run_blocks)
        h2 = jm.apply(v, h1, mid, n, method=type(jm).run_blocks)
        return jm.apply(v, x, taps=taps), [h, h1, h2, jm.apply(v, h2, method=type(jm).head_pool)]

    want, segs = ref(v, x)
    with torch.no_grad():
        out = net(torch.from_numpy(x), taps=taps)
        h = net.stem(torch.from_numpy(x))
        h1 = net.run_blocks(h, 0, mid)
        h2 = net.run_blocks(h1, mid, n)
        got = [t.permute(0, 2, 3, 1) for t in (h, h1, h2)] + [net.head_pool(h2)]
    assert sorted(out["taps"]) == sorted(taps)
    for g, w in zip([out["embedding"]] + [out["taps"][t] for t in taps] + got,
            [want["embedding"]] + [want["taps"][t] for t in taps] + segs):
        _close(g.numpy(), w, 1e-4)


def _perturb(v, seed):
    rng = np.random.default_rng(seed)
    u = lambda lo, hi, a: rng.uniform(lo, hi, np.shape(a)).astype(np.float32)  # noqa: E731

    def walk(p, s):
        for k, c in s.items():
            if "var" not in c:
                walk(p[k], c)
                continue
            c["mean"], c["var"] = u(-0.05, 0.05, c["mean"]), u(0.5, 2, c["var"])
            p[k]["scale"], p[k]["bias"] = u(0.5, 1.5, c["var"]), u(-0.05, 0.1, c["var"])

    walk(v["params"], v["batch_stats"])
    return v


@pytest.fixture(scope="module")
def v2():
    model, v = jmb.create_mobilenetv2(1.0, 0, seed=0, resolution=RES, dtype=jnp.float32)
    v = jax.tree_util.tree_map(np.array, {"params": v["params"], "batch_stats": v["batch_stats"]})
    return model, _perturb(v, 1)


@pytest.fixture(scope="module")
def v1():
    return jmb.MobileNetV1(dtype=jnp.float32), _perturb(create_backbone("mobilenetv1", seed=0, device="cpu")[1], 2)


@pytest.mark.parametrize("name", NAMES)
def test_zoo_facts_match_jax(name):
    got, w, plan = backbone_info(name), pmb.parse_mobilenet_width(name), "mobilenet_" + "v1_" * (name[-1] == "1")
    assert got.pop("variant") == name and got == J.backbone_info(name)
    assert got["taps"] == J.default_taps_for(name) and getattr(pmb, plan + "plan")(w) == getattr(jmb, plan + "plan")(w)


def test_zoo_names_as_jax():
    """``build_backbone`` takes any 'mobilenetv1*', ``backbone_info`` 'mobilenetv1'; unknown names raise."""
    from fast_image_recognition_tpu_torch.models import build_backbone

    assert isinstance(build_backbone("mobilenetv1_025"), MobileNetV1) and J.build_backbone("mobilenetv1_025")
    assert build_backbone("mobilenetv2_1.4").width == J.build_backbone("mobilenetv2_1.4").width == 1.4
    for info in (backbone_info, J.backbone_info):
        with pytest.raises(ValueError):
            info("mobilenetv1_025")
    with pytest.raises(ValueError):
        backbone_info("inception_v4")


@pytest.mark.parametrize("name,classes", [("mobilenetv2", 0), ("mobilenetv2_1.4", 5), ("mobilenetv1", 5)])
def test_variable_shapes_match_flax_init(name, classes):
    model = J.build_backbone(name, classes, dtype=jnp.float32)
    want = jax.eval_shape(lambda: model.init({"params": jax.random.PRNGKey(0)}, jnp.zeros((1, RES, RES, 3))))
    got = create_backbone(name, classes, seed=1, resolution=RES, device="cpu")[1]
    paths = lambda t: {jax.tree_util.keystr(p): tuple(x.shape)  # noqa: E731
            for p, x in jax.tree_util.tree_flatten_with_path(t)[0]}
    assert paths(got) == paths({k: want[k] for k in ("params", "batch_stats")})


@pytest.mark.parametrize("fam", ["v2", "v1"])
def test_fp32_forward_and_segments_match_jax(request, fam):
    jm, v = request.getfixturevalue(fam)
    net = (MobileNetV2 if fam == "v2" else MobileNetV1)(dtype=torch.float32).load_variables(v)
    check_segments(jm, net, v, np.random.default_rng(0).normal(size=(B, RES, RES, 3)).astype(np.float32), TAPS[fam], 8)


@pytest.mark.parametrize("fold_pp", [True, False])
def test_folded_forward_matches_jax(v2, fold_pp):
    jm, v = v2
    kw = dict(taps=TAPS["v2"], resolution=RES, fold_preprocess=fold_pp, mean=TF_MODE_MEAN, std=TF_MODE_STD)
    fn, folded = jax_infer_fn(jm, v, dtype=jnp.float32, **kw)
    images = _images()
    want = jax.jit(fn)(folded, images.astype(np.float32))
    with torch.no_grad():
        got = make_infer_fn(v, "mobilenetv2", dtype=torch.float32, device="cpu", **kw)(torch.from_numpy(images))
    for k in ("embedding",) + TAPS["v2"]:
        g, w = (got[k], want[k]) if k == "embedding" else (got["taps"][k], want["taps"][k])
        np.testing.assert_allclose(g.numpy(), np.asarray(w), rtol=2e-4, atol=2e-4)


def test_fused_plain_path_matches_per_op(v2):
    """The 13 stride-1 blocks go to ``mbconv`` (relu6, no SE)."""
    kw = dict(resolution=RES, mean=TF_MODE_MEAN, std=TF_MODE_STD, device="cpu")
    per_op, fused = make_infer_fn(v2[1], "mobilenetv2", **kw), make_infer_fn(v2[1], "mobilenetv2", fused=True, **kw)
    plan = pmb.mobilenet_plan()
    assert [plan[int(i)]["name"] for i in fused.fused_blocks] == ["block1a", "block2b", "block3b", "block3c", "block4b",
            "block4c", "block4d", "block5a", "block5b", "block5c", "block6b", "block6c", "block7a"]
    assert all(b.cfg["activation"] == "relu6" and not b.cfg["has_se"] for b in fused.fused_blocks.values())
    with torch.no_grad():
        x = torch.from_numpy(_images(8))
        _close(fused(x)["embedding"].numpy(), per_op(x)["embedding"].numpy(), 0.05)


@pytest.mark.parametrize("fam,folded", [("v2", True), ("v2", False), ("v1", True), ("v1", False)])
def test_serving_fn_matches_jax(request, fam, folded):
    _, v = request.getfixturevalue(fam)
    name, taps, images = ZOO[fam], TAPS[fam], _images()
    fn, params = jax_serving_fn(J.build_backbone(name), v, J.backbone_info(name), resolution=RES, taps=taps,
            folded=folded)
    want = jax.jit(fn)(params, images.astype(np.float32))
    serve = make_serving_fn(v, backbone_info(name), resolution=RES, taps=taps, device="cpu", folded=folded)
    with torch.no_grad():
        got = serve(torch.from_numpy(images))
    for k in taps:
        _close(got["taps"][k].numpy(), want["taps"][k], 0.02)
    _close(got["embedding"].numpy(), want["embedding"], 0.02)


def test_cascade_matches_jax_with_its_swish_stem(v2):
    """JAX's cascade folds the torch-mode mean and runs swish at stem and head
    whatever the family; the port copies it (ROADMAP.md §3)."""
    _, v = v2
    info, jinfo, jm, images = backbone_info("mobilenetv2"), J.backbone_info("mobilenetv2"), jmb.MobileNetV2(), _images(8)
    jf, je = jax_tap_embed_fn(jm, v, RES, ["block3a", "block4a"])(images)
    pf, pe = make_tap_embed_fn(v, info, RES, ["block3a", "block4a"], device="cpu")(torch.from_numpy(images))
    for g, w in zip(pf + [pe], list(jf) + [je]):
        _close(g.numpy(), w, 0.02)
    with torch.no_grad():
        served = make_serving_fn(v, info, RES, device="cpu")(torch.from_numpy(images))["embedding"]
    assert (served >= 0).all() and (pe < 0).any()  # relu6 at the served head, swish at the cascade's

    # 512 rows in the span of the probes' embeddings, their mean and 23 random directions (PCA-32 keeps
    # it), at the probes' spread; each probe's embedding planted at a row
    rng, e = np.random.default_rng(0), pe.numpy()
    span = np.linalg.qr(np.concatenate([e.mean(0)[:, None], e.T, rng.normal(size=(1280, 23))], 1))[0]
    gal = e.mean(0) + rng.normal(size=(512, 32)) @ span.T * np.sqrt(((e - e.mean(0)) ** 2).sum(1).mean() / 32)
    gal = (gal / np.linalg.norm(gal, axis=1, keepdims=True)).astype(np.float32)
    true_idx = rng.choice(512, 8, replace=False)
    gal[true_idx] = e
    kw = dict(resolution=RES, pca_dim=32, rescore=8, pca_sample=256, calib_total=64, calib_batch=32)
    js = JaxCascade(jm, v, jinfo, gal, **kw)
    ps = build_cascade_service("mobilenetv2", gal, variables=v, device="cpu", **kw)
    assert ps.taps == js.taps == ["block3a", "block4a"] and ps.segments == js.segments
    ji, _, jst = js.identify(images)
    pi, _, pst = ps.identify(images)
    np.testing.assert_array_equal(pi, ji)
    np.testing.assert_array_equal(pi, true_idx)
    assert pst == jst


@pytest.mark.parametrize("engine", ["bind", "folded"])
def test_engine_matches_jax(v2, engine):
    jm, v = v2
    taps = list(TAPS["v2"])
    dims = [c["out_filters"] for c in pmb.mobilenet_plan() if c["name"] in taps] + [1280]
    rng = np.random.default_rng(5)
    coefs = [rng.normal(0, 0.1, (7, d)).astype(np.float32) for d in dims]
    heads = (taps, coefs, [np.zeros(7, np.float32) for _ in dims])
    x = rng.normal(size=(16, RES, RES, 3)).astype(np.float32)
    port = SequentialInferencePipeline(MobileNetV2(dtype=torch.float32), v, *heads, buckets=(16,), engine=engine,
            device="cpu")
    th = port.calibrate(x)
    jax_pipe = JaxPipeline(jm, v, *heads, thresholds=th, buckets=(16,), engine=engine)
    for g, w in zip(port.level_embeddings(x), jax_pipe.level_embeddings(x)):
        _close(g, w, 1e-4 if engine == "bind" else 0.02)
    got, want = port.predict(x), jax_pipe.predict(x)
    assert (got.predictions == want.predictions).mean() >= 0.9 and (got.exit_level == want.exit_level).mean() >= 0.8
    for t, level in ((10.0, 4), (-100.0, 0)):  # JAX's own (tests/test_mobilenet.py:144-176)
        port.thresholds = [t] * 4
        assert (port.predict(x).exit_level == level).all()
