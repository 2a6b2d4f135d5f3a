"""``SequentialInferencePipeline`` against JAX's (random B0 at 32 px):
``predict_fused`` and ``predict_pooled`` = ``predict`` exactly, the kNN head =
``sequential_knn_cascade``; across packages (bf16) >= 90 % of predictions and
>= 80 % of levels, folded vs bind too (tests/test_cascade.py:253-265); level 0
= JAX's but where its two best scores lie within 2^-5 of max |score|."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from fast_image_recognition_tpu.cascade.engine import SequentialInferencePipeline as JaxPipeline
from fast_image_recognition_tpu.models.pruning import prune_efficientnet
from fast_image_recognition_tpu_torch.cascade.engine import SequentialInferencePipeline
from fast_image_recognition_tpu_torch.cascade.exits import sequential_knn_cascade
from fast_image_recognition_tpu_torch.models import EfficientNet, default_taps
from test_torch_synthetic import _one_thread, jax_b0  # noqa: F401

RES = 32
TAPS = default_taps("b0")
DIMS = [112, 112, 192, 192, 320, 1280]
TIE = 2.0**-5


@pytest.fixture(scope="module")
def b0():
    return jax_b0(RES)


def _jit_apply(model):
    return jax.jit(lambda v, x: model.apply(v, x, taps=TAPS))


def _heads(num_classes=5):
    rng = np.random.default_rng(0)
    coefs = [rng.normal(0, 0.1, (num_classes, d)).astype(np.float32) for d in DIMS]
    return coefs, [np.zeros(num_classes, np.float32) for _ in DIMS]


def _images(n, seed=0):
    return np.random.default_rng(seed).normal(size=(n, RES, RES, 3)).astype(np.float32)


def _make_pipe(b0, n=24, seed=0, thresholds=None, **kw):
    _, _, np_vars = b0
    coefs, intercepts = _heads()
    pipe = SequentialInferencePipeline(EfficientNet("b0"), np_vars, TAPS, coefs, intercepts,
        thresholds=thresholds or [0.0] * (len(DIMS) - 1), buckets=(8, 16, 32), device="cpu", **kw)
    return pipe, _images(n, seed)


def _level0_ties(scores):
    top2 = np.sort(scores, axis=1)[:, -2:]
    return top2[:, 1] - top2[:, 0] <= TIE * np.abs(scores).max(1)


def test_segment_pipeline_end_to_end(b0):
    model, variables, _ = b0
    pipe, images = _make_pipe(b0, n=12, thresholds=[-1e9] * 5)
    res = pipe.predict(images)
    assert res.break_counts[0] == 1.0
    pipe2, _ = _make_pipe(b0, n=12, thresholds=[1e9] * 5)
    assert pipe2.predict(images).break_counts[-1] == 1.0
    coefs, intercepts = _heads()
    # level 0 against the port's module and JAX's flax module, standalone
    with torch.no_grad():
        e0 = pipe._net(torch.from_numpy(images), taps=TAPS)["taps"][TAPS[0]].numpy()
    e0 = e0 / np.linalg.norm(e0, axis=1, keepdims=True)
    np.testing.assert_array_equal(res.predictions, (e0 @ coefs[0].T + intercepts[0]).argmax(1))
    j0 = np.asarray(_jit_apply(model)(variables, jnp.asarray(images))["taps"][TAPS[0]])
    j0 = j0 / np.linalg.norm(j0, axis=1, keepdims=True)
    js = j0 @ coefs[0].T + intercepts[0]
    assert ((res.predictions == js.argmax(1)) | _level0_ties(js)).all()


@pytest.fixture(scope="module")
def jax_predict(b0):
    """JAX's bind-engine ``predict`` at thresholds calibrated by the port's bind engine on the same 32 images."""
    model, variables, _ = b0
    pipe, images = _make_pipe(b0, n=32)
    thresholds = pipe.calibrate(images)
    coefs, intercepts = _heads()
    jpipe = JaxPipeline(model, variables, TAPS, coefs, intercepts, thresholds=thresholds, buckets=(32,))
    return thresholds, images, jpipe.predict(images), jpipe


@pytest.mark.parametrize("engine", ["bind", "folded"])
def test_predict_matches_jax(b0, jax_predict, engine):
    """JAX's bind engine is the reference for both port engines."""
    thresholds, images, want, _ = jax_predict
    pipe, _ = _make_pipe(b0, n=32, thresholds=thresholds, engine=engine)
    got = pipe.predict(images)
    assert (got.predictions == want.predictions).mean() >= 0.9
    assert (got.exit_level == want.exit_level).mean() >= 0.8
    assert 0 < want.break_counts[0] < 1


def test_fused_cascade_matches_host_compaction(b0):
    pipe, images = _make_pipe(b0)
    pipe.calibrate(images, quantile=0.5)
    want = pipe.predict(images)
    got = pipe.predict_fused(images, capacities=[len(images)] * pipe.num_levels)
    np.testing.assert_array_equal(got.predictions, want.predictions)
    np.testing.assert_array_equal(got.exit_level, want.exit_level)
    assert got.forced_fraction == 0.0
    assert 0 < want.break_counts[0] < 1


def test_fused_cascade_capacity_overflow_forces_exits(b0):
    pipe, images = _make_pipe(b0, thresholds=[1e9] * 5)
    got = pipe.predict_fused(images, capacities=[len(images)] + [1] * (pipe.num_levels - 1))
    assert got.forced_fraction > 0.5
    assert (got.exit_level == pipe.num_levels - 1).sum() == 1
    assert (got.exit_level == 0).sum() == len(images) - 1


def test_fused_cascade_calibrated_capacities(b0):
    pipe, images = _make_pipe(b0)
    pipe.calibrate(images, quantile=0.5)
    caps = pipe.capacities_for(len(images), slack=1.5, multiple=8)
    assert caps[0] == len(images)
    assert all(c2 <= c1 for c1, c2 in zip(caps, caps[1:]))
    got = pipe.predict_fused(images)
    assert np.isclose(got.break_counts.sum(), 1.0)
    assert got.forced_fraction <= 0.5


def test_pooled_cascade_matches_host_compaction(b0):
    pipe, images = _make_pipe(b0)
    pipe.calibrate(images, quantile=0.5)
    want = pipe.predict(images)
    for bucket in (8, 16, 64):
        got = pipe.predict_pooled(images, bucket=bucket)
        np.testing.assert_array_equal(got.predictions, want.predictions)
        np.testing.assert_array_equal(got.exit_level, want.exit_level)
        np.testing.assert_allclose(got.break_counts, want.break_counts)


def test_pooled_streams_match_one_stream_and_jax(b0, jax_predict):
    """``streams`` 2 and 3 (sub-pools of 10, 11 and 11) decide as one stream; JAX's two streams as the port's."""
    thresholds, images, _, jpipe = jax_predict
    pipe, _ = _make_pipe(b0, n=32, thresholds=thresholds)
    one = pipe.predict_pooled(images, bucket=8)
    for streams in (2, 3):
        got = pipe.predict_pooled(images, bucket=8, streams=streams)
        np.testing.assert_array_equal(got.predictions, one.predictions)
        np.testing.assert_array_equal(got.exit_level, one.exit_level)
    want = jpipe.predict_pooled(images, bucket=8, streams=2)
    assert (one.predictions == want.predictions).mean() >= 0.9
    assert (one.exit_level == want.exit_level).mean() >= 0.8


def test_level_scores_are_the_exit_heads_scores(b0):
    pipe, images = _make_pipe(b0)
    pipe.calibrate(images, quantile=0.5)
    scores = [s.numpy() for s in pipe.level_scores(images)]
    assert len(scores) == pipe.num_levels
    want = pipe.predict(images)
    for i, level in enumerate(want.exit_level):
        assert want.predictions[i] == scores[level][i].argmax()
        if level < pipe.num_levels - 1:
            assert scores[level][i].max() > pipe.thresholds[level]
        for earlier in range(level):
            assert scores[earlier][i].max() <= pipe.thresholds[earlier]
    assert len(pipe.level_scores(images, levels=1)) == 1


def test_fused_cache_keys_on_thresholds(b0):
    pipe, images = _make_pipe(b0)
    caps = [len(images)] * pipe.num_levels
    pipe.thresholds = [-1e9] * (pipe.num_levels - 1)
    assert (pipe.predict_fused(images, capacities=caps).exit_level == 0).all()
    pipe.thresholds = [1e9] * (pipe.num_levels - 1)
    assert (pipe.predict_fused(images, capacities=caps).exit_level == pipe.num_levels - 1).all()


def test_folded_engine_matches_bind_engine(b0):
    pipe_b, images = _make_pipe(b0, n=16)
    pipe_f, _ = _make_pipe(b0, n=16, engine="folded")
    pipe_b.calibrate(images)
    pipe_f.thresholds = list(pipe_b.thresholds)
    rb, rf = pipe_b.predict(images), pipe_f.predict(images)
    assert (rb.predictions == rf.predictions).mean() >= 0.9
    assert (rb.exit_level == rf.exit_level).mean() >= 0.8


def _make_knn_pipe(b0, n_gal=30, n_val=16, num_classes=6, **kw):
    _, _, np_vars = b0
    rng = np.random.default_rng(3)
    gal_images = rng.normal(size=(n_gal, RES, RES, 3)).astype(np.float32)
    val_images = rng.normal(size=(n_val, RES, RES, 3)).astype(np.float32)
    labels = rng.integers(0, num_classes, n_gal)
    model = EfficientNet("b0")
    tmp = SequentialInferencePipeline(model, np_vars, TAPS, head_mode="knn",
            galleries=[np.eye(2, dtype=np.float32)] * (len(TAPS) + 1),
            gallery_labels=np.zeros(2, np.int64), buckets=(8, 16, 32), device="cpu", **kw)
    gal_levels = tmp.level_embeddings(gal_images)
    pipe = SequentialInferencePipeline(model, None, TAPS, head_mode="knn", galleries=gal_levels,
            gallery_labels=labels, buckets=(8, 16, 32), device="cpu", **kw)
    return pipe, gal_levels, labels, gal_images, val_images


def test_knn_head_matches_sequential_knn_cascade(b0):
    pipe, gal_levels, labels, _, val_images = _make_knn_pipe(b0)
    val_levels = pipe.level_embeddings(val_images)
    want = sequential_knn_cascade(gal_levels, labels, val_levels, ratio=0.8, device="cpu")
    got = pipe.predict(val_images)
    np.testing.assert_array_equal(got.predictions, want.predictions)
    np.testing.assert_array_equal(got.exit_level, want.exit_level)
    assert 0.0 < got.break_counts[0] < 1.0 or got.break_counts[-1] > 0


def test_knn_fused_matches_host_compaction(b0):
    pipe, _, _, gal_images, val_images = _make_knn_pipe(b0)
    pipe.calibrate(gal_images)
    assert all(t == 0.0 for t in pipe.thresholds)
    want = pipe.predict(val_images)
    got = pipe.predict_fused(val_images, capacities=[len(val_images)] * pipe.num_levels)
    np.testing.assert_array_equal(got.predictions, want.predictions)
    np.testing.assert_array_equal(got.exit_level, want.exit_level)
    assert got.forced_fraction == 0.0
    per_level, cumulative = pipe.measure_segment_latency(val_images[:5], iters=1)
    assert per_level.shape == cumulative.shape == (pipe.num_levels,) and (per_level > 0).all()


def test_segment_pipeline_on_pruned_backbone(b0):
    """JAX's pruned widths and weights in the port's module; level 0 against the pruned flax module."""
    model, variables, _ = b0
    pruned_model, pruned_vars = prune_efficientnet(model, variables, 0.25, "l1")
    pruned_vars = jax.device_get(pruned_vars)
    np_vars = jax.tree_util.tree_map(np.asarray, {"params": pruned_vars["params"],
            "batch_stats": pruned_vars["batch_stats"]})
    images = _images(6, seed=1)
    rng = np.random.default_rng(0)
    coefs = [rng.normal(0, 0.1, (4, d)).astype(np.float32) for d in DIMS]
    intercepts = [np.zeros(4, np.float32) for _ in DIMS]
    pipe = SequentialInferencePipeline(EfficientNet("b0", hidden_overrides=pruned_model.hidden_overrides), np_vars,
            TAPS, coefs, intercepts, thresholds=[0.05] * 5, buckets=(8,), device="cpu")
    res = pipe.predict(images)
    assert res.predictions.shape == (6,) and np.isclose(res.break_counts.sum(), 1.0)
    full = _jit_apply(pruned_model)(pruned_vars, jnp.asarray(images))
    e0 = np.asarray(full["taps"][TAPS[0]])
    e0 = e0 / np.linalg.norm(e0, axis=1, keepdims=True)
    s0 = e0 @ coefs[0].T + intercepts[0]
    at0 = (res.exit_level == 0) & (s0.max(1) > 0.05)
    assert ((res.predictions == s0.argmax(1)) | _level0_ties(s0))[at0].all()
