"""``utils/flops.py``, ``utils/profiling.py`` and ``PCAModel`` against JAX's:
FLOPs equal on the known shapes and the fp32 B0 at 64 px, folded within 5 %;
``project`` bit-equal, ``project_device`` 1e-5 of max |project|."""

import time

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import torch.nn.functional as F

from fast_image_recognition_tpu.models.efficientnet import EfficientNet as JaxEfficientNet
from fast_image_recognition_tpu.ops.pca import PCAModel as JaxPCA
from fast_image_recognition_tpu.utils.flops import fn_flops as jax_flops
from fast_image_recognition_tpu_torch.models import backbone_info, create_efficientnet
from fast_image_recognition_tpu_torch.models.fold import make_serving_fn
from fast_image_recognition_tpu_torch.ops.pca import PCAModel, fit_pca
from fast_image_recognition_tpu_torch.utils.flops import fn_flops
from fast_image_recognition_tpu_torch.utils.profiling import Counters, Timer, device_trace, time_jitted, trace_call
from test_torch_synthetic import _one_thread  # noqa: F401


@pytest.mark.parametrize("shape,want", [((8, 64, 32, 0, 0), 2 * 8 * 64 * 32), ((2, 16, 8, 24, 1), 2 * (2 * 16 * 16 * 24)
        * (3 * 3 * 8)), ((1, 8, 16, 16, 16), 2 * (1 * 8 * 8 * 16) * (3 * 3 * 1))])
def test_fn_flops_matches_jax_on_known_shapes(shape, want):
    """A matmul, a SAME conv and a depthwise one (tests/test_flops.py)."""
    n, hw, cin, cout, groups = shape
    if not groups:
        a, b = np.ones((n, hw), np.float32), np.ones((hw, cin), np.float32)
        assert fn_flops(torch.matmul, torch.from_numpy(a), torch.from_numpy(b)) == jax_flops(jnp.matmul, a, b) == want
        return
    x, k = np.ones((n, hw, hw, cin), np.float32), np.ones((3, 3, cin // groups, cout), np.float32)
    assert jax_flops(lambda x, k: jax.lax.conv_general_dilated(x, k, (1, 1), "SAME", dimension_numbers=(
        "NHWC", "HWIO", "NHWC"), feature_group_count=groups), x, k) == want
    assert fn_flops(lambda x, k: F.conv2d(x, k, padding="same", groups=groups), torch.from_numpy(x).permute(0, 3, 1, 2),
            torch.from_numpy(k).permute(3, 2, 0, 1)) == want


def test_fn_flops_of_b0_matches_jax_and_folded_within_5_percent():
    model, v = create_efficientnet("b0", 0, seed=0, resolution=64, dtype=torch.float32, device="cpu")
    x = np.zeros((2, 64, 64, 3), np.float32)
    want = jax_flops(lambda v_, x_: JaxEfficientNet(variant="b0", dtype=jnp.float32).apply(v_, x_, train=False)[
        "embedding"], v, jnp.asarray(x))
    assert fn_flops(lambda x_: model(x_)["embedding"], torch.from_numpy(x)) == want
    assert 0.6e9 * 2 * (64 / 224) ** 2 < want < 0.9e9 * 2 * (64 / 224) ** 2  # ~0.78 GFLOPs an image at 224
    images = torch.zeros((2, 64, 64, 3), dtype=torch.uint8)
    folded, unfolded = (fn_flops(make_serving_fn(v, backbone_info("b0"), resolution=64, device="cpu", folded=f),
            images) for f in (True, False))
    assert abs(folded - unfolded) < 0.05 * unfolded


def test_counters_timer_and_time_jitted(tmp_path):
    c = Counters(gallery_size=200)
    c.add_checked(np.asarray([10, 30, 60]))
    assert (c.distance_calcs, c.probes) == (100, 3)
    np.testing.assert_allclose(c.avg_checked_percent, 100 * 100 / 600)  # ann.h:29-30
    assert Counters().avg_checked_percent == -1.0
    t = Timer()
    for _ in range(2):
        with t.span("work") as s:
            time.sleep(0.01)
            s.result = torch.ones(3)
    assert t.counts["work"] == 2 and t.totals["work"] >= 0.02 and "work" in t.report()
    a = torch.ones((256, 256))
    out = time_jitted(lambda x: x @ x + 1, a, iters=3)
    assert out["compile_s"] > 0 and out["steady_s"] > 0
    with device_trace(str(tmp_path / "trace")):
        a @ a
    assert (tmp_path / "trace" / "trace.json").exists()
    assert trace_call(lambda: a @ a) is None  # no device activity on the CPU


def test_pca_project_save_load_match_jax(tmp_path):
    rng = np.random.default_rng(0)
    x = rng.standard_normal((64, 40)).astype(np.float32)
    p = fit_pca(x[:48], 12)
    j = JaxPCA(p.mean, p.components, p.explained_variance)
    np.testing.assert_array_equal(p.project(x), j.project(x))
    want = p.project(x)
    assert np.abs(p.project_device(x, device="cpu").numpy() - want).max() <= 1e-5 * np.abs(want).max()
    p.save(str(tmp_path / "port"))
    j.save(str(tmp_path / "jax"))
    for back in (JaxPCA.load(str(tmp_path / "port.npz")), PCAModel.load(str(tmp_path / "jax.npz"))):
        for k in ("mean", "components", "explained_variance"):
            np.testing.assert_array_equal(getattr(back, k), getattr(p, k))
