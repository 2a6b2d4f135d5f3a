"""Channel pruning against JAX's: L1 and random surgery bit-equal (B0@32 JAX's
init, MobileNetV2); the metrics in fp32 on 8 images, BN statistics of 64 other
images, 1e-4 of max |score| (APoZ one activation's share: |a| at 1e-3 may
land either side); the pruned trained B0's fp32 forward 1e-4, folded serving
0.02, its fused block at ce = 176 2^-6 of max |JAX|."""

from functools import partial
from types import SimpleNamespace

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from fast_image_recognition_tpu.models import backbone_info as jax_info
from fast_image_recognition_tpu.models import inference as jinf
from fast_image_recognition_tpu.models import pruning as J
from fast_image_recognition_tpu.models.fold import make_serving_fn as jax_serving_fn
from fast_image_recognition_tpu.models.mobilenet import MobileNetV2 as JaxMobileNetV2
from fast_image_recognition_tpu_torch.models import backbone_info, create_backbone
from fast_image_recognition_tpu_torch.models import inference as pinf
from fast_image_recognition_tpu_torch.models import pruning as P
from fast_image_recognition_tpu_torch.models.fold import make_serving_fn
from fast_image_recognition_tpu_torch.models.zoo import _BatchNorm, batch_stats
from fast_image_recognition_tpu_torch.scripts import run_prune_finetune
from fast_image_recognition_tpu_torch.utils.checkpoint import load_variables
from test_torch_efficientnet import CKPT
from test_torch_mbconv import _both, _input, _rel_err
from test_torch_synthetic import _one_thread, jax_b0  # noqa: F401

RES, B, C = 32, 8, 4
X = np.random.default_rng(0).normal(size=(B, RES, RES, 3)).astype(np.float32)
Y = np.arange(B) % C


def _leaves(tree):
    return {jax.tree_util.keystr(k): np.asarray(v) for k, v in jax.tree_util.tree_leaves_with_path(tree)}


def _calibrated(model):
    """The module's tree with each BN's running statistics those of 64 other images (8: the last BNs amplify
    rounding ~30x)."""
    bns = [m for m in model.modules() if isinstance(m, _BatchNorm)]
    for bn in bns:
        bn.momentum = 0.0
    with torch.no_grad(), batch_stats(model):
        model(torch.from_numpy(np.random.default_rng(7).normal(size=(64, RES, RES, 3)).astype(np.float32)))
    for bn in bns:
        bn.momentum = 0.99
    return model.export_variables()


@pytest.fixture(scope="module")
def b0():
    """JAX's fp32 B0@32, its init as numpy, and the port's fp32 module on the calibrated tree."""
    jm, _, v = jax_b0(RES, dtype=jnp.float32)
    pm = create_backbone("b0", resolution=RES, dtype=torch.float32, device="cpu")[0].load_variables(v)
    return jm, v, pm, _calibrated(pm)


class _Jitted:
    """JAX's module whose bound ``stem``, ``run_blocks`` and ``head_pool`` run jitted: eager flax compiles op by op
    (~10 s of JAX's leave_one_out at block 2). Its metrics run their own code on these."""

    def __init__(self, model):
        self.model, cls = model, type(model)
        self.fns = {n: jax.jit(lambda v, *a, f=getattr(cls, n): model.apply(v, *a, method=f), static_argnums=s)
                for n, s in (("stem", ()), ("run_blocks", (2, 3)), ("head_pool", ()))}

    def __getattr__(self, name):
        return getattr(self.model, name)

    def bind(self, v):
        b = self.model.bind(v)
        return SimpleNamespace(dtype=b.dtype, blocks=b.blocks, head_filters=b.head_filters,
                **{n: partial(f, v) for n, f in self.fns.items()})


@pytest.fixture(scope="module")
def jitted(b0):
    return _Jitted(b0[0])


@pytest.fixture(scope="module")
def pruned(b0):
    """Both sides' one round of L1 pruning of the trained B0@224 (fp32 modules)."""
    jm, _, pm, _ = b0
    v = {k: load_variables(CKPT)[k] for k in ("params", "batch_stats")}
    return J.prune_backbone(jm, v, 0.25, "l1"), P.prune_backbone(pm, v, 0.25, "l1")


def test_round_down_multiple():
    for n in (int(384 * 0.75), int(96 * 0.75), 7):
        assert P.round_down_multiple(n, 16) == J.round_down_multiple(n, 16)
    assert [P.round_down_multiple(n, 16) for n in (288, 72, 7)] == [288, 64, 16]


@pytest.mark.parametrize("family", ["b0", "mobilenetv2"])
@pytest.mark.parametrize("metric", ["l1", "random"])
def test_surgery_equals_jax(b0, family, metric):
    if family == "b0":
        jm, v, pm, _ = b0
    else:  # the port's init: surgery slices whatever tree it is given
        pm, v = create_backbone("mobilenetv2", resolution=RES, device="cpu")
        jm = JaxMobileNetV2()
    jm2, jv = J.prune_backbone(jm, v, 0.25, metric, seed=5)
    pm2, pv = P.prune_backbone(pm, v, 0.25, metric, seed=5)
    assert dict(jm2.hidden_overrides) == pm2.hidden_overrides and all(w % 16 == 0 for w in pm2.hidden_overrides.values())
    got, want = _leaves(pv), _leaves(jv)
    assert got.keys() == want.keys() and all(np.array_equal(got[k], want[k]) for k in want)
    assert P.parameter_count(pv) == J.parameter_count(jv) < P.parameter_count(v)
    assert _leaves(pm2.export_variables()).keys() == got.keys()
    if (family, metric) == ("b0", "l1"):
        assert (P.parameter_count(v), P.parameter_count(pv)) == (4_007_548, 3_092_892)


@pytest.mark.parametrize("fn,block", [("apoz_hidden_scores", 2), ("class_sep_hidden_scores", 2),
    ("taylor_importance", 2), ("taylor_importance", 14), ("leave_one_out_importance", 2)])
def test_metric_scores_match_jax(b0, jitted, monkeypatch, fn, block):
    jm, _, pm, cal = b0
    grad = jax.grad  # jitted: eager flax differentiates B0 in ~30 s
    monkeypatch.setattr(jax, "grad", lambda f, argnums: jax.jit(grad(f, argnums=argnums)))
    args = {"apoz_hidden_scores": (X, block), "class_sep_hidden_scores": (X, Y, block)}.get(fn, (X, Y, C, block))
    want = getattr(J, fn)(jm if fn == "taylor_importance" else jitted, cal, *args)
    got = getattr(P, fn)(pm, cal, *args)
    assert got.shape == want.shape and np.abs(want).max() > 0
    tol = 1.0 / (B * (RES // 4) ** 2) if fn.startswith("apoz") else 1e-4 * np.abs(want).max()
    assert np.abs(got - want).max() <= tol


def test_pruned_forward_matches_jax(pruned):
    (jm, jv), (pm, pv) = pruned
    want = jax.jit(lambda v, x: jm.apply(v, x)["embedding"])(jv, X)
    with torch.no_grad():
        assert _rel_err(pm(torch.from_numpy(X))["embedding"].numpy(), np.asarray(want)) <= 1e-4


def test_pruned_serving_and_fused_block_match_jax(pruned):
    (jm, jv), (_, pv) = pruned
    images = np.random.default_rng(1).integers(0, 256, (4, RES, RES, 3)).astype(np.uint8)
    fn, params = jax_serving_fn(jm, jv, jax_info("b0"), resolution=RES)
    want = np.asarray(jax.jit(fn)(params, images)["embedding"], np.float32)
    got = make_serving_fn(pv, backbone_info("b0"), resolution=RES, device="cpu")(torch.from_numpy(images))
    assert _rel_err(got["embedding"].float().numpy(), want) <= 0.02
    jfolded, configs = jinf.fold_backbone(jm, jv, dtype=jnp.bfloat16)
    pfolded = pinf.fold_backbone(pv, "b0", dtype=torch.bfloat16)[0]
    i = [c["name"] for c in configs].index("block3b")
    pp, cfg = pfolded["blocks"][i], configs[i]
    assert pp["w_dw"].shape[-1] == 176
    assert _rel_err(*_both(jfolded["blocks"][i], pp, cfg, _input(pp, cfg, 14, seed=3))) <= 2.0**-6


def test_unknown_metric_and_missing_images_raise(b0):
    _, v, pm, _ = b0
    with pytest.raises(ValueError, match="unknown metric"):
        P.prune_backbone(pm, v, 0.25, "bogus")
    with pytest.raises(ValueError, match="calibration images"):
        P.prune_backbone(pm, v, 0.25, "taylor")


def test_run_prune_finetune_main():
    lines = run_prune_finetune.main(["--synthetic", "2,10,32", "--metric", "apoz", "--device", "cpu"])
    assert [s.split(":")[0] for s in lines] == ["baseline", "pruned-apoz"]
    params = [float(s.split("params=")[1].split("M")[0]) for s in lines]
    assert params[1] < params[0] and all("val_acc=" in s and "latency=" in s for s in lines)
