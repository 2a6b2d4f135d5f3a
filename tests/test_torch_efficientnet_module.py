"""The trainable EfficientNet against JAX's (B0, 32 px): weights carried both
ways bit-equal; fp32 taps and embedding 1e-4 of max |JAX|; bf16 2^-5 and
cosine >= 0.999 an image (flax rounds the conv output, torch once)."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from fast_image_recognition_tpu.models.efficientnet import EfficientNet as JaxEfficientNet
from fast_image_recognition_tpu_torch.models import EfficientNet, create_efficientnet, default_taps
from fast_image_recognition_tpu_torch.models.inference import make_infer_fn
from test_torch_synthetic import _one_thread, jax_b0  # noqa: F401

RES = 32
TAPS = default_taps("b0")


@pytest.fixture(scope="module")
def b0():
    model, variables, np_vars = jax_b0(RES)
    images = np.random.default_rng(0).normal(size=(6, RES, RES, 3)).astype(np.float32)
    return _jit_apply(model), variables, np_vars, images


def _jit_apply(model):
    """``model.apply(v, x, taps=TAPS)`` jitted (eager flax is slow)."""
    return jax.jit(lambda v, x: model.apply(v, x, taps=TAPS))


def _shapes(tree):
    return jax.tree_util.tree_map(lambda a: tuple(np.shape(a)), tree)


def _close(got, want, tol):
    assert np.abs(got - want).max() <= tol * np.abs(want).max()


def _check_out(po, jo, tol, cos=None):
    for name in TAPS:
        _close(po["taps"][name].numpy(), np.asarray(jo["taps"][name]), tol)
    pe, je = po["embedding"].numpy(), np.asarray(jo["embedding"])
    _close(pe, je, tol)
    if cos is not None:
        c = (pe * je).sum(1) / (np.linalg.norm(pe, axis=1) * np.linalg.norm(je, axis=1))
        assert (c >= cos).all(), c


def test_carried_module_matches_apply_bf16(b0):
    model, variables, np_vars, images = b0
    m = EfficientNet("b0").load_variables(np_vars).eval()
    with torch.no_grad():
        po = m(torch.from_numpy(images), taps=TAPS)
    _check_out(po, model(variables, jnp.asarray(images)), 2.0**-5, cos=0.999)
    # the segments chain to the same forward
    with torch.no_grad():
        h = m.stem(torch.from_numpy(images))
        h = m.run_blocks(h, 0, 7)
        h = m.run_blocks(h, 7)
        torch.testing.assert_close(m.head_pool(h), po["embedding"], rtol=0, atol=0)
    assert m.block_names() == [c["name"] for c in JaxEfficientNet(variant="b0").plan_configs()]
    # train mode normalizes by batch statistics and moves the running ones (test_torch_train.py: against flax)
    before = m.stem_bn.mean.clone()
    assert torch.isfinite(m(torch.from_numpy(images), train=True)["embedding"]).all()
    assert not torch.equal(m.stem_bn.mean, before)


def test_carried_module_matches_apply_fp32(b0):
    model, variables, np_vars, images = b0
    m = EfficientNet("b0", dtype=torch.float32).load_variables(np_vars).eval()
    jm = _jit_apply(JaxEfficientNet(variant="b0", dtype=jnp.float32))
    with torch.no_grad():
        po = m(torch.from_numpy(images), taps=TAPS)
    _check_out(po, jm(variables, jnp.asarray(images)), 1e-4)


def test_variables_carry_both_ways(b0):
    _, _, np_vars, _ = b0
    out = EfficientNet("b0").load_variables(np_vars).export_variables()
    assert _shapes(out) == _shapes(np_vars)
    for a, b in zip(jax.tree_util.tree_leaves(out), jax.tree_util.tree_leaves(np_vars)):
        np.testing.assert_array_equal(a, b)


def test_own_init_has_the_flax_tree_and_defaults(b0):
    model, _, np_vars, images = b0
    m, v = create_efficientnet("b0", 0, seed=0, resolution=RES, device="cpu")
    assert _shapes(v) == _shapes(np_vars) and m.resolution == RES
    for name in ("stem_bn", "head_bn"):
        np.testing.assert_array_equal(v["params"][name]["scale"], 1.0)
        np.testing.assert_array_equal(v["params"][name]["bias"], 0.0)
        np.testing.assert_array_equal(v["batch_stats"][name]["mean"], 0.0)
        np.testing.assert_array_equal(v["batch_stats"][name]["var"], 1.0)
    np.testing.assert_array_equal(v["params"]["block1a"]["se"]["reduce"]["bias"], 0.0)
    # truncated lecun-normal: |w| <= 2 std, std ~ sqrt(1 / fan_in)
    for k, fan_in in ((v["params"]["head_conv"]["kernel"], 320), (v["params"]["stem_conv"]["kernel"], 27)):
        std = np.sqrt(1.0 / fan_in)
        assert np.abs(k).max() <= 2.0 * std / 0.87962566103423978 + 1e-6
        assert abs(k.std() / std - 1.0) < 0.1
    same = create_efficientnet("b0", 0, seed=0, resolution=RES, device="cpu")[1]
    other = create_efficientnet("b0", 0, seed=1, resolution=RES, device="cpu")[1]
    np.testing.assert_array_equal(same["params"]["block2a"]["expand_conv"]["kernel"],
            v["params"]["block2a"]["expand_conv"]["kernel"])
    assert not np.array_equal(other["params"]["block2a"]["expand_conv"]["kernel"],
            v["params"]["block2a"]["expand_conv"]["kernel"])
    # the flax module runs the port's init: the same forward
    with torch.no_grad():
        po = m(torch.from_numpy(images), taps=TAPS)
    _check_out(po, model(v, jnp.asarray(images)), 2.0**-5, cos=0.999)


def test_fold_backbone_folds_the_own_init(b0):
    """``fold_backbone`` folds the exported tree: the folded forward equals the module's."""
    _, _, _, images = b0
    m, v = create_efficientnet("b0", 0, seed=2, resolution=RES, device="cpu")
    net = make_infer_fn(v, "b0", resolution=RES, fold_preprocess=False, device="cpu")
    with torch.no_grad():
        want = m(torch.from_numpy(images))["embedding"].numpy()
        h = net.run_blocks(net.raw_stem(torch.from_numpy(images)))
        got = net.head(h).numpy()
    c = (got * want).sum(1) / (np.linalg.norm(got, axis=1) * np.linalg.norm(want, axis=1))
    assert (c >= 0.999).all(), c


def test_logits_and_pruned_widths_match_flax(b0):
    """A classifier head and pruned hidden widths: flax applies the port's tree and gives its forward."""
    _, _, _, images = b0
    over = {"block2a": 40, "block6b": 600}
    m = EfficientNet("b0", num_classes=7, dtype=torch.float32, hidden_overrides=over)
    m.init_weights(3)
    v = m.export_variables()
    assert v["params"]["fc"]["kernel"].shape == (1280, 7)
    assert v["params"]["block2a"]["expand_conv"]["kernel"].shape == (1, 1, 16, 40)
    jm = JaxEfficientNet(variant="b0", num_classes=7, dtype=jnp.float32, hidden_overrides=over)
    jo = jax.jit(lambda v, x: jm.apply(v, x, taps=TAPS))(v, jnp.asarray(images))
    with torch.no_grad():
        po = m.eval()(torch.from_numpy(images), taps=TAPS)
    _check_out(po, jo, 1e-4)
    _close(po["logits"].numpy(), np.asarray(jo["logits"]), 1e-4)
