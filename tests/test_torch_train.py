"""The trainer and train mode against JAX's (stochastic depth all-keep): one
jitted ``value_and_grad(trainer._loss)`` at fp32, batch 8 at 64 px (at 32 the
last BNs see 4 values a channel). Loss 1e-5; a gradient leaf within 1e-3 of
its norm or 1e-6 of the whole's (a BN bias into a BN has a true gradient of
0); statistics 1e-5; Adam on JAX's gradients = ``optax.adam`` 1e-6; phase 1
backbone bit-equal, heads 1e-6 (2 lr under a 1e-6 gradient: Adam's first step
turns on its rounding); ``calibrate_batch_stats`` 1e-3 (its solve scales
rounding by 100); bf16 loss 2e-2, gradient cosine >= 0.99. MobileNetV1 fp32
at 96 px: 1e-4 of max |JAX|."""

import types

import flax.linen as fnn
import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

import fast_image_recognition_tpu.models.train as jtrain
from fast_image_recognition_tpu.models.efficientnet import EfficientNet as JaxEfficientNet
from fast_image_recognition_tpu.models.mobilenet import MobileNetV1 as JaxMobileNetV1
from fast_image_recognition_tpu.utils.checkpoint import load_variables as jax_load
from fast_image_recognition_tpu_torch.models import create_backbone, create_efficientnet, default_taps
from fast_image_recognition_tpu_torch.models.efficientnet import MEAN_RGB, STDDEV_RGB, drop_path
from fast_image_recognition_tpu_torch.models.train import MultiExitTrainer, TrainConfig, class_weights
from fast_image_recognition_tpu_torch.models.zoo import _BatchNorm, batch_stats, keep_mask
from test_torch_synthetic import _one_thread  # noqa: F401

RES, B, M = 64, 8, 0.99
TAPS = tuple(default_taps("b0", "early"))
CFG = TrainConfig(num_classes=5, taps=TAPS, resolution=RES, batch_size=B)


def _trainer(variables, dtype=torch.float32, **kw):
    model = create_efficientnet("b0", 0, seed=0, resolution=32, dtype=dtype, device="cpu")[0]
    model.drop_masks = lambda i, b: torch.ones(b, dtype=torch.bool)
    return MultiExitTrainer(model, variables, kw.pop("cfg", CFG), device="cpu", **kw)


def _grads(trainer):
    """The module's gradients in flax layout."""
    ps = list(trainer.model.parameters())
    for p in ps:
        p.data, p.grad = p.grad, p.data
    out = trainer.model.export_variables()["params"]
    for p in ps:
        p.data, p.grad = p.grad, p.data
    return out


def _leaves(tree):
    return jax.tree_util.tree_leaves(jax.tree_util.tree_map(np.asarray, tree))


def _stats(got, want, tol):
    if "var" not in want:
        return all(_stats(got[k], want[k], tol) for k in want)
    scale = max(np.abs(want["mean"]).max(), np.sqrt(want["var"].max()))
    assert np.abs(got["mean"] - want["mean"]).max() <= tol * scale
    assert np.abs(got["var"] - want["var"]).max() <= tol * want["var"].max()
    return True


@pytest.fixture(scope="module")
def ref():
    """The port's init and heads, the batch, and JAX's loss, gradients and statistics."""
    _, variables = create_efficientnet("b0", 0, seed=0, resolution=32, dtype=torch.float32, device="cpu")
    heads = _trainer(variables).head_arrays()
    rng = np.random.default_rng(0)
    x = rng.normal(size=(B, RES, RES, 3)).astype(np.float32)
    y = np.array([0, 0, 0, 0, 3, 3, 1, 2])  # unbalanced: class weights 0.4, 1.6, 1.6, 0.8, 8
    cls_w = class_weights(y, CFG.num_classes)
    mp = pytest.MonkeyPatch()
    mp.setattr(jtrain, "init_heads", lambda *a: [{k: jnp.asarray(v) for k, v in h.items()} for h in heads])
    mp.setattr(jax.random, "bernoulli", lambda key, p, shape: jnp.ones(shape, bool))
    jt = jtrain.MultiExitTrainer(JaxEfficientNet(variant="b0", dtype=jnp.float32), variables, CFG)
    keys = {"stochastic_depth": jax.random.PRNGKey(0), "dropout": jax.random.PRNGKey(1)}
    (loss, new_bs), (g, gh) = jax.jit(jax.value_and_grad(jt._loss, argnums=(0, 1), has_aux=True))(jt.params, jt.heads,
     jt.batch_stats, jnp.asarray(x), jnp.asarray(y), jnp.asarray(cls_w), keys)
    mp.undo()
    return dict(variables=variables, heads=heads, x=x, y=y, cls_w=cls_w, loss=float(loss),
            new_bs=jax.device_get(new_bs), g=jax.device_get(g), gh=jax.device_get(gh))


def _port_loss(ref, dtype=torch.float32):
    t = _trainer(ref["variables"], dtype)
    loss = t._loss(torch.from_numpy(ref["x"]), torch.from_numpy(ref["y"]), torch.from_numpy(ref["cls_w"]))
    loss.backward()
    return t, float(loss.detach())


def test_loss_gradients_and_statistics_match_jax(ref):
    t, loss = _port_loss(ref)
    assert abs(loss - ref["loss"]) <= 1e-5 * abs(ref["loss"])
    got = _grads(t)
    assert jax.tree_util.tree_structure(got) == jax.tree_util.tree_structure(ref["g"])
    floor = 1e-6 * np.sqrt(sum((b**2).sum() for b in _leaves(ref["g"])))
    for a, b in zip(_leaves(got), _leaves(ref["g"])):
        assert np.abs(a - b).max() <= max(1e-3 * np.linalg.norm(b), floor)
    for h, jh in zip(t.heads, ref["gh"]):
        for k in ("w", "b"):
            assert np.abs(h[k].grad.numpy() - jh[k]).max() <= 1e-3 * np.linalg.norm(jh[k])
    _stats(t.variables["batch_stats"], ref["new_bs"], 1e-5)


def test_bf16_module_at_the_same_point(ref):
    t, loss = _port_loss(ref, torch.bfloat16)
    assert abs(loss - ref["loss"]) <= 2e-2 * abs(ref["loss"])
    a, b = np.concatenate([v.ravel() for v in _leaves(_grads(t))]), np.concatenate([v.ravel() for v in
            _leaves(ref["g"])])
    assert a @ b / (np.linalg.norm(a) * np.linalg.norm(b)) >= 0.99


def test_adam_on_jax_gradients_matches_optax(ref):
    params = [torch.tensor(v, requires_grad=True) for v in _leaves(ref["variables"]["params"])]
    for p, g in zip(params, _leaves(ref["g"])):
        p.grad = torch.tensor(g)
    torch.optim.Adam(params, lr=1e-3).step()
    tx = optax.adam(1e-3)  # jitted: eager optax over B0's leaves takes ~30 s
    want = jax.jit(lambda p, g: optax.apply_updates(p, tx.update(g, tx.init(p))[0]))(ref["variables"]["params"],
            ref["g"])
    for p, w in zip(params, _leaves(want)):
        assert np.abs(p.detach().numpy() - w).max() <= 1e-6


def test_phase1_step_freezes_the_backbone(ref):
    t = _trainer(ref["variables"])
    before = _leaves(t.variables["params"])
    opt = t._optimizer(False, CFG.phase1_lr)
    t._step(opt, torch.from_numpy(ref["x"]), torch.arange(B), torch.from_numpy(ref["y"]),
            torch.from_numpy(ref["cls_w"]))
    for a, b in zip(_leaves(t.variables["params"]), before):
        np.testing.assert_array_equal(a, b)
    tx = optax.adam(CFG.phase1_lr)
    heads = [{k: jnp.asarray(v) for k, v in h.items()} for h in ref["heads"]]
    want = optax.apply_updates(heads, tx.update(ref["gh"], tx.init(heads))[0])
    for a, b, g in zip(_leaves(t.head_arrays()), _leaves(want), _leaves(ref["gh"])):
        assert (np.abs(a - b) <= np.where(np.abs(g) < 1e-6, 2 * CFG.phase1_lr, 1e-6)).all()
    _stats(t.variables["batch_stats"], ref["new_bs"], 1e-5)


def test_calibrate_batch_stats_solves_jax_step(ref):
    t = _trainer(ref["variables"])
    t.calibrate_batch_stats(ref["x"])
    solved = jax.tree_util.tree_map(lambda new, old: (new - M * old) / (1.0 - M), ref["new_bs"],
            ref["variables"]["batch_stats"])
    _stats(t.variables["batch_stats"], solved, 1e-3)


def _moved(stats, rng):
    if "var" in stats:
        return {"mean": (stats["mean"] + rng.normal(0, 0.2, stats["mean"].shape)).astype(np.float32),
                "var": (stats["var"] * rng.uniform(0.5, 2.0, stats["var"].shape)).astype(np.float32)}
    return {k: _moved(v, rng) for k, v in stats.items()}


def test_evaluate_and_head_logits_match_jax(ref):
    """Eval mode on moved statistics behind the serving preprocess: ``evaluate`` = JAX's, every head's logits
    within 1e-4 of max |JAX| (flax's ``apply`` jitted under JAX's methods)."""
    rng = np.random.default_rng(4)
    v = {"params": ref["variables"]["params"], "batch_stats": _moved(ref["variables"]["batch_stats"], rng)}
    mean, std = np.asarray(MEAN_RGB, np.float32), np.asarray(STDDEV_RGB, np.float32)
    t = _trainer(v, preprocess=lambda x: (x - torch.from_numpy(mean)) / torch.from_numpy(std))
    x, y = rng.uniform(0, 255, (2 * B, RES, RES, 3)).astype(np.float32), rng.integers(0, 5, 2 * B)
    mp = pytest.MonkeyPatch()
    mp.setattr(jtrain, "init_heads", lambda *a: [{k: jnp.asarray(w) for k, w in h.items()} for h in t.head_arrays()])
    jt = jtrain.MultiExitTrainer(JaxEfficientNet(variant="b0", dtype=jnp.float32), v, CFG,
            preprocess=lambda x: (x - mean) / std)
    mp.undo()
    jt.model = types.SimpleNamespace(apply=jax.jit(jt.model.apply, static_argnames=("train", "taps")))
    assert t.evaluate(x, y) == jt.evaluate(x, y)
    for a, b in zip(t.head_logits(x), jt.head_logits(x)):
        assert np.abs(a - b).max() <= 1e-4 * np.abs(b).max()


def test_stochastic_depth_keep_share_and_scale():
    keep = 0.8
    mask = keep_mask(4096, keep, torch.Generator().manual_seed(0), "cpu")
    assert abs(mask.float().mean().item() - keep) <= 3 * np.sqrt(keep * (1 - keep) / 4096)
    h = torch.randn(4096, 3, 2, 2, dtype=torch.bfloat16)
    out = drop_path(h, mask, keep)
    assert torch.equal(out[mask], h[mask] / keep) and not out[~mask].any() and out.dtype == h.dtype


def test_batchnorm_train_mode_matches_flax():
    x = np.random.default_rng(1).normal(2.0, 3.0, size=(6, 5, 4, 3)).astype(np.float32)  # NHWC
    p = {"scale": np.linspace(0.5, 2.0, 3, dtype=np.float32), "bias": np.float32([0.1, -0.2, 0.3])}
    s = {"mean": np.float32([0.5, 1.0, -1.0]), "var": np.float32([2.0, 0.5, 1.0])}
    y, mut = fnn.BatchNorm(use_running_average=False, momentum=M, epsilon=1e-3).apply(
        {"params": p, "batch_stats": s}, x, mutable=["batch_stats"])
    bn = _BatchNorm(3)
    bn.load(p, s)
    with batch_stats(bn):
        got = bn(torch.from_numpy(x).permute(0, 3, 1, 2))
    np.testing.assert_allclose(got.permute(0, 2, 3, 1).detach().numpy(), y, rtol=1e-5, atol=1e-5)
    for k in ("mean", "var"):
        np.testing.assert_allclose(getattr(bn, k).numpy(), mut["batch_stats"][k], rtol=1e-6)


def test_mobilenet_v1_train_mode_matches_flax():
    m, v = create_backbone("mobilenetv1", resolution=96, dtype=torch.float32, device="cpu")
    x = np.random.default_rng(2).normal(size=(8, 96, 96, 3)).astype(np.float32)
    out, mut = jax.jit(lambda v, x: JaxMobileNetV1(dtype=jnp.float32).apply(
        v, x, train=True, taps=("conv_dw_5",), mutable=["batch_stats"]))(v, jnp.asarray(x))
    po = m(torch.from_numpy(x), train=True, taps=("conv_dw_5",))
    for a, b in ((po["embedding"], out["embedding"]), (po["taps"]["conv_dw_5"], out["taps"]["conv_dw_5"])):
        assert np.abs(a.detach().numpy() - np.asarray(b)).max() <= 1e-4 * np.abs(np.asarray(b)).max()
    _stats(m.export_variables()["batch_stats"], mut["batch_stats"], 1e-5)


def test_tiny_fit_history_and_checkpoint(tmp_path):
    cfg = TrainConfig(num_classes=4, taps=TAPS, resolution=32, batch_size=4, phase1_epochs=1, phase2_epochs=1)
    _, variables = create_efficientnet("b0", 0, seed=1, resolution=32, device="cpu")
    t = _trainer(variables, torch.bfloat16, cfg=cfg, checkpoint_path=str(tmp_path / "best.msgpack"),
            preprocess=lambda x: x / 127.5 - 1.0)
    gen = np.random.default_rng(3)
    imgs, labels = gen.integers(0, 256, (16, 32, 32, 3), dtype=np.uint8), np.arange(16) % 4
    hist = t.fit(torch.from_numpy(imgs), labels, imgs[:8], labels[:8], verbose=False)
    assert set(hist) == {"loss", "val_acc"} and len(hist["loss"]) == len(hist["val_acc"]) == 2
    assert np.isfinite(hist["loss"]).all() and t.ckpt.best == max(hist["val_acc"])
    saved = jax_load(str(tmp_path / "best.msgpack"))
    assert set(saved) == {"params", "batch_stats", "heads"} and set(saved["heads"]) == {"0", "1", "2", "3", "4", "5",
            "6"}
    assert jax.tree_util.tree_structure(saved["params"]) == jax.tree_util.tree_structure(t.variables["params"])
    assert [np.shape(a) for a in _leaves(saved["heads"])] == [np.shape(a) for a in _leaves(t.head_arrays())]
    assert len(t.head_logits(imgs[:2])) == len(TAPS) + 1


def test_remat_gives_the_same_gradients_and_statistics(ref):
    """``remat`` recomputes each block backward: gradients and statistics as without (rtol 1e-5, atol 1e-7)."""
    out = []
    for remat in (False, True):
        t = _trainer(ref["variables"])
        t.model.remat = remat
        t._loss(torch.from_numpy(ref["x"][:4]), torch.from_numpy(ref["y"][:4]), torch.from_numpy(ref["cls_w"])).backward()
        out.append((_leaves(_grads(t)), _leaves(t.variables["batch_stats"])))
    for a, b in zip(out[0][0] + out[0][1], out[1][0] + out[1][1]):
        np.testing.assert_allclose(a, b, rtol=1e-5, atol=1e-7)
