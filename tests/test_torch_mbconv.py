"""The fused MBConv block (``plain.mbconv_plain``) and serving path against JAX's
interpret mode, random-init B0@64. JAX's tolerances
(tests/test_mbconv_kernel.py): a block 0.03 of its largest magnitude, the fused
embedding 0.05; against the per-op block in fp32 1e-4; the service: same top-1."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from fast_image_recognition_tpu.models import backbone_info as jax_info
from fast_image_recognition_tpu.models import inference as jinf
from fast_image_recognition_tpu.ops import mbconv_kernel as jmb
from fast_image_recognition_tpu.serving import RecognitionService as JaxService
from fast_image_recognition_tpu_torch.kernels import plain
from fast_image_recognition_tpu_torch.models import inference as pinf
from fast_image_recognition_tpu_torch.models.efficientnet import VARIANTS, backbone_info, block_plan
from fast_image_recognition_tpu_torch.ops import mbconv_kernel as pmb
from fast_image_recognition_tpu_torch.serving import RecognitionService, build_service
from test_torch_synthetic import _one_thread, jax_b0  # noqa: F401

RES = 64


@pytest.fixture(scope="module")
def b0():
    model, variables, np_vars = jax_b0(RES, dtype=jnp.float32)
    jfolded, configs = jinf.fold_backbone(model, variables, dtype=jnp.bfloat16)
    pfolded, pconfigs = pinf.fold_backbone(np_vars, "b0", dtype=torch.bfloat16)
    assert [c["name"] for c in configs] == [c["name"] for c in pconfigs]
    return model, variables, np_vars, jfolded, pfolded, configs


def _nchw(x: np.ndarray) -> torch.Tensor:
    """NHWC numpy -> the port's NCHW view of channels_last memory."""
    return torch.from_numpy(x).permute(0, 3, 1, 2)


def _rel_err(got: np.ndarray, want: np.ndarray) -> float:
    return float(np.abs(got - want).max() / (np.abs(want).max() + 1e-9))


def _both(jp, pp, cfg, x):
    """JAX's and the port's block on one bf16 input: (port, jax) fp32 NHWC."""
    want = np.asarray(jmb.fused_mbconv(jnp.asarray(x, jnp.bfloat16), jp, cfg), np.float32)
    got = pmb.fused_mbconv(_nchw(x), pp, cfg)
    assert got.dtype == torch.bfloat16 and got.is_contiguous(memory_format=torch.channels_last)
    return got.permute(0, 2, 3, 1).to(torch.float32).numpy(), want


def _input(pp, cfg, hw, seed, b=2):
    cin = pp["w_exp"].shape[2] if cfg["has_expand"] else pp["w_dw"].shape[-1]
    x = np.random.default_rng(seed).normal(size=(b, hw, hw, cin)).astype(np.float32)
    return np.asarray(jnp.asarray(x, jnp.bfloat16), np.float32)  # bf16 values on both sides


# stride-1 blocks: no expand (0), k3 (2), k5 (4), k5 without residual (8),
# the widest hidden (12), k3 without residual (15); hw 15 is an odd plane
@pytest.mark.parametrize("block_index,hw", [(0, 16), (2, 14), (4, 15), (8, 7), (12, 7), (15, 14)])
def test_block_matches_jax_fused(b0, block_index, hw):
    *_, jfolded, pfolded, configs = b0
    cfg = configs[block_index]
    assert cfg["stride"] == 1
    x = _input(jfolded["blocks"][block_index], cfg, hw, block_index)
    got, want = _both(jfolded["blocks"][block_index], pfolded["blocks"][block_index], cfg, x)
    assert got.shape == want.shape
    assert _rel_err(got, want) < 0.03


def test_border_columns_read_true_zeros(b0):
    """An expand bias of 50 N(0, 1) (a random init folds to 0) makes act(b_exp)
    leaking into the SAME border taps dominate the edges."""
    *_, jfolded, pfolded, configs = b0
    cfg = configs[2]  # k3, expand, SE, residual
    jp, pp = dict(jfolded["blocks"][2]), dict(pfolded["blocks"][2])
    bias = 50.0 * np.random.default_rng(11).normal(size=tuple(pp["b_exp"].shape)).astype(np.float32)
    jp["b_exp"] = jnp.asarray(bias, jp["b_exp"].dtype)
    pp["b_exp"] = torch.from_numpy(bias).to(pp["b_exp"].dtype)
    x = _input(jp, cfg, 14, 7)
    got, want = _both(jp, pp, cfg, x)
    for edge in (0, 1, -2, -1):
        assert _rel_err(got[:, :, edge], want[:, :, edge]) < 0.03, f"column {edge} leaks"
        assert _rel_err(got[:, edge], want[:, edge]) < 0.03, f"row {edge} leaks"


def test_relu6_block_matches_jax_fused(b0):
    *_, jfolded, pfolded, configs = b0
    cfg = dict(configs[4], activation="relu6")
    x = _input(jfolded["blocks"][4], cfg, 9, 4)
    got, want = _both(jfolded["blocks"][4], pfolded["blocks"][4], cfg, x)
    assert _rel_err(got, want) < 0.03


def test_stride2_raises(b0):
    *_, pfolded, configs = b0
    assert configs[1]["stride"] == 2
    x = torch.zeros((2, 16, 16, 16), dtype=torch.bfloat16).permute(0, 3, 1, 2)
    with pytest.raises(NotImplementedError):
        pmb.fused_mbconv(x, pfolded["blocks"][1], configs[1])


@pytest.mark.parametrize("block_index", [0, 4, 15])
def test_plain_matches_per_op_block_fp32(b0, block_index):
    """mbconv_plain against the per-op ``_FoldedBlock`` in fp32 (torch only)."""
    *_, np_vars, _, _, configs = b0
    folded, _ = pinf.fold_backbone(np_vars, "b0", dtype=torch.float32)
    p, cfg = folded["blocks"][block_index], configs[block_index]
    cin = p["w_exp"].shape[2] if cfg["has_expand"] else p["w_dw"].shape[-1]
    x = _nchw(np.random.default_rng(block_index).normal(size=(2, 11, 11, cin)).astype(np.float32))
    with torch.no_grad():
        want = pinf._FoldedBlock(p, cfg)(x).numpy()
    k = cfg["kernel"]
    pads = ((k - 1) // 2, k // 2)
    got = plain.mbconv_plain(x, pmb.prepare_params(p, cfg, torch.float32), k, (pads, pads), "swish",
            cfg["residual"]).numpy()
    np.testing.assert_allclose(got, want, rtol=1e-4, atol=1e-4 * np.abs(want).max())


def test_same_pads_and_tile_plan_cover_b0_224():
    """XLA SAME pads and a plan within shared memory for every stride-1 block of B0-B7 and odd planes; B0's
    14x14 planes one tile, its blocks one output group."""
    for h, k in [(7, 5), (14, 3), (15, 5), (112, 3)]:
        assert pmb._same_pads(h, k, 1) == jmb._same_pads(h, k, 1) == (h, (k - 1) // 2, k // 2)
    n_s1 = {}
    for variant in VARIANTS:
        hw = VARIANTS[variant].resolution // 2
        for c in block_plan(variant):
            hw = -(-hw // c["stride"])
            if c["stride"] != 1:
                continue
            n_s1[variant] = n_s1.get(variant, 0) + 1
            cin, has_expand = c["in_filters"], c["expand"] != 1
            ce, cout, s = cin * c["expand"], c["out_filters"], max(1, int(cin * c["se_ratio"]))
            for h in (hw, 15):
                th, tw, group, bufs, ipb = plan = pmb.plane_plan(h, h, c["kernel"], cin, ce, cout, s, has_expand)
                assert 1 <= th <= h and 1 <= tw <= h and group >= 1 and 0 <= bufs <= 3 and ipb in (1, 2)
                assert 0 < pmb.plane_smem(h, h, c["kernel"], cin, ce, cout, s, has_expand, *plan) <= pmb.MAX_SMEM
                if h == 7 or (variant == "b0" and h == 14):
                    assert (th, tw) == (h, h), (variant, c["name"], h)
                if variant == "b0" and h == hw:
                    assert group == -(-cout // 64), c["name"]  # B0 never splits its output channels
    assert n_s1["b0"] == 12


@pytest.fixture(scope="module")
def fused_pair(b0):
    """JAX's and the port's fused s2d module at 64 px, probe images."""
    model, variables, np_vars, *_ = b0
    jfn, jfolded = jinf.make_infer_fn(model, variables, resolution=RES, fused=True, space_to_depth=True)
    module = pinf.make_infer_fn(np_vars, "b0", resolution=RES, fused=True, space_to_depth=True, device="cpu")
    images = np.random.default_rng(3).integers(0, 256, (8, RES, RES, 3)).astype(np.uint8)
    return (jfn, jfolded), module, images


def test_fused_forward_matches_jax(fused_pair):
    (jfn, jfolded), module, images = fused_pair
    assert "stem_s2d_w" in jfolded and module.space_to_depth and len(module.fused_blocks) == 12
    want = np.asarray(jax.jit(jfn)(jfolded, jnp.asarray(images[:2]))["embedding"], np.float32)
    with torch.no_grad():
        got = module(torch.from_numpy(images[:2]))["embedding"].numpy()
    assert got.shape == want.shape == (2, 1280)
    assert _rel_err(got, want) < 0.05


def test_service_with_fused_serving_fn_matches_jax(fused_pair):
    """The service on the fused module and ``build_service`` against JAX's: the
    same top-1 over a near row (noise 0.05) and 20 farther (0.5) a probe."""
    (jfn, jfolded), module, images = fused_pair
    with torch.no_grad():
        emb = torch.nn.functional.normalize(module(torch.from_numpy(images))["embedding"], dim=1).numpy()
    rng = np.random.default_rng(5)
    near = emb + 0.05 * rng.standard_normal(emb.shape).astype(np.float32) / np.sqrt(emb.shape[1])
    far = np.repeat(emb, 20, axis=0) + 0.5 * rng.standard_normal((20 * len(emb), emb.shape[1])).astype(np.float32)
    gal = np.concatenate([near, far]).astype(np.float32)
    gal /= np.linalg.norm(gal, axis=1, keepdims=True)
    kw = dict(match="exact", resolution=RES)
    model, variables = None, None  # the JAX service folds nothing when given serving_fn
    js = JaxService(model, variables, jax_info("b0"), gal, serving_fn=(jfn, jfolded), **kw)
    ps = RecognitionService(None, backbone_info("b0"), gal, serving_fn=module, device="cpu", **kw)
    bs = build_service("b0", gal, variables=None, serving_fn=module, device="cpu", **kw)
    want = np.asarray(js.identify_device(jnp.asarray(images)))
    got = ps.identify_device(torch.from_numpy(images)).numpy()
    np.testing.assert_array_equal(got, want)
    np.testing.assert_array_equal(bs.identify_device(torch.from_numpy(images)).numpy(), want)
    np.testing.assert_array_equal(want, np.arange(len(images)))
