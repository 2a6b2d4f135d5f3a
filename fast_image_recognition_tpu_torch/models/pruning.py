"""Channel pruning of the MBConv families (JAX ``models/pruning.py``): six
metrics on the module's device; surgery slices the kept hidden channels out of
a flax-layout numpy tree, block I/O and taps kept."""

import copy
from typing import Dict, Tuple

import numpy as np
import torch
import torch.nn.functional as F

from .efficientnet import EfficientNet, _same_pad
from .mobilenet import MobileNetV2


def round_down_multiple(n: int, m: int) -> int:
    """Down to a multiple of ``m``, never below ``m`` (keras_finetune_prune.py:531)."""
    return max(m, (n // m) * m)


def keep_top(scores, n: int) -> np.ndarray:
    """The ``n`` highest-scoring channels, ascending."""
    return np.sort(np.argsort(scores)[::-1][:n])


def l1_kernel_importance(variables, block_name: str) -> np.ndarray:
    """L1 norm of each hidden channel's expand kernel (depthwise without an expand)."""
    p = variables["params"][block_name]
    return np.abs(np.asarray(p.get("expand_conv", p["dw_conv"])["kernel"], np.float32)).sum(axis=(0, 1, 2))


def _load(model, variables, images):
    """``model`` holding ``variables`` (None: as it is) and the stem's output on ``images``."""
    m = model if variables is None else model.load_variables(variables)
    return m, m.stem(torch.as_tensor(images, dtype=torch.float32, device=next(m.parameters()).device))


@torch.no_grad()
def _block_hidden_activations(model, variables, images, block_index: int) -> torch.Tensor:
    """Post-depthwise hidden activations ``[B, F, H, W]`` of a block, re-run in fp32; swish in every family (JAX's)."""
    m, h = _load(model, variables, images)
    h = m.run_blocks(h, 0, block_index).float()
    blk, cfg = m.blocks[block_index], m.plan[block_index]
    if blk.has_expand:  # fp32 weights
        h = F.silu(blk.expand_bn(F.conv2d(h, blk.expand_conv.weight), torch.float32))
    h = F.conv2d(_same_pad(h, cfg["kernel"], cfg["stride"]), blk.dw_conv.weight, stride=cfg["stride"],
            groups=h.shape[1])
    return F.silu(blk.dw_bn(h, torch.float32))


def _probe_head(model, num_classes: int, seed: int):
    """A linear probe: ``w`` N(0, 0.01) from ``np.random.default_rng(seed)``, ``b`` 0."""
    w = np.random.default_rng(seed).normal(0, 0.01, (model.head_conv.weight.shape[0], num_classes))
    return w.astype(np.float32), np.zeros(num_classes, np.float32)


def _losses(emb, labels, head, copies: int = 1) -> torch.Tensor:
    """Mean cross-entropy of each of ``copies`` stacked batches, in fp64 (a score is a difference of two losses)."""
    w, b = (torch.as_tensor(np.asarray(a, np.float64), device=emb.device) for a in head)
    y = torch.as_tensor(np.asarray(labels), device=emb.device).long().repeat(copies)
    return F.cross_entropy(emb.double() @ w + b, y, reduction="none").view(copies, -1).mean(1)


def taylor_importance(model, variables, images, labels, num_classes: int, block_index: int, head=None,
        seed: int = 0) -> np.ndarray:
    """|d loss / d s| of a scale ``s`` on each output channel of the block under ``head`` (default
    :func:`_probe_head`)."""
    flags = [p.requires_grad for p in model.parameters()]
    model.requires_grad_(False)  # the graph from the scale on
    try:
        with torch.enable_grad():
            m, h = _load(model, variables, images)
            h = m.run_blocks(h, 0, block_index + 1)
            scale = torch.ones(h.shape[1], device=h.device, requires_grad=True)
            emb = m.head_pool(m.run_blocks(h * scale.to(h.dtype)[:, None, None], block_index + 1))
            loss = _losses(emb, labels, head if head is not None else _probe_head(m, num_classes, seed))[0]
            (g,) = torch.autograd.grad(loss, scale)
    finally:
        for p, f in zip(model.parameters(), flags):
            p.requires_grad_(f)
    return g.abs().cpu().numpy()


@torch.no_grad()
def leave_one_out_importance(model, variables, images, labels, num_classes: int, block_index: int,
        seed: int = 0) -> np.ndarray:
    """The loss increase with one output channel of the block zeroed; the tail forwards run 1024 images a batch."""
    m, h = _load(model, variables, images)
    head = _probe_head(m, num_classes, seed)
    h = m.run_blocks(h, 0, block_index + 1)
    b, c = h.shape[:2]
    base = _losses(m.head_pool(m.run_blocks(h, block_index + 1)), labels, head)
    chunk, out = max(1, 1024 // b), []
    for s in range(0, c, chunk):
        ch = torch.arange(s, min(c, s + chunk), device=h.device)
        mask = (torch.arange(c, device=h.device)[None] != ch[:, None]).to(h.dtype)  # [n, C]
        x = (h[None] * mask[:, None, :, None, None]).flatten(0, 1).contiguous(memory_format=torch.channels_last)
        out.append(_losses(m.head_pool(m.run_blocks(x, block_index + 1)), labels, head, len(ch)))
    return (torch.cat(out) - base).float().cpu().numpy()


def apoz_hidden_scores(model, variables, images, block_index: int) -> np.ndarray:
    """1 - the average percentage of zeros (|a| < 1e-3) of each hidden channel."""
    acts = _block_hidden_activations(model, variables, images, block_index)
    return (1.0 - (acts.abs() < 1e-3).float().mean(dim=(0, 2, 3))).cpu().numpy()


def class_sep_hidden_scores(model, variables, images, labels, block_index: int) -> np.ndarray:
    """Between- over within-class scatter of each hidden channel's pooled activation."""
    pooled = _block_hidden_activations(model, variables, images, block_index).mean(dim=(2, 3)).cpu().numpy()
    labels = np.asarray(labels)
    overall = pooled.mean(axis=0)
    between, within = np.zeros(pooled.shape[1]), np.zeros(pooled.shape[1])
    for c in np.unique(labels):
        rows = pooled[labels == c]
        mu = rows.mean(axis=0)
        between += len(rows) * (mu - overall) ** 2
        within += ((rows - mu) ** 2).sum(axis=0)
    return between / np.maximum(within, 1e-12)


METRICS: Dict[str, str] = {
    "l1": "L1 kernel norm (the reference's active metric)",
    "apoz": "average percentage of zeros",
    "taylor": "gradient x activation",
    "leave_one_out": "leave-channel-out loss increase",
    "class_sep": "pairwise class separation",
    "random": "random control (prune_model_random, :552-571)",
}


def _slice_block_params(block_params, block_stats, keep: np.ndarray, cfg) -> Tuple[dict, dict]:
    """The kept hidden channels through expand, depthwise, SE and project."""
    def take(x, axis):
        return np.take(np.asarray(x), keep, axis=axis)

    p, s = dict(block_params), dict(block_stats)
    for n in (("expand_conv", "expand_bn") if cfg["expand"] != 1 else ()) + ("dw_conv", "dw_bn"):
        p[n] = {k: take(v, 3 if k == "kernel" else 0) for k, v in block_params[n].items()}
        if n in block_stats:
            s[n] = {k: take(v, 0) for k, v in block_stats[n].items()}
    if "se" in p:
        se = block_params["se"]
        p["se"] = {"reduce": {"kernel": take(se["reduce"]["kernel"], 2), "bias": se["reduce"]["bias"]},
                "expand": {"kernel": take(se["expand"]["kernel"], 3), "bias": take(se["expand"]["bias"], 0)}}
    p["project_conv"] = {"kernel": take(block_params["project_conv"]["kernel"], 2)}
    return p, s


def _rebuilt(model, overrides: Dict[str, int]):
    """``model``'s family, variant and device at the hidden widths ``overrides``."""
    if isinstance(model, MobileNetV2):
        new = MobileNetV2(model.width, model.num_classes, model.dtype, overrides, model.resolution)
    else:
        new = EfficientNet(model.variant, model.num_classes, model.dtype, overrides, model.remat)
        new.resolution = model.resolution
    return new.to(next(model.parameters()).device).eval()


def prune_backbone(model, variables, fraction: float = 0.25, metric: str = "l1", round_to: int = 16, images=None,
        labels=None, num_classes: int = 0, seed: int = 13):
    """Drop the worst ``fraction`` of each expanding block's hidden channels by ``metric``, to multiples of
    ``round_to``; a copy of ``model`` runs the data metrics on ``variables`` over ``images`` (preprocessed NHWC).
    (pruned module on ``model``'s device, its tree); earlier rounds' widths kept."""
    if metric not in METRICS:
        raise ValueError(f"unknown metric {metric!r}; options: {sorted(METRICS)}")
    if metric not in ("l1", "random"):
        if images is None or (labels is None and metric != "apoz"):
            raise ValueError(f"metric {metric!r} needs calibration images" + " and labels" * (metric != "apoz"))
        net = copy.deepcopy(model).load_variables(variables)  # the caller's module keeps its weights
    rng = np.random.default_rng(seed)
    params, stats = dict(variables["params"]), dict(variables["batch_stats"])
    overrides = dict(model.hidden_overrides)
    for bi, cfg in enumerate(model.plan_configs()):
        name = cfg["name"]
        if cfg["expand"] == 1:
            continue  # hidden == input: no expand axis
        hidden = params[name]["expand_conv"]["kernel"].shape[3]
        new_hidden = round_down_multiple(int(hidden * (1.0 - fraction)), round_to)
        if new_hidden >= hidden:
            continue
        if metric == "l1":
            scores = l1_kernel_importance(variables, name)
        elif metric == "random":
            scores = rng.random(hidden)
        elif metric == "apoz":
            scores = apoz_hidden_scores(net, None, images, bi)
        elif metric == "class_sep":
            scores = class_sep_hidden_scores(net, None, images, labels, bi)
        else:  # per output channel, onto the hidden axis through |project_conv|
            if metric == "taylor":
                out = taylor_importance(net, None, images, labels, num_classes, bi)
            else:
                out = np.maximum(leave_one_out_importance(net, None, images, labels, num_classes, bi, seed), 0.0)
            scores = np.abs(np.asarray(params[name]["project_conv"]["kernel"]))[0, 0] @ out
        params[name], stats[name] = _slice_block_params(params[name], stats[name], keep_top(scores, new_hidden), cfg)
        overrides[name] = new_hidden
    new_vars = {"params": params, "batch_stats": stats}
    return _rebuilt(model, overrides).load_variables(new_vars), new_vars


prune_efficientnet = prune_backbone  # the first family's name (JAX's)


def parameter_count(variables) -> int:
    def count(t):
        return sum(count(v) for v in t.values()) if isinstance(t, dict) else int(np.size(t))

    return count(variables["params"])
