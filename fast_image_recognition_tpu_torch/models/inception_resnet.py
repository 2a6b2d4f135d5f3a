"""InceptionResNetV2, the 1536-d gallery producer (JAX
``models/inception_resnet.py:32-311``): its blocks, plan, taps and segments
in NCHW ``channels_last``, bf16 compute, fp32 pools; ``folded=True``, each
conv carrying its folded BN as a bias (``models/fold.py``)."""

from __future__ import annotations

from typing import Any, Dict, List, Optional, Sequence

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

from fast_image_recognition_tpu_torch.device import DeviceLike, resolve_device
from fast_image_recognition_tpu_torch.models.efficientnet import _BatchNorm, _lecun_normal, _pool

INCEPTION_RESNET_EMBED_DIM = 1536

# kind -> (in channels, branches, residual scale or None). A branch is a
# chain of convs (out, kernel[, stride, padding]), after a 3x3 pool where it
# starts with "avg" (stride 1, SAME, pads not counted) or "max" (stride 2,
# VALID). Conv j of branch i is named b{i}, or b{i}_{j} in a longer chain.
_V = "VALID"
_KINDS = {
    "mixed5b": (192, [[(96, 1)], [(48, 1), (64, 5)], [(64, 1), (96, 3), (96, 3)], ["avg", (64, 1)]], None),
    "block35": (320, [[(32, 1)], [(32, 1), (32, 3)], [(32, 1), (48, 3), (64, 3)]], 0.17),
    "mixed6a": (320, [[(384, 3, 2, _V)], [(256, 1), (256, 3), (384, 3, 2, _V)], ["max"]], None),
    "block17": (1088, [[(192, 1)], [(128, 1), (160, (1, 7)), (192, (7, 1))]], 0.10),
    "mixed7a": (1088, [[(256, 1), (384, 3, 2, _V)], [(256, 1), (288, 3, 2, _V)],
                       [(256, 1), (288, 3), (320, 3, 2, _V)], ["max"]], None),
    "block8": (2080, [[(192, 1)], [(192, 1), (224, (1, 3)), (256, (3, 1))]], 0.20),
}
_STEM = [(32, 3, 2, _V), (32, 3, 1, _V), (64, 3), "max", (80, 1, 1, _V), (192, 3, 1, _V), "max"]


def inception_resnet_plan() -> List[Dict[str, Any]]:
    plan = [dict(name="mixed5b", kind="mixed5b", stage=1)]
    plan += [dict(name=f"block35_{i + 1}", kind="block35", stage=2) for i in range(10)]
    plan += [dict(name="mixed6a", kind="mixed6a", stage=3)]
    plan += [dict(name=f"block17_{i + 1}", kind="block17", stage=4) for i in range(20)]
    plan += [dict(name="mixed7a", kind="mixed7a", stage=5)]
    plan += [dict(name=f"block8_{i + 1}", kind="block8", stage=6) for i in range(10)]
    return plan


def default_taps_inception_resnet() -> List[str]:
    return ["block17_10", "block17_20", "block8_5"]


class ConvBN(nn.Module):
    """Conv (no bias) + inference BN (eps 1e-3) + ReLU; with ``bn=False``
    a conv with a bias (a folded ConvBN, or a block's ``up``). Every SAME
    conv here is stride 1 with odd kernels, so its padding is symmetric."""

    def __init__(self, cin, cout, k=1, stride=1, padding="SAME", relu=True, bn=True):
        super().__init__()
        kh, kw = (k, k) if isinstance(k, int) else k
        self.stride, self.relu = stride, relu
        self.pad = (kh // 2, kw // 2) if padding == "SAME" else (0, 0)
        self.weight = nn.Parameter(torch.zeros(cout, cin, kh, kw))
        self.bias = None if bn else nn.Parameter(torch.zeros(cout))
        self.bn = _BatchNorm(cout) if bn else None

    def forward(self, x):
        b = None if self.bias is None else self.bias.to(x.dtype)
        y = F.conv2d(x, self.weight.to(x.dtype), b, self.stride, self.pad)
        y = y if self.bn is None else self.bn(y)
        return F.relu(y) if self.relu else y


def _pool3(x, how):
    if how == "avg":
        return F.avg_pool2d(x, 3, 1, 1, count_include_pad=False)
    return F.max_pool2d(x, 3, 2)


class _Block(nn.Module):
    """Parallel branches concatenated over channels; a residual kind adds
    ``scale * up(mix)`` to its input in the activation dtype, then ReLU
    (none for the linear last Block8)."""

    def __init__(self, kind, bn, dtype, last=False):
        super().__init__()
        cin, branches, scale = _KINDS[kind]
        self.chains, out = [], 0
        for i, chain in enumerate(branches):
            convs = [c for c in chain if not isinstance(c, str)]
            names, c = [], cin
            for j, spec in enumerate(convs):
                name = f"b{i}" if len(convs) == 1 else f"b{i}_{j}"
                self.add_module(name, ConvBN(c, *spec, bn=bn))
                names.append(name)
                c = spec[0]
            self.chains.append((chain[0] if isinstance(chain[0], str) else None, names))
            out += c
        self.scale, self.relu = (1.0, False) if last else (scale, True)
        if scale is not None:
            self.up = ConvBN(out, cin, relu=False, bn=False)
            # JAX multiplies by the Python scale in the activation dtype
            self.scale = float(torch.tensor(self.scale, dtype=dtype))

    def forward(self, x):
        outs = []
        for pool, names in self.chains:
            h = x if pool is None else _pool3(x, pool)
            for n in names:
                h = getattr(self, n)(h)
            outs.append(h)
        mix = torch.cat(outs, 1)
        if self.scale is None:
            return mix
        y = x + self.scale * self.up(mix)
        return F.relu(y) if self.relu else y


class InceptionResNetV2(nn.Module):
    """``forward(NHWC images)`` -> ``{'embedding': [B, 1536] fp32, 'taps':
    {name: [B, C] fp32 pooled block output}}`` (+ ``logits``)."""

    def __init__(self, num_classes: int = 0, dtype: torch.dtype = torch.bfloat16, folded: bool = False):
        super().__init__()
        self.num_classes, self.dtype, self.plan = int(num_classes), dtype, inception_resnet_plan()
        self.stem_mod = nn.ModuleDict()
        c = 3
        for spec in _STEM:
            if spec != "max":
                self.stem_mod[f"conv{len(self.stem_mod) + 1}"] = ConvBN(c, *spec, bn=not folded)
                c = spec[0]
        self.blocks = nn.ModuleList(_Block(b["kind"], not folded, dtype, last=b["name"] == "block8_10")
                                    for b in self.plan)
        self.head_conv = ConvBN(2080, INCEPTION_RESNET_EMBED_DIM, bn=not folded)
        self.fc = nn.Linear(INCEPTION_RESNET_EMBED_DIM, self.num_classes) if self.num_classes else None

    def block_names(self) -> List[str]:
        return [b["name"] for b in self.plan]

    def plan_configs(self) -> List[Dict[str, Any]]:
        return inception_resnet_plan()

    def stem(self, x: torch.Tensor) -> torch.Tensor:
        x = x.to(self.dtype).permute(0, 3, 1, 2).contiguous(memory_format=torch.channels_last)
        convs = iter(self.stem_mod.values())
        for spec in _STEM:
            x = _pool3(x, "max") if spec == "max" else next(convs)(x)
        return x

    def run_blocks(self, x: torch.Tensor, start: int = 0, end: Optional[int] = None) -> torch.Tensor:
        for blk in self.blocks[start:end]:
            x = blk(x)
        return x

    def head_pool(self, x: torch.Tensor) -> torch.Tensor:
        return _pool(self.head_conv(x))

    def forward(self, x, train: bool = False, taps: Optional[Sequence[str]] = None,
                include_logits: Optional[bool] = None) -> Dict[str, Any]:
        if train:
            raise NotImplementedError("training is not ported (ROADMAP.md §1 queue 2)")
        h, tap_out = self.stem(x), {}
        for cfg, blk in zip(self.plan, self.blocks):
            h = blk(h)
            if cfg["name"] in (taps or ()):
                tap_out[cfg["name"]] = _pool(h)
        out = {"embedding": self.head_pool(h), "taps": tap_out}
        if self.fc is not None and include_logits is not False:
            out["logits"] = self.fc(out["embedding"])  # dropout is the identity at inference
        return out

    def _layers(self):
        """(flax scope, ConvBN) of every conv, in the flax tree's naming."""
        for name, conv in self.stem_mod.items():
            yield ("stem", name), conv
        for cfg, blk in zip(self.plan, self.blocks):
            for name, conv in blk.named_children():
                yield (cfg["name"], name), conv
        yield ("conv_7b",), self.head_conv

    @torch.no_grad()
    def init_weights(self, seed: int = 0) -> None:
        """flax's default init from ``torch.Generator().manual_seed(seed)``:
        lecun-normal kernels, zero biases, unit BN."""
        gen = torch.Generator().manual_seed(int(seed))
        for _, conv in self._layers():
            w = conv.weight
            w.data = _lecun_normal(w.shape, w[0].numel(), gen)
        if self.fc is not None:
            self.fc.weight.data = _lecun_normal(self.fc.weight.shape[::-1], self.fc.in_features, gen).T.contiguous()
            self.fc.bias.zero_()

    def export_variables(self) -> Dict[str, Any]:
        """The flax ``{'params', 'batch_stats'}`` trees as numpy fp32."""
        params: Dict[str, Any] = {}
        stats: Dict[str, Any] = {}
        t = lambda v: v.detach().cpu().numpy()  # noqa: E731
        for scope, conv in self._layers():
            node = params
            for key in scope:
                node = node.setdefault(key, {})
            kernel = t(conv.weight.permute(2, 3, 1, 0))
            if conv.bn is None:
                node.update(kernel=kernel, bias=t(conv.bias))
                continue
            node["conv"] = {"kernel": kernel}
            node["bn"], s = conv.bn.export()
            st = stats
            for key in scope:
                st = st.setdefault(key, {})
            st["bn"] = s
        if self.fc is not None:
            params["fc"] = {"kernel": t(self.fc.weight.T), "bias": t(self.fc.bias)}
        return {"params": params, "batch_stats": stats}

    @torch.no_grad()
    def load_variables(self, variables: Dict[str, Any]) -> "InceptionResNetV2":
        """Copy a flax numpy tree into the module. A folded module takes the
        BN-folded tree (``fold_variables``): each conv's bias is its
        neutral BN's bias."""
        for scope, conv in self._layers():
            p, s = variables["params"], variables.get("batch_stats", {})
            for key in scope:
                p, s = p[key], s.get(key, {})
            if scope[-1] == "up":
                k, b = p["kernel"], p["bias"]
            else:
                k, b = p["conv"]["kernel"], p["bn"]["bias"]
            conv.weight.data = torch.tensor(np.asarray(k, np.float32)).permute(3, 2, 0, 1).contiguous()
            if conv.bn is None:
                conv.bias.data = torch.tensor(np.asarray(b, np.float32))
            else:
                conv.bn.load(p["bn"], s["bn"])
        if self.fc is not None:
            self.fc.weight.data = torch.tensor(np.asarray(variables["params"]["fc"]["kernel"], np.float32)).T
            self.fc.bias.data = torch.tensor(np.asarray(variables["params"]["fc"]["bias"], np.float32))
        return self


def create_inception_resnet_v2(num_classes: int = 0, seed: int = 0, resolution: int = 299,
                               dtype: torch.dtype = torch.bfloat16, device: DeviceLike = None):
    """``(model on device, its flax-layout numpy variables)`` with flax's
    default init drawn from ``seed``; VALID stem reductions need
    ``resolution`` >= 75 (kept as ``model.resolution``)."""
    dev = resolve_device(device)
    model = InceptionResNetV2(num_classes, dtype)
    model.init_weights(seed)
    model.resolution = int(resolution)
    return model.to(dev).eval(), model.export_variables()
