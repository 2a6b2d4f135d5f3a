"""BN fold of variables and the serving entry (JAX ``models/fold.py``): each BN
into its conv in fp64 (a lone BN keeps its affine map)."""

from typing import Any, Dict, Optional, Sequence

import numpy as np
import torch
from torch import nn

from ..device import DeviceLike, resolve_device
from .efficientnet import (CAFFE_MEAN_BGR, MEAN_RGB, STDDEV_RGB, TF_MODE_MEAN, TF_MODE_STD, EfficientNet,
    preprocess_images, preprocess_images_caffe)
from .inception_resnet import InceptionResNetV2
from .inception_v3 import InceptionV3
from .inference import make_infer_fn
from .mobilenet import MobileNetV1, MobileNetV2, parse_mobilenet_width
from .resnet import ResNet
from .vgg import VGG19
from .zoo import ConvBN

MBCONV_FAMILIES = ("efficientnet", "mobilenetv2")  # served by make_infer_fn (JAX :179)
# the generic fold's families; the VALID-stem 'tf' ones take the stem fold (JAX :182)
_BN_FAMILIES = {"inception_resnet_v2": InceptionResNetV2, "inception_v3": InceptionV3, "resnet": ResNet, "vgg": VGG19}


def bn_fold_eps(model) -> float:
    """The family's BN epsilon; ``model`` is a module or its class name."""
    return 1.001e-5 if (model if isinstance(model, str) else type(model).__name__) == "ResNet" else 1e-3


def _to_plain(node):
    try:
        items = node.items()
    except AttributeError:
        return np.asarray(node)
    return {k: _to_plain(v) for k, v in items}


def fold_variables(model, variables, eps: Optional[float] = None):
    """New numpy trees with every BN folded (JAX :79-148)."""
    if eps is None:
        eps = bn_fold_eps(model)
    if "batch_stats" not in variables:
        return variables
    params, stats = _to_plain(variables["params"]), _to_plain(variables["batch_stats"])
    f64 = lambda a: np.asarray(a, np.float64)  # noqa: E731

    def walk(p_node, s_node):
        for key, s_child in list(s_node.items()):
            if not (isinstance(s_child, dict) and {"mean", "var"} <= set(s_child)
                    and not isinstance(s_child["mean"], dict)):
                if isinstance(s_child, dict):
                    walk(p_node[key], s_child)
                continue
            bn_p = p_node[key]
            s = f64(bn_p["scale"]) / np.sqrt(f64(s_child["var"]) + eps)
            c = f64(bn_p["bias"]) - f64(s_child["mean"]) * s
            conv = p_node.get(key.replace("bn", "conv")) if "bn" in key else None
            s_mul, c_add = s, c  # affine-only where no conv feeds the BN
            if isinstance(conv, dict) and "kernel" in conv and conv["kernel"].shape[-1] == s.shape[0]:
                conv["kernel"] = (f64(conv["kernel"]) * s).astype(np.float32)
                s_mul = 1.0
                if "bias" in conv:
                    conv["bias"] = (s * f64(conv["bias"]) + c).astype(np.float32)
                    c_add = np.zeros_like(c)
            bn_p["scale"] = np.broadcast_to(np.asarray(s_mul, np.float32), c.shape).copy()
            bn_p["bias"] = np.asarray(c_add, np.float32)
            s_child["mean"] = np.zeros(c.shape, np.float32)
            s_child["var"] = np.full(c.shape, 1.0 - eps, np.float32)

    walk(params, stats)
    return {**variables, "params": params, "batch_stats": stats}


def _bn_bias_to_conv(params):
    """Each ``*bn*`` node's bias onto its ``*conv*`` sibling (a folded tree)."""
    for k, v in params.items():
        if "bn" in k and k.replace("bn", "conv") in params:
            params[k.replace("bn", "conv")]["bias"] = v["bias"]
        elif isinstance(v, dict):
            _bn_bias_to_conv(v)
    return params


def fold_tf_preprocess_into_valid_stem(variables, stem_path: Sequence[str] = ("stem", "conv1"), scale: float = 127.5):
    """``x/scale - 1`` into the VALID stem conv of a ``fold_variables`` tree (JAX :151-182)."""
    params = _to_plain(variables["params"])
    node = params
    for p in stem_path:
        node = node[p]
    k = np.asarray(node["conv"]["kernel"], np.float64)
    node["conv"]["kernel"] = (k / scale).astype(np.float32)
    bn = node["bn"]
    bn["bias"] = (np.asarray(bn["bias"], np.float64) - k.sum(axis=(0, 1, 2))).astype(np.float32)
    return {**variables, "params": params}


class ServingModule(nn.Module):
    """uint8 NHWC -> ``{'embedding', 'taps'}``: resized, normalized unless folded (``mean=None``); ``bgr``: 'caffe'."""

    def __init__(self, net: nn.Module, resolution: int, taps: Sequence[str] = (), mean=None, std=None,
            bgr: bool = False):
        super().__init__()
        self.net, self.resolution, self.taps, self.normalize = net, int(resolution), tuple(taps), mean is not None
        self.bgr = bgr
        # on the device: one made per call would be a host sync
        self.register_buffer("mean", torch.tensor(mean or (0.0,) * 3, dtype=torch.float32))
        self.register_buffer("std", torch.tensor(std or (1.0,) * 3, dtype=torch.float32))

    def forward(self, images: torch.Tensor) -> Dict[str, Any]:
        r, x = self.resolution, images
        if self.bgr:
            x = preprocess_images_caffe(x, r, self.mean)
        elif self.normalize or x.shape[1] != r or x.shape[2] != r:
            x = preprocess_images(x, r, self.mean, self.std)
        out = self.net(x, taps=self.taps, include_logits=False)
        return {"embedding": out["embedding"], "taps": out["taps"]}


def _bf16_convs(net: nn.Module, dev) -> nn.Module:
    """The folded convs' weights in bf16 once; BNs (ResNetV2's affine ones) stay fp32."""
    net = net.to(dev).to(memory_format=torch.channels_last)
    for m in net.modules():
        if isinstance(m, ConvBN) and m.bn is None:
            m.to(torch.bfloat16)
    return net


def make_serving_fn(variables: Dict[str, Any], info: Dict[str, Any], resolution: Optional[int] = None,
    taps: Sequence[str] = (), device: DeviceLike = None, folded: bool = True) -> nn.Module:
    """A zoo member's serving module: MBConv by :func:`make_infer_fn`, the rest by ``fold_variables``;
    ``folded=False`` keeps BN."""
    family, dev = info.get("family"), resolve_device(device)
    res = int(resolution or info["resolution"])
    pp = info.get("preprocess", "torch")
    if family not in MBCONV_FAMILIES + ("mobilenetv1",) + tuple(_BN_FAMILIES) or pp not in ("torch", "tf", "caffe"):
        raise ValueError(f"unknown family {family!r} ({pp!r} preprocess)")
    variables = {k: variables[k] for k in ("params", "batch_stats") if k in variables}
    if family in MBCONV_FAMILIES and folded:
        mean, std = (TF_MODE_MEAN, TF_MODE_STD) if pp == "tf" else (None, None)
        return make_infer_fn(variables, info["variant"], taps=taps, resolution=res, mean=mean, std=std, device=dev)
    mean, std = {"tf": (TF_MODE_MEAN, TF_MODE_STD), "caffe": (CAFFE_MEAN_BGR, None)}.get(pp, (MEAN_RGB, STDDEV_RGB))
    # the tree's hidden widths: a pruned one's too
    hidden = {n: np.shape(p["dw_conv"]["kernel"])[-1] for n, p in variables["params"].items() if "dw_conv" in p}
    if family == "efficientnet":
        net = EfficientNet(info["variant"], hidden_overrides=hidden).load_variables(variables).to(dev)
    elif family == "mobilenetv2":
        net = MobileNetV2(parse_mobilenet_width(info["variant"]), hidden_overrides=hidden).load_variables(variables)
        net = net.to(dev)
    elif family == "mobilenetv1":  # folded: each neutral BN's bias on its conv, added before the rounding
        v = {"params": _bn_bias_to_conv(fold_variables("MobileNetV1", variables)["params"])} if folded else variables
        net = MobileNetV1(folded=folded).load_variables(v).to(dev)
    else:
        cls, kw = _BN_FAMILIES[family], {"variant": info["variant"]} if family == "resnet" else {}
        if folded:
            variables = fold_variables(cls.__name__, variables)  # VGG19's tree, no BN, as it is
            if family.startswith("inception"):  # VALID stems and 'tf': the preprocess folds exactly
                variables = fold_tf_preprocess_into_valid_stem(variables)
                mean = std = None
            if family != "vgg":
                kw["folded"] = True
        net = cls(**kw).load_variables(variables)
        net = _bf16_convs(net, dev) if folded else net.to(dev)
    return ServingModule(net, res, taps, mean, std, bgr=pp == "caffe").to(dev).eval()
