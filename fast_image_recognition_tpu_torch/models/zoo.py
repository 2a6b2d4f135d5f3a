"""The zoo's shared parts: flax's init, BN, the fp32 pool, ``ZooNet`` (segments,
train mode, flax trees), ``create``, ``ConvBN``, ``_Block``, the VALID
Inception stem. NCHW ``channels_last``, bf16."""

import contextlib
import math
from typing import Any, Dict, List, Optional, Sequence

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

from ..device import DeviceLike, resolve_device

_BN_EPS = 1e-3
# flax lecun_normal: truncated to [-2, 2], scaled by sqrt(1 / fan_in) / 0.8796
_TRUNC_STD = 0.87962566103423978


def _lecun_normal(shape, fan_in: int, gen: torch.Generator) -> torch.Tensor:
    """flax ``lecun_normal()`` by the inverse CDF from ``gen``."""
    lo, hi = math.erf(-2.0 / math.sqrt(2.0)), math.erf(2.0 / math.sqrt(2.0))
    u = torch.rand(shape, generator=gen, dtype=torch.float64) * (hi - lo) + lo
    x = torch.erfinv(u) * math.sqrt(2.0)
    return (x * (math.sqrt(1.0 / fan_in) / _TRUNC_STD)).to(torch.float32)


class _BatchNorm(nn.Module):
    """flax ``nn.BatchNorm`` in fp32, rounded to ``x``'s dtype; under :func:`batch_stats` on batch
    statistics (``max(0, E[x^2] - E[x]^2)`` over N, H, W), committed as ``m * old + (1 - m) * batch``."""

    def __init__(self, c: int, eps: float = _BN_EPS, momentum: float = 0.99):
        super().__init__()
        self.eps, self.momentum, self.use_batch, self.pending = eps, momentum, False, None
        self.scale = nn.Parameter(torch.ones(c))
        self.bias = nn.Parameter(torch.zeros(c))
        self.register_buffer("mean", torch.zeros(c))
        self.register_buffer("var", torch.ones(c))

    def forward(self, x: torch.Tensor, dtype: Optional[torch.dtype] = None) -> torch.Tensor:
        mean, var, xf = self.mean, self.var, x.to(torch.float32)
        if self.use_batch:
            mean = xf.mean(dim=(0, 2, 3))
            var = torch.clamp((xf * xf).mean(dim=(0, 2, 3)) - mean * mean, min=0.0)
            self.pending = (mean.detach(), var.detach())
        mul = torch.rsqrt(var + self.eps) * self.scale
        y = (xf - mean[:, None, None]) * mul[:, None, None] + self.bias[:, None, None]
        return y.to(dtype or x.dtype)

    @torch.no_grad()
    def commit(self) -> None:
        if self.pending is not None:
            m, (mean, var), self.pending = self.momentum, self.pending, None
            self.mean.copy_(m * self.mean + (1.0 - m) * mean)
            self.var.copy_(m * self.var + (1.0 - m) * var)

    def export(self):
        t = lambda v: np.array(v.detach().cpu())  # noqa: E731  (a copy: training moves them in place)
        return {"scale": t(self.scale), "bias": t(self.bias)}, {"mean": t(self.mean), "var": t(self.var)}

    def load(self, p: Dict[str, Any], s: Dict[str, Any]) -> None:
        for name, tree in (("scale", p), ("bias", p), ("mean", s), ("var", s)):
            getattr(self, name).data = torch.tensor(np.asarray(tree[name], np.float32))


@contextlib.contextmanager
def batch_stats(module: nn.Module, train: bool = True, commit: bool = True):
    """Train mode for every BN under ``module``, the running statistics updated on exit."""
    bns = [m for m in module.modules() if isinstance(m, _BatchNorm)] if train else []
    for bn in bns:
        bn.use_batch, bn.pending = True, None
    try:
        yield
    finally:
        for bn in bns:
            bn.use_batch = False
            if commit:
                bn.commit()


def keep_mask(shape, keep: float, rng: Optional[torch.Generator], device) -> torch.Tensor:
    """``jax.random.bernoulli(keep)``: uniform draws from ``rng`` below ``keep``."""
    return torch.rand(shape, generator=rng, device=device) < keep


def _pool(h: torch.Tensor) -> torch.Tensor:
    """``jnp.mean``'s global pool: fp32 sums, rounded to the activation's dtype, fp32 out."""
    return h.to(torch.float32).mean(dim=(2, 3)).to(h.dtype).to(torch.float32)


def _node(tree, path, make=False):
    for key in path:
        tree = tree.setdefault(key, {}) if make else tree[key]
    return tree


class ZooNet(nn.Module):
    """Segments over ``plan``, ``blocks``: ``forward`` -> ``{'embedding', 'taps'}`` (+ ``logits``), ``_after(i,
    h)`` between blocks. Subclasses give ``stem``, ``head_pool``, ``fc``, ``_layers``: (conv path, BN path, module)."""

    def block_names(self) -> List[str]:
        return [b["name"] for b in self.plan]

    def plan_configs(self) -> List[Dict[str, Any]]:
        return [dict(b) for b in self.plan]

    def _after(self, i: int, h: torch.Tensor) -> torch.Tensor:
        return h

    def _block(self, i: int, h: torch.Tensor, train: bool, rng) -> torch.Tensor:
        return self.blocks[i](h)

    def run_blocks(self, x: torch.Tensor, start: int = 0, end: Optional[int] = None, train: bool = False,
            rng: Optional[torch.Generator] = None) -> torch.Tensor:
        with batch_stats(self, train):
            for i in range(len(self.plan))[start:end]:
                x = self._after(i, self._block(i, x, train, rng))
        return x

    drop_rate = 0.0  # flax nn.Dropout on the embedding before ``fc``, train mode only

    def forward(self, x, train: bool = False, taps: Optional[Sequence[str]] = None,
            include_logits: Optional[bool] = None, rng: Optional[torch.Generator] = None) -> Dict[str, Any]:
        """``train``: batch statistics (the running ones updated), stochastic depth and dropout from ``rng``."""
        with batch_stats(self, train):
            h, tap_out = self.stem(x), {}
            for i, cfg in enumerate(self.plan):
                h = self._block(i, h, train, rng)
                if cfg["name"] in (taps or ()):
                    tap_out[cfg["name"]] = _pool(h)
                h = self._after(i, h)
            out = {"embedding": self.head_pool(h), "taps": tap_out}
        if self.fc is not None and include_logits is not False:
            e, keep = out["embedding"], 1.0 - self.drop_rate
            if train and keep < 1.0:
                e = torch.where(keep_mask(e.shape, keep, rng, e.device), e / keep, 0.0)
            out["logits"] = self.fc(e)
        return out

    def _to_nchw(self, x: torch.Tensor) -> torch.Tensor:
        return x.to(self.dtype).permute(0, 3, 1, 2).contiguous(memory_format=torch.channels_last)

    @torch.no_grad()
    def init_weights(self, seed: int = 0) -> None:
        """flax's default init from ``torch.Generator().manual_seed(seed)``."""
        gen = torch.Generator().manual_seed(int(seed))
        for conv_path, _, m in self._layers():
            if conv_path is not None:
                m.weight.data = _lecun_normal(m.weight.shape, m.weight[0].numel(), gen)
        if self.fc is not None:
            self.fc.weight.data = _lecun_normal(self.fc.weight.shape[::-1], self.fc.in_features, gen).T.contiguous()
            self.fc.bias.zero_()

    def export_variables(self) -> Dict[str, Any]:
        """The flax ``{'params'[, 'batch_stats']}`` trees as numpy fp32."""
        params: Dict[str, Any] = {}
        stats: Dict[str, Any] = {}
        t = lambda v: np.array(v.detach().cpu())  # noqa: E731  (a copy: training moves them in place)
        for conv_path, bn_path, m in self._layers():
            bn = m if conv_path is None else getattr(m, "bn", None)
            if conv_path is not None:
                node = _node(params, conv_path, True)
                node["kernel"] = t(m.weight.permute(2, 3, 1, 0))
                if m.bias is not None:
                    node["bias"] = t(m.bias)
            if bn is not None:
                p, s = bn.export()
                _node(params, bn_path, True).update(p)
                _node(stats, bn_path, True).update(s)
        if self.fc is not None:
            params["fc"] = {"kernel": t(self.fc.weight.T), "bias": t(self.fc.bias)}
        return {"params": params, "batch_stats": stats} if stats else {"params": params}

    @torch.no_grad()
    def load_variables(self, variables: Dict[str, Any]) -> "ZooNet":
        """A flax numpy tree into the module; a folded module takes ``fold_variables``' tree."""
        dev, params, stats = next(self.parameters()).device, variables["params"], variables.get("batch_stats", {})
        f32 = lambda a: torch.tensor(np.asarray(a, np.float32))  # noqa: E731
        for conv_path, bn_path, m in self._layers():
            bn = m if conv_path is None else getattr(m, "bn", None)
            if bn is not None:
                bn.load(_node(params, bn_path), _node(stats, bn_path))
            if conv_path is None:
                continue
            node = _node(params, conv_path)
            m.weight.data = f32(node["kernel"]).permute(3, 2, 0, 1).contiguous()
            if m.bias is not None:
                b = np.asarray(node.get("bias", 0.0), np.float32)
                m.bias.data = f32(b + _node(params, bn_path)["bias"] if bn is None and bn_path else b)
        if self.fc is not None:
            self.fc.weight.data = f32(params["fc"]["kernel"]).T.contiguous()
            self.fc.bias.data = f32(params["fc"]["bias"])
        return self.to(dev)


def create(model: ZooNet, seed: int, resolution: int, device: DeviceLike):
    """``(model on device, its flax-layout numpy variables)``, flax's init from ``seed``."""
    dev = resolve_device(device)
    model.init_weights(seed)
    model.resolution = int(resolution)
    return model.to(dev).eval(), model.export_variables()


class ConvBN(nn.Module):
    """Conv + BN + ReLU, symmetric pads (SAME: ``k // 2``); a bias where ``bias`` (default: no BN). A conv
    feeding a BN runs in fp32 from bf16 operands, rounded once after the BN (XLA's)."""

    def __init__(self, cin, cout, k=1, stride=1, padding="SAME", relu=True, bn=True, bias=None, eps=_BN_EPS):
        super().__init__()
        kh, kw = (k, k) if isinstance(k, int) else k
        self.stride, self.relu = stride, relu
        self.pad = (kh // 2, kw // 2) if padding == "SAME" else (0, 0)
        self.weight = nn.Parameter(torch.zeros(cout, cin, kh, kw))
        self.bias = nn.Parameter(torch.zeros(cout)) if (not bn if bias is None else bias) else None
        self.bn = _BatchNorm(cout, eps) if bn else None

    def forward(self, x):
        w, b = self.weight.to(x.dtype), None if self.bias is None else self.bias.to(x.dtype)
        if self.bn is None:
            y = F.conv2d(x, w, b, self.stride, self.pad)
        else:
            y = self.bn(F.conv2d(x.float(), w.float(), None if b is None else b.float(), self.stride, self.pad),
                    x.dtype)
        return F.relu(y) if self.relu else y


def _pool3(x, how):
    if how == "avg":
        return F.avg_pool2d(x, 3, 1, 1, count_include_pad=False)
    return F.max_pool2d(x, 3, 2)


class _Block(nn.Module):
    """Branches concatenated; a residual kind adds ``scale * up(mix)`` then ReLU (not ``last``). ``spec``: (in
    channels, branches, scale). A branch: convs (out, k[, stride, padding]) after a 3x3 "avg" (SAME) or "max" (stride
    2) pool; a list is a split. Conv j of branch i: b{i} or b{i}_{j} (+ "a", "b" in a split), a pool branch's
    ``pool_name``."""

    def __init__(self, spec, bn, dtype, last=False, pool_name=None):
        super().__init__()
        cin, branches, scale = spec
        self.chains, out = [], 0
        for i, chain in enumerate(branches):
            pool = chain[0] if isinstance(chain[0], str) else None
            convs = [c for c in chain if not isinstance(c, str)]
            names, c = [], cin
            for j, spec_j in enumerate(convs):
                name = pool_name if pool and pool_name else f"b{i}" if len(convs) == 1 else f"b{i}_{j}"
                split = spec_j if isinstance(spec_j, list) else [spec_j]
                for s, part in enumerate(split):
                    self.add_module(name + "ab"[s] * (len(split) > 1), ConvBN(c, *part, bn=bn))
                names.append([name + "ab"[s] * (len(split) > 1) for s in range(len(split))])
                c = sum(part[0] for part in split)
            self.chains.append((pool, names))
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
            for split in names:
                parts = [getattr(self, n)(h) for n in split]
                h = parts[0] if len(parts) == 1 else torch.cat(parts, 1)
            outs.append(h)
        mix = torch.cat(outs, 1)
        if self.scale is None:
            return mix
        y = x + self.scale * self.up(mix)
        return F.relu(y) if self.relu else y


# the VALID stem both Inceptions share: 299 -> 35x35x192
_V = "VALID"
STEM = [(32, 3, 2, _V), (32, 3, 1, _V), (64, 3), "max", (80, 1, 1, _V), (192, 3, 1, _V), "max"]


def stem_convs(bn: bool) -> nn.ModuleDict:
    mods, c = nn.ModuleDict(), 3
    for spec in STEM:
        if spec != "max":
            mods[f"conv{len(mods) + 1}"] = ConvBN(c, *spec, bn=bn)
            c = spec[0]
    return mods


def run_stem(mods: nn.ModuleDict, x: torch.Tensor) -> torch.Tensor:
    convs = iter(mods.values())
    for spec in STEM:
        x = _pool3(x, "max") if spec == "max" else next(convs)(x)
    return x


def branch_layers(stem: nn.ModuleDict, plan, blocks, tail=()):
    """ConvBN units at (scope + 'conv', scope + 'bn'); ``up`` at its scope."""
    named = [(("stem", n), m) for n, m in stem.items()]
    named += [((cfg["name"], n), m) for cfg, blk in zip(plan, blocks) for n, m in blk.named_children()]
    for scope, m in named + list(tail):
        yield (scope, None, m) if scope[-1] == "up" else (scope + ("conv",), scope + ("bn",), m)
