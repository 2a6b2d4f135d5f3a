"""Fused stride-1 MBConv block (counterpart of
``fast_image_recognition_tpu/ops/mbconv_kernel.py``: ``_same_pads``,
``_act``, ``fused_mbconv``).

One folded inverted-residual block per call: expand 1x1 (if any),
depthwise k x k SAME, squeeze-excite (if any), project 1x1, residual (if
any). On a CUDA tensor it runs ``kernels/mbconv.cu`` (two launches: expand
+ depthwise per spatial tile, then SE gate + project); on a CPU tensor the
plain version ``kernels/plain.py::mbconv_plain``. It is opt-in, as in the
JAX package: ``make_infer_fn(fused=True)`` sends the stride-1 blocks here
and keeps the stride-2 ones on the per-op path.

Activations are NCHW tensors in ``channels_last`` memory (physically
NHWC); the kernel reads that memory in place. The geometry the kernel
takes (SAME pads, the spatial tile of its first launch) is computed here,
where the CPU tests reach it.
"""

from __future__ import annotations

import functools
from typing import Any, Dict, Tuple

import torch

from fast_image_recognition_tpu_torch.kernels import build, plain

# must match kernels/mbconv.cu
CC = 32  # hidden channels per block of the expand + depthwise launch
PAD = 8  # bf16 row padding in shared memory
THREADS = 256
SMEM_BUDGET = 112 * 1024  # per block of the first launch: two blocks per SM
MAX_TILE = 32


def _same_pads(h: int, k: int, stride: int) -> Tuple[int, int, int]:
    """(out, pad_low, pad_high) of XLA SAME padding along one spatial dim."""
    out = -(-h // stride)
    total = max((out - 1) * stride + k - h, 0)
    low = total // 2
    return out, low, total - low


def _round_up(x: int, m: int) -> int:
    return -(-x // m) * m


def expand_dw_smem(th: int, tw: int, k: int, cin: int, has_expand: bool) -> int:
    """Dynamic shared memory of one block of the first launch, as
    ``expand_dw_smem`` in kernels/mbconv.cu computes it: the bf16 hidden
    halo tile, with expand the bf16 input halo and weight chunk and one
    fp32 16x16 scratch per warp, and the fp32 partial-sum table."""
    npp = _round_up((th + k - 1) * (tw + k - 1), 16)
    total = npp * (CC + PAD) * 2 + THREADS * 4
    if has_expand:
        cinp = _round_up(cin, 16)
        total += npp * (cinp + PAD) * 2 + cinp * (CC + PAD) * 2 + (THREADS // 32) * 256 * 4
    return total


@functools.lru_cache(maxsize=None)
def tile_plan(h: int, w: int, k: int, cin: int, has_expand: bool) -> Tuple[int, int]:
    """Output tile (th, tw) of the first launch: the least halo-padded
    work, ``n_tiles * ((th + k - 1) * (tw + k - 1) + 32)`` (the expand is
    recomputed on each tile's halo; 32 stands for a block's fixed cost),
    within :data:`SMEM_BUDGET`; ties go to the larger tile."""
    best = None
    for th in range(1, min(h, MAX_TILE) + 1):
        for tw in range(1, min(w, MAX_TILE) + 1):
            if expand_dw_smem(th, tw, k, cin, has_expand) > SMEM_BUDGET:
                continue
            cost = -(-h // th) * -(-w // tw) * ((th + k - 1) * (tw + k - 1) + 32)
            key = (cost, -th * tw)
            if best is None or key < best[0]:
                best = (key, (th, tw))
    if best is None:
        raise ValueError(f"no tile of a {h}x{w} plane with k={k}, Cin={cin} fits {SMEM_BUDGET} bytes")
    return best[1]


def prepare_params(p: Dict[str, Any], cfg: Dict[str, Any], dtype: torch.dtype = torch.bfloat16) -> Dict[str, torch.Tensor]:
    """Folded block params (JAX layout: HWIO kernels, [C, S] SE denses) ->
    the kernel's layout: ``w_exp`` [Cin, Ce] and ``w_proj`` [Ce, Cout] in
    ``dtype`` (bf16 for the kernel's tensor cores), ``w_dw`` [k*k, Ce] and
    every bias and SE weight in fp32."""
    k = cfg["kernel"]
    f32 = torch.float32
    q: Dict[str, torch.Tensor] = {}
    if cfg["has_expand"]:
        q["w_exp"] = p["w_exp"].reshape(p["w_exp"].shape[2:]).to(dtype).contiguous()
        q["b_exp"] = p["b_exp"].to(f32).contiguous()
    q["w_dw"] = p["w_dw"].reshape(k * k, -1).to(f32).contiguous()
    q["b_dw"] = p["b_dw"].to(f32).contiguous()
    if cfg["has_se"]:
        for n in ("w_se1", "b_se1", "w_se2", "b_se2"):
            q[n] = p[n].to(f32).contiguous()
    q["w_proj"] = p["w_proj"].reshape(p["w_proj"].shape[2:]).to(dtype).contiguous()
    q["b_proj"] = p["b_proj"].to(f32).contiguous()
    return q


def mbconv(x: torch.Tensor, q: Dict[str, torch.Tensor], cfg: Dict[str, Any]) -> torch.Tensor:
    """One stride-1 block on ``x`` [B, Cin, H, W] with params ``q``
    (:func:`prepare_params`) -> [B, Cout, H, W] channels_last in ``x.dtype``.
    A CUDA ``x`` must be bf16 and channels_last; it launches the kernel or
    raises."""
    if cfg["stride"] != 1:
        raise NotImplementedError("fused_mbconv covers stride-1 blocks only")
    if x.dim() != 4:
        raise ValueError(f"x must be [B, C, H, W], got {tuple(x.shape)}")
    k = cfg["kernel"]
    activation = cfg.get("activation", "swish")
    if activation not in ("swish", "relu6"):
        raise ValueError(f"unknown activation {activation!r}")
    _, h, w = x.shape[1:]
    _, pl_h, ph_h = _same_pads(h, k, 1)
    _, pl_w, ph_w = _same_pads(w, k, 1)
    residual = bool(cfg["residual"])
    if x.device.type == "cpu":
        return plain.mbconv_plain(x, q, k, ((pl_h, ph_h), (pl_w, ph_w)), activation, residual)
    if x.device.type != "cuda":
        raise ValueError(f"unsupported device {x.device}")
    tile = tile_plan(h, w, k, x.shape[1], "w_exp" in q)
    return build.launch_mbconv(x, q, k, (pl_h, pl_w), tile, activation == "relu6", residual)


def fused_mbconv(x: torch.Tensor, p: Dict[str, Any], cfg: Dict[str, Any]) -> torch.Tensor:
    """Run one folded stride-1 MBConv block (``p``, ``cfg`` as
    ``models.inference.fold_backbone`` gives them) on ``x`` [B, Cin, H, W]
    (bf16, or fp32 cast to bf16 here, as in the JAX package) -> bf16
    [B, Cout, H, W] channels_last. Raises ``NotImplementedError`` on
    stride 2."""
    return mbconv(x.to(torch.bfloat16), prepare_params(p, cfg), cfg)
