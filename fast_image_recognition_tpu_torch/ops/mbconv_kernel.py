"""Fused stride-1 MBConv block (JAX ``ops/mbconv_kernel.py``): the kernel on a
CUDA tensor, ``plain.mbconv_plain`` on a CPU one; its pads, tile plan and
shared memory computed here. NCHW ``channels_last``."""

import functools
from typing import Any, Dict, Tuple

import torch

from ..kernels import build, plain

# must match kernels/mbconv.cu
CS = 64  # hidden channels per slab: one 128-byte line of bf16
LINE = 128
NT_MAX = 3  # project tiles (64 pixels x 64 channels) per warpgroup
WGS = 4  # warpgroups per block
MAX_SMEM = 232448  # dynamic shared memory a Hopper block may opt in to
SMEM_ALIGN = 1024
MAX_TILE = 64


def _same_pads(h: int, k: int, stride: int) -> Tuple[int, int, int]:
    """(out, pad_low, pad_high) of XLA SAME padding along one spatial dim."""
    out = -(-h // stride)
    total = max((out - 1) * stride + k - h, 0)
    low = total // 2
    return out, low, total - low


def _round_up(x: int, m: int) -> int:
    return -(-x // m) * m


def plane_smem(h: int, w: int, k: int, cin: int, ce: int, cout: int, s: int, has_expand: bool, th: int, tw: int,
        group: int, bufs: int, ipb: int) -> int:
    """Shared memory of an ``mbconv.cu`` block for the plan (th, tw, group, bufs, ipb), or -1 where refused (over
    :data:`MAX_SMEM` or :data:`NT_MAX`; two images without one whole-plane tile or at k = 7). ``group``: 64-channel
    project tiles a block; ``bufs``: bit 0 double-buffers the box, bit 1 the weights; ``ipb``: images a block."""
    hh, hw = th + k - 1, tw + k - 1
    halo = hh * hw
    n_tiles = -(-h // th) * -(-w // tw)
    if ipb not in (1, 2) or (ipb > 1 and (n_tiles > 1 or k == 7)):
        return -1
    xplane = has_expand and n_tiles == 1
    rx, ro = _round_up(ipb * (h * w if xplane else halo), 64), _round_up(ipb * th * tw, 64)
    cin_ch, npt = -(-cin // CS), min(group, -(-cout // CS))
    xbufs = 2 if n_tiles > 1 and bufs & 1 else 1
    wbufs = 2 if bufs & 2 else 1
    aux = _round_up((k * k + 2) * CS * 4, 1024)  # a slab's w_dw rows, b_dw and b_exp
    wexp, wproj = wbufs * cin_ch * 64 * LINE if has_expand else 0, wbufs * npt * 64 * LINE
    total = (xbufs * cin_ch * rx * LINE + (max(wexp, wproj) if s > 0 else wexp + wproj) + wbufs * aux
            + (_round_up(ipb * halo * LINE, 1024) if has_expand else 0) + max(ro * LINE, WGS * 4 * ipb * CS * 4)
            + ipb * _round_up(ce, CS) * 4 + ipb * _round_up(s, 32) * 4 + _round_up(cout, CS) * 4 + 4 * 8
            + SMEM_ALIGN)
    if total > MAX_SMEM or -(-(ro // 64 * npt) // WGS) > NT_MAX:
        return -1
    return total


@functools.lru_cache(maxsize=None)
def plane_plan(h: int, w: int, k: int, cin: int, ce: int, cout: int, s: int,
        has_expand: bool) -> Tuple[int, int, int, int, int]:
    """The plan of least estimated work an image, ``groups * n_tiles * (round_up(box rows, 64) + 64) / ipb``, a quarter
    more a single buffer (guessed constants); ties to the larger tile."""
    npt_all = -(-cout // CS)
    best = None
    for group in range(npt_all, 0, -1):
        groups = -(-npt_all // group)
        for ipb in (2, 1):
            for bufs in (3, 2, 1, 0):
                for th in range(1, min(h, MAX_TILE) + 1):
                    for tw in range(1, min(w, MAX_TILE) + 1):
                        if plane_smem(h, w, k, cin, ce, cout, s, has_expand, th, tw, group, bufs, ipb) < 0:
                            continue
                        n_tiles = -(-h // th) * -(-w // tw)
                        rows = ipb * (h * w if has_expand and n_tiles == 1 else (th + k - 1) * (tw + k - 1))
                        exposed = (n_tiles > 1 and not bufs & 1) + (not bufs & 2)
                        cost = groups * n_tiles * (_round_up(rows, 64) + 64) / ipb * (1 + exposed / 4)
                        key = (cost, -th * tw)
                        if best is None or key < best[0]:
                            best = (key, (th, tw, group, bufs, ipb))
        if best is not None and group == npt_all:
            break  # one group fits: never split the output channels
    if best is None:
        raise ValueError(f"no plan of a {h}x{w} plane with k={k}, Cin={cin}, Ce={ce}, Cout={cout} fits "
                f"{MAX_SMEM} bytes")
    return best[1]


def prepare_params(p: Dict[str, Any], cfg: Dict[str, Any], dtype: torch.dtype = torch.bfloat16) -> Dict[str, torch.Tensor]:
    """Folded params -> the layout the kernel and its plain version read (``dw_aux``: a 64-channel slab's taps,
    b_dw, b_exp)."""
    k = cfg["kernel"]
    f32 = torch.float32
    ce = p["w_dw"].shape[-1]
    q: Dict[str, torch.Tensor] = {}
    rows = [p["w_dw"].reshape(k * k, ce).to(f32), p["b_dw"].to(f32)[None]]
    if cfg["has_expand"]:
        q["w_exp_t"] = p["w_exp"].reshape(p["w_exp"].shape[2:]).t().to(dtype).contiguous()
        rows.append(p["b_exp"].to(f32)[None])
    else:
        rows.append(torch.zeros_like(rows[1]))
    nslab = -(-ce // CS)
    aux = torch.nn.functional.pad(torch.cat(rows), (0, nslab * CS - ce))  # [k*k + 2, nslab * 64]
    q["dw_aux"] = aux.reshape(k * k + 2, nslab, CS).permute(1, 0, 2).contiguous()
    if cfg["has_se"]:
        for n in ("w_se1", "b_se1", "w_se2", "b_se2"):
            q[n] = p[n].to(f32).contiguous()
    q["w_proj_t"] = p["w_proj"].reshape(p["w_proj"].shape[2:]).t().to(dtype).contiguous()
    q["b_proj"] = p["b_proj"].to(f32).contiguous()
    return q


def mbconv(x: torch.Tensor, q: Dict[str, torch.Tensor], cfg: Dict[str, Any]) -> torch.Tensor:
    """One stride-1 block on ``x``; a CUDA ``x`` (bf16, channels_last) launches the kernel or raises."""
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
    s = q["w_se1"].shape[1] if "w_se1" in q else 0
    cout, ce = q["w_proj_t"].shape
    plan = plane_plan(h, w, k, x.shape[1], ce, cout, s, "w_exp_t" in q)
    return build.launch_mbconv(x, q, k, (pl_h, pl_w), plan, activation == "relu6", residual)


def fused_mbconv(x: torch.Tensor, p: Dict[str, Any], cfg: Dict[str, Any]) -> torch.Tensor:
    """One folded stride-1 block (``fold_backbone``'s ``p``, ``cfg``) on ``x`` in bf16; stride 2 raises."""
    return mbconv(x.to(torch.bfloat16), prepare_params(p, cfg), cfg)
