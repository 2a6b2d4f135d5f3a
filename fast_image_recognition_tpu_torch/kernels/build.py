"""Build, load and launch the port's CUDA kernels.

Each ``*.cu`` file in this directory exposes ``extern "C"`` launchers that
take raw device pointers, sizes and a ``cudaStream_t`` and return a
``cudaError_t`` value. They are compiled at first use by ``nvcc`` alone
(no ninja, no PyTorch headers) into a shared library under
``fast_image_recognition_tpu_torch/_build/``, named by a hash of the source
and the flags, and loaded with ``ctypes``. A failed build or a non-zero
launch status raises; nothing falls back to the plain versions.

Every launcher wrapper adds one to ``LAUNCHES[name]`` where it launches its
kernel, so a run can show which kernels its main path went through.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
from typing import Dict, Iterable, Optional, Tuple

import torch

from fast_image_recognition_tpu_torch.kernels.plain import TILE_G

KERNEL_DIR = os.path.dirname(os.path.abspath(__file__))
BUILD_DIR = os.path.join(os.path.dirname(KERNEL_DIR), "_build")
SOURCES = {
    "packed_scan": "packed_scan.cu",
    "topk_l2": "topk_l2.cu",
    "tile_scan": "tile_scan.cu",
    "mbconv": "mbconv.cu",
    "chi2": "chi2.cu",
}
NVCC_FLAGS = [
    "-O3",
    "-std=c++17",
    "-gencode=arch=compute_90a,code=sm_90a",
    "-shared",
    "-Xcompiler",
    "-fPIC",
    "-Xptxas",
    "-v",
]

LAUNCHES: Dict[str, int] = {
    "tilemin2_packed": 0,
    "tilemin_packed": 0,
    "topk_l2": 0,
    "topk_l2_windowed": 0,
    "topk_l2_precise": 0,
    "tilemin": 0,
    "tilemin_quant": 0,
    "mbconv": 0,  # two launches per block: expand + depthwise, then SE + project
    "chi2": 0,
}
# ptxas resource lines of the last build of each library (registers,
# shared memory, spills), for the smoke run to print
BUILD_LOG: Dict[str, str] = {}
_LIBS: Dict[str, ctypes.CDLL] = {}


def reset_launch_counts() -> None:
    for k in LAUNCHES:
        LAUNCHES[k] = 0


def _nvcc() -> str:
    path = shutil.which("nvcc") or "/usr/local/cuda/bin/nvcc"
    if not os.path.exists(path):
        raise RuntimeError("nvcc not found: the CUDA kernels cannot be built")
    return path


def _target(name: str) -> str:
    with open(os.path.join(KERNEL_DIR, SOURCES[name]), "rb") as fh:
        h = hashlib.sha256(fh.read() + " ".join(NVCC_FLAGS).encode()).hexdigest()
    return os.path.join(BUILD_DIR, f"{name}-{h[:16]}.so")


def build(names: Optional[Iterable[str]] = None) -> Dict[str, str]:
    """Compile the named sources (default: all) that are not built yet,
    one ``nvcc`` each, all started together. Returns name -> library path."""
    names = list(SOURCES if names is None else names)
    out = {n: _target(n) for n in names}
    todo = [n for n in names if not os.path.exists(out[n])]
    if todo:
        nvcc = _nvcc()
        os.makedirs(BUILD_DIR, exist_ok=True)
    procs = {}
    for n in todo:
        tmp = f"{out[n]}.{os.getpid()}.tmp"
        cmd = [nvcc, *NVCC_FLAGS, "-o", tmp, os.path.join(KERNEL_DIR, SOURCES[n])]
        procs[n] = (tmp, subprocess.Popen(cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True))
    failed = []
    for n, (tmp, p) in procs.items():
        log, _ = p.communicate()
        BUILD_LOG[n] = log
        if p.returncode != 0:
            failed.append(f"{SOURCES[n]}:\n{log}")
        else:
            os.replace(tmp, out[n])
    if failed:
        raise RuntimeError("nvcc failed for " + "\n".join(failed))
    return out


def _lib(name: str) -> ctypes.CDLL:
    if name not in _LIBS:
        lib = ctypes.CDLL(build([name])[name])
        P, I = ctypes.c_void_p, ctypes.c_int
        if name == "packed_scan":
            lib.tilemin2_packed_launch.argtypes = [P, P, P, P, I, I, I, P]
            lib.tilemin2_packed_launch.restype = I
            lib.tilemin_packed_launch.argtypes = [P, P, P, I, I, I, I, P]
            lib.tilemin_packed_launch.restype = I
        elif name == "mbconv":
            lib.mbconv_expand_dw_launch.argtypes = [P] * 7 + [I] * 11 + [P]
            lib.mbconv_expand_dw_launch.restype = I
            lib.mbconv_se_project_launch.argtypes = [P] * 10 + [I] * 6 + [P]
            lib.mbconv_se_project_launch.restype = I
        elif name == "chi2":
            lib.chi2_launch.argtypes = [P, P, I, P, I, I, I, P]
            lib.chi2_launch.restype = I
        elif name == "tile_scan":
            lib.tilemin_launch.argtypes = [P, P, P, P, P, I, I, I, I, I, P]
            lib.tilemin_launch.restype = I
            lib.tilemin_quant_launch.argtypes = [P, P, P, P, P, P, P, I, I, I, I, I, P]
            lib.tilemin_quant_launch.restype = I
        else:
            lib.topk_l2_launch.argtypes = [P, P, P, P, P, P, P, I, I, I, I, I, I, I, I, P]
            lib.topk_l2_launch.restype = I
            lib.topk_l2_precise_launch.argtypes = [P, P, I, P, P, P, P, I, I, I, I, I, I, I, I, P]
            lib.topk_l2_precise_launch.restype = I
            lib.topk_l2_segment_rows.argtypes = []
            lib.topk_l2_segment_rows.restype = I
            lib.topk_l2_list_len.argtypes = [I]
            lib.topk_l2_list_len.restype = I
        _LIBS[name] = lib
    return _LIBS[name]


def _check(t: torch.Tensor, what: str, dtype: torch.dtype, ndim: int) -> None:
    if t.device.type != "cuda":
        raise ValueError(f"{what} must be a CUDA tensor, got {t.device}")
    if t.dtype != dtype or t.dim() != ndim:
        raise ValueError(f"{what} must be {ndim}-d {dtype}, got {t.dim()}-d {t.dtype}")
    if not t.is_contiguous() or t.data_ptr() % 16:
        raise ValueError(f"{what} must be contiguous and 16-byte aligned")


def _raise_on(status: int, what: str) -> None:
    if status != 0:
        raise RuntimeError(f"{what} launch failed with cudaError_t {status}")


def _check_packed(q_aug: torch.Tensor, g_aug: torch.Tensor, tile_g: int) -> int:
    """Validate a packed scan's operands; returns the number of tiles."""
    _check(q_aug, "q_aug", torch.bfloat16, 2)
    _check(g_aug, "g_aug", torch.bfloat16, 2)
    da = q_aug.shape[1]
    if g_aug.shape[0] % tile_g or g_aug.shape[1] != da or da % 16:
        raise ValueError(
            f"packed scan takes whole {tile_g}-row tiles and Da % 16 == 0; got "
            f"q_aug {tuple(q_aug.shape)}, g_aug {tuple(g_aug.shape)}"
        )
    if q_aug.device != g_aug.device:
        raise ValueError("q_aug and g_aug are on different devices")
    return g_aug.shape[0] // tile_g


def launch_tilemin2_packed(q_aug: torch.Tensor, g_aug: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """``kernels/packed_scan.cu``: per (query, 1024-row tile) min and
    second-min packed keys, ``[B, n_tiles]`` int32 each."""
    n_tiles = _check_packed(q_aug, g_aug, TILE_G)
    b, da = q_aug.shape
    k1 = torch.empty((b, n_tiles), dtype=torch.int32, device=q_aug.device)
    k2 = torch.empty_like(k1)
    lib = _lib("packed_scan")
    with torch.cuda.device(q_aug.device):
        stream = torch.cuda.current_stream().cuda_stream
        _raise_on(
            lib.tilemin2_packed_launch(
                q_aug.data_ptr(), g_aug.data_ptr(), k1.data_ptr(), k2.data_ptr(),
                b, n_tiles, da, stream,
            ),
            "tilemin2_packed",
        )
    LAUNCHES["tilemin2_packed"] += 1
    return k1, k2


def launch_tilemin_packed(q_aug: torch.Tensor, g_aug: torch.Tensor, tile_g: int) -> torch.Tensor:
    """``kernels/packed_scan.cu``: per (query, ``tile_g``-row tile) min
    packed key, ``[B, n_tiles]`` int32; ``tile_g`` is 128, 256, 512 or 1024."""
    if tile_g not in (128, 256, 512, 1024):
        raise ValueError(f"tile_g must be 128, 256, 512 or 1024, got {tile_g}")
    n_tiles = _check_packed(q_aug, g_aug, tile_g)
    b, da = q_aug.shape
    keys = torch.empty((b, n_tiles), dtype=torch.int32, device=q_aug.device)
    lib = _lib("packed_scan")
    with torch.cuda.device(q_aug.device):
        stream = torch.cuda.current_stream().cuda_stream
        _raise_on(
            lib.tilemin_packed_launch(
                q_aug.data_ptr(), g_aug.data_ptr(), keys.data_ptr(), b, n_tiles, da, tile_g, stream,
            ),
            "tilemin_packed",
        )
    LAUNCHES["tilemin_packed"] += 1
    return keys


def launch_topk_l2(
    q: torch.Tensor,
    g: torch.Tensor,
    k: int,
    n_valid: int,
    window: Optional[Tuple[int, int]] = None,
    precise: bool = False,
    row_mask: Optional[torch.Tensor] = None,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """``kernels/topk_l2.cu``: exact top-k raw squared L2 distances
    ``[B, k]`` fp32 and row indices ``[B, k]`` int32 (-1 past n_valid).
    bf16 queries and rows on the tensor cores, or with ``precise`` fp32
    queries against fp32 or bf16 rows on the CUDA cores. ``window=(start,
    end)`` scans the feature lanes [start, end) only. Query rows where the
    bool ``row_mask`` is False come back empty ``(BIG_DIST, -1)`` (not with
    ``precise``)."""
    _check(q, "queries", torch.float32 if precise else torch.bfloat16, 2)
    if precise:
        if g.dtype not in (torch.float32, torch.bfloat16):
            raise ValueError(f"gallery must be fp32 or bf16, got {g.dtype}")
        _check(g, "gallery", g.dtype, 2)
    else:
        _check(g, "gallery", torch.bfloat16, 2)
    b, d = q.shape
    n = g.shape[0]
    start, end = (0, d) if window is None else (int(window[0]), int(window[1]))
    if g.shape[1] != d or d % 8 or not 1 <= k <= 16 or not 0 < n_valid <= n or not 0 <= start < end <= d:
        raise ValueError(
            f"topk_l2 kernel takes D % 8 == 0, 1 <= k <= 16, 0 < n_valid <= N, 0 <= start < end <= D; "
            f"got queries {tuple(q.shape)}, gallery {tuple(g.shape)}, k={k}, n_valid={n_valid}, "
            f"window {window}"
        )
    if q.device != g.device:
        raise ValueError("queries and gallery are on different devices")
    mask_ptr = None
    if row_mask is not None:
        if precise:
            raise ValueError("row_mask is not taken with precise=True")
        if row_mask.shape != (b,) or row_mask.dtype != torch.bool or row_mask.device != q.device:
            raise ValueError("row_mask must be a [B] bool tensor on the queries' device")
        row_mask = row_mask.contiguous()  # bool is one byte: read as uint8
        mask_ptr = row_mask.data_ptr()
    lib = _lib("topk_l2")
    seg = lib.topk_l2_segment_rows()
    n_seg = -(-n_valid // seg)
    kk = lib.topk_l2_list_len(k)
    part_d = torch.empty((b, n_seg, kk), dtype=torch.float32, device=q.device)
    part_i = torch.empty((b, n_seg, kk), dtype=torch.int32, device=q.device)
    out_d = torch.empty((b, k), dtype=torch.float32, device=q.device)
    out_i = torch.empty((b, k), dtype=torch.int32, device=q.device)
    sizes = (b, n, n_valid, d, k, n_seg, start, end)
    with torch.cuda.device(q.device):
        stream = torch.cuda.current_stream().cuda_stream
        if precise:
            status = lib.topk_l2_precise_launch(
                q.data_ptr(), g.data_ptr(), int(g.dtype == torch.float32), part_d.data_ptr(),
                part_i.data_ptr(), out_d.data_ptr(), out_i.data_ptr(), *sizes, stream,
            )
        else:
            status = lib.topk_l2_launch(
                q.data_ptr(), g.data_ptr(), mask_ptr, part_d.data_ptr(), part_i.data_ptr(),
                out_d.data_ptr(), out_i.data_ptr(), *sizes, stream,
            )
    name = "topk_l2_precise" if precise else "topk_l2" if window is None else "topk_l2_windowed"
    _raise_on(status, name)
    LAUNCHES[name] += 1
    return out_d, out_i


def _check_scan(q: torch.Tensor, g: torch.Tensor, dtype: torch.dtype, vec: int, tile_g: int) -> int:
    """Validate a tile scan's operands; returns the number of tiles."""
    if tile_g not in (128, 256, 512, 1024):
        raise ValueError(f"tile_g must be 128, 256, 512 or 1024, got {tile_g}")
    _check(q, "queries", dtype, 2)
    _check(g, "gallery", dtype, 2)
    d = q.shape[1]
    if g.shape[0] % tile_g or g.shape[1] != d or d % vec:
        raise ValueError(
            f"tile scan takes whole {tile_g}-row tiles and D % {vec} == 0; got "
            f"queries {tuple(q.shape)}, gallery {tuple(g.shape)}"
        )
    if q.device != g.device:
        raise ValueError("queries and gallery are on different devices")
    return g.shape[0] // tile_g


def _check_rows(t: torch.Tensor, what: str, n_rows: int, device: torch.device) -> None:
    _check(t, what, torch.float32, t.dim())
    if t.numel() < n_rows or t.device != device:
        raise ValueError(f"{what} must hold >= {n_rows} fp32 values on {device}")


def launch_tilemin(
    q: torch.Tensor, g: torch.Tensor, gsq: torch.Tensor, tile_g: int, bf16_scores: bool
) -> Tuple[torch.Tensor, torch.Tensor]:
    """``kernels/tile_scan.cu``: per (query, tile) min of ``|g|^2 - 2 q.g``
    and the lowest row at it, ``[B, n_tiles]`` fp32 and int32 (global
    rows). ``gsq`` holds |g|^2 in row order (the ``gallery_sq_norms``
    layout), BIG_DIST on pad rows."""
    n_tiles = _check_scan(q, g, torch.bfloat16, 8, tile_g)
    _check_rows(gsq, "gsq", g.shape[0], q.device)
    b, d = q.shape
    out_d = torch.empty((b, n_tiles), dtype=torch.float32, device=q.device)
    out_i = torch.empty((b, n_tiles), dtype=torch.int32, device=q.device)
    lib = _lib("tile_scan")
    with torch.cuda.device(q.device):
        stream = torch.cuda.current_stream().cuda_stream
        _raise_on(
            lib.tilemin_launch(
                q.data_ptr(), g.data_ptr(), gsq.data_ptr(), out_d.data_ptr(), out_i.data_ptr(),
                b, n_tiles, d, tile_g, int(bf16_scores), stream,
            ),
            "tilemin",
        )
    LAUNCHES["tilemin"] += 1
    return out_d, out_i


def launch_tilemin_quant(
    q: torch.Tensor,
    qs: torch.Tensor,
    g: torch.Tensor,
    gsq: torch.Tensor,
    gsc: torch.Tensor,
    tile_g: int,
    compute: str,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """``kernels/tile_scan.cu``: per (query, tile) min of ``gsq - (2 s_q)
    (q.g s_g)`` over int8 queries and rows and the lowest row at it,
    ``[B, n_tiles]`` fp32 and int32. ``compute`` is ``'int8'`` (int32 dot)
    or ``'bf16'`` (bf16 products summed in fp32)."""
    if compute not in ("int8", "bf16"):
        raise ValueError(f"compute must be 'int8' or 'bf16', got {compute!r}")
    n_tiles = _check_scan(q, g, torch.int8, 16, tile_g)
    b, d = q.shape
    _check_rows(qs, "qs", b, q.device)
    _check_rows(gsq, "gsq", g.shape[0], q.device)
    _check_rows(gsc, "gsc", g.shape[0], q.device)
    out_d = torch.empty((b, n_tiles), dtype=torch.float32, device=q.device)
    out_i = torch.empty((b, n_tiles), dtype=torch.int32, device=q.device)
    lib = _lib("tile_scan")
    with torch.cuda.device(q.device):
        stream = torch.cuda.current_stream().cuda_stream
        _raise_on(
            lib.tilemin_quant_launch(
                q.data_ptr(), qs.data_ptr(), g.data_ptr(), gsq.data_ptr(), gsc.data_ptr(),
                out_d.data_ptr(), out_i.data_ptr(), b, n_tiles, d, tile_g, int(compute == "int8"),
                stream,
            ),
            "tilemin_quant",
        )
    LAUNCHES["tilemin_quant"] += 1
    return out_d, out_i


def launch_mbconv(
    x: torch.Tensor,
    q: Dict[str, torch.Tensor],
    kernel: int,
    pad_low: Tuple[int, int],
    tile: Tuple[int, int],
    relu6: bool,
    residual: bool,
) -> torch.Tensor:
    """``kernels/mbconv.cu``: one stride-1 MBConv block on ``x`` [B, Cin,
    H, W] bf16 in channels_last memory, params ``q`` in the
    ``ops.mbconv_kernel.prepare_params`` layout, SAME ``pad_low`` (H, W)
    and the first launch's output ``tile`` (th, tw). Two launches, each
    counted under ``mbconv``. Returns [B, Cout, H, W] bf16 channels_last."""
    if x.device.type != "cuda":
        raise ValueError(f"x must be a CUDA tensor, got {x.device}")
    if x.dtype != torch.bfloat16 or x.dim() != 4:
        raise ValueError(f"x must be 4-d bf16, got {x.dim()}-d {x.dtype}")
    if not x.is_contiguous(memory_format=torch.channels_last) or x.data_ptr() % 16:
        raise ValueError("x must be channels_last contiguous and 16-byte aligned")
    b, cin, h, w = x.shape
    has_expand, has_se = "w_exp" in q, "w_se1" in q
    ce = q["w_dw"].shape[1]
    cout = q["w_proj"].shape[1]
    s = q["w_se1"].shape[1] if has_se else 0
    want = {"w_dw": ((kernel * kernel, ce), torch.float32), "b_dw": ((ce,), torch.float32),
            "w_proj": ((ce, cout), torch.bfloat16), "b_proj": ((cout,), torch.float32)}
    if has_expand:
        want.update(w_exp=((cin, ce), torch.bfloat16), b_exp=((ce,), torch.float32))
    if has_se:
        want.update(w_se1=((ce, s), torch.float32), b_se1=((s,), torch.float32),
                    w_se2=((s, ce), torch.float32), b_se2=((ce,), torch.float32))
    for n, (shape, dtype) in want.items():
        _check(q[n], n, dtype, len(shape))
        if tuple(q[n].shape) != shape or q[n].device != x.device:
            raise ValueError(f"{n} must be {shape} on {x.device}, got {tuple(q[n].shape)} on {q[n].device}")
    if (cin % 8 or ce % 8 or cout % 8 or kernel not in (3, 5, 7) or (not has_expand and cin != ce)
            or (residual and cin != cout) or not 1 <= b <= 65535):
        raise ValueError(
            f"mbconv kernel takes Cin, Ce, Cout % 8 == 0, k in (3, 5, 7), Cin == Ce without expand, "
            f"Cin == Cout with residual, 1 <= B <= 65535; got x {tuple(x.shape)}, Ce={ce}, Cout={cout}, k={kernel}"
        )
    th, tw = tile
    n_tiles = -(-h // th) * -(-w // tw)
    dw = torch.empty((b, h, w, ce), dtype=torch.bfloat16, device=x.device)
    part = torch.empty((b, n_tiles, ce), dtype=torch.float32, device=x.device)
    out = torch.empty((b, cout, h, w), dtype=torch.bfloat16, device=x.device, memory_format=torch.channels_last)

    def ptr(n: str) -> Optional[int]:
        return q[n].data_ptr() if n in q else None

    lib = _lib("mbconv")
    with torch.cuda.device(x.device):
        stream = torch.cuda.current_stream().cuda_stream
        _raise_on(
            lib.mbconv_expand_dw_launch(
                x.data_ptr(), ptr("w_exp"), ptr("b_exp"), q["w_dw"].data_ptr(), q["b_dw"].data_ptr(),
                dw.data_ptr(), part.data_ptr(), b, h, w, cin, ce, kernel, pad_low[0], pad_low[1], th, tw,
                int(relu6), stream,
            ),
            "mbconv_expand_dw",
        )
        LAUNCHES["mbconv"] += 1
        _raise_on(
            lib.mbconv_se_project_launch(
                dw.data_ptr(), part.data_ptr(), ptr("w_se1"), ptr("b_se1"), ptr("w_se2"), ptr("b_se2"),
                q["w_proj"].data_ptr(), q["b_proj"].data_ptr(), x.data_ptr() if residual else None,
                out.data_ptr(), b, h * w, ce, cout, s, n_tiles, stream,
            ),
            "mbconv_se_project",
        )
        LAUNCHES["mbconv"] += 1
    return out


def launch_chi2(q: torch.Tensor, g: torch.Tensor, n_valid: int) -> Tuple[torch.Tensor, torch.Tensor]:
    """``kernels/chi2.cu``: per query the least ``sum (g - q)^2 *
    rcp(max(g + q, 1e-30))`` over rows [0, n_valid) and the lowest row at
    it: (min [B] fp32, unnormalized; row [B] int32). ``q`` [B, D] fp32,
    ``g`` [N, D] fp32 or bf16. One launch whatever B is."""
    for t, what in ((q, "queries"), (g, "gallery")):
        if t.device.type != "cuda":
            raise ValueError(f"{what} must be a CUDA tensor, got {t.device}")
        if t.dim() != 2 or not t.is_contiguous():
            raise ValueError(f"{what} must be a contiguous 2-d tensor")
    if q.dtype != torch.float32 or g.dtype not in (torch.float32, torch.bfloat16):
        raise ValueError(f"chi2 takes fp32 queries and an fp32 or bf16 gallery, got {q.dtype}, {g.dtype}")
    b, d = q.shape
    n = g.shape[0]
    if b < 1 or d < 1 or g.shape[1] != d or not 0 < n_valid <= n:
        raise ValueError(
            f"chi2 kernel takes B, D >= 1 and 0 < n_valid <= N; got queries {tuple(q.shape)}, "
            f"gallery {tuple(g.shape)}, n_valid={n_valid}"
        )
    if q.device != g.device:
        raise ValueError("queries and gallery are on different devices")
    # all bits set: the kernel's atomicMin keeps the least (distance bits, row) key
    keys = torch.full((b,), -1, dtype=torch.int64, device=q.device)
    lib = _lib("chi2")
    with torch.cuda.device(q.device):
        stream = torch.cuda.current_stream().cuda_stream
        _raise_on(
            lib.chi2_launch(
                q.data_ptr(), g.data_ptr(), int(g.dtype == torch.float32), keys.data_ptr(), b, int(n_valid), d,
                stream,
            ),
            "chi2",
        )
    LAUNCHES["chi2"] += 1
    # distances are >= 0, so the key's high word is the fp32 bits of the min
    dist = (keys >> 32).to(torch.int32).view(torch.float32)
    rows = (keys & 0xFFFFFFFF).to(torch.int32)
    return dist, rows
