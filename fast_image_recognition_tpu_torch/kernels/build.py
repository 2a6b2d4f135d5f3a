"""Build, load and launch the port's CUDA kernels.

Each ``*.cu`` file in this directory exposes ``extern "C"`` launchers that
take raw device pointers, sizes and a ``cudaStream_t`` and return a
``cudaError_t`` value. They are compiled at first use by ``nvcc`` alone
(no ninja, no PyTorch headers) into a shared library under
``fast_image_recognition_tpu_torch/_build/``, named by a hash of the source,
the headers beside it (``*.cuh``, e.g. the Hopper main loop
``sm90_scan.cuh``) and the flags, and loaded with ``ctypes``. A failed build or a non-zero
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
import threading
import time
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
    "--split-compile=0",  # optimize a source's kernels on every core
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
    "topk_l2_precise": 0,  # over bf16 rows
    "topk_l2_precise_f32": 0,  # over fp32 rows
    "tilemin": 0,
    "tilemin_quant": 0,
    "mbconv": 0,  # one launch per block
    "chi2": 0,
}
# ptxas resource lines of the last build of each library (registers,
# shared memory, spills) and its seconds, for the smoke run to print
BUILD_LOG: Dict[str, str] = {}
BUILD_SECONDS: Dict[str, float] = {}
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
    """Library path keyed by the source, every header of the directory
    (a header edit must not load a stale library) and the flags."""
    h = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    headers = sorted(f for f in os.listdir(KERNEL_DIR) if f.endswith(".cuh"))
    for f in [SOURCES[name], *headers]:
        with open(os.path.join(KERNEL_DIR, f), "rb") as fh:
            h.update(f.encode() + b"\0" + fh.read())
    return os.path.join(BUILD_DIR, f"{name}-{h.hexdigest()[:16]}.so")


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
    t0 = time.time()
    for n in todo:
        tmp = f"{out[n]}.{os.getpid()}.tmp"
        cmd = [nvcc, *NVCC_FLAGS, "-o", tmp, os.path.join(KERNEL_DIR, SOURCES[n])]
        procs[n] = (tmp, subprocess.Popen(cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True))

    def wait(n, p):  # each source's own seconds
        BUILD_LOG[n], BUILD_SECONDS[n] = p.communicate()[0], time.time() - t0

    waits = [threading.Thread(target=wait, args=(n, p)) for n, (_, p) in procs.items()]
    for w in waits:
        w.start()
    for w in waits:
        w.join()
    failed = []
    for n, (tmp, p) in procs.items():
        if p.returncode != 0:
            failed.append(f"{SOURCES[n]}:\n{BUILD_LOG[n]}")
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
            lib.mbconv_launch.argtypes = [P] * 11 + [I] * 17 + [P]
            lib.mbconv_launch.restype = I
            lib.mbconv_smem.argtypes = [I] * 13
            lib.mbconv_smem.restype = I
        elif name == "chi2":
            lib.chi2_launch.argtypes = [P, P, I, P, I, I, I, P]
            lib.chi2_launch.restype = I
        elif name == "tile_scan":
            lib.tilemin_launch.argtypes = [P, P, P, P, P, I, I, I, I, I, P]
            lib.tilemin_launch.restype = I
            lib.tilemin_quant_launch.argtypes = [P, P, P, P, P, P, P, I, I, I, I, I, P]
            lib.tilemin_quant_launch.restype = I
        else:
            lib.topk_l2_launch.argtypes = [P] * 9 + [I] * 8 + [P]
            lib.topk_l2_launch.restype = I
            lib.topk_l2_precise_launch.argtypes = [P, P, I] + [P] * 8 + [I] * 8 + [P]
            lib.topk_l2_precise_launch.restype = I
            lib.topk_l2_split_smem.argtypes = [I]
            lib.topk_l2_split_smem.restype = I
            lib.topk_l2_split6_smem.argtypes = [I]
            lib.topk_l2_split6_smem.restype = I
            lib.topk_l2_segment_rows.argtypes = [I, I]
            lib.topk_l2_segment_rows.restype = I
            lib.topk_l2_query_rows.argtypes = []
            lib.topk_l2_query_rows.restype = I
            lib.topk_l2_list_len.argtypes = [I]
            lib.topk_l2_list_len.restype = I
            lib.topk_l2_max_k.argtypes = []
            lib.topk_l2_max_k.restype = I
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


def topk_l2_query_rows() -> int:
    """Queries per bf16 pass-1 block of ``kernels/topk_l2.cu``: a row mask
    skips the blocks that hold no masked query."""
    return _lib("topk_l2").topk_l2_query_rows()


# The kernels index gallery rows with int32 and keep some headroom past the
# last row (a sub-tile or segment of rows): the same limit as the JAX
# package's int32 row indices.
MAX_ROWS = 2**31 - 1 - 2048
TOPK_MAX_K = 256  # kernels/topk_l2.cu MAX_K: lists of up to 256 (query, segment) entries
TOPK_QUERY_ROWS = 128  # kernels/topk_l2.cu QT: queries per pass-1 block and per split-plane box


def topk_l2_split_plane_rows(b: int) -> int:
    """Rows of each of the three bf16 query planes of the split precise
    pass: B rounded up to whole 128-query boxes, so that no box straddles
    two planes."""
    return -(-b // TOPK_QUERY_ROWS) * TOPK_QUERY_ROWS


def topk_l2_split_smem_for(k: int) -> int:
    """Dynamic shared memory of ``kernels/topk_l2.cu``'s split precise pass
    over bf16 rows (``SplitTile``): a ring of stages holding three query
    planes and one gallery box (3 stages, 2 for k > 16, whose distance tile
    and lists' last entries need room), two |g|^2 buffers and the
    barriers."""
    line, qt, bn = 128, TOPK_QUERY_ROWS, 128
    lists = k > 16
    stages = 2 if lists else 3
    ring = stages * (3 * qt * line + bn * line)
    return 1024 + ring + 2 * bn * 4 + ((qt * (bn + 8) + 2 * qt) * 4 if lists else 0) + 2 * stages * 8


def topk_l2_split6_smem_for(k: int) -> int:
    """Dynamic shared memory of ``kernels/topk_l2.cu``'s six-product precise
    pass over fp32 rows (``Split6Tile``), 32-feature chunks: a ring of
    stages of three query and three row planes (64-byte lines; 3 stages, 2
    for k > 16), a ring of fp32 row boxes ([128 x 32]; 4 boxes, 3 for k >
    16), |g|^2 buffers for one sub-tile more than the stages, for k > 16
    the distance tile and the lists' last entries, and the barriers."""
    line, qt, bn = 64, TOPK_QUERY_ROWS, 128
    lists = k > 16
    stages, boxes = (2, 3) if lists else (3, 4)
    ring = stages * (3 * qt * line + 3 * bn * line)
    return (1024 + ring + boxes * bn * 128 + (stages + 1) * bn * 4
            + ((qt * (bn + 8) + 2 * qt) * 4 if lists else 0) + (2 * stages + boxes) * 8)


def topk_l2_segment_rows_for(precise: bool, k: int) -> int:
    """Gallery rows per ``topk_l2`` pass-1 block, as ``kernels/topk_l2.cu``
    ``segment_rows`` gives them: 2,048 for the bf16 register-list pass,
    8,192 for ``precise`` and for k > 16."""
    return 8192 if precise or k > 16 else 2048


def packed_scan_tiles(q_shape: Tuple[int, int], g_shape: Tuple[int, int], tile_g: int) -> int:
    """The packed scans' shape rules (``kernels/packed_scan.cu``), without a
    card: returns the number of tiles or raises. Any augmented width Da (a
    multiple of 16) and any number of whole tiles up to :data:`MAX_ROWS`."""
    (b, da), (np_, g_da) = q_shape, g_shape
    if tile_g not in (128, 256, 512, 1024):
        raise ValueError(f"tile_g must be 128, 256, 512 or 1024, got {tile_g}")
    if b < 1 or np_ < tile_g or np_ % tile_g or g_da != da or da < 16 or da % 16 or np_ > MAX_ROWS:
        raise ValueError(
            f"packed scan takes whole {tile_g}-row tiles (at most {MAX_ROWS} rows) and Da % 16 == 0; got "
            f"q_aug {tuple(q_shape)}, g_aug {tuple(g_shape)}"
        )
    return np_ // tile_g


def _check_packed(q_aug: torch.Tensor, g_aug: torch.Tensor, tile_g: int) -> int:
    """Validate a packed scan's operands; returns the number of tiles."""
    _check(q_aug, "q_aug", torch.bfloat16, 2)
    _check(g_aug, "g_aug", torch.bfloat16, 2)
    if q_aug.device != g_aug.device:
        raise ValueError("q_aug and g_aug are on different devices")
    return packed_scan_tiles(tuple(q_aug.shape), tuple(g_aug.shape), tile_g)


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


def topk_l2_args(
    q_shape: Tuple[int, int], g_shape: Tuple[int, int], k: int, n_valid: int, window: Optional[Tuple[int, int]],
    precise: bool = False,
) -> Tuple[int, int]:
    """``kernels/topk_l2.cu``'s argument rules, without a card: returns the
    window ``(start, end)`` or raises. Any k up to :data:`TOPK_MAX_K`; rows
    up to int32 less one segment of the mode
    (:func:`topk_l2_segment_rows_for`), the launcher's own limit."""
    (b, d), (n, g_d) = q_shape, g_shape
    start, end = (0, d) if window is None else (int(window[0]), int(window[1]))
    max_rows = 2**31 - 1 - topk_l2_segment_rows_for(precise, k)
    if (b < 1 or g_d != d or d % 8 or not 1 <= k <= TOPK_MAX_K or not 0 < n_valid <= n or n_valid > max_rows
            or not 0 <= start < end <= d):
        raise ValueError(
            f"topk_l2 kernel takes D % 8 == 0, 1 <= k <= {TOPK_MAX_K}, 0 < n_valid <= N (at most {max_rows}), "
            f"0 <= start < end <= D; got queries {tuple(q_shape)}, gallery {tuple(g_shape)}, k={k}, "
            f"n_valid={n_valid}, window {window}"
        )
    return start, end


def launch_topk_l2(
    q: torch.Tensor,
    g: torch.Tensor,
    k: int,
    n_valid: int,
    window: Optional[Tuple[int, int]] = None,
    precise: bool = False,
    row_mask: Optional[torch.Tensor] = None,
    floor: Optional[Tuple[torch.Tensor, torch.Tensor]] = None,
    split_out: Optional[Dict[str, torch.Tensor]] = None,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """``kernels/topk_l2.cu``: exact top-k raw squared L2 distances
    ``[B, k]`` fp32 and row indices ``[B, k]`` int32 (-1 past n_valid).
    bf16 queries and rows on the tensor cores; with ``precise`` fp32
    queries split into three bf16 terms, against bf16 rows as three bf16
    products on the tensor cores, against fp32 rows (split the same way on
    the chip) as six, counted as ``topk_l2_precise`` and
    ``topk_l2_precise_f32``. ``window=(start, end)`` scans
    the feature lanes [start, end) only. Query rows where the bool
    ``row_mask`` is False come back empty ``(BIG_DIST, -1)`` (not with
    ``precise``). ``floor=(d [B] fp32, row [B] int32)``, for k > 16 only:
    the last entry of the previous slab of a larger top-k (row -1: empty);
    only (distance, row) strictly after it enter. ``split_out``, a dict,
    receives the split pass's ``planes`` [3, round_up(B, 128), D] bf16 and
    ``qsq`` [B] fp32 (precise), for a check to read back."""
    _check(q, "queries", torch.float32 if precise else torch.bfloat16, 2)
    if precise:
        if g.dtype not in (torch.float32, torch.bfloat16):
            raise ValueError(f"gallery must be fp32 or bf16, got {g.dtype}")
        _check(g, "gallery", g.dtype, 2)
    else:
        _check(g, "gallery", torch.bfloat16, 2)
    b, d = q.shape
    n = g.shape[0]
    start, end = topk_l2_args(tuple(q.shape), tuple(g.shape), k, n_valid, window, precise)
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
    floor_d = floor_i = None
    if floor is not None:
        if k <= 16:
            raise ValueError(f"a slab floor is taken with k > 16 only, got k={k}")
        floor_d, floor_i = floor
        if floor_d.shape != (b,) or floor_i.shape != (b,) or floor_d.device != q.device or floor_i.device != q.device:
            raise ValueError("floor must be two [B] tensors on the queries' device")
        floor_d = floor_d.to(torch.float32).contiguous()
        floor_i = torch.where(floor_i < 0, 2**31 - 1, floor_i).to(torch.int32).contiguous()  # empty: nothing after
    lib = _lib("topk_l2")
    seg = lib.topk_l2_segment_rows(int(precise), k)
    n_seg = -(-n_valid // seg)
    kk = lib.topk_l2_list_len(k)
    part_d = torch.empty((b, n_seg, kk), dtype=torch.float32, device=q.device)
    part_i = torch.empty((b, n_seg, kk), dtype=torch.int32, device=q.device)
    out_d = torch.empty((b, k), dtype=torch.float32, device=q.device)
    out_i = torch.empty((b, k), dtype=torch.int32, device=q.device)
    sizes = (b, n, n_valid, d, k, n_seg, start, end)
    floor_ptrs = (None, None) if floor is None else (floor_d.data_ptr(), floor_i.data_ptr())
    with torch.cuda.device(q.device):
        stream = torch.cuda.current_stream().cuda_stream
        if precise:  # the three bf16 query planes and |q|^2 of the split passes
            planes = torch.empty((3, topk_l2_split_plane_rows(b), d), dtype=torch.bfloat16, device=q.device)
            qsq = torch.empty((b,), dtype=torch.float32, device=q.device)
            status = lib.topk_l2_precise_launch(
                q.data_ptr(), g.data_ptr(), int(g.dtype == torch.float32), planes.data_ptr(), qsq.data_ptr(),
                *floor_ptrs, part_d.data_ptr(), part_i.data_ptr(), out_d.data_ptr(), out_i.data_ptr(), *sizes, stream,
            )
            if split_out is not None:
                split_out.update(planes=planes, qsq=qsq)
        else:
            status = lib.topk_l2_launch(
                q.data_ptr(), g.data_ptr(), mask_ptr, *floor_ptrs, part_d.data_ptr(), part_i.data_ptr(),
                out_d.data_ptr(), out_i.data_ptr(), *sizes, stream,
            )
    if precise:
        name = "topk_l2_precise_f32" if g.dtype == torch.float32 else "topk_l2_precise"
    else:
        name = "topk_l2" if window is None else "topk_l2_windowed"
    _raise_on(status, name)
    LAUNCHES[name] += 1
    return out_d, out_i


def tile_scan_tiles(q_shape: Tuple[int, int], g_shape: Tuple[int, int], vec: int, tile_g: int) -> int:
    """The tile scans' shape rules (``kernels/tile_scan.cu``), without a
    card: returns the number of tiles or raises. D a multiple of ``vec``
    (8 bf16 or 16 int8 lanes) and any number of whole tiles up to
    :data:`MAX_ROWS`."""
    (b, d), (np_, g_d) = q_shape, g_shape
    if tile_g not in (128, 256, 512, 1024):
        raise ValueError(f"tile_g must be 128, 256, 512 or 1024, got {tile_g}")
    if b < 1 or np_ < tile_g or np_ % tile_g or g_d != d or d < vec or d % vec or np_ > MAX_ROWS:
        raise ValueError(
            f"tile scan takes whole {tile_g}-row tiles (at most {MAX_ROWS} rows) and D % {vec} == 0; got "
            f"queries {tuple(q_shape)}, gallery {tuple(g_shape)}"
        )
    return np_ // tile_g


def _check_scan(q: torch.Tensor, g: torch.Tensor, dtype: torch.dtype, vec: int, tile_g: int) -> int:
    """Validate a tile scan's operands; returns the number of tiles."""
    _check(q, "queries", dtype, 2)
    _check(g, "gallery", dtype, 2)
    if q.device != g.device:
        raise ValueError("queries and gallery are on different devices")
    return tile_scan_tiles(tuple(q.shape), tuple(g.shape), vec, tile_g)


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
    or ``'bf16'`` (bf16 products summed in fp32; the queries go to the
    kernel as bf16, converted here, exactly, once per call)."""
    if compute not in ("int8", "bf16"):
        raise ValueError(f"compute must be 'int8' or 'bf16', got {compute!r}")
    n_tiles = _check_scan(q, g, torch.int8, 16, tile_g)
    b, d = q.shape
    _check_rows(qs, "qs", b, q.device)
    _check_rows(gsq, "gsq", g.shape[0], q.device)
    _check_rows(gsc, "gsc", g.shape[0], q.device)
    out_d = torch.empty((b, n_tiles), dtype=torch.float32, device=q.device)
    out_i = torch.empty((b, n_tiles), dtype=torch.int32, device=q.device)
    if compute == "bf16":
        q = q.to(torch.bfloat16)
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
    plan: Tuple[int, int, int, int, int],
    relu6: bool,
    residual: bool,
) -> torch.Tensor:
    """``kernels/mbconv.cu``: one stride-1 MBConv block on ``x`` [B, Cin,
    H, W] bf16 in channels_last memory, params ``q`` in the
    ``ops.mbconv_kernel.prepare_params`` layout, SAME ``pad_low`` (H, W)
    and the ``plan`` (th, tw, group, bufs, ipb) of
    ``ops.mbconv_kernel.plane_plan``: the output tile each block walks its
    images in, the output-channel tiles a block owns, the double buffers,
    the images a block takes. One launch, counted under ``mbconv``.
    Returns [B, Cout, H, W] bf16 channels_last."""
    if x.device.type != "cuda":
        raise ValueError(f"x must be a CUDA tensor, got {x.device}")
    if x.dtype != torch.bfloat16 or x.dim() != 4:
        raise ValueError(f"x must be 4-d bf16, got {x.dim()}-d {x.dtype}")
    if not x.is_contiguous(memory_format=torch.channels_last) or x.data_ptr() % 16:
        raise ValueError("x must be channels_last contiguous and 16-byte aligned")
    b, cin, h, w = x.shape
    has_expand, has_se = "w_exp_t" in q, "w_se1" in q
    ce = q["w_proj_t"].shape[1]
    cout = q["w_proj_t"].shape[0]
    s = q["w_se1"].shape[1] if has_se else 0
    want = {"dw_aux": ((-(-ce // 64), kernel * kernel + 2, 64), torch.float32),
            "w_proj_t": ((cout, ce), torch.bfloat16), "b_proj": ((cout,), torch.float32)}
    if has_expand:
        want.update(w_exp_t=((ce, cin), torch.bfloat16))
    if has_se:
        want.update(w_se1=((ce, s), torch.float32), b_se1=((s,), torch.float32),
                    w_se2=((s, ce), torch.float32), b_se2=((ce,), torch.float32))
    for n, (shape, dtype) in want.items():
        _check(q[n], n, dtype, len(shape))
        if tuple(q[n].shape) != shape or q[n].device != x.device:
            raise ValueError(f"{n} must be {shape} on {x.device}, got {tuple(q[n].shape)} on {q[n].device}")
    th, tw, group, bufs, ipb = plan
    if (cin % 8 or ce % 8 or cout % 8 or kernel not in (3, 5, 7) or (not has_expand and cin != ce)
            or (residual and cin != cout) or not (1 <= th <= h and 1 <= tw <= w) or group < 1
            or not 0 <= bufs <= 3 or ipb not in (1, 2) or (ipb == 2 and (th, tw) != (h, w))
            or -(-cout // (64 * group)) > 65535):
        raise ValueError(
            f"mbconv kernel takes Cin, Ce, Cout % 8 == 0, k in (3, 5, 7), Cin == Ce without expand, "
            f"Cin == Cout with residual and a tile inside the plane; got x {tuple(x.shape)}, Ce={ce}, "
            f"Cout={cout}, k={kernel}, plan {plan}"
        )
    out = torch.empty((b, cout, h, w), dtype=torch.bfloat16, device=x.device, memory_format=torch.channels_last)
    # with SE the depthwise output waits here for the gate (NHWC)
    dw = torch.empty((b, h, w, ce), dtype=torch.bfloat16, device=x.device) if has_se else None

    def ptr(n: str) -> Optional[int]:
        return q[n].data_ptr() if n in q else None

    lib = _lib("mbconv")
    with torch.cuda.device(x.device):
        stream = torch.cuda.current_stream().cuda_stream
        _raise_on(
            lib.mbconv_launch(
                x.data_ptr(), ptr("w_exp_t"), q["dw_aux"].data_ptr(), None if dw is None else dw.data_ptr(),
                ptr("w_se1"), ptr("b_se1"), ptr("w_se2"),
                ptr("b_se2"), q["w_proj_t"].data_ptr(), q["b_proj"].data_ptr(), out.data_ptr(), b, h, w, cin, ce,
                cout, s, kernel, pad_low[0], pad_low[1], th, tw, group, bufs, ipb, int(relu6), int(residual), stream,
            ),
            "mbconv",
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
