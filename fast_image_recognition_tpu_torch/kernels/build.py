"""Build, load and launch the CUDA kernels: ``nvcc`` at first use into
``_build/`` (keyed by a hash of sources and flags), ``ctypes`` bindings,
launches counted in ``LAUNCHES``."""

import ctypes
import hashlib
import os
import shutil
import subprocess
import threading
import time
from typing import Dict, Iterable, Optional, Tuple

import torch

from .plain import TILE_G

KERNEL_DIR = os.path.dirname(os.path.abspath(__file__))
BUILD_DIR = os.path.join(os.path.dirname(KERNEL_DIR), "_build")
SOURCES = {"packed_scan": "packed_scan.cu", "topk_l2": "topk_l2.cu", "tile_scan": "tile_scan.cu", "mbconv": "mbconv.cu",
    "chi2": "chi2.cu"}
# --split-compile=0: a source's kernels optimized on every core
NVCC_FLAGS = ["-O3", "-std=c++17", "-gencode=arch=compute_90a,code=sm_90a", "--split-compile=0", "-shared",
        "-Xcompiler", "-fPIC", "-Xptxas", "-v"]
# topk_l2_precise over bf16 rows, _f32 over fp32 rows; mbconv one launch a block
LAUNCHES: Dict[str, int] = dict.fromkeys(("tilemin2_packed", "tilemin_packed", "topk_l2", "topk_l2_windowed",
        "topk_l2_precise", "topk_l2_precise_f32", "tilemin", "tilemin_quant", "mbconv", "chi2"), 0)
# each library's last build: ptxas resource lines and seconds
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
    """Library path keyed by the source, every header beside it and the flags."""
    h = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    headers = sorted(f for f in os.listdir(KERNEL_DIR) if f.endswith(".cuh"))
    for f in [SOURCES[name], *headers]:
        with open(os.path.join(KERNEL_DIR, f), "rb") as fh:
            h.update(f.encode() + b"\0" + fh.read())
    return os.path.join(BUILD_DIR, f"{name}-{h.hexdigest()[:16]}.so")


def build(names: Optional[Iterable[str]] = None) -> Dict[str, str]:
    """Compile the named sources (default all), one ``nvcc`` each in parallel: name -> library path."""
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


# each extern "C" function's arguments by library: P a pointer, I an int; every one returns an int
SIGNATURES = {
    "packed_scan": {"tilemin2_packed_launch": "PPPPIIIP", "tilemin_packed_launch": "PPPIIIIP"},
    "mbconv": {"mbconv_launch": "P" * 11 + "I" * 17 + "P", "mbconv_smem": "I" * 13},
    "chi2": {"chi2_launch": "PPIPIIIP"},
    "tile_scan": {"tilemin_launch": "PPPPPIIIIIP", "tilemin_quant_launch": "PPPPPPPIIIIIP"},
    "topk_l2": {"topk_l2_launch": "P" * 9 + "I" * 8 + "P", "topk_l2_precise_launch": "PPI" + "P" * 8 + "I" * 8 + "P",
        "topk_l2_split_smem": "I", "topk_l2_split6_smem": "I", "topk_l2_segment_rows": "II",
        "topk_l2_query_rows": "", "topk_l2_list_len": "I", "topk_l2_max_k": "",
        "topk_l2_rescore_launch": "PPIIPPIIIIIP"},
}


def _lib(name: str) -> ctypes.CDLL:
    if name not in _LIBS:
        lib = ctypes.CDLL(build([name])[name])
        for fn, sig in SIGNATURES[name].items():
            f = getattr(lib, fn)
            f.argtypes, f.restype = [ctypes.c_void_p if c == "P" else ctypes.c_int for c in sig], ctypes.c_int
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


def _run(lib: str, fn: str, name: str, device: torch.device, *args) -> None:
    """``lib.fn(*args, stream)`` on ``device``'s current stream, counted as ``name``."""
    with torch.cuda.device(device):
        _raise_on(getattr(_lib(lib), fn)(*args, torch.cuda.current_stream().cuda_stream), name)
    LAUNCHES[name] += 1


def topk_l2_query_rows() -> int:
    """Queries a bf16 pass-1 block: a row mask skips the blocks with no masked query."""
    return _lib("topk_l2").topk_l2_query_rows()


# int32 row indices with a sub-tile or segment of headroom (JAX's int32 rows)
MAX_ROWS = 2**31 - 1 - 2048
TOPK_MAX_K = 256  # kernels/topk_l2.cu MAX_K: lists of up to 256 (query, segment) entries
TOPK_QUERY_ROWS = 128  # kernels/topk_l2.cu QT: queries per pass-1 block and per split-plane box


def topk_l2_split_plane_rows(b: int) -> int:
    """Rows of each bf16 query plane of the split pass: B up to whole 128-query boxes."""
    return -(-b // TOPK_QUERY_ROWS) * TOPK_QUERY_ROWS


def topk_l2_split_smem_for(k: int) -> int:
    """Shared memory of the split pass over bf16 rows (``SplitTile``)."""
    line, qt, bn = 128, TOPK_QUERY_ROWS, 128
    lists = k > 16
    stages = 2 if lists else 3
    ring = stages * (3 * qt * line + bn * line)
    return 1024 + ring + 2 * bn * 4 + ((qt * (bn + 8) + 2 * qt) * 4 if lists else 0) + 2 * stages * 8


def topk_l2_split6_smem_for(k: int) -> int:
    """Shared memory of the six-product pass (``Split6Tile``)."""
    line, qt, bn = 64, TOPK_QUERY_ROWS, 128
    lists = k > 16
    stages, boxes = (2, 3) if lists else (3, 4)
    ring = stages * (3 * qt * line + 3 * bn * line)
    return (1024 + ring + boxes * bn * 128 + (stages + 1) * bn * 4
            + ((qt * (bn + 8) + 2 * qt) * 4 if lists else 0) + (2 * stages + boxes) * 8)


def topk_l2_segment_rows_for(precise: bool, k: int) -> int:
    """Rows per ``topk_l2`` pass-1 block (``segment_rows``): 2,048 bf16 k <= 16, else 8,192."""
    return 8192 if precise or k > 16 else 2048


def packed_scan_tiles(q_shape: Tuple[int, int], g_shape: Tuple[int, int], tile_g: int) -> int:
    """The packed scans' shape rules (Da % 16 == 0): the tile count, or raises."""
    return tile_scan_tiles(q_shape, g_shape, 16, tile_g, "packed scan")


def _check_packed(q_aug: torch.Tensor, g_aug: torch.Tensor, tile_g: int) -> int:
    return _check_scan(q_aug, g_aug, torch.bfloat16, 16, tile_g, "packed scan")


def launch_tilemin2_packed(q_aug: torch.Tensor, g_aug: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """Per (query, 1024-row tile) min and second-min packed keys, int32."""
    n_tiles = _check_packed(q_aug, g_aug, TILE_G)
    b, da = q_aug.shape
    k1 = torch.empty((b, n_tiles), dtype=torch.int32, device=q_aug.device)
    k2 = torch.empty_like(k1)
    _run("packed_scan", "tilemin2_packed_launch", "tilemin2_packed", q_aug.device, q_aug.data_ptr(), g_aug.data_ptr(),
         k1.data_ptr(), k2.data_ptr(), b, n_tiles, da)
    return k1, k2


def launch_tilemin_packed(q_aug: torch.Tensor, g_aug: torch.Tensor, tile_g: int) -> torch.Tensor:
    """Per (query, ``tile_g``-row tile) min packed key, int32."""
    n_tiles = _check_packed(q_aug, g_aug, tile_g)
    b, da = q_aug.shape
    keys = torch.empty((b, n_tiles), dtype=torch.int32, device=q_aug.device)
    _run("packed_scan", "tilemin_packed_launch", "tilemin_packed", q_aug.device, q_aug.data_ptr(), g_aug.data_ptr(),
         keys.data_ptr(), b, n_tiles, da, tile_g)
    return keys


def topk_l2_args(
    q_shape: Tuple[int, int], g_shape: Tuple[int, int], k: int, n_valid: int, window: Optional[Tuple[int, int]],
    precise: bool = False) -> Tuple[int, int]:
    """``topk_l2.cu``'s argument rules: the window, or raises."""
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


def launch_topk_l2(q: torch.Tensor, g: torch.Tensor, k: int, n_valid: int, window: Optional[Tuple[int, int]] = None,
    precise: bool = False, row_mask: Optional[torch.Tensor] = None,
    floor: Optional[Tuple[torch.Tensor, torch.Tensor]] = None, split_out: Optional[Dict[str, torch.Tensor]] = None
) -> Tuple[torch.Tensor, torch.Tensor]:
    """``kernels/topk_l2.cu``: top-k raw squared L2 [B, k] and rows (-1 past n_valid), bf16 or ``precise``;
    ``window``, ``row_mask``, ``floor`` as plain's; ``split_out`` gets ``planes``, ``qsq``."""
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
                *floor_ptrs, part_d.data_ptr(), part_i.data_ptr(), out_d.data_ptr(), out_i.data_ptr(), *sizes, stream)
            if split_out is not None:
                split_out.update(planes=planes, qsq=qsq)
        else:
            status = lib.topk_l2_launch(
                q.data_ptr(), g.data_ptr(), mask_ptr, *floor_ptrs, part_d.data_ptr(), part_i.data_ptr(),
                out_d.data_ptr(), out_i.data_ptr(), *sizes, stream)
    if precise:
        name = "topk_l2_precise_f32" if g.dtype == torch.float32 else "topk_l2_precise"
    else:
        name = "topk_l2" if window is None else "topk_l2_windowed"
    _raise_on(status, name)
    LAUNCHES[name] += 1
    return out_d, out_i


def launch_topk_rescore(q: torch.Tensor, g: torch.Tensor, d: torch.Tensor, idx: torch.Tensor,
        window: Optional[Tuple[int, int]] = None) -> Tuple[torch.Tensor, torch.Tensor]:
    """Pass 3 in place on :func:`launch_topk_l2`'s output, as ``plain.topk_rescore_plain``."""
    b, dim = q.shape
    f32, bf16 = torch.float32, torch.bfloat16
    if (g.shape[1:] != (dim,) or d.shape != idx.shape or d.shape[0] != b or d.dtype != f32
            or idx.dtype != torch.int32 or not d.is_contiguous() or not idx.is_contiguous()
            or (q.dtype, g.dtype) not in ((bf16, bf16), (f32, bf16), (f32, f32))):
        raise ValueError("rescore takes queries [B, D], rows [N, D] (bf16 with bf16 queries) and contiguous fp32 and "
                "int32 picks [B, k]")
    lo, hi = window or (0, dim)
    with torch.cuda.device(q.device):
        _raise_on(_lib("topk_l2").topk_l2_rescore_launch(q.contiguous().data_ptr(), g.contiguous().data_ptr(),
                int(q.dtype == torch.float32), int(g.dtype == torch.float32), d.data_ptr(), idx.data_ptr(), b,
                d.shape[1], dim, int(lo), int(hi), torch.cuda.current_stream().cuda_stream), "topk_rescore")
    return d, idx


def tile_scan_tiles(q_shape: Tuple[int, int], g_shape: Tuple[int, int], vec: int, tile_g: int,
        what: str = "tile scan") -> int:
    """The tile scans' shape rules: the tile count, or raises."""
    (b, d), (np_, g_d) = q_shape, g_shape
    if tile_g not in (128, 256, 512, 1024):
        raise ValueError(f"tile_g must be 128, 256, 512 or 1024, got {tile_g}")
    if b < 1 or np_ < tile_g or np_ % tile_g or g_d != d or d < vec or d % vec or np_ > MAX_ROWS:
        raise ValueError(
            f"{what} takes whole {tile_g}-row tiles (at most {MAX_ROWS} rows) and D % {vec} == 0; got "
            f"queries {tuple(q_shape)}, gallery {tuple(g_shape)}"
        )
    return np_ // tile_g


def _check_scan(q: torch.Tensor, g: torch.Tensor, dtype: torch.dtype, vec: int, tile_g: int,
        what: str = "tile scan") -> int:
    """Validate a scan's operands; returns the number of tiles."""
    _check(q, "queries", dtype, 2)
    _check(g, "gallery", dtype, 2)
    if q.device != g.device:
        raise ValueError("queries and gallery are on different devices")
    return tile_scan_tiles(tuple(q.shape), tuple(g.shape), vec, tile_g, what)


def _check_rows(t: torch.Tensor, what: str, n_rows: int, device: torch.device) -> None:
    _check(t, what, torch.float32, t.dim())
    if t.numel() < n_rows or t.device != device:
        raise ValueError(f"{what} must hold >= {n_rows} fp32 values on {device}")


def launch_tilemin(
    q: torch.Tensor, g: torch.Tensor, gsq: torch.Tensor, tile_g: int, bf16_scores: bool
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Per (query, tile) min of ``|g|^2 - 2 q.g`` and its lowest row, fp32 and int32 [B, n_tiles]."""
    n_tiles = _check_scan(q, g, torch.bfloat16, 8, tile_g)
    _check_rows(gsq, "gsq", g.shape[0], q.device)
    b, d = q.shape
    out_d = torch.empty((b, n_tiles), dtype=torch.float32, device=q.device)
    out_i = torch.empty((b, n_tiles), dtype=torch.int32, device=q.device)
    _run("tile_scan", "tilemin_launch", "tilemin", q.device, q.data_ptr(), g.data_ptr(), gsq.data_ptr(),
         out_d.data_ptr(), out_i.data_ptr(), b, n_tiles, d, tile_g, int(bf16_scores))
    return out_d, out_i


def launch_tilemin_quant(q: torch.Tensor, qs: torch.Tensor, g: torch.Tensor, gsq: torch.Tensor, gsc: torch.Tensor,
    tile_g: int, compute: str) -> Tuple[torch.Tensor, torch.Tensor]:
    """Per (query, tile) min of ``gsq - (2 s_q) (q.g s_g)`` and its lowest row."""
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
    _run("tile_scan", "tilemin_quant_launch", "tilemin_quant", q.device, q.data_ptr(), qs.data_ptr(), g.data_ptr(),
         gsq.data_ptr(), gsc.data_ptr(), out_d.data_ptr(), out_i.data_ptr(), b, n_tiles, d, tile_g,
         int(compute == "int8"))
    return out_d, out_i


def launch_mbconv(x: torch.Tensor, q: Dict[str, torch.Tensor], kernel: int, pad_low: Tuple[int, int],
    plan: Tuple[int, int, int, int, int], relu6: bool, residual: bool) -> torch.Tensor:
    """One stride-1 block on ``x`` (bf16 channels_last), one launch."""
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

    _run("mbconv", "mbconv_launch", "mbconv", x.device, x.data_ptr(), ptr("w_exp_t"), q["dw_aux"].data_ptr(),
         None if dw is None else dw.data_ptr(), ptr("w_se1"), ptr("b_se1"), ptr("w_se2"), ptr("b_se2"),
         q["w_proj_t"].data_ptr(), q["b_proj"].data_ptr(), out.data_ptr(), b, h, w, cin, ce, cout, s, kernel,
         pad_low[0], pad_low[1], th, tw, group, bufs, ipb, int(relu6), int(residual))
    return out


def launch_chi2(q: torch.Tensor, g: torch.Tensor, n_valid: int) -> Tuple[torch.Tensor, torch.Tensor]:
    """(least ``sum (g - q)^2 * rcp(max(g + q, 1e-30))`` over rows < n_valid [B] fp32, its lowest row); one launch."""
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
    _run("chi2", "chi2_launch", "chi2", q.device, q.data_ptr(), g.data_ptr(), int(g.dtype == torch.float32),
         keys.data_ptr(), b, int(n_valid), d)
    # distances are >= 0, so the key's high word is the fp32 bits of the min
    dist = (keys >> 32).to(torch.int32).view(torch.float32)
    rows = (keys & 0xFFFFFFFF).to(torch.int32)
    return dist, rows
