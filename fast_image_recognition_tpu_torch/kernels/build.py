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
SOURCES = {"packed_scan": "packed_scan.cu", "topk_l2": "topk_l2.cu"}
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

LAUNCHES: Dict[str, int] = {"tilemin2_packed": 0, "topk_l2": 0}
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
        else:
            lib.topk_l2_launch.argtypes = [P, P, P, P, P, P, I, I, I, I, I, I, P]
            lib.topk_l2_launch.restype = I
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


def launch_tilemin2_packed(q_aug: torch.Tensor, g_aug: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """``kernels/packed_scan.cu``: per (query, 1024-row tile) min and
    second-min packed keys, ``[B, n_tiles]`` int32 each."""
    _check(q_aug, "q_aug", torch.bfloat16, 2)
    _check(g_aug, "g_aug", torch.bfloat16, 2)
    b, da = q_aug.shape
    if g_aug.shape[0] % TILE_G or g_aug.shape[1] != da or da % 16:
        raise ValueError(
            f"packed scan takes whole {TILE_G}-row tiles and Da % 16 == 0; got "
            f"q_aug {tuple(q_aug.shape)}, g_aug {tuple(g_aug.shape)}"
        )
    if q_aug.device != g_aug.device:
        raise ValueError("q_aug and g_aug are on different devices")
    n_tiles = g_aug.shape[0] // TILE_G
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


def launch_topk_l2(
    q: torch.Tensor, g: torch.Tensor, k: int, n_valid: int
) -> Tuple[torch.Tensor, torch.Tensor]:
    """``kernels/topk_l2.cu``: exact top-k raw squared L2 distances
    ``[B, k]`` fp32 and row indices ``[B, k]`` int32 (-1 past n_valid)."""
    _check(q, "queries", torch.bfloat16, 2)
    _check(g, "gallery", torch.bfloat16, 2)
    b, d = q.shape
    n = g.shape[0]
    if g.shape[1] != d or d % 8 or not 1 <= k <= 16 or not 0 < n_valid <= n:
        raise ValueError(
            f"topk_l2 kernel takes D % 8 == 0, 1 <= k <= 16, 0 < n_valid <= N; got "
            f"queries {tuple(q.shape)}, gallery {tuple(g.shape)}, k={k}, n_valid={n_valid}"
        )
    if q.device != g.device:
        raise ValueError("queries and gallery are on different devices")
    lib = _lib("topk_l2")
    seg = lib.topk_l2_segment_rows()
    n_seg = -(-n_valid // seg)
    kk = lib.topk_l2_list_len(k)
    part_d = torch.empty((b, n_seg, kk), dtype=torch.float32, device=q.device)
    part_i = torch.empty((b, n_seg, kk), dtype=torch.int32, device=q.device)
    out_d = torch.empty((b, k), dtype=torch.float32, device=q.device)
    out_i = torch.empty((b, k), dtype=torch.int32, device=q.device)
    with torch.cuda.device(q.device):
        stream = torch.cuda.current_stream().cuda_stream
        _raise_on(
            lib.topk_l2_launch(
                q.data_ptr(), g.data_ptr(), part_d.data_ptr(), part_i.data_ptr(),
                out_d.data_ptr(), out_i.data_ptr(), b, n, n_valid, d, k, n_seg, stream,
            ),
            "topk_l2",
        )
    LAUNCHES["topk_l2"] += 1
    return out_d, out_i
