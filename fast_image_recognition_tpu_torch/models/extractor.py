"""Feature extraction (JAX ``models/extractor.py``): ``<root>/<class>/<image>``
through the folded forward into the 3-line format; PNG and BMP decoded here,
other formats by PIL."""

import os
import struct
import zlib
from typing import Iterable, List, Optional, Sequence, Tuple

import numpy as np
import torch
import torch.nn.functional as F

from ..device import DeviceLike, resolve_device
from . import backbone_info, create_backbone
from .fold import make_serving_fn

IMAGE_EXTENSIONS = (".jpg", ".jpeg", ".png", ".bmp")
NATIVE_FORMATS = "PNG (8-bit, non-interlaced) and BMP (24/32-bit, uncompressed)"
_PNG_SIG = b"\x89PNG\r\n\x1a\n"


class _Unsupported(Exception):
    pass


def _paeth_avg_row(raw: np.ndarray, prior: np.ndarray, bpp: int, paeth: bool) -> np.ndarray:
    out = [int(v) for v in raw]
    up = [int(v) for v in prior]
    for i in range(len(out)):
        a = out[i - bpp] if i >= bpp else 0
        if paeth:
            c = up[i - bpp] if i >= bpp else 0
            p = a + up[i] - c
            pa, pb, pc = abs(p - a), abs(p - up[i]), abs(p - c)
            out[i] = (out[i] + (a if pa <= pb and pa <= pc else up[i] if pb <= pc else c)) & 0xFF
        else:
            out[i] = (out[i] + ((a + up[i]) >> 1)) & 0xFF
    return np.asarray(out, np.uint8)


def _decode_png(data: bytes) -> np.ndarray:
    pos, chunks, palette = 8, [], None
    w = h = depth = ctype = interlace = None
    while pos + 8 <= len(data):
        n, kind = struct.unpack(">I4s", data[pos : pos + 8])
        body, pos = data[pos + 8 : pos + 8 + n], pos + 12 + n
        if len(body) != n:
            raise ValueError("truncated PNG chunk")
        if kind == b"IHDR":
            w, h, depth, ctype, _, _, interlace = struct.unpack(">IIBBBBB", body)
        elif kind == b"PLTE":
            palette = np.frombuffer(body, np.uint8).reshape(-1, 3)
        elif kind == b"IDAT":
            chunks.append(body)
        elif kind == b"IEND":
            break
    if w is None or depth != 8 or interlace or ctype not in (0, 2, 3, 4, 6):
        raise _Unsupported(f"PNG bit depth {depth}, colour type {ctype}, interlace {interlace}")
    ch = {0: 1, 2: 3, 3: 1, 4: 2, 6: 4}[ctype]
    raw = np.frombuffer(zlib.decompress(b"".join(chunks)), np.uint8)
    stride = w * ch
    if raw.size != h * (stride + 1):
        raise ValueError("PNG image data of the wrong size")
    rows, prior = raw.reshape(h, stride + 1), np.zeros(stride, np.uint8)
    img = np.empty((h, stride), np.uint8)
    for y in range(h):
        f, r = rows[y, 0], rows[y, 1:]
        if f == 0:
            cur = r
        elif f == 1:
            cur = np.cumsum(r.reshape(-1, ch), axis=0, dtype=np.uint8).reshape(-1)
        elif f == 2:
            cur = r + prior
        elif f in (3, 4):
            cur = _paeth_avg_row(r, prior, ch, f == 4)
        else:
            raise ValueError(f"PNG filter type {f}")
        img[y], prior = cur, cur
    img = img.reshape(h, w, ch)
    if ctype == 3:
        if palette is None or img.max() >= len(palette):
            raise ValueError("PNG palette index out of range")
        return palette[img[..., 0]]
    return np.repeat(img[..., :1], 3, axis=2) if ch <= 2 else img[..., :3]  # convert("RGB"): alpha dropped


def _decode_bmp(data: bytes) -> np.ndarray:
    offset = struct.unpack("<I", data[10:14])[0]
    w, h, _, bits, comp = struct.unpack("<iiHHI", data[18:34])
    if bits not in (24, 32) or comp not in (0, 3) or w <= 0 or h == 0:
        raise _Unsupported(f"BMP of {bits} bits, compression {comp}")
    bpp, stride = bits // 8, (w * bits // 8 + 3) & ~3
    px = np.frombuffer(data, np.uint8, abs(h) * stride, offset).reshape(abs(h), stride)[:, : w * bpp]
    px = px.reshape(abs(h), w, bpp)[..., 2::-1]  # BGR(X) -> RGB
    return np.ascontiguousarray(px[::-1] if h > 0 else px)  # rows bottom-up unless the height is negative


def decode_image(path: str) -> np.ndarray:
    """uint8 RGB [H, W, 3] as PIL's ``convert("RGB")``; other formats by PIL, else a ``ValueError``."""
    with open(path, "rb") as fh:
        data = fh.read()
    try:
        if data[:8] == _PNG_SIG:
            return _decode_png(data)
        if data[:2] == b"BM":
            return _decode_bmp(data)
        why = "not PNG or BMP"
    except _Unsupported as e:
        why = str(e)
    try:
        from PIL import Image
    except ImportError:
        raise ValueError(f"{path}: {why}; without PIL the port decodes {NATIVE_FORMATS} only") from None
    with Image.open(path) as im:
        return np.asarray(im.convert("RGB"), dtype=np.uint8)


def resize_uint8(img: np.ndarray, resolution: int) -> np.ndarray:
    """PIL's default ``resize``: bicubic (a = -0.5), antialiased, the width first, each pass rounded to uint8."""
    x = torch.from_numpy(np.ascontiguousarray(img)).permute(2, 0, 1)[None].float()
    for size in ((x.shape[2], resolution), (resolution, resolution)):
        if tuple(x.shape[2:]) != size:
            x = F.interpolate(x, size=size, mode="bicubic", align_corners=False, antialias=True).round().clamp(0, 255)
    return x[0].permute(1, 2, 0).to(torch.uint8).numpy()


def load_images(paths: Iterable[str], resolution: int) -> Tuple[np.ndarray, List[int]]:
    """(uint8 [N, R, R, 3], indices read): corrupt files skipped, an undecodable format raises."""
    out, kept = [], []
    for i, p in enumerate(paths):
        try:
            img = decode_image(p)
        except ValueError as e:
            if "without PIL" in str(e):
                raise
            continue
        except Exception:  # a corrupt file, as JAX :148-153 skips it
            continue
        out.append(resize_uint8(img, resolution))
        kept.append(i)
    if not out:
        return np.zeros((0, resolution, resolution, 3), dtype=np.uint8), []
    return np.stack(out), kept


def list_image_dataset(root: str, extensions: Sequence[str] = IMAGE_EXTENSIONS) -> Tuple[List[str], List[int], List[str]]:
    """(paths, labels, sorted class names) of ``<root>/<class>/<image>``."""
    class_names = sorted(d for d in os.listdir(root) if os.path.isdir(os.path.join(root, d)))
    paths, labels = [], []
    for ci, cname in enumerate(class_names):
        for fname in sorted(os.listdir(os.path.join(root, cname))):
            if fname.lower().endswith(tuple(extensions)):
                paths.append(os.path.join(root, cname, fname))
                labels.append(ci)
    return paths, labels, class_names


class FeatureExtractor:
    """Pooled embeddings by the folded serving forward on ``device``; ``mesh``: its ``data`` axis splits each batch,
    padded as JAX pads it."""

    def __init__(self, variant: str = "b0", variables=None, resolution: Optional[int] = None, mesh=None,
            seed: int = 0, folded: bool = True, device: DeviceLike = None):
        self.variant, self._info, self.mesh = variant, backbone_info(variant), mesh
        self.resolution = resolution or self._info["resolution"]
        devs = [resolve_device(device)] if mesh is None else list(mesh.shard_devices(("data",)))
        if variables is None:
            variables = create_backbone(variant, 0, seed, self.resolution, device=devs[0])[1]
        self.variables, self._devices = variables, devs
        fns = {}
        for d in devs:
            if str(d) not in fns:
                fns[str(d)] = make_serving_fn(variables, self._info, resolution=self.resolution, device=d,
                    folded=folded)
        self._fns, self._dp = fns, len(devs)

    @property
    def embedding_dim(self) -> int:
        return int(self._info["embedding_dim"])

    @torch.no_grad()
    def extract(self, images, batch_size: int = 256) -> np.ndarray:
        """[N, H, W, 3] images -> [N, F] fp32 numpy."""
        batch_size, outs = max(self._dp, batch_size - batch_size % self._dp), []
        for s in range(0, images.shape[0], batch_size):
            chunk = torch.as_tensor(images[s : s + batch_size])
            pad = -chunk.shape[0] % self._dp
            if pad:
                chunk = torch.cat([chunk, chunk[-1:].expand(pad, *chunk.shape[1:])])
            parts = chunk.chunk(self._dp)
            embs = [self._fns[str(d)](p.to(d))["embedding"].float() for d, p in zip(self._devices, parts)]
            emb = torch.cat([e.to(self._devices[0]) for e in embs]).cpu().numpy()
            outs.append(emb[: emb.shape[0] - pad])
        return np.concatenate(outs, axis=0)

    def extract_normalized(self, images, batch_size: int = 256) -> np.ndarray:
        """Rows normalized in fp64, fp32 out."""
        feats = self.extract(images, batch_size).astype(np.float64)
        norms = np.linalg.norm(feats, axis=1, keepdims=True)
        norms[norms == 0.0] = 1.0
        return (feats / norms).astype(np.float32)


def extract_dataset_to_file(root: str, output_path: str, variant: str = "b0", variables=None, batch_size: int = 64,
        mesh=None, device: DeviceLike = None) -> int:
    """Image folders -> feature file; the image count."""
    from ..data.feature_io import write_feature_file

    if not os.path.isdir(root):
        raise FileNotFoundError(f"dataset root is not a directory: {root}")
    paths, labels, class_names = list_image_dataset(root)
    extractor = FeatureExtractor(variant, variables=variables, mesh=mesh, device=device)
    images, kept = load_images(paths, extractor.resolution)
    feats = extractor.extract_normalized(images, batch_size=batch_size)
    write_feature_file(output_path, feats, np.asarray([labels[i] for i in kept]), class_names,
            [os.path.basename(paths[i]) for i in kept])
    return len(kept)
