"""Rules the port keeps: no JAX (or flax, msgpack, or the JAX package) in
the port or its smoke script, the card by default with no silent CPU
fallback, small source files only, and ctypes bindings that match the
kernels' C launchers."""

import ast
import os
import re
import shutil

import pytest
import torch

from fast_image_recognition_tpu_torch import device as port_device
from fast_image_recognition_tpu_torch.kernels import build

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
PORT = os.path.join(REPO, "fast_image_recognition_tpu_torch")
BANNED = ("jax", "jaxlib", "flax", "msgpack", "fast_image_recognition_tpu")


def _port_files(suffixes):
    for root, dirs, files in os.walk(PORT):
        dirs[:] = [d for d in dirs if d not in ("_build", "__pycache__")]
        for f in files:
            if f.endswith(suffixes):
                yield os.path.join(root, f)


def _python_sources():
    yield from _port_files((".py",))
    yield os.path.join(REPO, "chip_smoke.py")


def test_no_jax_imports_in_port_or_smoke_script():
    offenders = []
    for path in _python_sources():
        tree = ast.parse(open(path).read(), path)
        for node in ast.walk(tree):
            if isinstance(node, ast.Import):
                names = [a.name for a in node.names]
            elif isinstance(node, ast.ImportFrom):
                names = [node.module or ""]
            else:
                continue
            for n in names:
                if n.split(".")[0] in BANNED:
                    offenders.append(f"{os.path.relpath(path, REPO)}:{node.lineno} {n}")
    assert not offenders, offenders


def test_default_device_raises_without_cuda(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        port_device.default_device()
    with pytest.raises(RuntimeError):
        port_device.resolve_device(None)
    with pytest.raises(RuntimeError):
        port_device.resolve_device("cuda")
    assert port_device.resolve_device("cpu") == torch.device("cpu")


def test_entry_points_default_to_the_card(monkeypatch):
    from fast_image_recognition_tpu_torch.data.synthetic_device import device_dataset
    from fast_image_recognition_tpu_torch.models.efficientnet import backbone_info
    from fast_image_recognition_tpu_torch.models.inference import make_infer_fn
    from fast_image_recognition_tpu_torch.ops.chi2_kernel import chi2_nn
    from fast_image_recognition_tpu_torch.scripts import chi2_cost
    from fast_image_recognition_tpu_torch.search import BruteForceMatcher
    from fast_image_recognition_tpu_torch.serving import (
        CascadeRecognitionService,
        RecognitionService,
        build_cascade_service,
        build_service,
        make_tap_embed_fn,
    )

    from fast_image_recognition_tpu_torch.cascade import ConventionalTWD, ProposedTWD, TWDType
    from fast_image_recognition_tpu_torch.cascade.engine import SequentialInferencePipeline
    from fast_image_recognition_tpu_torch.evaluation.video import make_video_fusion_fn
    from fast_image_recognition_tpu_torch.models import EfficientNet, create_efficientnet
    from fast_image_recognition_tpu_torch.search.dem import DirectedEnumerationMatcher, FullMatrixDEM
    from fast_image_recognition_tpu_torch.classifiers import FPNNClassifier, KNNClassifier, PNNClassifier
    from fast_image_recognition_tpu_torch.parallel import ShardedGalleryMatcher, gallery_mesh
    from fast_image_recognition_tpu_torch.search.projection import ProjectionIndexMatcher
    from fast_image_recognition_tpu_torch.search.small_world import SmallWorldMatcher

    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    feats = torch.rand((40, 16)).numpy()
    labels = torch.arange(40).numpy() % 4
    for make in (
        lambda **kw: DirectedEnumerationMatcher(feats, labels, **kw),
        lambda **kw: DirectedEnumerationMatcher.from_device(torch.from_numpy(feats), labels, **kw),
        lambda **kw: FullMatrixDEM(feats, labels, **kw),
        lambda **kw: make_video_fusion_fn(feats, labels, 4, 2, **kw),
        lambda **kw: create_efficientnet("b0", resolution=32, **kw),
        lambda **kw: SequentialInferencePipeline(EfficientNet("b0"), None, ["block5a"], [feats[:4, :1]] * 2,
                                                 [labels[:4]] * 2, **kw),
        lambda **kw: ProposedTWD(feats, labels, 4, chunk_features=8, max_features=16, **kw),
        lambda **kw: ConventionalTWD(feats, labels, 4, TWDType.DIST_RATIO, 0.7, 8, 16, **kw),
        lambda **kw: SmallWorldMatcher(feats, **kw),
        lambda **kw: ProjectionIndexMatcher(feats, **kw),
        lambda **kw: KNNClassifier(1, 4, **kw),
        lambda **kw: PNNClassifier(4, **kw),
        lambda **kw: FPNNClassifier(4, **kw),
        lambda **kw: gallery_mesh(2, devices=None if not kw else [kw["device"]] * 2),
        lambda **kw: ShardedGalleryMatcher(feats, gallery_mesh(devices=None if not kw else [kw["device"]] * 2)),
    ):
        with pytest.raises(RuntimeError):
            make()
        make(device="cpu")  # the CPU only when asked for
    with pytest.raises(RuntimeError):
        RecognitionService(None, backbone_info("b0"), torch.zeros((4, 1280)))
    with pytest.raises(RuntimeError):
        RecognitionService(None, backbone_info("b0"), torch.zeros((4, 1280)), match="sharded")
    with pytest.raises(RuntimeError):  # the service on the CPU, its mesh left to the default
        RecognitionService(None, backbone_info("b0"), torch.zeros((4, 1280)), match="sharded",
                           serving_fn=torch.nn.Identity(), device="cpu")
    with pytest.raises(RuntimeError):
        CascadeRecognitionService(None, backbone_info("b0"), torch.zeros((4, 1280)))
    with pytest.raises(RuntimeError):
        build_cascade_service("b0", torch.zeros((4, 1280)), variables=None)
    with pytest.raises(RuntimeError):
        build_service("b0", torch.zeros((4, 1280)), variables=None)
    with pytest.raises(RuntimeError):
        make_tap_embed_fn(None, backbone_info("b0"))
    with pytest.raises(RuntimeError):
        device_dataset(2, 1, 8)
    with pytest.raises(RuntimeError):
        make_infer_fn(None, fused=True)
    rows = torch.rand((8, 16)).numpy()
    with pytest.raises(RuntimeError):
        chi2_nn(rows, rows)
    with pytest.raises(RuntimeError):
        BruteForceMatcher(rows)
    with pytest.raises(RuntimeError):
        chi2_cost.main(["--gallery", "8", "--batch", "2", "--dim", "16", "--iters", "1"])


def test_port_files_are_small_source_text():
    paths = list(_port_files(("",))) + [
        os.path.join(REPO, "chip_smoke.py"),
        *(os.path.join(REPO, "tests", f) for f in os.listdir(os.path.join(REPO, "tests"))
          if f.startswith("test_torch_")),
    ]
    total = 0
    for p in paths:
        if p.endswith((".pyc", ".so")):
            continue
        size = os.path.getsize(p)
        total += size
        assert size < 200_000, p
        open(p, encoding="utf-8").read()  # text, not binary
    assert total < 1_000_000


def test_ctypes_bindings_match_the_c_launchers():
    """Each ``extern "C"`` launcher takes as many arguments as its ctypes
    binding declares (the .cu files cannot be compiled here)."""
    expected = {
        "tilemin2_packed_launch": 8,
        "tilemin_packed_launch": 8,
        "topk_l2_launch": 18,
        "topk_l2_precise_launch": 20,
        "tilemin_launch": 11,
        "tilemin_quant_launch": 13,
        "mbconv_launch": 29,
        "mbconv_smem": 13,
        "chi2_launch": 8,
        "topk_l2_segment_rows": 2,
        "topk_l2_query_rows": 0,
        "topk_l2_list_len": 1,
        "topk_l2_max_k": 0,
        "topk_l2_split_smem": 1,
        "topk_l2_split6_smem": 1,
    }
    for name, src in build.SOURCES.items():
        text = open(os.path.join(build.KERNEL_DIR, src)).read()
        for fn, n_args in expected.items():
            m = re.search(r'extern "C" int ' + fn + r"\(([^)]*)\)", text)
            if m:
                params = [a for a in m.group(1).split(",") if a.strip() not in ("", "void")]
                assert len(params) == n_args, fn
                expected[fn] = None
    assert all(v is None for v in expected.values()), expected


def test_build_key_covers_the_headers(monkeypatch, tmp_path):
    """A library is named by its source, every ``*.cuh`` beside it and the
    flags: editing the shared main loop header must not load a stale
    library."""
    for f in os.listdir(build.KERNEL_DIR):
        if f.endswith((".cu", ".cuh")):
            shutil.copy(os.path.join(build.KERNEL_DIR, f), tmp_path / f)
    monkeypatch.setattr(build, "KERNEL_DIR", str(tmp_path))
    before = {n: build._target(n) for n in build.SOURCES}
    assert (tmp_path / "sm90_scan.cuh").exists()
    with open(tmp_path / "sm90_scan.cuh", "a") as fh:
        fh.write("// edited\n")
    after = {n: build._target(n) for n in build.SOURCES}
    assert all(before[n] != after[n] for n in build.SOURCES)
    with open(tmp_path / "topk_l2.cu", "a") as fh:
        fh.write("// edited\n")
    assert build._target("topk_l2") != after["topk_l2"] and build._target("chi2") == after["chi2"]


def test_build_raises_without_nvcc(monkeypatch, tmp_path):
    monkeypatch.setattr(build, "BUILD_DIR", str(tmp_path / "_build"))
    monkeypatch.setattr(build.shutil, "which", lambda _: None)
    monkeypatch.setattr(build.os.path, "exists", lambda p: False)
    with pytest.raises(RuntimeError, match="nvcc"):
        build.build()
    assert not (tmp_path / "_build").exists()
