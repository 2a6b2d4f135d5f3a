"""Rules the port keeps: no JAX in the port or its smoke script, the card by
default, small source files, ctypes bindings that match the C launchers."""

import ast
import os
import re
import shutil
from functools import partial

import pytest
import torch
from PIL import Image

from fast_image_recognition_tpu_torch import device as port_device
from fast_image_recognition_tpu_torch.kernels import build
from test_torch_synthetic import _one_thread  # noqa: F401

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


def test_entry_points_default_to_the_card(monkeypatch, tmp_path):
    from fast_image_recognition_tpu_torch.data.synthetic_device import device_dataset
    from fast_image_recognition_tpu_torch.models.efficientnet import backbone_info
    from fast_image_recognition_tpu_torch.models.inference import make_infer_fn
    from fast_image_recognition_tpu_torch.ops.chi2_kernel import chi2_nn
    from fast_image_recognition_tpu_torch.scripts import chi2_cost
    from fast_image_recognition_tpu_torch.search import BruteForceMatcher
    from fast_image_recognition_tpu_torch.serving import (CascadeRecognitionService, RecognitionService,
        build_cascade_service, build_service, make_tap_embed_fn)

    from fast_image_recognition_tpu_torch.cascade import ConventionalTWD, ProposedTWD, TWDType
    from fast_image_recognition_tpu_torch.cascade.engine import SequentialInferencePipeline
    from fast_image_recognition_tpu_torch.evaluation.video import make_video_fusion_fn
    from fast_image_recognition_tpu_torch.models import (EfficientNet, create_backbone, create_efficientnet,
        create_mobilenet_v1, create_mobilenetv2, backbone_info as zoo_info)
    from fast_image_recognition_tpu_torch.models.fold import make_serving_fn
    from fast_image_recognition_tpu_torch.search.dem import DirectedEnumerationMatcher, FullMatrixDEM
    from fast_image_recognition_tpu_torch.classifiers import FPNNClassifier, KNNClassifier, PNNClassifier
    from fast_image_recognition_tpu_torch.parallel import ShardedGalleryMatcher, gallery_mesh
    from fast_image_recognition_tpu_torch.search.projection import ProjectionIndexMatcher
    from fast_image_recognition_tpu_torch.search.small_world import SmallWorldMatcher
    from fast_image_recognition_tpu_torch.models.extractor import FeatureExtractor
    from fast_image_recognition_tpu_torch.models.train import MultiExitTrainer, TrainConfig
    from fast_image_recognition_tpu_torch.ops.pca import fit_pca
    from fast_image_recognition_tpu_torch.scripts import (extract_features, run_prune_finetune, run_trained_cascade,
        train_serving_backbone)

    _, irv2 = create_backbone("inception_resnet_v2", device="cpu")
    mb = {n: create_backbone(n, resolution=32, device="cpu")[1] for n in ("mobilenetv2", "mobilenetv1")}
    (tmp_path / "ds" / "c0").mkdir(parents=True)
    Image.new("RGB", (2, 2)).save(tmp_path / "ds" / "c0" / "x.bmp")
    train_args = ["--resolution", "32", "--classes", "2", "--per-class", "3", "--train-per-class", "2",
            "--batch-size", "2", "--epochs", "1", "--out", str(tmp_path / "ck.msgpack")]
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    feats = torch.rand((40, 16)).numpy()
    labels = torch.arange(40).numpy() % 4
    for make in (
        partial(DirectedEnumerationMatcher, feats, labels),
        partial(DirectedEnumerationMatcher.from_device, torch.from_numpy(feats), labels),
        partial(FullMatrixDEM, feats, labels),
        partial(make_video_fusion_fn, feats, labels, 4, 2),
        partial(create_efficientnet, "b0", resolution=32),
        partial(create_backbone, "inception_resnet_v2"),
        lambda **kw: build_service("inception_resnet_v2", feats[:4, :1].repeat(1536, 1), variables=None,
            match="exact", **kw),
        partial(make_serving_fn, irv2, zoo_info("inception_resnet_v2")),
        partial(create_mobilenetv2, resolution=32),
        partial(create_mobilenet_v1, resolution=32),
        *(lambda n=n, v=v, **kw: make_serving_fn(v, zoo_info(n), **kw) for n, v in mb.items()),
        partial(make_infer_fn, mb["mobilenetv2"], "mobilenetv2", fused=True),
        lambda **kw: SequentialInferencePipeline(EfficientNet("b0"), None, ["block5a"], [feats[:4, :1]] * 2,
            [labels[:4]] * 2, **kw),
        partial(ProposedTWD, feats, labels, 4, chunk_features=8, max_features=16),
        partial(ConventionalTWD, feats, labels, 4, TWDType.DIST_RATIO, 0.7, 8, 16),
        partial(SmallWorldMatcher, feats),
        partial(ProjectionIndexMatcher, feats),
        partial(KNNClassifier, 1, 4),
        partial(PNNClassifier, 4),
        partial(FPNNClassifier, 4),
        lambda **kw: gallery_mesh(2, devices=None if not kw else [kw["device"]] * 2),
        lambda **kw: ShardedGalleryMatcher(feats, gallery_mesh(devices=None if not kw else [kw["device"]] * 2)),
        lambda **kw: MultiExitTrainer(create_backbone("mobilenetv1", resolution=32, device="cpu")[0], mb["mobilenetv1"],
            TrainConfig(2, ("conv_dw_5",), 32), **kw),
        partial(FeatureExtractor, "mobilenetv1", mb["mobilenetv1"], resolution=32),
        partial(train_serving_backbone.main, train_args),
        lambda **kw: extract_features.main([str(tmp_path / "ds"), str(tmp_path / "f.txt"), "--variant",
            "mobilenetv1"], **kw),
        lambda **kw: run_trained_cascade.main(["--dataset", "synthetic", "--classes", "4", "--per-class", "6",
            "--phase1-epochs", "0", "--phase2-epochs", "1", "--batch-size", "8", "--pool", "8", "--bucket", "8",
            "--far-sweep", "0.1", "--fused-far", "0.1", "--iters", "1"], **kw),
        lambda **kw: fit_pca(feats, 4).project_device(feats, **kw),
        partial(run_prune_finetune.main, ["--synthetic", "2,10,32", "--epochs", "0"]),
    ):
        with pytest.raises(RuntimeError):
            make()
        make(device="cpu")  # the CPU only when asked for
    g, rows = torch.zeros((4, 1280)), torch.rand((8, 16)).numpy()
    for make in (lambda: RecognitionService(None, backbone_info("b0"), g),
            lambda: RecognitionService(None, backbone_info("b0"), g, match="sharded"),
            # the service on the CPU, its mesh left to the default
            lambda: RecognitionService(None, backbone_info("b0"), g, match="sharded",
                serving_fn=torch.nn.Identity(), device="cpu"),
            lambda: CascadeRecognitionService(None, backbone_info("b0"), g),
            lambda: build_cascade_service("b0", g, variables=None), lambda: build_service("b0", g, variables=None),
            lambda: make_tap_embed_fn(None, backbone_info("b0")), lambda: device_dataset(2, 1, 8),
            lambda: make_infer_fn(None, fused=True), lambda: chi2_nn(rows, rows), lambda: BruteForceMatcher(rows),
            lambda: chi2_cost.main(["--gallery", "8", "--batch", "2", "--dim", "16", "--iters", "1"])):
        with pytest.raises(RuntimeError):
            make()


def test_port_files_are_small_source_text():
    paths = list(_port_files(("",))) + [os.path.join(REPO, "chip_smoke.py"), *(os.path.join(REPO, "tests",
            f) for f in os.listdir(os.path.join(REPO, "tests")) if f.startswith("test_torch_"))]
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
    """Each ``extern "C"`` function takes as many arguments as its ctypes binding declares, and each is bound."""
    for name, src in build.SOURCES.items():
        text = open(os.path.join(build.KERNEL_DIR, src)).read()
        assert set(re.findall(r'extern "C" int (\w+)\(', text)) == set(build.SIGNATURES[name]), name
        for fn, sig in build.SIGNATURES[name].items():
            params = re.search(r'extern "C" int ' + fn + r"\(([^)]*)\)", text).group(1).split(",")
            assert len([a for a in params if a.strip() not in ("", "void")]) == len(sig), fn


def test_build_key_covers_the_headers(monkeypatch, tmp_path):
    """A library is keyed by its source, every ``*.cuh`` and the flags."""
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
