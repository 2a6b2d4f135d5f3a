"""``data/synthetic_images.py`` bit-equal to JAX's; ``run_trained_cascade.main``
tiny on the CPU: records with JAX's keys, ``--dataset digits`` refused without
scikit-learn."""

import sys

import numpy as np
import pytest

import fast_image_recognition_tpu.data.synthetic_images as J
import fast_image_recognition_tpu_torch.data.synthetic_images as P
from fast_image_recognition_tpu_torch.scripts import run_trained_cascade
from test_torch_synthetic import _one_thread  # noqa: F401

KEYS = {"cascade_trained_noexit": {"val_acc_final_head"}, "cascade_trained_fused": {"far", "break_counts",
        "forced_fraction"}, "cascade_trained_pooled": {"far", "break_counts", "streams"}}


@pytest.mark.parametrize("args", [(4, 3, 32, 0), (3, 5, 40, 7)])
def test_dataset_and_split_bit_equal_jax(args):
    *shape, seed = args
    want, got = J.make_synthetic_image_dataset(*shape, seed=seed), P.make_synthetic_image_dataset(*shape, seed=seed)
    for a, b in zip(want, got):
        assert a.dtype == b.dtype and np.array_equal(a, b)
    for a, b in zip(J.split_synthetic_image_dataset(*want, 2, seed=1),
            P.split_synthetic_image_dataset(*got, 2, seed=1)):
        np.testing.assert_array_equal(a, b)


def test_run_trained_cascade_records(monkeypatch, tmp_path):
    out = tmp_path / "curve.jsonl"
    recs = run_trained_cascade.main(["--dataset", "synthetic", "--classes", "4", "--per-class", "6", "--resolution",
        "32", "--phase1-epochs", "1", "--phase2-epochs", "1", "--batch-size", "8", "--pool", "64", "--bucket", "32",
        "--far-sweep", "0.1", "--fused-far", "0.1", "--streams", "1,2", "--iters", "1", "--out", str(out)],
        device="cpu")
    assert [r["config"].split("_")[-1] for r in recs] == ["noexit", "pooled", "pooled", "fused"]
    assert [r["streams"] for r in recs[1:3]] == [1, 2] and recs[1]["break_counts"] == recs[2]["break_counts"]
    for r in recs:
        assert {"config", "dataset", "variant", "resolution", "macro_recall_pct", "img_per_s", "vs_noexit"} \
            | KEYS[r["config"]] <= set(r) and r["dataset"] == "synthetic4"
    assert len(out.read_text().splitlines()) == 4 and np.isfinite(recs[0]["loss"]).all()
    monkeypatch.setitem(sys.modules, "sklearn", None)
    with pytest.raises(RuntimeError, match="scikit-learn"):
        run_trained_cascade.main(["--dataset", "digits"], device="cpu")
