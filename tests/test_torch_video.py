"""Video recognition (``data/video_io.py``, ``evaluation/video.py``) against
JAX's: the text format and NumPy helpers equal; the fp32 log-posterior fusion's
predictions equal but where a video's two best sums lie within 2^-10 (fp64
decides)."""

import jax.numpy as jnp
import numpy as np
import pytest

import fast_image_recognition_tpu.data.video_io as JV
import fast_image_recognition_tpu.evaluation.video as JE
import fast_image_recognition_tpu_torch.data.video_io as PV
import fast_image_recognition_tpu_torch.evaluation.video as PE
from fast_image_recognition_tpu.data import FeatureDB as JaxFeatureDB
from fast_image_recognition_tpu.data import make_gallery_and_probes
from fast_image_recognition_tpu.search import BruteForceMatcher as JaxBF
from fast_image_recognition_tpu_torch.data import FeatureDB
from fast_image_recognition_tpu_torch.search import BruteForceMatcher
from test_torch_synthetic import _one_thread  # noqa: F401

TIE = 2.0**-10


@pytest.fixture(scope="module")
def frames():
    """12 people, 3 videos each of 5-12 frames; D = 48."""
    rng = np.random.default_rng(5)
    n_people, d = 12, 48
    centers = rng.standard_normal((n_people, d)).astype(np.float32)
    rows, frame_video, video_person = [], [], []
    for person in range(n_people):
        for _ in range(3):
            n = int(rng.integers(5, 13))
            rows.append(centers[person] + 0.6 * rng.standard_normal((n, d)).astype(np.float32))
            frame_video += [len(video_person)] * n
            video_person.append(person)
    return np.concatenate(rows), np.asarray(frame_video), np.asarray(video_person), [f"p{i:02d}" for i in
            range(n_people)]


def test_video_file_round_trips_between_packages(frames, tmp_path):
    raw, fv, vp, names = frames
    for write, load, tag in ((PV.write_videos, JV.load_videos, "port"), (JV.write_videos, PV.load_videos, "jax")):
        path = str(tmp_path / f"{tag}.txt")
        write(path, raw, fv, vp, names)
        got = load(path, raw.shape[1])
        want = (JV if load is PV.load_videos else PV).load_videos(path, raw.shape[1])
        np.testing.assert_array_equal(got.frames, want.frames)
        np.testing.assert_array_equal(got.frame_video, fv)
        np.testing.assert_array_equal(got.video_person, vp)
        assert got.person_names == names and got.num_videos == len(vp)
    # a short row is zero-padded, a long one cut, as in JAX
    path = str(tmp_path / "short.txt")
    PV.write_videos(path, raw[:, :40], fv, vp, names)
    np.testing.assert_array_equal(PV.load_videos(path, 48).frames, JV.load_videos(path, 48).frames)
    np.testing.assert_array_equal(PV.load_videos(path, 16).frames, JV.load_videos(path, 16).frames)


def test_identities_sampling_and_aggregation_equal_jax(frames):
    raw, fv, vp, names = frames
    videos = PV.VideoDB(PV.normalize_features(raw), fv, vp, names)
    jvideos = JV.VideoDB(videos.frames, fv, vp, names)
    g_names = names[3:] + ["q0", "q1"]
    labels = np.repeat(np.arange(len(g_names)), 2).astype(np.int32)
    feats = np.zeros((len(labels), raw.shape[1]), np.float32)
    pi = PE.intersect_identities(FeatureDB(feats, labels, g_names, []), videos)
    ji = JE.intersect_identities(JaxFeatureDB(feats, labels, g_names, []), jvideos)
    assert pi.new_id == ji.new_id and pi.num_classes == ji.num_classes
    for f in ("gallery_mask", "video_mask", "gallery_labels", "video_labels"):
        np.testing.assert_array_equal(getattr(pi, f), getattr(ji, f))
    for step in (1, 4, 10):
        np.testing.assert_array_equal(PE.sample_probe_frames(videos, step), JE.sample_probe_frames(jvideos, step))
    rng = np.random.default_rng(1)
    keep = np.flatnonzero(fv % 5 != 0)  # video 0 has no frame: -1
    dists, preds = rng.random(len(keep)), rng.integers(0, 12, len(keep))
    for mode in ("min_distance", "majority"):
        np.testing.assert_array_equal(PE._aggregate(dists, preds, fv[keep], 12, len(vp), mode),
                JE._aggregate(dists, preds, fv[keep], 12, len(vp), mode))
    with pytest.raises(ValueError):
        PE._aggregate(dists, preds, fv[keep], 12, len(vp), "nope")


def _fusion_fp64(probes, gallery, gl, fv, num_classes, num_videos, w=100.0):
    d = ((probes[:, None, :].astype(np.float64) - gallery[None].astype(np.float64)) ** 2).mean(-1)
    cmin = np.full((len(probes), num_classes), 1e30)
    for c in range(num_classes):
        if (gl == c).any():
            cmin[:, c] = d[:, gl == c].min(1)
    logits = -w * cmin
    logp = logits - logits.max(1, keepdims=True)
    logp -= np.log(np.exp(logp).sum(1, keepdims=True))
    out = np.zeros((num_videos, num_classes))
    np.add.at(out, fv, logp)
    return out


@pytest.mark.parametrize("num_classes,per,seed", [(20, 5, 0), (40, 3, 7)])
def test_fusion_matches_jax(num_classes, per, seed):
    g, gl, p, pl = make_gallery_and_probes(num_classes, per, 6, 64, seed=seed, within_class_noise=0.8)
    fv = pl.copy()  # one video per class
    want = np.asarray(JE.make_video_fusion_fn(g, gl, num_classes, num_classes)(jnp.asarray(p), jnp.asarray(fv)))
    fuse = PE.make_video_fusion_fn(g, gl, num_classes, num_classes, device="cpu")
    got = fuse(p, fv).numpy()
    ref = _fusion_fp64(p, g, gl, fv, num_classes, num_classes)
    top2 = np.sort(ref, axis=1)[:, -2:]
    tie = top2[:, 1] - top2[:, 0] <= TIE * np.maximum(1.0, np.abs(top2[:, 1]))
    assert ((got == want) | tie).all()
    assert ((got == ref.argmax(1)) | tie).all()
    np.testing.assert_array_equal(
        PE.video_log_posterior_fusion(p, g, gl, fv, num_classes, num_classes, device="cpu"), got)


@pytest.mark.parametrize("aggregation", ["min_distance", "majority"])
def test_evaluate_video_recognition_matches_jax(frames, aggregation):
    raw, fv, vp, names = frames
    feats = PV.normalize_features(raw)
    videos, jvideos = PV.VideoDB(feats, fv, vp, names), JV.VideoDB(feats, fv, vp, names)
    # gallery: the first frame of every video, labelled with its person
    first = np.asarray([np.flatnonzero(fv == v)[0] for v in range(len(vp))])
    gal, gl = feats[first], vp
    idx = PE.sample_probe_frames(videos, 2)
    pr = PE.evaluate_video_recognition(BruteForceMatcher(gal, device="cpu"), gl, videos, vp, idx, 12,
            aggregation=aggregation, batch_size=16)
    jr = JE.evaluate_video_recognition(JaxBF(gal), gl, jvideos, vp, idx, 12, aggregation=aggregation, batch_size=16)
    assert pr.frame_error == pytest.approx(jr.frame_error) and pr.video_error == pytest.approx(jr.video_error)
    assert pr.aggregation == aggregation and pr.ms_per_frame > 0
