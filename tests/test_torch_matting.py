"""The port's matting stage against the JAX package's, on the CPU.

`border_color`, `median_background` and `none` run on the clips of the
reference's own matting tests; the masks are held equal but for a stated share
of pixels (<= 1e-4: `_classify_device` thresholds a squared distance, and a
pixel within rounding of the threshold may flip), and `_classify_device` is
held to its definition in numpy.
"""

import numpy as np
import pytest
import torch

from omfs4d.track import matting as jmat
from omfs4d_torch.track import matting as tmat
from tests.test_torch_track import one_torch_thread  # noqa: F401  (autouse here too)


def moving_blob(T=12, H=48, W=48):
    rng = np.random.default_rng(0)
    bg = rng.integers(80, 120, (H, W, 3)).astype(np.uint8)
    frames = np.zeros((T, H, W, 3), np.uint8)
    gt = np.zeros((T, H, W), bool)
    yy, xx = np.mgrid[0:H, 0:W]
    for t in range(T):
        frames[t] = bg
        blob = (yy - 24) ** 2 + (xx - (12 + 2 * t)) ** 2 < 64
        frames[t][blob] = [230, 40, 40]
        gt[t] = blob
    return frames, gt


def centered_subject(T=8, H=64, W=64):
    rng = np.random.default_rng(1)
    bg = rng.integers(90, 110, (H, W, 3)).astype(np.uint8)
    frames = np.zeros((T, H, W, 3), np.uint8)
    gt = np.zeros((T, H, W), bool)
    yy, xx = np.mgrid[0:H, 0:W]
    for t in range(T):
        frames[t] = bg
        blob = (yy - 32) ** 2 + (xx - 32 - (t % 3)) ** 2 < 180
        frames[t][blob] = [210, 150, 60]
        gt[t] = blob
    return frames, gt


def iou(masks, gt):
    m = masks.astype(bool)
    return (m & gt).sum() / (m | gt).sum()


def test_registry_matches_the_reference():
    assert sorted(tmat._MATTERS) == sorted(jmat._MATTERS) == [
        "border_color", "median_background", "neural", "none"]
    with pytest.raises(KeyError, match="nope"):
        tmat.compute_masks(np.zeros((1, 4, 4, 3), np.uint8), method="nope")

    @tmat.register_matting("half")
    def half(frames, **_):
        return np.full(frames.shape[:3], 0.5, np.float32)

    try:
        assert (tmat.compute_masks(np.zeros((2, 4, 4, 3), np.uint8), method="half") == 0.5).all()
    finally:
        del tmat._MATTERS["half"]


@pytest.mark.parametrize("kw", [dict(threshold=40.0), dict(), dict(keep_largest=False, smooth=1),
                                dict(k=2, border=4, smooth=7)],
                         ids=["reference_case", "defaults", "raw_classes", "other_settings"])
def test_border_color_matches_jax(kw):
    frames, gt = centered_subject()
    want = jmat.compute_masks(frames, method="border_color", **kw)
    got = tmat.compute_masks(frames, method="border_color", device="cpu", **kw)
    assert got.shape == frames.shape[:3] and got.dtype == np.float32
    assert (got != want).mean() <= 1e-4
    if kw.get("keep_largest", True):
        assert iou(got, gt) > 0.85


def test_border_centers_are_the_reference_bits(monkeypatch):
    frames, _ = centered_subject()
    seen = []
    real = jmat._classify_device

    def spy(fr, centers, threshold, smooth):
        seen.append(np.asarray(centers))
        return real(fr, centers, threshold, smooth)

    monkeypatch.setattr(jmat, "_classify_device", spy)
    jmat.compute_masks(frames, method="border_color")
    np.testing.assert_array_equal(tmat.border_centers(frames), seen[0])


@pytest.mark.parametrize("smooth", [1, 5, 4])
def test_classify_device_matches_its_numpy_definition(smooth):
    rng = np.random.default_rng(3)
    frames = rng.integers(0, 256, (3, 20, 28, 3)).astype(np.uint8)
    centers = rng.uniform(0, 255, (4, 3)).astype(np.float32)
    thr = 90.0
    f = frames.astype(np.float32)
    d2 = ((f[:, :, :, None, :] - centers[None, None, None]) ** 2).sum(-1).min(-1)
    want = (d2 > thr ** 2).astype(np.float32)
    if smooth > 1:
        want = (np.stack([tmat._box_blur(m, smooth) for m in want]) > 0.5).astype(np.float32)
    got = tmat._classify_device(frames, centers, thr, smooth, torch.device("cpu"))
    assert got.shape == (3, 20, 28) and got.dtype == np.float32
    assert (got != want).mean() <= 1e-4
    ref = np.asarray(jmat._classify_device(frames, centers, thr, smooth))
    assert (got != ref).mean() <= 1e-4


def test_box_blur_twins_agree():
    rng = np.random.default_rng(0)
    m = rng.uniform(0, 1, (2, 9, 13)).astype(np.float32)
    for k in (3, 5, 7):
        want = np.stack([jmat._box_blur(x, k) for x in m])
        np.testing.assert_allclose(tmat._box_blur(m, k), want, atol=1e-6)
        np.testing.assert_allclose(tmat._box_blur_torch(torch.from_numpy(m), k).numpy(), want,
                                   atol=1e-5)


@pytest.mark.parametrize("kw", [dict(threshold=40.0, smooth=1), dict()],
                         ids=["reference_case", "defaults"])
def test_median_background_matches_jax(kw):
    frames, gt = moving_blob()
    want = jmat.compute_masks(frames, method="median_background", **kw)
    got = tmat.compute_masks(frames, method="median_background", **kw)
    np.testing.assert_array_equal(got, want)
    assert got.shape == frames.shape[:3] and iou(got, gt) > 0.5


def test_none_is_full_foreground():
    frames, _ = moving_blob(T=3)
    got = tmat.compute_masks(frames, method="none")
    np.testing.assert_array_equal(got, jmat.compute_masks(frames, method="none"))
    assert (got == 1.0).all() and got.dtype == np.float32


def test_device_methods_take_the_card_by_default_and_raise_without_one(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    frames, _ = moving_blob(T=2)
    for method in ("border_color", "neural"):
        with pytest.raises(RuntimeError, match="device='cpu'"):
            tmat.compute_masks(frames, method=method)
    # the host methods need no device
    assert tmat.compute_masks(frames, method="median_background").shape == frames.shape[:3]


def test_neural_method_trains_caches_and_predicts(tmp_path, monkeypatch):
    from omfs4d_torch.track import segnet as tseg
    from tests.test_torch_detector import models

    monkeypatch.setenv("OMFS4D_CACHE", str(tmp_path / "cache"))
    _, tm = models()
    real = tseg.train_segnet
    monkeypatch.setattr(tseg, "train_segnet",
                        lambda *a, **kw: real(*a, batch_size=2, log_every=0, **kw))
    frames, _ = centered_subject(T=3)
    weights = tmp_path / "seg.npz"
    got = tmat.compute_masks(frames, method="neural", model=tm, weights=weights, image_size=32,
                             train_steps=2, device="cpu")
    assert weights.exists() and not (tmp_path / "cache").exists()
    assert got.shape == frames.shape[:3] and set(np.unique(got)) <= {0.0, 1.0}
    net = tseg.get_or_train_segnet(tm, weights=weights, device="cpu")
    np.testing.assert_array_equal(got, tseg.predict_masks(net, frames, image_size=32))
