"""The port's strict report (`omfs4d_torch.eval.reporting`) against the JAX
package's `omfs4d.eval.reporting`, on the CPU.

Both are host NumPy on uint8 frames: seeded frames go through every public
function of both, and the results must be equal (the arithmetic is the same,
in the same order).  The cases: the 99 dB cap on identical frames, the view
bucket boundaries (front < 0.2 or > 0.8, profile 0.35-0.65, rear the rest),
`psnr_unchanged` with and without a zero-offset baseline, and
`generate_report` on one model directory giving the same
`strict_scores.json`, row for row, and the same checklist.
"""

import json

import numpy as np
import pytest

from omfs4d.eval import reporting as jrep
from omfs4d_torch.eval import reporting as trep
from omfs4d_torch.io.video import write_image

H, W = 24, 32


def frames(seed, n=5, channels=3):
    rng = np.random.default_rng(seed)
    shape = (n, H, W, channels) if channels else (n, H, W)
    return rng.integers(0, 256, shape).astype(np.uint8)


def moved(base, seed, box=(4, 14, 6, 20), amount=60):
    """`base` with a block shifted in brightness: a stand-in for the pixels a
    surgical plan moves."""
    out = base.astype(np.int16)
    y0, y1, x0, x1 = box
    out[:, y0:y1, x0:x1] += amount
    out += np.random.default_rng(seed).integers(-2, 3, out.shape).astype(np.int16)
    return np.clip(out, 0, 255).astype(np.uint8)


def test_constants_match_the_reference():
    assert trep.PSNR_CAP_DB == jrep.PSNR_CAP_DB == 99.0
    assert trep.BUCKETS == jrep.BUCKETS
    assert trep.REVIEW_ITEMS == jrep.REVIEW_ITEMS
    np.testing.assert_array_equal(trep._LUMA, jrep._LUMA)
    assert (trep._SSIM_C1, trep._SSIM_C2) == (jrep._SSIM_C1, jrep._SSIM_C2)


@pytest.mark.parametrize("channels", [3, 0], ids=["rgb", "gray"])
def test_batch_metrics_match(channels):
    a, b = frames(0, channels=channels), frames(1, channels=channels)
    b[2] = a[2]                                   # one identical pair: the cap
    for name in ("psnr_batch", "ssim_global_batch"):
        got, want = getattr(trep, name)(a, b), getattr(jrep, name)(a, b)
        np.testing.assert_array_equal(got, want, err_msg=name)
    assert trep.psnr_batch(a, b)[2] == 99.0
    assert abs(trep.ssim_global_batch(a, b)[2] - 1.0) < 1e-12
    mod = moved(a, 2)
    mask_t = trep.changed_region_mask_batch(mod, a)
    np.testing.assert_array_equal(mask_t, jrep.changed_region_mask_batch(mod, a))
    assert 0 < mask_t.mean() < 1
    for thr, dil in ((8.0, 4), (20.0, 0), (1.0, 2)):
        np.testing.assert_array_equal(
            trep.changed_region_mask_batch(mod, a, threshold=thr, dilate=dil),
            jrep.changed_region_mask_batch(mod, a, threshold=thr, dilate=dil))
    exclude = mask_t.copy()
    exclude[3] = True                             # a frame with nothing left: nan
    got = trep.psnr_excluding_batch(mod, b, exclude)
    np.testing.assert_array_equal(got, jrep.psnr_excluding_batch(mod, b, exclude))
    assert np.isnan(got[3]) and np.isfinite(got[[0, 1, 2, 4]]).all()
    assert trep.psnr_excluding_batch(a, a, exclude)[0] == 99.0


def test_scalar_wrappers_and_the_cap():
    a, b = frames(3, n=1)[0], frames(4, n=1)[0]
    assert trep.psnr(a, a) == jrep.psnr(a, a) == 99.0
    assert trep.psnr(a, b) == jrep.psnr(a, b)
    assert trep.ssim_global(a, b) == jrep.ssim_global(a, b)
    # a known value: a constant error of 5 grey levels
    c = np.full((H, W, 3), 100, np.uint8)
    assert abs(trep.psnr(c, c + 5) - 10 * np.log10(255.0 ** 2 / 25.0)) < 1e-12


@pytest.mark.parametrize("p,want", [
    (0.0, "front"), (0.1999, "front"), (0.2, "rear"), (0.2001, "rear"), (0.3499, "rear"),
    (0.35, "profile"), (0.5, "profile"), (0.65, "profile"), (0.6501, "rear"),
    (0.8, "rear"), (0.8001, "front"), (1.0, "front")])
def test_bucket_boundaries(p, want):
    assert trep.bucket(p) == jrep.bucket(p) == want


def test_bucket_batch_matches():
    p = np.linspace(0.0, 1.0, 101)
    np.testing.assert_array_equal(trep.bucket_batch(p), jrep.bucket_batch(p))


def model_dir(root, n=7, iterations=(2, 10), baseline=True, gray=False):
    """A model directory with `train/ours_N/{renders,gt}` for each N, the
    renders of the newest moved from the GT in one block, a deterministic
    manifest, and (optionally) zero-offset baseline renders."""
    rng = np.random.default_rng(5)
    gt = rng.integers(0, 256, (n, H, W, 3)).astype(np.uint8)
    base = np.clip(gt.astype(int) + rng.integers(-6, 7, gt.shape), 0, 255).astype(np.uint8)
    pred = moved(base, 6)
    pred[1] = gt[1]                                    # a perfect frame: 99 dB
    names = [f"{i:05d}.png" for i in range(n)]
    for it in iterations:
        for d, imgs in (("renders", pred if it == max(iterations) else base), ("gt", gt)):
            for name, img in zip(names, imgs):
                write_image(root / "model" / "train" / f"ours_{it}" / d / name,
                            img.mean(-1).astype(np.uint8) if gray else img)
    if baseline:
        for i, (name, img) in enumerate(zip(names, base)):
            if i != 4:                                 # one frame has no baseline
                write_image(root / "baseline" / name, img.mean(-1).astype(np.uint8)
                            if gray else img)
    det = root / "det"
    det.mkdir()
    # a row with no render on disk still counts in the progress denominator
    rows = [{"index": i, "source": names[i], "exported": f"idx_{i:05d}.png"} for i in range(n)]
    rows.append({"index": 2 * n, "source": "missing.png", "exported": "idx_missing.png"})
    (det / "deterministic_indices_manifest.json").write_text(json.dumps({"exports": rows}))
    return root / "model", det


@pytest.mark.parametrize("baseline,gray", [(False, False), (True, False), (True, True)],
                         ids=["no-baseline", "baseline", "gray"])
def test_generate_report_matches_the_reference(tmp_path, baseline, gray):
    model, det = model_dir(tmp_path, baseline=baseline, gray=gray)
    bl = tmp_path / "baseline" if baseline else None
    rep_t = trep.generate_report(model, det, tmp_path / "t", baseline_renders_dir=bl)
    rep_j = jrep.generate_report(model, det, tmp_path / "j", baseline_renders_dir=bl)
    scores_t = json.loads((tmp_path / "t" / "strict_scores.json").read_text())
    scores_j = json.loads((tmp_path / "j" / "strict_scores.json").read_text())
    assert scores_t == scores_j == json.loads(json.dumps(rep_t))
    assert rep_t["summary"] == rep_j["summary"]
    assert len(scores_t["rows"]) == 7
    for row_t, row_j in zip(scores_t["rows"], scores_j["rows"]):
        assert row_t == row_j
    assert scores_t["rows"][1]["psnr"] == 99.0
    assert [r["bucket"] for r in scores_t["rows"]] == [
        jrep.bucket(i / 14) for i in range(7)]
    unchanged = [r for r in scores_t["rows"] if "psnr_unchanged" in r]
    if baseline:
        # every frame with a baseline of its shape, and only those
        assert [r["index"] for r in unchanged] == [0, 1, 2, 3, 5, 6]
        assert all(r["psnr_unchanged"] > r["psnr"] for r in unchanged if r["index"] != 1)
        assert "psnr_unchanged" in scores_t["summary"]["by_bucket"]["front"]
    else:
        assert not unchanged
    assert ((tmp_path / "t" / "human_review_checklist.md").read_text()
            == (tmp_path / "j" / "human_review_checklist.md").read_text())


def test_streamed_scores_equal_the_batch_functions(tmp_path):
    """`score_frame_pairs` streams frame by frame through scratch buffers;
    its numbers are the batch functions' on the stacked frames."""
    model, det = model_dir(tmp_path)
    latest = trep.find_latest_train_dir(model)
    rows = trep.score_frame_pairs(latest / "renders", latest / "gt",
                                  trep._read_manifest_rows(det),
                                  baseline_renders_dir=tmp_path / "baseline")
    renders = np.stack([trep.read_image(latest / "renders" / r["frame"]) for r in rows])
    gts = np.stack([trep.read_image(latest / "gt" / r["frame"]) for r in rows])
    np.testing.assert_allclose([r["psnr"] for r in rows], trep.psnr_batch(renders, gts),
                               rtol=0, atol=1e-12)
    np.testing.assert_allclose([r["ssim"] for r in rows],
                               trep.ssim_global_batch(renders, gts), rtol=0, atol=1e-12)
    keep = [r for r in rows if "psnr_unchanged" in r]
    base = np.stack([trep.read_image(tmp_path / "baseline" / r["frame"]) for r in keep])
    sel = [rows.index(r) for r in keep]
    mask = trep.changed_region_mask_batch(renders[sel], base)
    np.testing.assert_allclose([r["psnr_unchanged"] for r in keep],
                               trep.psnr_excluding_batch(renders[sel], gts[sel], mask),
                               rtol=0, atol=1e-12)


def test_latest_train_dir_summary_and_missing_inputs(tmp_path):
    model, det = model_dir(tmp_path, iterations=(2, 10, 9))
    assert trep.find_latest_train_dir(model) == jrep.find_latest_train_dir(model)
    assert trep.find_latest_train_dir(model).name == "ours_10"
    rows = [{"bucket": b, "psnr": 20.0 + i, "ssim": 0.5, **({"psnr_unchanged": 30.0}
                                                             if i % 2 else {})}
            for i, b in enumerate(["front", "rear", "front", "profile"])]
    assert trep.summarize(rows) == jrep.summarize(rows)
    assert trep.summarize([]) == jrep.summarize([])
    for pkg in (trep, jrep):
        with pytest.raises(FileNotFoundError):
            pkg.find_latest_train_dir(tmp_path / "nothing")
        with pytest.raises(FileNotFoundError):
            pkg.generate_report(model, tmp_path / "no_manifest", tmp_path / "out")
