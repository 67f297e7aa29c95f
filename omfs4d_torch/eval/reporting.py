"""Strict validation scoring — deterministic PSNR/SSIM grouped by view bucket.

Port of `omfs4d.eval.reporting`: host NumPy, carried across as written, with
frames read by this package's own PNG reader.  Output contract as the
reference's (ref: validation_reporting.py:16-121):
``strict_scores.json`` with per-frame rows + per-bucket summary, the 99.0 dB
PSNR cap for identical uint8 frames, temporal-progress bucket boundaries
(front: <0.2 or >0.8; profile: 0.35-0.65; rear: the rest), and a
human-review checklist markdown.  The implementation here is vectorized:
frame pairs are stacked per shape group and scored with batched numpy
reductions rather than a per-frame Python loop.
"""

from __future__ import annotations

import json
from pathlib import Path

import numpy as np

from omfs4d_torch.core.logging import get_logger
from omfs4d_torch.io.video import read_image

log = get_logger("validation_reporting")

PSNR_CAP_DB = 99.0
_LUMA = np.array([0.299, 0.587, 0.114], np.float64)
_SSIM_C1 = (0.01 * 255.0) ** 2
_SSIM_C2 = (0.03 * 255.0) ** 2

#: temporal-progress bucket boundaries (ref: validation_reporting.py:40-45)
BUCKETS = ("front", "profile", "rear")


def _f32(a: np.ndarray) -> np.ndarray:
    """View/convert to float32 without copying when already float32.

    All metric pipelines convert ONCE to f32 and accumulate reductions in
    f64 via einsum's dtype — full-size f64 temporaries measured 16 s of
    page-fault time per report on the 1-core host.  uint8 differences and
    their squares are exact in f32 (|d| <= 255, d^2 <= 2^16 < 2^24), so
    PSNR is bit-identical to the old f64 path."""
    return np.asarray(a, np.float32)


def psnr_batch(a: np.ndarray, b: np.ndarray) -> np.ndarray:
    """Batched PSNR on (N, ...) 0-255 arrays; zero-MSE frames hit the cap."""
    d = _f32(a).reshape(len(a), -1) - _f32(b).reshape(len(b), -1)
    mse = np.einsum("np,np->n", d, d, dtype=np.float64) / d.shape[1]
    with np.errstate(divide="ignore"):
        db = 10.0 * np.log10(255.0**2 / mse)
    return np.where(mse == 0.0, PSNR_CAP_DB, db)


def ssim_global_batch(a: np.ndarray, b: np.ndarray) -> np.ndarray:
    """Batched single-window SSIM on luma for (N, H, W[, 3]) 0-255 arrays.

    Uses whole-image statistics (one window) — the strict-gate convention,
    not the windowed perceptual SSIM.
    """
    a = _f32(a)
    b = _f32(b)
    if a.ndim == 4:
        a = a @ _LUMA.astype(np.float32)
    if b.ndim == 4:
        b = b @ _LUMA.astype(np.float32)
    x = a.reshape(len(a), -1)
    y = b.reshape(len(b), -1)
    mx = x.mean(axis=1, dtype=np.float64).astype(np.float32)
    my = y.mean(axis=1, dtype=np.float64).astype(np.float32)
    xc, yc = x - mx[:, None], y - my[:, None]
    vx = np.einsum("np,np->n", xc, xc, dtype=np.float64) / x.shape[1]
    vy = np.einsum("np,np->n", yc, yc, dtype=np.float64) / y.shape[1]
    cov = np.einsum("np,np->n", xc, yc, dtype=np.float64) / x.shape[1]
    mx, my = mx.astype(np.float64), my.astype(np.float64)
    num = (2.0 * mx * my + _SSIM_C1) * (2.0 * cov + _SSIM_C2)
    den = (mx * mx + my * my + _SSIM_C1) * (vx + vy + _SSIM_C2)
    return num / den


def changed_region_mask_batch(
    modified: np.ndarray, baseline: np.ndarray,
    threshold: float = 8.0, dilate: int = 4,
) -> np.ndarray:
    """(N, H, W) bool masks of surgically CHANGED pixels.

    A modified prediction differs from the zero-offset baseline render
    exactly where the surgical plan moved anatomy; comparing those pixels
    to the unmodified ground truth is meaningless (they are SUPPOSED to
    differ).  The mask is a luma |modified - baseline| > threshold test,
    box-dilated so soft edges of the moved region are excluded too.
    """
    a = _f32(modified)
    b = _f32(baseline)
    if a.ndim == 4:
        a = a @ _LUMA.astype(np.float32)
    if b.ndim == 4:
        b = b @ _LUMA.astype(np.float32)
    mask = np.abs(a - b) > threshold
    for _ in range(dilate):  # 3x3 box dilation via shifted ORs
        m = mask.copy()
        m[:, 1:] |= mask[:, :-1]
        m[:, :-1] |= mask[:, 1:]
        m[:, :, 1:] |= mask[:, :, :-1]
        m[:, :, :-1] |= mask[:, :, 1:]
        mask = m
    return mask


def psnr_excluding_batch(a: np.ndarray, b: np.ndarray,
                         exclude: np.ndarray) -> np.ndarray:
    """Batched PSNR over only the pixels NOT in ``exclude`` (N, H, W).

    Frames that are entirely excluded score nan (no unchanged pixels).
    """
    keep = ~exclude
    d = _f32(a) - _f32(b)
    if d.ndim == 4:
        d = np.einsum("nhwc,nhwc->nhw", d, d)   # exact: d^2 <= 2^16 < 2^24
        n_ch = a.shape[-1]
    else:
        d = d * d
        n_ch = 1
    counts = keep.sum(axis=(1, 2)) * n_ch
    sse = np.einsum("nhw,nhw->n", d, keep.astype(np.float32),
                    dtype=np.float64)
    with np.errstate(divide="ignore", invalid="ignore"):
        mse = sse / counts
        db = 10.0 * np.log10(255.0**2 / mse)
    return np.where(counts == 0, np.nan,
                    np.where(mse == 0.0, PSNR_CAP_DB, db))


_LUMA32 = _LUMA.astype(np.float32)


def _luma_into(a: np.ndarray, out: np.ndarray) -> np.ndarray:
    if a.ndim == 2:
        np.copyto(out, a)
        return out
    return np.matmul(a, _LUMA32, out=out)


def _psnr_pair(a: np.ndarray, b: np.ndarray, s: dict) -> float:
    d = s["c"]
    np.subtract(a, b, out=d)
    sse = float(np.einsum("hwc,hwc->", d, d, dtype=np.float64)
                if d.ndim == 3 else
                np.einsum("hw,hw->", d, d, dtype=np.float64))
    mse = sse / d.size
    if mse == 0.0:
        return PSNR_CAP_DB
    return 10.0 * float(np.log10(255.0**2 / mse))


def _ssim_pair(a: np.ndarray, b: np.ndarray, s: dict) -> float:
    x = _luma_into(a, s["pa"])
    y = _luma_into(b, s["pb"])
    mx = float(np.float32(x.mean(dtype=np.float64)))
    my = float(np.float32(y.mean(dtype=np.float64)))
    x -= np.float32(mx)
    y -= np.float32(my)
    n = x.size
    vx = float(np.einsum("hw,hw->", x, x, dtype=np.float64)) / n
    vy = float(np.einsum("hw,hw->", y, y, dtype=np.float64)) / n
    cov = float(np.einsum("hw,hw->", x, y, dtype=np.float64)) / n
    num = (2.0 * mx * my + _SSIM_C1) * (2.0 * cov + _SSIM_C2)
    den = (mx * mx + my * my + _SSIM_C1) * (vx + vy + _SSIM_C2)
    return num / den


def _psnr_unchanged_pair(a: np.ndarray, gt: np.ndarray, bl: np.ndarray,
                         s: dict, threshold: float = 8.0,
                         dilate: int = 4) -> float:
    """Streamed equivalent of changed_region_mask_batch +
    psnr_excluding_batch for one frame (same constants, same math)."""
    la = _luma_into(a, s["pa"])
    lb = _luma_into(bl, s["pb"])
    np.subtract(la, lb, out=la)
    np.abs(la, out=la)
    mask, m2 = s["m"], s["m2"]
    np.greater(la, threshold, out=mask)
    for _ in range(dilate):
        np.copyto(m2, mask)
        m2[1:] |= mask[:-1]
        m2[:-1] |= mask[1:]
        m2[:, 1:] |= mask[:, :-1]
        m2[:, :-1] |= mask[:, 1:]
        mask, m2 = m2, mask
    if a.ndim == 3:
        d3 = s["c"]
        np.subtract(a, gt, out=d3)
        d2 = np.einsum("hwc,hwc->hw", d3, d3, out=s["pb"])
        n_ch = a.shape[-1]
    else:
        d2 = np.subtract(a, gt, out=s["pb"])
        np.multiply(d2, d2, out=d2)
        n_ch = 1
    keepf = s["pa"]
    np.logical_not(mask, out=m2)
    np.copyto(keepf, m2)
    count = float(m2.sum()) * n_ch
    if count == 0:
        return float("nan")
    sse = float(np.einsum("hw,hw->", d2, keepf, dtype=np.float64))
    mse = sse / count
    if mse == 0.0:
        return PSNR_CAP_DB
    return 10.0 * float(np.log10(255.0**2 / mse))


def psnr(a: np.ndarray, b: np.ndarray) -> float:
    """Scalar convenience wrapper over :func:`psnr_batch`."""
    return float(psnr_batch(a[None], b[None])[0])


def ssim_global(a: np.ndarray, b: np.ndarray) -> float:
    """Scalar convenience wrapper over :func:`ssim_global_batch`."""
    return float(ssim_global_batch(a[None], b[None])[0])


def bucket_batch(progress: np.ndarray) -> np.ndarray:
    """Vectorized temporal-progress -> view-bucket mapping."""
    p = np.asarray(progress, np.float64)
    return np.select(
        [(p < 0.20) | (p > 0.80), (p >= 0.35) & (p <= 0.65)],
        ["front", "profile"],
        default="rear",
    )


def bucket(progress: float) -> str:
    return str(bucket_batch(np.asarray([progress]))[0])


def find_latest_train_dir(model_path: Path) -> Path:
    """Highest-iteration ``train/ours_N`` directory under a model path."""
    candidates = sorted(
        Path(model_path).glob("train/ours_*"),
        key=lambda p: int(p.name.rsplit("_", 1)[1]) if p.is_dir() else -1,
    )
    if not candidates:
        raise FileNotFoundError(
            f"no train/ours_* directories under {model_path}"
        )
    return candidates[-1]


REVIEW_ITEMS = (
    "Jaw contour stays continuous when the head turns to profile.",
    "Both ears keep plausible shape in left and right profile views.",
    "The head-to-neck boundary does not drift or tear during motion.",
    "Slow rotations show no frame-to-frame shimmer or popping gaussians.",
    "Maxilla/mandible displacement looks surgically plausible, not rubbery.",
)


def _write_checklist(path: Path) -> None:
    lines = ["# Human Review Checklist", ""]
    lines += [f"- [ ] {item}" for item in REVIEW_ITEMS]
    path.write_text("\n".join(lines) + "\n", encoding="utf-8")


def _read_manifest_rows(deterministic_frames_dir: Path) -> list[dict]:
    manifest = deterministic_frames_dir / "deterministic_indices_manifest.json"
    if not manifest.exists():
        raise FileNotFoundError(f"deterministic manifest not found: {manifest}")
    return json.loads(manifest.read_text(encoding="utf-8")).get("exports", [])


def score_frame_pairs(
    renders_dir: Path, gt_dir: Path, rows: list[dict],
    baseline_renders_dir: Path | None = None,
) -> list[dict]:
    """Score every manifest row whose render+GT pair exists on disk.

    Pairs are grouped by image shape and scored with the batched metrics —
    one numpy reduction per shape group instead of per frame.

    ``baseline_renders_dir`` (the ZERO-OFFSET render of the same frames)
    enables the region-excluded metric for surgically modified
    predictions: pixels the surgery moved (|modified - baseline| above a
    luma threshold, dilated) are excluded and each row gains
    ``psnr_unchanged`` — "did the prediction corrupt anything it was not
    supposed to touch?".  Raw ``psnr`` against unmoved GT is inherently
    capped for modified anatomy and stays labeled as-is.
    """
    # progress denominator spans ALL manifest rows, not just the pairs that
    # exist on disk — trailing missing renders must not shift the view-bucket
    # assignment (parity: validation_reporting.py:83)
    denom = max([1] + [int(r["index"]) for r in rows])
    indices, names, renders, gts, baselines = [], [], [], [], []
    for row in rows:
        name = row["source"]
        rp, gp = renders_dir / name, gt_dir / name
        if rp.exists() and gp.exists():
            indices.append(int(row["index"]))
            names.append(name)
            renders.append(read_image(rp))
            gts.append(read_image(gp))
            if baseline_renders_dir is not None:
                bp = Path(baseline_renders_dir) / name
                baselines.append(read_image(bp) if bp.exists() else None)
    if not indices:
        return []
    progress = np.asarray(indices, np.float64) / denom
    buckets = bucket_batch(progress)

    # Streamed per-frame scoring with SHAPE-KEYED preallocated scratch:
    # stacking all frames and converting to float batches measured ~20 s of
    # page-fault time per report on the 1-core microVM host (every fresh
    # large allocation faults page-by-page).  The math is identical to the
    # batch functions: exact f32 products, f64 einsum accumulation.
    psnr_vals = np.empty(len(indices))
    ssim_vals = np.empty(len(indices))
    unchanged_vals = np.full(len(indices), np.nan)
    scratch: dict[tuple, dict] = {}

    def bufs(shape):
        if shape not in scratch:
            scratch[shape] = {
                "a": np.empty(shape, np.float32),
                "b": np.empty(shape, np.float32),
                "c": np.empty(shape, np.float32),
                "pa": np.empty(shape[:2], np.float32),
                "pb": np.empty(shape[:2], np.float32),
                "m": np.empty(shape[:2], bool),
                "m2": np.empty(shape[:2], bool),
            }
        return scratch[shape]

    for i in range(len(indices)):
        s = bufs(renders[i].shape)
        a, b = s["a"], s["b"]
        np.copyto(a, renders[i])
        np.copyto(b, gts[i])
        psnr_vals[i] = _psnr_pair(a, b, s)
        ssim_vals[i] = _ssim_pair(a, b, s)
        if (baselines and baselines[i] is not None
                and baselines[i].shape == renders[i].shape):
            np.copyto(s["c"], baselines[i])
            unchanged_vals[i] = _psnr_unchanged_pair(a, b, s["c"], s)

    out = []
    for i in range(len(indices)):
        row = {
            "index": indices[i],
            "frame": names[i],
            "progress": float(progress[i]),
            "bucket": str(buckets[i]),
            "psnr": float(psnr_vals[i]),
            "ssim": float(ssim_vals[i]),
        }
        if not np.isnan(unchanged_vals[i]):
            row["psnr_unchanged"] = float(unchanged_vals[i])
        out.append(row)
    return out


def summarize(rows: list[dict]) -> dict:
    """Per-bucket mean PSNR/SSIM over scored rows."""
    by_bucket = {}
    for name in BUCKETS:
        sel = [r for r in rows if r["bucket"] == name]
        entry = {
            "count": len(sel),
            "psnr": float(np.mean([r["psnr"] for r in sel])) if sel else None,
            "ssim": float(np.mean([r["ssim"] for r in sel])) if sel else None,
        }
        unch = [r["psnr_unchanged"] for r in sel if "psnr_unchanged" in r]
        if unch:
            entry["psnr_unchanged"] = float(np.mean(unch))
        by_bucket[name] = entry
    return {"count": len(rows), "by_bucket": by_bucket}


def generate_report(model_path, deterministic_frames_dir, output_dir,
                    baseline_renders_dir=None) -> dict:
    """Score the deterministic frame subset vs GT; emit strict_scores.json.

    Pass ``baseline_renders_dir`` (zero-offset renders of the same frames)
    when scoring a surgically MODIFIED prediction — rows then also carry
    ``psnr_unchanged`` (moved-anatomy pixels excluded; see
    :func:`changed_region_mask_batch`).
    """
    latest = find_latest_train_dir(Path(model_path))
    renders_dir, gt_dir = latest / "renders", latest / "gt"
    missing = [d for d in (renders_dir, gt_dir) if not d.exists()]
    if missing:
        raise FileNotFoundError(f"missing render outputs: {missing}")

    rows = score_frame_pairs(
        renders_dir, gt_dir,
        _read_manifest_rows(Path(deterministic_frames_dir)),
        baseline_renders_dir=baseline_renders_dir,
    )
    report = {"summary": summarize(rows), "rows": rows}

    out = Path(output_dir)
    out.mkdir(parents=True, exist_ok=True)
    scores_path = out / "strict_scores.json"
    scores_path.write_text(json.dumps(report, indent=2), encoding="utf-8")
    _write_checklist(out / "human_review_checklist.md")
    log.info(f"Wrote strict report: {scores_path}")
    return report
