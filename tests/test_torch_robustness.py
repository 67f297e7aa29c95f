"""The port's cross-distribution eval set against the JAX package's, on the CPU.

`shifted_eval_batch` draws from one `np.random.Generator` in the reference's
order, so one seed gives both packages the same faces: images atol 1e-4 (but
for <= 1e-3 of pixels: the mesh rasterizer's lists tie on coplanar
neighbours), labels atol 1e-5, alpha atol 1e-4 (same share).  `mask_iou` and
`detector_px_error` are held equal on the same inputs.
"""

import jax.numpy as jnp
import numpy as np
import pytest

from omfs4d.track import detector as jdet
from omfs4d.track import robustness as jrob
from omfs4d_torch import convert
from omfs4d_torch.track import robustness as trob
from tests.test_torch_detector import models, random_weights
from tests.test_torch_track import one_torch_thread  # noqa: F401  (autouse here too)

S = 64


@pytest.mark.parametrize("kw", [dict(), dict(occlude=False, photometrics=False,
                                             heldout_bg=False)],
                         ids=["all_shifts", "texture_and_formation_only"])
def test_shifted_eval_batch_matches_jax(kw):
    jm, tm = models()
    want = jrob.shifted_eval_batch(jm, n=6, image_size=S, seed=0, **kw)
    got = trob.shifted_eval_batch(tm, n=6, image_size=S, seed=0, **kw)
    for g, w in zip(got, want):
        assert g.shape == w.shape and g.dtype == w.dtype == np.float32
    imgs, lbls, alphas = got
    assert imgs.shape == (6, S, S, 3) and lbls.shape == (6, 68, 2) and alphas.shape == (6, S, S)
    np.testing.assert_allclose(lbls, want[1], atol=1e-5)
    off_img = (np.abs(imgs - want[0]).max(axis=-1) > 1e-4).mean()
    off_alpha = (np.abs(alphas - want[2]) > 1e-4).mean()
    assert off_img <= 1e-3 and off_alpha <= 1e-3, (off_img, off_alpha)
    assert 0.0 <= imgs.min() and imgs.max() <= 1.0
    if kw.get("occlude", True):
        assert alphas.min() == 0.0          # occluders zero the alpha label somewhere


@pytest.mark.parametrize("kind", jrob.TEXTURES)
def test_heldout_face_colors_match_jax(kind):
    jm, tm = models()
    want = jrob.heldout_face_colors(jm, kind, np.random.default_rng(4))
    got = trob.heldout_face_colors(tm, kind, np.random.default_rng(4))
    np.testing.assert_allclose(got, want, atol=1e-7)
    assert got.shape == (tm.faces.shape[0], 3) and got.min() >= 0.02 and got.max() <= 0.98


def test_unknown_texture_raises_and_the_helpers_draw_alike():
    _, tm = models()
    assert trob.TEXTURES == jrob.TEXTURES
    with pytest.raises(ValueError, match="plaid"):
        trob.heldout_face_colors(tm, "plaid", np.random.default_rng(0))
    np.testing.assert_array_equal(trob._heldout_background(S, np.random.default_rng(2)),
                                  jrob._heldout_background(S, np.random.default_rng(2)))
    img, alpha = np.ones((S, S, 3)), np.ones((S, S), np.float32)
    a = trob._occlude(img.copy(), alpha.copy(), np.random.default_rng(3))
    b = jrob._occlude(img.copy(), alpha.copy(), np.random.default_rng(3))
    np.testing.assert_array_equal(a[0], b[0])
    np.testing.assert_array_equal(a[1], b[1])
    assert a[1].min() == 0.0


def test_metrics_match_jax():
    jm, tm = models()
    imgs, lbls, alphas = trob.shifted_eval_batch(tm, n=3, image_size=S, seed=1)
    flat = random_weights(jdet.init_net, n_landmarks=68, image_size=S)
    net = convert.detector_params_from_numpy(flat, "cpu")
    want = jrob.detector_px_error({k: jnp.asarray(v) for k, v in flat.items()}, imgs, lbls)
    got = trob.detector_px_error(net, imgs, lbls)
    np.testing.assert_allclose(got, want, rtol=1e-5)
    assert isinstance(got, float) and 1.0 < got < S
    rng = np.random.default_rng(0)
    pred = rng.uniform(0, 1, alphas.shape).astype(np.float32)
    assert trob.mask_iou(pred, alphas) == jrob.mask_iou(pred, alphas)
    assert trob.mask_iou(alphas, alphas) == 1.0
    assert trob.mask_iou(np.zeros_like(alphas), np.zeros_like(alphas)) == 0.0
    assert trob.mask_iou(pred, alphas, threshold=0.9) == jrob.mask_iou(pred, alphas,
                                                                       threshold=0.9)
