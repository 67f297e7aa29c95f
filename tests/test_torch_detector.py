"""The port's landmark detector against the JAX package's, on the CPU.

Same inputs, made from a seed with numpy, go through both packages:

  * `net_apply` on the same weights (carried across by `convert.py`) at 64^2,
    96^2 and the odd size 75: output atol 1e-5; the gradient of the training
    loss (Huber, delta 0.05) for every weight atol 2e-4 * max|g|, rtol 2e-3
    (max|g| of that weight, and no less than a twentieth of the largest);
  * one .npz written by either package loads in the other;
  * the sampler's picture: the draws of the reference's `_sample_one` are
    rebuilt from a JAX key and fed to the port's `picture`: labels atol 1e-4
    (normalized), image and alpha label atol 1e-4 but for at most 2e-3 of the
    pixels (coplanar neighbour splats tie in the depth key and may swap);
  * the port's own draws: ranges and moments over 4,000 draws;
  * a 20-step training run on the same injected batches: loss curve rel 2e-3;
    `detect` on a uint8 stack atol 0.05 px.

The JAX sampler runs with `backend="never"`, as its own tests run it.
"""

import functools
import math

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from omfs4d.models import flame as jf
from omfs4d.models.assets import synthetic_flame_asset
from omfs4d.track import detector as jdet
from omfs4d_torch import convert
from omfs4d_torch.track import detector as tdet
from omfs4d_torch.train.trainer import adam_init
from tests.test_torch_track import one_torch_thread  # noqa: F401  (autouse here too)

S = 64
GRAD_TOL = 2e-4, 2e-3      # atol * max|reference gradient|, rtol


@functools.cache
def models():
    jm = jf.FlameModel.from_asset(synthetic_flame_asset(n_vertices=700, seed=0))
    return jm, convert.flame_model_from_numpy(jax.tree_util.tree_map(np.asarray, jm)._asdict())


def jax_flat(params) -> dict:
    return {k: np.asarray(v) for k, v in params.items()}


def random_weights(init, seed=0, **kw):
    """The reference's init with every bias (and log_temp) moved off zero."""
    rng = np.random.default_rng(seed)
    flat = jax_flat(init(jax.random.PRNGKey(seed), **kw))
    for k, v in flat.items():
        if k.endswith("/b") or k.endswith("log_temp"):
            flat[k] = (0.1 * rng.normal(size=v.shape)).astype(np.float32)
    return flat


def assert_grads_close(got: dict, want: dict):
    assert sorted(got) == sorted(want)
    # a gradient that is zero in exact arithmetic (the head's bias under the
    # softmax) is rounding noise of size ~1e-6 of the largest gradient in both
    # packages: a weight's scale is at least a twentieth of the largest one
    floor = 0.05 * max(np.abs(w).max() for w in want.values())
    for k, w in want.items():
        scale = max(np.abs(w).max(), floor)
        np.testing.assert_allclose(got[k], w, atol=GRAD_TOL[0] * scale, rtol=GRAD_TOL[1],
                                   err_msg=k)


def torch_grads(net, loss) -> dict:
    """Gradients of every weight, under the reference's flat names (HWIO)."""
    names = [n for n, _ in net.named_parameters()]
    grads = torch.autograd.grad(loss, list(net.parameters()))
    out = {}
    for n, g in zip(names, grads):
        g = g.numpy()
        if n.endswith(".weight"):
            out[n[:-7] + "/w"] = g.transpose(2, 3, 1, 0)
        elif n.endswith(".bias"):
            out[n[:-5] + "/b"] = g
        else:
            out["head/" + n] = g
    return out


# ── the net ──────────────────────────────────────────────────


def test_same_pad_is_xla_same():
    for n, k, s, want in [(64, 3, 2, (0, 1)), (75, 3, 2, (1, 1)), (96, 3, 1, (1, 1)),
                          (12, 1, 1, (0, 0)), (9, 5, 1, (2, 2))]:
        x = torch.ones(1, 1, n, n)
        padded = tdet.same_pad(x, k, s)
        lo = int((padded[0, 0, :, n // 2] == 0).nonzero().min()) == 0 if want[0] else False
        assert padded.shape[-1] == n + sum(want), (n, k, s)
        assert bool(padded[0, 0, 0, 0] == 0) == bool(want[0]) == lo
        assert bool(padded[0, 0, -1, -1] == 0) == bool(want[1])


@pytest.mark.parametrize("size", [64, 96, 75])
def test_net_apply_value_and_gradients_match_jax(size):
    L = 68
    flat = random_weights(jdet.init_net, n_landmarks=L, image_size=size)
    net = convert.detector_params_from_numpy(flat, "cpu")
    rng = np.random.default_rng(size)
    images = rng.uniform(0, 1, (2, size, size, 3)).astype(np.float32)
    labels = rng.uniform(0.2, 0.8, (2, L, 2)).astype(np.float32)

    jp = {k: jnp.asarray(v) for k, v in flat.items()}
    want = np.asarray(jdet.net_apply(jp, jnp.asarray(images)))
    got = tdet.net_apply(net, torch.from_numpy(images))
    assert got.shape == (2, L, 2)
    np.testing.assert_allclose(got.detach().numpy(), want, atol=1e-5)

    def loss_fn(p):
        pred = jdet.net_apply(p, jnp.asarray(images))
        return jnp.mean(optax.huber_loss(pred, jnp.asarray(labels), delta=0.05))

    jl, jg = jax.value_and_grad(loss_fn)(jp)
    loss = tdet.detector_loss(net, torch.from_numpy(images), torch.from_numpy(labels))
    np.testing.assert_allclose(float(loss.detach()), float(jl), rtol=1e-5)
    jg = jax_flat(jg)
    jg.pop("meta/size")
    assert_grads_close(torch_grads(net, loss), jg)


def test_init_net_statistics_and_layout():
    gen = torch.Generator().manual_seed(0)
    net = tdet.init_net(gen, 68, 96)
    ref = jax_flat(jdet.init_net(jax.random.PRNGKey(0), 68, 96))
    flat = convert.net_params_to_numpy(net)
    assert {k: v.shape for k, v in flat.items()} == {k: v.shape for k, v in ref.items()}
    assert float(flat["meta/size"]) == 96.0 and flat["meta/size"].dtype == np.float32
    for k, v in flat.items():
        if k.endswith("/w"):
            fan_in = v.shape[0] * v.shape[1] * v.shape[2]
            want = math.sqrt(2.0 / fan_in) * (0.1 if k == "head/w" else 1.0)
            np.testing.assert_allclose(v.std(), want, rtol=0.1, err_msg=k)
            np.testing.assert_allclose(v.std(), ref[k].std(), rtol=0.15, err_msg=k)
        elif k != "meta/size":
            assert not v.any(), k
    # another seed, other weights
    other = convert.net_params_to_numpy(
        tdet.init_net(torch.Generator().manual_seed(1), 68, 96))
    assert not np.allclose(other["conv0/w"], flat["conv0/w"])


def test_one_npz_loads_in_both_packages(tmp_path):
    rng = np.random.default_rng(0)
    images = rng.uniform(0, 1, (2, S, S, 3)).astype(np.float32)
    # written by the reference, read by the port
    flat = random_weights(jdet.init_net, n_landmarks=68, image_size=S)
    jdet.save_detector(tmp_path / "jax.npz", {k: jnp.asarray(v) for k, v in flat.items()})
    net = tdet.load_detector(tmp_path / "jax.npz", "cpu")
    assert int(net.size) == S
    want = np.asarray(jdet.net_apply(jdet.load_detector(tmp_path / "jax.npz"),
                                     jnp.asarray(images)))
    np.testing.assert_allclose(tdet.net_apply(net, torch.from_numpy(images)).detach().numpy(),
                               want, atol=1e-5)
    # written by the port, read by the reference
    net2 = tdet.init_net(torch.Generator().manual_seed(3), 68, S)
    tdet.save_detector(tmp_path / "deep" / "torch.npz", net2)
    jp = jdet.load_detector(tmp_path / "deep" / "torch.npz")
    assert sorted(jp) == sorted(flat)
    np.testing.assert_allclose(np.asarray(jdet.net_apply(jp, jnp.asarray(images))),
                               tdet.net_apply(net2, torch.from_numpy(images)).detach().numpy(),
                               atol=1e-5)
    # and the flat dict round-trips through convert.py
    back = convert.net_params_to_numpy(convert.detector_params_from_numpy(flat, "cpu"))
    for k, v in flat.items():
        np.testing.assert_array_equal(back[k], v)


# ── the sampler ──────────────────────────────────────────────


def jax_draws(key, n_expr: int, n_faces: int, size: int) -> dict:
    """The random quantities of the reference's `_sample_one`, in its order
    of keys, under the names of the port's `draw_batch` (no batch axis)."""
    u, n = jax.random.uniform, jax.random.normal
    ks = jax.random.split(key, 12)
    kt = jax.random.split(ks[11], 16)
    kb = jax.random.split(kt[15], 10)
    d = {
        "expr": 0.5 * n(ks[0], (1, n_expr))[0],
        "jaw_pose": jnp.concatenate([u(ks[1], (1, 1), minval=0.0, maxval=0.35),
                                     0.05 * n(ks[2], (1, 2))], axis=1)[0],
        "rotation": jnp.stack([u(ks[3], (), minval=-0.3, maxval=0.3),
                               u(ks[4], (), minval=-0.6, maxval=0.6),
                               u(ks[5], (), minval=-0.2, maxval=0.2)]),
        "translation": 0.02 * n(ks[6], (1, 3))[0],
        "angle": u(ks[7], (), minval=-0.7, maxval=0.7),
        "radius": u(ks[8], (), minval=0.45, maxval=0.8),
        "height": 0.12 * n(ks[9], ()),
        "focal": size * u(ks[10], (), minval=1.3, maxval=2.2),
        "wave_dirs": n(kt[0], (3, 3)),
        "wave_freq": u(kt[1], (3,), minval=3.0, maxval=25.0),
        "wave_phase": u(kt[2], (3,), minval=0.0, maxval=2 * jnp.pi),
        "speckle": u(kt[3], (n_faces, 3)),
        "blotch_dir": n(kt[4], (3,)),
        "blotch_freq": u(kt[5], (), minval=3.0, maxval=15.0),
        "blotch_phase": u(kt[6], (), minval=0.0, maxval=2 * jnp.pi),
        "palette": u(kt[7], (2, 3)),
        "mix": u(kt[8], (3,), minval=0.05, maxval=1.0),
        "light_dir": n(kt[9], (3,)),
        "ambient": u(kt[10], (), minval=0.35, maxval=0.75),
        "diffuse": u(kt[11], (), minval=0.25, maxval=0.65),
        "bank_gain": u(kt[13], (), minval=0.7, maxval=1.3),
        "use_bank": jax.random.bernoulli(kt[14], 0.5),
        "bg_a": u(kb[0], (3,)),
        "bg_b": u(kb[1], (3,)),
        "bg_theta": u(kb[2], (), minval=0.0, maxval=2 * jnp.pi),
        "bg_solid": jax.random.bernoulli(kb[3], 0.25),
        "gain": u(kb[4], (), minval=0.55, maxval=1.35),
        "bias": u(kb[5], (), minval=-0.1, maxval=0.15),
        "noise": 0.02 * n(kb[6], (size, size, 3)),
        "blur_sigma": u(kb[8], (), minval=0.3, maxval=1.2),
        "blur_on": jax.random.bernoulli(kb[9], 0.5),
    }
    cuts = {"cut_on": [], "cut_center": [], "cut_half": [], "cut_color": []}
    for kc in jax.random.split(kb[7], 2):
        kc1, kc2, kc3, kc4 = jax.random.split(kc, 4)
        cuts["cut_on"].append(jax.random.bernoulli(kc1, 0.5))
        cuts["cut_center"].append(u(kc2, (2,), minval=0.0, maxval=1.0) * size)
        cuts["cut_half"].append(u(kc3, (2,), minval=0.06, maxval=0.16))
        cuts["cut_color"].append(u(kc4, (3,)))
    d.update({k: jnp.stack(v) for k, v in cuts.items()})
    return {k: np.asarray(v) for k, v in d.items()}


def jax_batch_draws(key, batch_size: int, n_tex: int, **kw) -> dict:
    """The draws of the reference's `SyntheticFaceSampler.batch(key, B)`."""
    kt, ks = jax.random.split(key)
    tex_idx = np.asarray(jax.random.randint(kt, (batch_size,), 0, n_tex))
    per = [jax_draws(k, **kw) for k in jax.random.split(ks, batch_size)]
    d = {k: torch.from_numpy(np.stack([p[k] for p in per])) for k in per[0]}
    d["bank_index"] = torch.tensor(tex_idx).long()
    return d


def test_picture_on_the_reference_draws_matches_the_jax_sample():
    jm, tm = models()
    B = 3
    key = jax.random.PRNGKey(5)
    jsampler = jdet.SyntheticFaceSampler(jm, image_size=S, backend="never")
    want_img, want_lbl, want_alpha = (np.asarray(a) for a in jsampler.batch(key, B))
    tsampler = tdet.SyntheticFaceSampler(tm, image_size=S)
    draws = jax_batch_draws(key, B, 4, n_expr=jm.shapedirs_expr.shape[-1],
                            n_faces=jm.faces.shape[0], size=S)
    # the rebuilt draws carry the names and shapes of the port's own
    own = tsampler.draw(torch.Generator().manual_seed(0), B)
    assert {k: (v.shape, v.dtype) for k, v in own.items()} == \
        {k: (v.shape, v.dtype) for k, v in draws.items()}
    img, lbl, alpha = (t.numpy() for t in tsampler.picture(draws))
    assert img.shape == (B, S, S, 3) and lbl.shape == (B, 68, 2) and alpha.shape == (B, S, S)
    np.testing.assert_allclose(lbl, want_lbl, atol=1e-4)
    # coplanar neighbour splats tie in the quantized depth key: a swapped
    # pair changes a few pixels; everything else agrees to 1e-4
    off_img = (np.abs(img - want_img).max(axis=-1) > 1e-4).mean()
    off_alpha = (np.abs(alpha - want_alpha) > 1e-4).mean()
    assert off_img <= 2e-3 and off_alpha <= 2e-3, (off_img, off_alpha)
    assert np.abs(img - want_img).mean() < 1e-5
    assert 0.05 < (alpha > 0.5).mean() < 0.95


def test_look_at_matches_jax():
    rng = np.random.default_rng(0)
    eye = rng.normal(size=(5, 3)).astype(np.float32)
    got = tdet._look_at_w2c(torch.from_numpy(eye), torch.zeros(5, 3)).numpy()
    for i in range(5):
        want = np.asarray(jdet._look_at_w2c(jnp.asarray(eye[i]), jnp.zeros(3)))
        np.testing.assert_allclose(got[i], want, atol=1e-6)


RANGES = {     # uniform draws: (low, high)
    "angle": (-0.7, 0.7), "radius": (0.45, 0.8), "wave_freq": (3.0, 25.0),
    "wave_phase": (0.0, 2 * math.pi), "speckle": (0.0, 1.0), "blotch_freq": (3.0, 15.0),
    "blotch_phase": (0.0, 2 * math.pi), "palette": (0.0, 1.0), "mix": (0.05, 1.0),
    "ambient": (0.35, 0.75), "diffuse": (0.25, 0.65), "bank_gain": (0.7, 1.3),
    "bg_a": (0.0, 1.0), "bg_b": (0.0, 1.0), "bg_theta": (0.0, 2 * math.pi),
    "gain": (0.55, 1.35), "bias": (-0.1, 0.15), "blur_sigma": (0.3, 1.2),
    "cut_half": (0.06, 0.16), "cut_color": (0.0, 1.0),
}
NORMALS = {"expr": 0.5, "translation": 0.02, "height": 0.12, "wave_dirs": 1.0,
           "blotch_dir": 1.0, "light_dir": 1.0, "noise": 0.02}
COINS = {"use_bank": 0.5, "bg_solid": 0.25, "blur_on": 0.5, "cut_on": 0.5}


def test_draws_have_the_reference_ranges_and_moments():
    n, size = 4000, 8
    d = tdet.draw_batch(torch.Generator().manual_seed(0), n, n_expr=10, n_faces=6,
                        image_size=size, n_textures=4)
    d = {k: v.numpy() for k, v in d.items()}
    assert sorted(d) == sorted([*RANGES, *NORMALS, *COINS, "jaw_pose", "rotation", "focal",
                                "cut_center", "bank_index"])
    uniform = dict(RANGES, focal=(1.3 * size, 2.2 * size), cut_center=(0.0, float(size)))
    cols = {"jaw0": (d["jaw_pose"][:, 0], (0.0, 0.35)), "rot0": (d["rotation"][:, 0], (-0.3, 0.3)),
            "rot1": (d["rotation"][:, 1], (-0.6, 0.6)), "rot2": (d["rotation"][:, 2], (-0.2, 0.2)),
            **{k: (d[k], r) for k, r in uniform.items()}}
    for name, (v, (lo, hi)) in cols.items():
        assert v.shape[0] == n and lo <= v.min() and v.max() <= hi, name
        tol = 4 * (hi - lo) / math.sqrt(12 * v.size) + 1e-3 * (hi - lo)
        assert abs(v.mean() - (lo + hi) / 2) < tol, name
        np.testing.assert_allclose(v.std(), (hi - lo) / math.sqrt(12), rtol=0.05, err_msg=name)
        assert v.min() < lo + 0.02 * (hi - lo) and v.max() > hi - 0.02 * (hi - lo), name
    normals = dict(NORMALS)
    for name, sd in normals.items():
        v = d[name]
        assert abs(v.mean()) < 4 * sd / math.sqrt(v.size) + 1e-6, name
        np.testing.assert_allclose(v.std(), sd, rtol=0.05, err_msg=name)
    np.testing.assert_allclose(d["jaw_pose"][:, 1:].std(), 0.05, rtol=0.05)
    for name, p in COINS.items():
        assert d[name].dtype == bool
        assert abs(d[name].mean() - p) < 4 * math.sqrt(p * (1 - p) / d[name].size), name
    assert d["bank_index"].dtype == np.int64 and set(np.unique(d["bank_index"])) == {0, 1, 2, 3}


def test_batches_differ_by_generator_and_repeat_by_seed():
    _, tm = models()
    sampler = tdet.SyntheticFaceSampler(tm, image_size=32, max_per_tile=64)
    a = sampler.batch(torch.Generator().manual_seed(1), 2)
    b = sampler.batch(torch.Generator().manual_seed(2), 2)
    c = sampler.batch(torch.Generator().manual_seed(1), 2)
    assert a[0].shape == (2, 32, 32, 3) and a[1].shape == (2, 68, 2) and a[2].shape == (2, 32, 32)
    assert float(a[0].min()) >= 0.0 and float(a[0].max()) <= 1.0
    assert 0.0 < float(a[1].mean()) < 1.0           # a centred head stays mostly in frame
    assert not np.allclose(a[0].numpy(), b[0].numpy())
    for x, y in zip(a, c):
        assert torch.equal(x, y)


# ── training and detection ───────────────────────────────────


@functools.cache
def injected_batches(n=4, batch_size=8):
    """A few batches of the port's sampler, as numpy: both packages train on
    these."""
    _, tm = models()
    sampler = tdet.SyntheticFaceSampler(tm, image_size=S)
    gen = torch.Generator().manual_seed(11)
    return [tuple(t.numpy() for t in sampler.batch(gen, batch_size)) for _ in range(n)]


def test_cosine_schedule_matches_optax():
    ref = optax.cosine_decay_schedule(3e-4, 50, alpha=0.1)
    got = tdet.cosine_decay_schedule(3e-4, 50, alpha=0.1)
    for c in (0, 1, 17, 49, 50, 80):
        np.testing.assert_allclose(float(got(torch.tensor(c, dtype=torch.int32))), float(ref(c)),
                                   rtol=1e-6)


def test_short_training_run_matches_jax_and_detect_agrees():
    steps, lr = 20, 3e-4
    batches = injected_batches()
    flat = jax_flat(jdet.init_net(jax.random.PRNGKey(1), 68, S))
    # the reference's step (detector.py: adam on a cosine schedule, Huber loss)
    opt = optax.adam(optax.cosine_decay_schedule(lr, steps, alpha=0.1))
    jp = {k: jnp.asarray(v) for k, v in flat.items()}
    jstate = opt.init(jp)

    @jax.jit
    def jstep(params, opt_state, images, labels):
        def loss_fn(p):
            return jnp.mean(optax.huber_loss(jdet.net_apply(p, images), labels, delta=0.05))

        loss, grads = jax.value_and_grad(loss_fn)(params)
        updates, opt_state2 = opt.update(grads, opt_state)
        return optax.apply_updates(params, updates), opt_state2, loss

    net = convert.detector_params_from_numpy(flat, "cpu")
    state = adam_init(dict(net.named_parameters()))
    schedule = tdet.cosine_decay_schedule(lr, steps, alpha=0.1)
    want, got = [], []
    for i in range(steps):
        images, labels, _ = batches[i % len(batches)]
        jp, jstate, jl = jstep(jp, jstate, jnp.asarray(images), jnp.asarray(labels))
        want.append(float(jl))
        loss = tdet.detector_loss(net, torch.from_numpy(images), torch.from_numpy(labels))
        tdet.adam_step(net, state, loss, schedule)
        got.append(float(loss.detach()))
    np.testing.assert_allclose(got, want, rtol=2e-3)
    assert got[-1] < got[0]
    assert float(net.size) == float(jp["meta/size"]) == S      # the size is no weight: unmoved

    # detection on a uint8 stack at another size, resized to the trained one
    rng = np.random.default_rng(0)
    frames = rng.integers(0, 256, (5, 80, 112, 3)).astype(np.uint8)
    frames[:, 20:60, 30:90] = (batches[0][0][:5, 12:52, 2:62] * 255).astype(np.uint8)
    want_px, want_valid = jdet.detect(jp, frames)
    got_px, got_valid = tdet.detect(net, frames, chunk=2)
    assert got_px.shape == (5, 68, 2) and got_px.dtype == np.float32 and got_valid.all()
    assert want_valid.all()
    np.testing.assert_allclose(got_px, want_px, atol=0.05)
    # floats in [0, 1] are taken as they are
    got_f, _ = tdet.detect(net, frames.astype(np.float32) / 255.0)
    np.testing.assert_allclose(got_f, got_px, atol=1e-3)


def test_get_or_train_detector_caches_under_omfs4d_cache(tmp_path, monkeypatch):
    monkeypatch.setenv("OMFS4D_CACHE", str(tmp_path / "cache"))
    _, tm = models()
    calls = []
    real = tdet.train_detector

    def spy(*a, **kw):
        calls.append(kw)
        return real(*a, batch_size=2, log_every=0, **kw)

    monkeypatch.setattr(tdet, "train_detector", spy)
    net = tdet.get_or_train_detector(tm, image_size=32, steps=2, device="cpu")
    cache = tmp_path / "cache" / "landmark_net_sa2_torch_v700_l68_s32_t2.npz"
    assert cache.exists() and len(calls) == 1 and calls[0]["device"].type == "cpu"
    assert tdet.detector_cache_path(tm, 32, 2) == cache
    # the reference's cache of the same mesh, size and steps has another name
    assert "torch" not in "landmark_net_sa2_v700_l68_s32_t2.npz"
    again = tdet.get_or_train_detector(tm, image_size=32, steps=2, device="cpu")
    assert len(calls) == 1
    for k, v in convert.net_params_to_numpy(net).items():
        np.testing.assert_array_equal(convert.net_params_to_numpy(again)[k], v)
    # an explicit weights file: trained into it when absent, loaded when present
    tdet.get_or_train_detector(tm, weights=tmp_path / "w.npz", image_size=32, steps=2,
                               device="cpu")
    assert (tmp_path / "w.npz").exists() and len(calls) == 2
    tdet.get_or_train_detector(tm, weights=tmp_path / "w.npz", image_size=32, steps=2,
                               device="cpu")
    assert len(calls) == 2


def test_training_defaults_to_the_card_and_raises_without_one(monkeypatch):
    _, tm = models()
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    for fn in (tdet.train_detector, tdet.get_or_train_detector):
        with pytest.raises(RuntimeError, match="device='cpu'"):
            fn(tm, steps=1)
        with pytest.raises(RuntimeError, match="device='cpu'"):
            fn(tm, steps=1, device="cuda")
    with pytest.raises(ValueError, match="generator"):
        class OnCard:            # a generator that claims another device
            device = torch.device("cuda", 0)
        tdet.SyntheticFaceSampler(tm, image_size=32).draw(OnCard(), 1)


def test_loading_a_weights_file_takes_the_card_and_raises_without_one(tmp_path, monkeypatch):
    """`detect(load_detector(path), frames)` is the documented use: with no
    device named, the net goes to the card, never silently to the CPU."""
    net = tdet.init_net(torch.Generator().manual_seed(0), 68, 32)
    tdet.save_detector(tmp_path / "net.npz", net)
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="load_detector.*device='cpu'"):
        tdet.load_detector(tmp_path / "net.npz")
    with pytest.raises(RuntimeError, match="device='cpu'"):
        tdet.load_detector(tmp_path / "net.npz", "cuda")
    with pytest.raises(TypeError):
        convert.detector_params_from_numpy(convert.net_params_to_numpy(net))   # no device
    loaded = tdet.load_detector(tmp_path / "net.npz", "cpu")
    assert loaded.log_temp.device.type == "cpu"
    frames = np.random.default_rng(0).integers(0, 255, (2, 40, 48, 3), dtype=np.uint8)
    for a, b in zip(tdet.detect(loaded, frames), tdet.detect(net, frames)):
        np.testing.assert_array_equal(a, b)
