"""The port's matting net against the JAX package's, on the CPU.

  * `segnet_apply` on the same weights (carried across by `convert.py`) at
    64^2, 96^2 and the odd size 75 (where the decoder's nearest resize has no
    whole factor): logits atol 1e-5 * max|logit| + 1e-5; the gradient of the
    training loss (sigmoid cross-entropy) for every weight atol
    2e-4 * max|g|, rtol 2e-3;
  * one .npz written by either package loads in the other;
  * a 20-step training run on the same injected batches: loss curve rel 2e-3;
  * `predict_masks` on a uint8 stack: masks equal but for <= 1e-3 of pixels
    (a probability within rounding of the 0.5 cut may flip).
"""

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from omfs4d.track import segnet as jseg
from omfs4d_torch import convert
from omfs4d_torch.track import segnet as tseg
from omfs4d_torch.track.detector import cosine_decay_schedule, adam_step
from omfs4d_torch.train.trainer import adam_init
from tests.test_torch_detector import (assert_grads_close, injected_batches, jax_flat, models,
                                       random_weights, torch_grads)
from tests.test_torch_track import one_torch_thread  # noqa: F401  (autouse here too)

S = 64


def test_layout_matches_the_reference():
    net = tseg.init_segnet(torch.Generator().manual_seed(0))
    ref = jax_flat(jseg.init_segnet(jax.random.PRNGKey(0)))
    flat = convert.net_params_to_numpy(net)
    assert {k: v.shape for k, v in flat.items()} == {k: v.shape for k, v in ref.items()}
    for k, v in flat.items():
        if k.endswith("/w") and k != "out/w":
            fan_in = v.shape[0] * v.shape[1] * v.shape[2]
            np.testing.assert_allclose(v.std(), np.sqrt(2.0 / fan_in), rtol=0.15, err_msg=k)
            np.testing.assert_allclose(v.std(), ref[k].std(), rtol=0.25, err_msg=k)
        elif k != "out/w":
            assert not v.any(), k
    # 16 draws of N(0, 0.1): the mean square is 0.01 within a factor of 3
    assert 0.01 / 3 < float((flat["out/w"] ** 2).mean()) < 0.03


@pytest.mark.parametrize("size", [64, 96, 75])
def test_segnet_apply_value_and_gradients_match_jax(size):
    flat = random_weights(jseg.init_segnet, image_size=size)
    net = convert.segnet_params_from_numpy(flat, "cpu")
    rng = np.random.default_rng(size)
    images = rng.uniform(0, 1, (2, size, size, 3)).astype(np.float32)
    alpha = rng.uniform(0, 1, (2, size, size)).astype(np.float32)
    alpha[:, : size // 2] = np.round(alpha[:, : size // 2])       # hard and soft labels

    jp = {k: jnp.asarray(v) for k, v in flat.items()}
    want = np.asarray(jseg.segnet_apply(jp, jnp.asarray(images)))
    got = tseg.segnet_apply(net, torch.from_numpy(images)).detach().numpy()
    assert got.shape == (2, size, size)
    np.testing.assert_allclose(got, want, atol=1e-5 * np.abs(want).max() + 1e-5)

    def loss_fn(p):
        logits = jseg.segnet_apply(p, jnp.asarray(images))
        return jnp.mean(optax.sigmoid_binary_cross_entropy(logits, jnp.asarray(alpha)))

    jl, jg = jax.value_and_grad(loss_fn)(jp)
    loss = tseg.segnet_loss(net, torch.from_numpy(images), torch.from_numpy(alpha))
    np.testing.assert_allclose(float(loss.detach()), float(jl), rtol=1e-5)
    assert_grads_close(torch_grads(net, loss), jax_flat(jg))


def test_one_npz_loads_in_both_packages(tmp_path, monkeypatch):
    monkeypatch.setenv("OMFS4D_CACHE", str(tmp_path / "cache"))
    jm, tm = models()
    rng = np.random.default_rng(0)
    images = rng.uniform(0, 1, (2, S, S, 3)).astype(np.float32)
    flat = random_weights(jseg.init_segnet)
    # written as the reference writes it, read by the port's loader
    np.savez(tmp_path / "jax.npz", **flat)
    net = tseg.get_or_train_segnet(tm, weights=tmp_path / "jax.npz", device="cpu")
    want = np.asarray(jseg.segnet_apply({k: jnp.asarray(v) for k, v in flat.items()},
                                        jnp.asarray(images)))
    got = tseg.segnet_apply(net, torch.from_numpy(images)).detach().numpy()
    np.testing.assert_allclose(got, want, atol=1e-5 * np.abs(want).max() + 1e-5)
    # written by the port, read by the reference's loader
    net2 = tseg.init_segnet(torch.Generator().manual_seed(2))
    np.savez(tmp_path / "torch.npz", **convert.net_params_to_numpy(net2))
    jp = jseg.get_or_train_segnet(jm, weights=tmp_path / "torch.npz")
    assert sorted(jp) == sorted(flat)
    want2 = tseg.segnet_apply(net2, torch.from_numpy(images)).detach().numpy()
    np.testing.assert_allclose(np.asarray(jseg.segnet_apply(jp, jnp.asarray(images))), want2,
                               atol=1e-5 * np.abs(want2).max() + 1e-5)
    back = convert.net_params_to_numpy(convert.segnet_params_from_numpy(flat, "cpu"))
    for k, v in flat.items():
        np.testing.assert_array_equal(back[k], v)
    assert not (tmp_path / "cache").exists()


def test_short_training_run_matches_jax_and_masks_agree():
    steps, lr = 20, 1e-3
    batches = injected_batches()
    flat = jax_flat(jseg.init_segnet(jax.random.PRNGKey(1)))
    opt = optax.adam(optax.cosine_decay_schedule(lr, steps, alpha=0.1))
    jp = {k: jnp.asarray(v) for k, v in flat.items()}
    jstate = opt.init(jp)

    @jax.jit
    def jstep(params, opt_state, images, alpha):
        def loss_fn(p):
            logits = jseg.segnet_apply(p, images)
            return jnp.mean(optax.sigmoid_binary_cross_entropy(logits, alpha))

        loss, grads = jax.value_and_grad(loss_fn)(params)
        updates, opt_state2 = opt.update(grads, opt_state)
        return optax.apply_updates(params, updates), opt_state2, loss

    net = convert.segnet_params_from_numpy(flat, "cpu")
    state = adam_init(dict(net.named_parameters()))
    schedule = cosine_decay_schedule(lr, steps, alpha=0.1)
    want, got = [], []
    for i in range(steps):
        images, _, alpha = batches[i % len(batches)]
        jp, jstate, jl = jstep(jp, jstate, jnp.asarray(images), jnp.asarray(alpha))
        want.append(float(jl))
        loss = tseg.segnet_loss(net, torch.from_numpy(images), torch.from_numpy(alpha))
        adam_step(net, state, loss, schedule)
        got.append(float(loss.detach()))
    np.testing.assert_allclose(got, want, rtol=2e-3)
    assert got[-1] < got[0]

    # masks of a uint8 stack at another size: in at 80x112, net at 64, out at 80x112
    frames = np.pad((batches[1][0][:5] * 255).astype(np.uint8),
                    ((0, 0), (8, 8), (24, 24), (0, 0)), mode="edge")
    want_m = jseg.predict_masks(jp, frames, image_size=S)
    got_m = tseg.predict_masks(net, frames, image_size=S, chunk=2)
    assert got_m.shape == (5, 80, 112) and got_m.dtype == np.float32
    assert set(np.unique(got_m)) <= {0.0, 1.0} and 0.0 < got_m.mean() < 1.0
    assert (got_m != want_m).mean() <= 1e-3, (got_m != want_m).mean()


def test_get_or_train_segnet_caches_and_takes_the_card_by_default(tmp_path, monkeypatch):
    monkeypatch.setenv("OMFS4D_CACHE", str(tmp_path / "cache"))
    _, tm = models()
    calls = []
    real = tseg.train_segnet

    def spy(*a, **kw):
        calls.append(kw)
        return real(*a, batch_size=2, log_every=0, **kw)

    monkeypatch.setattr(tseg, "train_segnet", spy)
    net = tseg.get_or_train_segnet(tm, image_size=32, steps=2, device="cpu")
    cache = tmp_path / "cache" / "segnet_n3_torch_v700_s32_t2.npz"
    assert cache.exists() and len(calls) == 1 and tseg.segnet_cache_path(tm, 32, 2) == cache
    again = tseg.get_or_train_segnet(tm, image_size=32, steps=2, device="cpu")
    assert len(calls) == 1
    for k, v in convert.net_params_to_numpy(net).items():
        np.testing.assert_array_equal(convert.net_params_to_numpy(again)[k], v)
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    for fn in (real, tseg.get_or_train_segnet):
        with pytest.raises(RuntimeError, match="device='cpu'"):
            fn(tm, steps=1)


def test_loading_a_weights_file_takes_the_card_and_raises_without_one(tmp_path, monkeypatch):
    net = tseg.init_segnet(torch.Generator().manual_seed(0))
    tseg.save_segnet(tmp_path / "seg.npz", net)
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="load_segnet.*device='cpu'"):
        tseg.load_segnet(tmp_path / "seg.npz")
    with pytest.raises(TypeError):
        convert.segnet_params_from_numpy(convert.net_params_to_numpy(net))     # no device
    loaded = tseg.load_segnet(tmp_path / "seg.npz", "cpu")
    assert loaded.out.weight.device.type == "cpu"
    frames = np.random.default_rng(0).integers(0, 255, (2, 40, 48, 3), dtype=np.uint8)
    np.testing.assert_array_equal(tseg.predict_masks(loaded, frames, image_size=32),
                                  tseg.predict_masks(net, frames, image_size=32))
