"""The port's training loop (`AvatarTrainer.train`) against the JAX
trainer's, on the CPU.

A 30-iteration run at 64^2 (the scene of test_torch_train.py, black
background) from the same state, with one densify event whose noise is
JAX's own (`jax.random.split` chain injected): the per-iteration loss
curve follows JAX's to rel 2e-3 and the alive count after densification
is the same.  The two drift apart only by rounding: Adam's first steps are
+-lr wherever |g| > eps, so a gradient that differs in its last bits still
moves a parameter by the same step.
"""

import jax
import numpy as np
import torch

from omfs4d_torch.convert import train_state_from_jax
from tests.test_torch_train import CAPACITY, scene, trainers  # noqa: F401


class Recorder:
    """Collects `train_step` events (both trainers emit them the same way)."""

    def __init__(self):
        self.steps = []

    def emit(self, event, **fields):
        if event == "train_step":
            self.steps.append(fields)


def test_short_loop_follows_jax(scene):
    cfg_kw = dict(densify_from=10, densify_interval=10, densify_until_frac=0.5)
    j_tr, t_tr = trainers(scene, False, **cfg_kw)
    data = scene[3]
    js = j_tr.init_state(capacity=CAPACITY)
    ts = train_state_from_jax(js)

    key = [jax.random.PRNGKey(0)]

    def jax_noise(rng_seed, iteration, max_new):
        key[0], sub = jax.random.split(key[0])
        return torch.from_numpy(np.array(jax.random.normal(sub, (max_new, 3))))

    t_tr.densify_noise = jax_noise
    j_rec, t_rec = Recorder(), Recorder()
    js = j_tr.train(data, iterations=30, state=js, events=j_rec, log_every=1)
    ts = t_tr.train(data, iterations=30, state=ts, events=t_rec, log_every=1)

    assert [s["iter"] for s in t_rec.steps] == list(range(1, 31))
    j_loss = np.array([s["loss"] for s in j_rec.steps])
    t_loss = np.array([s["loss"] for s in t_rec.steps])
    np.testing.assert_allclose(t_loss, j_loss, rtol=2e-3)
    assert t_loss[-1] < t_loss[0]
    j_alive = [s["n_alive"] for s in j_rec.steps]
    assert [s["n_alive"] for s in t_rec.steps] == j_alive
    assert j_alive[-1] > j_alive[0]                      # the densify event fired
    assert t_tr.render_cfg == {k: v for k, v in j_tr.render_cfg.items() if k != "use_pallas"}
    np.testing.assert_array_equal(ts.gaussians.alive.numpy(), np.asarray(js.gaussians.alive))
