"""The port's FLAME model against the JAX package's, on the CPU.

Both packages get the same synthetic asset (carried over by
`omfs4d_torch.convert`) and the same numpy parameters.  Tolerance atol 1e-5:
float32 with sums taken in another order.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from omfs4d.models import flame as jf
from omfs4d.models.assets import synthetic_flame_asset
from omfs4d_torch.convert import flame_model_from_numpy, to_numpy
from omfs4d_torch.models import flame as tf

ATOL = 1e-5


@pytest.fixture(scope="module")
def models():
    jm = jf.FlameModel.from_asset(synthetic_flame_asset(n_vertices=400, seed=1))
    tm = flame_model_from_numpy(jax.tree_util.tree_map(np.asarray, jm)._asdict())
    return jm, tm


def random_params(V, B=3, n_shape=300, n_expr=100, seed=0):
    rng = np.random.default_rng(seed)

    def f(*shape, s=1.0):
        return (s * rng.normal(size=shape)).astype(np.float32)

    return {
        "shape": f(n_shape), "expr": f(B, n_expr),
        "rotation": f(B, 3, s=0.3), "neck_pose": f(B, 3, s=0.2),
        "jaw_pose": f(B, 3, s=0.2), "eyes_pose": f(B, 6, s=0.1),
        "translation": f(B, 3, s=0.02),
        "static_offset": f(1, V, 3, s=1e-3), "dynamic_offset": f(B, V, 3, s=1e-3),
    }


@pytest.mark.parametrize("modes", [(300, 100), (50, 20)], ids=["full", "truncated"])
def test_flame_forward_and_landmarks_match_jax(models, modes):
    jm, tm = models
    p = random_params(jm.n_vertices, n_shape=modes[0], n_expr=modes[1])
    vj, lj = jf.flame_forward(jm, {k: jnp.asarray(v) for k, v in p.items()},
                              return_landmarks=True)
    vt, lt = tf.flame_forward(tm, p, return_landmarks=True)
    assert vt.shape == (3, jm.n_vertices, 3) and lt.shape == (3, 68, 3)
    np.testing.assert_allclose(vt.numpy(), np.asarray(vj), atol=ATOL)
    np.testing.assert_allclose(lt.numpy(), np.asarray(lj), atol=ATOL)
    np.testing.assert_allclose(tf.flame_landmarks(tm, vt).numpy(),
                               np.asarray(jf.flame_landmarks(jm, vj)), atol=ATOL)


def test_flame_forward_defaults_and_batched_shape(models):
    """Missing pose keys default to zero, and a (B, 300) shape equals the
    broadcast (300,) one."""
    jm, tm = models
    p = random_params(jm.n_vertices, B=2, seed=3)
    minimal = {"shape": p["shape"], "expr": p["expr"]}
    vj = jf.flame_forward(jm, {k: jnp.asarray(v) for k, v in minimal.items()})
    np.testing.assert_allclose(tf.flame_forward(tm, minimal).numpy(), np.asarray(vj),
                               atol=ATOL)
    batched = dict(minimal, shape=np.stack([p["shape"]] * 2))
    np.testing.assert_allclose(tf.flame_forward(tm, batched).numpy(), np.asarray(vj),
                               atol=ATOL)


def test_axis_angle_to_matrix_matches_jax():
    rng = np.random.default_rng(1)
    aa = np.concatenate([np.zeros((1, 3)), rng.normal(0, 1.0, (20, 3))]).astype(np.float32)
    np.testing.assert_allclose(tf.axis_angle_to_matrix(torch.from_numpy(aa)).numpy(),
                               np.asarray(jf.axis_angle_to_matrix(jnp.asarray(aa))),
                               atol=ATOL)


def test_model_fields_and_helpers_match_jax(models):
    jm, tm = models
    fields = to_numpy(tm)
    for name, value in jm._asdict().items():
        np.testing.assert_array_equal(fields[name], np.asarray(value), err_msg=name)
    assert fields["faces"].dtype == np.int32 and tm.parent_list == (-1, 0, 1, 1, 1)
    assert (tm.n_vertices, tm.n_joints) == (jm.n_vertices, jm.n_joints)
    for k, v in jf.canonical_params(jm, T=2).items():
        np.testing.assert_array_equal(tf.canonical_params(tm, T=2)[k], v)
    v = np.asarray(jm.v_template)
    np.testing.assert_array_equal(tf.default_uv_coords(v), jf.default_uv_coords(v))
