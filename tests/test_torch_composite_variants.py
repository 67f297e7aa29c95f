"""The K2 ablation variants (kernel V, `omfs4d_torch/csrc/composite_variants.cu`)
on the CPU: `variant_plain` against the JAX package's
`scripts/profile_composite_variants.py::make_variant_kernel` run in Pallas
interpret mode, for every mode; `pack_lists` against `_pack_lists`; the
profiler's inputs and its "current" rows against the reference's; and V's
own reordered sums written out in numpy f64 and held to `variant_plain`.

The JAX script is loaded from its path; no JAX file is edited.  Its import
sets the JAX compilation-cache options, which are put back right after.
Its globals T, K and GRID_W and its `pl` are monkeypatched per test (`pl`
by a namespace whose `pallas_call` runs in interpret mode).

Bounds (`profile_composite_variants.compare`): copy exact (a product by
2); every other mode, the bf16 ones included, atol 2e-4 * s + rtol 2e-3 *
|ref| for every element (BOUND, the reference's gradient bound,
tests/test_pallas_composite.py).  s is the max |ref| over the element's row
of its tile (`row_scale`), taken apart over entries with an indefinite
conic: power clamps to 0 there, so a = o at any distance and the geometry
gradients grow with the squared distance, ~1e6 times the rest on the
reference's own table, where one scale for the table would leave most
elements unchecked.

Why the f32 bound holds the bf16 modes too.  Both sides round the same
five operands (lg, dcol, rgb, m, w) to bf16 and sum the products in f32.
The rounded values are the same bits on both sides when the f32 values
before the casts are: alpha is evaluated in the same order of roundings
(the kernel's alpha_of spells it out; here XLA and torch agree on it), the
prefix of rounded lg is exact in f32 in any order (bf16 values of at least
2^-8 in magnitude, as a >= 1/255, summed below 512), and the products of
rounded operands are exact.  What remains is the order of the f32 sums,
which is what the bound was set for.  Had one side landed a value on the
neighbouring bf16 value (a midpoint flip), a term would move by 2^-8 of
itself, and an element summing it could leave the bound: a failure here
would show that.  Leaving the roundings out moves every term by up to
2^-9 of itself and the transmittance by the drift of the summed lg, which
puts 3.8-27% of the nonzero elements outside the bound on these tables
(and 36-45% on the reference's own, on the card):
test_bf16_bound_rejects_the_unrounded_result holds that control to failing.
"""

import functools
import importlib.util
import sys
import types
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.experimental import pallas as pl

from omfs4d.ops.camera import look_at_camera, project_gaussians
from omfs4d.render.pallas_kernels import _call_bwd, _call_fwd, _pack_lists
from omfs4d.render.rasterize import bin_gaussians
from omfs4d_torch.render import composite as tc
from omfs4d_torch.scripts import profile_composite_variants as pcv
from tests.test_rasterize import random_scene

ROOT = Path(__file__).resolve().parents[1]
MODES = pcv.MODES
GRID_W = 2
CACHE_OPTIONS = ("jax_compilation_cache_dir", "jax_persistent_cache_min_compile_time_secs")


@pytest.fixture(scope="module")
def script():
    """scripts/profile_composite_variants.py as a module, with the JAX
    config and sys.path as they were before its import."""
    saved = {k: getattr(jax.config, k) for k in CACHE_OPTIONS}
    path = list(sys.path)
    try:
        spec = importlib.util.spec_from_file_location(
            "_reference_profile_composite_variants", ROOT / "scripts" / "profile_composite_variants.py")
        mod = importlib.util.module_from_spec(spec)
        spec.loader.exec_module(mod)
    finally:
        for k, v in saved.items():
            jax.config.update(k, v)
        sys.path[:] = path
    return mod


def jax_variant(script, monkeypatch, mode, packed, dcol, dalpha):
    """The reference's variant kernel in Pallas interpret mode."""
    monkeypatch.setattr(script, "T", packed.shape[0])
    monkeypatch.setattr(script, "K", packed.shape[2])
    monkeypatch.setattr(script, "GRID_W", GRID_W)
    monkeypatch.setattr(script, "pl", types.SimpleNamespace(
        pallas_call=functools.partial(pl.pallas_call, interpret=True),
        BlockSpec=pl.BlockSpec, program_id=pl.program_id))
    return np.asarray(script.make_variant_kernel(mode)(packed, dcol, dalpha))


def variant_inputs(T, K, seed=0):
    """A packed table over a GRID_W-wide grid of 16-px tiles with capped
    (opacity 1 near a pixel: a > 0.99), cut (a < 1/255 far out) and
    zero-opacity padding entries (the last quarter of each list), and
    normal cotangents."""
    rng = np.random.default_rng(seed)
    grid_h = T // GRID_W
    packed = np.zeros((T, 9, K), np.float32)
    packed[:, 0] = rng.uniform(-8, 16 * GRID_W + 8, (T, K))
    packed[:, 1] = rng.uniform(-8, 16 * grid_h + 8, (T, K))
    packed[:, 2] = rng.uniform(0.005, 0.2, (T, K))
    packed[:, 3] = rng.uniform(-0.03, 0.03, (T, K))
    packed[:, 4] = rng.uniform(0.005, 0.2, (T, K))
    packed[:, 5:8] = rng.uniform(0, 1, (T, 3, K))
    opacity = rng.uniform(0.05, 1.0, (T, K))
    opacity[rng.uniform(size=(T, K)) < 0.15] = 1.0
    opacity[:, 3 * K // 4:] = 0.0
    packed[:, 8] = opacity
    dcol = rng.normal(size=(T, 3, pcv.P)).astype(np.float32)
    dalpha = rng.normal(size=(T, 1, pcv.P)).astype(np.float32)
    return packed, dcol, dalpha


def t_(x):
    return torch.from_numpy(np.array(x))


def assert_variant_close(mode, got, ref, packed):
    res = pcv.compare(mode, t_(got), t_(ref), t_(packed))
    assert res["ok"], f"{mode}: {res}"


@pytest.mark.parametrize("K", [32, 512])
def test_inputs_hold_capped_cut_and_padded_entries(K):
    packed, _, _ = variant_inputs(4, K)
    p = np.arange(pcv.P)
    a_full = []
    for t in range(4):
        x = (t % GRID_W) * 16 + p % 16 + 0.5
        y = (t // GRID_W) * 16 + p // 16 + 0.5
        ux, uy, ca, cb, cc, _, _, _, o = packed[t]
        dx, dy = x[:, None] - ux, y[:, None] - uy
        power = np.minimum(-0.5 * (ca * dx * dx + cc * dy * dy) - cb * dx * dy, 0)
        a_full.append(o * np.exp(power))
    a_full = np.stack(a_full)
    assert (a_full > 0.99).sum() > 0
    assert ((a_full > 0) & (a_full < 1 / 255)).sum() > 0
    assert ((a_full >= 1 / 255) & (a_full <= 0.99)).sum() > 100
    assert (packed[:, 8, 3 * K // 4:] == 0).all()


@pytest.mark.parametrize("K", [32, 512])
@pytest.mark.parametrize("mode", MODES)
def test_variant_plain_matches_jax(script, monkeypatch, mode, K):
    packed, dcol, dalpha = variant_inputs(4 if K == 32 else 2, K, seed=K)
    ref = jax_variant(script, monkeypatch, mode, packed, dcol, dalpha)
    got = pcv.variant_plain(mode, t_(packed), t_(dcol), t_(dalpha), grid_w=GRID_W)
    assert got.shape == ref.shape == packed.shape
    assert np.abs(ref).max() > 0
    assert_variant_close(mode, got.numpy(), ref, packed)


@pytest.mark.parametrize("K", [32, 512])
@pytest.mark.parametrize("mode", ["bf16_matmuls", "full_bf16"])
def test_bf16_bound_rejects_the_unrounded_result(script, monkeypatch, mode, K):
    """The control: variant_plain without its five bf16 roundings fails the
    bound that it passes with them, against the same JAX output."""
    packed, dcol, dalpha = variant_inputs(4 if K == 32 else 2, K, seed=K)
    ref = jax_variant(script, monkeypatch, mode, packed, dcol, dalpha)
    got = pcv.variant_plain(mode, t_(packed), t_(dcol), t_(dalpha), grid_w=GRID_W,
                            rounded=False)
    res = pcv.compare(mode, got, t_(ref), t_(packed))
    assert res["share"] > 1e-2, res


def test_row_scale_takes_indefinite_conics_apart():
    """An entry with ca * cc < cb^2 is scaled by the largest such entry of
    its row, every other entry by the largest of the rest."""
    packed = torch.zeros((1, 9, 4))
    packed[0, 2:5] = torch.tensor([[0.1, 0.1, 0.01, 0.1], [0.0, 0.05, 0.05, 0.0],
                                   [0.1, 0.1, 0.01, 0.1]])          # ca, cb, cc
    ref = torch.zeros((1, 9, 4))
    ref[0, 0] = torch.tensor([1.0, -3.0, 5e6, 2.0])
    s = pcv.row_scale(ref, packed)
    assert s[0, 0].tolist() == [3.0, 3.0, 5e6, 3.0]
    assert s[0, 1].tolist() == [0.0] * 4


def test_cpu_call_takes_the_plain_version():
    packed, dcol, dalpha = (t_(a) for a in variant_inputs(4, 32, seed=3))
    before = dict(pcv.launches)
    for mode in MODES:
        out = pcv.make_variant_kernel(mode)(packed, dcol, dalpha, grid_w=GRID_W)
        assert torch.equal(out, pcv.variant_plain(mode, packed, dcol, dalpha, grid_w=GRID_W))
    assert pcv.launches == before
    with pytest.raises(ValueError, match="unknown mode"):
        pcv.make_variant_kernel("bf16")


def test_pack_lists_matches_jax():
    W, H = 48, 32
    cam = look_at_camera(eye=(0, 0, -2.5), target=(0, 0, 0), fx=150.0, width=W, height=H)
    means, rot, scales, opacity, colors = random_scene(60, seed=4)
    proj = project_gaussians(cam, jnp.asarray(means), jnp.asarray(rot), jnp.asarray(scales))
    b = bin_gaussians(proj, jnp.asarray(opacity), W, H, tile=16, max_per_tile=64)
    assert int(b.tile_counts.max()) > 0 and int(b.tile_counts.min()) < 64   # padding to zero
    ref = np.asarray(_pack_lists(proj["uv"], proj["conic"], jnp.asarray(colors),
                                 jnp.asarray(opacity), b.tile_lists, b.tile_counts))
    got = tc.pack_lists(t_(proj["uv"]), t_(proj["conic"]), t_(colors), t_(opacity),
                        t_(b.tile_lists), t_(b.tile_counts))
    assert got.shape == ref.shape == (6, 9, 64)
    np.testing.assert_array_equal(got.numpy(), ref)


def test_synthetic_inputs_match_the_reference_main(script, monkeypatch):
    """The reference's main() at T = 4, K = 32, its timer replaced by one
    that records the arguments: the port draws the same table, cotangents
    and sort keys from the same seed."""
    calls = {}
    monkeypatch.setattr(script, "T", 4)
    monkeypatch.setattr(script, "K", 32)
    monkeypatch.setattr(script, "timed",
                        lambda fn, *args, n=30, label="": calls.setdefault(label, args))
    script.main()
    packed, dcol, dalpha, keys = pcv.synthetic_inputs(0, T=4, K=32)
    for got, ref in zip((packed, dcol, dalpha), calls["bwd (current)"]):
        np.testing.assert_array_equal(got, np.asarray(ref))
    ref_keys, ref_payload = calls[f"lax.sort {pcv.N_PAIRS / 1e6:.1f}M pairs"]
    np.testing.assert_array_equal(keys, np.asarray(ref_keys))
    assert keys.dtype == np.int32 and len(ref_payload) == pcv.N_PAIRS


def test_layout_helpers_round_trip():
    packed, dcol, dalpha = (t_(a) for a in variant_inputs(4, 32, seed=5))
    *params, b = pcv.as_gaussians(packed)
    assert torch.equal(tc.pack_lists(*params, b.tile_lists, b.tile_counts), packed)
    img, alpha = pcv.to_image(dcol, dalpha, grid_w=GRID_W)
    assert img.shape == (32, 32, 3) and alpha.shape == (32, 32)
    # pixel p of tile t sits at row (t // grid_w) * 16 + p // 16, col (t % grid_w) * 16 + p % 16
    assert img[16 + 2, 16 + 5, 1] == dcol[3, 1, 2 * 16 + 5]
    back = pcv.to_tiles(img, alpha)
    assert torch.equal(back[0], dcol) and torch.equal(back[1], dalpha)


def test_current_rows_match_jax():
    """K1 and K2 as the profiler's "current" rows drive them (the packed
    table as gaussians with identity lists, cotangents as images), through
    their plain versions, against the reference's `_call_fwd` / `_call_bwd`
    on the packed table in interpret mode: K1's bound 1e-4 and the gradient
    bound."""
    T, K = 4, 64
    packed, dcol, dalpha = variant_inputs(T, K, seed=6)
    W, H = GRID_W * 16, T // GRID_W * 16
    base = jnp.zeros((1,), jnp.int32)
    col_j, alp_j = _call_fwd(jnp.asarray(packed), base, 16, GRID_W, True)
    dp_j = np.asarray(_call_bwd(jnp.asarray(packed), base, jnp.asarray(dcol),
                                jnp.asarray(dalpha), 16, GRID_W, True))

    *params, b = pcv.as_gaussians(t_(packed))
    leaves = [p.clone().requires_grad_() for p in params]
    img, alpha = tc.composite(*leaves, b, W, H)
    col_t, alp_t = pcv.to_tiles(img.detach(), alpha.detach())
    np.testing.assert_allclose(col_t.numpy(), np.asarray(col_j), atol=1e-4, rtol=1e-4)
    np.testing.assert_allclose(alp_t.numpy(), np.asarray(alp_j), atol=1e-4, rtol=1e-4)

    dimg, dA = pcv.to_image(t_(dcol), t_(dalpha), grid_w=GRID_W)
    grads = torch.autograd.grad((img, alpha), leaves, (dimg, dA))
    dp_t = torch.cat([g.reshape(T * K, -1) for g in grads], 1).reshape(T, K, 9).transpose(1, 2)
    for rows in ((0, 2), (2, 5), (5, 8), (8, 9)):
        ref = dp_j[:, rows[0]:rows[1]]
        np.testing.assert_allclose(dp_t[:, rows[0]:rows[1]].numpy(), ref,
                                   atol=2e-4 * np.abs(ref).max(), rtol=2e-3)


def v_numpy(mode, packed, dcol, dalpha, tile=16, grid_w=GRID_W):
    """Kernel V's arithmetic in the kernel's order, vectorised over a tile's
    pixels: per pixel, running sums front to back (the exclusive prefix of
    lg; for elementwise and full_bf16 a first pass for sum_k lg and, in
    full_bf16, sum_k m); per entry, sums over the pixels; row 0 of the
    matmul modes as an exclusive suffix scan over k of the per-entry sums of
    m; full_bf16's per-pixel suffix as the first-pass total minus a running
    inclusive prefix."""
    bf16 = mode in ("bf16_matmuls", "full_bf16")

    def rnd(v):
        v = np.asarray(v, np.float64)
        return torch.from_numpy(v).to(torch.bfloat16).double().numpy() if bf16 else v

    T, _, K = packed.shape
    out = np.zeros(packed.shape)
    p = np.arange(tile * tile)
    for t in range(T):
        x = (t % grid_w) * tile + p % tile + 0.5
        y = (t // grid_w) * tile + p // tile + 0.5
        d = rnd(dcol[t])
        dA = dalpha[t, 0]
        ux, uy, ca, cb, cc, r, g, b, o = packed[t]
        rgb = rnd(np.stack([r, g, b]))

        def entry(k):
            dx, dy = x - ux[k], y - uy[k]
            e = np.exp(np.minimum(-0.5 * (ca[k] * dx * dx + cc[k] * dy * dy)
                                  - cb[k] * dx * dy, 0))
            a_full = o[k] * e
            a = np.minimum(a_full, 0.99)
            ok = (a_full <= 0.99) & (a >= 1 / 255)
            a = np.where(a < 1 / 255, 0, a)
            return dx, dy, a_full, a, ok, np.maximum(1 - a, 1e-6)

        def weights(a, s_excl, k):
            t_excl = np.exp(s_excl)
            w = a * t_excl
            dw = d.T @ rgb[:, k]
            return t_excl, w, dw, rnd(dw * w)

        s_total, m_tot, s_excl = np.zeros(len(p)), np.zeros(len(p)), np.zeros(len(p))
        if mode in ("elementwise", "full_bf16"):
            for k in range(K):
                _, _, _, a, _, one_minus = entry(k)
                s_total += np.log(one_minus)
                if mode == "full_bf16":
                    m_tot += weights(a, s_excl, k)[3]
                    s_excl += rnd(np.log(one_minus))
        t_total = np.exp(s_total)
        s_excl, m_le, m_sum = np.zeros(len(p)), np.zeros(len(p)), np.zeros(K)
        for k in range(K):
            dx, dy, a_full, a, ok, one_minus = entry(k)
            if mode == "elementwise":
                t_excl, suffix, dw = one_minus, a * 0.5, a + 0.1
            else:
                t_excl, w, dw, m = weights(a, s_excl, k)
                s_excl += rnd(np.log(one_minus))
                if mode != "full_bf16":
                    m_sum[k] = m.sum()
                    out[t, 6:9, k] = d @ rnd(w)
                    continue
                out[t, 5:8, k] = d @ rnd(w)
                m_le += m
                suffix = m_tot - m_le
            da = np.where(ok, dw * t_excl - suffix / one_minus + dA * t_total / one_minus, 0)
            dq = da * a_full
            out[t, :5, k] = [np.sum(dq * (ca[k] * dx + cb[k] * dy)),
                             np.sum(dq * (cc[k] * dy + cb[k] * dx)),
                             np.sum(-0.5 * dq * dx * dx), np.sum(-dq * dx * dy),
                             np.sum(-0.5 * dq * dy * dy)]
            out[t, 8, k] = np.sum(da * a_full / max(o[k], 1e-12))
        if mode in ("matmuls", "bf16_matmuls"):
            acc = 0.0
            for k in reversed(range(K)):
                out[t, 0, k] = acc
                acc += m_sum[k]
    return out


@pytest.mark.parametrize("mode", [m for m in MODES if m != "copy"])
def test_v_arithmetic_matches_plain(mode):
    packed, dcol, dalpha = variant_inputs(4, 64, seed=7)
    got = v_numpy(mode, packed.astype(np.float64), dcol.astype(np.float64),
                  dalpha.astype(np.float64))
    ref = pcv.variant_plain(mode, *(t_(a).double() for a in (packed, dcol, dalpha)),
                            grid_w=GRID_W).numpy()
    assert np.abs(ref).max() > 0
    np.testing.assert_allclose(got, ref, atol=1e-9 * np.abs(ref).max(), rtol=1e-7,
                               err_msg=mode)
