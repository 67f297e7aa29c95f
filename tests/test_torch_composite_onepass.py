"""The one-pass design of kernel K2 (`omfs4d_torch/csrc/composite_bwd.cu`),
on the CPU: its arithmetic written out in numpy float32 in the kernel's
order, held to autograd through `composite_plain` and to the JAX package's
`_bwd_body` (`composite_pallas`'s VJP, Pallas in interpret mode).

The transcription takes each pixel's C_tot and T_tot from K1's arithmetic
(`composite_common.cuh`: the alpha of the reference's order of roundings
and the step w = a T, C += w rgb as an FMA, T *= 1 - a), walks each list
once front to back, skips an entry for a warp of 32 pixels when the entry's
reach box (`reach_of`) misses the warp's pixels and when no pixel of the
warp inside the image has a > 0, reduces each live (entry, warp)'s 9 terms in
the order of the multi-value exchange (the xor butterfly 16, 8, 4, 2, 1),
adds the warps' sums in warp order and the tiles' in tile order.  The
kernel adds those last two with atomics, in an order that changes from run
to run.

The fixture is built by hand, lists included, so no sort and no key ties
are involved: capped (a = 0.99) and cut entries at the end of a list; a
tile where T underflows to 0 after many saturated entries; an empty tile;
tiles past the right and bottom image edges; one gaussian in every
non-empty list; gaussians in no list; padding past each count.

Tolerances: K2's bound against the plain version and the reference, atol
2e-4 * max|grad|, rtol 2e-3 (the reference's own gradient bound,
tests/test_pallas_composite.py; the packages sum in other orders), and
K1's 1e-4 on the image and alpha.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from omfs4d.render.pallas_kernels import composite_pallas
from omfs4d.render.rasterize import TileBinning as JBinning
from omfs4d_torch.render import composite as tc
from omfs4d_torch.render.rasterize import TileBinning

F = np.float32
W, H, TILE, K = 40, 24, 16, 64          # 3 x 2 tiles; the right and bottom tiles are cut
GRID_W = -(-W // TILE)
P = TILE * TILE
CUTOFF, CAP = F(1) / F(255), F(0.99)
NAMES = ("uv", "conic", "colors", "opacity")
GRAD_TOL = 2e-4, 2e-3


def fixture(seed=0):
    """Gaussians (uv, conic, colors, opacity) and hand-made per-tile lists."""
    rng = np.random.default_rng(seed)
    rows, lists = [], [[] for _ in range(6)]

    def add(ux, uy, sigma, o, tiles):
        rows.append([ux, uy, 1 / sigma ** 2, rng.uniform(-0.2, 0.2) / sigma ** 2,
                     1 / sigma ** 2, *rng.uniform(0, 1, 3), o])
        for t in tiles:
            lists[t].append(len(rows) - 1)

    add(20, 12, 30.0, 0.3, [])                              # 0: in every non-empty list
    for _ in range(8):                                      # tile 0: ordinary entries
        add(*rng.uniform(1, 15, 2), rng.uniform(2, 5), rng.uniform(0.3, 0.9), [0])
    for _ in range(3):                                      # straddling tiles 0 and 1
        add(16 + rng.uniform(-2, 2), rng.uniform(2, 14), 4.0, 0.7, [0, 1])
    add(8, 8, 6.0, 1.0, [0])                                # capped (a_full > 0.99)
    add(5, 9, 3.0, 0.003, [0])                              # cut everywhere (o < 1/255)
    add(200, 200, 2.0, 0.9, [0])                            # cut: far away
    for i in range(40):                                     # tile 1: T underflows to 0
        add(24 + rng.uniform(-1, 1), 8 + rng.uniform(-1, 1), 60.0,
            1.0 if i % 7 == 3 else 0.98, [1])
    for _ in range(5):                                      # ... and entries behind it
        add(*rng.uniform(17, 31, 2), 3.0, 0.6, [1])
    for _ in range(6):                                      # tile 2: past the right edge
        add(rng.uniform(36, 46), rng.uniform(1, 15), rng.uniform(2, 4), 0.8, [2])
    for _ in range(5):                                      # tile 4: past the bottom edge
        add(rng.uniform(17, 31), rng.uniform(20, 28), rng.uniform(2, 4), 0.8, [4])
    for _ in range(4):                                      # tile 5: past both edges
        add(rng.uniform(33, 46), rng.uniform(20, 30), rng.uniform(2, 4), 0.8, [5])
    add(10, 10, 3.0, 0.8, [])                               # in no list
    for t in (0, 1, 2, 4, 5):                               # tile 3 stays empty
        lists[t].insert(int(rng.integers(0, len(lists[t]) + 1)), 0)
    # the capped and cut entries last in tile 0's list
    tail = [i for i in lists[0] if rows[i][8] in (1.0, 0.003) or rows[i][0] == 200]
    lists[0] = [i for i in lists[0] if i not in tail] + sorted(tail)

    params = np.asarray(rows, np.float32)
    table = np.zeros((6, K), np.int32)                      # padding points at gaussian 0
    counts = np.array([len(lst) for lst in lists], np.int32)
    for t, lst in enumerate(lists):
        table[t, :len(lst)] = lst
    uv, conic, colors, opacity = (params[:, :2], params[:, 2:5], params[:, 5:8],
                                  np.ascontiguousarray(params[:, 8]))
    dimg = rng.normal(size=(H, W, 3)).astype(np.float32)
    dalpha = rng.normal(size=(H, W)).astype(np.float32)
    return uv, conic, colors, opacity, table, counts, dimg, dalpha


def fma(a, b, c):
    """f32 fused multiply-add, through f64 (exact product, one f64 rounding)."""
    return (a.astype(np.float64) * b.astype(np.float64) + c.astype(np.float64)).astype(F)


def alpha_of(x, y, g):
    """composite_common.cuh's alpha_of over a tile's pixels, for entry row g."""
    ux, uy, ca, cb, cc, _, _, _, o = g
    dx, dy = x - ux, y - uy
    quad = (ca * dx) * dx + (cc * dy) * dy
    power = np.minimum(F(-0.5) * quad - (cb * dx) * dy, F(0))
    e = np.exp(power)
    a_full = o * e
    capped = a_full > CAP
    a = np.where(capped, CAP, a_full)
    cut = a < CUTOFF
    return dx, dy, e, a_full, np.where(cut, F(0), a), capped, cut


def step(state, a, rgb, on=None):
    """composite_common.cuh's step; `on` masks the lanes that take it."""
    t, c = state
    w = a * t
    new = (t * (F(1) - a), np.stack([fma(w, rgb[i], c[:, i]) for i in range(3)], 1))
    if on is None:
        return new, w
    return (np.where(on, new[0], t), np.where(on[:, None], new[1], c)), w


def tile_pixels(t):
    p = np.arange(P)
    px, py = (t % GRID_W) * TILE + p % TILE, (t // GRID_W) * TILE + p // TILE
    return px, py, (px < W) & (py < H)


def k1_numpy(params9, table, counts):
    """K1's arithmetic: (C_tot (H, W, 3), T_tot (H, W)), 0 and 1 nowhere written."""
    img, trans = np.zeros((H, W, 3), F), np.ones((H, W), F)
    for t in range(table.shape[0]):
        px, py, inside = tile_pixels(t)
        x, y = px.astype(F) + F(0.5), py.astype(F) + F(0.5)
        state = (np.ones(P, F), np.zeros((P, 3), F))
        for g in table[t, :counts[t]]:
            state, _ = step(state, alpha_of(x, y, params9[g])[4], params9[g, 5:8])
        img[py[inside], px[inside]] = state[1][inside]
        trans[py[inside], px[inside]] = state[0][inside]
    return img, trans


def butterfly(v):
    """(..., 32) -> (...): the multi-value exchange's sum over a warp's lanes."""
    for half in (16, 8, 4, 2, 1):
        v = v[..., :half] + v[..., half:2 * half]
    return v[..., 0]


def k2_numpy(params9, table, counts, img, trans, dimg, dalpha):
    """K2's one pass.  Returns the (N, 9) gradient and, per tile, the
    running state after the last entry and the suffix there."""
    grad = np.zeros_like(params9)
    ends = []
    for t in range(table.shape[0]):
        px, py, inside = tile_pixels(t)
        x, y = px.astype(F) + F(0.5), py.astype(F) + F(0.5)
        cy, cx = np.minimum(py, H - 1), np.minimum(px, W - 1)
        d = np.where(inside[:, None], dimg[cy, cx], F(0))
        dA = np.where(inside, dalpha[cy, cx], F(0))
        tot = np.where(inside[:, None], img[cy, cx], F(0))
        t_tot = np.where(inside, trans[cy, cx], F(1))
        dA_t = dA * t_tot
        wx0, wx1 = x.reshape(-1, 32).min(1), x.reshape(-1, 32).max(1)      # warp boxes
        wy0, wy1 = y.reshape(-1, 32).min(1), y.reshape(-1, 32).max(1)
        state = (np.ones(P, F), np.zeros((P, 3), F))
        acc = np.zeros((counts[t], 9), F)
        for j, g in enumerate(table[t, :counts[t]]):
            row = params9[g]
            x0, x1, y0, y1 = reach_of(*row)
            reached = ~((x1 < wx0) | (x0 > wx1) | (y1 < wy0) | (y0 > wy1))   # (warps,)
            dx, dy, e, a_full, a, capped, cut = alpha_of(x, y, row)
            warp_on = (inside & (a > 0)).reshape(-1, 32).any(1) & reached
            if not warp_on.any():
                continue
            on = np.repeat(warp_on, 32)
            t_k = state[0]
            state, w = step(state, a, row[5:8], on)
            inv = F(1) / np.maximum(F(1) - a, F(1e-6))
            dw = d[:, 0] * row[5] + d[:, 1] * row[6] + d[:, 2] * row[7]
            suffix = ((d[:, 0] * (tot[:, 0] - state[1][:, 0]) + d[:, 1] * (tot[:, 1] - state[1][:, 1]))
                      + d[:, 2] * (tot[:, 2] - state[1][:, 2]))
            da = fma(dA_t - suffix, inv, dw * t_k)
            da = np.where(capped | cut, F(0), da)
            dq = da * a_full
            ca, cb, cc = row[2], row[3], row[4]
            v = np.stack([dq * (ca * dx + cb * dy), dq * (cc * dy + cb * dx),
                          dq * (F(-0.5) * dx * dx), dq * (-dx * dy), dq * (F(-0.5) * dy * dy),
                          d[:, 0] * w, d[:, 1] * w, d[:, 2] * w, da * e])
            sums = butterfly(np.where(on, v, F(0)).reshape(9, -1, 32))      # (9, warps)
            for wi in np.flatnonzero(warp_on):
                acc[j] += sums[:, wi]
        for j, g in enumerate(table[t, :counts[t]]):
            grad[g] += acc[j]
        suffix_end = (d * (tot - state[1])).sum(1)
        ends.append((inside, state, tot, t_tot, suffix_end))
    return grad, ends


def port_grads(uv, conic, colors, opacity, table, counts, dimg, dalpha):
    leaves = [torch.from_numpy(a).requires_grad_() for a in (uv, conic, colors, opacity)]
    b = TileBinning(torch.from_numpy(table), torch.from_numpy(counts),
                    *[torch.zeros((), dtype=torch.int32)] * 3)
    img, alpha = tc.composite_plain(*leaves, b, W, H, TILE)
    grads = torch.autograd.grad((img, alpha), leaves,
                                (torch.from_numpy(dimg), torch.from_numpy(dalpha)))
    return [g.numpy() for g in grads], img.detach().numpy(), alpha.detach().numpy()


def jax_grads(uv, conic, colors, opacity, table, counts, dimg, dalpha):
    b = JBinning(jnp.asarray(table), jnp.asarray(counts), *[jnp.zeros((), jnp.int32)] * 3)
    out, vjp = jax.vjp(lambda *a: composite_pallas(*a, b, W, H, tile=TILE),
                       *(jnp.asarray(a) for a in (uv, conic, colors, opacity)))
    return [np.asarray(g) for g in vjp((jnp.asarray(dimg), jnp.asarray(dalpha)))]


def as_rows(grad9):
    return grad9[:, :2], grad9[:, 2:5], grad9[:, 5:8], grad9[:, 8]


def assert_grads_close(got, ref, what):
    for name, a, b in zip(NAMES, got, ref):
        scale = max(np.abs(b).max(), 1e-6)
        np.testing.assert_allclose(a, b, atol=GRAD_TOL[0] * scale, rtol=GRAD_TOL[1],
                                   err_msg=f"{what}: grad {name}")


@pytest.fixture(scope="module")
def case():
    uv, conic, colors, opacity, table, counts, dimg, dalpha = fixture()
    params9 = np.concatenate([uv, conic, colors, opacity[:, None]], 1)
    img, trans = k1_numpy(params9, table, counts)
    grad9, ends = k2_numpy(params9, table, counts, img, trans, dimg, dalpha)
    return dict(args=(uv, conic, colors, opacity, table, counts, dimg, dalpha),
                params9=params9, img=img, trans=trans, grad9=grad9, ends=ends)


def test_fixture_covers_the_cases(case):
    uv, conic, colors, opacity, table, counts, *_ = case["args"]
    params9 = case["params9"]
    assert counts[3] == 0 and all(counts[t] > 0 for t in (0, 1, 2, 4, 5))
    assert all(0 in table[t, :counts[t]] for t in (0, 1, 2, 4, 5))
    listed = set(np.concatenate([table[t, :counts[t]] for t in range(6)]).tolist())
    assert len(listed) < len(uv)                            # some gaussians in no list
    px, py, _ = tile_pixels(0)
    x, y = px.astype(F) + F(0.5), py.astype(F) + F(0.5)
    last = [alpha_of(x, y, params9[g]) for g in table[0, counts[0] - 3:counts[0]]]
    assert last[0][5].any() and last[1][6].all() and last[2][6].all()   # capped, cut, cut
    # T underflows to exactly 0 in the saturated tile (inside pixels)
    t1 = case["trans"][:16, 16:32]
    assert (t1 == 0).mean() > 0.9
    assert np.isfinite(case["grad9"]).all()


def test_forward_arithmetic_matches_plain(case):
    """K1's arithmetic (C_tot, T_tot) against composite_plain: K1's bound."""
    _, img, alpha = port_grads(*case["args"])
    np.testing.assert_allclose(case["img"], img, atol=1e-4, rtol=1e-4)
    np.testing.assert_allclose(1 - case["trans"], alpha, atol=1e-4, rtol=1e-4)


def test_suffix_is_exactly_zero_after_the_last_entry(case):
    """The one pass ends on the forward's C_tot and T_tot, bit for bit, at
    every pixel inside the image: the warp skip is exact and K1 and K2 add
    the same terms in the same order.  So suffix_k = dcol . (C_tot - C_<=k)
    is exactly 0 at each pixel's last entry."""
    for inside, (t_end, c_end), tot, t_tot, suffix_end in case["ends"]:
        assert np.array_equal(c_end[inside], tot[inside])
        assert np.array_equal(t_end[inside], t_tot[inside])
        assert np.all(suffix_end[inside] == 0)


@pytest.mark.parametrize("reference", ["autograd_plain", "jax_bwd_body"])
def test_onepass_arithmetic_matches(case, reference):
    if reference == "autograd_plain":
        ref, _, _ = port_grads(*case["args"])
    else:
        ref = jax_grads(*case["args"])
    got = as_rows(case["grad9"])
    assert_grads_close(got, ref, reference)
    # gaussians in no list get exactly 0
    table, counts = case["args"][4:6]
    listed = np.zeros(len(case["params9"]), bool)
    for t in range(table.shape[0]):
        listed[table[t, :counts[t]]] = True
    assert np.all(case["grad9"][~listed] == 0)


def test_butterfly_is_the_xor_tree():
    """The exchange's order: ((x_l + x_{l^16}) + (x_{l^8} + x_{l^24})) + ...,
    the same sum on every lane; the f32 result differs from a sequential sum."""
    rng = np.random.default_rng(2)
    v = (rng.normal(size=(1000, 32)) * 10.0 ** rng.integers(-3, 4, (1000, 32))).astype(F)
    tree = v.copy()
    for off in (16, 8, 4, 2, 1):
        tree = tree + tree[:, np.arange(32) ^ off]
    assert np.array_equal(butterfly(v), tree[:, 0])
    assert all(np.array_equal(tree[:, 0], tree[:, lane]) for lane in range(32))
    np.testing.assert_allclose(butterfly(v), v.astype(np.float64).sum(1), rtol=1e-5,
                               atol=1e-5 * np.abs(v).sum(1).max())


def reach_of(ux, uy, ca, cb, cc, r, g, b, o):
    """composite_common.cuh's reach_of in f32, on an entry's row: the box
    (x0, x1, y0, y1) that holds every pixel centre where the entry can reach
    a >= 1/255; every pixel when an input is not finite."""
    inf = F(np.inf)
    with np.errstate(over="ignore", invalid="ignore"):
        finite = np.isfinite(ux + uy + ca + cb + cc + o + r + g + b)
    if not finite:
        return -inf, inf, -inf, inf
    if o < CUTOFF:
        return inf, -inf, inf, -inf
    det = ca * cc - cb * cb
    if not (ca > 0 and cc > 0 and det > F(1e-3) * ca * cc):
        return -inf, inf, -inf, inf
    level = F(2.04) * np.log(F(255) * o) + F(1e-3)
    rx, ry = np.sqrt(level * cc / det) + F(1), np.sqrt(level * ca / det) + F(1)
    return ux - rx, ux + rx, uy - ry, uy + ry


def test_reach_box_holds_every_pixel_with_alpha():
    """The warps of K1 and K2 skip an entry whose reach box misses their
    pixels: sound only if every pixel centre with a > 0 (f32, alpha_of's
    order) lies in the box.  Random gaussians over a 64 x 64 grid, with
    opacities at the 1/255 cut, capped ones, near-singular and indefinite
    conics, and widths from sub-pixel to the whole grid."""
    rng = np.random.default_rng(3)
    g = np.arange(64, dtype=F) + F(0.5)
    x, y = (a.ravel() for a in np.meshgrid(g, g))
    cases = 0
    for i in range(3000):
        sx, sy = np.exp(rng.uniform(np.log(0.2), np.log(60), 2))
        rho = rng.choice([rng.uniform(-0.95, 0.95), rng.choice([-1, 1]) * rng.uniform(0.99, 1.0)])
        cov = np.array([[sx * sx, rho * sx * sy], [rho * sx * sy, sy * sy]])
        if i % 10 == 0:                      # indefinite
            ca, cb, cc = rng.uniform(0.01, 1), rng.uniform(1, 2), rng.uniform(0.01, 1)
        else:
            ca, cb, cc = np.linalg.inv(cov)[[0, 0, 1], [0, 1, 1]]
        o = rng.choice([rng.uniform(0.004, 1.0), F(1) / F(255), F(0.0039), F(1.0)])
        row = np.array([*rng.uniform(-20, 84, 2), ca, cb, cc, 0, 0, 0, o], F)
        a = alpha_of(x, y, row)[4]
        x0, x1, y0, y1 = reach_of(*row)
        inside = (x >= x0) & (x <= x1) & (y >= y0) & (y <= y1)
        assert not np.any((a > 0) & ~inside), (i, row)
        cases += bool(np.any(a > 0)) and not np.all(inside)
    assert cases > 500                       # boxes that cut something, around live pixels


@pytest.mark.parametrize("bad", ["inf_colour", "nan_colour", "inf_mean", "nan_opacity"])
def test_reach_box_of_a_non_finite_entry_holds_every_pixel(bad):
    """An entry with a non-finite input turns the plain version's a = 0
    steps into NaN (0 * Inf, or a NaN alpha) at every pixel of the tile; its
    reach box takes every pixel, so K1 steps it there too and returns the
    same NaN."""
    row = np.array([8, 8, 1, 0, 1, 0.5, 0.5, 0.5, 0.8], F)
    col, value = {"inf_colour": (6, np.inf), "nan_colour": (5, np.nan),
                  "inf_mean": (0, np.inf), "nan_opacity": (8, np.nan)}[bad]
    row[col] = value
    assert reach_of(*row) == (-np.inf, np.inf, -np.inf, np.inf)
    # far from a finite entry's mean, a = 0 and the step leaves the state as it was
    far = row.copy()
    far[col] = 0.5 if col >= 5 else 8
    x, y = np.array([60.5], F), np.array([60.5], F)
    x0, x1, y0, y1 = reach_of(*far)
    assert not (x0 <= x[0] <= x1 and y0 <= y[0] <= y1)
    state = (np.ones(1, F), np.full((1, 3), 0.25, F))
    with np.errstate(invalid="ignore", over="ignore"):
        stepped, _ = step(state, alpha_of(x, y, row)[4], row[5:8])
        kept, _ = step(state, alpha_of(x, y, far)[4], far[5:8])
    assert not np.isfinite(stepped[1]).all()
    assert np.array_equal(kept[1], state[1]) and np.array_equal(kept[0], state[0])
