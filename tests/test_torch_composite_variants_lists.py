"""Kernel V's walk over the entries that reach a tile
(`omfs4d_torch/csrc/composite_variants.cu`), on the CPU: its arithmetic
written out in numpy float32 in the kernel's order, held to `variant_plain`
and to the JAX package's `scripts/profile_composite_variants.py` kernel in
Pallas interpret mode, for every mode.

The transcription (`v_walk`) takes each slot's reach box (`reach_of`,
composite_common.cuh), lists the slots whose box meets the tile (the block
list), lets each warp (32 pixels in index order, one a thread) walk the
listed entries whose box meets the box of its own pixels, in both passes,
skips an entry for a warp none of whose pixels has a term, sums an entry's
terms over the warp's lanes in the order of the multi-value exchange (the
xor butterfly 16, 8, 4, 2, 1), then over the warps in warp order; fills
row 0 of the matmul modes from the inclusive suffix over the block list (32
runs, as warp 0 takes it); keeps full_bf16's per-pixel sums of m in f64 with
the non-finite ones counted apart; and walks every slot with every warp in a
tile that holds a non-finite entry.

The inputs are `profile_composite_variants.fixture_inputs`, whose docstring
lists the cases it holds, at K = 38 (no multiple of 4) and K = 40.

Bounds: `profile_composite_variants.compare` (BOUND per `row_scale`, derived
in tests/test_torch_composite_variants.py).  With a non-finite entry, the
outputs must be non-finite in the same places (NaN where NaN, the same Inf)
and within the bound elsewhere.
"""

import functools
import types

import numpy as np
import pytest
import torch
from jax.experimental import pallas as pl

from omfs4d_torch.scripts import profile_composite_variants as pcv
from tests.test_torch_composite_onepass import alpha_of, butterfly, fma, reach_of
from tests.test_torch_composite_variants import script  # noqa: F401  (a fixture)

F = np.float32
TILE, GRID_W, P = 16, pcv.FIXTURE_GRID_W, 256
WALKED = [m for m in pcv.MODES if m != "copy"]
SUMS = {"elementwise": 6, "matmuls": 4, "bf16_matmuls": 4, "full_bf16": 9}
#: the output row of an entry's sum r
ROW_OF_SUM = {"elementwise": [0, 1, 2, 3, 4, 8], "matmuls": [0, 6, 7, 8],
              "bf16_matmuls": [0, 6, 7, 8], "full_bf16": list(range(9))}


def t_(x):
    return torch.from_numpy(np.array(x))


def bf16(v):
    return torch.from_numpy(np.ascontiguousarray(v, F)).to(torch.bfloat16).float().numpy()


def threads_of(tile):
    """(column, row) of each thread's pixel, for tile * tile rounded up to
    whole warps, and the mask of the threads that have a pixel."""
    p = np.arange(-(-tile * tile // 32) * 32)
    return p % tile, p // tile, p < tile * tile


def boxes_meet(reach, box):
    x0, x1, y0, y1 = reach
    return not (x1 < box[0] or x0 > box[1] or y1 < box[2] or y0 > box[3])


def lists_of(packed_t, t, tile=TILE, grid_w=GRID_W):
    """The block list of tile t, per listed entry the warps it reaches, and
    whether the tile walks every slot (a non-finite entry)."""
    K = packed_t.shape[1]
    tx, ty = F((t % grid_w) * tile), F((t // grid_w) * tile)
    col, row, _ = threads_of(tile)
    x = (tx + col.astype(F) + F(0.5)).reshape(-1, 32)
    y = (ty + row.astype(F) + F(0.5)).reshape(-1, 32)
    with np.errstate(invalid="ignore", over="ignore"):
        every = not np.isfinite(packed_t.sum(0, dtype=F)).all()
    reach = [reach_of(*packed_t[:, j]) for j in range(K)]
    tile_box = (tx + F(0.5), tx + F(tile) - F(0.5), ty + F(0.5), ty + F(tile) - F(0.5))
    blist = [j for j in range(K) if every or boxes_meet(reach[j], tile_box)]
    # a warp's box takes all its threads, those past the tile too
    warp_boxes = list(zip(x.min(1), x.max(1), y.min(1), y.max(1)))
    reaches = {j: np.array([every or boxes_meet(reach[j], b) for b in warp_boxes])
               for j in blist}
    return blist, reaches, every


class MSum:
    """full_bf16's sums of m: the finite ones in f64, the others counted."""

    def __init__(self, shape):
        self.sum = np.zeros(shape)
        self.nan, self.pos, self.neg = (np.zeros(shape, int) for _ in range(3))

    def add(self, m, on):
        fin = np.isfinite(m)
        self.sum += np.where(on & fin, m, 0).astype(np.float64)
        self.nan += on & np.isnan(m)
        self.pos += on & (m == np.inf)
        self.neg += on & (m == -np.inf)


def suffix_of(total, upto):
    nan, pos, neg = total.nan - upto.nan, total.pos - upto.pos, total.neg - upto.neg
    out = (total.sum - upto.sum).astype(F)
    out = np.where(pos > 0, F(np.inf), out)
    out = np.where(neg > 0, F(-np.inf), out)
    return np.where((nan > 0) | ((pos > 0) & (neg > 0)), F(np.nan), out)


def v_walk(mode, packed, dcol, dalpha, tile=TILE, grid_w=GRID_W):
    """Kernel V's arithmetic for every mode but copy, in f32."""
    rounded = mode in ("bf16_matmuls", "full_bf16")
    rnd = bf16 if rounded else (lambda v: np.asarray(v, F))
    two_pass = mode in ("elementwise", "full_bf16")
    T, _, K = packed.shape
    R = SUMS[mode]
    out = np.zeros(packed.shape, F)
    col, row, has = threads_of(tile)
    n_warps = len(col) // 32
    pixel = np.where(has, np.arange(len(col)), 0)
    for t in range(T):
        tab = packed[t]
        blist, reaches, every = lists_of(tab, t, tile, grid_w)
        x = F((t % grid_w) * tile) + col.astype(F) + F(0.5)
        y = F((t // grid_w) * tile) + row.astype(F) + F(0.5)
        d = np.where(has, rnd(dcol[t])[:, pixel], F(0))             # (3, threads)
        dA = np.where(has, dalpha[t, 0][pixel], F(0))
        rgb = rnd(tab[5:8])

        def warps(on):
            """(warps,) -> (threads,)"""
            return np.repeat(on, 32) & has

        def weights(a, s_excl, j):
            t_excl = np.exp(s_excl)
            w = a * t_excl
            dw = fma(d[2], rgb[2, j], fma(d[1], rgb[1, j], d[0] * rgb[0, j]))
            return t_excl, w, dw, rnd(dw * w)

        s_total = np.zeros(len(col), F)
        m_tot = MSum(len(col))
        with np.errstate(invalid="ignore", over="ignore", divide="ignore"):
            if two_pass:
                s_excl = np.zeros(len(col), F)
                for j in blist:
                    a = alpha_of(x, y, tab[:, j])[4]
                    on = warps(reaches[j]) & (every | (a > 0))
                    u = F(1) - a
                    lg = np.log(np.where(u < F(1e-6), F(1e-6), u))
                    s_total = np.where(on, s_total + lg, s_total)
                    if mode == "full_bf16":
                        m_tot.add(weights(a, s_excl, j)[3], on)
                        s_excl = np.where(on, s_excl + rnd(lg), s_excl)
            t_total = np.exp(s_total)

            s_excl = np.zeros(len(col), F)
            m_le = MSum(len(col))
            for j in blist:
                dx, dy, _, a_full, a, capped, cut = alpha_of(x, y, tab[:, j])
                ok = ~(capped | cut)
                terms = (ok if mode == "elementwise" else a > 0) & has
                live = reaches[j] & (every | terms.reshape(n_warps, -1).any(1))   # (warps,)
                if not live.any():
                    continue
                on = warps(live)
                u = F(1) - a
                one_minus = np.where(u < F(1e-6), F(1e-6), u)
                v = np.zeros((R, len(col)), F)
                if two_pass:
                    if mode == "elementwise":
                        t_excl, suffix, dw = one_minus, a * F(0.5), a + F(0.1)
                    else:
                        t_excl, w, dw, m = weights(a, s_excl, j)
                        m_le.add(m, on)
                        suffix = suffix_of(m_tot, m_le)
                        wb = rnd(w)
                        v[5:8] = d * wb
                        s_excl = np.where(on, s_excl + rnd(np.log(one_minus)), s_excl)
                    inv = F(1) / one_minus
                    da = fma(dA * t_total - suffix, inv, dw * t_excl)
                    da = np.where(ok, da, F(0))
                    ca, cb, cc, o = tab[2, j], tab[3, j], tab[4, j], tab[8, j]
                    dq = da * a_full
                    v[0] = dq * (ca * dx + cb * dy)
                    v[1] = dq * (cc * dy + cb * dx)
                    v[2] = dq * (F(-0.5) * dx * dx)
                    v[3] = dq * (-dx * dy)
                    v[4] = dq * (F(-0.5) * dy * dy)
                    v[R - 1] = da * (a_full * (F(1) / np.maximum(o, F(1e-12))))
                else:
                    t_excl, w, dw, m = weights(a, s_excl, j)
                    wb = rnd(w)
                    v[0] = m
                    v[1:4] = d * wb
                    s_excl = np.where(on, s_excl + rnd(np.log(one_minus)), s_excl)
                v = np.where(on[None], v, F(0))
                sums = butterfly(v.reshape(R, n_warps, 32))                        # (R, warps)
                acc = np.zeros(R, F)
                for w_i in np.flatnonzero(live):
                    acc = acc + sums[:, w_i]
                out[t, ROW_OF_SUM[mode], j] = acc
            if mode in ("matmuls", "bf16_matmuls"):
                out[t, 0] = row0_from_list(out[t, 0], blist)
    return out


def row0_from_list(m_sums, blist):
    """Row 0 of the matmul modes from the listed slots' M: the inclusive
    suffix over the block list as warp 0 takes it (32 runs, the runs' sums
    scanned from the right, each run walked down), then each slot reads the
    first listed entry behind it."""
    n = len(blist)
    K = len(m_sums)
    incl = np.zeros(n + 1, F)
    with np.errstate(invalid="ignore", over="ignore"):
        if n:
            run = -(-n // 32)
            bounds = [(min(l * run, n), min(l * run + run, n)) for l in range(32)]
            local = np.zeros(32, F)
            for l, (a, b) in enumerate(bounds):
                for i in range(a, b):
                    local[l] = local[l] + m_sums[blist[i]]
            scan = local.copy()
            off = 1
            while off < 32:
                scan = scan + np.concatenate([scan[off:], np.zeros(off, F)])
                off *= 2
            for l, (a, b) in enumerate(bounds):
                acc = scan[l + 1] if l < 31 else F(0)
                for i in range(b - 1, a - 1, -1):
                    acc = acc + m_sums[blist[i]]
                    incl[i] = acc
    behind = np.searchsorted(np.asarray(blist, int), np.arange(K), side="right")
    return incl[behind]


def jax_variant(script, monkeypatch, mode, packed, dcol, dalpha, grid_w=GRID_W):
    """The reference's variant kernel in Pallas interpret mode."""
    monkeypatch.setattr(script, "T", packed.shape[0])
    monkeypatch.setattr(script, "K", packed.shape[2])
    monkeypatch.setattr(script, "GRID_W", grid_w)
    monkeypatch.setattr(script, "pl", types.SimpleNamespace(
        pallas_call=functools.partial(pl.pallas_call, interpret=True),
        BlockSpec=pl.BlockSpec, program_id=pl.program_id))
    return np.asarray(script.make_variant_kernel(mode)(packed, dcol, dalpha))


def plain(mode, packed, dcol, dalpha, grid_w=GRID_W):
    return pcv.variant_plain(mode, t_(packed), t_(dcol), t_(dalpha), grid_w=grid_w).numpy()


def assert_close(mode, got, ref, packed):
    """`compare`'s bound; where ref is not finite, got must be the same."""
    res = pcv.compare_non_finite(mode, t_(np.asarray(got, F)), t_(np.asarray(ref, F)),
                                 t_(packed))
    assert res["ok"], f"{mode}: {res}"


def tile_alphas(packed, t, grid_w=GRID_W):
    p = np.arange(P)
    x = F((t % grid_w) * TILE) + (p % TILE).astype(F) + F(0.5)
    y = F((t // grid_w) * TILE) + (p // TILE).astype(F) + F(0.5)
    with np.errstate(invalid="ignore", over="ignore"):
        return [alpha_of(x, y, packed[t][:, j]) for j in range(packed.shape[2])]


def test_fixture_covers_the_cases():
    packed, dcol, dalpha = pcv.fixture_inputs()
    assert packed.shape == (5, 9, 38) and packed.shape[2] % 4 != 0
    assert dcol.shape == (5, 3, P) and dalpha.shape == (5, 1, P)
    a0 = tile_alphas(packed, 0)
    live = np.array([(al[4] > 0).any() for al in a0])
    # slot 0 and one in the middle reach no pixel, with live entries behind them
    assert not live[0] and not live[8] and live[1:6].all() and live[12:16].any()
    blist, reaches, every = lists_of(packed[0], 0)
    assert not every and 0 not in blist and 8 not in blist
    # singular and indefinite conics reach every pixel from far away
    for j in (6, 7):
        ca, cb, cc = packed[0, 2:5, j]
        assert ca * cc - cb * cb <= 1e-3 * ca * cc and reaches[j].all()
        assert np.hypot(packed[0, 0, j], packed[0, 1, j]) > 150 and (a0[j][4] > 0).any()
    assert (a0[7][4] > 0).all()
    assert packed[0, 3, 7] ** 2 > packed[0, 2, 7] * packed[0, 4, 7]
    assert 0 < packed[0, 8, 9] < 1 / 255 and 9 not in blist
    assert a0[10][5].any()                                  # capped
    assert 11 in blist and a0[11][6].all()                  # listed, cut at every pixel
    assert (packed[0, 8, 16:] == 0).all()                   # padding behind the entries
    # tile 1: the transmittance underflows behind the saturated entries
    a1 = np.stack([al[4] for al in tile_alphas(packed, 1)])
    assert (np.prod(1 - a1[:12], 0) < 1e-12).mean() > 0.5 and (a1[12:17] > 0).any()
    assert (packed[2, 0, :8] > 40).all() and (packed[2, 0, :8] > 48).any()   # past the right edge
    assert not packed[3].any()                              # padding only
    assert (packed[4, 1, :10] > 32).any()                   # past the bottom edge
    for kind, (row, value) in pcv.NON_FINITE.items():
        bad, _, _ = pcv.fixture_inputs(non_finite=kind)
        assert np.array_equal(np.argwhere(~np.isfinite(bad)), [[0, row, 5], [4, row, 5]])
        assert lists_of(bad[0], 0)[2] and lists_of(bad[0], 0)[0] == list(range(38))
        assert not lists_of(bad[1], 1)[2]


@pytest.mark.parametrize("K", [38, 40])
@pytest.mark.parametrize("mode", WALKED)
def test_walk_matches_plain(mode, K):
    packed, dcol, dalpha = pcv.fixture_inputs(K=K)
    got = v_walk(mode, packed, dcol, dalpha)
    ref = plain(mode, packed, dcol, dalpha)
    assert np.abs(ref).max() > 0
    assert_close(mode, got, ref, packed)
    assert not got[3].any()                                 # the padding tile


@pytest.mark.parametrize("mode", WALKED)
def test_walk_matches_jax(script, monkeypatch, mode):  # noqa: F811
    packed, dcol, dalpha = pcv.fixture_inputs()
    ref = jax_variant(script, monkeypatch, mode, packed, dcol, dalpha)
    assert_close(mode, v_walk(mode, packed, dcol, dalpha), ref, packed)
    assert_close(mode, plain(mode, packed, dcol, dalpha), ref, packed)


@pytest.mark.parametrize("mode", WALKED)
def test_walk_on_small_tiles(mode):
    """6-px tiles: 36 pixels in two warps, the second mostly threads past
    the tile."""
    rng = np.random.default_rng(11)
    T, K, tile, grid_w = 3, 24, 6, 2
    packed = np.zeros((T, 9, K), F)
    packed[:, 0] = rng.uniform(-4, tile * grid_w + 4, (T, K))
    packed[:, 1] = rng.uniform(-4, tile * 2 + 4, (T, K))
    packed[:, 2] = rng.uniform(0.02, 0.5, (T, K))
    packed[:, 3] = rng.uniform(-0.03, 0.03, (T, K))
    packed[:, 4] = rng.uniform(0.02, 0.5, (T, K))
    packed[:, 5:8] = rng.uniform(0, 1, (T, 3, K))
    packed[:, 8] = rng.uniform(0.05, 1.0, (T, K))
    packed[:, 8, 3 * K // 4:] = 0
    dcol = rng.normal(size=(T, 3, tile * tile)).astype(F)
    dalpha = rng.normal(size=(T, 1, tile * tile)).astype(F)
    got = v_walk(mode, packed, dcol, dalpha, tile=tile, grid_w=grid_w)
    ref = pcv.variant_plain(mode, t_(packed), t_(dcol), t_(dalpha), tile=tile,
                            grid_w=grid_w).numpy()
    assert_close(mode, got, ref, packed)


@pytest.mark.parametrize("mode", ["matmuls", "bf16_matmuls"])
def test_row0_of_a_slot_that_reaches_no_pixel(mode):
    """Row 0 is the sum over the later slots: nonzero on slots 0 and 8 of
    tile 0, which the walk never visits, and equal across a run of unlisted
    slots."""
    packed, dcol, dalpha = pcv.fixture_inputs()
    got = v_walk(mode, packed, dcol, dalpha)
    ref = plain(mode, packed, dcol, dalpha)
    for j in (0, 8):
        assert ref[0, 0, j] != 0 and not got[0, 6:9, j].any()
        np.testing.assert_allclose(got[0, 0, j], ref[0, 0, j], rtol=2e-3)
    assert got[0, 0, 8] == got[0, 0, 9]                     # slot 9 is unlisted too
    assert (got[0, 0, 15:] == 0).all()                      # nothing behind the last entry


@pytest.mark.parametrize("kind", list(pcv.NON_FINITE))
@pytest.mark.parametrize("mode", WALKED)
def test_non_finite_entry_in_the_middle_of_a_list(script, monkeypatch, mode, kind):  # noqa: F811
    """NaN exactly where the plain version has NaN: at the entry, and through
    0 * NaN at later entries of the tile, also those that reach no pixel; the
    tiles without such an entry stay finite.  The JAX kernel has a NaN there
    too; its triangular matmuls spread it further over the tile (0 * NaN in
    every product), also to entries in front."""
    packed, dcol, dalpha = pcv.fixture_inputs(non_finite=kind)
    ref = plain(mode, packed, dcol, dalpha)
    got = v_walk(mode, packed, dcol, dalpha)
    assert_close(mode, got, ref, packed)
    assert np.isfinite(ref[1:4]).all()
    uses_colour = mode != "elementwise"
    if uses_colour or "colour" not in kind:
        assert np.isnan(ref[0]).any() and np.isnan(ref[4]).any()
    else:
        assert np.isfinite(ref).all()
    if kind == "nan_mean" and mode != "elementwise":
        # slot 8 reaches no pixel, behind the NaN entry: its colour rows are NaN
        assert np.isnan(ref[0, 5 if mode == "full_bf16" else 6, 8])
    jax_out = jax_variant(script, monkeypatch, mode, packed, dcol, dalpha)
    assert np.isnan(jax_out[np.isnan(ref)]).all()
    assert np.isfinite(jax_out[1:4]).all()


@pytest.mark.parametrize("seed", range(4))
def test_lists_never_drop_a_live_entry(seed):
    """Over 1,000 random gaussians a seed (sub-pixel to grid-wide, near
    singular and indefinite conics, opacities at the cut and capped), on a
    4 x 4 grid of tiles: wherever a pixel of a warp has a > 0, the entry is in
    the tile's block list and reaches that warp."""
    rng = np.random.default_rng(100 + seed)
    n, grid = 1000, 4
    sx, sy = np.exp(rng.uniform(np.log(0.2), np.log(60), (2, n)))
    rho = np.where(rng.uniform(size=n) < 0.5, rng.uniform(-0.95, 0.95, n),
                   rng.choice([-1, 1], n) * rng.uniform(0.99, 1.0, n))
    det = (sx * sy) ** 2 * (1 - rho ** 2) + 1e-30
    ca, cb, cc = sy * sy / det, -rho * sx * sy / det, sx * sx / det
    odd = np.arange(n) % 10 == 0                           # indefinite
    ca = np.where(odd, rng.uniform(0.01, 1, n), ca)
    cb = np.where(odd, rng.uniform(1, 2, n), cb)
    cc = np.where(odd, rng.uniform(0.01, 1, n), cc)
    o = rng.choice([0.5, 1 / 255, 0.0039, 1.0], n)
    o = np.where(o == 0.5, rng.uniform(0.004, 1.0, n), o)
    table = np.zeros((9, n), F)
    table[0], table[1] = rng.uniform(-20, 84, (2, n))
    table[2], table[3], table[4], table[8] = ca, cb, cc, o
    kept = dropped = 0
    for t in range(grid * grid):
        blist, reaches, every = lists_of(table, t, grid_w=grid)
        assert not every
        col, row, has = threads_of(TILE)
        x = F((t % grid) * TILE) + col.astype(F) + F(0.5)
        y = F((t // grid) * TILE) + row.astype(F) + F(0.5)
        listed = set(blist)
        for j in range(n):
            a = alpha_of(x, y, table[:, j])[4]
            live_warps = ((a > 0) & has).reshape(len(col) // 32, -1).any(1)
            if live_warps.any():
                assert j in listed, (t, j, table[:, j])
                assert reaches[j][live_warps].all(), (t, j, table[:, j])
                kept += 1
            dropped += j not in listed
    assert kept > 1000 and dropped > 1000


def exchange(v, keep_bits):
    """The multi-value exchange of composite_common.cuh on (n, 32) values of
    32 lanes: at xor step 16, 8 (and 4) a lane keeps the half of its values
    picked by that bit of its lane number and adds its partner's; then plain
    xor steps.  Returns per lane the value it ends with and which one."""
    lane = np.arange(32)
    vals = [v[i].copy() for i in range(len(v))]
    which = np.zeros(32, int)
    steps = [16, 8, 4, 2, 1]
    for off in steps[:keep_bits]:
        half = len(vals) // 2
        hi = (lane & off) != 0
        new = []
        for i in range(half):
            send = np.where(hi, vals[i], vals[i + half])
            keep = np.where(hi, vals[i + half], vals[i])
            new.append(keep + send[lane ^ off])
        which = which + np.where(hi, half, 0)
        vals = new
    s = vals[0]
    for off in steps[keep_bits:]:
        s = s + s[lane ^ off]
    return s, which


@pytest.mark.parametrize("n,keep_bits,shift,mask", [(8, 3, 2, 7), (4, 2, 3, 3)])
def test_exchange_leaves_each_sum_on_its_lanes(n, keep_bits, shift, mask):
    """warp_sum8 leaves value (l >> 2) & 7 on lane l, warp_sum4 value
    (l >> 3) & 3, each the butterfly's tree."""
    rng = np.random.default_rng(5)
    v = (rng.normal(size=(n, 32)) * 10.0 ** rng.integers(-3, 4, (n, 32))).astype(F)
    s, which = exchange(v, keep_bits)
    lane = np.arange(32)
    assert np.array_equal(which, (lane >> shift) & mask)
    assert np.array_equal(s, butterfly(v)[which])


def test_a_remembered_check_refuses_what_the_full_check_refuses(monkeypatch):
    """`_check_inputs` skips a signature (shape, strides, dtype, device of
    each tensor, tile, grid_w) that passed once; a call that differs in any
    of them is checked in full and refused as before."""
    from omfs4d_torch.render import composite as tc
    monkeypatch.setattr(tc, "_device_type", lambda t: "cuda")
    monkeypatch.setattr(pcv, "_taken", set())
    packed, dcol, dalpha = torch.zeros(2, 9, 8), torch.zeros(2, 3, 256), torch.zeros(2, 1, 256)
    pcv._check_inputs(packed, dcol, dalpha, 16, 32)
    assert len(pcv._taken) == 1
    pcv._check_inputs(packed.clone(), dcol, dalpha, 16, 32)     # the same signature
    assert len(pcv._taken) == 1
    bad_calls = {
        "float64": (packed.double(), dcol, dalpha, 16, 32),
        "strides": (packed.transpose(0, 2).contiguous().transpose(0, 2), dcol, dalpha, 16, 32),
        "rows": (packed[:, :8].contiguous(), dcol, dalpha, 16, 32),
        "pixels": (packed, dcol, dalpha, 8, 32),
        "tiles": (packed, dcol[:1], dalpha, 16, 32),
        "grid_w": (packed, dcol, dalpha, 16, 0),
        "meta device": (packed, dcol.to("meta"), dalpha, 16, 32),
    }
    for what, args in bad_calls.items():
        with pytest.raises(ValueError):
            pcv._check_inputs(*args)
        with pytest.raises(ValueError):                          # and again: not remembered
            pcv._check_inputs(*args)
    assert len(pcv._taken) == 1
