"""Kernel V (`omfs4d_torch/csrc/composite_variants.cu`, the K2 ablation
variants) against its plain PyTorch version `variant_plain`, every mode, on
a CUDA card.  Without a card every test here skips.

This file imports only the port (no jax), so it also runs on a machine
without JAX:
    python -m pytest --noconftest tests/test_torch_composite_variants_card.py
Bounds are `profile_composite_variants.compare`'s, derived in
tests/test_torch_composite_variants.py.  The hand-built table
(`profile_composite_variants.fixture_inputs`) is the one the CPU tests of
V's walk use (tests/test_torch_composite_variants_lists.py).
"""

import numpy as np
import pytest
import torch

from omfs4d_torch.scripts import profile_composite_variants as pcv


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: kernel V has no CPU mode")
    return torch.device("cuda", 0)


def table(T, K, grid_w, tile, device, seed=0):
    """A packed table over a grid_w-wide grid of tiles, with capped, cut and
    zero-opacity padding entries, and normal cotangents."""
    rng = np.random.default_rng(seed)
    grid_h = -(-T // grid_w)
    packed = np.zeros((T, 9, K), np.float32)
    packed[:, 0] = rng.uniform(-8, tile * grid_w + 8, (T, K))
    packed[:, 1] = rng.uniform(-8, tile * grid_h + 8, (T, K))
    packed[:, 2] = rng.uniform(0.005, 0.2, (T, K))
    packed[:, 3] = rng.uniform(-0.03, 0.03, (T, K))
    packed[:, 4] = rng.uniform(0.005, 0.2, (T, K))
    packed[:, 5:8] = rng.uniform(0, 1, (T, 3, K))
    opacity = rng.uniform(0.05, 1.0, (T, K))
    opacity[rng.uniform(size=(T, K)) < 0.15] = 1.0
    opacity[:, 3 * K // 4:] = 0.0
    packed[:, 8] = opacity
    P = tile * tile
    arrays = (packed, rng.normal(size=(T, 3, P)), rng.normal(size=(T, 1, P)))
    return [torch.tensor(a, dtype=torch.float32, device=device) for a in arrays]


def assert_matches_plain(mode, args, tile, grid_w):
    before = pcv.launches[mode]
    got = pcv.make_variant_kernel(mode)(*args, tile=tile, grid_w=grid_w)
    torch.cuda.synchronize()
    assert pcv.launches[mode] == before + 1
    ref = pcv.variant_plain(mode, *args, tile=tile, grid_w=grid_w)
    assert bool(torch.isfinite(got).all())
    res = pcv.compare(mode, got, ref, args[0])
    assert res["ok"], f"{mode}: {res}"
    return got


@pytest.mark.parametrize("T,K,grid_w,tile", [
    (4, 32, 2, 16),        # the CPU parity test's shape
    (6, 100, 3, 16),       # two chunks of the block list, the second partial
    (4, 200, 2, 16),       # four chunks: both buffers of parked sums reused
    (9, 70, 3, 8),         # 8-px tiles: 64-thread blocks
    (3, 40, 2, 6),         # 36 pixels: a partial second warp of non-pixels
])
@pytest.mark.parametrize("mode", pcv.MODES)
def test_variant_matches_plain_on_card(cuda_device, mode, T, K, grid_w, tile):
    args = table(T, K, grid_w, tile, cuda_device)
    got = assert_matches_plain(mode, args, tile, grid_w)
    # one block owns each tile's output: no atomics, the same bits every run
    again = pcv.make_variant_kernel(mode)(*args, tile=tile, grid_w=grid_w)
    assert torch.equal(got, again)


@pytest.mark.parametrize("K", [38, 40])
@pytest.mark.parametrize("mode", pcv.MODES)
def test_variant_matches_plain_on_the_fixture_on_card(cuda_device, mode, K):
    """The hand-built table: slots that reach no pixel in front of live ones,
    singular and indefinite conics, an opacity below 1/255, capped and cut
    entries, a saturated tile, means past the grid's edges, a padding tile;
    K = 38 takes the unaligned staging and stores, K = 40 the bulk copy."""
    args = [torch.from_numpy(a).to(cuda_device) for a in pcv.fixture_inputs(K=K)]
    got = assert_matches_plain(mode, args, pcv.TILE, pcv.FIXTURE_GRID_W)
    assert not got[3].any()
    if mode in ("matmuls", "bf16_matmuls"):
        assert got[0, 0, 0] != 0 and got[0, 0, 8] == got[0, 0, 9] != 0
    again = pcv.make_variant_kernel(mode)(*args, grid_w=pcv.FIXTURE_GRID_W)
    assert torch.equal(got, again)


@pytest.mark.parametrize("kind", list(pcv.NON_FINITE))
@pytest.mark.parametrize("mode", [m for m in pcv.MODES if m != "copy"])
def test_non_finite_entry_matches_plain_on_card(cuda_device, mode, kind):
    """A NaN or Inf entry in the middle of a list: V is NaN exactly where the
    plain version is (at the entry and, through 0 * NaN, at later entries of
    the tile, also those that reach no pixel), and within the bound
    elsewhere."""
    args = [torch.from_numpy(a).to(cuda_device)
            for a in pcv.fixture_inputs(K=40, non_finite=kind)]
    got = pcv.make_variant_kernel(mode)(*args, grid_w=pcv.FIXTURE_GRID_W)
    ref = pcv.variant_plain(mode, *args, grid_w=pcv.FIXTURE_GRID_W)
    res = pcv.compare_non_finite(mode, got, ref, args[0])
    assert res["ok"], f"{mode} {kind}: {res}"
    if mode != "elementwise" or "colour" not in kind:
        assert res["non_finite"] > 0
    assert bool(torch.isfinite(got[1:4]).all())


def test_a_refused_launch_raises_on_card(cuda_device):
    """K = 8192: the tile's slab alone (288 KB) is past a block's shared
    memory, so the launch is refused and the call raises."""
    packed = torch.zeros((1, 9, 8192), device=cuda_device)
    dcol = torch.zeros((1, 3, 256), device=cuda_device)
    dalpha = torch.zeros((1, 1, 256), device=cuda_device)
    before = dict(pcv.launches)
    with pytest.raises(RuntimeError, match="launch failed"):
        pcv.make_variant_kernel("full_bf16")(packed, dcol, dalpha, grid_w=1)
    assert pcv.launches == before
    torch.cuda.synchronize()
    out = pcv.make_variant_kernel("copy")(packed, dcol, dalpha, grid_w=1)   # the card is fine
    assert not out.any()


def test_copy_of_an_unaligned_table_on_card(cuda_device):
    """A contiguous view 4 bytes into its storage takes the scalar copy."""
    packed, dcol, dalpha = table(4, 32, 2, 16, cuda_device)
    store = torch.empty(packed.numel() + 1, device=cuda_device)
    shifted = store[1:].view(packed.shape)
    shifted.copy_(packed)
    assert shifted.data_ptr() % 16 != 0
    assert_matches_plain("copy", (shifted, dcol, dalpha), 16, 2)


@pytest.mark.parametrize("mode", pcv.MODES)
def test_variant_matches_plain_at_the_reference_shape_on_card(cuda_device, mode):
    """T = 1024, K = 512, P = 256: the profiler's own table."""
    packed, dcol, dalpha, _ = pcv.synthetic_inputs(0)
    args = [torch.from_numpy(a).to(cuda_device) for a in (packed, dcol, dalpha)]
    assert_matches_plain(mode, args, pcv.TILE, pcv.GRID_W)


@pytest.mark.parametrize("mode", ["bf16_matmuls", "full_bf16"])
def test_bf16_bound_rejects_the_unrounded_result_on_card(cuda_device, mode):
    """The control: variant_plain without its five bf16 roundings, at the
    reference shape, fails the bound that V passes."""
    packed, dcol, dalpha, _ = pcv.synthetic_inputs(0)
    args = [torch.from_numpy(a).to(cuda_device) for a in (packed, dcol, dalpha)]
    ref = pcv.variant_plain(mode, *args)
    res = pcv.compare(mode, pcv.variant_plain(mode, *args, rounded=False), ref, args[0])
    assert res["share"] > 1e-2, res


def test_profiler_main_runs_on_card(cuda_device, capsys):
    before = dict(pcv.launches)
    assert pcv.main() == 0
    out = capsys.readouterr().out
    for label in ("fwd (current)", "bwd (current)", *(f"bwd variant: {m}" for m in pcv.MODES),
                  "torch.sort 2.1M pairs", "torch.sort 131k (gaussian-level)"):
        assert label in out
    assert all(pcv.launches[m] > before[m] for m in pcv.MODES)
