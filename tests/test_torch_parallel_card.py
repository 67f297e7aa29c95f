"""K1 and K2 under the sharded renders' entry point, `composite_lists`, on a
CUDA card with 2 ranks of one gloo group sharing it (test_torch_parallel_
harness spawns them).  Without a card the test skips.

This file imports only the port (no jax), so it also runs on a machine
without JAX:  python -m pytest --noconftest tests/test_torch_parallel_card.py
Each rank holds its slab of a 96x80 grid (30 tiles, the second slab's base
15) and of an 80x80 grid (25 tiles: slabs of 13 with one padding row, which
is trimmed before K1) against the plain version: forward atol = rtol = 1e-4,
gradients atol = 2e-4 * max|plain|, rtol = 2e-3 (K2 scatters with float
atomics), and the gathered tile-sharded composite against one K1 launch of
the whole grid within 1e-4.
"""

import numpy as np
import pytest
import torch

from test_torch_parallel_harness import World  # tests/ is on the path, as for every test file


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the composite kernels have no CPU mode")
    return torch.device("cuda", 0)


def test_composite_lists_on_slabs_of_two_ranks(cuda_device, tmp_path):
    out = World(2, tmp_path).run("card_composite_lists").wait()["card_composite_lists"]
    for rank, res in enumerate(out):
        for name in ("even", "padded"):
            assert int(res[f"{name}_base"]) == rank * (15 if name == "even" else 13)
            assert list(res[f"{name}_launches"]) == [1, 1]
            for key in ("col", "alp"):
                np.testing.assert_allclose(res[f"{name}_{key}_k"], res[f"{name}_{key}_plain"],
                                           atol=1e-4, rtol=1e-4, err_msg=f"{name} {key}")
            for key in ("duv", "dconic", "dcolors", "dopacity"):
                plain = res[f"{name}_{key}_plain"]
                np.testing.assert_allclose(res[f"{name}_{key}_k"], plain,
                                           atol=2e-4 * max(np.abs(plain).max(), 1e-8),
                                           rtol=2e-3, err_msg=f"{name} {key}")
            assert float(res[f"{name}_sharded_err"]) <= 1e-4
        # the padded slab's padding row comes back as zeros
        assert not out[1]["padded_col_k"][-1].any() and not out[1]["padded_alp_k"][-1].any()
