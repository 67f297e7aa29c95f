"""The port's bench (`omfs4d_torch.scripts.bench`) on the CPU: `--cpu` runs
end to end and prints one line with `bench.py`'s keys and no rate; without a
card it prints an `error` line and exits 1, and so does a forced failure;
the dispatch counter on programs whose work is known; `pair_counts` against
a count in NumPy, pixel by pixel; `chip_smoke.py` still offers the helpers
that moved into the bench."""

import json
import os
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

from omfs4d_torch.scripts import bench

ROOT = Path(__file__).resolve().parents[1]
# bench.py's line (bench.py:438-462), and the keys of its `extra` the port
# keeps; `pallas` became `kernels`, `tpu_unreachable` `device` and
# `power_limit_w`
LINE_KEYS = {"metric", "value", "unit", "vs_baseline", "extra"}
KEPT_EXTRA = {"train_ips_per_step_dispatch", "render_fps", "flame_fit_iters_per_sec",
              "n_gaussians", "resolution", "backend", "mfu", "mfu_f32", "floors",
              "flops_per_step", "bytes_per_step", "roofline_bound"}
RATES = ("train_ips_per_step_dispatch", "render_fps", "flame_fit_iters_per_sec", "mfu",
         "mfu_f32", "roofline_bound")


def run_bench(*flags):
    # no card is visible to the bench, also on a machine that has one
    env = dict(os.environ, OMP_NUM_THREADS="1", CUDA_VISIBLE_DEVICES="",
               PYTHONPATH=f"{ROOT}{os.pathsep}{os.environ.get('PYTHONPATH', '')}")
    res = subprocess.run([sys.executable, "-m", "omfs4d_torch.scripts.bench", *flags],
                         cwd=ROOT, env=env, capture_output=True, text=True, timeout=400)
    lines = res.stdout.strip().splitlines()
    assert len(lines) == 1, res.stdout[-3000:] + res.stderr[-3000:]
    return res.returncode, json.loads(lines[0]), res.stderr


def test_cpu_run_prints_the_line_with_no_rate():
    rc, out, err = run_bench("--cpu")
    assert rc == 0, err[-4000:]
    assert set(out) == LINE_KEYS
    ex = out["extra"]
    assert KEPT_EXTRA | {"kernels", "device", "power_limit_w"} <= set(ex)
    assert not {"pallas", "tpu_unreachable"} & set(ex)
    assert out["metric"] == "3dgs_train_iters_per_sec@128" and out["unit"] == "iter/s"
    assert ex["backend"] == "cpu" and ex["device"] is None and ex["power_limit_w"] is None
    assert out["value"] is None and out["vs_baseline"] is None
    assert all(ex[k] is None for k in RATES)
    assert ex["floors"] is None and ex["device_per_call"] is None
    assert ex["kernels"] == {"composite_fwd": 0, "composite_bwd": 0}
    assert ex["steps"] == {"train_step": 6, "train": 10, "render_frame": 6, "flame_fit": 75}
    assert set(ex["final_loss"]) == {"train_step", "train", "flame_fit"}
    assert all(np.isfinite(v) for v in ex["final_loss"].values())
    assert ex["flops_per_step"] > 0 and ex["bytes_per_step"] > 0
    assert "flops by op family" in err


def test_without_a_card_the_line_carries_the_error():
    rc, out, _ = run_bench()
    assert rc == 1
    assert out["value"] is None and out["vs_baseline"] is None
    assert "no CUDA device" in out["error"]


def test_a_forced_failure_still_prints_a_valid_line():
    rc, out, err = run_bench("--cpu", "--size", "-1")
    assert rc == 1, err[-3000:]
    assert set(out) == LINE_KEYS | {"error"}
    assert out["value"] is None and out["error"].startswith("setup:")
    assert out["metric"] == "3dgs_train_iters_per_sec@-1"


# ── the dispatch counter ─────────────────────────────────────


def test_counter_counts_a_matmul_by_its_formula():
    m, k, n = 7, 5, 3
    a, b = torch.randn(m, k), torch.randn(k, n)
    with bench.DispatchCounter() as c:
        a @ b
    assert c.flops == {"mm": 2 * m * n * k}
    assert c.bytes == {"mm": 4 * (m * k + k * n + m * n)}
    a, b = torch.randn(2, m, k), torch.randn(2, k, n)
    with bench.DispatchCounter() as c:
        torch.bmm(a, b)
    assert c.flops == {"bmm": 2 * 2 * m * n * k}


def test_counter_counts_an_elementwise_chain_by_its_outputs():
    x = torch.randn(4, 6)
    with bench.DispatchCounter() as c:
        y = (x * 2.0 + 1.0).exp()
        y.view(24).sum()                   # a view counts nothing; the sum one element
    assert c.flops == {"mul": 24, "add": 24, "exp": 24, "sum": 1}
    # each op reads its input and writes its output; the view moves nothing
    assert c.bytes == {"mul": 2 * 96, "add": 2 * 96, "exp": 2 * 96, "sum": 96 + 4}
    assert "view" not in c.flops and c.backward_flops == 0


def test_counter_counts_data_movement_as_bytes_only():
    x = torch.randn(4, 6)
    idx = torch.tensor([2, 0])
    with bench.DispatchCounter() as c:
        torch.cat([x, x])
        torch.nn.functional.pad(x, (1, 1))
        x.clone()
        x.flip(0)
        torch.zeros_like(x)
        x.index_select(0, idx)
        torch.zeros(4, 6).scatter_(0, torch.tensor([[2, 0, 1, 3, 2, 0]]), 1.0, reduce="add")
    assert c.flops["scatter"] == 24                # with a reduction: one per output
    assert all(v == 0 for k, v in c.flops.items() if k != "scatter")
    assert {"cat", "constant_pad_nd", "clone", "flip", "zeros_like", "index_select"} <= set(c.flops)
    assert c.bytes["cat"] == 2 * 96 + 192 and c.bytes["constant_pad_nd"] == 96 + 4 * 8 * 4
    assert c.bytes["clone"] == 2 * 96 and c.bytes["index_select"] == 96 + 2 * 8 + 2 * 24


def test_k1_k2_work_counts_flops_apart_from_instructions():
    """`composite_work`'s flops (an FMA 2) and its FP32 instructions (an FMA
    1, for the bound) on the same pairs."""
    packed, width, height, grid_w = packed_table(0)
    reached, live = bench.pair_counts(packed, width, height, grid_w)

    class Binning:
        tile_counts = torch.full((packed.shape[0],), packed.shape[2])
        tile_lists = torch.zeros(packed.shape[0] * packed.shape[2], dtype=torch.int32)

    uv = torch.zeros(10, 2)
    work = bench.composite_work((uv, None, None, None, Binning, width, height), packed)
    assert (work["reached"], work["live"]) == (reached, live)
    assert work["flops"] == {
        "composite_fwd": 13 * reached + 9 * live,
        "composite_bwd": 13 * reached + (9 + 40 + 9) * live}
    assert work["composite_fwd"][0] == 16 * reached + 6 * live
    assert work["composite_bwd"][0] == 16 * reached + (6 + 35 + 9) * live


def test_counter_sees_the_backward():
    w = torch.randn(5, 4, requires_grad=True)
    x = torch.randn(3, 5)
    with bench.DispatchCounter() as c:
        (x @ w).sum().backward()
    assert c.backward_flops > 0 and c.total_flops > c.backward_flops
    # the backward's mm (x^T @ dy: 2 * 5 * 4 * 3) is among its flops
    assert c.backward_flops >= 2 * 5 * 4 * 3
    assert w.grad is not None


# ── K1's and K2's work on a packed table ─────────────────────


def packed_table(seed=0, T=6, K=12, grid_w=3):
    """A (T, 9, K) table over a (3 x 2)-tile image cut to 40 x 27 pixels:
    random entries, padding (opacity 0) past each count, a NaN entry, an
    indefinite conic and an entry below the 1/255 opacity."""
    rng = np.random.default_rng(seed)
    t = np.zeros((T, 9, K), np.float32)
    for i in range(T):
        n = rng.integers(3, K)
        tx, ty = (i % grid_w) * 16, (i // grid_w) * 16
        t[i, 0, :n] = tx + rng.uniform(-8, 24, n)
        t[i, 1, :n] = ty + rng.uniform(-8, 24, n)
        a, c = rng.uniform(0.01, 0.5, n), rng.uniform(0.01, 0.5, n)
        t[i, 2, :n], t[i, 4, :n] = a, c
        t[i, 3, :n] = rng.uniform(-0.9, 0.9, n) * np.sqrt(a * c)
        t[i, 5:8, :n] = rng.uniform(0, 1, (3, n))
        t[i, 8, :n] = rng.uniform(0.0, 1.0, n)
    t[1, 0, 0] = np.nan
    t[2, 3, 1] = 5.0                       # b^2 > a c: indefinite
    t[3, 8, 2] = 1e-3                      # below 1/255
    return torch.from_numpy(t), 40, 27, grid_w


def brute_pairs(packed, width, height, grid_w, tile=16):
    """pair_counts' definition in NumPy f32, one tile, slot and pixel at a time
    (K1's alpha, and its `reach_of` in its order of tests)."""
    from omfs4d_torch.render.rasterize import ALPHA_CAP, ALPHA_CUTOFF

    f = np.float32
    tab = packed.numpy()
    reached = live = 0
    for t in range(tab.shape[0]):
        for k in range(tab.shape[2]):
            ux, uy, ca, cb, cc, _, _, _, o = (f(v) for v in tab[t, :, k])
            finite = np.isfinite(tab[t, :, k].sum(dtype=np.float32))
            det = f(ca * cc - cb * cb)
            wide = not (ca > 0 and cc > 0 and det > f(f(1e-3) * ca) * cc)
            with np.errstate(all="ignore"):
                level = f(f(f(2.04) * np.log(f(255.0) * o)) + f(1e-3))
                rx = f(np.sqrt(f(level * cc) / det) + f(1.0))
                ry = f(np.sqrt(f(level * ca) / det) + f(1.0))
                for p in range(tile * tile):
                    px = (t % grid_w) * tile + p % tile
                    py = (t // grid_w) * tile + p // tile
                    if px >= width or py >= height:
                        continue
                    dx, dy = f(f(px + 0.5) - ux), f(f(py + 0.5) - uy)
                    power = min(f(f(f(-0.5) * f(f(ca * dx * dx) + f(cc * dy * dy)))
                                  - f(cb * dx * dy)), f(0.0))
                    a = min(f(o * np.exp(power)), f(ALPHA_CAP))
                    live += bool(a >= ALPHA_CUTOFF)
                    in_box = abs(dx) <= rx and abs(dy) <= ry
                    reached += bool(not finite or (o >= ALPHA_CUTOFF and (wide or in_box)))
    return reached, live


@pytest.mark.parametrize("seed", [0, 1])
def test_pair_counts_equal_a_count_in_numpy(seed):
    packed, width, height, grid_w = packed_table(seed)
    got = bench.pair_counts(packed, width, height, grid_w)
    assert got == brute_pairs(packed, width, height, grid_w)
    assert 0 < got[1] < got[0] < packed.shape[0] * packed.shape[2] * 256


def test_bound_is_the_larger_of_operations_and_bytes():
    assert bench.bound_us(bench.FP32_INSTR_PER_S * 1e-6, 0) == (1.0, "operations")
    assert bench.bound_us(0, bench.HBM_BYTES_PER_S * 2e-6) == (2.0, "bytes")


def test_chip_smoke_imports_the_moved_helpers_back():
    sys.path.insert(0, str(ROOT))
    try:
        import chip_smoke
    finally:
        sys.path.remove(str(ROOT))
    for name in ("bench_avatar", "grad_inputs", "pair_counts", "bound_us", "composite_bounds",
                 "profiled_kernels", "flame_fit"):
        assert getattr(chip_smoke, name) is getattr(bench, name), name
    assert callable(chip_smoke.training_data)
