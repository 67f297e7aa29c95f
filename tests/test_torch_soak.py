"""The port's soak (`omfs4d_torch.scripts.soak`) on the CPU: `summarize`
equals the reference's (`scripts/soak.py`, loaded by path) on the same
hand-written `events.jsonl`, and a `--cpu` soak at 32^2 for a few
iterations writes its JSON with the reference's fields and the port's."""

import importlib.util
import json
import time
from pathlib import Path

import pytest

from omfs4d_torch.scripts import soak as tsoak
from tests.test_torch_track import one_torch_thread  # noqa: F401  (autouse here too)

ROOT = Path(__file__).resolve().parents[1]
T0 = 1_700_000_000.0
META = {"soak": True, "resolution": 256, "iters": 400, "n_frames": 60, "backend": "cuda",
        "device": "a card", "power_limit_w": 700.0}


def reference_soak():
    spec = importlib.util.spec_from_file_location("reference_soak", ROOT / "scripts" / "soak.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def tick(it, t, **kw):
    return {"t": t, "event": "train_step", "iter": it, "loss": 0.1, "psnr": 20.0 + it / 100,
            "n_alive": 1000 + it, "rss_mb": 900.0 + it / 10, "capacity": 16384 * (1 + it // 200),
            "ckpt_threads": it // 100 % 2, **kw}


def events(case):
    """Hand-written event streams: a run with log ticks every 10 iterations
    (out of order, with another stage's events, a torn line and a past
    run's ticks before T0), one with a single tick, and none at all."""
    if case == "ticks":
        rows = [tick(it, T0 + 1.0 + it * 0.05) for it in range(10, 401, 10)]
        rows = rows[::2] + rows[1::2]
        rows += [{"t": T0 + 2.0, "event": "stage_end", "stage": "train"},
                 tick(100, T0 - 500.0, psnr=99.0)]
        return [json.dumps(r) for r in rows] + ['{"t": 1, "event": "train_st']
    if case == "one tick":
        return [json.dumps(tick(400, T0 + 30.0))]
    return []


@pytest.mark.parametrize("case", ["ticks", "one tick", "no ticks", "no file"])
def test_summarize_equals_the_reference(case, tmp_path, monkeypatch):
    ref = reference_soak()
    path = tmp_path / "events.jsonl"
    if case != "no file":
        path.write_text("\n".join(events(case)) + "\n")
    monkeypatch.setattr(time, "time", lambda: T0 + 90.0)
    got = tsoak.summarize(path, T0, META)
    assert got == ref.summarize(path, T0, META)
    if case == "ticks":
        assert got["n_log_ticks"] == 40 and got["progress_iter"] == 400
        assert len(got["curve"]) == 20 and got["curve"][0]["it_per_sec"] == 20.0
        assert got["recompiles_total"] is None and got["psnr_best"] == 24.0


def test_cpu_soak_writes_its_json(tmp_path):
    out = tsoak.main(["--cpu", "--size", "32", "--frames", "4", "--iters", "6",
                      "--workdir", str(tmp_path / "soak")])
    written = json.loads((tmp_path / "soak" / "E2E_SOAK_256.json").read_text())
    assert written == out
    assert out["completed"] is True and out["progress_iter"] == 6 and out["n_log_ticks"] >= 1
    assert out["backend"] == "cpu" and out["device"] is None and out["power_limit_w"] is None
    assert out["cuda_max_mem_mb"] is None and out["recompiles_total"] is None
    for key in ("rss_mb_first", "rss_mb_last", "capacity_first", "capacity_last",
                "ckpt_threads_max", "n_alive_last", "psnr_last", "psnr_best", "curve",
                "wall_minutes", "soak", "resolution", "iters", "n_frames"):
        assert key in out, key
    assert out["rss_mb_last"] > 0 and out["capacity_last"] > 0
