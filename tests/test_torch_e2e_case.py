"""`omfs4d_torch.scripts.e2e_case` on the CPU, against the reference's
`scripts/e2e_case.py` on the same case: 64^2, 4 frames, 40 iterations,
`--gt-track` and a `--set` override, both scripts run as a user runs them
(the reference's with its JAX compilation cache kept in the test's
temporary directory, and off).
Held: the port's JSON has the reference's keys (plus the card's name, its
power limit and the overrides) and times the same stages; the `--gt-track`
branch skipped preprocess and track and the `--set` override reached the
trained model; the selfrecon PSNR is finite and within the back half's
0.05 dB of the reference's.  Then the tracking branch (no `--gt-track`) in
process, on the 700-vertex asset with the landmark net's 50 steps cut to 10
of batch 4: it times preprocess and track as the reference does, and its
PSNR is finite."""

import json
import math
import os
import subprocess
import sys
from pathlib import Path

import pytest

from tests.test_torch_track import one_torch_thread  # noqa: F401  (autouse here too)

ROOT = Path(__file__).resolve().parents[1]
CASE = ["--cpu", "--size", "64", "--frames", "4", "--iters", "40", "--gt-track",
        "--set", "render.max_per_tile=64"]
# the keys the port adds to the reference's JSON
PORT_KEYS = {"card_name", "power_limit", "overrides"}
PSNR_TOL_DB = 0.05


# The reference script points JAX's persistent compilation cache at a fixed
# directory of its own; run under this shim it gets one in the test's
# temporary directory, and the cache is off.
REF_SHIM = """
import runpy, sys
import jax
cache, script = sys.argv[1:3]
_update = jax.config.update
def update(name, value):
    if name == "jax_compilation_cache_dir":
        value = cache
    _update(name, value)
jax.config.update = update
_update("jax_enable_compilation_cache", False)
sys.argv = sys.argv[2:]
runpy.run_path(script, run_name="__main__")
"""


def _run(cmd, work: Path):
    env = dict(os.environ, JAX_PLATFORMS="cpu", OMP_NUM_THREADS="1",
               PYTHONPATH=f"{ROOT}{os.pathsep}{os.environ.get('PYTHONPATH', '')}")
    return subprocess.Popen(cmd + CASE + ["--workdir", str(work), "--out",
                                          str(work / "out.json")],
                            cwd=ROOT, env=env, stdout=subprocess.PIPE,
                            stderr=subprocess.STDOUT, text=True)


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    """Both scripts on the same case, side by side: {"port", "ref"} -> (JSON,
    workdir)."""
    tmp = tmp_path_factory.mktemp("e2e")
    procs = {"port": _run([sys.executable, "-m", "omfs4d_torch.scripts.e2e_case"],
                          tmp / "port"),
             "ref": _run([sys.executable, "-c", REF_SHIM, str(tmp / "jax_cache"),
                          str(ROOT / "scripts" / "e2e_case.py")], tmp / "ref")}
    out = {}
    for name, proc in procs.items():
        log, _ = proc.communicate(timeout=400)
        assert proc.returncode == 0, f"{name}:\n{log[-4000:]}"
        out[name] = (json.loads((tmp / name / "out.json").read_text()), tmp / name)
    return out


def test_keys_and_stages_are_the_references(runs):
    port, ref = runs["port"][0], runs["ref"][0]
    assert set(port) == set(ref) | PORT_KEYS
    assert list(port["stages_sec"]) == list(ref["stages_sec"]) == [
        "train_40_iters", "selfrecon_render", "selfrecon_report", "render_surgery", "report"]
    assert port["backend"] == ref["backend"] == "cpu"
    assert port["card_name"] is None and port["power_limit"] is None
    for k in ("resolution", "n_frames", "train_iters", "gt_track"):
        assert port[k] == ref[k], k


def test_gt_track_and_set_branches_ran(runs):
    """--gt-track: no preprocess or track stage, the synthetic case trained
    on; --set render.max_per_tile=64: the trained model's meta carries it."""
    from omfs4d_torch.train.checkpoints import latest_iteration, trained_render_meta

    port, work = runs["port"]
    assert port["gt_track"] is True and port["overrides"] == ["render.max_per_tile=64"]
    assert "preprocess" not in port["stages_sec"] and "track" not in port["stages_sec"]
    model = work / "wd" / "model"
    it = latest_iteration(model)
    assert it == 40
    assert trained_render_meta(model, it)["max_per_tile"] == 64


def test_selfrecon_psnr_is_finite_and_the_references(runs):
    port, ref = runs["port"][0], runs["ref"][0]
    for key in ("selfrecon_psnr", "front_psnr_modified", "front_psnr_unchanged"):
        assert math.isfinite(port[key]), key
        assert abs(port[key] - ref[key]) <= PSNR_TOL_DB, (key, port[key], ref[key])
    for key in ("min", "max"):
        assert abs(port["selfrecon_psnr_stats"][key]
                   - ref["selfrecon_psnr_stats"][key]) <= PSNR_TOL_DB


def test_tracking_branch_times_preprocess_and_track(tmp_path, monkeypatch):
    """Without --gt-track the capture goes through preprocess and track (the
    landmark net trains first: no landmark file lies beside the frames)."""
    from omfs4d_torch.io import synthetic as tsynth
    from omfs4d_torch.models import assets as tassets
    from omfs4d_torch.pipeline import runner as trunner
    from omfs4d_torch.scripts import e2e_case
    from omfs4d_torch.track import detector as tdet

    real_asset, real_train = tassets.synthetic_flame_asset, tdet.train_detector
    real_case = tsynth.make_synthetic_dataset
    trained = []

    def few_steps(*a, **kw):
        trained.append(kw.pop("steps"))
        return real_train(*a, steps=10, batch_size=4, log_every=0, **kw)

    monkeypatch.setattr(trunner, "synthetic_flame_asset",
                        lambda: real_asset(n_vertices=700, seed=0))
    monkeypatch.setattr(tsynth, "make_synthetic_dataset",
                        lambda *a, **kw: real_case(*a, n_vertices=700, **kw))
    monkeypatch.setattr(tdet, "train_detector", few_steps)
    monkeypatch.setenv("OMFS4D_CACHE", str(tmp_path / "cache"))
    out = e2e_case.main(["--cpu", "--size", "64", "--frames", "4", "--iters", "10",
                         "--workdir", str(tmp_path / "work")])
    assert trained == [50]                  # the script's smoke budget, cut here
    assert list(out["stages_sec"]) == ["preprocess", "track", "train_10_iters",
                                       "selfrecon_render", "selfrecon_report",
                                       "render_surgery", "report"]
    assert out["gt_track"] is False and math.isfinite(out["selfrecon_psnr"])
    assert json.loads((tmp_path / "work" / "E2E_TIMING.json").read_text()) == out
