"""Package rules of the port, checked on the CPU: it imports neither jax,
omfs4d nor cv2, and a CUDA tensor never falls back to the plain composite."""

import pkgutil
import subprocess
import sys
from pathlib import Path

import pytest
import torch

import omfs4d_torch
from omfs4d_torch import _build
from omfs4d_torch.render import composite as tc
from omfs4d_torch.render.rasterize import TileBinning

ROOT = Path(__file__).resolve().parents[1]


def port_modules():
    return sorted(m.name for m in pkgutil.walk_packages(omfs4d_torch.__path__,
                                                        prefix="omfs4d_torch."))


def test_port_imports_no_jax_omfs4d_or_cv2():
    mods = port_modules()
    assert "omfs4d_torch.render.composite" in mods and len(mods) > 20
    code = (
        "import importlib, sys, torch\n"
        f"for m in {mods!r}:\n"
        "    importlib.import_module(m)\n"
        "bad = sorted(m for m in sys.modules if m.split('.')[0] in ('jax', 'jaxlib', 'omfs4d', 'cv2'))\n"
        "assert not bad, bad\n"
        "assert not torch.backends.cuda.matmul.allow_tf32 and not torch.backends.cudnn.allow_tf32\n"
    )
    res = subprocess.run([sys.executable, "-c", code], cwd=ROOT, capture_output=True,
                         text=True, timeout=120)
    assert res.returncode == 0, res.stderr


def small_inputs(requires_grad=False):
    uv = torch.zeros(4, 2, requires_grad=requires_grad)
    binning = TileBinning(torch.zeros(1, 8, dtype=torch.int32),
                          torch.ones(1, dtype=torch.int32), *[torch.zeros((), dtype=torch.int32)] * 3)
    return uv, torch.zeros(4, 3), torch.zeros(4, 3), torch.zeros(4), binning


@pytest.fixture
def cuda_typed(monkeypatch, tmp_path):
    """Make the wrapper see CUDA tensors, with no nvcc and an empty build
    directory: the call must raise and build nothing."""
    monkeypatch.setattr(tc, "_device_type", lambda t: "cuda")
    monkeypatch.setattr(_build, "find_nvcc", lambda: None)
    monkeypatch.setattr(_build, "BUILD_DIR", tmp_path / "build")
    _build.load_library.cache_clear()
    tc._kernel.cache_clear()
    yield tmp_path / "build"
    _build.load_library.cache_clear()
    tc._kernel.cache_clear()


def test_composite_on_cuda_raises_without_a_kernel(cuda_typed):
    before = tc.composite.launches
    with pytest.raises(RuntimeError, match="nvcc"):
        tc.composite(*small_inputs(), 16, 16)
    assert tc.composite.launches == before
    assert not cuda_typed.exists()


def test_composite_on_cuda_refuses_what_the_kernel_does_not_take(cuda_typed):
    uv, conic, colors, opacity, b = small_inputs()
    bad_calls = {
        "requires grad": (small_inputs(requires_grad=True), {}),
        "float64": ((uv.double(), conic, colors, opacity, b), {}),
        "int64 lists": ((uv, conic, colors, opacity,
                         b._replace(tile_lists=b.tile_lists.long())), {}),
        "shape": ((uv, conic[:3], colors, opacity, b), {}),
        "contiguity": ((torch.zeros(2, 4).T, conic, colors, opacity, b), {}),
        "tile range": ((uv, conic, colors, opacity, b), {"tile_base": 1}),
    }
    for what, (args, kw) in bad_calls.items():
        with pytest.raises(ValueError):
            tc.composite(*args, 16, 16, **kw)
    assert not cuda_typed.exists()


def test_library_path_tracks_sources():
    p = _build.library_path()
    assert p.parent == _build.BUILD_DIR and p.suffix == ".so"
    assert p == _build.library_path()
    assert [s.name for s in _build._sources()] == ["composite_fwd.cu"]
