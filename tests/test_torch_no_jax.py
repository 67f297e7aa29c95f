"""Package rules of the port, checked on the CPU: it imports neither jax,
optax, omfs4d, cv2 nor PIL (the JPEG codec, the Motion JPEG containers and
the video module, the bench and the soak, the clinical engine, its IO, the app and the meshkit loader included; the
streamlit dashboard is read, not imported, since it exits without
streamlit), and a CUDA tensor never falls back to a plain version:
not the composite's, forward (K1) or backward (K2), not under the tracker's
splat backend, and not the K2 ablation variants' (V)."""

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
from omfs4d_torch.scripts import profile_composite_variants as pcv

ROOT = Path(__file__).resolve().parents[1]


def port_modules():
    return sorted(m.name for m in pkgutil.walk_packages(omfs4d_torch.__path__,
                                                        prefix="omfs4d_torch."))


TRACKING_MODULES = ("omfs4d_torch.core.logging", "omfs4d_torch.render.texture",
                    "omfs4d_torch.render.mesh_raster", "omfs4d_torch.track.fitter",
                    "omfs4d_torch.track.landmarks", "omfs4d_torch.track.preflight",
                    "omfs4d_torch.convert")

FRONT_END_MODULES = ("omfs4d_torch.track.detector", "omfs4d_torch.track.segnet",
                     "omfs4d_torch.track.matting", "omfs4d_torch.track.robustness",
                     "omfs4d_torch.core.artifacts", "omfs4d_torch.core.device",
                     "omfs4d_torch.io.video", "omfs4d_torch.io.mpegts",
                     "omfs4d_torch.pipeline.runner")

BACK_HALF_MODULES = ("omfs4d_torch.eval.reporting", "omfs4d_torch.pipeline.cli",
                     "omfs4d_torch.pipeline.watch", "omfs4d_torch.headrecon.pipeline",
                     "omfs4d_torch.scripts.e2e_case")

CLINICAL_MODULES = ("omfs4d_torch.io.meshio", "omfs4d_torch.io.nifti", "omfs4d_torch.io.dicom",
                    "omfs4d_torch.ops.mesh", "omfs4d_torch.ops.marching",
                    "omfs4d_torch.ops.primitives", "omfs4d_torch.native",
                    "omfs4d_torch.clinical", "omfs4d_torch.clinical.loader",
                    "omfs4d_torch.clinical.surgical", "omfs4d_torch.clinical.measure",
                    "omfs4d_torch.clinical.segmentation", "omfs4d_torch.app",
                    "omfs4d_torch.app.session", "omfs4d_torch.app.viewer",
                    "omfs4d_torch.app.progress")
PARALLEL_MODULES = ("omfs4d_torch.parallel", "omfs4d_torch.parallel.mesh",
                    "omfs4d_torch.parallel.collectives", "omfs4d_torch.parallel.shard",
                    "omfs4d_torch.parallel.sharded_trainer",
                    "omfs4d_torch.parallel.distributed")
# the JPEG codec and the Motion JPEG containers, the bench and the soak, and
# the card's gate script
MEASUREMENT_MODULES = ("omfs4d_torch.io.jpeg", "omfs4d_torch.io.mjpeg",
                       "omfs4d_torch.scripts.bench", "omfs4d_torch.scripts.soak",
                       "chip_smoke")
# a streamlit script: it exits when streamlit is missing, so it is read, not imported
DASHBOARD = "omfs4d_torch.app.dashboard"


def test_port_imports_no_jax_omfs4d_or_cv2():
    mods = port_modules()
    assert "omfs4d_torch.render.composite" in mods and len(mods) > 20
    assert "omfs4d_torch.scripts.profile_composite_variants" in mods
    assert set(TRACKING_MODULES) <= set(mods) and set(FRONT_END_MODULES) <= set(mods)
    assert set(BACK_HALF_MODULES) <= set(mods) and set(CLINICAL_MODULES) <= set(mods)
    assert set(PARALLEL_MODULES) <= set(mods)
    assert set(MEASUREMENT_MODULES[:-1]) <= set(mods)
    assert DASHBOARD in mods
    mods.remove(DASHBOARD)
    code = (
        "import importlib, sys, torch\n"
        f"for m in {mods!r}:\n"
        "    importlib.import_module(m)\n"
        "bad = sorted(m for m in sys.modules if m.split('.')[0] in ('jax', 'jaxlib', 'optax', 'omfs4d', 'cv2', 'PIL'))\n"
        "assert not bad, bad\n"
        "assert not torch.backends.cuda.matmul.allow_tf32 and not torch.backends.cudnn.allow_tf32\n"
    )
    res = subprocess.run([sys.executable, "-c", code], cwd=ROOT, capture_output=True,
                         text=True, timeout=120)
    assert res.returncode == 0, res.stderr


@pytest.mark.parametrize("module", TRACKING_MODULES + FRONT_END_MODULES + BACK_HALF_MODULES
                         + CLINICAL_MODULES + PARALLEL_MODULES + MEASUREMENT_MODULES
                         + (DASHBOARD,))
def test_tracking_module_names_no_jax_package(module):
    """No import statement of a tracking, front-end, pipeline, clinical, app,
    parallel or measurement module (or of chip_smoke.py) names jax, optax or
    the JAX package, lazy ones inside functions included; nor PIL, but in the
    writer of test DICOM slices."""
    import ast
    import importlib.util

    origin = (ROOT / "chip_smoke.py" if module == "chip_smoke"
              else Path(importlib.util.find_spec(module).origin))
    tree = ast.parse(origin.read_text())
    roots = set()
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            roots |= {a.name.split(".")[0] for a in node.names}
        elif isinstance(node, ast.ImportFrom) and node.module:
            roots.add(node.module.split(".")[0])
    assert not roots & {"jax", "jaxlib", "optax", "omfs4d", "cv2"}, roots
    assert "PIL" not in roots or module == "omfs4d_torch.io.dicom", roots


def test_video_io_imports_neither_cv2_nor_pil():
    """The video module and the Motion JPEG containers, imported alone in a
    fresh process, bring in neither cv2 nor PIL (nor JAX): the card's
    machine has none of them."""
    code = (
        "import sys\n"
        "import omfs4d_torch.io.mjpeg, omfs4d_torch.io.video\n"
        "bad = sorted(m for m in sys.modules if m.split('.')[0] in ('cv2', 'PIL', 'jax', 'omfs4d'))\n"
        "assert not bad, bad\n"
    )
    res = subprocess.run([sys.executable, "-c", code], cwd=ROOT, capture_output=True,
                         text=True, timeout=120)
    assert res.returncode == 0, res.stderr


def small_inputs():
    uv = torch.zeros(4, 2)
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
    kernels = (_build.load_library, tc._kernel, tc._bwd_kernel, pcv._kernel)
    for k in kernels:
        k.cache_clear()
    yield tmp_path / "build"
    for k in kernels:
        k.cache_clear()


def test_composite_on_cuda_raises_without_a_kernel(cuda_typed):
    before = tc.composite.launches
    with pytest.raises(RuntimeError, match="nvcc"):
        tc.composite(*small_inputs(), 16, 16)
    assert tc.composite.launches == before
    assert not cuda_typed.exists()


def test_composite_lists_on_cuda_raises_without_a_kernel(cuda_typed):
    """The sharded renders reach K1 through `composite_lists`: a slab with a
    non-zero base and the padded last slab raise for want of the kernel; a
    slab of padding alone launches nothing and is zeros."""
    uv, conic, colors, opacity, b = small_inputs()
    lists = b.tile_lists.expand(2, -1).contiguous()
    counts = torch.tensor([1, 0], dtype=torch.int32)
    before = tc.composite.launches
    for base, num_tiles in ((1, None), (3, 4)):
        with pytest.raises(RuntimeError, match="nvcc"):
            tc.composite_lists(uv, conic, colors, opacity, lists, counts, 16, 2,
                               tile_base=base, num_tiles=num_tiles)
    col, alp = tc.composite_lists(uv, conic, colors, opacity, lists, counts, 16, 2,
                                  tile_base=4, num_tiles=4)
    assert col.shape == (2, 256, 3) and alp.shape == (2, 256)
    assert not col.any() and not alp.any()
    assert tc.composite.launches == before
    assert not cuda_typed.exists()


def test_composite_on_cuda_refuses_what_the_kernel_does_not_take(cuda_typed):
    uv, conic, colors, opacity, b = small_inputs()
    bad_calls = {
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


def test_composite_backward_on_cuda_raises_without_a_kernel(cuda_typed, monkeypatch):
    """The forward is stood in by the plain version so that the graph
    exists; the backward must then raise for want of K2, build nothing and
    count no launch."""
    def plain_fwd(uv, conic, colors, opacity, lists, counts, width, height, tile, tile_base,
                  grid_w, residual=False):
        img, alpha = (t.detach() for t in tc.composite_plain(
            uv, conic, colors, opacity, TileBinning(lists, counts, *[None] * 3), width, height,
            tile, tile_base))
        return img, alpha, (1.0 - alpha, None) if residual else None

    monkeypatch.setattr(tc, "_launch_fwd", plain_fwd)
    uv, conic, colors, opacity, b = small_inputs()
    uv.requires_grad_()
    img, alpha = tc.composite(uv, conic, colors, opacity, b, 16, 16)
    assert img.requires_grad and alpha.requires_grad
    before = tc.composite.backward_launches
    with pytest.raises(RuntimeError, match="nvcc"):
        (img.sum() + alpha.sum()).backward()
    assert tc.composite.backward_launches == before
    assert uv.grad is None
    assert not cuda_typed.exists()


def test_tracker_splat_backend_on_cuda_raises_without_a_kernel(cuda_typed):
    """The tracker reaches K1 and K2 only through `composite`: with tensors
    that claim the card and no kernel, its photometric loss raises; it never
    gives way to the plain version."""
    from omfs4d_torch.core.config import TrackConfig
    from omfs4d_torch.models.assets import synthetic_flame_asset
    from omfs4d_torch.models.flame import FlameModel
    from omfs4d_torch.ops.camera import look_at_camera
    from omfs4d_torch.track.fitter import FlameTracker

    model = FlameModel.from_asset(synthetic_flame_asset(n_vertices=300, seed=0))
    cam = look_at_camera(eye=(0, 0, 0.5), target=(0, 0, 0), fx=50.0, width=32, height=32)
    tracker = FlameTracker(model, TrackConfig(n_shape=5, n_expr=5, texture_res=8), cam,
                           (32, 32), max_per_tile=32, device="cpu")
    p = {k: v.requires_grad_() for k, v in tracker.init_params(1).items()}
    frames = torch.zeros((1, 32, 32, 3), dtype=torch.uint8)
    before = tc.composite.launches
    with pytest.raises(RuntimeError, match="nvcc"):
        tracker._photometric_loss(p, frames, [0])
    assert tc.composite.launches == before
    assert not cuda_typed.exists()


def test_sampler_on_cuda_raises_without_a_kernel(cuda_typed):
    """The synthetic-face sampler reaches K1 only through `composite`: with
    tensors that claim the card and no kernel a batch raises; it never gives
    way to the plain version."""
    from omfs4d_torch.models.assets import synthetic_flame_asset
    from omfs4d_torch.models.flame import FlameModel
    from omfs4d_torch.track.detector import SyntheticFaceSampler

    model = FlameModel.from_asset(synthetic_flame_asset(n_vertices=300, seed=0))
    sampler = SyntheticFaceSampler(model, image_size=32, max_per_tile=32)
    before = tc.composite.launches
    with pytest.raises(RuntimeError, match="nvcc"):
        sampler.batch(torch.Generator().manual_seed(0), 2)
    assert tc.composite.launches == before
    assert not cuda_typed.exists()


def variant_inputs(k=8, tile=16):
    return torch.zeros(2, 9, k), torch.zeros(2, 3, tile * tile), torch.zeros(2, 1, tile * tile)


def test_variant_on_cuda_raises_without_a_kernel(cuda_typed):
    before = dict(pcv.launches)
    for mode in pcv.MODES:
        with pytest.raises(RuntimeError, match="nvcc"):
            pcv.make_variant_kernel(mode)(*variant_inputs())
    assert pcv.launches == before
    assert not cuda_typed.exists()


def test_variant_on_cuda_refuses_what_the_kernel_does_not_take(cuda_typed):
    packed, dcol, dalpha = variant_inputs()
    call = pcv.make_variant_kernel("full_bf16")
    bad_calls = {
        "float64": ((packed.double(), dcol, dalpha), {}),
        "rows": ((packed[:, :8].contiguous(), dcol, dalpha), {}),
        "pixels": ((packed, dcol, dalpha), {"tile": 8}),
        "tiles": ((packed, dcol[:1], dalpha), {}),
        "contiguity": ((packed.transpose(0, 2).contiguous().transpose(0, 2), dcol, dalpha), {}),
        "tile size": ((packed, torch.zeros(2, 3, 33 * 33), torch.zeros(2, 1, 33 * 33)),
                      {"tile": 33}),
    }
    for args, kw in bad_calls.values():
        with pytest.raises(ValueError):
            call(*args, **kw)
    assert not cuda_typed.exists()


def test_library_path_tracks_sources():
    p = _build.library_path()
    assert p.parent == _build.BUILD_DIR and p.suffix == ".so"
    assert p == _build.library_path()
    assert [s.name for s in _build._sources()] == [
        "composite_bwd.cu", "composite_common.cuh", "composite_fwd.cu",
        "composite_variants.cu"]
