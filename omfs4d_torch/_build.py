"""Build the hand-written CUDA kernels in `csrc/` and load them with ctypes.

Each `csrc/*.cu` file is compiled by its own `nvcc` for Hopper (sm_90a), all
at once, and the objects are linked into one shared library with a plain C
interface, at first use, into `_build/` beside this file (git-ignored).  The
library's name carries a hash of the sources and flags, so an edited source
is rebuilt and a built one is reused.  No PyTorch headers are involved, which
keeps a build to seconds.

Wrappers pass pointers (`tensor.data_ptr()`) and the stream
(`torch.cuda.current_stream().cuda_stream`) as `ctypes.c_void_p`, and ints as
`ctypes.c_int`; each wrapper declares the argtypes of its own function.

With no `nvcc` (PATH, `$CUDA_HOME/bin`, `/usr/local/cuda/bin`) or a failed
compile, `load_library` raises: there is nothing to fall back to.
"""

from __future__ import annotations

import ctypes
import functools
import hashlib
import os
import shutil
import subprocess
import tempfile
from pathlib import Path

CSRC_DIR = Path(__file__).resolve().parent / "csrc"
BUILD_DIR = Path(__file__).resolve().parent / "_build"
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
              "-Xcompiler", "-fPIC", "-Xptxas", "-v")


def find_nvcc() -> str | None:
    exe = shutil.which("nvcc")
    if exe:
        return exe
    for root in (os.environ.get("CUDA_HOME"), "/usr/local/cuda"):
        if root and (Path(root) / "bin" / "nvcc").is_file():
            return str(Path(root) / "bin" / "nvcc")
    return None


def _sources() -> list[Path]:
    return sorted(p for p in CSRC_DIR.iterdir() if p.suffix in (".cu", ".cuh"))


def library_path() -> Path:
    """Where the library for the current sources and flags lives."""
    h = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for p in _sources():
        h.update(p.name.encode())
        h.update(p.read_bytes())
    return BUILD_DIR / f"libomfs4d_kernels_{h.hexdigest()[:16]}.so"


def build_log() -> str:
    """nvcc's output (ptxas register and shared-memory report) of the build
    that made the current library, or '' when it was not built."""
    log = library_path().with_suffix(".log")
    return log.read_text() if log.exists() else ""


def _rank_and_world() -> tuple[int, int]:
    import torch.distributed as dist

    if dist.is_available() and dist.is_initialized():
        return dist.get_rank(), dist.get_world_size()
    return 0, 1


@functools.cache
def load_library() -> ctypes.CDLL:
    """Build (if needed) and load the kernel library.  Under a process group
    every rank must call it: rank 0 builds while the others wait at a
    barrier, so that N ranks run nvcc once."""
    lib_path = library_path()
    rank, n = _rank_and_world()
    try:
        if rank == 0 and not lib_path.exists():
            _build_library(lib_path)
    finally:
        if n > 1:
            import torch.distributed as dist

            dist.barrier()
    if not lib_path.exists():
        if n > 1:
            raise RuntimeError(f"rank 0 did not build {lib_path.name}; see its error")
        _build_library(lib_path)
    return ctypes.CDLL(str(lib_path))


def _build_library(lib_path: Path) -> None:
    nvcc = find_nvcc()
    if nvcc is None:
        raise RuntimeError(
            "no nvcc found (PATH, $CUDA_HOME/bin, /usr/local/cuda/bin): "
            "the CUDA kernels in omfs4d_torch/csrc cannot be built")
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    with tempfile.TemporaryDirectory(dir=BUILD_DIR) as tmp_dir:
        objs, log = _compile_all(nvcc, Path(tmp_dir))
        tmp = Path(tmp_dir) / lib_path.name
        _run([nvcc, "-shared", "-o", str(tmp), *objs])
        lib_path.with_suffix(".log").write_text(log)
        os.replace(tmp, lib_path)      # atomic: concurrent builds agree


def _run(cmd: list[str]) -> None:
    res = subprocess.run(cmd, capture_output=True, text=True)
    if res.returncode != 0:
        raise RuntimeError(f"nvcc failed (exit {res.returncode}):\n"
                           f"{' '.join(cmd)}\n{res.stderr[-6000:]}")


def _compile_all(nvcc: str, out_dir: Path) -> tuple[list[str], str]:
    """One nvcc per source, all started together; waits for every one of
    them before it reports a failure.  Returns the objects and the joined
    output (the ptxas reports)."""
    srcs = [p for p in _sources() if p.suffix == ".cu"]
    objs = [str(out_dir / f"{src.stem}.o") for src in srcs]
    cmds = [[nvcc, *NVCC_FLAGS, "-c", "-o", obj, str(src)] for src, obj in zip(srcs, objs)]
    procs = [subprocess.Popen(cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
             for cmd in cmds]
    outputs = [proc.communicate()[0] for proc in procs]
    for cmd, proc, out in zip(cmds, procs, outputs):
        if proc.returncode != 0:
            raise RuntimeError(f"nvcc failed (exit {proc.returncode}):\n"
                               f"{' '.join(cmd)}\n{out[-6000:]}")
    return objs, "".join(outputs)
