"""Build host C++ with g++ and load it with ctypes: native/meshkit.cpp, the
QEM decimator (`qem_decimate`), and the libraries of other modules (the
H.264 decoder of `omfs4d_torch.io.h264`) through `build`.

The port's counterpart of `omfs4d.native`.  The source is compiled unedited
with `g++ -O3 -shared -fPIC`, at first use, into `_build/` beside this file
(git-ignored), never into `native/`; the library's name carries a hash of the
source and the flags, so an edited source is rebuilt and a built one is
reused.  With no g++ on PATH or a failed compile it raises with the
compiler's message: there is nothing to fall back to (the reference warns and
decimates by grid clustering instead, which gives another mesh).

Only `qem_decimate` is used: the Laplacian smoothing runs on the device
(`omfs4d_torch.ops.mesh.smooth_vertices`, meshkit's arithmetic bit for bit).
QEM is a serial heap over collapse costs, so it stays on the host.
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

import numpy as np

SOURCE = Path(__file__).resolve().parent.parent / "native" / "meshkit.cpp"
BUILD_DIR = Path(__file__).resolve().parent / "_build"
GXX_FLAGS = ("-O3", "-shared", "-fPIC")


def built_path(source: Path, name: str, flags: tuple[str, ...],
               headers: dict[str, str] | None = None) -> Path:
    """Where the library `name` built from `source` with `flags` (and the
    generated `headers`, by file name) lives: `BUILD_DIR/lib<name>_<hash>.so`,
    the hash over the flags, the source and the headers."""
    h = hashlib.sha256(" ".join(flags).encode())
    h.update(source.read_bytes())
    for header, text in sorted((headers or {}).items()):
        h.update(header.encode() + b"\0" + text.encode())
    return BUILD_DIR / f"lib{name}_{h.hexdigest()[:16]}.so"


def build(source: Path, name: str, flags: tuple[str, ...], what: str,
          headers: dict[str, str] | None = None) -> Path:
    """Compile `source` with g++ into `built_path(...)` unless it is there,
    the generated `headers` written beside it for the compile; `what` names
    the library in the errors.  Raises RuntimeError with no g++ on PATH or
    with g++'s message when the compile fails."""
    lib_path = built_path(source, name, flags, headers)
    if not lib_path.exists():
        gxx = shutil.which("g++")
        if gxx is None:
            raise RuntimeError(f"no g++ on PATH: {what} cannot be built")
        BUILD_DIR.mkdir(parents=True, exist_ok=True)
        with tempfile.TemporaryDirectory(dir=BUILD_DIR) as tmp_dir:
            tmp = Path(tmp_dir) / lib_path.name
            for header, text in (headers or {}).items():
                (Path(tmp_dir) / header).write_text(text)
            cmd = [gxx, *flags, "-I", tmp_dir, "-o", str(tmp), str(source)]
            res = subprocess.run(cmd, capture_output=True, text=True)
            if res.returncode != 0:
                raise RuntimeError(f"g++ failed (exit {res.returncode}):\n{' '.join(cmd)}\n"
                                   f"{res.stderr[-6000:]}")
            os.replace(tmp, lib_path)      # atomic: concurrent builds agree
    return lib_path


def library_path() -> Path:
    """Where meshkit for the current source and flags lives."""
    return built_path(SOURCE, "meshkit", GXX_FLAGS)


@functools.cache
def load_library() -> ctypes.CDLL:
    """Build (if needed) and load meshkit."""
    lib_path = build(SOURCE, "meshkit", GXX_FLAGS, "native/meshkit.cpp (the QEM decimator)")
    lib = ctypes.CDLL(str(lib_path))
    lib.qem_decimate.restype = ctypes.c_int64
    lib.qem_decimate.argtypes = [
        ctypes.POINTER(ctypes.c_float), ctypes.c_int64,
        ctypes.POINTER(ctypes.c_int32), ctypes.c_int64, ctypes.c_int64,
        ctypes.POINTER(ctypes.c_float), ctypes.POINTER(ctypes.c_int64),
        ctypes.POINTER(ctypes.c_int32),
    ]
    return lib


def qem_decimate(verts: np.ndarray, faces: np.ndarray,
                 target_faces: int) -> tuple[np.ndarray, np.ndarray]:
    """QEM edge collapse of a host mesh to about `target_faces` faces:
    (vertices float32, faces int32), not yet cleaned."""
    lib = load_library()
    v = np.ascontiguousarray(verts, dtype=np.float32)
    f = np.ascontiguousarray(faces, dtype=np.int32)
    if v.ndim != 2 or v.shape[1] != 3 or f.ndim != 2 or f.shape[1] != 3:
        raise ValueError(f"qem_decimate: vertices {v.shape} and faces {f.shape} must be (n, 3)")
    if f.size and (f.min() < 0 or f.max() >= len(v)):
        raise ValueError("qem_decimate: a face indexes no vertex")
    out_v = np.zeros_like(v)
    out_f = np.zeros_like(f)
    out_nv = ctypes.c_int64(0)
    nf = lib.qem_decimate(
        v.ctypes.data_as(ctypes.POINTER(ctypes.c_float)), v.shape[0],
        f.ctypes.data_as(ctypes.POINTER(ctypes.c_int32)), f.shape[0],
        int(target_faces),
        out_v.ctypes.data_as(ctypes.POINTER(ctypes.c_float)),
        ctypes.byref(out_nv),
        out_f.ctypes.data_as(ctypes.POINTER(ctypes.c_int32)),
    )
    return out_v[: out_nv.value].copy(), out_f[:nf].copy()
