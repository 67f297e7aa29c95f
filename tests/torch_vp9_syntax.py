"""A random legal-syntax VP9 profile 0 writer with its own boolean encoder,
for holding the port's decoder (`omfs4d_torch/io/vp9dec.cpp`) to cv2's
FFmpeg on what cv2's libvpx does not write.

The writer is `tests/torch_vp9_writer.cpp`, built by g++ at first use (into
`omfs4d_torch/_build/`, as the port's own host libraries are): it drives the
decoder's parser with a source of syntax that draws each element at random
within what the specification allows and codes it with the probability
the parser reads it with, through every delta update, saved context and
backward adaptation.  cv2 is the judge: where the port's parser and FFmpeg
disagree, their frames differ.

`write_stream(seed, plan, **options)` gives a `Stream`: the frames in
decoding order, each with its kind (key, inter, intra-only, or a
show_existing_frame), whether it is shown, and the writer's counts of what
it drew (`stats`).  A plan is a string of frame kinds, one letter a frame:
`K` key, `P` inter shown, `h` inter hidden (an alt-ref), `i` intra-only
(always hidden), `e` show_existing_frame of the last hidden frame's slot,
`E` that of a random slot.  `OPTIONS` names what the writer draws and how
often (per mille where it is a rate); it draws what libvpx at cv2's
settings never writes: error-resilient frames, every `reset_frame_context`,
`refresh_frame_context` 0 and 1, `frame_parallel_decoding_mode` 0 (backward
adaptation) and 1, all four `frame_context_idx`, lossless frames, every
`tx_mode`, every filter and switchable filters, high precision on and off,
vectors of every class, compound prediction and `reference_select`,
segmentation with temporal update and all four features, loop filter
levels, sharpness and deltas, tile columns and rows, delta updates of every
probability, intra-only frames, hidden frames and show_existing_frame, odd
sizes, the colour bits.

`packets(stream, superframes=True)` groups the frames as libvpx does (each
hidden frame in a superframe with the frame after it); `write_webm` /
`write_avi` mux them (`tests/torch_mkv_mux.py`), `make_file` by a path's
suffix from the arguments `tests/data/vp9/manifest.json` keeps.
"""

from __future__ import annotations

import ctypes
import functools
import importlib.util
from pathlib import Path

_HERE = Path(__file__).resolve().parent
_SOURCE = _HERE / "torch_vp9_writer.cpp"
_DECODER = _HERE.parent / "omfs4d_torch" / "io" / "vp9dec.cpp"

# the writer's options in its order, with their defaults
OPTIONS = {
    "width": 64, "height": 48, "seed": 0, "error_res": 100, "refresh_ctx": 700,
    "parallel": 400, "ctx_idx": 1, "reset_ctx": 1, "q_min": 1, "q_max": 255, "delta_q": 300,
    "lossless": 80, "lf_min": 0, "lf_max": 63, "lf_delta": 500, "sharpness": 7, "seg": 0,
    "seg_temporal": 500, "seg_data": 600, "seg_skip_ref": 1, "tile_cols": -1, "tile_rows": 2,
    "switchable": 500, "hp": 500, "compound": 1, "updates": 30, "sub8x8": 1, "split": 700,
    "skip": 250, "density": 700, "far_mv": 100, "tx_modes": 31, "colour_space": 0,
    "full_range": 0, "intra": 200, "budget": 3000, "big_tokens": 0, "found_ref": 800,
}
KINDS = {"K": (0, 1), "P": (1, 1), "h": (1, 0), "i": (2, 0), "e": (3, 1), "E": (3, 1)}
# the writer's own counts, from index 200 of `stats` (torch_vp9_writer.cpp's S_*)
_STAT_NAMES = ["update", "zero", "cat1", "cat2", "cat3", "cat4", "cat5", "cat6", "mv_class0",
               "mv_class", "mv_class10", "lossless", "adapt", "parallel_save", "error_res",
               "intra_only", "hidden", "show_existing", "tile_cols_log2", "tile_rows_log2",
               "seg_temporal", "seg_q", "seg_lf", "seg_ref", "seg_skip", "comp_select",
               "comp_only", "switchable", "tx_mode_0", "tx_mode_1", "tx_mode_2", "tx_mode_3",
               "tx_mode_4", "ctx_idx_0", "ctx_idx_1", "ctx_idx_2", "ctx_idx_3", "reset_0",
               "reset_1", "reset_2", "reset_3", "filter_0", "filter_1", "filter_2",
               "filter_3", "hp", "lf_delta", "sharpness", "seg_no_map_update"]


@functools.cache
def _library() -> ctypes.CDLL:
    from omfs4d_torch import native
    from omfs4d_torch.io import vp9_tables

    path = native.build(_SOURCE, "vp9writer", ("-std=c++17", "-O2", "-shared", "-fPIC"),
                        "tests/torch_vp9_writer.cpp (the VP9 test writer)",
                        headers={"vp9_tables.h": vp9_tables.cpp_header(),
                                 "vp9dec.cpp": _DECODER.read_text()})
    lib = ctypes.CDLL(str(path))
    lib.vp9w_new.restype = ctypes.c_void_p
    lib.vp9w_new.argtypes = [ctypes.POINTER(ctypes.c_int32), ctypes.c_int]
    lib.vp9w_free.argtypes = [ctypes.c_void_p]
    lib.vp9w_frame.restype = ctypes.c_int64
    lib.vp9w_frame.argtypes = [ctypes.c_void_p] + [ctypes.c_int] * 5
    lib.vp9w_take.argtypes = [ctypes.c_void_p, ctypes.c_void_p]
    lib.vp9w_error.restype = ctypes.c_char_p
    lib.vp9w_error.argtypes = [ctypes.c_void_p]
    lib.vp9w_stats.argtypes = [ctypes.c_void_p, ctypes.POINTER(ctypes.c_int64)]
    return lib


class Stream:
    """A written stream: its size, frames in decoding order, their plan
    letters, and the writer's counts of what it drew."""

    def __init__(self, width: int, height: int):
        self.width, self.height = width, height
        self.frames: list[bytes] = []
        self.kinds: list[str] = []
        self.stats: dict = {}

    @property
    def shown(self) -> int:
        return sum(k in "KPeE" for k in self.kinds)


def write_stream(seed: int, plan: str = "KPPPPP", **options) -> Stream:
    """The frames of `plan` (see the module's doc) drawn from `seed` with
    `options` (see `OPTIONS`)."""
    opts = dict(OPTIONS, seed=seed, **options)
    unknown = set(opts) - set(OPTIONS)
    if unknown:
        raise ValueError(f"unknown options {sorted(unknown)}")
    lib = _library()
    values = (ctypes.c_int32 * len(OPTIONS))(*[int(opts[k]) for k in OPTIONS])
    h = lib.vp9w_new(values, len(OPTIONS))
    try:
        out = Stream(opts["width"], opts["height"])
        for letter in plan:
            kind, show = KINDS[letter]
            slot = seed % 8 if letter == "E" else -1
            n = lib.vp9w_frame(h, kind, show, slot, -1, -1)
            if n < 0:
                raise RuntimeError(f"seed {seed}: {lib.vp9w_error(h).decode()}")
            buf = ctypes.create_string_buffer(int(n))
            lib.vp9w_take(h, buf)
            out.frames.append(buf.raw)
            out.kinds.append(letter)
        counts = (ctypes.c_int64 * 256)()
        lib.vp9w_stats(h, counts)
        out.stats = {f"kind_{i}": counts[i] for i in range(200) if counts[i]}
        out.stats.update({name: counts[200 + i] for i, name in enumerate(_STAT_NAMES)})
        return out
    finally:
        lib.vp9w_free(h)


def superframe(frames: list[bytes]) -> bytes:
    """Frames joined with a superframe index, as libvpx writes it."""
    if len(frames) == 1:
        return frames[0]
    size = max(len(f) for f in frames)
    mag = 0 if size < 1 << 8 else 1 if size < 1 << 16 else 2 if size < 1 << 24 else 3
    marker = 0xC0 | mag << 3 | (len(frames) - 1)
    index = bytes([marker]) + b"".join(len(f).to_bytes(mag + 1, "little") for f in frames)
    return b"".join(frames) + index + bytes([marker])


def packets(stream: Stream, superframes: bool = True) -> tuple[list[bytes], list[bool]]:
    """The stream's packets and which start at a key frame: each hidden
    frame in one packet with the frames after it up to a shown one (a
    superframe), or, without `superframes`, each frame a packet."""
    out, keys, pending = [], [], []
    for frame, kind in zip(stream.frames, stream.kinds):
        pending.append(frame)
        if not superframes or kind in "KPeE":
            out.append(superframe(pending) if superframes else frame)
            keys.append(kind == "K" and len(pending) == 1)
            pending = []
    if pending:
        out.append(superframe(pending))
        keys.append(False)
    return out, keys


@functools.cache
def _mkv_mux():
    """tests/torch_mkv_mux.py, loaded by its path: a package named `tests`
    installed elsewhere would win an import by name."""
    spec = importlib.util.spec_from_file_location("torch_mkv_mux", _HERE / "torch_mkv_mux.py")
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module


def write_webm(path, stream: Stream, fps: float = 30.0, doc_type: str = "webm",
               times_ms: list[int] | None = None, superframes: bool = True, **options) -> Path:
    """A WebM (or, with doc_type "matroska", an MKV) of one VP9 track, as
    FFmpeg's muxer writes it by default (`DefaultDuration` and `Duration`
    from fps; `times_ms` and options as `torch_mkv_mux.write_mkv` takes
    them)."""
    pk, keys = packets(stream, superframes)
    n = len(pk)
    times = times_ms if times_ms is not None else [round(i * 1000 / fps) for i in range(n)]
    options.setdefault("default_duration", round(1e9 / fps))
    options.setdefault("duration_ms", n * 1000 / fps)
    return _mkv_mux().write_mkv(path, pk, keys, times, codec_id="V_VP9", width=stream.width,
                                height=stream.height, doc_type=doc_type, **options)


def write_avi(path, stream: Stream, fps: int = 30, superframes: bool = True) -> Path:
    """An AVI of one `VP90` stream, a packet a chunk."""
    pk, keys = packets(stream, superframes)
    return _mkv_mux().write_avi(path, pk, keys, stream.width, stream.height, b"VP90", fps)


def make_file(path, seed: int, plan: str, options: dict, mux: dict) -> Path:
    """`write_stream(seed, plan, **options)` muxed by the suffix of `path`:
    AVI, Matroska (.mkv) or WebM (`mux`, `write_webm`'s options)."""
    stream = write_stream(seed, plan, **options)
    path = Path(path)
    if path.suffix == ".avi":
        return write_avi(path, stream, **mux)
    return write_webm(path, stream, doc_type="matroska" if path.suffix == ".mkv" else "webm",
                      **mux)
