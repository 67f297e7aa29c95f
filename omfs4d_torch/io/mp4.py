"""One video track in an MP4 (ISO BMFF) file, read and written with the
standard library: the box code shared by the port's two codecs, Motion JPEG
(`omfs4d_torch.io.mjpeg`) and H.264 (`omfs4d_torch.io.h264`).

Written as FFmpeg's mov muxer lays a file out: `ftyp`, `mdat`, then `moov`
with one video `trak`, all samples in one chunk, the track's timescale the
frame rate's numerator doubled until it reaches 10,000, and an `stss` box
listing the sync samples when not every sample is one.  Read: MP4 and
QuickTime (`qt  ` brand, `wide` atoms, a sound track beside the video, which
is skipped), any `stsc` layout, `stco` or `co64` chunk offsets, `moov` before
or after `mdat`; fps from `mdhd`'s timescale and `stts`, the frame count from
`stsz`; the samples' presentation times (`stts` and the signed `ctts`
offsets); the display rotation of `tkhd`'s matrix and the pictures an edit
list (`elst`) keeps, both as FFmpeg applies them.  The codec is the caller's: the
sample entry goes in as bytes and comes back as a range of the file.
"""

from __future__ import annotations

import math
import struct
from collections.abc import Callable, Iterable
from fractions import Fraction
from pathlib import Path


def boxes(buf, start: int, end: int):
    """(type, body start, box end) of each box between start and end; a
    box's end may run past the end of the file."""
    pos = start
    while pos + 8 <= end:
        size, typ = struct.unpack_from(">I4s", buf, pos)
        body = pos + 8
        if size == 1:
            (size,) = struct.unpack_from(">Q", buf, pos + 8)
            body = pos + 16
        elif size == 0:
            size = end - pos
        if size < body - pos:
            raise ValueError(f"MP4: a box '{typ.decode('latin-1')}' of {size} bytes")
        yield typ, body, pos + size
        pos += size


def child(buf, start, end, typ):
    """(body start, box end) of the first box of type `typ` between start
    and end, or None."""
    for t, body, box_end in boxes(buf, start, end):
        if t == typ:
            return body, box_end
    return None


def full_box(buf, body, fmt):
    """The fields after a full box's version and flags."""
    return struct.unpack_from(">" + fmt, buf, body + 4)


# the fields of a VisualSampleEntry before its child boxes
VISUAL_ENTRY_HEAD = 78


def read_track(buf, path: Path):
    """The first video track of an MP4 file: (sample offsets, sample sizes,
    info, sample entry) where info holds width and height (the sample
    entry's), fps, frame_count, container "mp4", `sync`, the 0-based indices
    of the sync samples (None where `stss` is absent: every sample is one),
    `rotation`, the clockwise display rotation of the track header's matrix
    (0, 90, 180 or 270), `times`, each sample's presentation time in track
    ticks, and `shown`, the output positions the edit list keeps, in order
    (None: every one), where the k-th picture out is the sample with the
    k-th smallest presentation time (decoding order where there is no
    `ctts`); the sample entry is (type, body start, body end)."""
    file_end = len(buf)
    moov = child(buf, 0, file_end, b"moov")
    if moov is None:
        raise ValueError(f"{path}: an MP4 file with no moov box (cut short, or fragmented)")
    if moov[1] > file_end:
        raise ValueError(f"{path}: the moov box is cut short")
    mvhd = child(buf, *moov, b"mvhd")
    movie_scale = (full_box(buf, mvhd[0], "QQI") if buf[mvhd[0]] == 1
                   else full_box(buf, mvhd[0], "III"))[2] if mvhd else 0
    for typ, tbody, tend in boxes(buf, *moov):
        if typ != b"trak":
            continue
        mdia = child(buf, tbody, tend, b"mdia")
        hdlr = mdia and child(buf, *mdia, b"hdlr")
        if not hdlr or bytes(buf[hdlr[0] + 8:hdlr[0] + 12]) != b"vide":
            continue
        mdhd = child(buf, *mdia, b"mdhd")
        version = buf[mdhd[0]]
        (timescale,) = (full_box(buf, mdhd[0], "QQI") if version == 1
                        else full_box(buf, mdhd[0], "III"))[2:]
        stbl = child(buf, *child(buf, *mdia, b"minf"), b"stbl")
        offsets, sizes, info, entry = _read_stbl(buf, stbl, timescale, path)
        info["rotation"] = _rotation(buf, child(buf, tbody, tend, b"tkhd"))
        edts = child(buf, tbody, tend, b"edts")
        elst = edts and child(buf, *edts, b"elst")
        info["shown"] = _edited(buf, elst, info["times"], timescale, movie_scale)
        return offsets, sizes, info, entry
    raise ValueError(f"{path}: an MP4 file with no video track")


def _rotation(buf, tkhd) -> int:
    """The clockwise rotation of a track header's display matrix (a b u / c
    d v / x y w) to the nearest quarter turn, as FFmpeg's
    av_display_rotation_get reads it."""
    if tkhd is None:
        return 0
    # the matrix follows the times, track_ID, duration and 16 more bytes
    at = tkhd[0] + (52 if buf[tkhd[0]] == 1 else 40)
    a, b = struct.unpack_from(">ii", buf, at)
    return int(round(math.degrees(math.atan2(b, a)) / 90)) % 4 * 90


def output_order(times: list[int]) -> list[int]:
    """The samples in output order: by presentation time, then decoding
    order."""
    return sorted(range(len(times)), key=lambda i: (times[i], i))


def _edited(buf, elst, times: list[int], timescale: int, movie_scale: int):
    """The output positions the edit list shows, in order: for each edit
    that is not empty, those of the samples whose presentation time lies in
    [media_time, media_time + the edit's duration); None where there is no
    edit list or it keeps every position in order."""
    if elst is None or not movie_scale:
        return None
    version = buf[elst[0]]
    (count,) = full_box(buf, elst[0], "I")
    fmt, step = (">Qq", 16) if version == 1 else (">Ii", 8)
    shown = []
    for k in range(count):
        duration, media_time = struct.unpack_from(fmt, buf, elst[0] + 8 + k * (step + 4))
        if media_time < 0:
            continue                                    # an empty edit
        end = media_time + duration * timescale / movie_scale
        shown += [k for k, i in enumerate(output_order(times)) if media_time <= times[i] < end
                  or (duration == 0 and times[i] >= media_time)]
    return None if shown == list(range(len(times))) else shown
def _read_stbl(buf, stbl, timescale: int, path: Path):
    stsd = child(buf, *stbl, b"stsd")
    entry = next(boxes(buf, stsd[0] + 8, stsd[1]))
    width, height = struct.unpack_from(">HH", buf, entry[1] + 24)

    stsz = child(buf, *stbl, b"stsz")
    if stsz is None:
        raise ValueError(f"{path}: no stsz box (compact stz2 sample sizes are not read)")
    size, n = full_box(buf, stsz[0], "II")
    sizes = list(full_box(buf, stsz[0], f"II{n}I")[2:]) if size == 0 else [size] * n
    stco = child(buf, *stbl, b"stco")
    co64 = child(buf, *stbl, b"co64")
    if stco is not None:
        (nc,) = full_box(buf, stco[0], "I")
        chunks = full_box(buf, stco[0], f"I{nc}I")[1:]
    else:
        (nc,) = full_box(buf, co64[0], "I")
        chunks = full_box(buf, co64[0], f"I{nc}Q")[1:]
    stsc = child(buf, *stbl, b"stsc")
    (ns,) = full_box(buf, stsc[0], "I")
    runs = full_box(buf, stsc[0], f"I{3 * ns}I")[1:]
    offsets = []
    for k in range(ns):
        first, per_chunk = runs[3 * k] - 1, runs[3 * k + 1]
        last = runs[3 * k + 3] - 1 if k + 1 < ns else nc
        for c in range(first, last):
            pos = chunks[c]
            for _ in range(per_chunk):
                if len(offsets) == n:
                    break
                offsets.append(pos)
                pos += sizes[len(offsets) - 1]
    if len(offsets) < n:
        raise ValueError(f"{path}: the chunks hold {len(offsets)} of the {n} samples that "
                         "stsz declares")
    for i, (o, s) in enumerate(zip(offsets, sizes)):
        if o + s > len(buf):
            raise ValueError(f"{path}: frame {i} is cut short: {max(len(buf) - o, 0)} of "
                             f"its {s} bytes are in the file")
    stts = child(buf, *stbl, b"stts")
    (nt,) = full_box(buf, stts[0], "I")
    deltas = full_box(buf, stts[0], f"I{2 * nt}I")[1:]
    duration = sum(deltas[2 * k] * deltas[2 * k + 1] for k in range(nt))
    times, t = [], 0                             # presentation times, n of them
    for k in range(nt):
        for _ in range(min(deltas[2 * k], n - len(times))):
            times.append(t)
            t += deltas[2 * k + 1]
    times += [t] * (n - len(times))
    ctts = child(buf, *stbl, b"ctts")
    if ctts is not None:                         # composition offsets (signed)
        (nc,) = full_box(buf, ctts[0], "I")
        runs = full_box(buf, ctts[0], f"I{2 * nc}i")[1:]
        shift = []
        for k in range(nc):
            shift += [runs[2 * k + 1]] * min(runs[2 * k], n - len(shift))
        times = [t + (shift[i] if i < len(shift) else 0) for i, t in enumerate(times)]
    fps = float(Fraction(n * timescale, duration)) if duration and n else 0.0
    stss = child(buf, *stbl, b"stss")
    sync = None
    if stss is not None:
        (nsync,) = full_box(buf, stss[0], "I")
        sync = [s - 1 for s in full_box(buf, stss[0], f"I{nsync}I")[1:]]
    info = {"width": width, "height": height, "fps": fps, "frame_count": n,
            "container": "mp4", "sync": sync, "times": times}
    return offsets, sizes, info, entry


def box(typ: bytes, *parts: bytes) -> bytes:
    body = b"".join(parts)
    return struct.pack(">I", 8 + len(body)) + typ + body


def full(typ: bytes, version: int, flags: int, *parts: bytes) -> bytes:
    return box(typ, struct.pack(">I", version << 24 | flags), *parts)


def visual_entry(kind: bytes, width: int, height: int, *children: bytes) -> bytes:
    """A VisualSampleEntry of type `kind` (72 dpi, one frame a sample, depth
    24) with its codec's boxes."""
    return box(kind, bytes(6), struct.pack(">H", 1), bytes(16),
               struct.pack(">HHIIIH", width, height, 0x480000, 0x480000, 0, 1), bytes(32),
               struct.pack(">Hh", 0x18, -1), *children)


_MATRIX = struct.pack(">9I", 0x10000, 0, 0, 0, 0x10000, 0, 0, 0, 0x40000000)


def _moov(entry: bytes, sizes: list[int], sync: list[int], first: int, timescale: int,
          delta: int, width: int, height: int) -> bytes:
    n = len(sizes)
    ms = round(n * delta * 1000 / timescale)
    offsets = full(b"co64", 0, 0, struct.pack(">IQ", 1, first)) if first > 0xFFFFFFFF \
        else full(b"stco", 0, 0, struct.pack(">II", 1, first))
    stss = b"" if len(sync) == n else full(
        b"stss", 0, 0, struct.pack(f">I{len(sync)}I", len(sync), *(s + 1 for s in sync)))
    stbl = box(b"stbl",
               full(b"stsd", 0, 0, struct.pack(">I", 1), entry),
               full(b"stts", 0, 0, struct.pack(">III", 1, n, delta)),
               stss,
               full(b"stsc", 0, 0, struct.pack(">IIII", 1, 1, n, 1)),
               full(b"stsz", 0, 0, struct.pack(f">II{n}I", 0, n, *sizes)),
               offsets)
    minf = box(b"minf", full(b"vmhd", 0, 1, bytes(8)),
               box(b"dinf", full(b"dref", 0, 0, struct.pack(">I", 1),
                                 full(b"url ", 0, 1))), stbl)
    mdia = box(b"mdia",
               full(b"mdhd", 0, 0, struct.pack(">IIIIHH", 0, 0, timescale, n * delta,
                                               0x55C4, 0)),
               full(b"hdlr", 0, 0, struct.pack(">I4s12x", 0, b"vide"), b"VideoHandler\x00"),
               minf)
    tkhd = full(b"tkhd", 0, 3, struct.pack(">IIIII8xhhhH", 0, 0, 1, 0, ms, 0, 0, 0, 0),
                _MATRIX, struct.pack(">II", width << 16, height << 16))
    mvhd = full(b"mvhd", 0, 0, struct.pack(">IIIIIH10x", 0, 0, 1000, ms, 0x10000, 0x100),
                _MATRIX, bytes(24), struct.pack(">I", 2))
    return box(b"moov", mvhd, box(b"trak", tkhd, mdia))


def write_track(f, samples: Iterable[tuple[bytes, bool]], rate: Fraction, width: int,
                height: int, entry: Callable[[list[int]], bytes]) -> int:
    """Stream (sample bytes, is a sync sample) pairs into an MP4 file open
    for writing and reading at its start; `entry(sizes)` gives the sample
    entry once every sample's size is known.  Returns the number of samples
    (0: nothing but the header was written)."""
    # the track's timescale as FFmpeg's mov muxer picks it: the frame rate's
    # numerator doubled until it reaches 10,000
    timescale, delta = rate.numerator, rate.denominator
    while timescale < 10000:
        timescale, delta = 2 * timescale, 2 * delta
    f.write(box(b"ftyp", b"isom", struct.pack(">I", 0x200), b"isomiso2mp41"))
    mdat = f.tell()
    f.write(struct.pack(">I4sQ", 1, b"mdat", 16))          # size patched below
    sizes, sync = [], []
    for data, is_sync in samples:
        if is_sync:
            sync.append(len(sizes))
        f.write(data)
        sizes.append(len(data))
    if not sizes:
        return 0
    end = f.tell()
    f.write(_moov(entry(sizes), sizes, sync, mdat + 16, timescale, delta, width, height))
    f.seek(mdat + 8)
    f.write(struct.pack(">Q", end - mdat))
    return len(sizes)
