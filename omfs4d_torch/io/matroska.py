"""Matroska and WebM read with the standard library: the EBML walker and
`index`, which gives what `container.index` gives for AVI and MP4: the
offsets and sizes of the video track's frames in the file and the track's
info, for the port's codecs (Motion JPEG, MPEG-4 Part 2, H.264, HEVC, VP8,
VP9, MPEG-1 / MPEG-2, MS MPEG-4 v2 / v3 and WMV1 / WMV2).

Read as FFmpeg's `matroskadec` reads a file for cv2:
- EBML: element IDs keep their length marker, sizes drop it; a size of all
  ones is unknown: a Segment of unknown size ends with the file, a Cluster
  of unknown size at the first element that is no child of a Cluster.
  `SeekHead`, `Cues`, `Tags`, `Chapters`, `Attachments`, `Void` and `CRC-32`
  are skipped: the frames are found by walking every Cluster, whatever the
  Cues say.
- The track: the first `TrackEntry` of `TrackType` 1 (video), as OpenCV
  takes the first video stream; every other track's blocks are skipped by
  their track number.  `PixelWidth` x `PixelHeight` is its size;
  `PixelCrop*` and `DisplayWidth` / `DisplayHeight` are not applied, as cv2
  applies neither (measured on Motion JPEG and H.264).
- The codec from `CodecID`: `V_MJPEG`; `V_MPEG4/ISO/SP`, `/ASP`, `/AP` (MPEG-4
  Part 2, `CodecPrivate` its headers); `V_MPEG4/ISO/AVC` and
  `V_MPEGH/ISO/HEVC` (`CodecPrivate` the avcC / hvcC body, the frames
  length-prefixed); `V_VP8` (no CodecPrivate; its BlockAdditions, an
  alpha channel, are skipped as cv2 skips them); `V_VP9` (no CodecPrivate;
  its frames may be superframes, split by the codec); `V_MPEG1` /
  `V_MPEG2` (`CodecPrivate` the sequence header, as `extradata`);
  `V_MPEG4/MS/V3` (MS MPEG-4 v3, DivX 3); `V_MS/VFW/FOURCC` (`CodecPrivate`
  a BITMAPINFOHEADER, its fourcc read as AVI's, `container.avi_codec`: cv2's
  WMV1 / WMV2 / MP42 / MP43 among them, WMV2's extended header the bytes
  after it, HuffYUV's and PNG's); `V_FFV1` (`CodecPrivate` its configuration
  record); `V_UNCOMPRESSED` (raw video, its `ColourSpace` fourcc as its
  pixel format, cv2's `I420`, `RGBA` and `Y800`).  Any other (AV1, Theora,
  ProRes, ...)
  raises `UnsupportedCodecError` naming it.
- Frames: `SimpleBlock`s (FFmpeg's muxer; the keyframe flag gives `sync`)
  and `BlockGroup`s (mkvmerge's: a `Block` with no `ReferenceBlock` is a
  key frame), unlaced or in Xiph, EBML or fixed-size lacing (every laced
  frame its own range of the file; only a lace's first frame can be a key
  frame).  A block cut short by the end of the file is dropped, as FFmpeg
  drops it.
- Times: a frame's is `TimestampScale` x (its Cluster's `Timestamp` + the
  block's signed offset); a lace's later frames follow by `DefaultDuration`
  (their times unknown without it, as FFmpeg leaves them).  `info["times"]`
  holds them in decoding order, so that the readers order output and find
  their restarts as from MP4's `ctts`; a VfW track's are decoding times,
  and it gets none, as in AVI.
- fps and frame_count as cv2 reports them: FFmpeg's average frame rate from
  `DefaultDuration` (`av_reduce(1e9, DefaultDuration, 30000)`), else its
  estimate from the first frames' times (`estimated_fps`); the count is
  OpenCV's `floor(duration x fps + 0.5)` from the Segment's `Duration` (no
  Matroska element counts frames), else from the frames' own span.
- Rotation: a rectangular `Video/Projection`'s roll (and yaw of 180) turns
  the frames as cv2 turns them (`info["rotation"]`, clockwise).
- Colour: `Video/Colour`'s matrix, range, transfer and primaries become
  `info["colr"]` and `MasteringMetadata`'s luminance `info["mdcv"]`, in the
  shapes the MP4 boxes give them, for each codec to weigh against its
  stream's own as it does there.
- `ContentEncoding`: header stripping (`ContentCompAlgo` 3) gives
  `info["prefix"]`, the bytes every frame starts with and the file leaves
  out; zlib, bzlib, LZO and encryption raise naming it.
"""

from __future__ import annotations

import math
import struct
from fractions import Fraction
from pathlib import Path

# element IDs (with their length marker), Matroska's specification
EBML, DOC_TYPE = 0x1A45DFA3, 0x4282
MAGIC = EBML.to_bytes(4, "big")                 # a Matroska / WebM file's first bytes
SEGMENT = 0x18538067
INFO, TIMESTAMP_SCALE, DURATION = 0x1549A966, 0x2AD7B1, 0x4489
TRACKS, TRACK_ENTRY = 0x1654AE6B, 0xAE
TRACK_NUMBER, TRACK_TYPE, CODEC_ID, CODEC_PRIVATE = 0xD7, 0x83, 0x86, 0x63A2
DEFAULT_DURATION, VIDEO = 0x23E383, 0xE0
PIXEL_WIDTH, PIXEL_HEIGHT, COLOUR_SPACE = 0xB0, 0xBA, 0x2EB524
PROJECTION, PROJECTION_TYPE, POSE_YAW, POSE_PITCH, POSE_ROLL = \
    0x7670, 0x7671, 0x7673, 0x7674, 0x7675
COLOUR, MATRIX, RANGE, TRANSFER, PRIMARIES = 0x55B0, 0x55B1, 0x55B9, 0x55BA, 0x55BB
MASTERING, LUMINANCE_MAX, LUMINANCE_MIN = 0x55D0, 0x55D9, 0x55DA
CONTENT_ENCODINGS, CONTENT_ENCODING = 0x6D80, 0x6240
ENCODING_SCOPE, ENCODING_TYPE = 0x5032, 0x5033
COMPRESSION, COMP_ALGO, COMP_SETTINGS = 0x5034, 0x4254, 0x4255
CLUSTER, CLUSTER_TIMESTAMP = 0x1F43B675, 0xE7
SIMPLE_BLOCK, BLOCK_GROUP, BLOCK, REFERENCE_BLOCK = 0xA3, 0xA0, 0xA1, 0xFB
VOID, CRC32 = 0xEC, 0xBF
# what a Cluster holds: an element of another ID ends a Cluster of unknown size
_CLUSTER_CHILDREN = {CLUSTER_TIMESTAMP, SIMPLE_BLOCK, BLOCK_GROUP, 0x5854, 0xA7, 0xAB,
                     0xAF, VOID, CRC32}

TRACK_TYPE_VIDEO = 1
# CodecIDs the port reads, and names of those it does not
_MPEG4 = {"V_MPEG4/ISO/SP", "V_MPEG4/ISO/ASP", "V_MPEG4/ISO/AP"}
_NAMES = {"V_AV1": "AV1", "V_THEORA": "Theora", "V_PRORES": "ProRes",
          "V_REAL/RV40": "RealVideo 4", "V_DIRAC": "Dirac",
          "V_QUICKTIME": "a QuickTime codec", "V_MPEGI/ISO/VVC": "H.266 / VVC"}
_COMP_ALGOS = {0: "zlib", 1: "bzlib", 2: "LZO"}
HEADER_STRIPPING = 3

# FFmpeg's `fps_analyze_framecount` for a time base as coarse as Matroska's
# millisecond: the frame intervals find_stream_info reads for its estimate
_FPS_FRAMES = 40


class Cut(Exception):
    """An element runs past the end of the file."""


def vint(buf, pos: int, end: int) -> tuple[int, int]:
    """(length, value without the length marker) of the EBML variable-size
    integer at pos."""
    if pos >= end:
        raise Cut
    first = buf[pos]
    if first == 0:
        raise ValueError(f"EBML: a variable-size integer longer than 8 bytes at {pos}")
    length = 9 - first.bit_length()
    if pos + length > end:
        raise Cut
    value = first & (0xFF >> length)
    for k in range(1, length):
        value = value << 8 | buf[pos + k]
    return length, value


def header(buf, pos: int, end: int) -> tuple[int, int, int | None]:
    """(ID, data start, data size, None when unknown) of the element at
    pos; `Cut` when its header runs past `end`."""
    n, _ = vint(buf, pos, end)
    eid = int.from_bytes(buf[pos:pos + n], "big")
    m, size = vint(buf, pos + n, end)
    return eid, pos + n + m, None if size == (1 << 7 * m) - 1 else size


def children(buf, start: int, end: int):
    """(ID, data start, data end) of each element between start and end (of
    known size; an element cut by `end` stops the walk)."""
    pos = start
    while pos < end:
        try:
            eid, data, size = header(buf, pos, end)
        except Cut:
            return
        if size is None:
            raise ValueError(f"EBML: element {eid:#x} at {pos} has an unknown size")
        if data + size > end:
            return
        yield eid, data, data + size
        pos = data + size


def _uint(buf, data: int, stop: int) -> int:
    return int.from_bytes(buf[data:stop], "big")


def _float(buf, data: int, stop: int) -> float:
    if stop - data == 4:
        return struct.unpack_from(">f", buf, data)[0]
    if stop - data == 8:
        return struct.unpack_from(">d", buf, data)[0]
    return 0.0


def _fields(buf, start: int, end: int) -> dict[int, tuple[int, int]]:
    """The (data start, data end) of each child of a master element, by ID
    (the first of each)."""
    out: dict[int, tuple[int, int]] = {}
    for eid, data, stop in children(buf, start, end):
        out.setdefault(eid, (data, stop))
    return out


def _cluster_end(buf, pos: int, end: int) -> int:
    """Where a Cluster of unknown size whose data starts at pos ends: at the
    first element that is no child of a Cluster, or the end."""
    while pos < end:
        try:
            eid, data, size = header(buf, pos, end)
        except Cut:
            return end
        if eid not in _CLUSTER_CHILDREN or size is None:
            return pos
        pos = data + size
    return min(pos, end)


def segment_elements(buf, start: int, end: int):
    """(ID, data start, data end) of each element of a Segment's data,
    Clusters of unknown size ended as FFmpeg ends them; the data end of a
    cut element is past `end`."""
    pos = start
    while pos < end:
        try:
            eid, data, size = header(buf, pos, end)
        except Cut:
            return
        if eid == EBML:                       # a chained Segment: the first one ends
            return
        stop = _cluster_end(buf, data, end) if size is None else data + size
        yield eid, data, stop
        if stop <= pos:
            return
        pos = stop


# ── the track ───────────────────────────────────────────────────────────

def _video_track(buf, tracks: tuple[int, int], path) -> dict:
    for eid, data, stop in children(buf, *tracks):
        if eid != TRACK_ENTRY:
            continue
        f = _fields(buf, data, stop)
        if TRACK_TYPE in f and _uint(buf, *f[TRACK_TYPE]) == TRACK_TYPE_VIDEO:
            return _track(buf, f, path)
    raise ValueError(f"{path}: a Matroska file with no video track")


def _track(buf, f: dict, path) -> dict:
    from omfs4d_torch.io.container import _needs_ffmpeg

    def text(eid):
        return bytes(buf[slice(*f[eid])]).rstrip(b"\x00").decode("latin-1") if eid in f else ""

    track = {"number": _uint(buf, *f[TRACK_NUMBER]) if TRACK_NUMBER in f else 0,
             "codec_id": text(CODEC_ID),
             "private": bytes(buf[slice(*f[CODEC_PRIVATE])]) if CODEC_PRIVATE in f else b"",
             "default_duration": _uint(buf, *f[DEFAULT_DURATION])
             if DEFAULT_DURATION in f else 0, "width": 0, "height": 0, "prefix": b"",
             "colour_space": b""}
    if VIDEO in f:
        v = _fields(buf, *f[VIDEO])
        track["width"] = _uint(buf, *v[PIXEL_WIDTH]) if PIXEL_WIDTH in v else 0
        track["height"] = _uint(buf, *v[PIXEL_HEIGHT]) if PIXEL_HEIGHT in v else 0
        if COLOUR_SPACE in v:
            track["colour_space"] = bytes(buf[slice(*v[COLOUR_SPACE])])
        if COLOUR in v:
            track.update(_colour(buf, _fields(buf, *v[COLOUR])))
        if PROJECTION in v:
            track["rotation"] = _rotation(buf, _fields(buf, *v[PROJECTION]))
    if CONTENT_ENCODINGS in f:
        encodings = [(d, s) for e, d, s in children(buf, *f[CONTENT_ENCODINGS])
                     if e == CONTENT_ENCODING]
        if len(encodings) > 1:
            raise _needs_ffmpeg(path, f"its video track has {len(encodings)} content "
                                      "encodings combined")
        if encodings:
            e = _fields(buf, *encodings[0])
            kind = _uint(buf, *e[ENCODING_TYPE]) if ENCODING_TYPE in e else 0
            scope = _uint(buf, *e[ENCODING_SCOPE]) if ENCODING_SCOPE in e else 1
            if kind != 0:
                raise _needs_ffmpeg(path, "its video track is encrypted (Matroska "
                                          "ContentEncryption)")
            c = _fields(buf, *e[COMPRESSION]) if COMPRESSION in e else {}
            algo = _uint(buf, *c[COMP_ALGO]) if COMP_ALGO in c else 0
            if algo != HEADER_STRIPPING:
                raise _needs_ffmpeg(path, f"its video track is compressed with "
                                          f"{_COMP_ALGOS.get(algo, f'algorithm {algo}')} "
                                          "(Matroska ContentCompression)")
            settings = bytes(buf[slice(*c[COMP_SETTINGS])]) if COMP_SETTINGS in c else b""
            if scope & 1:
                track["prefix"] = settings
            if scope & 2:
                track["private"] = settings + track["private"]
    return track


def _colour(buf, c: dict) -> dict:
    """`Colour`'s tags as `matroskadec` hands them to the decoder: reserved
    values left unspecified (2), a range of 1 or 2 taken (limited, full)."""
    def get(eid, default):
        return _uint(buf, *c[eid]) if eid in c else default

    matrix, transfer, primaries = get(MATRIX, 2), get(TRANSFER, 2), get(PRIMARIES, 2)
    out = {"colr": (2 if primaries in (0, 3) else primaries,
                    2 if transfer in (0, 3) else transfer,
                    2 if matrix == 3 else matrix, get(RANGE, 0) == 2)}
    if MASTERING in c:
        m = _fields(buf, *c[MASTERING])
        most = _float(buf, *m[LUMINANCE_MAX]) if LUMINANCE_MAX in m else 0.0
        least = _float(buf, *m[LUMINANCE_MIN]) if LUMINANCE_MIN in m else None
        if least is not None and 0 <= least < most:
            out["mdcv"] = (least, most)
    return out


def _rotation(buf, p: dict) -> int:
    """The clockwise turn cv2 gives the frames of a rectangular
    `Projection`: `matroskadec`'s display matrix of its roll (and a
    horizontal flip for a yaw of 180), read back as OpenCV reads it (the
    angle alone, rounded), applied only at 90, 180 or 270 degrees."""
    def get(eid):
        return _float(buf, *p[eid]) if eid in p else 0.0

    kind = _uint(buf, *p[PROJECTION_TYPE]) if PROJECTION_TYPE in p else 0
    yaw, pitch, roll = get(POSE_YAW), get(POSE_PITCH), get(POSE_ROLL)
    if kind != 0 or pitch != 0.0 or yaw not in (0.0, 180.0, -180.0) or math.isnan(roll):
        return 0
    hflip = yaw != 0.0
    radians = -roll * (1 if hflip else -1) * math.pi / 180.0
    fixed = [int(round(v * (1 << 16))) for v in (math.cos(radians), -math.sin(radians))]
    if hflip:
        fixed[0] = -fixed[0]
    angle = round(math.degrees(math.atan2(fixed[1], fixed[0]))) % 360
    return angle if angle in (90, 180, 270) else 0


def _codec(track: dict, path) -> dict:
    from omfs4d_torch.io import container

    cid, private = track["codec_id"], track["private"]
    if cid == "V_MJPEG":
        return {"codec": "mjpeg"}
    if cid in _MPEG4:
        return {"codec": "mpeg4", "dsi": private}
    if cid == "V_VP8":
        return {"codec": "vp8"}
    if cid == "V_VP9":
        return {"codec": "vp9"}
    if cid in ("V_MPEG1", "V_MPEG2"):
        return {"codec": "mpeg2", "extradata": private}
    if cid == "V_FFV1":
        return {"codec": "ffv1", "extradata": private}
    if cid == "V_UNCOMPRESSED":
        tag = track["colour_space"]
        if tag not in container.RAW_TAGS - {b"\0\0\0\0"}:
            raise container._needs_ffmpeg(path, f"its video is raw video of ColourSpace "
                                                f"{tag.decode('latin-1')!r} (Matroska "
                                                "V_UNCOMPRESSED)")
        return {"codec": "raw", "fourcc": tag, "bits": 0, "bottom_up": False}
    if cid == "V_MPEG4/MS/V3":
        return {"codec": "msmpeg4", "version": 3, "extradata": private}
    if cid == "V_MPEG4/ISO/AVC":
        if not private:
            raise container._needs_ffmpeg(path, "its video is H.264 with no CodecPrivate "
                                                "(Matroska V_MPEG4/ISO/AVC)")
        return {"codec": "h264", "avcC": private}
    if cid == "V_MPEGH/ISO/HEVC":
        if not private:
            raise container._needs_ffmpeg(path, "its video is H.265 / HEVC with no "
                                                "CodecPrivate (Matroska V_MPEGH/ISO/HEVC)")
        return {"codec": "hevc", "hvcC": private}
    if cid == "V_MS/VFW/FOURCC":
        if len(private) < 40:
            raise ValueError(f"{path}: a V_MS/VFW/FOURCC track with no BITMAPINFOHEADER")
        return container.avi_codec(private[16:20], private[40:], path, "Matroska VfW fourcc",
                                   bits=int.from_bytes(private[14:16], "little"))
    name = _NAMES.get(cid, "an unknown codec")
    raise container._needs_ffmpeg(path, f"its video is {name} (Matroska CodecID {cid!r})")


# ── blocks ──────────────────────────────────────────────────────────────

def laces(buf, pos: int, end: int, flags: int) -> list[tuple[int, int]]:
    """(offset, size) of each frame of a block's data at pos..end, by its
    lacing (flags bits 1-2: none, Xiph, fixed-size, EBML)."""
    lacing = flags >> 1 & 3
    if lacing == 0:
        return [(pos, end - pos)]
    if pos >= end:
        raise ValueError("a laced block with no lace count")
    count = buf[pos] + 1
    pos += 1
    sizes = []
    if lacing == 1:                                      # Xiph
        for _ in range(count - 1):
            size = 0
            while True:
                if pos >= end:
                    raise ValueError("a Xiph lace's sizes run past its block")
                b = buf[pos]
                pos += 1
                size += b
                if b != 255:
                    break
            sizes.append(size)
    elif lacing == 3:                                    # EBML
        n, size = vint(buf, pos, end)
        pos += n
        sizes.append(size)
        for _ in range(count - 2):
            n, raw = vint(buf, pos, end)
            pos += n
            size += raw - ((1 << 7 * n - 1) - 1)
            sizes.append(size)
    else:                                                # fixed
        if (end - pos) % count:
            raise ValueError(f"a fixed-size lace of {count} frames in {end - pos} bytes")
        sizes = [(end - pos) // count] * (count - 1)
    last = end - pos - sum(sizes)
    if min(sizes + [last]) < 0:
        raise ValueError("a lace's sizes exceed its block")
    out = []
    for size in sizes + [last]:
        out.append((pos, size))
        pos += size
    return out


def _blocks(buf, data: int, stop: int, number: int, out: list) -> None:
    """Append (data start, data end, flags, is a key frame, time in ticks)
    of each whole block of track `number` in the Cluster data at
    data..stop (stop at most the end of the file)."""
    cluster_ts = 0
    for eid, d, s in children(buf, data, stop):
        if eid == CLUSTER_TIMESTAMP:
            cluster_ts = _uint(buf, d, s)
        elif eid == SIMPLE_BLOCK:
            _block(buf, d, s, number, cluster_ts, None, out)
        elif eid == BLOCK_GROUP:
            g = list(children(buf, d, s))
            for e, bd, bs in g:
                if e == BLOCK:
                    key = not any(x == REFERENCE_BLOCK for x, _, _ in g)
                    _block(buf, bd, bs, number, cluster_ts, key, out)
                    break


def _block(buf, data: int, stop: int, number: int, cluster_ts: int, key: bool | None,
           out: list) -> None:
    try:
        n, track = vint(buf, data, stop)
    except Cut:
        return
    if track != number or data + n + 3 > stop:
        return
    (offset,) = struct.unpack_from(">h", buf, data + n)
    flags = buf[data + n + 2]
    out.append((data + n + 3, stop, flags, bool(flags & 0x80) if key is None else key,
                cluster_ts + offset))


# ── fps and frame_count as cv2 reports them ─────────────────────────────

def av_reduce(num: int, den: int, most: int) -> Fraction:
    """libavutil's av_reduce: the closest fraction to num / den with both
    terms at most `most` (its continued-fraction walk, ties and all)."""
    g = math.gcd(num, den)
    if g:
        num, den = num // g, den // g
    a0n, a0d, a1n, a1d = 0, 1, 1, 0
    if num <= most and den <= most:
        a1n, a1d, den = num, den, 0
    while den:
        x = num // den
        next_den = num - den * x
        a2n, a2d = x * a1n + a0n, x * a1d + a0d
        if a2n > most or a2d > most:
            if a1n:
                x = (most - a0n) // a1n
            if a1d:
                x = min(x, (most - a0d) // a1d)
            if den * (2 * x * a1d + a0d) > num * a1d:
                a1n, a1d = x * a1n + a0n, x * a1d + a0d
            break
        a0n, a0d, a1n, a1d = a1n, a1d, a2n, a2d
        num, den = den, next_den
    return Fraction(a1n, a1d) if a1d else Fraction(0)


def _std_rate(j: int) -> int:
    """libavformat's get_std_framerate(j), in 1 / (12 x 1001) frames a
    second."""
    if j < 30 * 12:
        return (j + 1) * 1001
    j -= 30 * 12
    if j < 30:
        return (j + 31) * 1001 * 12
    j -= 30
    if j < 3:
        return (80, 120, 240)[j] * 1001 * 12
    return (24, 30, 60, 12, 15, 48)[j - 3] * 1000 * 12


_N_STD = 30 * 12 + 30 + 3 + 6


def rfps(dts: list[int | None], base: int = 1000, info_duration: int = 0
         ) -> tuple[Fraction, int, int]:
    """FFmpeg's r_frame_rate estimate for a video stream whose time base is
    1 / `base` s and whose demuxer gives no rate (`ff_rfps_add_frame` over
    the decoding times `dts`, None where a frame has none, then
    `ff_rfps_calculate`: the intervals' common divisor past the 4th, else
    the standard rate their ticks fit best, which is neither slower than one
    frame in `info_duration` ticks, the frames' summed durations, nor, with
    none, than 1 fps); returns (the rate, 0 where it finds none, the count
    and the sum of the intervals)."""
    err = [[[0.0] * _N_STD for _ in range(2)] for _ in range(2)]
    count = dur_sum = gcd = 0
    last = None
    for ts in dts:
        if ts is not None and last is not None and ts > last:
            t = ts / base
            for i in range(_N_STD):
                if err[0][1][i] < 1e10:
                    sdts = t * _std_rate(i) / (1001 * 12)
                    for j in range(2):
                        ticks = round(sdts + j * 0.5)     # llrint: ties to even
                        e = sdts - ticks + j * 0.5
                        err[j][0][i] += e
                        err[j][1][i] += e * e
            count += 1
            dur_sum += ts - last
            if count > 3:
                gcd = math.gcd(gcd, ts - last)
            if count % 10 == 0:
                for i in range(_N_STD):
                    if err[0][1][i]:
                        a0 = err[0][0][i] / count
                        e0 = err[0][1][i] / count - a0 * a0
                        a1 = err[1][0][i] / count
                        e1 = err[1][1][i] / count - a1 * a1
                        if e0 > 0.04 and e1 > 0.04:
                            err[0][1][i] = err[1][1][i] = 2e10
        if ts is not None:
            last = ts
    if count > 15 and gcd > max(1, base // 500):   # the intervals' common divisor
        return Fraction(base, gcd), count, dur_sum
    if count <= 1:
        return Fraction(0), count, dur_sum
    return _snapped(err, count, dur_sum, base, info_duration), count, dur_sum


def estimated_fps(times_ms: list[int]) -> tuple[Fraction, Fraction]:
    """FFmpeg's (r_frame_rate, avg_frame_rate) estimate for a video stream
    of a millisecond time base whose demuxer gives no rate (`rfps` over the
    first `_FPS_FRAMES` frame intervals of its decoding times, the average
    rate the same where the intervals average to it); 0 for either it finds
    none of."""
    rate, count, dur_sum = rfps(sorted(times_ms)[:_FPS_FRAMES + 1])
    zero = Fraction(0)
    avg = rate if rate and count > 2 and abs(1000 / rate - dur_sum / count) <= 1.0 else zero
    return rate, avg


def _snapped(err, count: int, dur_sum: int, base: int = 1000, info_duration: int = 0
             ) -> Fraction:
    """The standard rate whose ticks the intervals fit best, as
    `ff_rfps_calculate` picks it; 0 where none fits."""
    best, num = 0.01, 0
    for j in range(_N_STD):
        rate = _std_rate(j)
        if info_duration and info_duration * (1 / base) < (1001 * 12.0) / rate:
            continue
        if not info_duration and rate < 1001 * 12:
            continue
        if (1 / base) * dur_sum / count < (1001 * 12.0 * 0.8) / rate:
            continue
        for k in range(2):
            a = err[k][0][j] / count
            e = err[k][1][j] / count - a * a
            if e < best and best > 0.000000001:
                best, num = e, rate
    if num and num / (12 * 1001) < 1.01 * base:
        return av_reduce(num, 12 * 1001, 2**31 - 1)
    return Fraction(0)


def snapped(rate: Fraction) -> Fraction:
    """A rate within 1% of a standard one, as that one (FFmpeg's rounding of
    the average frame rate it estimates)."""
    best, num = 0.01, 0
    for j in range(_N_STD):
        error = abs(rate / Fraction(_std_rate(j), 12 * 1001) - 1)
        if error < best:
            best, num = error, _std_rate(j)
    return av_reduce(num, 12 * 1001, 2**31 - 1) if num else rate


def cv2_fps(times_ms: list[int], stream_rate: float, codec: str) -> float:
    """cv2's CAP_PROP_FPS of a Matroska track with no DefaultDuration, as
    measured against cv2 5.0.0 (libavformat 62).  H.264 and HEVC, which FFmpeg parses, give
    each frame from the third on a duration of 1 / the rate of their VUI
    timing (`stream_rate`) in whole milliseconds, and the rate is that
    average, snapped to a standard rate within 1%.  MPEG-4 Part 2 takes its
    VOL's rate where it lies in [5, 101).  Else (Motion JPEG, VP8, VP9: no rate
    in the stream, as in a browser's recording) FFmpeg estimates the rate
    from the frames' times (`estimated_fps`): its average rate where it sets
    one, else the rate it found, else the stream's rate (an H.264 stream's
    doubled, as FFmpeg counts its fields; none for HEVC), else 1000 (the
    millisecond time base's)."""
    if codec in ("h264", "hevc") and 0 < stream_rate < 1000 and len(times_ms) >= 3:
        ms = math.floor(1000 / Fraction(stream_rate).limit_denominator(1 << 30))
        if ms:
            return float(snapped(av_reduce(1000, ms, 60000)))
    if codec == "mpeg4" and 5 <= stream_rate < 101:
        return stream_rate
    r, avg = estimated_fps(times_ms)
    if avg or r:
        return float(avg or r)
    rate = {"h264": 2 * stream_rate, "mpeg4": stream_rate}.get(codec, 0.0)
    return rate if 0 < rate <= 1000 else 1000.0


def frame_count(duration: float | None, scale: int, fps: float) -> int:
    """OpenCV's frame count of a Matroska file, which declares none:
    floor(seconds x fps + 0.5), the seconds FFmpeg's from the Segment's
    `Duration` (in ticks of `scale` ns, truncated to microseconds); with no
    Duration, OpenCV takes the stream's, which `matroskadec` leaves unset
    (AV_NOPTS_VALUE, INT64_MIN ticks of the stream's time base): a count
    near -2.3e17 at 25 fps, as cv2 reports it."""
    seconds = int(duration * scale * 1000 / 1_000_000) / 1_000_000 if duration else 0.0
    if seconds < 0.000025:                               # OpenCV's eps_zero
        base = Fraction(scale, 10**9)
        seconds = float(-2**63) * (base.numerator / base.denominator)
    return int(math.floor(seconds * fps + 0.5))


def _stream_rate(buf, info: dict, offsets: list[int], sizes: list[int], prefix: bytes
                 ) -> float:
    """The frame rate the codec reads from the stream's headers, 0.0 where
    they give none: H.264's and HEVC's VUI timing, MPEG-4 Part 2's VOL
    (time_increment_resolution over the fixed VOP increment, or 1), none for
    Motion JPEG and VP8."""
    from omfs4d_torch.io import h264, hevc, mpeg2, mpeg4

    codec = info["codec"]
    first = prefix + bytes(buf[offsets[0]:offsets[0] + sizes[0]]) if offsets else b""
    if codec == "mpeg2":
        rate = mpeg2.parse_headers(info["extradata"] + first)["rate"]
        return float(rate) if rate else 0.0
    if codec == "mpeg4":
        headers = info["dsi"] + first[:max(first.find(mpeg4.VOP), 0)]
        p = mpeg4.parse_headers(headers)
        return p["time_resolution"] / (p["fixed_increment"] or 1)
    if codec == "h264":
        if "avcC" in info:
            sps = h264._avcc_units(info["avcC"], "")[0]
        else:
            sps = [u for u in h264.annexb_units(info["annexb"] + first) if u[0] & 0x1F == 7]
        return h264.parse_sps(sps[0])["fps"] if sps else 0.0
    if codec == "hevc":
        units = (hevc.hvcc_units(info["hvcC"], "")[0] if "hvcC" in info
                 else hevc.annexb_units(info["annexb"] + first))
        sps = [u for u in units if hevc.nal_type(u) == hevc.NAL_SPS]
        return hevc.parse_sps(sps[0])["fps"] if sps else 0.0
    return 0.0


# ── the API ─────────────────────────────────────────────────────────────

def index(buf, path: Path) -> tuple[list[int], list[int], dict]:
    """(frame offsets, frame sizes, info) of a Matroska / WebM file's first
    video track: info holds width, height, fps, frame_count, container
    "matroska", the codec's keys as `container.index` gives them, `sync`,
    `times` (in nanoseconds; not for a VfW track) and, where the track
    has them, `colr`, `mdcv`, `rotation` and `prefix`."""
    file_end = len(buf)
    eid, data, size = header(buf, 0, file_end)
    if eid != EBML:
        raise ValueError(f"{path}: no EBML header")
    head = _fields(buf, data, data + size)
    doc = bytes(buf[slice(*head[DOC_TYPE])]).rstrip(b"\x00") if DOC_TYPE in head else b""
    if doc not in (b"matroska", b"webm"):
        raise ValueError(f"{path}: an EBML file of DocType {doc!r}, not Matroska or WebM")
    pos = data + size
    seg = None
    while pos < file_end:
        eid, data, size = header(buf, pos, file_end)
        if eid == SEGMENT:
            seg = (data, file_end if size is None else min(data + size, file_end))
            break
        pos = data + (size or 0)
    if seg is None:
        raise ValueError(f"{path}: a Matroska file with no Segment")
    scale, duration, track, clusters = 1_000_000, None, None, []
    for eid, data, stop in segment_elements(buf, *seg):
        if eid == INFO and stop <= file_end:
            f = _fields(buf, data, stop)
            if TIMESTAMP_SCALE in f:
                scale = _uint(buf, *f[TIMESTAMP_SCALE]) or 1_000_000
            if DURATION in f:
                duration = _float(buf, *f[DURATION])
        elif eid == TRACKS and track is None:
            if stop > file_end:
                raise ValueError(f"{path}: the Tracks element is cut short")
            track = _video_track(buf, (data, stop), path)
        elif eid == CLUSTER:
            clusters.append((data, stop))
    if track is None:
        raise ValueError(f"{path}: a Matroska file with no Tracks element")
    if not clusters:
        # FFmpeg cannot open a file that ends before its first Cluster
        raise ValueError(f"{path}: a Matroska file with no Cluster (cut short before its "
                         "first frame)")
    info = _codec(track, path)
    blocks: list = []
    for data, stop in clusters:
        _blocks(buf, data, min(stop, file_end), track["number"], blocks)
    offsets, sizes, sync, times = [], [], [], []
    for start, stop, flags, key, ts in blocks:
        try:
            frames = laces(buf, start, stop, flags)
        except (ValueError, Cut):
            continue                                 # FFmpeg drops a block it cannot split
        # a lace's frames follow each other by DefaultDuration, in whole
        # ticks as `matroskadec` divides it; with none their times are unknown
        step = track["default_duration"] * len(frames) // scale // len(frames)
        for k, (o, s) in enumerate(frames):
            if key and k == 0:
                sync.append(len(offsets))
            offsets.append(o)
            sizes.append(s)
            times.append(ts + k * step if k == 0 or step else None)
    if track["default_duration"]:
        fps = float(av_reduce(10**9, track["default_duration"], 30000))
    else:
        fps = cv2_fps([round(t * scale / 1e6) for t in times if t is not None],
                      _stream_rate(buf, info, offsets, sizes, track["prefix"]), info["codec"])
    info.update(width=track["width"], height=track["height"], fps=fps,
                frame_count=frame_count(duration, scale, fps), container="matroska",
                sync=sync if len(sync) < len(offsets) else None)
    if track["codec_id"] != "V_MS/VFW/FOURCC" and None not in times:
        info["times"] = [round(t * scale) for t in times]
    for key in ("colr", "mdcv", "rotation"):
        if key in track:
            info[key] = track[key]
    if track["prefix"]:
        info["prefix"] = track["prefix"]
    return offsets, sizes, info
