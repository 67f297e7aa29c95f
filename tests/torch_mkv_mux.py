"""A test muxer: Matroska / WebM and AVI files of samples the tests give it,
deterministic byte for byte, and the remuxes of the committed corpus.

`write_mkv` lays a file out as FFmpeg's Matroska muxer does (EBML header,
Segment, Info with `Duration`, Tracks, a Cluster at each key frame, Cues),
with the variants the port's reader must follow: SimpleBlocks or
BlockGroups with ReferenceBlocks (mkvmerge's layout), Xiph, EBML or
fixed-size lacing, Segment and Cluster sizes known or unknown, `DefaultDuration`
present or absent, a `Colour` element, `CodecPrivate`, header stripping
(`ContentCompAlgo` 3), a second (audio) track interleaved before or after
the video one, and no Cues or Duration (a recording cut short).

`write_avi` lays out an AVI as FFmpeg's AVI muxer does for x264's or x265's
output: an Annex B byte stream a sample, the parameter sets in band at each
IDR / IRAP picture, key frames flagged in `idx1`.

`remux(name, kind, out)` rewrites a committed clip (`CLIPS`) into Matroska
("mkv") or AVI ("avi").

Run as a script it rewrites the remuxes `tests/data/matroska/manifest.json`
lists into a directory and prints each file's SHA-256.
"""

from __future__ import annotations

import struct
import sys
from pathlib import Path

REPO = Path(__file__).resolve().parent.parent
if str(REPO) not in sys.path:
    sys.path.insert(0, str(REPO))

from omfs4d_torch.io import container, h264, hevc, mp4  # noqa: E402
from omfs4d_torch.io import matroska as mk  # noqa: E402

DATA = REPO / "tests" / "data"
# the committed clips the remuxes are made from
CLIPS = {"clip_b": DATA / "h264" / "clip_b.mp4", "clip_mov": DATA / "h264" / "clip.mov",
         "clip_hevc": DATA / "hevc" / "clip_hevc.mp4",
         "clip_hevc10": DATA / "hevc" / "clip_hevc10.mp4",
         "clip_mp4v": DATA / "mpeg4" / "clip_mp4v.mp4"}
CODEC_IDS = {"h264": "V_MPEG4/ISO/AVC", "hevc": "V_MPEGH/ISO/HEVC", "mpeg4": "V_MPEG4/ISO/ASP",
             "mjpeg": "V_MJPEG"}
FOURCCS = {"h264": b"H264", "hevc": b"HEVC"}

UNKNOWN = object()          # a size of all ones


# ── EBML ────────────────────────────────────────────────────────────────

def size_bytes(n, width: int | None = None) -> bytes:
    """An EBML size: the shortest vint (or `width` bytes); UNKNOWN: 8 bytes
    of all ones."""
    if n is UNKNOWN:
        return b"\x01" + b"\xff" * 7
    length = width or next(k for k in range(1, 9) if n < (1 << 7 * k) - 1)
    return ((1 << 7 * length) | n).to_bytes(length, "big")


def el(eid: int, body: bytes, unknown: bool = False) -> bytes:
    return eid.to_bytes((eid.bit_length() + 7) // 8, "big") + \
        size_bytes(UNKNOWN if unknown else len(body)) + body


def uint(eid: int, v: int) -> bytes:
    return el(eid, v.to_bytes(max(1, (v.bit_length() + 7) // 8), "big"))


def flt(eid: int, v: float) -> bytes:
    return el(eid, struct.pack(">d", v))


def text(eid: int, s: str) -> bytes:
    return el(eid, s.encode("latin-1"))


def ebml_header(doc_type: str) -> bytes:
    return el(mk.EBML, uint(0x4286, 1) + uint(0x42F7, 1) + uint(0x42F2, 4) + uint(0x42F3, 8)
              + text(mk.DOC_TYPE, doc_type) + uint(0x4287, 4) + uint(0x4285, 2))


def colour_element(colour: dict) -> bytes:
    """`Colour` of {"matrix", "range", "transfer", "primaries",
    "mastering": (min, max) cd/m^2}, each optional."""
    body = b""
    for key, eid in (("matrix", mk.MATRIX), ("range", mk.RANGE), ("transfer", mk.TRANSFER),
                     ("primaries", mk.PRIMARIES)):
        if key in colour:
            body += uint(eid, colour[key])
    if "mastering" in colour:
        least, most = colour["mastering"]
        body += el(mk.MASTERING, flt(mk.LUMINANCE_MAX, most) + flt(mk.LUMINANCE_MIN, least))
    return el(mk.COLOUR, body)


def lace(frames: list[bytes], kind: str) -> tuple[int, bytes]:
    """(lacing flags, the lace's header) of frames laced as `kind`."""
    n = len(frames) - 1
    if kind == "xiph":
        head = bytes([n]) + b"".join(b"\xff" * (len(f) // 255) + bytes([len(f) % 255])
                                     for f in frames[:-1])
        return 0x02, head
    if kind == "fixed":
        assert len({len(f) for f in frames}) == 1
        return 0x04, bytes([n])
    head = bytes([n]) + size_bytes(len(frames[0]))
    for a, b in zip(frames, frames[1:-1]):
        diff = len(b) - len(a)
        length = next(k for k in range(1, 9) if abs(diff) < (1 << 7 * k - 1) - 1)
        head += size_bytes(diff + (1 << 7 * length - 1) - 1, length)
    return 0x06, head


# ── Matroska ────────────────────────────────────────────────────────────

def write_mkv(path, frames: list[bytes], key: list[bool], times_ms: list[int], *,
              codec_id: str, width: int, height: int, private: bytes = b"",
              default_duration: int | None = None, duration_ms: float | None = None,
              block_group: bool = False, lacing: str | None = None, lace_size: int = 3,
              unknown_segment: bool = False, unknown_cluster: bool = False,
              colour: dict | None = None, strip: bytes = b"", audio: str | None = None,
              doc_type: str = "matroska", cues: bool = True, entry_extra: bytes = b"",
              video_extra: bytes = b"", additions: list[bytes] | None = None) -> Path:
    """A Matroska file of one video track: `frames` in decoding order, `key`
    their key-frame flags, `times_ms` their presentation times (ms, the
    TimestampScale 1,000,000).  `default_duration` (ns) and `duration_ms`
    (the Segment's Duration) are written where given; `block_group` writes
    BlockGroups (a ReferenceBlock to the frame before on every frame but a
    key one) in place of SimpleBlocks; `lacing` ("xiph", "ebml", "fixed")
    laces up to `lace_size` frames a block, a lace never holding a key frame
    but first; `strip`, a prefix every frame starts with, is stripped from
    the blocks (header stripping); `audio` "after" / "before" puts a 16-bit
    PCM track beside the video one (its TrackEntry after or before), a
    block of it after each video block; `cues` False leaves out the Cues;
    `entry_extra` and `video_extra`, elements as bytes, end the video
    TrackEntry and its Video element; `additions`, an element a frame (its
    BlockAdditions), follows each frame's Block in its BlockGroup."""
    vnum, anum = (2, 1) if audio == "before" else (1, 2)
    video = el(mk.VIDEO, uint(mk.PIXEL_WIDTH, width) + uint(mk.PIXEL_HEIGHT, height)
               + (colour_element(colour) if colour else b"") + video_extra)
    entry = (uint(mk.TRACK_NUMBER, vnum) + uint(0x73C5, vnum) + uint(0x9C, int(bool(lacing)))
             + text(mk.CODEC_ID, codec_id) + uint(mk.TRACK_TYPE, 1)
             + (uint(mk.DEFAULT_DURATION, default_duration) if default_duration else b"")
             + video + (el(mk.CODEC_PRIVATE, private) if private else b"") + entry_extra)
    if strip:
        entry += el(mk.CONTENT_ENCODINGS, el(mk.CONTENT_ENCODING, uint(0x5031, 0)
                                            + uint(mk.ENCODING_SCOPE, 1)
                                            + uint(mk.ENCODING_TYPE, 0)
                                            + el(mk.COMPRESSION, uint(mk.COMP_ALGO, 3)
                                                 + el(mk.COMP_SETTINGS, strip))))
    tracks = [el(mk.TRACK_ENTRY, entry)]
    if audio:
        a = el(mk.TRACK_ENTRY, uint(mk.TRACK_NUMBER, anum) + uint(0x73C5, anum)
               + text(mk.CODEC_ID, "A_PCM/INT/LIT") + uint(mk.TRACK_TYPE, 2)
               + el(0xE1, flt(0xB5, 8000.0) + uint(0x9F, 1) + uint(0x6264, 16)))
        tracks.insert(0 if audio == "before" else 1, a)
    for f in frames:
        assert f.startswith(strip)
    # blocks: (time, key, frames)
    blocks, i = [], 0
    while i < len(frames):
        n = 1
        if lacing:
            while (n < lace_size and i + n < len(frames) and not key[i + n]
                   and (lacing != "fixed" or len(frames[i + n]) == len(frames[i]))):
                n += 1
        blocks.append((i, n))
        i += n
    clusters, cluster, cluster_ts, cue_points = [], [], None, []

    def close():
        if cluster:
            clusters.append((cluster_ts, b"".join(cluster)))

    for i, n in blocks:
        ts = times_ms[i]
        if key[i] or cluster_ts is None or not -32768 <= ts - cluster_ts <= 32767:
            close()
            cluster, cluster_ts = [uint(mk.CLUSTER_TIMESTAMP, ts)], ts
            cue_points.append((ts, len(clusters)))
        body = [f[len(strip):] for f in frames[i:i + n]]
        flags, head = lace(body, lacing) if n > 1 else (0, b"")
        data = size_bytes(vnum) + struct.pack(">hB", ts - cluster_ts, flags | (
            0x80 if key[i] and not block_group else 0)) + head + b"".join(body)
        if block_group:
            ref = b"" if key[i] else el(mk.REFERENCE_BLOCK, struct.pack(">b", -1))
            more = additions[i] if additions else b""
            cluster.append(el(mk.BLOCK_GROUP, el(mk.BLOCK, data) + more + ref))
        else:
            cluster.append(el(mk.SIMPLE_BLOCK, data))
        if audio:
            sound = size_bytes(anum) + struct.pack(">hB", ts - cluster_ts, 0x80) + bytes(64)
            cluster.append(el(mk.SIMPLE_BLOCK, sound))
    close()
    info = uint(mk.TIMESTAMP_SCALE, 1_000_000) + text(0x4D80, "omfs4d tests") + \
        text(0x5741, "omfs4d tests") + (flt(mk.DURATION, duration_ms) if duration_ms else b"")
    head = el(mk.INFO, info) + el(mk.TRACKS, b"".join(tracks))
    body = head
    positions = []
    for ts, data in clusters:
        positions.append(len(body))
        body += el(mk.CLUSTER, data, unknown=unknown_cluster)
    if cues:
        points = b"".join(el(0xBB, uint(0xB3, ts) + el(0xB7, uint(0xF7, vnum)
                                                          + uint(0xF1, positions[c])))
                          for ts, c in cue_points)
        body += el(0x1C53BB6B, points)
    out = ebml_header(doc_type) + el(mk.SEGMENT, body, unknown=unknown_segment)
    Path(path).write_bytes(out)
    return Path(path)


# ── AVI ─────────────────────────────────────────────────────────────────

def _chunk(fcc: bytes, data: bytes) -> bytes:
    return fcc + struct.pack("<I", len(data)) + data + b"\x00" * (len(data) & 1)


def _list(kind: bytes, *parts: bytes) -> bytes:
    body = kind + b"".join(parts)
    return b"LIST" + struct.pack("<I", len(body)) + body


def write_avi(path, samples: list[bytes], key: list[bool], width: int, height: int,
              fourcc: bytes, fps: int = 30, extradata: bytes = b"") -> Path:
    """An AVI of one video stream, as FFmpeg's AVI muxer lays it out: `hdrl`
    (avih, one strl of strh / strf, the BITMAPINFOHEADER followed by
    `extradata`), an INFO list naming the writer, `movi` of `00dc` chunks,
    and `idx1` flagging the key frames."""
    n = len(samples)
    biggest = max(len(s) for s in samples)
    avih = struct.pack("<10I16x", 1000000 // fps, 0, 0, 0x910, n, 0, 1, biggest + 8, width,
                       height)
    strh = struct.pack("<4s4sIHHIIIIIIiI4h", b"vids", fourcc, 0, 0, 0, 0, 1, fps, 0, n,
                       biggest + 8, -1, 0, 0, 0, width, height)
    strf = struct.pack("<IiiHH4sIiiII", 40 + len(extradata), width, height, 1, 24, fourcc,
                       width * height * 3, 0, 0, 0, 0) + extradata
    hdrl = _list(b"hdrl", _chunk(b"avih", avih),
                 _list(b"strl", _chunk(b"strh", strh), _chunk(b"strf", strf)))
    info = _list(b"INFO", _chunk(b"ISFT", b"omfs4d tests\x00"))
    movi, index, pos = b"", b"", 4
    for s, k in zip(samples, key):
        index += struct.pack("<4sIII", b"00dc", 0x10 if k else 0, pos, len(s))
        movi += _chunk(b"00dc", s)
        pos += 8 + len(s) + (len(s) & 1)
    body = b"AVI " + hdrl + info + _chunk(b"JUNK", bytes(1016)) + _list(b"movi", movi) + \
        _chunk(b"idx1", index)
    Path(path).write_bytes(b"RIFF" + struct.pack("<I", len(body)) + body)
    return Path(path)


# ── the remuxes ─────────────────────────────────────────────────────────

def read_clip(path) -> dict:
    """A committed MP4 clip's samples, key flags, presentation times (ms from
    the first shown), codec keys and size, through the port's MP4 index."""
    path = Path(path)
    offsets, sizes, info = container.index(path)
    raw = path.read_bytes()
    samples = [raw[o:o + s] for o, s in zip(offsets, sizes)]
    n = len(samples)
    sync = set(info["sync"] if info.get("sync") is not None else range(n))
    moov = mp4.child(raw, 0, len(raw), b"moov")
    scale = None
    for typ, body, end in mp4.boxes(raw, *moov):
        mdia = typ == b"trak" and mp4.child(raw, body, end, b"mdia")
        hdlr = mdia and mp4.child(raw, *mdia, b"hdlr")
        if hdlr and raw[hdlr[0] + 8:hdlr[0] + 12] == b"vide":
            mdhd = mp4.child(raw, *mdia, b"mdhd")
            scale = mp4.full_box(raw, mdhd[0], "III")[2]
            break
    times = info["times"]
    first = min(times)
    return {"samples": samples, "key": [i in sync for i in range(n)],
            "times_ms": [round((t - first) * 1000 / scale) for t in times], "info": info,
            "fps": info["fps"], "width": info["width"], "height": info["height"]}


def length_units(sample: bytes, length: int) -> list[bytes]:
    out, pos = [], 0
    while pos < len(sample):
        size = int.from_bytes(sample[pos:pos + length], "big")
        out.append(sample[pos + length:pos + length + size])
        pos += length + size
    return out


def annexb_samples(clip: dict) -> list[bytes]:
    """The clip's length-prefixed samples as an Annex B byte stream each,
    the parameter sets in band before every IDR / IRAP picture, as x264 and
    x265 write them into AVI."""
    info = clip["info"]
    if info["codec"] == "h264":
        sps, pps, length = h264._avcc_units(info["avcC"], "clip")
        params = sps + pps

        def irap(units):
            return any(u[0] & 0x1F == 5 for u in units)
    else:
        params, length = hevc.hvcc_units(info["hvcC"], "clip")

        def irap(units):
            return any(16 <= hevc.nal_type(u) <= 23 for u in units)
    out = []
    for s in clip["samples"]:
        units = length_units(s, length)
        if irap(units):
            units = params + units
        out.append(b"".join(b"\x00\x00\x00\x01" + u for u in units))
    return out


def remux(name: str, kind: str, out, **options) -> Path:
    """The committed clip `name` (`CLIPS`) rewritten as Matroska ("mkv",
    `write_mkv`'s options passed on; DefaultDuration and Duration as FFmpeg
    writes them unless given) or as AVI of Annex B samples ("avi")."""
    clip = read_clip(CLIPS[name])
    info = clip["info"]
    if kind == "avi":
        return write_avi(out, annexb_samples(clip), clip["key"], clip["width"], clip["height"],
                         FOURCCS[info["codec"]], fps=round(clip["fps"]))
    frame_ns = int(1e9 / clip["fps"])
    private = info.get("avcC") or info.get("hvcC") or info.get("dsi") or b""
    options.setdefault("default_duration", frame_ns)
    options.setdefault("duration_ms", max(clip["times_ms"]) + frame_ns / 1e6)
    return write_mkv(out, clip["samples"], clip["key"], clip["times_ms"],
                     codec_id=CODEC_IDS[info["codec"]], width=clip["width"],
                     height=clip["height"], private=private, **options)


# the remuxes the corpus manifest holds: (file name, clip, kind)
REMUXES = [("clip_b.mkv", "clip_b", "mkv"), ("clip_mov.mkv", "clip_mov", "mkv"),
           ("clip_hevc.mkv", "clip_hevc", "mkv"), ("clip_hevc10.mkv", "clip_hevc10", "mkv"),
           ("clip_mp4v.mkv", "clip_mp4v", "mkv"), ("clip_b.avi", "clip_b", "avi"),
           ("clip_hevc.avi", "clip_hevc", "avi")]


def main(argv=None) -> int:
    import argparse
    import hashlib

    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("out", type=Path, help="the directory to write the remuxes into")
    args = ap.parse_args(argv)
    args.out.mkdir(parents=True, exist_ok=True)
    for file, clip, kind in REMUXES:
        path = remux(clip, kind, args.out / file)
        print(file, hashlib.sha256(path.read_bytes()).hexdigest())
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
