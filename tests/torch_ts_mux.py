"""A test muxer: MPEG transport streams (ISO/IEC 13818-1) of the access
units the tests give it, deterministic byte for byte, and the remuxes of the
committed corpus.

`write_ts` lays a file out as FFmpeg's `mpegts` muxer does: a PAT and a PMT
at the start and before every key frame, one PES an access unit on the
video PID with its PTS and DTS, a PCR in the adaptation field of each PES's
first packet, the last packet of a PES filled out with adaptation field
stuffing.  With the variants the port's reader must follow:

- `packet`: 188-byte packets (`.ts`), 192 (M2TS / AVCHD, a 4-byte
  TP_extra_header before each, and the PMT's `HDMV` registration, as a
  camcorder's `.mts` / `.m2ts` holds them) or 204 (16 parity bytes after);
- `group` access units in one PES, or each access unit split across
  `split` PES (the later pieces with no PTS);
- `pes_length`: PES_packet_length set, else 0 (FFmpeg's video PES);
- `no_pts`: the access units whose PES carries no PTS and no DTS;
- `audio`: an ADTS AAC PID listed first in the PMT, a silent frame after
  every video PES;
- `second`: a second program, its own PMT and video PID (another stream),
  listed after the first in the PAT; `second_first` writes its PMT and
  PES before the first's;
- `stream_type` and `descriptor`: the PMT entry of the video as given (a
  refused codec, 0x06 with a registration descriptor);
- `scrambled`: transport_scrambling_control set on every video packet;
- `drop`: the indices of the video PID's packets left out (a
  continuity-counter gap); `cut`: the file ends after that many bytes.

The times are 90 kHz ticks and wrap at 2**33, as the PES header holds them
(a first time stamp near 2**33 gives a wrap).  `annexb_aus` turns a clip's samples
into Annex B access units, with or without access unit delimiters.

`remux(name, out, **options)` rewrites a committed clip
(`torch_mkv_mux.CLIPS`) into a transport stream, with any of the variants.
Run as a script it writes the remuxes and variants `REMUXES` lists (those
`tests/data/mpegts/manifest.json` holds) into a directory and prints each
file's SHA-256.
"""

from __future__ import annotations

import struct
import sys
from pathlib import Path

HERE = Path(__file__).resolve().parent
for _path in (HERE.parent, HERE):       # the repo, and this directory for its sibling by name
    if str(_path) not in sys.path:
        sys.path.insert(0, str(_path))

# by its file's name, not through a `tests` package, which may be another one
from torch_mkv_mux import CLIPS, annexb_samples, read_clip  # noqa: E402

PID_PAT, PID_PMT, PID_PMT2 = 0x0000, 0x1000, 0x1001
PID_VIDEO, PID_AUDIO, PID_VIDEO2 = 0x0100, 0x0101, 0x0200
STREAM_TYPES = {"h264": 0x1B, "hevc": 0x24, "mpeg4": 0x10}
STREAM_IDS = {"video": 0xE0, "audio": 0xC0}
# an access unit delimiter of each codec (any picture type)
AUD = {"h264": b"\x00\x00\x00\x01\x09\xf0", "hevc": b"\x00\x00\x00\x01\x46\x01\x50"}
# a silent AAC-LC frame, 48 kHz mono, in ADTS: one SCE of no bands, then END
ADTS_SILENCE = bytes.fromhex("fff14c40017ffc00000007")
AAC_TICKS = 1920                          # 1,024 samples at 48 kHz, in 90 kHz ticks
FRAME_TICKS = 3000                        # a frame at 30 fps
PTS_BASE = 126000                         # FFmpeg's first DTS, 1.4 s
WRAP = 1 << 33


def crc32(data: bytes) -> int:
    """The CRC of MPEG-2 sections (polynomial 0x04C11DB7, no reflection)."""
    crc = 0xFFFFFFFF
    for b in data:
        crc ^= b << 24
        for _ in range(8):
            crc = (crc << 1) ^ 0x04C11DB7 if crc & 0x80000000 else crc << 1
            crc &= 0xFFFFFFFF
    return crc


def section(table_id: int, ext: int, body: bytes) -> bytes:
    """A long-form PSI section (version 0, current), with its CRC."""
    head = bytes([table_id]) + struct.pack(">HH", 0xB000 | (len(body) + 9), ext) + b"\xc1\x00\x00"
    sec = head + body
    return sec + struct.pack(">I", crc32(sec))


def pat(programs: list[tuple[int, int]]) -> bytes:
    return section(0x00, 1, b"".join(struct.pack(">HH", n, 0xE000 | pid) for n, pid in programs))


def pmt(number: int, pcr_pid: int, streams: list[tuple[int, int, bytes]],
        program_info: bytes = b"") -> bytes:
    body = struct.pack(">HH", 0xE000 | pcr_pid, 0xF000 | len(program_info)) + program_info
    for stream_type, pid, info in streams:
        body += bytes([stream_type]) + struct.pack(">HH", 0xE000 | pid, 0xF000 | len(info)) + info
    return section(0x02, number, body)


def registration(fourcc: bytes) -> bytes:
    """A registration descriptor (tag 5) of a format identifier."""
    return bytes([0x05, 4]) + fourcc


def timestamp(marker: int, t: int) -> bytes:
    t %= WRAP
    return bytes([marker << 4 | (t >> 29 & 0x0E) | 1, t >> 22 & 0xFF, (t >> 14 & 0xFE) | 1,
                  t >> 7 & 0xFF, (t << 1 & 0xFE) | 1])


def pes(stream_id: int, payload: bytes, pts: int | None, dts: int | None,
        length: bool) -> bytes:
    """A PES packet: its header (PTS, and DTS where it differs) and payload;
    PES_packet_length set where `length` and it fits, else 0."""
    if pts is None:
        flags, stamps = 0x00, b""
    elif dts is None or dts == pts:
        flags, stamps = 0x80, timestamp(2, pts)
    else:
        flags, stamps = 0xC0, timestamp(3, pts) + timestamp(1, dts)
    opt = bytes([0x80, flags, len(stamps)]) + stamps
    size = len(opt) + len(payload)
    return (b"\x00\x00\x01" + bytes([stream_id])
            + struct.pack(">H", size if length and size <= 0xFFFF else 0) + opt + payload)


class Packets:
    """The TS packets of a file, each 188 bytes, with the continuity counter
    of every PID."""

    def __init__(self):
        self.out: list[tuple[int, bytes]] = []          # (PID, packet)
        self.cc: dict[int, int] = {}

    def put(self, pid: int, data: bytes, pcr: int | None = None, scrambled: bool = False,
            psi: bool = False) -> None:
        """`data` (a PES packet, or a section after its pointer_field) in
        packets of `pid`, the first with payload_unit_start_indicator and
        the PCR (27 MHz) where given, the last filled out with stuffing."""
        if psi:                     # pointer_field 0, the section, 0xFF to the packet's end
            data = b"\x00" + data
            data += b"\xff" * (-len(data) % 184)
        first = True
        while first or data:
            adapt = b""
            if first and pcr is not None:
                base, ext = pcr // 300 % WRAP, pcr % 300
                adapt = bytes([0x10]) + struct.pack(">IH", base >> 1,
                                                    (base & 1) << 15 | 0x7E00 | ext)
            room = 184 - (len(adapt) + 1 if adapt else 0)
            if len(data) < room:                     # stuffing to fill the packet
                fill = 184 - len(data)
                if fill == 1 and not adapt:
                    adapt_field = b"\x00"
                else:
                    body = adapt or b"\x00"
                    body += b"\xff" * (fill - 1 - len(body))
                    adapt_field = bytes([len(body)]) + body
            else:
                adapt_field = bytes([len(adapt)]) + adapt if adapt else b""
            take = 184 - len(adapt_field)
            payload, data = data[:take], data[take:]
            cc = self.cc.get(pid, 0)
            self.cc[pid] = (cc + 1) & 15
            control = (0x30 if adapt_field else 0x10) | cc
            if scrambled:
                control |= 0xC0
            head = bytes([0x47, (0x40 if first else 0) | pid >> 8, pid & 0xFF, control])
            packet = head + adapt_field + payload
            assert len(packet) == 188, len(packet)
            self.out.append((pid, packet))
            first = False


def annexb_aus(clip: dict, aud: bool = False) -> list[bytes]:
    """A clip's samples as Annex B access units (the parameter sets before
    each IRAP picture), an access unit delimiter first in each where `aud`;
    MPEG-4 Part 2 samples as they are, its headers before the first."""
    info = clip["info"]
    if info["codec"] == "mpeg4":
        return [(info["dsi"] if k == 0 else b"") + s for k, s in enumerate(clip["samples"])]
    aus = annexb_samples(clip)
    return [AUD[info["codec"]] + au for au in aus] if aud else aus


def clip_times(clip: dict) -> tuple[list[int], list[int]]:
    """(PTS, DTS) of a clip's samples in 90 kHz ticks from PTS_BASE: each
    frame's presentation slot at its rate, the DTS the decoding order's,
    shifted back by the reordering depth as FFmpeg's muxers shift it."""
    step = round(90000 / clip["fps"])
    slots = [round(t * clip["fps"] / 1000) for t in clip["times_ms"]]
    shift = max(k - s for k, s in enumerate(slots))
    return ([PTS_BASE + shift * step + s * step for s in slots],
            [PTS_BASE + k * step for k in range(len(slots))])


def write_ts(path, aus: list[bytes], pts: list[int | None], dts: list[int | None], *,
             codec: str, packet: int = 188, group: int = 1, split: int = 1,
             pes_length: bool = False, no_pts: frozenset = frozenset(), audio: bool = False,
             second: dict | None = None, second_first: bool = False,
             stream_type: int | None = None, descriptor: bytes = b"", scrambled: bool = False,
             key: list[bool] | None = None, drop: frozenset = frozenset(),
             cut: int | None = None) -> Path:
    """A transport stream of one program (or two, `second` = {"aus", "pts",
    "dts", "codec"}) whose video is `aus` (access units in decoding order,
    Annex B or MPEG-4 Part 2 bytes) at the given times; see the module's
    docstring for the options.  `key` flags the access units a PAT and PMT
    go before, besides the first."""
    key = key or [k == 0 for k in range(len(aus))]
    hdmv = registration(b"HDMV") if packet == 192 else b""
    streams = [(stream_type if stream_type is not None else STREAM_TYPES[codec], PID_VIDEO,
                descriptor)]
    if audio:
        streams.insert(0, (0x0F, PID_AUDIO, b""))
    programs = [(1, PID_PMT)] + ([(2, PID_PMT2)] if second else [])
    tables = [(PID_PAT, pat(programs)), (PID_PMT, pmt(1, PID_VIDEO, streams, hdmv))]
    if second:
        table2 = (PID_PMT2, pmt(2, PID_VIDEO2, [(STREAM_TYPES[second["codec"]], PID_VIDEO2,
                                                 b"")]))
        tables.insert(1 if second_first else 2, table2)
    ps = Packets()
    audio_t = (dts[0] if dts[0] is not None else PTS_BASE) - 2 * AAC_TICKS

    def put_tables():
        for pid, table in tables:
            ps.put(pid, table, psi=True)

    def put_second(k):
        if second and k < len(second["aus"]):
            ps.put(PID_VIDEO2, pes(STREAM_IDS["video"], second["aus"][k], second["pts"][k],
                                   second["dts"][k], pes_length), pcr=second["dts"][k] * 300)

    # the PES packets of the video: (first access unit, payload, PTS, DTS)
    units = []
    for k in range(0, len(aus), group):
        body = b"".join(aus[k:k + group])
        t = (None, None) if k in no_pts else (pts[k], dts[k])
        if split > 1:
            step = -(-len(body) // split)
            for j in range(split):
                units.append((k, body[j * step:(j + 1) * step], *(t if j == 0 else (None, None))))
        else:
            units.append((k, body, *t))
    last = None
    for k, payload, p, d in units:
        if k != last and (key[k] or k == 0):
            put_tables()
        if second_first and k != last:
            put_second(k)
        at = d if d is not None else p
        ps.put(PID_VIDEO, pes(STREAM_IDS["video"], payload, p, d, pes_length),
               pcr=None if at is None else ((at - 9000) % WRAP) * 300, scrambled=scrambled)
        if not second_first and k != last:
            put_second(k)
        if audio and k != last:
            for _ in range(group):
                ps.put(PID_AUDIO, pes(STREAM_IDS["audio"], ADTS_SILENCE, audio_t, None, True))
                audio_t += AAC_TICKS
        last = k
    data = bytearray()
    video_index = 0
    for n, (pid, pk) in enumerate(ps.out):
        if pid == PID_VIDEO:
            video_index += 1
            if video_index - 1 in drop:
                continue
        if packet == 192:
            data += struct.pack(">I", (n * 2700) & 0x3FFFFFFF)     # copy 0, arrival time
        data += pk
        if packet == 204:
            data += bytes(16)
    path = Path(path)
    path.write_bytes(bytes(data[:cut]) if cut is not None else bytes(data))
    return path


def clip_stream(name: str, aud: bool = False, start: int = 0, pts_base: int | None = None
                ) -> dict:
    """The committed clip `name` (`torch_mkv_mux.CLIPS`) as `write_ts`'s
    access units, times, codec and key flags: from access unit `start` on
    (MPEG-4 Part 2's headers before the first), the first DTS at `pts_base`
    where given."""
    clip = read_clip(CLIPS[name])
    pts, dts = clip_times(clip)
    shift = 0 if pts_base is None else pts_base - dts[0]
    aus = annexb_aus(clip, aud)[start:]
    if start and clip["info"]["codec"] == "mpeg4":     # the headers before the first VOP
        aus[0] = clip["info"]["dsi"] + aus[0]
    return {"aus": aus, "pts": [t + shift for t in pts[start:]],
            "dts": [t + shift for t in dts[start:]], "codec": clip["info"]["codec"],
            "key": clip["key"][start:]}


def remux(name: str, out, aud: bool = False, start: int = 0, pts_base: int | None = None,
          second: str | None = None, no_pts=(), drop=(), cut: int | None = None,
          **options) -> Path:
    """The committed clip `name` rewritten as a transport stream, an access
    unit a PES at the clip's times, PAT and PMT before each key frame:
    `clip_stream`'s `aud`, `start` and `pts_base`; `second`, another clip
    as a second program; `cut` < 0 ends the file that many bytes early;
    `write_ts`'s other options passed on."""
    s = clip_stream(name, aud, start, pts_base)
    if second:
        options["second"] = clip_stream(second)
    if cut is not None and cut < 0:
        size = len(write_ts(out, s["aus"], s["pts"], s["dts"], codec=s["codec"], key=s["key"],
                            no_pts=frozenset(no_pts), drop=frozenset(drop),
                            **options).read_bytes())
        cut += size
    return write_ts(out, s["aus"], s["pts"], s["dts"], codec=s["codec"], key=s["key"],
                    no_pts=frozenset(no_pts), drop=frozenset(drop), cut=cut, **options)


# the remuxes and variants the corpus manifest holds: (file name, clip,
# remux's options); each file is deterministic byte for byte
REMUXES = [("clip_b.ts", "clip_b", {}),
           ("clip_b.m2ts", "clip_b", {"packet": 192, "aud": True, "audio": True}),
           ("clip_mov.ts", "clip_mov", {}), ("clip_hevc.ts", "clip_hevc", {}),
           ("clip_hevc10.ts", "clip_hevc10", {"aud": True}), ("clip_mp4v.ts", "clip_mp4v", {}),
           ("clip_b_204.ts", "clip_b", {"packet": 204, "pes_length": True}),
           ("clip_b_group3.ts", "clip_b", {"group": 3}),
           ("clip_hevc_group2.ts", "clip_hevc", {"group": 2, "audio": True}),
           ("clip_b_split2.mts", "clip_b", {"packet": 192, "split": 2, "no_pts": [4]}),
           ("clip_b_wrap.ts", "clip_b", {"pts_base": (1 << 33) - 4 * FRAME_TICKS}),
           ("clip_b_programs.ts", "clip_hevc", {"second": "clip_b", "second_first": True}),
           ("clip_mp4v_start_p.ts", "clip_mp4v", {"start": 2}),
           ("clip_hevc_start_rasl.ts", "clip_hevc", {"start": 1}),
           ("clip_b_gap.ts", "clip_b", {"drop": [2900]}),
           ("clip_b_cut.ts", "clip_b", {"cut": -20000 - 77})]


def main(argv=None) -> int:
    import argparse
    import hashlib

    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("out", type=Path, help="the directory to write the remuxes into")
    args = ap.parse_args(argv)
    args.out.mkdir(parents=True, exist_ok=True)
    for file, clip, options in REMUXES:
        path = remux(clip, args.out / file, **options)
        print(file, hashlib.sha256(path.read_bytes()).hexdigest())
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
