"""MPEG transport streams (ISO/IEC 13818-1: `.ts`, and M2TS / AVCHD's
`.mts` / `.m2ts`) read with the standard library and numpy: `index`, which
gives what `container.index` gives for the other containers: where each
frame of the first video stream lies and the stream's info, for the port's
codecs that a transport stream carries (H.264, HEVC, MPEG-4 Part 2, MPEG-1
/ MPEG-2); its parsers, rates and duration estimate serve `mpegps` too.

Read as FFmpeg's `mpegts` demuxer and its parsers read a file for cv2
(measured against cv2 5.0.0, libavformat 62):

- Packets: 188 bytes, 192 (a 4-byte TP_extra_header before each, M2TS) or
  204 (16 parity bytes after), the size FFmpeg's `get_packet_size` picks
  from the first 8 KiB (`packet_size`); a file is read as a transport
  stream only where FFmpeg's probe takes it for one (`probe`: 2,040 bytes at
  least, whatever the suffix).  A byte where a sync byte belongs makes the
  reader resync on the next 0x47 as `mpegts_resync` does; a packet cut by
  the end of the file is dropped.
- Programs: the PAT, then each program's PMT (the first section of each
  whose CRC holds, within the first 5,000,000 bytes: FFmpeg's header scan).
  Its streams are FFmpeg's in the order it meets the PMTs, and the video is
  the first one FFmpeg takes for video, as OpenCV takes the first video
  stream: stream type 0x1B (H.264), 0x24 (HEVC), 0x10 (MPEG-4 Part 2), 0x01
  / 0x02 (MPEG-1 / MPEG-2), or 0x06 with a registration descriptor `HEVC`.
  A first video stream of another codec (VC-1, VVC, AVS, Dirac, JPEG 2000,
  H.264 MVC, ...), scrambled packets, or no video raise
  `container.UnsupportedCodecError` naming it.
- PES: reassembled as `mpegts_push_data` does (a PES starts at
  payload_unit_start_indicator with 00 00 01; PES_packet_length set or 0;
  adaptation fields skipped).  The video's elementary stream is split into
  the frames FFmpeg's parser makes (`h264_parser`: a frame ends before an
  SEI, SPS, PPS or AUD after a slice, or before a slice whose
  first_mb_in_slice is not past the last one's; `hevc_parser`: before a
  VPS / SPS / PPS / AUD / EOS / prefix SEI after a slice, or before a slice
  with first_slice_segment_in_pic_flag; `mpeg4video_parser`: after a VOP,
  at the next start code; `mpegvideo_parser`: at the first start code
  after a picture's slices that is no slice, a field pair kept whole), not
  into PES payloads.  Each frame takes the PTS
  and DTS of the PES its first byte lies in, where that PES starts after the
  frame before begins (`ff_fetch_timestamp`), else none.  A frame is given
  as its offset and size in the elementary stream (`ElementaryStream` maps
  them to the file's packets; `container.read_sample` gathers them).
- Damage: a continuity counter that skips on the video's PID, or a packet
  with transport_error_indicator, marks the PES it falls in (or, at a PES
  start, the one before) damaged; so does the end of the file inside a PES
  of the video.  The frames of a damaged PES are in `info["damaged"]`: cv2
  decodes them with FFmpeg's error concealment, which the port does not
  copy, so reading one raises ValueError.
- fps and frame_count as cv2 reports them (`cv2_fps`, `estimate_duration`).

Times are 90 kHz ticks, wrapped at 2**33 as FFmpeg unwraps them (60 s
before a program's first time stamp).
"""

from __future__ import annotations

import math
from fractions import Fraction
from pathlib import Path

import numpy as np

from omfs4d_torch.io import matroska

SYNC = 0x47
TS_SIZE = 188
SIZES = (188, 192, 204)
PROBE_BUF = 8192                           # FFmpeg's PROBE_PACKET_MAX_BUF
RESYNC_SIZE = 65536
PROBESIZE = 5_000_000                      # FFmpeg's header scan, and find_stream_info's
WRAP_BITS = 33
TB = 90000                                 # the PES time base
DURATION_READ = 250_000                    # FFmpeg's DURATION_DEFAULT_MAX_READ_SIZE
DURATION_RETRY = 6
FPS_FRAMES = 20                            # find_stream_info's fps_analyze_framecount

# stream types of the codecs the port reads
READ = {0x1B: "h264", 0x24: "hevc", 0x10: "mpeg4", 0x01: "mpeg2", 0x02: "mpeg2"}
# FFmpeg's ISO_types / HDMV_types / MISC_types / REGD_types that are video,
# by name, and those that are audio
_VIDEO_NAMES = {0x20: "H.264 MVC (stream type 0x20)",
                0x21: "JPEG 2000", 0x33: "H.266 / VVC", 0x42: "AVS (Chinese AVS video)",
                0xD1: "Dirac", 0xD2: "AVS2", 0xD4: "AVS3", 0xEA: "VC-1"}
_REGD_VIDEO = {b"HEVC": "hevc", b"drac": "Dirac", b"VVC ": "H.266 / VVC", b"VC-1": "VC-1"}
_AUDIO = {0x03: "mp3", 0x04: "mp3", 0x0F: "aac", 0x11: "latm", 0x1C: "aac"}
_HDMV_AUDIO = {0x80: "pcm", 0x81: "ac3", 0x82: "dts", 0x83: "truehd", 0x84: "eac3",
               0x85: "dts", 0x86: "dts", 0xA1: "eac3", 0xA2: "dts"}
_MISC_AUDIO = {0x81: "ac3", 0x87: "eac3", 0x8A: "dts"}
_REGD_AUDIO = {b"AC-3": "ac3", b"AC-4": "ac4", b"BSSD": "s302m", b"DTS1": "dts", b"DTS2": "dts",
               b"DTS3": "dts", b"EAC3": "eac3", b"Opus": "opus"}
# DVB descriptors that make a stream of type 0x06 audio
_DVB_AUDIO = {0x6A: "ac3", 0x7A: "eac3", 0x7B: "dts"}
# PES stream_ids whose header is only the 6 bytes of start code and length
_NO_HEADER = {0xBC, 0xBE, 0xBF, 0xF0, 0xF1, 0xFF, 0xF2, 0xF8}


class Cut(Exception):
    """cv2 cannot open the file (no whole PAT, PMT or video frame in it)."""


# ── packets ─────────────────────────────────────────────────────────────

def _analyze(arr: np.ndarray, size: int, probe: bool = False) -> int:
    """FFmpeg's `analyze`: the count of sync bytes at the most common offset
    modulo `size`, less a tenth of those elsewhere past ten times it; with
    `probe`, only sync bytes whose packet has a payload or adaptation
    field."""
    sync = arr[:max(len(arr) - 3, 0)] == SYNC
    if probe:
        sync &= (arr[3:] & 0x30) != 0
    where = np.flatnonzero(sync)
    if not len(where):
        return 0
    stat = np.bincount(where % size, minlength=size)
    best = int(stat.max())
    return best - max(len(where) - 10 * best, 0) // 10


def packet_size(arr: np.ndarray) -> int | None:
    """The packet size FFmpeg's `get_packet_size` picks from the first
    PROBE_BUF bytes of `arr` (188, 192 or 204), None where it finds none."""
    head = arr[:PROBE_BUF]
    scores = [_analyze(head, s) for s in SIZES]
    margin = sorted(scores)[1]
    for size, score in zip(SIZES, scores):
        if score > margin:
            return size
    return None


def probe(head: bytes) -> bool:
    """Whether FFmpeg's `mpegts_probe` takes a file whose first bytes are
    `head` (2,048 of them, as it is first asked) for a transport stream: at
    least ten packets' room and more than six sync bytes in step."""
    arr = np.frombuffer(head[:2048], np.uint8)
    if len(arr) // 204 < 10:
        return False
    return max(_analyze(arr[:10 * size], size, probe=True) for size in SIZES) > 6


def walk(arr: np.ndarray, size: int, pos: int, end: int) -> tuple[np.ndarray, np.ndarray]:
    """The positions of the TS packets (their sync bytes) FFmpeg reads from
    byte `pos` of a file of packets of `size`, to `end`: in step, then on
    each byte that should be a sync byte and is not, `mpegts_resync`'s scan
    for the next one (a packet read from there, whatever it holds); a
    packet cut by `end` is dropped.  Returns the positions and which packets
    are suspect: the last one in step before a resync (bytes may have come
    into it) and each one a resync found (it may be no packet)."""
    lead = 4 if size == 192 else 0
    runs, suspect = [], []
    while True:
        p = pos + lead
        if p + TS_SIZE > end:
            break
        if arr[p] == SYNC:
            n = (end - TS_SIZE - p) // size + 1
            bad = np.flatnonzero(arr[p:p + (n - 1) * size + 1:size] != SYNC)
            k = int(bad[0]) if len(bad) else n
            runs.append(p + size * np.arange(k, dtype=np.int64))
            flags = np.zeros(k, bool)
            if k < n:
                flags[-1] = True
            suspect.append(flags)
            pos = p + k * size - lead
            continue
        after = p + TS_SIZE
        if arr[p] == 0x80 and arr[p + 12] == SYNC:
            q = p + 12                               # a 12-byte header before the packet
        else:
            scan = after - min(size, after)
            hits = np.flatnonzero(arr[scan:min(scan + RESYNC_SIZE, end)] == SYNC)
            if not len(hits):
                break
            q = scan + int(hits[0])
            new = packet_size(arr[q:q + PROBE_BUF])
            if new:
                size, lead = new, 4 if new == 192 else 0
        if q + TS_SIZE > end:
            break
        runs.append(np.array([q], np.int64))
        suspect.append(np.ones(1, bool))
        pos = q + size - lead
    if not runs:
        return np.zeros(0, np.int64), np.zeros(0, bool)
    return np.concatenate(runs), np.concatenate(suspect)


class Packets:
    """The header fields of the packets `walk` found (numpy arrays): PID,
    payload_unit_start_indicator, transport_error_indicator,
    transport_scrambling_control, adaptation_field_control, continuity
    counter, discontinuity_indicator, and the payload's start and length."""

    def __init__(self, arr: np.ndarray, walked: tuple[np.ndarray, np.ndarray]):
        starts, self.suspect = walked
        self.starts = starts
        b1, b2, b3 = (arr[starts + k].astype(np.int64) for k in (1, 2, 3))
        self.pid = (b1 & 0x1F) << 8 | b2
        self.pusi = (b1 & 0x40) != 0
        self.tei = (b1 & 0x80) != 0
        self.scrambled = b3 >> 6
        self.afc = b3 >> 4 & 3
        self.cc = b3 & 15
        adapt = (self.afc & 2) != 0
        alen = arr[starts + 4].astype(np.int64)
        self.discontinuity = adapt & (alen > 0) & ((arr[starts + 5] & 0x80) != 0)
        self.payload = starts + 4 + np.where(adapt, alen + 1, 0)
        has = ((self.afc & 1) != 0) & (self.payload < starts + TS_SIZE)
        self.length = np.where(has, starts + TS_SIZE - self.payload, 0)

    def of(self, pid: int) -> np.ndarray:
        """The indices of the packets of `pid` that FFmpeg handles (not of
        adaptation_field_control 0)."""
        return np.flatnonzero((self.pid == pid) & (self.afc != 0))


# ── tables ──────────────────────────────────────────────────────────────

def _crc_table() -> list[int]:
    table = []
    for i in range(256):
        c = i << 24
        for _ in range(8):
            c = (c << 1) ^ 0x04C11DB7 if c & 0x80000000 else c << 1
        table.append(c & 0xFFFFFFFF)
    return table


_CRC = _crc_table()


def crc32(data: bytes) -> int:
    """The CRC of MPEG-2 sections (0 over a section and its CRC)."""
    c = 0xFFFFFFFF
    for b in data:
        c = (c << 8 & 0xFFFFFFFF) ^ _CRC[(c >> 24) ^ b]
    return c


def _sections(buf, pk: Packets, idx: np.ndarray, table_id: int):
    """The whole sections of `table_id` carried in the packets `idx` (one
    PID), in order, their CRC checked."""
    data, started = b"", False
    for k in idx:
        o, n = int(pk.payload[k]), int(pk.length[k])
        if not n:
            continue
        chunk = bytes(buf[o:o + n])
        if pk.pusi[k]:
            pointer = chunk[0]
            if started:
                data += chunk[1:1 + pointer]
                yield from _complete(data, table_id)
            data, started = chunk[1 + pointer:], True
        elif started:
            data += chunk
        for sec in _complete(data, table_id):
            yield sec
            data = data[3 + (int.from_bytes(sec[1:3], "big") & 0xFFF):]


def _complete(data: bytes, table_id: int):
    """The first section of `data` where it is whole, of `table_id` and its
    CRC right."""
    if len(data) >= 3 and data[0] == table_id:
        n = 3 + (int.from_bytes(data[1:3], "big") & 0xFFF)
        if len(data) >= n and crc32(data[:n]) == 0:
            yield data[:n]


def _descriptors(data: bytes) -> list[tuple[int, bytes]]:
    out, pos = [], 0
    while pos + 2 <= len(data):
        tag, n = data[pos], data[pos + 1]
        out.append((tag, data[pos + 2:pos + 2 + n]))
        pos += 2 + n
    return out


def _kind(stream_type: int, descriptors: list, hdmv: bool) -> tuple[str, str]:
    """(video / audio / other, codec) FFmpeg gives a PMT entry."""
    regd = next((body[:4] for tag, body in descriptors if tag == 0x05 and len(body) >= 4), None)
    if stream_type in READ:
        return "video", READ[stream_type]
    if stream_type in _VIDEO_NAMES:
        return "video", _VIDEO_NAMES[stream_type]
    if stream_type in _AUDIO:
        return "audio", _AUDIO[stream_type]
    if hdmv and stream_type in _HDMV_AUDIO:
        return "audio", _HDMV_AUDIO[stream_type]
    if stream_type in _MISC_AUDIO:
        return "audio", _MISC_AUDIO[stream_type]
    if regd in _REGD_VIDEO:
        return "video", _REGD_VIDEO[regd]
    if regd in _REGD_AUDIO:
        return "audio", _REGD_AUDIO[regd]
    if stream_type == 0x06:
        for tag, _ in descriptors:
            if tag in _DVB_AUDIO:
                return "audio", _DVB_AUDIO[tag]
        if not descriptors:
            return "probed", "a private stream (stream type 0x06) FFmpeg types by its content"
    return "other", f"stream type {stream_type:#04x}"


def _looks_like_video(head: bytes) -> bool:
    """Whether a PES payload starts as an H.264, HEVC or MPEG-4 Part 2
    elementary stream does (a start code and a parameter set, delimiter or
    VOS / VO / VOL header), which FFmpeg's probe of a private stream's
    content would take for video."""
    at = head.find(b"\x00\x00\x01")
    if at < 0 or at + 4 >= len(head):
        return False
    b = head[at + 3]
    return (not b & 0x80 and (b & 0x1F in (7, 9) or b >> 1 & 0x3F in (32, 33, 35))) or \
        b in (0xB0, 0xB5) or 0x20 <= b <= 0x2F


def programs(buf, pk: Packets, path) -> list[dict]:
    """FFmpeg's streams: each program's PMT entries ({"pid", "type",
    "kind", "codec", "program"}), the programs in the order their PMTs come
    within the header scan."""
    scan = pk.starts < PROBESIZE
    pat = next(_sections(buf, pk, np.flatnonzero(scan & (pk.pid == 0) & (pk.afc != 0)), 0x00),
               None)
    if pat is None:
        raise Cut(f"{path}: a transport stream with no whole PAT")
    pmts = {}
    body = pat[8:-4]
    for k in range(0, len(body) - 3, 4):
        number, pid = int.from_bytes(body[k:k + 2], "big"), int.from_bytes(body[k + 2:k + 4],
                                                                          "big") & 0x1FFF
        if number:
            pmts.setdefault(pid, number)
    found = []
    for pid, number in pmts.items():
        idx = np.flatnonzero(scan & (pk.pid == pid) & (pk.afc != 0))
        for sec in _sections(buf, pk, idx, 0x02):
            if int.from_bytes(sec[3:5], "big") == number:
                found.append((int(pk.starts[idx[0]]) if len(idx) else 0, number, sec))
                break
    streams = []
    for _, number, sec in sorted(found, key=lambda f: f[0]):
        info_len = int.from_bytes(sec[10:12], "big") & 0xFFF
        prog = _descriptors(sec[12:12 + info_len])
        hdmv = any(tag == 0x05 and body[:4] == b"HDMV" for tag, body in prog)
        pos, end = 12 + info_len, len(sec) - 4
        while pos + 5 <= end:
            stype = sec[pos]
            pid = int.from_bytes(sec[pos + 1:pos + 3], "big") & 0x1FFF
            n = int.from_bytes(sec[pos + 3:pos + 5], "big") & 0xFFF
            desc = _descriptors(sec[pos + 5:pos + 5 + n])
            kind, codec = _kind(stype, desc, hdmv)
            if not any(s["pid"] == pid for s in streams):
                streams.append({"pid": pid, "type": stype, "kind": kind, "codec": codec,
                                "program": number})
            pos += 5 + n
    if not found:
        raise Cut(f"{path}: a transport stream with no whole PMT")
    return streams


# ── PES ─────────────────────────────────────────────────────────────────

def _stamp(b: bytes) -> int:
    """A PES time stamp (`ff_parse_pes_pts`: no marker check)."""
    return (b[0] & 0x0E) << 29 | (int.from_bytes(b[1:3], "big") >> 1) << 15 | \
        int.from_bytes(b[3:5], "big") >> 1


def pes_packets(buf, pk: Packets, idx: np.ndarray, pieces: bool = False) -> list[dict]:
    """The PES packets of one PID (the packets `idx`) as `mpegts_push_data`
    emits them: {"pts", "dts" (None where absent), "size" (payload bytes),
    "emit" (the file position at which FFmpeg hands it on), "damaged",
    "open" (the file ended in it), "head" (its payload's first 64 bytes), and
    with `pieces` "pieces": (file offset, length) of its payload}.  A PES
    starts at a packet with payload_unit_start_indicator and 00 00 01, its
    header read across packets where it runs past the first; other packets
    are skipped until one does."""
    out: list[dict] = []
    state, cur, hdr, last_cc = _SKIP, None, b"", -1
    for k in idx:
        length = int(pk.length[k])
        cc = int(pk.cc[k])
        expected = (last_cc + 1) & 15 if length else last_cc
        bad = bool(pk.tei[k] or pk.suspect[k]) or (
            last_cc >= 0 and expected != cc and not pk.discontinuity[k])
        last_cc = cc
        pos = int(pk.starts[k])
        if bad:
            if not pk.pusi[k] and cur is not None:
                cur["damaged"] = True
            elif cur is not None and state == _PAYLOAD and cur["size"]:
                cur["damaged"] = True
            elif out:
                out[-1]["damaged"] = True
        if not length:
            continue
        o = int(pk.payload[k])
        if pk.pusi[k]:
            if state == _PAYLOAD and cur is not None:
                _emit(cur, pos, out)
            state, hdr = _HEADER, b""
            cur = {"pts": None, "dts": None, "length": 0, "header": 6, "size": 0,
                   "damaged": False, "open": False, "head": b"",
                   "pieces": [] if pieces else None}
        while length and state != _SKIP:
            if state == _PAYLOAD:
                cur["size"] += length
                if len(cur["head"]) < 64:
                    cur["head"] += bytes(buf[o:o + min(length, 64)])
                if pieces:
                    cur["pieces"].append((o, length))
                length = 0
                if cur["length"] and cur["header"] + cur["size"] == cur["length"] + 6:
                    _emit(cur, pos, out)
                    state, cur = _SKIP, None
                break
            want = {_HEADER: 6, _PESHEADER: 9}.get(state, cur["header"])
            take = min(want - len(hdr), length)
            hdr += bytes(buf[o:o + take])
            o, length = o + take, length - take
            if len(hdr) < want:
                break
            if state == _HEADER:
                if hdr[:3] != b"\x00\x00\x01":
                    state = _SKIP
                    break
                cur["length"] = int.from_bytes(hdr[4:6], "big")
                state = _PAYLOAD if hdr[3] in _NO_HEADER else _PESHEADER
            elif state == _PESHEADER:
                cur["header"], state = 9 + hdr[8], _FILL
            else:
                flags = hdr[7]
                if flags & 0xC0 == 0x80 and len(hdr) >= 14:
                    cur["pts"] = cur["dts"] = _stamp(hdr[9:14])
                elif flags & 0xC0 == 0xC0 and len(hdr) >= 19:
                    cur["pts"], cur["dts"] = _stamp(hdr[9:14]), _stamp(hdr[14:19])
                state = _PAYLOAD
    if state == _PAYLOAD and cur is not None:
        cur["open"] = True
        _emit(cur, int(pk.starts[idx[-1]]) + TS_SIZE, out)
    return out


_SKIP, _HEADER, _PESHEADER, _FILL, _PAYLOAD = range(5)


def _emit(pes: dict, pos: int, out: list) -> None:
    """Hand a PES on at file position `pos`, as `new_pes_packet` does: one
    with no payload is dropped; one shorter than its PES_packet_length is
    damaged."""
    if pes["size"] > 0:
        pes["emit"] = pos
        if pes["length"] and pes["header"] + pes["size"] < pes["length"] + 6:
            pes["damaged"] = True
        out.append(pes)


# ── the parsers: the elementary stream split into frames ────────────────

def _first_mb(data: bytes) -> int | None:
    """first_mb_in_slice as `h264_find_frame_end` reads it from the bytes
    after a slice's NAL header (emulation prevention left in): from the
    first bytes that hold its Exp-Golomb code with a bit to spare, or from
    six; None while fewer have come."""
    for k in range(1, min(len(data), 6) + 1):
        bits, width = int.from_bytes(data[:k], "big"), 8 * k
        code = 2 * (width - bits.bit_length()) + 1
        if code < width or k == 6:
            return (bits >> max(width - code, 0)) - 1
    return None


class Splitter:
    """FFmpeg's frame boundaries (`h264_find_frame_end`,
    `hevc_find_frame_end`, `ff_mpeg4_find_frame_end`,
    `ff_mpeg1_find_frame_end`) in an elementary stream fed in pieces
    (`feed`, then `end`): `starts` holds the offset of each frame's first
    byte; for MPEG-1 / MPEG-2 video `pictures` the offset of each picture
    start code at which the parser fetches a frame's time stamps (the
    frame's first picture)."""

    def __init__(self, codec: str):
        self.codec = codec
        self.data, self.base, self.scan = b"", 0, 0
        self.found = False
        self.last_mb = 0
        self.starts = [0]
        self.state = 0                        # mpegvideo's frame_start_found
        self.pictures: list[int] = []

    def feed(self, chunk: bytes, final: bool = False) -> None:
        self.data += chunk
        data, need = self.data, {"h264": 10, "hevc": 6, "mpeg4": 4, "mpeg2": 7}[self.codec]
        while True:
            s = data.find(b"\x00\x00\x01", self.scan)
            if s < 0:
                self.scan = max(len(data) - 2, self.scan)
                break
            if s + need > len(data) and not final:
                self.scan = s
                break
            self._code(data, s)
            self.scan = s + 3
        keep = max(min(self.scan, len(data)) - 1, 0)
        if keep > 0:
            self.data, self.base, self.scan = data[keep:], self.base + keep, self.scan - keep

    def _boundary(self, data: bytes, s: int) -> None:
        b = s - 1 if s > 0 and data[s - 1] == 0 else s
        if self.base + b > self.starts[-1]:
            self.starts.append(self.base + b)

    def _code(self, data: bytes, s: int) -> None:
        if s + 3 >= len(data):
            return
        h = data[s + 3]
        if self.codec == "h264":
            t = h & 0x1F
            if t in (6, 7, 8, 9):
                if self.found:
                    self._boundary(data, s)
                    self.found = False
            elif t in (1, 2, 5):
                mb = _first_mb(data[s + 4:s + 10])
                if mb is None:
                    return
                if self.found and mb <= self.last_mb:
                    self._boundary(data, s)
                self.found, self.last_mb = True, mb
        elif self.codec == "hevc":
            if s + 5 >= len(data):
                return
            nut = h >> 1 & 0x3F
            if ((h & 1) << 5 | data[s + 4] >> 3) > 0:
                return
            if 32 <= nut <= 37 or nut == 39 or 41 <= nut <= 44 or 48 <= nut <= 55:
                if self.found:
                    self._boundary(data, s)
                    self.found = False
            elif (nut <= 9 or 16 <= nut <= 21) and data[s + 5] >> 7:
                if self.found:
                    self._boundary(data, s)
                self.found = True
        elif self.codec == "mpeg2":
            self._mpeg2(data, s, h)
        else:
            if not self.found:
                self.found = h == 0xB6
            elif h not in (0xB7, 0xB8):                  # a frame ends at any other start code
                if self.base + s > self.starts[-1]:
                    self.starts.append(self.base + s)
                self.found = h == 0xB6

    def _mpeg2(self, data: bytes, s: int, h: int) -> None:
        """`ff_mpeg1_find_frame_end` at the start code at s: a frame ends at
        the first start code after its slices that is no slice (or after a
        sequence end code), where the picture coding extension does not
        show it to be a field pair's first field."""
        slice_code = 0x01 <= h <= 0xAF
        if self.state == 4 and not slice_code and h != 0xB7:
            if self.base + s > self.starts[-1]:
                self.starts.append(self.base + s)
            self.state = 0
        if self.state == 0 and slice_code:
            self.state = 4
        elif h == 0xB7:                                  # sequence end: the frame ends after it
            self.state = 0
            if self.base + s + 4 > self.starts[-1]:
                self.starts.append(self.base + s + 4)
            return
        if self.state == 2 and h == 0xB3:
            self.state = 0
        if self.state < 4 and h == 0xB5:
            self.state += 1
            if s + 6 < len(data):
                if data[s + 4] & 0xF0 != 0x80:
                    self.state -= 1
                elif data[s + 6] & 3 == 3:
                    self.state = 0
                else:
                    self.state = (self.state + 1) & 3
        if self.state == 0 and h == 0x00:
            self.pictures.append(self.base + s)

    def end(self, total: int) -> list[tuple[int, int]]:
        """(offset, size) of every frame of a stream of `total` bytes."""
        self.feed(b"", final=True)
        bounds = [b for b in self.starts if b < total] + [total]
        return [(a, b - a) for a, b in zip(bounds, bounds[1:]) if b > a]

    def stamp_at(self, frames: list[tuple[int, int]]) -> list[int]:
        """The offset at which the parser fetches each frame's time stamps:
        its first byte, or for MPEG-1 / MPEG-2 video its first picture start
        code (`ff_fetch_timestamp` from `ff_mpeg1_find_frame_end`)."""
        if self.codec != "mpeg2":
            return [o for o, _ in frames]
        out, j = [], 0
        for o, n in frames:
            while j < len(self.pictures) and self.pictures[j] < o:
                j += 1
            out.append(self.pictures[j] if j < len(self.pictures) and
                       self.pictures[j] < o + n else o)
        return out


class ElementaryStream:
    """Where the bytes of the video's elementary stream lie in the file:
    the payload pieces of its PES packets, in order (`offsets` and
    `lengths` of each in the file, `at` where each starts in the stream);
    `read` gathers a frame's bytes from them."""

    def __init__(self, offsets: np.ndarray, lengths: np.ndarray):
        self.offsets, self.lengths = offsets, lengths
        self.at = np.concatenate([[0], np.cumsum(lengths)[:-1]]).astype(np.int64) \
            if len(lengths) else np.zeros(0, np.int64)
        self.total = int(lengths.sum()) if len(lengths) else 0

    def read(self, f, offset: int, size: int) -> bytes:
        """The `size` bytes of the stream from `offset`, read from the file
        open as f."""
        first = int(np.searchsorted(self.at, offset, "right")) - 1
        last = int(np.searchsorted(self.at, offset + size - 1, "right")) - 1
        lo = int(self.offsets[first])
        f.seek(lo)
        span = f.read(int(self.offsets[last] + self.lengths[last]) - lo)
        parts = []
        for k in range(first, last + 1):
            a = int(self.offsets[k]) - lo
            skip = offset - int(self.at[k]) if k == first else 0
            stop = min(int(self.lengths[k]), offset + size - int(self.at[k]))
            parts.append(span[a + skip:a + stop])
        return b"".join(parts)

    def file_pos(self, offset: int) -> int:
        """The file position of byte `offset` of the stream."""
        k = int(np.searchsorted(self.at, offset, "right")) - 1
        return int(self.offsets[k]) + offset - int(self.at[k])

    def chunk(self, buf, first: int, last: int) -> bytes:
        """The bytes of pieces first..last-1 from the mapped file."""
        return b"".join(buf[int(o):int(o) + int(n)]
                        for o, n in zip(self.offsets[first:last], self.lengths[first:last]))


# ── time stamps, fps and duration as cv2 reports them ───────────────────

class Wrap:
    """FFmpeg's unwrapping of a program's 33-bit time stamps
    (`update_wrap_reference` / `wrap_timestamp`): from its first stamp
    `ref`, a stamp more than 60 s before it is after a wrap (+2**33), or,
    where `ref` lies within 60 s of the wrap, one at or after 60 s before it
    is before the wrap (-2**33)."""

    def __init__(self, ref: int | None):
        self.ref = None if ref is None else ref - 60 * TB
        self.add = ref is not None and ref < (1 << WRAP_BITS) - 60 * TB

    def __call__(self, t: int | None) -> int | None:
        if t is None or self.ref is None:
            return t
        if self.add and t < self.ref:
            return t + (1 << WRAP_BITS)
        if not self.add and t >= self.ref:
            return t - (1 << WRAP_BITS)
        return t


def codec_rate(codec: str, head: bytes) -> Fraction | None:
    """The frame rate FFmpeg's parser gives the codec context from the
    stream's first headers (`head`, the start of the elementary stream):
    H.264's VUI timing (time_scale / (2 num_units_in_tick)), HEVC's VPS
    timing, else its VUI's (time_scale / num_units_in_tick), MPEG-4 Part 2's
    VOL (time_increment_resolution over the fixed increment, else 1)."""
    from omfs4d_torch.io import h264, hevc, mpeg2, mpeg4

    if codec == "mpeg2":
        return mpeg2.parse_headers(head)["rate"] if b"\x00\x00\x01\xb3" in head else None
    if codec == "h264":
        sps = [u for u in h264.annexb_units(head) if u and u[0] & 0x1F == 7]
        return h264.parse_sps(sps[0]).get("rate") if sps else None
    if codec == "hevc":
        units = [u for u in hevc.annexb_units(head) if len(u) > 2 and hevc.nuh_layer_id(u) == 0]
        vps = [u for u in units if hevc.nal_type(u) == hevc.NAL_VPS]
        sps = [u for u in units if hevc.nal_type(u) == hevc.NAL_SPS]
        rate = hevc.vps_rate(vps[0]) if vps else None
        return rate or (hevc.parse_sps(sps[0]).get("rate") if sps else None)
    vop = head.find(mpeg4.VOP)
    if vop < 0:
        return None
    p = mpeg4.parse_headers(head[:vop])
    return Fraction(p["time_resolution"], p["fixed_increment"] or 1) \
        if p["time_resolution"] else None


def _safe_rate(codec: str, head: bytes) -> Fraction | None:
    """`codec_rate`, None where the headers do not parse or hold what the
    port's readers refuse (interlaced H.264, which FFmpeg's parser times by
    fields: the reader refuses the stream when it is opened), or the codec
    is one the port does not read."""
    try:
        return codec_rate(codec, head) if codec in READ.values() else None
    except (ValueError, IndexError, RuntimeError):      # RuntimeError: UnsupportedCodecError
        return None


def cv2_fps(codec: str, dts: list[int | None], rate: Fraction | None) -> tuple[Fraction, Fraction]:
    """FFmpeg's (avg_frame_rate, r_frame_rate) of the video after
    `avformat_find_stream_info`, from the decoding times of the frames it
    read (`dts`, 90 kHz, None where a frame has none) and the codec's rate
    (`codec_rate`); cv2's CAP_PROP_FPS is the first that is not 0.

    As measured against cv2 5.0.0: H.264 and HEVC (and MPEG-4 Part 2 of a
    rate under 5 or from 101) have a time base FFmpeg takes as unreliable,
    so r_frame_rate is `matroska.rfps` over the frames' decoding times;
    MPEG-4 Part 2 of a VOL rate in [5, 101) keeps that rate.  Each frame
    from the third on has a duration of floor(90,000 / the codec's rate)
    ticks where the codec gives a rate, and avg_frame_rate is then their
    average, snapped to a standard rate within 1% (the codec's own rate
    weighed too: mpegts prefers it); with no duration it is r_frame_rate
    where the intervals average to it.
    Where no rate is found, r_frame_rate is the codec's (an H.264 stream's
    doubled, as FFmpeg counts its fields), else 90,000."""
    zero = Fraction(0)
    mul = 2 if codec == "h264" else 1
    if codec == "mpeg4" and rate is not None and 5 <= rate < 101:
        return zero, rate
    step = 0
    if rate and rate.denominator * 1000 > rate.numerator:
        step = TB * rate.denominator // rate.numerator
    info_duration = step * max(len(dts) - 2, 0)
    avg = zero
    r, count, dur_sum = matroska.rfps(dts, TB, info_duration)
    if r and not info_duration and count > 2 and abs(TB / r - dur_sum / count) <= 1.0:
        avg = r
    if info_duration:
        raw = matroska.av_reduce(TB, step, 60000)
        best, num = 0.01, 0
        for j in range(matroska._N_STD):
            std = Fraction(matroska._std_rate(j), 12 * 1001)
            for cand in (raw, rate) if rate else (raw,):
                error = abs(float(cand) / float(std) - 1)
                if error < best:
                    best, num = error, matroska._std_rate(j)
        avg = matroska.av_reduce(num, 12 * 1001, 2**31 - 1) if num else raw
    if not r:
        fr = rate * mul if rate else None
        r = fr if fr and fr <= TB else Fraction(TB)
    return avg, r


def _audio_ticks(codec: str, head: bytes) -> int:
    """The duration in 90 kHz ticks FFmpeg gives a PES of an audio stream
    it reads no parser for (`av_get_audio_frame_duration2`: a frame's
    samples over the rate, read from the first frame's header); 0 for a
    codec the port does not weigh (PCM, DTS, TrueHD, LATM, Opus, ...)."""
    if codec == "aac" and len(head) >= 7 and head[0] == 0xFF and head[1] & 0xF0 == 0xF0:
        rates = (96000, 88200, 64000, 48000, 44100, 32000, 24000, 22050, 16000, 12000, 11025,
                 8000, 7350)
        index = head[2] >> 2 & 15
        return TB * 1024 // rates[index] if index < len(rates) else 0
    if codec == "mp3" and len(head) >= 4 and head[0] == 0xFF and head[1] & 0xE0 == 0xE0:
        version, layer, index = head[1] >> 3 & 3, head[1] >> 1 & 3, head[2] >> 2 & 3
        if layer == 0 or version == 1 or index == 3:
            return 0
        rate = (44100, 48000, 32000)[index] >> {3: 0, 2: 1, 0: 2}[version]
        samples = 384 if layer == 3 else 1152 if layer == 2 or version == 3 else 576
        return TB * samples // rate
    if codec in ("ac3", "eac3") and len(head) >= 6 and head[:2] == b"\x0b\x77":
        if head[5] >> 3 <= 10:                                    # AC-3
            index = head[4] >> 6
            return TB * 1536 // (48000, 44100, 32000)[index] if index < 3 else 0
        code = head[4] >> 6                                       # E-AC-3
        if code == 3:
            return TB * 1536 // (24000, 22050, 16000, 0)[head[4] >> 4 & 3] \
                if head[4] >> 4 & 3 < 3 else 0
        blocks = (1, 2, 3, 6)[head[4] >> 4 & 3]
        return TB * 256 * blocks // (48000, 44100, 32000)[code]
    return 0


def _rescale(t: int) -> int:
    """90 kHz ticks to microseconds, rounded half away from 0 as
    av_rescale_q rounds."""
    if t < 0:
        return -_rescale(-t)
    return (t * 1_000_000 + TB // 2) // TB


def duration_us(streams: list[dict]) -> int:
    """The file's duration as FFmpeg's `update_stream_timings` makes it, in
    microseconds, from each audio / video stream's {"start" (its first time
    stamp), "duration" (of `estimate_timings_from_pts`), "group" (its
    program where the file has several, else one for all)}: the latest end
    less the earliest start of each group, and at least every stream's own
    duration."""
    spans = [s for s in streams if s["start"] is not None]
    best = max((_rescale(s["duration"]) for s in spans if s["duration"] is not None),
               default=None)
    groups: dict[int, list] = {}
    for s in spans:
        groups.setdefault(s["group"], []).append(s)
    for group in groups.values():
        start = min(_rescale(s["start"]) for s in group)
        ends = [_rescale(s["start"]) + _rescale(s["duration"]) for s in group
                if s["duration"] is not None]
        if ends and max(ends) >= start:
            span = max(ends) - start
            best = span if best is None else max(best, span)
    return best or 0


def frame_count(seconds: float, fps: float) -> int:
    """OpenCV's CAP_PROP_FRAME_COUNT where the container counts no frames:
    floor(duration x fps + 0.5)."""
    return int(math.floor(seconds * fps + 0.5))


# ── the API ─────────────────────────────────────────────────────────────

def _first_stamp(pes: list[dict]) -> tuple[int, int] | None:
    """(emission position, stamp) of the first PES FFmpeg hands on with a
    time stamp (its DTS, else its PTS)."""
    for p in pes:
        t = p["dts"] if p["dts"] is not None else p["pts"]
        if t is not None:
            return p["emit"], t
    return None


def _tail_durations(arr, buf, size: int, streams: list[dict], wraps: dict) -> None:
    """Each audio / video stream's "duration" as `estimate_timings_from_pts`
    finds it: the latest PTS plus a frame's duration, less its start, over
    the PES read from 250,000 bytes before the end (more, up to 6 times,
    while no stream has one), as FFmpeg reads them after a seek."""
    end = len(arr)
    found = False
    for s in streams:
        s["duration"], s["last"] = None, 0
    retry = 0
    while True:
        is_end = found
        offset = max(end - (DURATION_READ << retry), 0)
        pk = Packets(arr, walk(arr, size, offset, end))
        packets = []
        for s in streams:
            if s["start"] is None:
                continue
            for p in pes_packets(buf, pk, pk.of(s["pid"])):
                packets.append((p["emit"], p["size"], p["pts"], s))
        packets.sort(key=lambda q: q[0])
        read, limit = 0, DURATION_READ << max(retry - 1, 0)
        for _, n, pts, s in packets:
            if read >= limit:
                break
            read += n
            if pts is None:
                continue
            found = True
            d = wraps[s["program"]](pts) + s["ticks"] - s["start"]
            if d > 0:
                if s["duration"] is None or s["last"] <= 0 or (
                        s["duration"] < d and abs(d - s["last"]) < 60 * TB):
                    s["duration"] = d
                s["last"] = d
        if not is_end:
            is_end = all(s["duration"] is not None for s in streams)
        retry += 1
        if is_end or not offset or retry > DURATION_RETRY:
            return


def index(buf, path: Path) -> tuple[list[int], list[int], dict]:
    """(frame offsets, frame sizes, info) of the first video stream of a
    transport stream: the offsets are in its elementary stream, which
    `info["es"]` (an `ElementaryStream`) maps to the file; info holds width
    and height 0 (the codec's headers give them), fps, frame_count,
    container "mpegts", the codec's keys in Annex B form (`codec`, and for
    H.264 / HEVC `annexb` b"", their restarts found in band by the reader;
    for MPEG-4 Part 2 `dsi` b"", its headers in band), `times` (the frames'
    PTS where each has one), `damaged` (the frames of damaged PES) and
    `packet_size`.  A codec the port does not read raises
    `UnsupportedCodecError`; a file cv2 cannot open raises `Cut`."""
    from omfs4d_torch.io import container

    arr = np.frombuffer(buf, np.uint8)
    size = packet_size(arr)
    if size is None:
        raise Cut(f"{path}: no packet size of a transport stream fits its first bytes")
    pk = Packets(arr, walk(arr, size, 0, len(arr)))
    streams = programs(buf, pk, path)
    for s in streams:                    # private streams FFmpeg finds video in
        if s["kind"] == "probed":
            leading = pes_packets(buf, pk, pk.of(s["pid"])[:64])
            s["kind"] = "video" if leading and _looks_like_video(leading[0]["head"]) else "other"
    video = next((s for s in streams if s["kind"] == "video"), None)
    if video is None:
        raise container._needs_ffmpeg(path, "it is an MPEG transport stream with no video "
                                            "stream (" + ", ".join(
                                                f"{s['codec']}" for s in streams) + ")")
    codec = video["codec"]
    if codec not in READ.values():
        raise container._needs_ffmpeg(path, f"its video is {codec} (MPEG-TS stream type "
                                            f"{video['type']:#04x})")
    vidx = pk.of(video["pid"])
    if len(vidx) and (pk.scrambled[vidx] != 0).any():
        raise container._needs_ffmpeg(path, "its video is scrambled (MPEG-TS "
                                            "transport_scrambling_control set: encrypted)")
    pes = pes_packets(buf, pk, vidx, pieces=True)
    if not pes:
        raise Cut(f"{path}: a transport stream with no whole PES of its video")
    # the file ends in a packet cut short: the video PES it continues is cut
    tail = int(pk.starts[-1]) + size if len(pk.starts) else 0
    if tail < len(arr) and pes[-1]["open"]:
        rest = arr[tail:]
        pid = (int(rest[1]) & 0x1F) << 8 | int(rest[2]) if len(rest) >= 3 else None
        if pid is None or (pid == video["pid"] and not rest[1] & 0x40):
            pes[-1]["damaged"] = True
    offsets = np.array([o for p in pes for o, _ in p["pieces"]], np.int64)
    lengths = np.array([n for p in pes for _, n in p["pieces"]], np.int64)
    es = ElementaryStream(offsets, lengths)
    splitter = Splitter(codec)
    pes_at, at, piece = [], 0, 0
    for p in pes:
        pes_at.append(at)
        count = len(p["pieces"])
        splitter.feed(es.chunk(buf, piece, piece + count))
        piece += count
        at += p["size"]
    frames = splitter.end(es.total)
    stamp_at = splitter.stamp_at(frames)
    # every audio / video stream FFmpeg times: the video read, and the others;
    # each program's wrap reference, from the first stamp FFmpeg hands on
    timed_streams = [s for s in streams if s["kind"] in ("video", "audio")]
    others = [s for s in timed_streams if s is not video]
    all_pes = {video["pid"]: pes}
    for s in others:
        all_pes[s["pid"]] = pes_packets(buf, pk, pk.of(s["pid"]))
    wraps = {}
    for number in {s["program"] for s in streams}:
        firsts = [f for s in streams if s["program"] == number and s["pid"] in all_pes
                  for f in [_first_stamp(all_pes[s["pid"]])] if f]
        wraps[number] = Wrap(min(firsts)[1] if firsts else None)
    wrap = wraps[video["program"]]
    # each frame's time stamps: those of the PES its first byte (MPEG-1 / 2:
    # its first picture) is in, where that PES starts after the frame before
    # it does
    times, damaged = [], []
    for f, (o, n) in enumerate(frames):
        p = int(np.searchsorted(pes_at, stamp_at[f], "right")) - 1
        if f == 0 or pes_at[p] > frames[f - 1][0]:
            times.append((wrap(pes[p]["pts"]), wrap(pes[p]["dts"])))
        else:
            times.append((None, None))
        q = int(np.searchsorted(pes_at, o + n - 1, "right")) - 1
        if any(pes[k]["damaged"] for k in range(p, q + 1)):
            damaged.append(f)
    head = es.chunk(buf, 0, min(len(es.lengths), 400))    # the stream's first 70 KiB
    rate = _safe_rate(codec, head)
    # what find_stream_info reads: frames until 20 increasing intervals of
    # their decoding times, or PROBESIZE bytes of packets
    dts, last, count, read = [], None, 0, 0
    stop = len(arr)
    extra = sorted((p["emit"], p["size"]) for s in others for p in all_pes[s["pid"]])
    e = 0
    for f, (o, n) in enumerate(frames):
        if count >= FPS_FRAMES or read >= PROBESIZE:
            break
        end_pos = es.file_pos(o + n - 1)
        while e < len(extra) and extra[e][0] <= end_pos:
            read += extra[e][1]
            e += 1
        d = times[f][1]
        dts.append(d)
        read += n
        if d is not None and last is not None and d > last:
            count += 1
        if d is not None:
            last = d
        stop = end_pos
    avg, r = cv2_fps(codec, dts, rate)
    fps = float(avg or r)
    # each audio / video stream's start (its first stamp in what
    # find_stream_info reads) and frame duration, then its duration from the
    # end of the file
    first = next((t for t in times if t[1] is not None and t[0] is not None), None)
    timed = [{"pid": video["pid"], "program": video["program"],
              "start": first[0] if first else None, "ticks": TB * r.denominator // r.numerator}]
    for s in others:
        ps = all_pes[s["pid"]]
        stamped = [p for p in ps if p["pts"] is not None and p["emit"] <= stop]
        w = wraps[s["program"]]
        if s["kind"] == "audio":
            ticks = _audio_ticks(s["codec"], ps[0]["head"] if ps else b"")
        else:                                     # another video: its PES taken for frames
            head = b"".join(p["head"] for p in ps[:1])
            other = cv2_fps(s["codec"], [w(p["dts"]) for p in ps[:FPS_FRAMES + 1]],
                            _safe_rate(s["codec"], head))[1]
            ticks = TB * other.denominator // other.numerator
        timed.append({"pid": s["pid"], "program": s["program"],
                      "start": w(stamped[0]["pts"]) if stamped else None, "ticks": ticks})
    _tail_durations(arr, buf, size, timed, wraps)
    several = len({s["program"] for s in streams}) > 1
    seconds = duration_us([dict(t, group=t["program"] if several else 0) for t in timed]) / 1e6
    if seconds < 0.000025:
        v = timed[0]
        seconds = v["duration"] / TB if v["duration"] else 0.0
    info = {"width": 0, "height": 0, "fps": fps, "frame_count": frame_count(seconds, fps),
            "container": "mpegts", "codec": codec, "es": es, "damaged": damaged,
            "packet_size": size}
    if codec == "mpeg4":
        info["dsi"] = b""
    elif codec == "mpeg2":
        info["extradata"] = b""
    else:
        info["annexb"] = b""
    if all(t[0] is not None for t in times):
        info["times"] = [t[0] for t in times]
    return [o for o, _ in frames], [n for _, n in frames], info
