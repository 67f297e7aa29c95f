"""MPEG program streams (ISO/IEC 13818-1 and the MPEG-1 system stream of
ISO/IEC 11172-1: `.mpg`, `.mpeg`, `.vob`) read with the standard library
and numpy: `index`, which gives what `container.index` gives for the other
containers: where each frame of the first video stream lies and the
stream's info.

Read as FFmpeg's `mpeg` demuxer (mpeg.c) and its parsers read a file for
cv2 (measured against cv2 5.0.0, libavformat 62):

- The probe (`probe`): `mpegps_probe`'s count of pack headers (MPEG-1's
  `0010` and MPEG-2's `01`), system headers and PES start codes, and its
  scores; a file is read as a program stream only where that score would
  win (the content decides, not the suffix): a transport stream, an ASF
  file or a raw elementary stream goes to another demuxer first.
- Packs: pack headers and system headers are passed over; padding (0xBE)
  and private stream 2 (0xBF: a DVD's navigation packs) are skipped by
  their length; the program stream map (0xBC) names each stream's type.
  PES headers of MPEG-1 (0xFF stuffing, the STD buffer, a PTS or PTS and
  DTS) and of MPEG-2 (with its extension's stream_id_extension) are read
  as `mpegps_read_pes_header` reads them; private stream 1 (0xBD: a DVD's
  AC-3 / DTS / LPCM audio and subpictures) is split by its sub-stream id.
- The video is the first stream FFmpeg makes a video stream of, as OpenCV
  takes the first video stream: a PES stream 0xE0-0xEF, its codec the
  PSM's stream type or, with none, FFmpeg's probe of its payload
  (`_probe_codec`): MPEG-1 / MPEG-2 video, H.264, HEVC or MPEG-4 Part 2 (a
  CCTV or DVR recorder's `.mpg`); any other (CAVS, VC-1, ...) raises
  `container.UnsupportedCodecError` naming it.
- Frames: the video's elementary stream is split by FFmpeg's parser for
  its codec (`mpegts.Splitter`), each frame timed as in a transport stream
  (`mpegts.index`); fps and frame_count as cv2 reports them, through
  `mpegts.cv2_fps` and FFmpeg's duration estimate from the time stamps
  near the file's end (`estimate_timings_from_pts`, as for `mpegts`).
- Damage: a PES that the file's end cuts marks its frames damaged
  (`info["damaged"]`): reading one raises ValueError, as in a transport
  stream.
"""

from __future__ import annotations

import numpy as np

from omfs4d_torch.io import mpegts

PACK, SYSTEM, PSM, PRIVATE_1, PADDING, PRIVATE_2 = 0xBA, 0xBB, 0xBC, 0xBD, 0xBE, 0xBF
SCORE_EXTENSION = 50                       # FFmpeg's AVPROBE_SCORE_EXTENSION
SCORE_RETRY = SCORE_EXTENSION // 2
MAX_PROBE = 1 << 20                        # the probe's largest window here
# PSM stream types of the codecs the port reads, and FFmpeg's others by name
_PSM_VIDEO = {0x01: "mpeg2", 0x02: "mpeg2", 0x10: "mpeg4", 0x1B: "h264", 0x24: "hevc"}
_ASF = bytes.fromhex("3026b2758e66cf11a6d900aa0062ce6c")


class Cut(Exception):
    """cv2 cannot open the file (no whole PES of its video)."""


# ── the probe ───────────────────────────────────────────────────────────

def _check_pes(b, i: int, end: int) -> bool:
    """`check_pes` at the start code whose id byte is at i."""
    def at(k):
        return b[k] if k < end else 0
    pes2 = (at(i + 3) & 0xC0) == 0x80 and (at(i + 4) & 0xC0) != 0x40 and (
        (at(i + 4) & 0xC0) == 0 or (at(i + 4) & 0xC0) >> 2 == (at(i + 6) & 0xF0))
    p = i + 3
    while p < end and b[p] == 0xFF:
        p += 1
    if (at(p) & 0xC0) == 0x40:
        p += 2
    if (at(p) & 0xF0) == 0x20:
        pes1 = at(p) & at(p + 2) & at(p + 4) & 1
    elif (at(p) & 0xF0) == 0x30:
        pes1 = at(p) & at(p + 2) & at(p + 4) & at(p + 5) & at(p + 7) & at(p + 9) & 1
    else:
        pes1 = at(p) == 0x0F
    return bool(pes1) or pes2


def score(b: bytes) -> int:
    """`mpegps_probe`'s score of the bytes b."""
    sys = pspack = priv1 = vid = audio = invalid = 0
    end, endpes = len(b), 0
    m = b.find(b"\x00\x00\x01")
    while 0 <= m and m + 3 < end:
        i = m + 3                                 # the id byte, as the probe's i
        code = b[i]
        length = (b[i + 1] << 8 | b[i + 2]) if i + 2 < end else 0
        pes = endpes <= i and _check_pes(b, i, end)
        pack = i + 1 < end and ((b[i + 1] & 0xCC) == 0x44 or (b[i + 1] & 0xF1) == 0x21)
        if code == SYSTEM:
            sys += 1
        elif code == PACK and pack:
            pspack += 1
        elif code & 0xF0 == 0xE0 and pes:
            endpes = i + length
            vid += 1
        elif code & 0xE0 == 0xC0 and pes:
            audio += 1
            i += length
        elif code == PRIVATE_1 and pes:
            priv1 += 1
            i += length
        elif code == 0xFD and pes:
            vid += 1
        elif (code & 0xF0 == 0xE0 or code & 0xE0 == 0xC0 or code == PRIVATE_1) and not pes:
            invalid += 1
        m = b.find(b"\x00\x00\x01", i)
    if sys > invalid and sys * 9 <= pspack * 10:
        return (SCORE_EXTENSION + 2 if audio > 12 or vid > 3 or pspack > 2
                else SCORE_EXTENSION // 2 + (audio + vid + pspack > 1))
    if pspack > invalid and (priv1 + vid + audio) * 10 >= pspack * 9:
        return SCORE_EXTENSION + 2 if pspack > 2 else SCORE_EXTENSION // 2
    if (bool(vid) ^ bool(audio)) and (audio > 4 or vid > 1) and not sys and not pspack \
            and len(b) > 2048 and vid + audio > invalid:
        return (SCORE_EXTENSION + 2 if audio > 12 or vid > 6 + 2 * invalid
                else SCORE_EXTENSION // 2)
    return (SCORE_EXTENSION // 2) if vid + audio > invalid + 1 else 0


def probe(buf) -> bool:
    """Whether FFmpeg's probe (`av_probe_input_buffer2`) takes the file (its
    mapped bytes) for a program stream: windows of 2,048 bytes and up,
    doubling, until the score passes FFmpeg's retry mark (any score at all
    in the last window, 1 MiB) or the file ends; an ASF header or a raw
    video elementary stream's start takes it elsewhere."""
    head = bytes(buf[:16])
    if head.startswith(_ASF) or head.startswith(b"\x00\x00\x01\xb3"):
        return False
    size = 2048
    while True:
        s = score(bytes(buf[:size]))
        if s > (SCORE_RETRY if size < MAX_PROBE else 0):
            return True
        if size >= min(len(buf), MAX_PROBE):
            return False
        size *= 2


# ── PES ─────────────────────────────────────────────────────────────────

def _stamp(b, k: int) -> int:
    return mpegts._stamp(bytes(b[k:k + 5]))


def walk(buf, start: int, end: int, state: dict) -> list[dict]:
    """The PES packets FFmpeg's `mpegps_read_pes_header` finds from byte
    `start` to `end`: {"id" (the stream: 0x1C0-0x1EF, or 0xBD's sub-stream
    id), "pos" (its start code), "offset" / "size" (its payload in the
    file; size past the end where the file cuts it), "pts", "dts",
    "cut"}; the PSM's types go into `state["psm"]`."""
    out: list[dict] = []
    pos = start
    psm = state.setdefault("psm", {})
    while True:
        at = buf.find(b"\x00\x00\x01", pos, end)
        if at < 0 or at + 4 > end:
            break
        code = buf[at + 3]
        pos = at + 4
        if code in (PACK, SYSTEM) or pos + 2 > end:
            continue
        length = buf[pos] << 8 | buf[pos + 1]
        if code == PADDING:
            pos += 2 + length
            continue
        if code == PRIVATE_2:                    # a DVD's navigation pack: no video
            pos += 2 + length
            continue
        if code == PSM:
            if pos + 6 <= end:
                info_len = buf[pos + 4] << 8 | buf[pos + 5]
                p = pos + 6 + info_len + 2
                left = length - info_len - 10
                while left >= 4 and p + 4 <= end:
                    kind, es_id, es_len = buf[p], buf[p + 1], buf[p + 2] << 8 | buf[p + 3]
                    psm[es_id] = kind
                    p += 4 + es_len
                    left -= 4 + es_len
            pos += 2 + length
            continue
        if not (0xC0 <= code <= 0xEF or code in (PRIVATE_1, 0xFD)):
            continue
        p, left = pos + 2, length
        pts = dts = None
        ok = True
        while True:                              # MPEG-1 stuffing
            if left < 1 or p >= end:
                ok = False
                break
            c = buf[p]
            p, left = p + 1, left - 1
            if c != 0xFF:
                break
        if not ok:
            continue
        if c & 0xC0 == 0x40:                     # STD buffer
            c = buf[p + 1] if p + 1 < end else 0
            p, left = p + 2, left - 2
        if c & 0xE0 == 0x20:
            pts = dts = _stamp(buf, p - 1)
            p, left = p + 4, left - 4
            if c & 0x10:
                dts = _stamp(buf, p)
                p, left = p + 5, left - 5
        elif c & 0xC0 == 0x80:                   # MPEG-2 PES
            if p + 2 > end:
                continue
            flags, header_len = buf[p], buf[p + 1]
            p, left = p + 2, left - 2
            if header_len > left:
                continue
            left -= header_len
            q = p
            if flags & 0x80:
                pts = dts = _stamp(buf, q)
                q, header_len = q + 5, header_len - 5
                if flags & 0x40:
                    dts = _stamp(buf, q)
                    q, header_len = q + 5, header_len - 5
            if flags & 0x3F and header_len == 0:
                flags &= 0xC0
            if flags & 0x01 and q < end:
                ext = buf[q]
                q, header_len = q + 1, header_len - 1
                skip = (ext >> 4) & 0xB
                skip += skip & 0x9
                if ext & 0x40 or skip > header_len:
                    ext = skip = 0
                q, header_len = q + skip, header_len - skip
                if ext & 0x01 and q < end:
                    ext2 = buf[q]
                    q, header_len = q + 1, header_len - 1
                    if ext2 & 0x7F and q < end:
                        if not buf[q] & 0x80:
                            code = (code & 0xFF) << 8 | buf[q]
                        q, header_len = q + 1, header_len - 1
            if header_len < 0:
                continue
            p = q + header_len
        elif c != 0x0F:
            continue
        sid = code | 0x100 if code < 0x100 else code
        if code == PRIVATE_1:
            sub = buf[p] if p < end else 0
            raw = sub == 0x0B and p + 1 < end and buf[p + 1] == 0x77
            if raw:
                sid = 0x80                       # raw AC-3
            else:
                sid, p, left = sub, p + 1, left - 1
            if 0x80 <= sid <= 0xCF and not raw and left >= 4:
                p, left = p + 3, left - 3        # the audio header FFmpeg skips
        if left < 0:
            continue
        out.append({"id": sid, "pos": at, "offset": p, "size": left, "pts": pts, "dts": dts,
                    "cut": p + left > end})
        pos = p + left
    return out


def _kind(sid: int, psm: dict) -> tuple[str, str | None]:
    """(video / audio / other, the codec where FFmpeg names it by the id or
    the PSM; None: probed from the payload) of a PES stream."""
    t = psm.get(sid & 0xFF)
    if t in _PSM_VIDEO:
        return "video", _PSM_VIDEO[t]
    if t in (0x03, 0x04):
        return "audio", "mp3"
    if t == 0x0F:
        return "audio", "aac"
    if t == 0x81:
        return "audio", "ac3"
    if 0x1E0 <= sid <= 0x1EF:
        return "video", None
    if 0x1C0 <= sid <= 0x1DF:
        return "audio", "mp3"
    if 0x80 <= sid <= 0x87 or 0xC0 <= sid <= 0xCF:
        return "audio", "ac3"
    if 0x88 <= sid <= 0x8F or 0x98 <= sid <= 0x9F:
        return "audio", "dts"
    if 0xA0 <= sid <= 0xBF:
        return "audio", "pcm"
    if 0xFD55 <= sid <= 0xFD5F:
        return "video", "VC-1"
    return "other", None


def _probe_codec(head: bytes) -> str:
    """The codec FFmpeg's probe of a video PES stream's payload finds:
    "mpeg2" for a sequence header, "h264" / "hevc" for their parameter sets
    or access unit delimiter, "mpeg4" for MPEG-4 Part 2's VOS, VOL or VOP,
    else a name of what the port does not read (CAVS: its sequence header
    0xB0 with no MPEG-4 profile after it)."""
    for at, code in ((m + 3, head[m + 3]) for m in _starts(head)):
        nxt = head[at + 1:at + 5]
        if code == 0xB3:
            return "mpeg2"
        if code == 0xB0:
            if len(head) >= at + 5 and (head[at + 3] != 0 or head[at + 4] != 1):
                return "CAVS (Chinese AVS video)"
            return "mpeg4"
        if code in (0xB6,) or 0x20 <= code <= 0x2F:
            return "mpeg4"
        if code < 0x80 and code & 0x1F in (7, 9) and code & 0x60 != 0 or code in (0x09, 0x67):
            return "h264"
        if code >> 1 & 0x3F in (32, 33, 35) and not code & 0x80 and nxt[:1] == b"\x01":
            return "hevc"
    return "an unknown codec"


def _starts(b: bytes):
    at = b.find(b"\x00\x00\x01")
    while 0 <= at < len(b) - 4:
        yield at
        at = b.find(b"\x00\x00\x01", at + 3)


# ── the API ─────────────────────────────────────────────────────────────

def _tail_durations(buf, streams: list[dict], wrap: mpegts.Wrap) -> None:
    """Each audio / video stream's "duration" as `estimate_timings_from_pts`
    finds it: the latest PTS plus a frame's duration, less its start, over
    the PES read from 250,000 bytes before the end (more, up to 6 times,
    while no stream has one)."""
    end = len(buf)
    found = False
    for s in streams:
        s["duration"], s["last"] = None, 0
    by_id = {s["id"]: s for s in streams if s["start"] is not None}
    retry = 0
    while True:
        is_end = found
        offset = max(end - (mpegts.DURATION_READ << retry), 0)
        read, limit = 0, mpegts.DURATION_READ << max(retry - 1, 0)
        for p in walk(buf, offset, end, {}):
            if read >= limit:
                break
            read += min(p["size"], max(end - p["offset"], 0))
            s = by_id.get(p["id"])
            if s is None or p["pts"] is None:
                continue
            found = True
            d = wrap(p["pts"]) + s["ticks"] - s["start"]
            if d > 0:
                if s["duration"] is None or s["last"] <= 0 or (
                        s["duration"] < d and abs(d - s["last"]) < 60 * mpegts.TB):
                    s["duration"] = d
                s["last"] = d
        if not is_end:
            is_end = all(s["duration"] is not None for s in by_id.values())
        retry += 1
        if is_end or not offset or retry > mpegts.DURATION_RETRY:
            return


def index(buf, path) -> tuple[list[int], list[int], dict]:
    """(frame offsets, frame sizes, info) of the first video stream of a
    program stream: the offsets are in its elementary stream, which
    `info["es"]` (an `mpegts.ElementaryStream`) maps to the file; info holds
    width and height 0 (the codec's headers give them), fps, frame_count,
    container "mpegps", the codec's keys in Annex B form (`codec`; "mpeg2"
    with `extradata` b"", "h264" / "hevc" with `annexb` b"", "mpeg4" with
    `dsi` b""), `times` (the frames' PTS where each has one) and `damaged`
    (the frames of a PES the file's end cuts).  A codec the port does not
    read raises `UnsupportedCodecError`; a file cv2 cannot open raises
    `Cut`."""
    from omfs4d_torch.io import container

    state: dict = {}
    pes = walk(buf, 0, len(buf), state)
    order: list[int] = []
    for p in pes:
        if p["id"] not in order:
            order.append(p["id"])
    kinds = {sid: _kind(sid, state["psm"]) for sid in order}
    video = next((sid for sid in order if kinds[sid][0] == "video"), None)
    if video is None:
        raise container._needs_ffmpeg(path, "it is an MPEG program stream with no video stream")
    vpes = [p for p in pes if p["id"] == video]
    codec = kinds[video][1]
    if codec is None:
        head = b"".join(bytes(buf[p["offset"]:p["offset"] + min(p["size"], 4096)])
                        for p in vpes[:8])
        codec = _probe_codec(head)
    if codec not in mpegts.READ.values():
        raise container._needs_ffmpeg(path, f"its video is {codec} (MPEG program stream, "
                                            f"stream {video:#x})")
    end = len(buf)
    lengths = np.array([max(min(p["size"], end - p["offset"]), 0) for p in vpes], np.int64)
    offsets = np.array([p["offset"] for p in vpes], np.int64)
    keep = lengths > 0
    vpes = [p for p, k in zip(vpes, keep) if k]
    offsets, lengths = offsets[keep], lengths[keep]
    if not len(vpes):
        raise Cut(f"{path}: a program stream with no whole PES of its video")
    es = mpegts.ElementaryStream(offsets, lengths)
    splitter = mpegts.Splitter(codec)
    pes_at = [int(a) for a in es.at]
    for k in range(len(vpes)):
        splitter.feed(es.chunk(buf, k, k + 1))
    frames = splitter.end(es.total)
    stamp_at = splitter.stamp_at(frames)
    first = next(((p["dts"] if p["dts"] is not None else p["pts"])
                  for p in pes if p["pts"] is not None and kinds[p["id"]][0] in ("video", "audio")),
                 None)
    wrap = mpegts.Wrap(first)
    times, damaged = [], []
    for f, (o, n) in enumerate(frames):
        k = int(np.searchsorted(pes_at, stamp_at[f], "right")) - 1
        prev = frames[f - 1][0] if f else -1
        if f == 0 or pes_at[k] > prev:
            times.append((wrap(vpes[k]["pts"]), wrap(vpes[k]["dts"])))
        else:
            times.append((None, None))
        q = int(np.searchsorted(pes_at, o + n - 1, "right")) - 1
        if any(vpes[i]["cut"] for i in range(int(np.searchsorted(pes_at, o, "right")) - 1, q + 1)):
            damaged.append(f)
    head = es.chunk(buf, 0, min(len(lengths), 64))
    rate = mpegts._safe_rate(codec, head)
    # what find_stream_info reads: frames until 20 increasing intervals of
    # their decoding times, or PROBESIZE bytes of packets
    others = [sid for sid in order if sid != video and kinds[sid][0] in ("video", "audio")]
    extra = sorted((p["pos"], p["size"]) for p in pes if p["id"] in others)
    dts, last, count, read, e, stop = [], None, 0, 0, 0, len(buf)
    for f, (o, n) in enumerate(frames):
        if count >= mpegts.FPS_FRAMES or read >= mpegts.PROBESIZE:
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
    avg, r = mpegts.cv2_fps(codec, dts, rate)
    fps = float(avg or r)
    start = next((t for t in times if t[1] is not None and t[0] is not None), None)
    timed = [{"id": video, "start": start[0] if start else None,
              "ticks": mpegts.TB * r.denominator // r.numerator}]
    for sid in others:
        ps = [p for p in pes if p["id"] == sid]
        stamped = [p for p in ps if p["pts"] is not None and p["pos"] <= stop]
        if kinds[sid][0] == "audio":
            h = bytes(buf[ps[0]["offset"]:ps[0]["offset"] + 16]) if ps else b""
            ticks = mpegts._audio_ticks(kinds[sid][1] or "", h)
        else:
            other = mpegts.cv2_fps("mpeg2", [wrap(p["dts"]) for p in ps[:mpegts.FPS_FRAMES + 1]],
                                   None)[1]
            ticks = mpegts.TB * other.denominator // other.numerator
        timed.append({"id": sid, "start": wrap(stamped[0]["pts"]) if stamped else None,
                      "ticks": ticks})
    _tail_durations(buf, timed, wrap)
    seconds = mpegts.duration_us([dict(t, group=0) for t in timed]) / 1e6
    if seconds < 0.000025:
        v = timed[0]
        seconds = v["duration"] / mpegts.TB if v["duration"] else 0.0
    info = {"width": 0, "height": 0, "fps": fps,
            "frame_count": mpegts.frame_count(seconds, fps), "container": "mpegps",
            "codec": codec, "es": es, "damaged": damaged}
    if codec == "mpeg4":
        info["dsi"] = b""
    elif codec == "mpeg2":
        info["extradata"] = b""
    else:
        info["annexb"] = b""
    if all(t[0] is not None for t in times):
        info["times"] = [t[0] for t in times]
    return [o for o, _ in frames], [n for _, n in frames], info
