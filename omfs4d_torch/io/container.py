"""The containers of the port's video files, AVI, MP4, Matroska / WebM,
MPEG transport and program streams and ASF, with the standard library: which codec a file holds
and where its frames lie (`index`), and the file writing the port's two
written codecs share (`write_file`).  The codecs sit on top of it as
siblings: Motion JPEG
(`omfs4d_torch.io.mjpeg`), H.264 (`omfs4d_torch.io.h264`), HEVC
(`omfs4d_torch.io.hevc`, read only), MPEG-4 Part 2
(`omfs4d_torch.io.mpeg4`, read only), VP8 (`omfs4d_torch.io.vp8`, read
only), VP9 (`omfs4d_torch.io.vp9`, read only), MPEG-1 / MPEG-2
(`omfs4d_torch.io.mpeg2`, read only) and MS MPEG-4 v2 / v3 and WMV1 / WMV2
(`omfs4d_torch.io.msmpeg4`, read only), and the lossless ones, raw video
(`omfs4d_torch.io.rawvideo`), PNG (`omfs4d_torch.io.video.decode_png`),
HuffYUV (`omfs4d_torch.io.huffyuv`) and FFV1 (`omfs4d_torch.io.ffv1`), read
only; the MP4 boxes are
`omfs4d_torch.io.mp4`'s, the Matroska elements `omfs4d_torch.io.matroska`'s,
the transport stream's packets `omfs4d_torch.io.mpegts`'s, the program
stream's `omfs4d_torch.io.mpegps`'s, ASF's objects and packets
`omfs4d_torch.io.asf`'s.

- AVI (RIFF): the `hdrl` list's first video `strl` (`strh` of type `vids`,
  a BITMAPINFOHEADER `strf` naming the codec), and its frames from the
  `movi` lists, walked chunk by chunk (`idx1` is not trusted, only counted),
  following the `RIFF AVIX` lists of an OpenDML file past 1 GB and skipping
  `JUNK` and `ix##` chunks.  AVI holds Motion JPEG (`MJPG`, ...), MPEG-4
  Part 2 (`XVID`, `FMP4`, `DIVX`, `DX50`, `MP4V`, upper or lower case), the
  latter with whatever follows the BITMAPINFOHEADER in `strf` as its
  extradata (`dsi`, maybe empty) and its fourcc (`fourcc`, which FFmpeg's
  decoder reads the encoder from where the stream has no stamp), H.264
  (`H264`, `X264`, `avc1`, `DAVC`, ...) and HEVC (`HEVC`, `H265`, `hev1`, `hvc1`): an Annex B byte stream,
  its parameter sets in band, as FFmpeg's AVI muxer writes x264's and
  x265's output (`info["annexb"]`, the extradata, maybe empty), or
  length-prefixed after an avcC / hvcC extradata (`info["avcC"]` /
  `info["hvcC"]`, as FFmpeg tells the two apart), VP8 (`VP80`, a frame
  a chunk, as cv2's writer lays it out), VP9 (`VP90`, a packet a chunk)
  MPEG-1 / MPEG-2 (`mpg1`, `mpg2`, `PIM1`, `MPEG`, ... of FFmpeg's
  table; the extradata, maybe empty, as `extradata`) and Microsoft's MPEG-4
  family (`MP42`, `MP43` / `DIV3` and FFmpeg's other v3 tags, `WMV1`,
  `WMV2`: codec "msmpeg4" with its `version`, 2 to 5, and `extradata`,
  WMV2's extended header), raw video (compression 0, BI_RGB, at 24 or 32
  bits, bottom-up where biHeight > 0; `I420` / `IYUV`, `YV12`, `Y800` /
  `GREY` / `Y8  `, `RGBA`: codec "raw" with its `fourcc`, `bits` and
  `bottom_up`), PNG (`MPNG`, `PNG `, upper or lower case), HuffYUV (`HFYU`,
  FFmpeg's `FFVH`: codec "huffyuv" with `fourcc`, `bits` and `extradata`)
  and FFV1 (`FFV1`, its configuration record as `extradata`).  cv2's raw
  `YUY2` / `UYVY` AVIs (I420 bytes under a 4:2:2 tag: cv2 shows no frame)
  are refused by name.  A zero-byte chunk is a
  frame the writer dropped: it has no sample, but counts in `frame_count`
  (cv2 counts it and shows no frame for it).
- MP4 / QuickTime: the first video track (`mp4.read_track`; a sound track
  beside it is skipped).  Its codec is Motion JPEG for an `mp4v` sample
  entry whose esds has objectTypeIndication 0x6C (as FFmpeg muxes MJPEG into
  `.mp4`) and for QuickTime's `jpeg` and `mjpa`; MPEG-4 Part 2 for an `mp4v`
  entry of objectTypeIndication 0x20, its DecoderSpecificInfo (the VOS / VOL
  headers) as `dsi`; H.264 for `avc1` / `avc3` with an `avcC` box; HEVC for
  `hvc1` / `hev1` with an `hvcC` box; VP9 for `vp09` (its `vpcC` box, where
  there is one, as `info["vpcC"]`; FFmpeg's decoder tags the frames from the
  stream's own colour bits whatever it says); MPEG-1 / MPEG-2 for an `mp4v`
  entry of objectTypeIndication 0x60-0x65 or 0x6A (its DecoderSpecificInfo
  as `extradata`) and for QuickTime's `m2v1` (cv2's), `m1v1`, `mpeg`, HDV's
  `hdv*`, XDCAM's `xdv*` / `xd5*` / `xdhd`, IMX's `mx*`; PNG for `png ` and
  for an `mp4v` entry of objectTypeIndication 0x6D; raw RGBA for QuickTime's
  `RGBA`; HuffYUV for `HFYU` / `FFVH` and FFV1 for `FFV1`, each with the
  `glbl` box as its extradata.  QuickTime's other raw entries (`raw `,
  `yuv2`, `2vuy`, `v308`, `I420`: cv2 shows no frame from its own) are
  refused by name.
- Matroska / WebM (EBML, whatever the suffix): the first video track, its
  codec by CodecID (`matroska.index`): Motion JPEG, MPEG-4 Part 2, H.264,
  HEVC, VP8, VP9, MPEG-1 / MPEG-2, FFV1 (`V_FFV1`) and raw video
  (`V_UNCOMPRESSED`, its `ColourSpace` fourcc read as AVI's), and a VfW
  track's fourcc read as AVI's.
- IVF (`.ivf`, `DKIF`): VP8 or VP9, a frame a record, as cv2's `VP80` /
  `VP90` writers and libvpx's tools write it.
- MPEG-TS (`.ts`, M2TS / AVCHD `.mts` / `.m2ts`; 188-, 192- or 204-byte
  packets, found by their sync bytes whatever the suffix): the first video
  stream of the programs (`mpegts.index`): H.264, HEVC, MPEG-4 Part 2 and
  MPEG-1 / MPEG-2, split into frames as FFmpeg's parsers split them; its
  samples are ranges of the elementary stream, gathered from the packets
  (`read_sample`).
- ASF (`.wmv`, `.asf`, found by its header object's GUID): the first video
  stream (`asf.index`), its codec by the BITMAPINFOHEADER's fourcc as AVI's,
  its media objects gathered from the data packets (`info["es"]`).
- MPEG-PS (`.mpg`, `.mpeg`, `.vob`: MPEG-1 system streams and MPEG-2
  program streams, found by FFmpeg's probe whatever the suffix): the first
  video stream (`mpegps.index`), MPEG-1 / MPEG-2, or H.264, HEVC or MPEG-4
  Part 2 by its PSM or its payload, read as from a transport stream.  A raw
  MPEG-1 / 2 elementary stream (`.m1v` / `.m2v`) is refused by name.

Any other codec (AV1, WMV 9 / VC-1, VP8 in MP4, ...) raises
`UnsupportedCodecError` naming it: decoding it needs an ffmpeg binary.  So
does a file that is none of the containers.  A frame whose bytes end early
raises ValueError with its index (in Matroska, whose frames no header
counts, the cut block is dropped as FFmpeg drops it), and an AVI or MP4
file holding fewer frames than its header declares raises too.
"""

from __future__ import annotations

import mmap
import struct
import traceback
from collections.abc import Callable
from fractions import Fraction
from pathlib import Path

import numpy as np

from omfs4d_torch.io import asf, matroska, mp4, mpegps, mpegts


class UnsupportedCodecError(RuntimeError):
    """The video file holds a codec that the port cannot decode without an
    ffmpeg binary, or it is no AVI, MP4, Matroska, MPEG-TS, MPEG-PS or ASF
    file at all."""


def _needs_ffmpeg(path, what: str) -> UnsupportedCodecError:
    return UnsupportedCodecError(
        f"{path}: {what}; the port reads only Motion JPEG (MJPG), H.264 (Main / High "
        "profile I, P and B pictures), HEVC (Main and Main 10 profiles, whole), MPEG-4 "
        "Part 2 (Simple and Advanced Simple profile), VP8, VP9 (profile 0), MPEG-1 / "
        "MPEG-2 (4:2:0 frame pictures), MS MPEG-4 v2 / v3 (DivX 3) and WMV1 / WMV2 (WMV 7 "
        "/ 8, no IntraX8 pictures), raw video (I420 / IYUV, YV12, Y800, RGBA, BI_RGB at "
        "24 / 32 bits), PNG, HuffYUV (FFmpeg's huffyuv and ffvhuff at 8 bits) and FFV1 "
        "(versions 0, 1 and 3, YCbCr and grey at 8 to 10 bits, RGB at 8), each in AVI, MP4 / "
        "QuickTime, Matroska / WebM, IVF, MPEG-TS, MPEG-PS or ASF (.wmv / .asf), by itself "
        "(not MS MPEG-4 v1, WMV 9 / VC-1, UtVideo, JPEG-LS, JPEG 2000, Snow, FFV1 above "
        "10 bits or with alpha, ffvhuff version 3, FLV's Sorenson H.263 or Theora); "
        "decoding this needs an ffmpeg binary (on PATH or from imageio_ffmpeg)")


# AVI fourccs of Motion JPEG (cv2 writes Motion JPEG under each of FFmpeg's
# tags from JPGL on and reads it back as MJPG), and names of those that need
# another decoder
_AVI_MJPEG = {b"MJPG", b"mjpg", b"AVRn", b"dmb1", b"jpeg", b"JPEG", b"JPGL", b"LJPG", b"IJPG",
              b"ACDV", b"QIVG", b"SLMJ", b"CJPG", b"MVJP", b"AVI1", b"mjpa"}
# AVI fourccs of MPEG-4 Part 2 (Xvid, FFmpeg, DivX 4 and 5, generic)
_AVI_MPEG4 = {b"XVID", b"xvid", b"FMP4", b"fmp4", b"DIVX", b"divx", b"DX50", b"MP4V",
              b"mp4v"}
# AVI fourccs of H.264 and of HEVC
_AVI_H264 = {b"H264", b"h264", b"X264", b"x264", b"avc1", b"AVC1", b"DAVC"}
_AVI_HEVC = {b"HEVC", b"H265", b"hev1", b"hvc1"}
_AVI_VP8 = {b"VP80", b"vp80"}
_AVI_VP9 = {b"VP90", b"vp90"}
# AVI fourccs of MPEG-1 / MPEG-2 video (FFmpeg's ff_codec_bmp_tags, matched
# upper- or lower-case as FFmpeg falls back to)
_AVI_MPEG2 = {c for t in (b"mpg1", b"mpg2", b"MPEG", b"PIM1", b"PIM2", b"DVR ", b"MMES",
                          b"LMP2", b"EM2V", b"mpgv", b"BW10", b"XMPG", b"M701", b"M702",
                          b"M703", b"M705") for c in (t, t.upper(), t.lower())}
# AVI fourccs of Microsoft's MPEG-4 family (FFmpeg's ff_codec_bmp_tags, upper
# or lower case): MS MPEG-4 v2 and v3 (DivX 3 and its relabellings), WMV 7
# and 8; the version the decoder takes
_AVI_MSMPEG4 = {c: v for t, v in ((b"MP42", 2), (b"DIV2", 2), (b"MP43", 3), (b"DIV3", 3),
                                 (b"MPG3", 3), (b"DIV4", 3), (b"DIV5", 3), (b"DIV6", 3),
                                 (b"DVX3", 3), (b"AP41", 3), (b"COL1", 3), (b"COL0", 3),
                                 (b"WMV1", 4), (b"WMV2", 5))
                for c in (t, t.lower())}
_AVI_NAMES = {b"MPG4": "MS MPEG-4 v1", b"DIV1": "MS MPEG-4 v1", b"MP41": "MS MPEG-4 v1",
              b"mpg4": "MS MPEG-4 v1", b"div1": "MS MPEG-4 v1", b"mp41": "MS MPEG-4 v1",
              b"AV01": "AV1", b"WMV3": "WMV 9 / VC-1 (Simple and Main profile)",
              b"wmv3": "WMV 9 / VC-1 (Simple and Main profile)",
              b"WVC1": "VC-1 Advanced profile (WMV 9 Advanced)",
              b"WMVA": "VC-1 Advanced profile (WMV 9 Advanced)",
              b"FLV1": "Sorenson H.263 (FLV)",
              **{t: "UtVideo" for t in (b"ULRA", b"ULRG", b"ULY0", b"ULY2", b"ULY4", b"ULH0",
                                        b"ULH2", b"ULH4", b"UQY0", b"UQY2", b"UQRG", b"UQRA",
                                        b"UMY2", b"UMH2", b"UMY4", b"UMH4", b"UMRG", b"UMRA")},
              b"MJLS": "JPEG-LS", b"MJ2C": "JPEG 2000", b"mjp2": "JPEG 2000",
              b"SNOW": "Snow", b"snow": "Snow", b"theo": "Theora", b"Thra": "Theora",
              **{t: f"raw {t.decode()} (cv2 writes I420 bytes under this 4:2:2 tag and shows "
                    "no frame from them)" for t in (b"YUY2", b"UYVY", b"YUYV", b"yuv2")},
              b"VCR2": "MPEG-1 video of ATI VCR2 (its chroma planes swapped)",
              b"slif": "MPEG-2 video of SoftLab-NSK (a first slice FFmpeg reads its own way)",
              b"SLIF": "MPEG-2 video of SoftLab-NSK (a first slice FFmpeg reads its own way)",
              b"M704": "MPEG-2 video with Matrox's alpha plane (M704)"}
# MP4 sample entries of Motion JPEG and of H.264, and names of those that
# need another decoder
_MP4_MJPEG = {b"jpeg", b"mjpa"}
_MP4_H264 = {b"avc1", b"avc3"}
_MP4_HEVC = {b"hvc1", b"hev1"}
# QuickTime sample entries of MPEG-1 / MPEG-2 video (FFmpeg's
# ff_codec_movvideo_tags: cv2's m2v1, HDV, XDCAM, IMX; the 4:2:2 ones are
# refused by the decoder's headers)
_MP4_MPEG2 = ({b"m1v1", b"m1v ", b"mpeg", b"m2v1", b"mp2v", b"xdhd", b"xdh2"}
              | {b"hdv" + bytes([c]) for c in b"123456789a"}
              | {b"xdv" + bytes([c]) for c in b"123456789abcdef"}
              | {b"xd5" + bytes([c]) for c in b"1459abcdef"}
              | {b"mx%d%s" % (n, c) for n in (3, 4, 5) for c in (b"n", b"p")})
_MP4_NAMES = {b"av01": "AV1", b"vp08": "VP8",
              **{t: f"raw video ({t.decode()!r}; cv2 shows no frame from its own)"
                 for t in (b"raw ", b"yuv2", b"2vuy", b"v308", b"I420", b"v210", b"v410")},
              b"mjp2": "JPEG 2000", b"SNOW": "Snow",
              b"mjpb": "Motion JPEG format B", b"s263": "H.263", b"apcn": "ProRes"}
# objectTypeIndication of an `mp4v` entry's esds (ISO/IEC 14496-1, Table 5)
OTI_JPEG = 0x6C
OTI_MPEG4 = 0x20
# of MPEG-2 video (0x60-0x65, each profile) and MPEG-1 video (0x6A)
OTI_MPEG2 = {0x60, 0x61, 0x62, 0x63, 0x64, 0x65, 0x6A}
# of PNG (FFmpeg's ff_mp4_obj_type; its MP4 muxer writes it for `MPNG`)
OTI_PNG = 0x6D
# AVI fourccs of the lossless codecs (upper or lower case as FFmpeg falls
# back to); raw video's are FFmpeg's raw pixel format tags the port reads
_AVI_PNG = {c for t in (b"MPNG", b"PNG ") for c in (t, t.lower())}
_AVI_HUFFYUV = {c for t in (b"HFYU", b"FFVH") for c in (t, t.lower())}
_AVI_FFV1 = {b"FFV1", b"ffv1"}
RAW_TAGS = {b"I420", b"IYUV", b"YV12", b"Y800", b"GREY", b"Y8  ", b"RGBA", b"\0\0\0\0"}
_OTI_NAMES = {0x21: "H.264", 0x6E: "JPEG 2000"}


# ── AVI ─────────────────────────────────────────────────────────────────

def avi_codec(compression: bytes, extradata: bytes, path, where: str = "AVI fourcc",
              bits: int = 0, bottom_up: bool = False) -> dict:
    """The codec keys of `index`'s info for a BITMAPINFOHEADER's fourcc and
    the extradata after it (an AVI `strf`, a Matroska VfW CodecPrivate), its
    biBitCount (`bits`) and whether its rows run bottom-up (an AVI's BI_RGB
    with biHeight > 0, which FFmpeg's AVI demuxer flags).
    H.264 and HEVC samples are length-prefixed after an avcC / hvcC
    extradata and an Annex B byte stream after any other, as FFmpeg's
    decoders tell them apart (avcC starts with its version, 1; hvcC with no
    start code)."""
    if compression in _AVI_MJPEG:
        return {"codec": "mjpeg"}
    if compression in _AVI_MPEG4:
        return {"codec": "mpeg4", "dsi": extradata, "fourcc": compression}
    if compression in _AVI_H264:
        if extradata[:1] == b"\x01":
            return {"codec": "h264", "avcC": extradata}
        return {"codec": "h264", "annexb": extradata}
    if compression in _AVI_HEVC:
        if len(extradata) > 3 and (extradata[0] or extradata[1] or extradata[2] > 1):
            return {"codec": "hevc", "hvcC": extradata}
        return {"codec": "hevc", "annexb": extradata}
    if compression in _AVI_VP8:
        return {"codec": "vp8"}
    if compression in _AVI_VP9:
        return {"codec": "vp9"}
    if compression in _AVI_MPEG2:
        return {"codec": "mpeg2", "extradata": extradata, "fourcc": compression}
    if compression in _AVI_MSMPEG4:
        return {"codec": "msmpeg4", "version": _AVI_MSMPEG4[compression],
                "extradata": extradata, "fourcc": compression}
    if compression in _AVI_PNG:
        return {"codec": "png"}
    if compression in _AVI_HUFFYUV:
        return {"codec": "huffyuv", "fourcc": compression.upper(), "bits": bits,
                "extradata": extradata}
    if compression in _AVI_FFV1:
        return {"codec": "ffv1", "extradata": extradata}
    if compression in RAW_TAGS:
        return {"codec": "raw", "fourcc": compression, "bits": bits, "bottom_up": bottom_up}
    name = _AVI_NAMES.get(compression, repr(compression.decode("latin-1")))
    raise _needs_ffmpeg(path, f"its video is {name} ({where} "
                              f"{compression.decode('latin-1')!r})")


def _avi_chunks(buf, start: int, end: int):
    """(fourcc, data start, data size, list type or None) of each chunk
    between start and end; a chunk's size may run past the end of the file."""
    pos = start
    while pos + 8 <= end:
        fcc = bytes(buf[pos:pos + 4])
        (size,) = struct.unpack_from("<I", buf, pos + 4)
        if fcc in (b"RIFF", b"LIST"):
            yield fcc, pos + 12, size - 4, bytes(buf[pos + 8:pos + 12])
        else:
            yield fcc, pos + 8, size, None
        pos += 8 + size + (size & 1)


def _read_avi(buf, path: Path):
    file_end = len(buf)
    stream, video = 0, None
    declared = idx1_frames = 0
    offsets, sizes = [], []
    ids: tuple[bytes, bytes] = (b"00dc", b"00db")
    dropped = [0]
    extradata = b""

    def walk_movi(start, end):
        for fcc, pos, size, kind in _avi_chunks(buf, start, end):
            if kind is not None:                     # LIST 'rec ' groups
                walk_movi(pos, min(pos + size, end))
            elif fcc in ids:
                if size == 0:                    # a dropped frame
                    dropped[0] += 1
                    continue
                if pos + size > file_end:
                    raise ValueError(f"{path}: frame {len(offsets)} is cut short: "
                                     f"{max(file_end - pos, 0)} of its {size} bytes are in "
                                     "the file")
                offsets.append(pos)
                sizes.append(size)

    for fcc, pos, size, kind in _avi_chunks(buf, 0, file_end):
        if fcc != b"RIFF" or kind not in (b"AVI ", b"AVIX"):
            break
        for cfcc, cpos, csize, ckind in _avi_chunks(buf, pos, min(pos + size, file_end)):
            if ckind == b"hdrl":
                for n, (_, spos, ssize, _) in enumerate(
                        c for c in _avi_chunks(buf, cpos, cpos + csize) if c[3] == b"strl"):
                    strl = {f: (p, s) for f, p, s, _ in _avi_chunks(buf, spos, spos + ssize)}
                    if b"strh" not in strl or b"strf" not in strl:
                        continue
                    hp, _ = strl[b"strh"]
                    if bytes(buf[hp:hp + 4]) != b"vids" or video is not None:
                        continue
                    scale, rate = struct.unpack_from("<II", buf, hp + 20)
                    (declared,) = struct.unpack_from("<I", buf, hp + 32)
                    fp, fsize = strl[b"strf"]
                    extradata = bytes(buf[fp + 40:fp + max(fsize, 40)])
                    width, height = struct.unpack_from("<ii", buf, fp + 4)
                    (bits,) = struct.unpack_from("<H", buf, fp + 14)
                    compression = bytes(buf[fp + 16:fp + 20])
                    stream = n
                    video = (compression, width, abs(height), rate / scale if scale else 0.0,
                             bits, height > 0)
                    ids = (b"%02ddc" % n, b"%02ddb" % n)
            elif ckind == b"movi":
                walk_movi(cpos, min(cpos + csize, file_end))
            elif cfcc == b"idx1":
                entries = min(csize, file_end - cpos) // 16
                idx1_frames = sum(bytes(buf[cpos + 16 * k:cpos + 16 * k + 4]) in ids
                                  for k in range(entries))
    if video is None:
        raise ValueError(f"{path}: an AVI file with no video stream")
    compression, width, height, fps, bits, positive = video
    codec = avi_codec(compression, extradata, path, bits=bits,
                      bottom_up=positive and compression == b"\0\0\0\0")
    found = len(offsets)
    if max(declared, idx1_frames) > found + dropped[0]:
        raise ValueError(f"{path}: the file holds {found} frames of stream {stream}, its "
                         f"header declares {declared} and its index {idx1_frames}: it is "
                         "cut short")
    return offsets, sizes, {"width": width, "height": height, "fps": fps,
                            "frame_count": found + dropped[0], "container": "avi", **codec}


# ── MP4 ─────────────────────────────────────────────────────────────────

def _descriptor(buf, pos):
    """(tag, body start, body end) of the MPEG-4 descriptor at pos."""
    tag, size, pos = buf[pos], 0, pos + 1
    for _ in range(4):
        b = buf[pos]
        pos += 1
        size = size << 7 | (b & 0x7F)
        if not b & 0x80:
            break
    return tag, pos, pos + size


def _esds_oti(buf, body, end) -> tuple[int | None, bytes]:
    """objectTypeIndication of an esds box's DecoderConfigDescriptor, and
    the body of its DecoderSpecificInfo (tag 0x05; b"" where it has none)."""
    tag, pos, _ = _descriptor(buf, body + 4)
    if tag != 0x03:
        return None, b""
    flags = buf[pos + 2]
    pos += 3 + (2 if flags & 0x80 else 0) + (1 + buf[pos + 3] if flags & 0x40 else 0) \
        + (2 if flags & 0x20 else 0)
    tag, pos, config_end = _descriptor(buf, pos)
    if tag != 0x04:
        return None, b""
    oti, dsi = buf[pos], b""
    if pos + 13 < min(config_end, end):
        tag, start, stop = _descriptor(buf, pos + 13)
        if tag == 0x05:
            dsi = bytes(buf[start:min(stop, end)])
    return oti, dsi


def _colour_boxes(buf, children: int, end: int, info: dict) -> None:
    """A sample entry's `colr` (nclx / nclc: info["colr"], (primaries,
    transfer, matrix, full range)) and `mdcv` (info["mdcv"], the mastering
    display's (min, max) luminance in cd/m^2) boxes, as FFmpeg's mov demuxer
    reads them."""
    colr = mp4.child(buf, children, end, b"colr")
    if colr is not None and colr[1] - colr[0] >= 10 and bytes(buf[colr[0]:colr[0] + 4]) in (
            b"nclx", b"nclc"):
        tags = struct.unpack_from(">HHH", buf, colr[0] + 4)
        full = bytes(buf[colr[0]:colr[0] + 4]) == b"nclx" and colr[1] - colr[0] >= 11 \
            and bool(buf[colr[0] + 10] & 0x80)
        info["colr"] = (*tags, full)
    mdcv = mp4.child(buf, children, end, b"mdcv")
    if mdcv is not None and mdcv[1] - mdcv[0] >= 24:
        most, least = struct.unpack_from(">II", buf, mdcv[0] + 16)
        info["mdcv"] = (least / 10000, most / 10000)


def _read_mp4(buf, path: Path):
    offsets, sizes, info, (kind, ebody, eend) = mp4.read_track(buf, path)
    children = ebody + mp4.VISUAL_ENTRY_HEAD
    _colour_boxes(buf, children, eend, info)
    info["codec"] = "mjpeg"
    if kind == b"mp4v":
        esds = mp4.child(buf, children, eend, b"esds")
        oti, dsi = _esds_oti(buf, *esds) if esds else (None, b"")
        if oti == OTI_MPEG4:
            info["codec"], info["dsi"] = "mpeg4", dsi
        elif oti in OTI_MPEG2:
            info["codec"], info["extradata"] = "mpeg2", dsi
        elif oti == OTI_PNG:
            info["codec"] = "png"
        elif oti != OTI_JPEG:
            name = _OTI_NAMES.get(oti, "an unknown codec")
            raise _needs_ffmpeg(path, f"its video is {name} (sample entry 'mp4v', "
                                      f"objectTypeIndication {oti if oti is None else hex(oti)})")
    elif kind in _MP4_H264:
        avcc = mp4.child(buf, children, eend, b"avcC")
        if avcc is None:
            raise _needs_ffmpeg(path, f"its video is H.264 with no avcC box (sample entry "
                                      f"{kind.decode('latin-1')!r})")
        info["codec"], info["avcC"] = "h264", bytes(buf[avcc[0]:avcc[1]])
    elif kind in _MP4_HEVC:
        hvcc = mp4.child(buf, children, eend, b"hvcC")
        if hvcc is None:
            raise _needs_ffmpeg(path, f"its video is H.265 / HEVC with no hvcC box (sample "
                                      f"entry {kind.decode('latin-1')!r})")
        info["codec"], info["hvcC"] = "hevc", bytes(buf[hvcc[0]:hvcc[1]])
    elif kind in _MP4_MPEG2:
        info["codec"], info["extradata"] = "mpeg2", b""
    elif kind == b"png ":
        info["codec"] = "png"
    elif kind == b"RGBA":
        info.update(codec="raw", fourcc=b"RGBA", bits=32, bottom_up=False)
    elif kind in (b"HFYU", b"FFVH", b"FFV1"):
        glbl = mp4.child(buf, children, eend, b"glbl")
        extradata = bytes(buf[glbl[0]:glbl[1]]) if glbl else b""
        (depth,) = struct.unpack_from(">H", buf, ebody + 74)
        info.update(avi_codec(kind, extradata, path, "QuickTime sample entry", bits=depth))
    elif kind == b"vp09":
        info["codec"] = "vp9"
        vpcc = mp4.child(buf, children, eend, b"vpcC")
        if vpcc is not None:
            info["vpcC"] = bytes(buf[vpcc[0]:vpcc[1]])
    elif kind not in _MP4_MJPEG:
        name = _MP4_NAMES.get(kind, "an unknown codec")
        raise _needs_ffmpeg(path, f"its video is {name} (sample entry "
                                  f"{kind.decode('latin-1')!r})")
    return offsets, sizes, info


# ── IVF ─────────────────────────────────────────────────────────────────

_IVF_CODECS = {b"VP80": "vp8", b"VP90": "vp9"}


def _read_ivf(buf, path: Path):
    """libvpx's IVF: a 32-byte header (`DKIF`, version, header size, fourcc,
    width, height, the time base's denominator and numerator, a frame
    count), then each frame behind a 12-byte header (its size, its time);
    as FFmpeg's `ivf` demuxer reads it, the header's count as the stream's
    duration in time base ticks."""
    fourcc = bytes(buf[8:12])
    if fourcc not in _IVF_CODECS:
        raise _needs_ffmpeg(path, f"its video is {_AVI_NAMES.get(fourcc, 'an unknown codec')} "
                                  f"(IVF fourcc {fourcc.decode('latin-1')!r})")
    (head,) = struct.unpack_from("<H", buf, 6)
    width, height, den, num, declared = struct.unpack_from("<HHIII", buf, 12)
    offsets, sizes, times = [], [], []
    pos, end = max(head, 32), len(buf)
    while pos + 12 <= end:
        size, t = struct.unpack_from("<Iq", buf, pos)
        if pos + 12 + size > end:
            raise ValueError(f"{path}: frame {len(offsets)} is cut short: "
                             f"{end - pos - 12} of its {size} bytes are in the file")
        offsets.append(pos + 12)
        sizes.append(size)
        times.append(t)
        pos += 12 + size
    steps = sorted(b - a for a, b in zip(times, times[1:]) if b > a)
    step = steps[len(steps) // 2] if steps else 1
    rate = Fraction(den, num * step) if den and num else Fraction(0)
    count = len(offsets)
    if declared and num and den:
        count = round(Fraction(declared * num, den) * rate)
    return offsets, sizes, {"width": width, "height": height, "fps": float(rate),
                            "frame_count": count, "container": "ivf",
                            "codec": _IVF_CODECS[fourcc]}


# ── the API ─────────────────────────────────────────────────────────────

def index(path) -> tuple[list[int], list[int], dict]:
    """(sample offsets, sample sizes, info) of the video track of an AVI,
    MP4, Matroska / WebM or MPEG-TS file: info holds width, height (the
    container's; 0 for MPEG-TS), fps (0.0 where the container gives none),
    frame_count, container ("avi", "mp4", "matroska", "ivf", "mpegts", "mpegps" or "asf")
    and codec:
    "mjpeg"; "h264", then with `avcC`, the avcC box's body (MP4, Matroska,
    an AVI's avcC extradata), or `annexb`, the extradata of a track of
    Annex B samples (AVI, MPEG-TS; maybe b""), and
    `sync`, the indices of its sync samples (None: every sample, or for
    Annex B: found by the reader); "hevc" alike with `hvcC`; "mpeg4" for
    MPEG-4 Part 2, then with `dsi`, the headers the esds, the AVI extradata
    or the CodecPrivate holds (maybe b""), and an AVI's (or a Matroska VfW
    track's) `fourcc`; "mpeg2" for MPEG-1 / MPEG-2 video, then with
    `extradata` (its sequence header where the container keeps one apart,
    maybe b""); "vp8", "vp9"; "msmpeg4", then with `version` (2 to 5: MS
    MPEG-4 v2, v3, WMV1, WMV2) and `extradata`.  ASF adds `es`, the media
    objects its samples are gathered from.  Matroska adds `prefix` where its
    track strips a header from every frame; MPEG-TS and MPEG-PS `es`, the map from its
    samples' offsets (in the elementary stream) to the file, and `damaged`
    (see `mpegts.index`).  Any other codec raises `UnsupportedCodecError`
    naming it."""
    p = Path(path)
    if not p.is_file():
        raise FileNotFoundError(f"no video file at {path}")
    with open(p, "rb") as f:
        head = f.read(2048)
        if len(head) < 12:
            raise _needs_ffmpeg(p, "it is no AVI, MP4, Matroska or MPEG-TS file (too short)")
        with mmap.mmap(f.fileno(), 0, access=mmap.ACCESS_READ) as buf:
            try:
                if head[:4] == b"RIFF" and head[8:12] == b"AVI ":
                    return _read_avi(buf, p)
                if head[4:8] in (b"ftyp", b"moov", b"mdat", b"free", b"wide", b"skip"):
                    return _read_mp4(buf, p)
                if head[:4] == matroska.MAGIC:
                    return matroska.index(buf, p)
                if head[:4] == b"DKIF":
                    return _read_ivf(buf, p)
                if mpegts.probe(head):
                    return mpegts.index(buf, p)
                if mpegps.probe(buf):
                    return mpegps.index(buf, p)
                if asf.probe(head):
                    return asf.index(buf, p)
                if head[:4] == b"\x00\x00\x01\xb3":
                    raise _needs_ffmpeg(p, "it is a raw MPEG-1 / MPEG-2 video elementary stream "
                                           "(.m1v / .m2v), for which cv2 reports a frame rate "
                                           "of 25 and a frame count that do not follow from "
                                           "the stream")
                if len(buf) < 2040 and mpegts.packet_size(np.frombuffer(head, np.uint8)):
                    # packets, but fewer than FFmpeg's probe needs to take
                    # the file for a transport stream; a longer file that
                    # the probe turned down is some other container (an
                    # ASF file may hold what looks like sync bytes)
                    raise mpegts.Cut("a transport stream of fewer than 2,040 bytes")
            except (struct.error, IndexError, TypeError, matroska.Cut, mpegts.Cut,
                    mpegps.Cut, asf.Cut) as e:
                traceback.clear_frames(e.__traceback__)      # views of the map go first
                raise ValueError(f"{p}: a corrupt or cut-short container ({e})") from e
            except BaseException as e:
                traceback.clear_frames(e.__traceback__)
                raise
    raise _needs_ffmpeg(p, "it is neither an AVI nor an MP4 / QuickTime file, nor a Matroska "
                           "/ WebM one, nor IVF, nor an MPEG transport or program stream, nor "
                           "ASF")


def read_sample(f, offset: int, size: int, info: dict) -> bytes:
    """A sample's bytes from the file open as f, after the header its
    Matroska track strips from every frame (`info["prefix"]`), or gathered
    from a transport stream's packets (`info["es"]`, the sample's offset
    one in its elementary stream); fewer than size bytes where the file ends
    early."""
    if "es" in info:
        return info["es"].read(f, offset, size)
    f.seek(offset)
    return info.get("prefix", b"") + f.read(size)


def check_whole(path, info: dict, i: int) -> None:
    """Raise ValueError where sample i of a transport stream lies in a
    damaged PES (`info["damaged"]`: a lost packet, or the file's end inside
    it), which cv2 decodes with FFmpeg's error concealment and the port
    does not."""
    if i in info.get("damaged", ()):
        raise ValueError(f"{path}: frame {i} lies in a damaged PES (a packet lost or garbled "
                         "in it, or the file's end inside it): cv2 shows FFmpeg's concealment "
                         "of the damage, which the port does not copy")


def write_file(path, fps: float, width: int, height: int,
               fill: Callable[..., int]) -> Path:
    """Create a video file at `path` and let `fill(file, rate)` write it, the
    rate being fps as a Fraction; returns the path.  The file is removed when
    `fill` raises or writes no frame (it returns their number)."""
    p = Path(path)
    rate = Fraction(fps).limit_denominator(1001) if fps > 0 else 0
    if rate <= 0:
        raise ValueError(f"write: fps {fps}; expected > 0")
    if not (0 < width < 65536 and 0 < height < 65536):
        raise ValueError(f"write: a {width} x {height} frame; sides of 1 to 65,535")
    p.parent.mkdir(parents=True, exist_ok=True)
    try:
        with open(p, "w+b") as f:
            n = fill(f, rate)
        if n == 0:
            raise ValueError(f"write: no frames for {p}")
    except BaseException:
        p.unlink(missing_ok=True)
        raise
    return p


def container_of(path) -> str:
    """"avi" for a `.avi` suffix, else "mp4": the container a writer picks
    (a `.mkv`, `.ts` or `.m2ts` path gets MP4 bytes, which cv2 reads by their
    content whatever the suffix)."""
    return "avi" if Path(path).suffix.lower() == ".avi" else "mp4"
