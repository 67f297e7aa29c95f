"""A random legal-syntax writer of the lossless and raw video codecs the port
reads, for the cases cv2's writers do not make: raw BI_RGB AVIs (24 / 32
bits, bottom-up or top-down, rows padded to 4 bytes), PNG video with every
row filter, HuffYUV (versions 0 / 1 with the classic tables and 2 with its
own, per-packet tables (`context`), YUV 4:2:2, ffvhuff's 4:2:0, RGB24 and
RGB32, the left, plane and median predictors, decorrelation, interlaced
prediction) and FFV1 (versions 0, 1 and 3, Golomb-Rice and the range coder
with the default or a custom state table, the record's initial states,
quantisation tables of 3 or 5 inputs, slices with CRCs, key frames every k
frames, YCbCr 4:2:0 / 4:2:2 / 4:4:4 and grey at 8 and 10 bits, RGB with and
without alpha).

Each writer mirrors its decoder: it knows the pictures it codes, so its
streams are held to cv2's decode of them (`tests/test_torch_lossless.py`,
which also holds the port to cv2).  `make_file(path, seed, codec, options,
mux)` writes a stream of the manifest (`tests/make_lossless_corpus.py`) into
AVI or Matroska; `random_options(codec, seed)` draws a feature mix.

Run as a script, it writes one stream: `python tests/torch_lossless_syntax.py
ffv1 7 out.avi`.
"""

from __future__ import annotations

import functools
import heapq
import importlib.util
import struct
import sys
import zlib
from pathlib import Path

import numpy as np

REPO = Path(__file__).resolve().parent.parent
if str(REPO) not in sys.path:
    sys.path.insert(0, str(REPO))

from omfs4d_torch.io import huffyuv_tables  # noqa: E402

CODECS = ("raw", "png", "huffyuv", "ffv1")


# ── pictures ────────────────────────────────────────────────────────────

def picture(rng: np.random.Generator, height: int, width: int, depth: int = 8,
            kind: str | None = None) -> np.ndarray:
    """A test plane of `depth` bits: a mix of flat areas, ramps and noise, so
    that every predictor, run mode and context is used."""
    top = (1 << depth) - 1
    kind = kind or rng.choice(["noise", "ramp", "flat", "mixed"])
    yy, xx = np.mgrid[0:height, 0:width]
    if kind == "noise":
        return rng.integers(0, top + 1, (height, width))
    if kind == "flat":
        out = np.full((height, width), rng.integers(0, top + 1))
        out[rng.random((height, width)) < 0.05] = rng.integers(0, top + 1)
        return out
    ramp = (xx * rng.integers(-3, 4) + yy * rng.integers(-3, 4) + rng.integers(0, top + 1))
    if kind == "ramp":
        return ramp % (top + 1)
    noise = rng.integers(-2, 3, (height, width)) * (rng.random((height, width)) < 0.3)
    out = (ramp + noise) % (top + 1)
    y0, x0 = rng.integers(0, height), rng.integers(0, width)
    out[y0:y0 + height // 3, x0:x0 + width // 3] = rng.integers(0, top + 1)
    return out


# ── containers ──────────────────────────────────────────────────────────

def _chunk(fcc: bytes, data: bytes) -> bytes:
    return fcc + struct.pack("<I", len(data)) + data + b"\x00" * (len(data) & 1)


def _list(kind: bytes, *parts: bytes) -> bytes:
    body = kind + b"".join(parts)
    return b"LIST" + struct.pack("<I", len(body)) + body


def bitmapinfo(width: int, height: int, fourcc: bytes, bits: int, extradata: bytes = b"") -> bytes:
    """A BITMAPINFOHEADER (height signed: > 0 bottom-up for BI_RGB) and the
    extradata after it."""
    return struct.pack("<IiiHH4sIiiII", 40 + len(extradata), width, height, 1, bits, fourcc,
                       abs(width * height) * max(bits, 8) // 8, 0, 0, 0, 0) + extradata


def write_avi(path, samples: list[bytes], width: int, height: int, fourcc: bytes, bits: int,
              extradata: bytes = b"", fps: int = 30, key: list[bool] | None = None) -> Path:
    """An AVI of one video stream, as FFmpeg's AVI muxer lays it out: its
    BITMAPINFOHEADER of `fourcc`, `bits` and a signed `height`, `00dc`
    chunks, an idx1 flagging `key` (every sample where None)."""
    n = len(samples)
    key = key or [True] * n
    h = abs(height)
    biggest = max(len(s) for s in samples)
    avih = struct.pack("<10I16x", 1000000 // fps, 0, 0, 0x910, n, 0, 1, biggest + 8, width, h)
    strh = struct.pack("<4s4sIHHIIIIIIiI4h", b"vids", fourcc, 0, 0, 0, 0, 1, fps, 0, n,
                       biggest + 8, -1, 0, 0, 0, width, h)
    strf = bitmapinfo(width, height, fourcc, bits, extradata)
    hdrl = _list(b"hdrl", _chunk(b"avih", avih),
                 _list(b"strl", _chunk(b"strh", strh), _chunk(b"strf", strf)))
    movi, index, pos = b"", b"", 4
    for s, k in zip(samples, key):
        index += struct.pack("<4sIII", b"00dc", 0x10 if k else 0, pos, len(s))
        movi += _chunk(b"00dc", s)
        pos += 8 + len(s) + (len(s) & 1)
    body = b"AVI " + hdrl + _list(b"movi", movi) + _chunk(b"idx1", index)
    Path(path).write_bytes(b"RIFF" + struct.pack("<I", len(body)) + body)
    return Path(path)


def write_mkv(path, samples: list[bytes], width: int, height: int, *, codec_id: str,
              private: bytes = b"", fps: int = 30, key: list[bool] | None = None,
              colour_space: bytes = b"") -> Path:
    """A Matroska file of one video track (`tests/torch_mkv_mux.py`, loaded
    by its path), with a `ColourSpace` fourcc where given (`V_UNCOMPRESSED`)."""
    spec = importlib.util.spec_from_file_location(
        "torch_mkv_mux", Path(__file__).resolve().with_name("torch_mkv_mux.py"))
    mux = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mux)
    n = len(samples)
    extra = mux.el(0x2EB524, colour_space) if colour_space else b""
    return mux.write_mkv(path, samples, key or [True] * n,
                         [round(1000 * i / fps) for i in range(n)], codec_id=codec_id,
                         width=width, height=height, private=private,
                         default_duration=round(1e9 / fps), duration_ms=1000 * n / fps,
                         video_extra=extra)


# ── bits ────────────────────────────────────────────────────────────────

def pack_codes(codes: np.ndarray, lengths: np.ndarray) -> bytes:
    """The bits of each code (its low `length` bits, most significant first)
    one after another, zero-padded to a byte."""
    codes = np.asarray(codes, np.uint64)
    lengths = np.asarray(lengths, np.int64)
    parts = []
    for a in range(0, len(codes), 1 << 20):          # a million codes at a time
        c, n = codes[a:a + (1 << 20)], lengths[a:a + (1 << 20)]
        total = int(n.sum())
        starts = np.cumsum(n) - n
        rep_len = np.repeat(n, n)
        k = np.arange(total, dtype=np.int64) - np.repeat(starts, n)
        parts.append(((np.repeat(c, n) >> (rep_len - 1 - k).astype(np.uint64))
                      & np.uint64(1)).astype(np.uint8))
    if not parts:
        return b""
    return np.packbits(np.concatenate(parts)).tobytes()


class BitWriter:
    def __init__(self):
        self.codes: list[int] = []
        self.lens: list[int] = []

    def put(self, n: int, v: int) -> None:
        if n:
            self.codes.append(v & ((1 << n) - 1))
            self.lens.append(n)

    def bytes(self) -> bytes:
        # codes longer than 57 bits are split so that numpy's uint64 holds them
        codes, lens = [], []
        for c, n in zip(self.codes, self.lens):
            while n > 32:
                lens.append(32)
                codes.append(c >> (n - 32) & 0xFFFFFFFF)
                n -= 32
            codes.append(c & ((1 << n) - 1))
            lens.append(n)
        return pack_codes(np.array(codes, np.uint64), np.array(lens, np.int64))


# ── raw ─────────────────────────────────────────────────────────────────

def raw_sample(planes: list[np.ndarray], fourcc: bytes, pad: bool = False) -> bytes:
    """A raw frame of FFmpeg's layout for `fourcc`: `I420` / `IYUV` (Y', Cb,
    Cr planes, chroma half the size rounded up), `YV12` (Cr before Cb),
    `Y800` (rows padded to 4 bytes where `pad`), `RGBA` (R, G, B, A)."""
    if fourcc in (b"I420", b"IYUV", b"YV12"):
        y, cb, cr = planes
        order = (y, cr, cb) if fourcc == b"YV12" else (y, cb, cr)
        return b"".join(np.ascontiguousarray(p, np.uint8).tobytes() for p in order)
    if fourcc == b"Y800":
        rows = np.asarray(planes[0], np.uint8)
        if pad:
            rows = np.concatenate([rows, np.zeros((rows.shape[0], -rows.shape[1] % 4),
                                                  np.uint8)], 1)
        return rows.tobytes()
    return np.stack(planes[:4], -1).astype(np.uint8).tobytes()


def bi_rgb_sample(rgb: np.ndarray, bits: int, bottom_up: bool, alpha: np.ndarray | None = None
                  ) -> bytes:
    """A BI_RGB frame: B, G, R (, A) bytes, rows padded to 4 bytes, the last
    row first where bottom-up."""
    px = rgb[..., ::-1]
    if bits == 32:
        px = np.concatenate([px, alpha[..., None]], -1)
    h, w = rgb.shape[:2]
    rows = px.reshape(h, -1).astype(np.uint8)
    pad = -rows.shape[1] % 4
    rows = np.concatenate([rows, np.zeros((h, pad), np.uint8)], 1)
    return (rows[::-1] if bottom_up else rows).tobytes()


# ── PNG ─────────────────────────────────────────────────────────────────

def _png_chunk(tag: bytes, data: bytes) -> bytes:
    return (struct.pack(">I", len(data)) + tag + data
            + struct.pack(">I", zlib.crc32(tag + data) & 0xFFFFFFFF))


def filter_rows(img: np.ndarray, filters: list[int]) -> bytes:
    """Each row of (H, W, C) uint8 filtered by its filter type (0-4) and
    prefixed with it (the encoder side, from the image's own bytes)."""
    h, w, c = img.shape
    rows = img.reshape(h, w * c).astype(np.int32)
    out = []
    zero = np.zeros(w * c, np.int32)
    for y in range(h):
        x = rows[y]
        b = rows[y - 1] if y else zero
        a = np.concatenate([np.zeros(c, np.int32), x[:-c]])
        cc = np.concatenate([np.zeros(c, np.int32), b[:-c]])
        ft = filters[y]
        if ft == 0:
            r = x
        elif ft == 1:
            r = x - a
        elif ft == 2:
            r = x - b
        elif ft == 3:
            r = x - (a + b) // 2
        else:
            p = a + b - cc
            pa, pb, pc = np.abs(p - a), np.abs(p - b), np.abs(p - cc)
            r = x - np.where((pa <= pb) & (pa <= pc), a, np.where(pb <= pc, b, cc))
        out.append(bytes([ft]) + (r & 0xFF).astype(np.uint8).tobytes())
    return b"".join(out)


def png_bytes(img: np.ndarray, filters: list[int], idat_sizes: int = 1, level: int = 6) -> bytes:
    """(H, W, C) uint8, C in 1-4, as a PNG with the given row filters, its
    data split over `idat_sizes` IDAT chunks."""
    h, w, c = img.shape
    data = zlib.compress(filter_rows(img, filters), level)
    ihdr = struct.pack(">IIBBBBB", w, h, 8, {1: 0, 2: 4, 3: 2, 4: 6}[c], 0, 0, 0)
    step = -(-len(data) // max(idat_sizes, 1))
    idats = b"".join(_png_chunk(b"IDAT", data[k:k + step]) for k in range(0, len(data), step))
    return b"\x89PNG\r\n\x1a\n" + _png_chunk(b"IHDR", ihdr) + idats + _png_chunk(b"IEND", b"")


def ffmpeg_png(img: np.ndarray) -> bytes:
    """A PNG as FFmpeg's encoder (cv2's `MPNG`) filters it: the first row
    Sub, every other Paeth."""
    return png_bytes(img, [1] + [4] * (img.shape[0] - 1), 1, 1)


# ── HuffYUV ─────────────────────────────────────────────────────────────

def huffman_lengths(counts: np.ndarray, limit: int = 24) -> list[int]:
    """Code lengths of a complete prefix code for every symbol (each count
    raised to at least 1), flattened until no code is longer than `limit`."""
    counts = np.maximum(np.asarray(counts, np.float64), 1)
    while True:
        heap = [(float(c), i, [i]) for i, c in enumerate(counts)]
        heapq.heapify(heap)
        depth = [0] * len(counts)
        k = len(counts)
        while len(heap) > 1:
            a, _, sa = heapq.heappop(heap)
            b, _, sb = heapq.heappop(heap)
            for s in sa + sb:
                depth[s] += 1
            heapq.heappush(heap, (a + b, k, sa + sb))
            k += 1
        if max(depth) <= limit:
            return depth
        counts = np.sqrt(counts) + 1


def len_table_bytes(lengths: list[int], rng: np.random.Generator) -> BitWriter:
    """HuffYUV's run-length coded code lengths (store_table, with runs of up
    to 7 written either way at random)."""
    bw = BitWriter()
    i = 0
    while i < len(lengths):
        v = lengths[i]
        r = 1
        while i + r < len(lengths) and lengths[i + r] == v and r < 255:
            r += 1
        if r <= 7 and rng.random() < 0.7:
            bw.put(3, r)
            bw.put(5, v)
        else:
            bw.put(3, 0)
            bw.put(5, v)
            bw.put(8, r)
        i += r
    return bw


def _left(row: np.ndarray, acc: int) -> tuple[np.ndarray, int]:
    row = np.asarray(row, np.int64)
    prev = np.concatenate([[acc], row[:-1]])
    return (row - prev) & 0xFF, int(row[-1]) & 0xFF if len(row) else acc


def _median(row, top, left: int, lefttop: int):
    row = np.asarray(row, np.int64)
    top = np.asarray(top, np.int64)
    L = np.concatenate([[left], row[:-1]])
    LT = np.concatenate([[lefttop], top[:-1]])
    c = (L + top - LT) & 0xFF
    pred = np.maximum(np.minimum(L, top), np.minimum(np.maximum(L, top), c))
    return (row - pred) & 0xFF, int(row[-1]), int(top[-1])


class HuffYUV:
    """A HuffYUV stream: `version` 0 / 1 (the classic tables; the predictor
    and decorrelation in biBitCount's low bits) or 2 (its own tables in the
    extradata, or in every packet with `context`), `fmt` "yuv422" /
    "yuv420" (ffvhuff) / "rgb24" / "rgb32", `predictor` "left" / "plane" /
    "median" (YUV only), `decorrelate` (RGB), `interlace` (None: by height,
    as FFmpeg defaults; True / False: flagged in a version 2 extradata)."""

    FOURCC = {"yuv420": b"FFVH"}

    def __init__(self, width: int, height: int, fmt: str = "yuv422", version: int = 2,
                 predictor: str = "left", decorrelate: bool = True,
                 interlace: bool | None = None, context: bool = False, seed: int = 0):
        self.width, self.height, self.fmt, self.version = width, height, fmt, version
        self.predictor, self.context = predictor, context
        self.rgb = fmt.startswith("rgb")
        self.decorrelate = decorrelate if self.rgb else False
        self.rng = np.random.default_rng(seed)
        self.bpp = {"yuv420": 12, "yuv422": 16, "rgb24": 24, "rgb32": 32}[fmt]
        self.fourcc = self.FOURCC.get(fmt, b"HFYU")
        pred = ("left", "plane", "median").index(predictor)
        if version == 2:
            self.interlaced = (height > 288) if interlace is None else bool(interlace)
            flag = {None: 0, True: 0x10, False: 0x20}[interlace] | (0x40 if context else 0)
            self.extra_head = bytes([pred | (0x40 if self.decorrelate else 0), self.bpp, flag, 0])
            self.bits = self.bpp
            self.tables = None
        else:
            self.interlaced = height > 288
            low = {("left", False): 1, ("left", True): 2, ("plane", False): 3,
                   ("plane", True): 3, ("median", False): 4}[(predictor, self.decorrelate)]
            if predictor == "plane":
                self.decorrelate = self.bpp >= 24
            self.bits = self.bpp | low
            luma, _ = huffyuv_tables.read_len_table(huffyuv_tables.CLASSIC_SHIFT_LUMA)
            chroma, _ = huffyuv_tables.read_len_table(huffyuv_tables.CLASSIC_SHIFT_CHROMA)
            luma_codes = list(huffyuv_tables.CLASSIC_ADD_LUMA)
            chroma_codes = list(huffyuv_tables.CLASSIC_ADD_CHROMA)
            if self.rgb:
                chroma, chroma_codes = luma, luma_codes
            self.tables = [(luma_codes, luma), (chroma_codes, chroma), (chroma_codes, chroma)]

    def _code_tables(self, symbols: list[tuple[np.ndarray, np.ndarray]]):
        counts = np.zeros((3, 256))
        for tabs, vals in symbols:
            for t in range(3):
                counts[t] += np.bincount(vals[tabs == t], minlength=256)[:256]
        noise = self.rng.random((3, 256)) * self.rng.choice([0, 3, 50])
        lengths = [huffman_lengths(counts[t] + noise[t]) for t in range(3)]
        codes = [huffyuv_tables.canonical_codes(n) for n in lengths]
        return [(c, n) for c, n in zip(codes, lengths)]

    def symbols(self, planes) -> tuple[list[int], list[tuple[np.ndarray, np.ndarray]]]:
        """The stream's first raw bytes and its coded symbols (table, value),
        in the decoder's order."""
        return self._rgb_symbols(planes) if self.rgb else self._yuv_symbols(planes)

    def _yuv_symbols(self, planes):
        Y, U, V = (np.asarray(p, np.int64) for p in planes)
        h, w = Y.shape
        w2 = w // 2
        fy = 2 if self.interlaced else 1
        out: list = []
        is420 = self.fmt == "yuv420"
        il = int(self.interlaced)

        def e422(y, u, v):
            n = len(u)
            vals = np.empty(4 * n, np.int64)
            vals[0::4], vals[1::4], vals[2::4], vals[3::4] = y[0::2], u, y[1::2], v
            out.append((np.tile([0, 1, 0, 2], n), vals))

        def egray(y):
            out.append((np.zeros(len(y), np.int64), np.asarray(y, np.int64)))

        head = [int(V[0, 0]), int(Y[0, 1]), int(U[0, 0]), int(Y[0, 0])]
        ry, ly = _left(Y[0, 2:], Y[0, 1])
        ru, lu = _left(U[0, 1:], U[0, 0])
        rv, lv = _left(V[0, 1:], V[0, 0])
        e422(ry, ru, rv)
        if self.predictor in ("left", "plane"):
            plane = self.predictor == "plane"
            y = cy = 1
            while y < h:
                if is420:
                    row = Y[y] - Y[y - fy] if plane and y > il else Y[y]
                    r, ly = _left(row & 0xFF, ly)
                    egray(r)
                    y += 1
                    if y >= h:
                        break
                rows = [Y[y], U[cy], V[cy]]
                if plane and cy > il:
                    rows = [(Y[y] - Y[y - fy]) & 0xFF, (U[cy] - U[cy - fy]) & 0xFF,
                            (V[cy] - V[cy - fy]) & 0xFF]
                ry, ly = _left(rows[0], ly)
                ru, lu = _left(rows[1], lu)
                rv, lv = _left(rows[2], lv)
                e422(ry, ru, rv)
                y += 1
                cy += 1
            return head, out
        y = cy = 1
        if y >= h:
            return head, out
        if self.interlaced:
            ry, ly = _left(Y[1], ly)
            ru, lu = _left(U[1], lu)
            rv, lv = _left(V[1], lv)
            e422(ry, ru, rv)
            y += 1
            cy += 1
            if y >= h:
                return head, out
        ry, ly = _left(Y[fy, :4], ly)
        ru, lu = _left(U[fy, :2], lu)
        rv, lv = _left(V[fy, :2], lv)
        e422(ry, ru, rv)
        ry, ly, lty = _median(Y[fy, 4:], Y[0, 4:], ly, int(Y[0, 3]))
        ru, lu, ltu = _median(U[fy, 2:], U[0, 2:], lu, int(U[0, 1]))
        rv, lv, ltv = _median(V[fy, 2:], V[0, 2:], lv, int(V[0, 1]))
        e422(ry, ru, rv)
        y += 1
        cy += 1
        while y < h:
            if is420:
                while 2 * cy > y:
                    r, ly, lty = _median(Y[y], Y[y - fy], ly, lty)
                    egray(r)
                    y += 1
                if y >= h:
                    break
            ry, ly, lty = _median(Y[y], Y[y - fy], ly, lty)
            ru, lu, ltu = _median(U[cy], U[cy - fy], lu, ltu)
            rv, lv, ltv = _median(V[cy], V[cy - fy], lv, ltv)
            e422(ry, ru, rv)
            y += 1
            cy += 1
        return head, out

    def _rgb_symbols(self, planes):
        R, G, B = (np.asarray(p, np.int64) for p in planes[:3])
        h, w = G.shape
        A = np.asarray(planes[3], np.int64) if self.bpp == 32 else None
        px = {0: B, 1: G, 2: R, 3: A}
        fs = 2 if self.interlaced else 1
        out: list = []
        if self.bpp == 32:
            head = [int(A[h - 1, 0]), int(R[h - 1, 0]), int(G[h - 1, 0]), int(B[h - 1, 0])]
        else:
            head = [int(R[h - 1, 0]), int(G[h - 1, 0]), int(B[h - 1, 0]), 0]
        left = [int(B[h - 1, 0]), int(G[h - 1, 0]), int(R[h - 1, 0]),
                int(A[h - 1, 0]) if A is not None else 255]
        chans = (0, 1, 2, 3) if self.bpp == 32 else (0, 1, 2)

        def emit(res):
            b, g, r = res[0], res[1], res[2]
            if self.decorrelate:
                cols = [(1, g), (0, (b - g) & 0xFF), (2, (r - g) & 0xFF)]
            else:
                cols = [(0, b), (1, g), (2, r)]
            if self.bpp == 32:
                cols.append((2, res[3]))
            n = len(g)
            k = len(cols)
            vals = np.empty(k * n, np.int64)
            tabs = np.empty(k * n, np.int64)
            for j, (t, v) in enumerate(cols):
                vals[j::k], tabs[j::k] = v, t
            out.append((tabs, vals))

        res = {}
        for c in chans:
            res[c], left[c] = _left(px[c][h - 1, 1:], left[c])
        emit(res)
        for y in range(h - 2, -1, -1):
            res = {}
            for c in chans:
                row = px[c][y]
                if self.predictor == "plane" and y < h - 1 - int(self.interlaced):
                    row = (row - px[c][y + fs]) & 0xFF
                res[c], left[c] = _left(row, left[c])
            emit(res)
            if self.predictor == "plane" and self.bpp != 32:
                left[3] = 0
        return head, out

    def header_extradata(self, first_planes) -> bytes:
        """The extradata (version 2's tables from the first frame's symbols,
        or a version 1's 4 bytes; none for version 0)."""
        if self.version != 2:
            return b"" if self.version == 0 else bytes(4)
        # FFmpeg reads tables from the extradata even where every packet
        # brings its own (`context`)
        _, syms = self.symbols(first_planes)
        return self.extra_head + self._new_tables(syms)

    def _new_tables(self, syms) -> bytes:
        """Codes fitted to the symbols (`tables`), and their lengths as the
        stream stores them, run-length coded and padded to a byte."""
        self.tables = self._code_tables(syms)
        bw = BitWriter()
        for _, lengths in self.tables:
            t = len_table_bytes(lengths, self.rng)
            bw.codes += t.codes
            bw.lens += t.lens
        return bw.bytes()

    def packet(self, planes) -> bytes:
        head, syms = self.symbols(planes)
        prefix = self._new_tables(syms) if self.context else b""
        codes = [np.array(head, np.uint64)]
        lens = [np.full(4, 8, np.int64)]
        for tabs, vals in syms:
            tc = [np.asarray(self.tables[t][0], np.uint64) for t in range(3)]
            tl = [np.asarray(self.tables[t][1], np.int64) for t in range(3)]
            c = np.choose(tabs, [t[vals] for t in tc])
            n = np.choose(tabs, [t[vals] for t in tl])
            if (n == 0).any():
                raise ValueError("HuffYUV writer: a symbol with no code")
            codes.append(c)
            lens.append(n)
        body = prefix + pack_codes(np.concatenate(codes), np.concatenate(lens))
        body += bytes(-len(body) % 4 + 4)
        return np.frombuffer(body, ">u4").astype("<u4").tobytes()


# ── FFV1 ────────────────────────────────────────────────────────────────

CONTEXT_SIZE = 32
LOG2_RUN = [0, 0, 0, 0, 1, 1, 1, 1, 2, 2, 2, 2, 3, 3, 3, 3, 4, 4, 5, 5, 6, 6, 7, 7, 8, 9, 10,
            11, 12, 13, 14, 15, 16, 17, 18, 19, 20, 21, 22, 23, 24]


def default_states() -> tuple[list[int], list[int]]:
    """FFmpeg's `ff_build_rac_states(c, 0.05 * 2^32, 256 - 8)`: (zero, one)."""
    zero, one = _default_states()
    return list(zero), list(one)


@functools.cache
def _default_states() -> tuple[tuple[int, ...], tuple[int, ...]]:
    one64 = 1 << 32
    factor = int(0.05 * (1 << 32))
    max_p = 256 - 8
    zero, one = [0] * 256, [0] * 256
    last_p8, p = 0, one64 // 2
    for _ in range(128):
        p8 = (256 * p + one64 // 2) >> 32
        if p8 <= last_p8:
            p8 = last_p8 + 1
        if last_p8 and last_p8 < 256 and p8 <= max_p:
            one[last_p8] = p8
        p += ((one64 - p) * factor + one64 // 2) >> 32
        last_p8 = p8
    for i in range(256 - max_p, max_p + 1):
        if one[i]:
            continue
        p = (i * one64 + 128) >> 8
        p += ((one64 - p) * factor + one64 // 2) >> 32
        p8 = (256 * p + one64 // 2) >> 32
        p8 = min(max(p8, i + 1), max_p)
        one[i] = p8
    for i in range(1, 255):
        zero[i] = 256 - one[256 - i]
    return tuple(zero), tuple(one)


class RangeEncoder:
    """FFmpeg's range encoder (rangecoder.h), with the decoder's count of
    the bytes it reads (`refills`)."""

    def __init__(self):
        self.out = bytearray()
        self.low, self.range = 0, 0xFF00
        self.outstanding_count, self.outstanding_byte = 0, -1
        self.zero, self.one = default_states()
        self.refills = 0

    def custom(self, transition: list[int]) -> None:
        for j in range(1, 256):
            self.one[j] = transition[j]
            self.zero[256 - j] = 256 - transition[j]

    def _renorm(self) -> None:
        while self.range < 0x100:
            if self.outstanding_byte < 0:
                self.outstanding_byte = self.low >> 8
            elif self.low <= 0xFF00:
                self.out.append(self.outstanding_byte)
                self.out += b"\xff" * self.outstanding_count
                self.outstanding_count = 0
                self.outstanding_byte = self.low >> 8
            elif self.low >= 0x10000:
                self.out.append((self.outstanding_byte + 1) & 0xFF)
                self.out += b"\x00" * self.outstanding_count
                self.outstanding_count = 0
                self.outstanding_byte = (self.low >> 8) - 0x100
            else:
                self.outstanding_count += 1
            self.low = (self.low & 0xFF) << 8
            self.range <<= 8
            self.refills += 1

    def put(self, state: list, i: int, bit: int) -> None:
        s = state[i]
        range1 = (self.range * s) >> 8
        if not bit:
            self.range -= range1
            state[i] = self.zero[s]
        else:
            self.low += self.range - range1
            self.range = range1
            state[i] = self.one[s]
        self._renorm()

    def symbol(self, state: list, v: int, signed: bool) -> None:
        if v:
            a = abs(v)
            e = a.bit_length() - 1
            self.put(state, 0, 0)
            for i in range(e):
                self.put(state, 1 + min(i, 9), 1)
            self.put(state, 1 + min(e, 9), 0)
            for i in range(e - 1, -1, -1):
                self.put(state, 22 + min(i, 9), (a >> i) & 1)
            if signed:
                self.put(state, 11 + min(e, 10), 1 if v < 0 else 0)
        else:
            self.put(state, 0, 1)

    def terminate(self, check_bit: bool) -> bytes:
        """FFmpeg's ff_rac_terminate, after a 0 of state 129 where the
        decoder reads one (`check_bit`); the bytes so far."""
        if check_bit:
            self.put([129], 0, 0)
        self.range = 0xFF
        self.low += 0xFF
        self._renorm()
        self.range = 0xFF
        self._renorm()
        self.refills -= 2
        data = bytes(self.out)
        if len(data) != 1 + self.refills:
            raise AssertionError(f"range coder: {len(data)} bytes, the decoder reads "
                                 f"{1 + self.refills}")
        return data


def make_quant_table(runs: list[int], scale: int) -> list[int]:
    t = [0] * 256
    i = 0
    for v, n in enumerate(runs):
        for _ in range(n):
            t[i] = scale * v
            i += 1
    for i in range(1, 128):
        t[256 - i] = -t[i]
    t[128] = -t[127]
    return t


class FFV1:
    """An FFV1 stream: `version` 0, 1 or 3, `coder` 0 (Golomb-Rice), 1
    (range, default states) or 2 (range, a custom state table),
    `colorspace` 0 (YCbCr, `chroma` False for grey, shifts `hs`, `vs`) or 1
    (RGB, `alpha`), `bits` 8-10 (YCbCr), version 3's `slices` (h, v) grid,
    `ec` (slice CRCs), `tables` (quant table runs: each a list of 5 tables'
    run lengths summing to 128; version 3 may have several), `initial`
    (version 3: initial states in the record), `gop` (a key frame every gop
    frames)."""

    def __init__(self, width: int, height: int, *, version: int = 3, coder: int = 1,
                 colorspace: int = 0, bits: int = 8, chroma: bool = True, hs: int = 1,
                 vs: int = 1, alpha: bool = False, slices: tuple[int, int] = (1, 1),
                 ec: bool = False, tables: list | None = None, initial: bool = False,
                 gop: int = 1, seed: int = 0):
        self.width, self.height, self.version, self.coder = width, height, version, coder
        self.colorspace, self.bits, self.chroma = colorspace, bits, chroma or colorspace == 1
        self.hs, self.vs = (hs, vs) if colorspace == 0 and chroma else (0, 0)
        self.alpha = alpha and colorspace == 1
        self.rng = np.random.default_rng(seed)
        self.slices = slices if version >= 2 else (1, 1)
        self.ec = ec and version >= 3
        self.gop = gop
        self.plane_count = 2 + int(self.alpha)
        self.tables_runs = tables or [[[1, 2, 3, 122], [1, 4, 123], [1, 127], [128], [128]]]
        if version < 2:
            self.tables_runs = self.tables_runs[:1]
        self.quant, self.context_count = [], []
        for runs in self.tables_runs:
            scale, qt = 1, []
            for r in runs:
                qt.append(make_quant_table(r, scale))
                scale *= 2 * len(r) - 1
            self.quant.append(qt)
            self.context_count.append((scale + 1) // 2)
        self.transition = None
        if coder == 2:
            _, one = default_states()
            t = [0] * 256
            for i in range(1, 256):
                t[i] = int(np.clip(one[i] + self.rng.integers(-6, 7), 1, 255))
            self.transition = t
        self.initial = None
        if initial and version >= 2 and coder:
            self.initial = [self.rng.integers(40, 216, (n, CONTEXT_SIZE)).tolist()
                            for n in self.context_count]
        # each slice's quant table index a plane, fixed for the stream
        nsl = self.slices[0] * self.slices[1]
        self.qidx = [[int(self.rng.integers(0, len(self.quant))) for _ in range(self.plane_count)]
                     for _ in range(nsl)]
        self.frame = 0
        self.state: dict = {}
        # Golomb-Rice slices of equal samples and equal states code to equal
        # bits: coded once a frame (a 1080p stream of one tile stays quick)
        self._payloads: dict = {}
        self.extradata = self._record() if version >= 2 else b""

    # ── headers ──
    def _header_common(self, c: RangeEncoder, state: list) -> None:
        c.symbol(state, self.coder, False)
        if self.coder == 2:
            _, one = default_states()
            for i in range(1, 256):
                c.symbol(state, self.transition[i] - one[i], True)

    def _write_quant_tables(self, c: RangeEncoder, runs: list) -> None:
        for r in runs:
            st = [128] * CONTEXT_SIZE
            for n in r:
                c.symbol(st, n - 1, False)

    def _record(self) -> bytes:
        c = RangeEncoder()
        state = [128] * CONTEXT_SIZE
        c.symbol(state, self.version, False)
        c.symbol(state, 4, False)                                # micro version
        self._header_common(c, state)
        c.symbol(state, self.colorspace, False)
        c.symbol(state, self.bits, False)
        c.put(state, 0, int(self.chroma))
        c.symbol(state, self.hs, False)
        c.symbol(state, self.vs, False)
        c.put(state, 0, int(self.alpha))
        c.symbol(state, self.slices[0] - 1, False)
        c.symbol(state, self.slices[1] - 1, False)
        c.symbol(state, len(self.quant), False)
        for runs in self.tables_runs:
            self._write_quant_tables(c, runs)
        state2 = [[128] * CONTEXT_SIZE for _ in range(32)]
        for i in range(len(self.quant)):
            if self.initial is None:
                c.put(state, 0, 0)
                continue
            c.put(state, 0, 1)
            for j in range(self.context_count[i]):
                for k in range(CONTEXT_SIZE):
                    pred = self.initial[i][j - 1][k] if j else 128
                    d = (self.initial[i][j][k] - pred + 128) % 256 - 128
                    c.symbol(state2[k], d, True)
        c.symbol(state, int(self.ec), False)
        c.symbol(state, int(self.gop == 1), False)              # intra
        data = c.terminate(False)
        return data + crc32(data).to_bytes(4, "big")

    def _v01_header(self, c: RangeEncoder) -> None:
        state = [128] * CONTEXT_SIZE
        c.symbol(state, self.version, False)
        self._header_common(c, state)
        c.symbol(state, self.colorspace, False)
        if self.version > 0:
            c.symbol(state, self.bits, False)
        c.put(state, 0, int(self.chroma))
        c.symbol(state, self.hs, False)
        c.symbol(state, self.vs, False)
        c.put(state, 0, int(self.alpha))
        self._write_quant_tables(c, self.tables_runs[0])

    # ── samples ──
    def _slice_rects(self):
        nh, nv = self.slices
        w, h = self.width, self.height
        for sy in range(nv):
            for sx in range(nh):
                x0, x1 = sx * w // nh, (sx + 1) * w // nh
                y0, y1 = sy * h // nv, (sy + 1) * h // nv
                yield sx, sy, x0, y0, x1 - x0, y1 - y0

    def _clear(self, k: int) -> None:
        planes = []
        for p in range(self.plane_count):
            qi = self.qidx[k][p] if self.version >= 2 else 0
            n = self.context_count[qi]
            if self.coder:
                if self.initial is not None:
                    st = [list(row) for row in self.initial[qi]]
                else:
                    st = [[128] * CONTEXT_SIZE for _ in range(n)]
                planes.append(st)
            else:
                planes.append([[0, 0, 4, 1] for _ in range(n)])   # drift, bias, error_sum, count
        self.state[k] = planes

    def _encode_line(self, enc, k: int, plane_index: int, cur: list, top: list, tt: list,
                     w: int, nbits: int, run: dict) -> None:
        qi = self.qidx[k][plane_index] if self.version >= 2 else 0
        q = self.quant[qi]
        five = q[3][127] or q[4][127]
        states = self.state[k][plane_index]
        mask = (1 << nbits) - 1
        half = 1 << (nbits - 1)
        run_mode = run_count = 0
        run_index = run["index"]
        for x in range(w):
            L, LT, T, RT = cur[x - 1], top[x - 1], top[x], top[x + 1]
            ctx = q[0][(L - LT) & 0xFF] + q[1][(LT - T) & 0xFF] + q[2][(T - RT) & 0xFF]
            if five:
                ctx += q[3][(cur[x - 2] - L) & 0xFF] + q[4][(tt[x] - T) & 0xFF]
            pred = sorted((L, L + T - LT, T))[1]
            diff = cur[x] - pred
            if ctx < 0:
                ctx, diff = -ctx, -diff
            diff = ((diff + half) & mask) - half
            if self.coder:
                enc.symbol(states[ctx], diff, True)
                continue
            bw = enc
            if ctx == 0:
                run_mode = 1
            if run_mode:
                if diff:
                    while run_count >= 1 << LOG2_RUN[run_index]:
                        run_count -= 1 << LOG2_RUN[run_index]
                        run_index += 1
                        bw.put(1, 1)
                    bw.put(1 + LOG2_RUN[run_index], run_count)
                    if run_index:
                        run_index -= 1
                    run_count = run_mode = 0
                    if diff > 0:
                        diff -= 1
                else:
                    run_count += 1
            if run_mode == 0:
                put_vlc_symbol(bw, states[ctx], diff, nbits)
        if not self.coder and run_mode:
            while run_count >= 1 << LOG2_RUN[run_index]:
                run_count -= 1 << LOG2_RUN[run_index]
                run_index += 1
                enc.put(1, 1)
            if run_count:
                enc.put(1, 1)
        run["index"] = run_index

    def _encode_plane(self, enc, k, plane: np.ndarray, plane_index: int, nbits: int) -> None:
        h, w = plane.shape
        run = {"index": 0}
        rows = [[0] * (w + 6) for _ in range(2)]       # [top, cur] with 3 samples of margin
        for y in range(h):
            rows = [rows[1], rows[0]]
            top, cur = rows[0], rows[1]
            tt = list(cur)                             # the line two above
            cur[3 - 1] = top[3]
            top[3 + w] = top[3 + w - 1]
            vals = plane[y].tolist()
            cur[3:3 + w] = vals
            self._encode_line(enc, k, plane_index, _View(cur, 3), _View(top, 3), _View(tt, 3),
                              w, nbits, run)

    def _encode_rgb(self, enc, k, planes: list[np.ndarray]) -> None:
        h, w = planes[0].shape
        run = {"index": 0}
        n = 3 + int(self.alpha)
        bufs = [[[0] * (w + 6) for _ in range(2)] for _ in range(4)]
        offset = 1 << self.bits
        for y in range(h):
            g = planes[1][y].astype(np.int64)
            b = planes[2][y].astype(np.int64) - g
            r = planes[0][y].astype(np.int64) - g
            g = g + ((b + r) >> 2)
            comps = [g, b + offset, r + offset] + ([planes[3][y].astype(np.int64)] if self.alpha
                                                   else [])
            for p in range(n):
                bufs[p] = [bufs[p][1], bufs[p][0]]
                top, cur = bufs[p]
                tt = list(cur)
                cur[2] = top[3]
                top[3 + w] = top[3 + w - 1]
                cur[3:3 + w] = comps[p].tolist()
                self._encode_line(enc, k, (p + 1) // 2, _View(cur, 3), _View(top, 3),
                                  _View(tt, 3), w, self.bits + 1, run)

    def packet(self, planes: list[np.ndarray]) -> bytes:
        """One frame: Y', Cb, Cr (grey: Y' alone) or R, G, B (, A) planes."""
        key = self.frame % self.gop == 0
        self.frame += 1
        c = RangeEncoder()
        c.put([128], 0, int(key))
        if key and self.version < 2:
            self._v01_header(c)
        out = b""
        for k, (sx, sy, x0, y0, sw, sh) in enumerate(self._slice_rects()):
            if key:
                self._clear(k)
            if k:
                c = RangeEncoder()
            if self.transition is not None:
                c.custom(self.transition)
            if self.version > 2:
                st = [128] * CONTEXT_SIZE
                c.symbol(st, sx, False)
                c.symbol(st, sy, False)
                c.symbol(st, 0, False)
                c.symbol(st, 0, False)
                for p in range(self.plane_count):
                    c.symbol(st, self.qidx[k][p], False)
                c.symbol(st, 3, False)
                c.symbol(st, 0, False)
                c.symbol(st, 1, False)
            enc = c
            if not self.coder:
                head = c.terminate(self.version > 2)
                enc = BitWriter()
                cut = self._cut(planes, x0, y0, sw, sh)
                memo = (cut, repr(self.state[k]), tuple(self.qidx[k]))
                if memo in self._payloads:
                    payload, after = self._payloads[memo]
                    self.state[k] = eval(after)
                    data = head + payload
                else:
                    self._slice_samples(enc, k, planes, x0, y0, sw, sh)
                    payload = enc.bytes()
                    self._payloads = {memo: (payload, repr(self.state[k]))}
                    data = head + payload
            else:
                self._slice_samples(enc, k, planes, x0, y0, sw, sh)
            if self.coder:
                data = c.terminate(self.version > 2)
            if k or self.version > 2:
                data += len(data).to_bytes(3, "big")
            if self.ec:
                data += b"\x00"
                data += crc32(data).to_bytes(4, "big")
            out += data
        return out

    def _cut(self, planes, x0, y0, w, h) -> bytes:
        """A slice's samples, as bytes (the payload cache's key)."""
        if self.colorspace == 1 or not self.chroma:
            return b"".join(np.ascontiguousarray(p[y0:y0 + h, x0:x0 + w]).tobytes()
                            for p in planes)
        cx, cy = x0 >> self.hs, y0 >> self.vs
        cw, ch = -(-w >> self.hs), -(-h >> self.vs)
        return (np.ascontiguousarray(planes[0][y0:y0 + h, x0:x0 + w]).tobytes()
                + b"".join(np.ascontiguousarray(p[cy:cy + ch, cx:cx + cw]).tobytes()
                           for p in planes[1:3]))

    def _slice_samples(self, enc, k, planes, x0, y0, w, h) -> None:
        if self.colorspace == 1:
            self._encode_rgb(enc, k, [p[y0:y0 + h, x0:x0 + w] for p in planes])
            return
        nbits = max(self.bits, 8)
        self._encode_plane(enc, k, planes[0][y0:y0 + h, x0:x0 + w], 0, nbits)
        if self.chroma:
            cx, cy = x0 >> self.hs, y0 >> self.vs
            cw, ch = -(-w >> self.hs), -(-h >> self.vs)
            for p in planes[1:3]:
                self._encode_plane(enc, k, p[cy:cy + ch, cx:cx + cw], 1, nbits)


class _View:
    """A list seen from an offset, so that index -1 reads the margin."""

    __slots__ = ("a", "o")

    def __init__(self, a: list, o: int):
        self.a, self.o = a, o

    def __getitem__(self, i: int) -> int:
        return self.a[i + self.o]


def put_vlc_symbol(bw: BitWriter, st: list, v: int, bits: int) -> None:
    """FFV1's Golomb-Rice symbol with its adaptive state (drift, bias,
    error_sum, count), as FFmpeg's put_vlc_symbol."""
    drift, bias, error_sum, count = st
    half = 1 << (bits - 1)
    v = ((v - bias + half) & ((1 << bits) - 1)) - half
    i, k = count, 0
    while i < error_sum:
        k += 1
        i += i
    code = v ^ (-1 if (2 * drift + count) < 0 else 0)
    # set_sr_golomb then set_ur_golomb(limit 12, esc_len bits)
    u = 2 * code if code >= 0 else -2 * code - 1
    e = u >> k
    if e < 12:
        bw.put(e + k + 1, (1 << k) + (u & ((1 << k) - 1)))
    else:
        bw.put(12 + bits, u - 12 + 1)
    # update_vlc_state
    error_sum = (error_sum + abs(v)) & 0xFFFF
    drift += v
    if count == 128:
        count >>= 1
        drift >>= 1
        error_sum >>= 1
    count += 1
    if drift <= -count:
        bias = max(bias - 1, -128)
        drift = max(drift + count, -count + 1)
    elif drift > 0:
        bias = min(bias + 1, 127)
        drift = min(drift - count, 0)
    st[:] = [drift, bias, error_sum, count]


def _crc_table() -> list[int]:
    table = []
    for i in range(256):
        c = i << 24
        for _ in range(8):
            c = ((c << 1) ^ 0x04C11DB7) & 0xFFFFFFFF if c & 0x80000000 else (c << 1) & 0xFFFFFFFF
        table.append(c)
    return table


_CRC_TABLE = _crc_table()


def crc32(data: bytes) -> int:
    """CRC-32 of polynomial 0x04C11DB7, most significant bit first, from 0,
    no inversion (FFmpeg's AV_CRC_32_IEEE as FFV1 uses it)."""
    c, table = 0, _CRC_TABLE
    for b in data:
        c = ((c << 8) & 0xFFFFFFFF) ^ table[(c >> 24) ^ b]
    return c


# ── streams ─────────────────────────────────────────────────────────────

def _runs(rng: np.random.Generator, n: int) -> list[int]:
    """n run lengths (the first at least 1) summing to 128."""
    if n == 1:
        return [128]
    cuts = sorted(rng.choice(np.arange(1, 128), n - 1, replace=False).tolist())
    return [b - a for a, b in zip([0] + cuts, cuts + [128])]


def random_options(codec: str, seed: int) -> dict:
    """A feature mix of `codec` drawn from `seed`: the writer's options, the
    frame size and count, and the container."""
    rng = np.random.default_rng(seed)
    mux = str(rng.choice(["avi", "mkv"]))
    if codec == "raw":
        # cv2 5.0.0 corrupts its heap reading a bottom-up BGR24 frame (it
        # copies FFmpeg's flipped picture as if its rows ran down): those
        # are held to the writer's pictures alone
        fourcc = str(rng.choice(["BI_RGB", "BI_RGB", "I420", "IYUV", "YV12", "Y800", "RGBA"]))
        bits = int(rng.choice([24, 32])) if fourcc == "BI_RGB" else 0
        return {"fourcc": fourcc, "bits": bits,
                "bottom_up": bool(bits == 32 and rng.random() < 0.7),
                "pad": bool(rng.random() < 0.5),
                "width": int(rng.integers(1, 40)), "height": int(rng.integers(1, 30)),
                "frames": int(rng.integers(1, 4)),
                "mux": "avi" if fourcc == "BI_RGB" else mux}
    if codec == "png":
        return {"channels": int(rng.choice([1, 2, 3, 4])), "idat": int(rng.integers(1, 5)),
                "width": int(rng.integers(1, 40)), "height": int(rng.integers(1, 30)),
                "frames": int(rng.integers(1, 4)), "level": int(rng.integers(0, 10)),
                "mux": mux}
    if codec == "huffyuv":
        fmt = str(rng.choice(["yuv422", "yuv420", "rgb24", "rgb32"]))
        rgb = fmt.startswith("rgb")
        version = int(rng.choice([0, 1, 2])) if fmt != "yuv420" else 2
        preds = ["left", "plane"] if rgb else ["left", "plane", "median"]
        predictor = str(rng.choice(preds))
        tall = rng.random() < 0.1
        width = int(rng.integers(2, 12)) * 4
        height = int(rng.integers(290, 300)) if tall else int(rng.integers(1, 14)) * 2
        if fmt == "yuv420":                       # FFmpeg's 4:2:0 rows come in fours
            height = -(-height // 4) * 4 + 4
        if tall:
            width = 8
        return {"fmt": fmt, "version": version, "predictor": predictor,
                "decorrelate": bool(rng.random() < 0.7) if rgb else False,
                "interlace": (None if version < 2 else
                              [None, True, False][int(rng.integers(0, 3))]),
                "context": bool(version == 2 and rng.random() < 0.4),
                "width": width, "height": height, "frames": int(rng.integers(1, 4)),
                "mux": mux}
    if codec == "ffv1":
        version = int(rng.choice([0, 1, 3]))
        colorspace = int(rng.random() < 0.3)
        bits = 8 if colorspace or version == 0 else int(rng.choice([8, 8, 9, 10]))
        chroma = bool(colorspace or rng.random() < 0.8)
        hs, vs = [(1, 1), (1, 0), (0, 0), (2, 0), (1, 1), (0, 1), (2, 2)][int(rng.integers(0, 7))]
        deep = [(0, 0), (1, 0), (1, 1)] + ([(0, 1)] if bits == 10 else [])
        if bits > 8 and (hs, vs) not in deep:        # FFmpeg has no such pixel format
            hs, vs = 1, 1
        ntables = int(rng.integers(1, 4)) if version == 3 else 1
        tables = []
        for _ in range(ntables):
            five = rng.random() < 0.4
            sizes = [int(rng.integers(1, 5)), int(rng.integers(1, 4)), int(rng.integers(1, 4)),
                     int(rng.integers(2, 3)) if five else 1, int(rng.integers(2, 3)) if five else 1]
            tables.append([_runs(rng, n) for n in sizes])
        coder = int(rng.choice([0, 1, 2]))
        return {"version": version, "coder": coder, "colorspace": colorspace, "bits": bits,
                "chroma": chroma, "hs": hs, "vs": vs,
                "alpha": bool(colorspace and rng.random() < 0.5),
                "slices": ([int(rng.integers(1, 3)), int(rng.integers(1, 3))]
                           if version == 3 else [1, 1]),
                "ec": bool(version == 3 and rng.random() < 0.6), "tables": tables,
                "initial": bool(version == 3 and coder and rng.random() < 0.5),
                "gop": int(rng.integers(1, 4)),
                "width": int(rng.integers(4, 28)), "height": int(rng.integers(4, 20)),
                "frames": int(rng.integers(1, 5)), "mux": mux}
    raise ValueError(f"no codec {codec!r}")


def _frames_of(rng, shapes: list[tuple[int, int]], depth: int, n: int):
    """n frames of planes of the given shapes, each a moving variant of the
    first (so that non-key frames carry their contexts over)."""
    base = [picture(rng, h, w, depth) for h, w in shapes]
    out = []
    top = (1 << depth) - 1
    for i in range(n):
        frame = []
        for p in base:
            q = np.roll(p, i, axis=1).copy()
            mask = rng.random(q.shape) < 0.1
            q[mask] = rng.integers(0, top + 1, int(mask.sum()))
            frame.append(q)
        out.append(frame)
    return out


def make_stream(seed: int, codec: str, options: dict | None = None) -> dict:
    """A stream of `codec` from `seed` (options from `random_options` where
    None): its samples, the container's fourcc, bits, signed height and
    extradata, and its options; "png1080" and "ffv1tile" are the 1080p
    streams of the manifest (FFmpeg-style Paeth PNGs; 10-bit 4:2:2 FFV1 in
    16 x 9 slices of one tile)."""
    o = dict(random_options(codec, seed) if options is None else options)
    rng = np.random.default_rng(seed + 1_000_003)
    w, h, n = o["width"], o["height"], o["frames"]
    if codec == "raw":
        tag = o.get("fourcc", "BI_RGB")
        if tag == "BI_RGB":
            frames = [[picture(rng, h, w) for _ in range(4)] for _ in range(n)]
            samples = [bi_rgb_sample(np.stack(f[:3], -1), o["bits"], o["bottom_up"], f[3])
                       for f in frames]
            return {"samples": samples, "fourcc": b"\0\0\0\0", "bits": o["bits"],
                    "height": h if o["bottom_up"] else -h, "extradata": b"", "options": o}
        fourcc = tag.encode()
        if fourcc in (b"I420", b"IYUV", b"YV12"):
            shapes = [(h, w)] + [((h + 1) // 2, (w + 1) // 2)] * 2
        else:
            shapes = [(h, w)] * (1 if fourcc == b"Y800" else 4)
        samples = [raw_sample([picture(rng, *s) for s in shapes], fourcc, o.get("pad", False))
                   for _ in range(n)]
        return {"samples": samples, "fourcc": fourcc,
                "bits": {b"Y800": 8, b"RGBA": 32}.get(fourcc, 12), "height": h,
                "extradata": b"", "options": o}
    if codec == "png":
        samples = []
        for _ in range(n):
            img = np.stack([picture(rng, h, w) for _ in range(o["channels"])], -1)
            filters = rng.integers(0, 5, h).tolist()
            samples.append(png_bytes(img.astype(np.uint8), filters, o["idat"], o["level"]))
        return {"samples": samples, "fourcc": b"MPNG", "bits": 24, "height": h,
                "extradata": b"", "options": o}
    if codec == "png1080":            # FFmpeg-style frames: Sub, then Paeth rows
        tile = np.stack([picture(rng, 120, 120, 8, "mixed") for _ in range(3)], -1)
        samples = [ffmpeg_png(np.roll(np.tile(tile, (h // 120 + 1, w // 120 + 1, 1)),
                                      3 * i, 1)[:h, :w].astype(np.uint8)) for i in range(n)]
        return {"samples": samples, "fourcc": b"MPNG", "bits": 24, "height": h,
                "extradata": b"", "options": o}
    if codec == "huffyuv":
        hy = HuffYUV(w, h, o["fmt"], o["version"], o["predictor"], o["decorrelate"],
                     o["interlace"], o["context"], seed)
        if hy.rgb:
            shapes = [(h, w)] * (4 if o["fmt"] == "rgb32" else 3)
        else:
            ch = (h + 1) // 2 if o["fmt"] == "yuv420" else h
            shapes = [(h, w), (ch, w // 2), (ch, w // 2)]
        frames = _frames_of(rng, shapes, 8, n)
        extradata = hy.header_extradata(frames[0])
        samples = [hy.packet(f) for f in frames]
        return {"samples": samples, "fourcc": hy.fourcc, "bits": hy.bits, "height": h,
                "extradata": extradata, "options": o}
    if codec == "ffv1":
        fv = FFV1(w, h, version=o["version"], coder=o["coder"], colorspace=o["colorspace"],
                  bits=o["bits"], chroma=o["chroma"], hs=o["hs"], vs=o["vs"],
                  alpha=o["alpha"], slices=tuple(o["slices"]), ec=o["ec"], tables=o["tables"],
                  initial=o["initial"], gop=o["gop"], seed=seed)
        if o["colorspace"]:
            shapes = [(h, w)] * (4 if o["alpha"] else 3)
        elif fv.chroma:
            shapes = [(h, w)] + [(-(-h >> fv.vs), -(-w >> fv.hs))] * 2
        else:
            shapes = [(h, w)]
        frames = _frames_of(rng, shapes, o["bits"] if not o["colorspace"] else 8, n)
        samples = [fv.packet(f) for f in frames]
        return {"samples": samples, "fourcc": b"FFV1", "bits": 24, "height": h,
                "extradata": fv.extradata, "options": o,
                "key": [i % fv.gop == 0 for i in range(n)]}
    if codec == "ffv1tile":           # 10-bit 4:2:2, one 120 x 120 tile a slice
        fv = FFV1(w, h, version=3, coder=0, bits=10, hs=1, vs=0,
                  slices=(w // 120, h // 120), ec=True, tables=None, gop=3, seed=seed)
        tile = [picture(rng, 120, 120, 10, "mixed"), picture(rng, 120, 60, 10, "mixed"),
                picture(rng, 120, 60, 10, "mixed")]
        samples = []
        for i in range(n):
            planes = [np.tile(np.roll(t, i, 1), (h // 120, w // 120)) for t in tile]
            samples.append(fv.packet(planes))
        return {"samples": samples, "fourcc": b"FFV1", "bits": 24, "height": h,
                "extradata": fv.extradata, "options": o,
                "key": [i % fv.gop == 0 for i in range(n)]}
    raise ValueError(f"no codec {codec!r}")


def make_file(path, seed: int, codec: str, options: dict | None = None) -> Path:
    """A stream of `make_stream` muxed into AVI or Matroska (`options`'
    "mux"), as the manifest names it."""
    s = make_stream(seed, codec, options)
    o = s["options"]
    w = o["width"]
    if o["mux"] == "avi":
        return write_avi(path, s["samples"], w, s["height"], s["fourcc"], s["bits"],
                         s["extradata"], key=s.get("key"))
    if codec.startswith("ffv1"):
        return write_mkv(path, s["samples"], w, abs(s["height"]), codec_id="V_FFV1",
                         private=s["extradata"], key=s.get("key"))
    if codec == "raw":
        return write_mkv(path, s["samples"], w, abs(s["height"]), codec_id="V_UNCOMPRESSED",
                         colour_space=s["fourcc"])
    private = bitmapinfo(w, abs(s["height"]), s["fourcc"], s["bits"], s["extradata"])
    return write_mkv(path, s["samples"], w, abs(s["height"]), codec_id="V_MS/VFW/FOURCC",
                     private=private, key=s.get("key"))


if __name__ == "__main__":
    make_file(sys.argv[3], int(sys.argv[2]), sys.argv[1])
