"""Baseline JPEG decoding and encoding on the host, with NumPy alone (no
PIL, no OpenCV).

The counterpart of what the JAX package gets from cv2 and PIL: the frames
`omfs4d.io.video.read_image` reads, the `*.jpg` captures of
`omfs4d.track.landmarks`, and the JPEG Baseline (1.2.840.10008.1.2.4.50)
transfer syntax of `omfs4d.io.dicom`.  It reads what a camera, `cv2.imwrite`
or a DICOM JPEG Baseline encoder writes:

- SOF0 and SOF1 frames (8-bit sequential, Huffman-coded), one scan for all
  components or one scan per component;
- one component (gray) or three (YCbCr, or RGB under the Adobe APP14
  transform flag 0 or the component ids 'R', 'G', 'B');
- any integer sampling factors (4:4:4, 4:2:2, 4:2:0, 4:4:0, ...);
- DRI / RSTn restart intervals;
- sides of any length (not multiples of 8 or 16).

Progressive (SOF2), arithmetic-coded, lossless, hierarchical and 12-bit
frames raise `ValueError` naming their SOF marker: they never come out as a
wrong picture.

The arithmetic is libjpeg's default decode, as libjpeg-turbo (which PIL and
cv2 carry) computes it, so the pixels are theirs:

- the integer "islow" inverse DCT of `jidctint.c` (CONST_BITS 13,
  PASS1_BITS 2, the same fixed-point constants and roundings), range-limited
  to 0..255;
- the "fancy" triangle upsampling of `jdsample.c` for chroma at half width
  (h2v1), half height (h1v2) or both (h2v2), with the last sample repeated at
  the edges; other ratios, and h2v1 / h2v2 chroma no wider than 2 samples,
  repeat each sample;
- the fixed-point YCbCr -> RGB tables of `jdcolor.c` (SCALEBITS 16).

A Motion JPEG *video frame* is another matter: cv2.VideoCapture reads it
through FFmpeg's MJPEG decoder and swscale, not libjpeg.  `decode_planes`
gives a frame's Y'CbCr planes at their own sampling through either IDCT,
and `idct_simple` is FFmpeg's (its 8-bit simple IDCT); `mjpeg.frame_rgb`
converts them as swscale does.

Entropy decoding is serial by nature.  It runs in Python per scan, over a
table indexed by the next 16 bits of the bit stream; the next 32 bits at
every bit position of the scan are computed beforehand with NumPy.
Dequantization, the inverse DCT, upsampling and colour conversion then run
over all blocks at once in integer NumPy.

`encode_jpeg` writes what `cv2.imencode('.jpg', ...)` and PIL's `save`
write, byte for byte: libjpeg-turbo's default compression of a baseline
JFIF file (`jccolor.c`'s fixed-point RGB -> YCbCr, `jcsample.c`'s 4:2:0
h2v2 downsampling, `jfdctint.c`'s islow forward DCT, `jcdctmgr.c`'s
rounding quantization with the IJG tables scaled by quality, the standard
Huffman tables of Annex K.3, and the markers in libjpeg's order).  It is the
MJPG rung of the port's video writer (`omfs4d_torch.io.mjpeg`).  Its
entropy coding is vectorised: the (code, length) pairs of every block are
laid out at once, their bit offsets taken from a cumulative sum and packed
byte by byte.
"""

from __future__ import annotations

import struct
from array import array

import numpy as np

# natural (row-major) index of the k-th coefficient in zig-zag order
_ZIGZAG = (
    0, 1, 8, 16, 9, 2, 3, 10, 17, 24, 32, 25, 18, 11, 4, 5,
    12, 19, 26, 33, 40, 48, 41, 34, 27, 20, 13, 6, 7, 14, 21, 28,
    35, 42, 49, 56, 57, 50, 43, 36, 29, 22, 15, 23, 30, 37, 44, 51,
    58, 59, 52, 45, 38, 31, 39, 46, 53, 60, 61, 54, 47, 55, 62, 63,
)

_SOF_NAMES = {
    0xC0: "SOF0 (baseline)", 0xC1: "SOF1 (extended sequential)",
    0xC2: "SOF2 (progressive)", 0xC3: "SOF3 (lossless)",
    0xC5: "SOF5 (differential sequential)", 0xC6: "SOF6 (differential progressive)",
    0xC7: "SOF7 (differential lossless)", 0xC9: "SOF9 (arithmetic sequential)",
    0xCA: "SOF10 (arithmetic progressive)", 0xCB: "SOF11 (arithmetic lossless)",
    0xCD: "SOF13 (arithmetic differential sequential)",
    0xCE: "SOF14 (arithmetic differential progressive)",
    0xCF: "SOF15 (arithmetic differential lossless)",
}

# jidctint.c: FIX(x) = round(x * 2^13)
_CONST_BITS, _PASS1_BITS = 13, 2
_F0298, _F0390, _F0541, _F0765 = 2446, 3196, 4433, 6270
_F0899, _F1175, _F1501, _F1847 = 7373, 9633, 12299, 15137
_F1961, _F2053, _F2562, _F3072 = 16069, 16819, 20995, 25172

_MASK = [(1 << s) - 1 for s in range(17)]


class _Component:
    __slots__ = ("cid", "h", "v", "tq", "q", "width", "height", "bw", "bh", "coef")

    def __init__(self, cid, h, v, tq):
        self.cid, self.h, self.v, self.tq = cid, h, v, tq
        self.q = None


def _huffman_table(counts: bytes, symbols: bytes) -> list[int]:
    """A 65,536-entry table over the next 16 bits of the stream: entry =
    symbol << 5 | code length; 0 where no code starts with those bits."""
    lut = np.zeros(1 << 16, np.int64)
    code = k = 0
    for length in range(1, 17):
        for _ in range(counts[length - 1]):
            if code >= 1 << length:
                raise ValueError("JPEG: a Huffman table with too many codes")
            shift = 16 - length
            lut[code << shift:(code + 1) << shift] = (symbols[k] << 5) | length
            code += 1
            k += 1
        code <<= 1
    return lut.tolist()


def _peek_table(segments: list[bytes]) -> tuple[memoryview, list[int]]:
    """The unstuffed entropy-coded segments of one scan, end to end: the 32
    bits that start at every bit position, and the bit position at which each
    segment (restart interval) starts."""
    starts, parts, n = [], [], 0
    for seg in segments:
        seg = seg.replace(b"\xff\x00", b"\xff")
        starts.append(8 * n)
        parts.append(seg)
        n += len(seg)
    buf = np.frombuffer(b"".join(parts) + bytes(8), np.uint8).astype(np.uint64)
    w = ((buf[:-4] << np.uint64(32)) | (buf[1:-3] << np.uint64(24))
         | (buf[2:-2] << np.uint64(16)) | (buf[3:-1] << np.uint64(8)) | buf[4:])
    peek = np.empty((w.size, 8), np.uint32)
    for j in range(8):
        peek[:, j] = (w >> np.uint64(8 - j)) & np.uint64(0xFFFFFFFF)
    return memoryview(peek.reshape(-1)), starts


def _entropy_segments(data: bytes, pos: int) -> tuple[list[bytes], int]:
    """Split the entropy-coded data that starts at `pos` at its RSTn markers;
    returns the segments (still byte-stuffed) and the position of the marker
    that ends the scan."""
    segments, start, i = [], pos, pos
    while True:
        j = data.find(b"\xff", i)
        if j < 0 or j + 1 >= len(data):
            segments.append(data[start:])
            return segments, len(data)
        k = j + 1
        while k < len(data) and data[k] == 0xFF:      # fill bytes before a marker
            k += 1
        if k >= len(data):
            segments.append(data[start:j])
            return segments, len(data)
        m = data[k]
        if m == 0x00 and k == j + 1:
            i = k + 1
        elif 0xD0 <= m <= 0xD7:
            segments.append(data[start:j])
            start = i = k + 1
        else:
            segments.append(data[start:j])
            return segments, j


def _decode_scan(data, pos, scan, frame, restart):
    """Huffman-decode one scan's blocks into each component's coefficients
    (natural order, not yet dequantized); returns the position after it."""
    comps, dc_luts, ac_luts = zip(*scan)
    segments, end = _entropy_segments(data, pos)
    peek, seg_bits = _peek_table(segments)
    mcus_x, mcus_y = frame[2:4]
    if len(comps) == 1:                     # non-interleaved: a block per MCU
        c = comps[0]
        nx, ny = -(-c.width // 8), -(-c.height // 8)
        mcu = [(0, 0)]
        origins = [(y * c.bw + x,) for y in range(ny) for x in range(nx)]
    else:
        mcu = [(s, v * c.bw + h) for s, c in enumerate(comps)
               for v in range(c.v) for h in range(c.h)]
        origins = [tuple((my * c.v) * c.bw + mx * c.h for c in comps)
                   for my in range(mcus_y) for mx in range(mcus_x)]
    outs = [c.coef for c in comps]
    preds = [0] * len(comps)
    zz, mask = _ZIGZAG, _MASK
    bit = seg_bits[0]
    seg = 0
    try:
        for m, origin in enumerate(origins):
            if restart and m and m % restart == 0:
                seg += 1
                bit, preds = seg_bits[seg], [0] * len(comps)
            for s, off in mcu:
                out, ac = outs[s], ac_luts[s]
                base = (origin[s] + off) << 6
                w = peek[bit]
                t = dc_luts[s][w >> 16]
                if not t:
                    raise ValueError("JPEG: an invalid Huffman code")
                n = t & 31
                size = t >> 5
                if size:
                    val = (w >> (32 - n - size)) & mask[size]
                    if val <= mask[size - 1]:
                        val -= mask[size]
                    preds[s] += val
                bit += n + size
                out[base] = preds[s]
                k = 1
                while k < 64:
                    w = peek[bit]
                    t = ac[w >> 16]
                    n = t & 31
                    rs = t >> 5
                    size = rs & 15
                    if size:
                        k += rs >> 4
                        val = (w >> (32 - n - size)) & mask[size]
                        if val <= mask[size - 1]:
                            val -= mask[size]
                        out[base + zz[k]] = val
                        bit += n + size
                        k += 1
                    elif rs == 0xF0:
                        bit += n
                        k += 16
                    else:
                        if not t:
                            raise ValueError("JPEG: an invalid Huffman code")
                        bit += n
                        break
    except IndexError as e:
        raise ValueError("JPEG: the scan's data ends early or holds a run past "
                         "the 64th coefficient") from e
    return end


def _idct_1d(x, descale):
    """One 8-point pass of jidctint.c's islow IDCT over the last axis: the
    eight outputs rounded right by `descale` bits (int64 in and out)."""
    x0, x1, x2, x3, x4, x5, x6, x7 = (x[..., i] for i in range(8))
    z1 = (x2 + x6) * _F0541
    tmp2 = z1 + x6 * -_F1847
    tmp3 = z1 + x2 * _F0765
    tmp0 = (x0 + x4) << _CONST_BITS
    tmp1 = (x0 - x4) << _CONST_BITS
    tmp10, tmp13 = tmp0 + tmp3, tmp0 - tmp3
    tmp11, tmp12 = tmp1 + tmp2, tmp1 - tmp2
    z1, z2, z3, z4 = x7 + x1, x5 + x3, x7 + x3, x5 + x1
    z5 = (z3 + z4) * _F1175
    o0, o1, o2, o3 = x7 * _F0298, x5 * _F2053, x3 * _F3072, x1 * _F1501
    z1, z2 = z1 * -_F0899, z2 * -_F2562
    z3, z4 = z3 * -_F1961 + z5, z4 * -_F0390 + z5
    o0, o1, o2, o3 = o0 + z1 + z3, o1 + z2 + z4, o2 + z2 + z3, o3 + z1 + z4
    half = 1 << (descale - 1)
    out = (tmp10 + o3, tmp11 + o2, tmp12 + o1, tmp13 + o0,
           tmp13 - o0, tmp12 - o1, tmp11 - o2, tmp10 - o3)
    return np.stack([(v + half) >> descale for v in out], axis=-1)


def idct_islow(coef: np.ndarray) -> np.ndarray:
    """(N, 8, 8) dequantized coefficients (row = vertical frequency) ->
    (N, 8, 8) uint8 samples, as jidctint.c's jpeg_idct_islow computes them."""
    c = coef.astype(np.int64)
    ws = _idct_1d(c.transpose(0, 2, 1), _CONST_BITS - _PASS1_BITS)     # columns
    out = _idct_1d(ws.transpose(0, 2, 1), _CONST_BITS + _PASS1_BITS + 3)  # rows
    return np.clip(out + 128, 0, 255).astype(np.uint8)


# FFmpeg's simple_idct_template.c at 8 bits: round(cos(k pi / 16) sqrt(2) 2^14)
# (W4 one below), the row and column shifts, the shift of a DC-only row
_W1, _W2, _W3, _W4, _W5, _W6, _W7 = 22725, 21407, 19266, 16383, 12873, 8867, 4520
_ROW_SHIFT, _COL_SHIFT, _DC_SHIFT = 11, 20, 3


def _int16(x):
    return ((x + (1 << 15)) & 0xFFFF) - (1 << 15)


def _int32(x):
    return ((x + (1 << 31)) & 0xFFFFFFFF) - (1 << 31)


def _simple_1d(x, a0):
    """The butterflies of FFmpeg's simple IDCT over the last axis from the
    even part's common term `a0` (int64 in, the eight sums out)."""
    x1, x2, x3, x4, x5, x6, x7 = (x[..., i] for i in range(1, 8))
    a = (a0 + _W4 * x4 + _W2 * x2 + _W6 * x6, a0 - _W4 * x4 + _W6 * x2 - _W2 * x6,
         a0 - _W4 * x4 - _W6 * x2 + _W2 * x6, a0 + _W4 * x4 - _W2 * x2 - _W6 * x6)
    b = (_W1 * x1 + _W3 * x3 + _W5 * x5 + _W7 * x7, _W3 * x1 - _W7 * x3 - _W1 * x5 - _W5 * x7,
         _W5 * x1 - _W1 * x3 + _W7 * x5 + _W3 * x7, _W7 * x1 - _W5 * x3 + _W3 * x5 - _W1 * x7)
    return np.stack([a[0] + b[0], a[1] + b[1], a[2] + b[2], a[3] + b[3],
                     a[3] - b[3], a[2] - b[2], a[1] - b[1], a[0] - b[0]], -1)


def idct_simple(coef: np.ndarray) -> np.ndarray:
    """(N, 8, 8) dequantized coefficients (row = vertical frequency) ->
    (N, 8, 8) uint8 samples as FFmpeg's MJPEG decoder computes them (the
    decoder cv2.VideoCapture reads Motion JPEG with): the 8-bit simple IDCT
    (`ff_simple_idct_put_int16_8bit`), with the level shift of 128 carried in
    the DC as FFmpeg does.  Rows first, each held in int16 (a row with only
    its DC set is DC << 3), then columns, clipped to 0..255."""
    c = coef.astype(np.int64)
    c[:, 0, 0] += 1024
    rows = _int16(_int32(_simple_1d(c, _W4 * c[..., 0] + (1 << (_ROW_SHIFT - 1))))
                  >> _ROW_SHIFT)
    dc_only = ~c[..., 1:].any(-1)
    rows = np.where(dc_only[..., None], _int16(c[..., :1] << _DC_SHIFT), rows)
    cols = rows.transpose(0, 2, 1)
    out = _int32(_simple_1d(cols, _W4 * (cols[..., 0] + (1 << (_COL_SHIFT - 1)) // _W4)))
    return np.clip(out >> _COL_SHIFT, 0, 255).astype(np.uint8).transpose(0, 2, 1)


def _edge(x, axis):
    """x with its first and last sample along `axis` repeated once outward."""
    first = np.take(x, [0], axis=axis)
    last = np.take(x, [-1], axis=axis)
    return np.concatenate([first, x, last], axis=axis)


def _interleave(a, b, axis):
    out = np.stack([a, b], axis=axis + 1)
    shape = list(a.shape)
    shape[axis] *= 2
    return out.reshape(shape)


def _fancy_1d(x, axis):
    """jdsample.c's h2v1 (axis 1) / h1v2 (axis 0) triangle filter: 3/4 of the
    nearer sample and 1/4 of the farther one, rounding biases 1 and 2."""
    p = _edge(x, axis)
    n = x.shape[axis]
    prev = np.take(p, np.arange(0, n), axis=axis)
    nxt = np.take(p, np.arange(2, n + 2), axis=axis)
    return _interleave((3 * x + prev + 1) >> 2, (3 * x + nxt + 2) >> 2, axis)


def _fancy_h2v2(x):
    """jdsample.c's h2v2 triangle filter: column sums 3 x nearer row + farther
    row, then 3 x nearer column sum + farther one, rounding biases 8 and 7."""
    p = _edge(x, 0)
    n = x.shape[0]
    colsum = _interleave(3 * x + p[:n], 3 * x + p[2:], 0)
    q = _edge(colsum, 1)
    w = colsum.shape[1]
    return _interleave((3 * colsum + q[:, :w] + 8) >> 4,
                       (3 * colsum + q[:, 2:] + 7) >> 4, 1)


def _upsample(plane, hx, vx):
    """A component plane at (H / vx, W / hx) brought to full size."""
    if hx == vx == 1:
        return plane
    x = plane.astype(np.int32)
    width = plane.shape[1]
    if (hx, vx) == (2, 1) and width > 2:
        return _fancy_1d(x, 1)
    if (hx, vx) == (1, 2):
        return _fancy_1d(x, 0)
    if (hx, vx) == (2, 2) and width > 2:
        return _fancy_h2v2(x)
    return np.repeat(np.repeat(x, vx, axis=0), hx, axis=1)


def _ycc_to_rgb(y, cb, cr):
    """jdcolor.c's ycc_rgb_convert: its fixed-point tables, range-limited."""
    one_half = 1 << 15
    cb = cb.astype(np.int64) - 128
    cr = cr.astype(np.int64) - 128
    fix = lambda v: int(v * 65536 + 0.5)                           # noqa: E731
    r = y + ((fix(1.40200) * cr + one_half) >> 16)
    g = y + ((-fix(0.34414) * cb + one_half - fix(0.71414) * cr) >> 16)
    b = y + ((fix(1.77200) * cb + one_half) >> 16)
    return np.clip(np.stack([r, g, b], axis=-1), 0, 255).astype(np.uint8)


def decode_planes(data: bytes, idct=idct_islow) -> tuple[list[np.ndarray], list, bool, tuple]:
    """JPEG bytes -> its component planes at their own sampling (uint8, each
    ceil(H * v / vmax) x ceil(W * h / hmax)) through `idct`, each one's
    sampling factors (h, v), whether they are Y'CbCr (JFIF, the Adobe flag,
    else not 'R', 'G', 'B' ids) and the frame's (H, W).  Raises ValueError as
    `decode_jpeg` does."""
    data = bytes(data)
    if data[:2] != b"\xff\xd8":
        raise ValueError("not a JPEG file (no SOI marker)")
    qtables, dc_tables, ac_tables = {}, {}, {}
    restart, comps, frame = 0, None, None
    jfif, adobe = False, None
    scans = 0
    pos = 2
    while True:
        if pos + 1 >= len(data):
            if scans:
                break               # a stream cut after its last scan still decodes
            raise ValueError("JPEG: the stream ends before any scan")
        if data[pos] != 0xFF:
            raise ValueError(f"JPEG: expected a marker at byte {pos}")
        while pos < len(data) and data[pos] == 0xFF:
            pos += 1
        marker = data[pos]
        pos += 1
        if marker == 0xD9:
            break
        if marker in (0x01, 0xD8) or 0xD0 <= marker <= 0xD7:
            continue
        (length,) = struct.unpack(">H", data[pos:pos + 2])
        seg = data[pos + 2:pos + length]
        pos += length
        if marker == 0xDB:
            i = 0
            while i < len(seg):
                pq, tq = seg[i] >> 4, seg[i] & 15
                if pq:
                    vals = struct.unpack(">64H", seg[i + 1:i + 129])
                    i += 129
                else:
                    vals = seg[i + 1:i + 65]
                    i += 65
                q = np.zeros(64, np.int64)
                q[list(_ZIGZAG)] = list(vals)
                qtables[tq] = q
        elif marker == 0xC4:
            i = 0
            while i < len(seg):
                tc, th = seg[i] >> 4, seg[i] & 15
                counts = seg[i + 1:i + 17]
                n = sum(counts)
                table = _huffman_table(counts, seg[i + 17:i + 17 + n])
                (ac_tables if tc else dc_tables)[th] = table
                i += 17 + n
        elif marker == 0xDD:
            (restart,) = struct.unpack(">H", seg[:2])
        elif marker in _SOF_NAMES:
            if marker not in (0xC0, 0xC1):
                raise ValueError(f"JPEG: {_SOF_NAMES[marker]} frames are not supported "
                                 "(only 8-bit sequential Huffman: SOF0, SOF1)")
            precision, height, width, nf = struct.unpack(">BHHB", seg[:6])
            if precision != 8:
                raise ValueError(f"JPEG: {precision}-bit {_SOF_NAMES[marker]} frames are "
                                 "not supported (8-bit only)")
            if height == 0 or width == 0:
                raise ValueError("JPEG: a frame of height 0 (set by a DNL marker) or "
                                 "width 0 is not supported")
            if nf not in (1, 3):
                raise ValueError(f"JPEG: {nf} components; 1 (gray) or 3 are supported "
                                 "(not CMYK / YCCK)")
            comps = [_Component(seg[6 + 3 * k], seg[7 + 3 * k] >> 4, seg[7 + 3 * k] & 15,
                                seg[8 + 3 * k]) for k in range(nf)]
            hmax = max(c.h for c in comps)
            vmax = max(c.v for c in comps)
            if any(not c.h or not c.v or hmax % c.h or vmax % c.v for c in comps):
                raise ValueError("JPEG: fractional or zero sampling factors")
            mcus_x, mcus_y = -(-width // (8 * hmax)), -(-height // (8 * vmax))
            for c in comps:
                c.width = -(-width * c.h // hmax)
                c.height = -(-height * c.v // vmax)
                c.bw, c.bh = mcus_x * c.h, mcus_y * c.v
                c.coef = array("i", bytes(4 * 64 * c.bw * c.bh))
            frame = (hmax, vmax, mcus_x, mcus_y, width, height)
        elif marker == 0xDA:
            if frame is None:
                raise ValueError("JPEG: a scan before the frame header")
            ns = seg[0]
            ss, se, a = seg[1 + 2 * ns:4 + 2 * ns]
            if (ss, se, a) != (0, 63, 0):
                raise ValueError("JPEG: a scan with spectral selection or successive "
                                 "approximation in a sequential frame")
            by_id = {c.cid: c for c in comps}
            scan = []
            for k in range(ns):
                c = by_id[seg[1 + 2 * k]]
                td, ta = seg[2 + 2 * k] >> 4, seg[2 + 2 * k] & 15
                if c.q is None:            # libjpeg latches the table at the first scan
                    if c.tq not in qtables:
                        raise ValueError(f"JPEG: quantization table {c.tq} is not defined")
                    c.q = qtables[c.tq]
                if td not in dc_tables or ta not in ac_tables:
                    raise ValueError("JPEG: a scan uses an undefined Huffman table")
                scan.append((c, dc_tables[td], ac_tables[ta]))
            pos = _decode_scan(data, pos, scan, frame, restart)
            scans += 1
        elif marker == 0xE0 and seg[:5] == b"JFIF\x00":
            jfif = True
        elif marker == 0xEE and seg[:5] == b"Adobe" and len(seg) >= 12:
            adobe = seg[11]
        elif marker == 0xDC:
            raise ValueError("JPEG: DNL markers are not supported")
        elif marker in (0xC8, 0xCC):
            raise ValueError(f"JPEG: marker 0x{marker:02X} (arithmetic coding) is not supported")

    if comps is None or not scans:
        raise ValueError("JPEG: no frame or no scan")
    hmax, vmax, _, _, width, height = frame
    planes = []
    for c in comps:
        blocks = np.frombuffer(c.coef, np.int32).reshape(-1, 8, 8) * c.q.reshape(8, 8)
        pixels = idct(blocks).reshape(c.bh, c.bw, 8, 8).transpose(0, 2, 1, 3)
        planes.append(pixels.reshape(c.bh * 8, c.bw * 8)[:c.height, :c.width])
    if jfif:
        ycc = True
    elif adobe is not None:
        ycc = adobe != 0
    else:
        ycc = tuple(c.cid for c in comps) != (82, 71, 66)      # 'R', 'G', 'B'
    return planes, [(c.h, c.v) for c in comps], ycc, (height, width)


def decode_jpeg(data: bytes) -> np.ndarray:
    """JPEG bytes -> (H, W) uint8 for one component, (H, W, 3) uint8 RGB for
    three.  Raises ValueError for what this decoder does not read (see the
    module docstring) and for a corrupt stream."""
    planes, factors, ycc, (height, width) = decode_planes(data)
    hmax, vmax = (max(f[k] for f in factors) for k in (0, 1))
    planes = [_upsample(p, hmax // h, vmax // v)[:height, :width]
              for p, (h, v) in zip(planes, factors)]
    if len(planes) == 1:
        return np.ascontiguousarray(planes[0], dtype=np.uint8)
    if not ycc:
        return np.stack(planes, axis=-1).astype(np.uint8)
    return _ycc_to_rgb(*(p.astype(np.int64) for p in planes))


# ── encoding ────────────────────────────────────────────────────────────

# jcparam.c: the IJG tables of Annex K.1 (natural order), scaled by quality
_STD_LUMA_Q = (
    16, 11, 10, 16, 24, 40, 51, 61, 12, 12, 14, 19, 26, 58, 60, 55,
    14, 13, 16, 24, 40, 57, 69, 56, 14, 17, 22, 29, 51, 87, 80, 62,
    18, 22, 37, 56, 68, 109, 103, 77, 24, 35, 55, 64, 81, 104, 113, 92,
    49, 64, 78, 87, 103, 121, 120, 101, 72, 92, 95, 98, 112, 100, 103, 99,
)
_STD_CHROMA_Q = (
    17, 18, 24, 47, 99, 99, 99, 99, 18, 21, 26, 66, 99, 99, 99, 99,
    24, 26, 56, 99, 99, 99, 99, 99, 47, 66, 99, 99, 99, 99, 99, 99,
) + (99,) * 32

# Annex K.3 (jstdhuff.c): the code counts by length 1..16, then the symbols
_STD_HUFFMAN = {
    (0, 0): (bytes([0, 1, 5, 1, 1, 1, 1, 1, 1, 0, 0, 0, 0, 0, 0, 0]), bytes(range(12))),
    (1, 0): (bytes([0, 2, 1, 3, 3, 2, 4, 3, 5, 5, 4, 4, 0, 0, 1, 125]), bytes.fromhex(
        "01020300041105122131410613516107227114328191a1082342b1c11552d1f0"
        "2433627282090a161718191a25262728292a3435363738393a43444546474849"
        "4a535455565758595a636465666768696a737475767778797a83848586878889"
        "8a92939495969798999aa2a3a4a5a6a7a8a9aab2b3b4b5b6b7b8b9bac2c3c4c5"
        "c6c7c8c9cad2d3d4d5d6d7d8d9dae1e2e3e4e5e6e7e8e9eaf1f2f3f4f5f6f7f8"
        "f9fa")),
    (0, 1): (bytes([0, 3, 1, 1, 1, 1, 1, 1, 1, 1, 1, 0, 0, 0, 0, 0]), bytes(range(12))),
    (1, 1): (bytes([0, 2, 1, 2, 4, 4, 3, 4, 7, 5, 4, 4, 0, 1, 2, 119]), bytes.fromhex(
        "000102031104052131061241510761711322328108144291a1b1c109233352f0"
        "156272d10a162434e125f11718191a262728292a35363738393a434445464748"
        "494a535455565758595a636465666768696a737475767778797a828384858687"
        "88898a92939495969798999aa2a3a4a5a6a7a8a9aab2b3b4b5b6b7b8b9bac2c3"
        "c4c5c6c7c8c9cad2d3d4d5d6d7d8d9dae2e3e4e5e6e7e8e9eaf2f3f4f5f6f7f8"
        "f9fa")),
}

# jfdctint.c's FIX constants are jidctint.c's (_F0298 ... _F3072 above)


def _quant_tables(quality: int) -> tuple[np.ndarray, np.ndarray]:
    """The luminance and chrominance quantization tables (natural order) that
    libjpeg's `jpeg_set_quality(quality, force_baseline=TRUE)` sets."""
    if not 0 <= quality <= 100:
        raise ValueError(f"JPEG quality {quality}: expected 0..100")
    q = max(quality, 1)
    scale = 5000 // q if q < 50 else 200 - 2 * q
    return tuple(np.clip((np.array(t, np.int64) * scale + 50) // 100, 1, 255)
                 for t in (_STD_LUMA_Q, _STD_CHROMA_Q))


def _huffman_codes(counts: bytes, symbols: bytes) -> tuple[np.ndarray, np.ndarray]:
    """jchuff.c's derived encoding table: (code, length) of each symbol."""
    code_of = np.zeros(256, np.int64)
    size_of = np.zeros(256, np.int64)
    code = k = 0
    for length in range(1, 17):
        for _ in range(counts[length - 1]):
            code_of[symbols[k]], size_of[symbols[k]] = code, length
            code += 1
            k += 1
        code <<= 1
    return code_of, size_of


_CODES = {key: _huffman_codes(*table) for key, table in _STD_HUFFMAN.items()}


def _fdct_1d(x, first_pass):
    """One 8-point pass of jfdctint.c's islow forward DCT over the last axis
    (int64 in and out): the row pass keeps PASS1_BITS of extra precision, the
    column pass takes them off and leaves the outputs scaled up by 8."""
    x0, x1, x2, x3, x4, x5, x6, x7 = (x[..., i] for i in range(8))
    tmp0, tmp7 = x0 + x7, x0 - x7
    tmp1, tmp6 = x1 + x6, x1 - x6
    tmp2, tmp5 = x2 + x5, x2 - x5
    tmp3, tmp4 = x3 + x4, x3 - x4
    tmp10, tmp13 = tmp0 + tmp3, tmp0 - tmp3
    tmp11, tmp12 = tmp1 + tmp2, tmp1 - tmp2
    if first_pass:
        d0, d4 = (tmp10 + tmp11) << _PASS1_BITS, (tmp10 - tmp11) << _PASS1_BITS
        n = _CONST_BITS - _PASS1_BITS
    else:
        half = 1 << (_PASS1_BITS - 1)
        d0 = (tmp10 + tmp11 + half) >> _PASS1_BITS
        d4 = (tmp10 - tmp11 + half) >> _PASS1_BITS
        n = _CONST_BITS + _PASS1_BITS
    half = 1 << (n - 1)
    z1 = (tmp12 + tmp13) * _F0541
    d2 = (z1 + tmp13 * _F0765 + half) >> n
    d6 = (z1 - tmp12 * _F1847 + half) >> n
    z1, z2, z3, z4 = tmp4 + tmp7, tmp5 + tmp6, tmp4 + tmp6, tmp5 + tmp7
    z5 = (z3 + z4) * _F1175
    tmp4, tmp5, tmp6, tmp7 = tmp4 * _F0298, tmp5 * _F2053, tmp6 * _F3072, tmp7 * _F1501
    z1, z2 = z1 * -_F0899, z2 * -_F2562
    z3, z4 = z3 * -_F1961 + z5, z4 * -_F0390 + z5
    d7 = (tmp4 + z1 + z3 + half) >> n
    d5 = (tmp5 + z2 + z4 + half) >> n
    d3 = (tmp6 + z2 + z3 + half) >> n
    d1 = (tmp7 + z1 + z4 + half) >> n
    return np.stack([d0, d1, d2, d3, d4, d5, d6, d7], axis=-1)


def fdct_islow(samples: np.ndarray) -> np.ndarray:
    """(N, 8, 8) uint8 samples -> (N, 8, 8) int64 DCT coefficients scaled up
    by 8 (row = vertical frequency), as jfdctint.c's jpeg_fdct_islow computes
    them from the samples less 128."""
    x = samples.astype(np.int64) - 128
    ws = _fdct_1d(x, True)                                             # rows
    return _fdct_1d(ws.transpose(0, 2, 1), False).transpose(0, 2, 1)  # columns


def _quantize(coef: np.ndarray, table: np.ndarray) -> np.ndarray:
    """jcdctmgr.c: each coefficient over 8 x its table entry, rounded half
    away from zero; (N, 64) in zig-zag order out."""
    d = table.reshape(8, 8) * 8
    q = (np.abs(coef) + d // 2) // d
    return (np.sign(coef) * q).reshape(-1, 64)[:, list(_ZIGZAG)]


def _blocks(plane: np.ndarray) -> np.ndarray:
    """(8 by, 8 bx) plane -> (by, bx, 8, 8) blocks."""
    h, w = plane.shape
    return plane.reshape(h // 8, 8, w // 8, 8).transpose(0, 2, 1, 3)


def _edge_pad(plane: np.ndarray, height: int, width: int) -> np.ndarray:
    """The last row and column repeated out to (height, width)."""
    return np.pad(plane, ((0, height - plane.shape[0]), (0, width - plane.shape[1])),
                  mode="edge")


def _rgb_to_ycc(rgb: np.ndarray):
    """jccolor.c's rgb_ycc_convert: its fixed-point tables (SCALEBITS 16)."""
    fix = lambda v: int(v * 65536 + 0.5)                           # noqa: E731
    r, g, b = (rgb[..., i].astype(np.int64) for i in range(3))
    half, offset = 1 << 15, 128 << 16
    y = (fix(0.29900) * r + fix(0.58700) * g + fix(0.11400) * b + half) >> 16
    cb = (-fix(0.16874) * r - fix(0.33126) * g + fix(0.5) * b + offset + half - 1) >> 16
    cr = (fix(0.5) * r - fix(0.41869) * g - fix(0.08131) * b + offset + half - 1) >> 16
    return y, cb, cr


def _h2v2_downsample(plane: np.ndarray, width_blocks: int) -> np.ndarray:
    """jcsample.c's h2v2_downsample with its prep controller's edges: the
    plane's rows made even and its columns made 16 x `width_blocks` by
    repeating the last one, then each 2 x 2 box averaged with a bias of 1, 2,
    1, 2, ... along the row."""
    h = plane.shape[0]
    x = _edge_pad(plane, h + (h & 1), 16 * width_blocks)
    s = x[0::2, 0::2] + x[0::2, 1::2] + x[1::2, 0::2] + x[1::2, 1::2]
    bias = np.tile([1, 2], s.shape[1] // 2)
    return (s + bias) >> 2


def ycc_planes(rgb: np.ndarray) -> tuple[np.ndarray, np.ndarray, np.ndarray]:
    """(H, W, 3) uint8 RGB -> the Y', Cb, Cr planes `encode_jpeg` codes
    (uint8; chroma ceil(H / 2) x ceil(W / 2)): what a decode of its bytes
    gives back but for the codec's loss."""
    h, w = rgb.shape[:2]
    y, cb, cr = _rgb_to_ycc(np.asarray(rgb))
    chroma = [_h2v2_downsample(c, -(-w // 16))[:-(-h // 2), :-(-w // 2)] for c in (cb, cr)]
    return tuple(p.astype(np.uint8) for p in [y] + chroma)


def _y_blocks_420(y: np.ndarray, table: np.ndarray, mcus_y: int, mcus_x: int) -> np.ndarray:
    """The luminance blocks of every 4:2:0 MCU, quantized, (MCUs, 4, 64):
    the plane's blocks, then jccoefct.c's dummy blocks where the plane's
    blocks do not fill the last MCU column or row (zero, with the DC of the
    block before them in the MCU)."""
    h, w = y.shape
    by, bx = -(-h // 8), -(-w // 8)
    coef = _quantize(fdct_islow(_blocks(_edge_pad(y, 8 * by, 8 * bx)).reshape(-1, 8, 8)), table)
    grid = np.zeros((2 * mcus_y, 2 * mcus_x, 64), np.int64)
    grid[:by, :bx] = coef.reshape(by, bx, 64)
    if bx & 1:                         # a dummy block right of the last column
        grid[:by, bx, 0] = grid[:by, bx - 1, 0]
    if by & 1:                         # a row of dummies under the last row
        grid[by, :, 0] = np.repeat(grid[by - 1, 1::2, 0], 2)
    return grid.reshape(mcus_y, 2, mcus_x, 2, 64).transpose(0, 2, 1, 3, 4).reshape(-1, 4, 64)


def _value_bits(v: np.ndarray):
    """Each value's magnitude category and its category bits (a negative
    value as its one's complement)."""
    nbits = np.frexp(np.abs(v).astype(np.float64))[1].astype(np.int64)
    bits = np.where(v < 0, v + (1 << nbits) - 1, v)
    return nbits, bits


def _entropy_code(blocks: np.ndarray, tables: np.ndarray, dc_diff: np.ndarray) -> bytes:
    """Huffman-code (N, 64) quantized blocks (zig-zag order) in scan order,
    block n with the standard tables of class `tables[n]` (0 luminance, 1
    chrominance) and DC difference `dc_diff[n]`, as jchuff.c's
    encode_one_block does; flushed with one bits and byte-stuffed."""
    n_blocks = blocks.shape[0]
    dc_code = np.stack([_CODES[(0, t)][0] for t in (0, 1)])
    dc_size = np.stack([_CODES[(0, t)][1] for t in (0, 1)])
    ac_code = np.stack([_CODES[(1, t)][0] for t in (0, 1)])
    ac_size = np.stack([_CODES[(1, t)][1] for t in (0, 1)])
    keys, vals, lens = [], [], []

    # the DC difference: its category's code, then the category bits
    nb, bits = _value_bits(dc_diff)
    keys.append(np.arange(n_blocks, dtype=np.int64) * 256)
    vals.append((dc_code[tables, nb] << nb) | bits)
    lens.append(dc_size[tables, nb] + nb)

    # each non-zero AC coefficient: its run of zeros (a ZRL per 16 of them),
    # then the code of (run, category) and the category bits
    ac = blocks[:, 1:]
    bi, ki = np.nonzero(ac)
    t = tables[bi]
    first = np.ones(bi.size, bool)
    first[1:] = bi[1:] != bi[:-1]
    prev = np.where(first, -1, np.concatenate([[-1], ki[:-1]]))
    run = ki - prev - 1
    nb, bits = _value_bits(ac[bi, ki])
    sym = ((run & 15) << 4) | nb
    keys.append(bi * 256 + 2 + 2 * ki)
    vals.append((ac_code[t, sym] << nb) | bits)
    lens.append(ac_size[t, sym] + nb)
    zrl = run >> 4
    has = zrl > 0
    if has.any():
        zc, zs, zn = ac_code[t[has], 0xF0], ac_size[t[has], 0xF0], zrl[has]
        zval = np.zeros(zn.size, np.int64)
        for j in range(3):                 # at most 3 ZRLs: a run is < 63
            more = zn > j
            zval[more] = (zval[more] << zs[more]) | zc[more]
        keys.append(bi[has] * 256 + 1 + 2 * ki[has])
        vals.append(zval)
        lens.append(zs * zn)

    # EOB where the block's last coefficient is zero
    eob = ac[:, -1] == 0
    keys.append(np.flatnonzero(eob) * 256 + 255)
    vals.append(ac_code[tables[eob], 0])
    lens.append(ac_size[tables[eob], 0])

    order = np.argsort(np.concatenate(keys), kind="stable")
    val = np.concatenate(vals)[order].astype(np.uint64)
    ln = np.concatenate(lens)[order]
    total = int(ln.sum())
    pad = -total % 8                       # flush_bits: fill with one bits
    if pad:
        val = np.append(val, np.uint64((1 << pad) - 1))
        ln = np.append(ln, pad)
    end = np.cumsum(ln)
    start = end - ln
    # every code lands in the 5 bytes from its first one on (<= 7 + 33 bits)
    x = val << (40 - (start & 7) - ln).astype(np.uint64)
    first_byte = start >> 3
    n_bytes = (total + pad) // 8
    out = np.zeros(n_bytes + 5)
    for j in range(5):
        out += np.bincount(first_byte + j, weights=((x >> np.uint64(32 - 8 * j))
                                                    & np.uint64(0xFF)).astype(np.float64),
                           minlength=n_bytes + 5)
    data = out[:n_bytes].astype(np.uint8)
    ff = np.flatnonzero(data == 0xFF)
    return np.insert(data, ff + 1, 0).tobytes()


def _segment(marker: int, body: bytes) -> bytes:
    return struct.pack(">BBH", 0xFF, marker, len(body) + 2) + body


def standard_dht(chroma: bool = True) -> bytes:
    """The DHT segments of the standard tables, in libjpeg's order: DC 0,
    AC 0, and with `chroma` DC 1, AC 1."""
    return b"".join(_segment(0xC4, bytes([tc << 4 | t]) + b"".join(_STD_HUFFMAN[(tc, t)]))
                    for t in ((0, 1) if chroma else (0,)) for tc in (0, 1))


def encode_jpeg(rgb: np.ndarray, quality: int = 95) -> bytes:
    """(H, W, 3) uint8 RGB, or (H, W) / (H, W, 1) uint8 gray -> baseline JFIF
    bytes, those of `cv2.imencode('.jpg', bgr, [cv2.IMWRITE_JPEG_QUALITY,
    quality])` (libjpeg-turbo's defaults: 4:2:0 for colour, standard Huffman
    tables, no restart markers).  Sides of 1 to 65,535 pixels."""
    img = np.asarray(rgb)
    if img.ndim == 3 and img.shape[2] == 1:
        img = img[..., 0]
    if img.dtype != np.uint8 or not (img.ndim == 2 or (img.ndim == 3 and img.shape[2] == 3)):
        raise ValueError(f"encode_jpeg: {img.dtype} {img.shape}; expected uint8 (H, W) or "
                         "(H, W, 3)")
    height, width = img.shape[:2]
    if not (0 < height < 65536 and 0 < width < 65536):
        raise ValueError(f"encode_jpeg: a {width} x {height} image; JPEG holds sides of "
                         "1 to 65,535")
    luma_q, chroma_q = _quant_tables(quality)
    if img.ndim == 2:
        by, bx = -(-height // 8), -(-width // 8)
        blocks = _quantize(fdct_islow(_blocks(_edge_pad(img, 8 * by, 8 * bx)).reshape(
            -1, 8, 8)), luma_q)
        tables = np.zeros(len(blocks), np.int64)
        dc = blocks[:, 0]
        dc_diff = np.diff(dc, prepend=0)
        comps = [(1, 0x11, 0)]
        used = [(0, luma_q)]
    else:
        y, cb, cr = _rgb_to_ycc(img)
        mcus_y, mcus_x = -(-height // 16), -(-width // 16)
        yb = _y_blocks_420(y, luma_q, mcus_y, mcus_x)
        chroma = []
        for plane in (cb, cr):
            sub = _edge_pad(_h2v2_downsample(plane, mcus_x), 8 * mcus_y, 8 * mcus_x)
            chroma.append(_quantize(fdct_islow(_blocks(sub).reshape(-1, 8, 8)), chroma_q))
        mcu = np.concatenate([yb, chroma[0][:, None], chroma[1][:, None]], axis=1)
        blocks = mcu.reshape(-1, 64)
        tables = np.tile([0, 0, 0, 0, 1, 1], mcu.shape[0])
        diffs = np.empty(mcu.shape[:2], np.int64)
        diffs[:, :4] = np.diff(yb[:, :, 0].reshape(-1), prepend=0).reshape(-1, 4)
        for k in (0, 1):
            diffs[:, 4 + k] = np.diff(chroma[k][:, 0], prepend=0)
        dc_diff = diffs.reshape(-1)
        comps = [(1, 0x22, 0), (2, 0x11, 1), (3, 0x11, 1)]
        used = [(0, luma_q), (1, chroma_q)]

    head = [b"\xff\xd8", _segment(0xE0, b"JFIF\x00\x01\x01\x00\x00\x01\x00\x01\x00\x00")]
    for tq, table in used:
        head.append(_segment(0xDB, bytes([tq]) + bytes(table[list(_ZIGZAG)].tolist())))
    head.append(_segment(0xC0, struct.pack(">BHHB", 8, height, width, len(comps))
                         + b"".join(bytes(c) for c in comps)))
    head.append(standard_dht(chroma=len(used) == 2))
    head.append(_segment(0xDA, bytes([len(comps)]) + b"".join(
        bytes([cid, tq << 4 | tq]) for cid, _, tq in comps) + b"\x00\x3f\x00"))
    return b"".join(head) + _entropy_code(blocks, tables, dc_diff) + b"\xff\xd9"


def main(argv: list[str] | None = None) -> int:
    """`python -m omfs4d_torch.io.jpeg FILE [FILE ...]`: each file's size,
    decoded shape, decode time, and the time of `encode_jpeg` of the decoded
    picture at quality 95, on this host (host clock, best of 3)."""
    import argparse
    import time
    from pathlib import Path

    ap = argparse.ArgumentParser(description=main.__doc__)
    ap.add_argument("files", nargs="+", type=Path)
    args = ap.parse_args(argv)
    for path in args.files:
        data = path.read_bytes()
        best = [float("inf")] * 2
        for _ in range(3):
            t0 = time.perf_counter()
            img = decode_jpeg(data)
            t1 = time.perf_counter()
            encode_jpeg(img, 95)
            best = [min(best[0], t1 - t0), min(best[1], time.perf_counter() - t1)]
        print(f"{path}: {len(data)} bytes -> {img.shape}, decode {best[0]:.3f} s, "
              f"encode_jpeg (quality 95) {best[1]:.3f} s")
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
