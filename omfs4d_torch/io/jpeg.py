"""Baseline JPEG decoding on the host, with NumPy alone (no PIL, no OpenCV).

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

Entropy decoding is serial by nature.  It runs in Python per scan, over a
table indexed by the next 16 bits of the bit stream; the next 32 bits at
every bit position of the scan are computed beforehand with NumPy.
Dequantization, the inverse DCT, upsampling and colour conversion then run
over all blocks at once in integer NumPy.
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


def decode_jpeg(data: bytes) -> np.ndarray:
    """JPEG bytes -> (H, W) uint8 for one component, (H, W, 3) uint8 RGB for
    three.  Raises ValueError for what this decoder does not read (see the
    module docstring) and for a corrupt stream."""
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
        pixels = idct_islow(blocks).reshape(c.bh, c.bw, 8, 8).transpose(0, 2, 1, 3)
        plane = pixels.reshape(c.bh * 8, c.bw * 8)[:c.height, :c.width]
        planes.append(_upsample(plane, hmax // c.h, vmax // c.v))
    planes = [p[:height, :width] for p in planes]
    if len(comps) == 1:
        return np.ascontiguousarray(planes[0], dtype=np.uint8)
    if jfif:
        ycc = True
    elif adobe is not None:
        ycc = adobe != 0
    else:
        ycc = tuple(c.cid for c in comps) != (82, 71, 66)      # 'R', 'G', 'B'
    if not ycc:
        return np.stack(planes, axis=-1).astype(np.uint8)
    return _ycc_to_rgb(*(p.astype(np.int64) for p in planes))


def main(argv: list[str] | None = None) -> int:
    """`python -m omfs4d_torch.io.jpeg FILE [FILE ...]`: each file's size,
    decoded shape and decode time on this host (host clock, best of 3)."""
    import argparse
    import time
    from pathlib import Path

    ap = argparse.ArgumentParser(description=main.__doc__)
    ap.add_argument("files", nargs="+", type=Path)
    args = ap.parse_args(argv)
    for path in args.files:
        data = path.read_bytes()
        best = float("inf")
        for _ in range(3):
            t0 = time.perf_counter()
            img = decode_jpeg(data)
            best = min(best, time.perf_counter() - t0)
        print(f"{path}: {len(data)} bytes -> {img.shape}, {best:.3f} s")
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
