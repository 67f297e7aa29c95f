"""First-party DICOM series reader/writer (pydicom is not a dependency).

Port of `omfs4d.io.dicom` (host NumPy; verbatim): the series is read on the
host and handed to the card by the clinical loader.  JPEG Baseline slices
are decoded by the port's own decoder (`omfs4d_torch.io.jpeg`, libjpeg's
arithmetic, no PIL); the writer of test slices encodes them with PIL.

Replaces the reference's pydicom usage (ref: dicom_loader.py:34-106,
compressed decode transparently at dicom_loader.py:97-103): reads a folder
of CT slices, sorts them by ImagePositionPatient Z, applies
RescaleSlope/Intercept to produce a Hounsfield-Unit volume.

Supported transfer syntaxes:
  * Implicit VR Little Endian (1.2.840.10008.1.2), uncompressed
  * Explicit VR Little Endian (1.2.840.10008.1.2.1), uncompressed
  * RLE Lossless (1.2.840.10008.1.2.5) — first-party PackBits decoder
    over the DICOM byte-segment composite (PS3.5 annex G)
  * JPEG Baseline (1.2.840.10008.1.2.4.50) — `omfs4d_torch.io.jpeg`

Any other syntax raises :class:`UnsupportedTransferSyntaxError` naming the
UID (real CBCT exports are frequently compressed; a silent skip was the
likeliest first real-data failure).
"""

from __future__ import annotations

import struct
from pathlib import Path

import numpy as np

from omfs4d_torch.io.jpeg import decode_jpeg


class UnsupportedTransferSyntaxError(ValueError):
    """A DICOM file uses a transfer syntax this reader cannot decode."""

# (group, element) tags we care about
TAG_TRANSFER_SYNTAX = (0x0002, 0x0010)
TAG_ROWS = (0x0028, 0x0010)
TAG_COLS = (0x0028, 0x0011)
TAG_BITS_ALLOCATED = (0x0028, 0x0100)
TAG_PIXEL_REPRESENTATION = (0x0028, 0x0103)
TAG_PIXEL_SPACING = (0x0028, 0x0030)
TAG_SLICE_THICKNESS = (0x0018, 0x0050)
TAG_IMAGE_POSITION = (0x0020, 0x0032)
TAG_RESCALE_INTERCEPT = (0x0028, 0x1052)
TAG_RESCALE_SLOPE = (0x0028, 0x1053)
TAG_PIXEL_DATA = (0x7FE0, 0x0010)

_EXPLICIT_LONG_VRS = {b"OB", b"OW", b"OF", b"OD", b"OL", b"SQ", b"UC", b"UR", b"UT", b"UN"}

IMPLICIT_LE = "1.2.840.10008.1.2"
EXPLICIT_LE = "1.2.840.10008.1.2.1"
RLE_LOSSLESS = "1.2.840.10008.1.2.5"
JPEG_BASELINE = "1.2.840.10008.1.2.4.50"

#: encapsulated syntaxes this reader decodes
COMPRESSED_SYNTAXES = (RLE_LOSSLESS, JPEG_BASELINE)


class DicomSlice:
    """Parsed attributes of one DICOM file."""

    def __init__(self):
        self.rows = 0
        self.cols = 0
        self.bits_allocated = 16
        self.pixel_representation = 0
        self.pixel_spacing = (1.0, 1.0)   # (row, col) spacing
        self.slice_thickness = 1.0
        self.image_position = None         # (x, y, z)
        self.rescale_slope = 1.0
        self.rescale_intercept = 0.0
        self.pixel_bytes = b""
        self.transfer_syntax = EXPLICIT_LE
        self.fragments: list[bytes] | None = None   # encapsulated syntaxes

    def _dtype(self):
        if self.bits_allocated == 16:
            return np.int16 if self.pixel_representation == 1 else np.uint16
        if self.bits_allocated == 8:
            return np.int8 if self.pixel_representation == 1 else np.uint8
        raise ValueError(f"unsupported BitsAllocated={self.bits_allocated}")

    @property
    def pixel_array(self) -> np.ndarray:
        dtype = self._dtype()
        if self.transfer_syntax == RLE_LOSSLESS:
            frame = b"".join(self.fragments)   # single-frame CT slice
            arr = decode_rle_frame(frame, self.rows, self.cols,
                                   self.bits_allocated,
                                   self.pixel_representation)
            return arr
        if self.transfer_syntax == JPEG_BASELINE:
            return _decode_jpeg_baseline(
                b"".join(self.fragments), self.rows, self.cols, dtype)
        arr = np.frombuffer(self.pixel_bytes, dtype=np.dtype(dtype).newbyteorder("<"))
        return arr[: self.rows * self.cols].reshape(self.rows, self.cols)


# ── RLE Lossless (PS3.5 annex G): PackBits over byte segments ───────


def _packbits_decode(data: bytes, expected: int) -> np.ndarray:
    """Apple PackBits decode of one RLE segment to `expected` bytes."""
    out = np.empty(expected, np.uint8)
    i, o, n = 0, 0, len(data)
    while o < expected and i < n:
        h = data[i]
        i += 1
        if h < 128:                      # literal run of h+1 bytes
            cnt = min(h + 1, expected - o)
            out[o:o + cnt] = np.frombuffer(data, np.uint8, cnt, i)
            i += h + 1
            o += cnt
        elif h > 128:                    # replicate next byte 257-h times
            cnt = min(257 - h, expected - o)
            out[o:o + cnt] = data[i]
            i += 1
            o += cnt
        # h == 128: no-op
    if o < expected:
        out[o:] = 0
    return out


def _packbits_encode(data: np.ndarray) -> bytes:
    """PackBits encode one byte segment (writer/test path)."""
    data = np.asarray(data, np.uint8)
    out = bytearray()
    i, n = 0, len(data)
    while i < n:
        # find run length at i
        run = 1
        while i + run < n and run < 128 and data[i + run] == data[i]:
            run += 1
        if run >= 3:
            out.append(257 - run)
            out.append(int(data[i]))
            i += run
            continue
        # literal: extend until a >=3 run starts or 128 bytes
        j = i + 1
        while j < n and j - i < 128:
            if j + 2 < n and data[j] == data[j + 1] == data[j + 2]:
                break
            j += 1
        out.append(j - i - 1)
        out.extend(data[i:j].tobytes())
        i = j
    if len(out) % 2:
        out.append(0)                    # segments are padded to even length
    return bytes(out)


def decode_rle_frame(frame: bytes, rows: int, cols: int,
                     bits_allocated: int, pixel_representation: int) -> np.ndarray:
    """Decode one DICOM RLE frame (64-byte header + PackBits segments).

    16-bit data is a byte composite: segment 0 carries the MOST significant
    byte of every pixel, segment 1 the least (PS3.5 G.2)."""
    if len(frame) < 64:
        raise ValueError("RLE frame shorter than its 64-byte header")
    n_seg = struct.unpack_from("<I", frame, 0)[0]
    offsets = struct.unpack_from("<15I", frame, 4)
    npix = rows * cols
    segs = []
    for s in range(n_seg):
        start = offsets[s]
        end = offsets[s + 1] if (s + 1 < n_seg and offsets[s + 1]) else len(frame)
        segs.append(_packbits_decode(frame[start:end], npix))
    if bits_allocated == 8:
        dtype = np.int8 if pixel_representation else np.uint8
        arr = segs[0].view(dtype)
    else:
        if len(segs) < 2:
            raise ValueError(f"RLE 16-bit frame with {len(segs)} segments")
        dtype = np.int16 if pixel_representation else np.uint16
        comp = ((segs[0].astype(np.uint16) << 8)
                | segs[1].astype(np.uint16))
        arr = comp.view(dtype)
    return arr[:npix].reshape(rows, cols)


def _decode_jpeg_baseline(data: bytes, rows: int, cols: int, dtype) -> np.ndarray:
    """One JPEG Baseline frame through the port's own decoder
    (`omfs4d_torch.io.jpeg`), with the reference's rule for colour: an RGB
    secondary capture becomes the mean of its three channels."""
    try:
        arr = decode_jpeg(data)
    except ValueError as e:
        raise UnsupportedTransferSyntaxError(
            f"JPEG Baseline ({JPEG_BASELINE}) frame not decoded: {e}") from e
    if arr.ndim == 3:                    # RGB secondary capture — luminance
        arr = arr.mean(axis=2)
    return arr.astype(dtype)[:rows, :cols]


def _skip_undefined_sequence(buf: bytes, pos: int) -> int:
    """Advance past an undefined-length SQ by scanning delimiters."""
    depth = 1
    while pos + 8 <= len(buf) and depth > 0:
        group, elem = struct.unpack_from("<HH", buf, pos)
        length = struct.unpack_from("<I", buf, pos + 4)[0]
        pos += 8
        if (group, elem) == (0xFFFE, 0xE000):       # Item
            if length == 0xFFFFFFFF:
                continue                             # contents parsed via delimiters
            pos += length
        elif (group, elem) == (0xFFFE, 0xE00D):      # ItemDelimitation
            continue
        elif (group, elem) == (0xFFFE, 0xE0DD):      # SequenceDelimitation
            depth -= 1
        else:
            # nested undefined-length element inside an item
            if length == 0xFFFFFFFF:
                depth += 1
            else:
                pos += length
    return pos


def _parse_dataset(buf: bytes, pos: int, explicit: bool, wanted: dict, stop_after_pixels: bool = True) -> dict:
    """Sequentially walk elements, capturing tags listed in `wanted`."""
    out = {}
    n = len(buf)
    while pos + 8 <= n:
        group, elem = struct.unpack_from("<HH", buf, pos)
        pos += 4
        tag = (group, elem)
        if explicit and group != 0xFFFE:
            vr = buf[pos : pos + 2]
            if vr in _EXPLICIT_LONG_VRS:
                length = struct.unpack_from("<I", buf, pos + 4)[0]
                pos += 8
            else:
                length = struct.unpack_from("<H", buf, pos + 2)[0]
                pos += 4
        else:
            vr = b""
            length = struct.unpack_from("<I", buf, pos)[0]
            pos += 4

        if length == 0xFFFFFFFF:
            if tag == TAG_PIXEL_DATA and tag in wanted:
                # encapsulated pixel data: Basic Offset Table item + one or
                # more fragment items, closed by a sequence delimiter
                frags, pos = _parse_fragments(buf, pos)
                out[tag] = (vr, frags)
                if stop_after_pixels:
                    return out
                continue
            pos = _skip_undefined_sequence(buf, pos)
            continue

        if tag in wanted:
            out[tag] = (vr, buf[pos : pos + length])
            if tag == TAG_PIXEL_DATA and stop_after_pixels:
                return out
        pos += length
    return out


def _parse_fragments(buf: bytes, pos: int) -> tuple[list[bytes], int]:
    """Items of an encapsulated Pixel Data element -> fragment list.

    The first item is the Basic Offset Table (possibly empty) and is
    dropped; single-frame CT slices concatenate the remaining fragments."""
    items = []
    n = len(buf)
    while pos + 8 <= n:
        group, elem = struct.unpack_from("<HH", buf, pos)
        length = struct.unpack_from("<I", buf, pos + 4)[0]
        pos += 8
        if (group, elem) == (0xFFFE, 0xE000):       # Item (fragment)
            items.append(buf[pos : pos + length])
            pos += length
        elif (group, elem) == (0xFFFE, 0xE0DD):     # SequenceDelimitation
            break
        else:                                        # malformed — stop
            break
    return items[1:] if items else [], pos


def _decode_ds(value: bytes) -> list[float]:
    return [float(x) for x in value.decode("ascii", "ignore").strip("\x00 ").split("\\") if x.strip()]


def _decode_us(vr: bytes, value: bytes) -> int:
    if vr in (b"US", b"SS") or (not vr and len(value) == 2):
        return struct.unpack("<H", value[:2])[0]
    if len(value) >= 2:
        return struct.unpack("<H", value[:2])[0]
    return 0


def read_dicom_file(path: str | Path) -> DicomSlice | None:
    """Parse one DICOM file; returns None if it is not an image slice."""
    raw = Path(path).read_bytes()
    if len(raw) < 200:
        return None
    pos = 0
    explicit = True
    syntax = EXPLICIT_LE
    if raw[128:132] == b"DICM":
        pos = 132
        # File meta group is always explicit VR LE; parse until group != 0x0002
        meta = _parse_dataset_meta(raw, pos)
        pos = meta["end"]
        syntax = meta.get("syntax", EXPLICIT_LE)
    # else: raw dataset without preamble — guess explicit LE, fall back below

    if syntax == IMPLICIT_LE:
        explicit = False
    elif syntax not in (EXPLICIT_LE,) + COMPRESSED_SYNTAXES:
        # crisp failure naming the UID — a silent skip turns a compressed
        # CBCT export into an empty-series mystery downstream
        raise UnsupportedTransferSyntaxError(
            f"{path}: transfer syntax {syntax} is not supported "
            f"(supported: {IMPLICIT_LE} implicit LE, {EXPLICIT_LE} explicit "
            f"LE, {RLE_LOSSLESS} RLE lossless, {JPEG_BASELINE} JPEG "
            f"baseline)")

    wanted = {
        TAG_ROWS, TAG_COLS, TAG_BITS_ALLOCATED, TAG_PIXEL_REPRESENTATION,
        TAG_PIXEL_SPACING, TAG_SLICE_THICKNESS, TAG_IMAGE_POSITION,
        TAG_RESCALE_INTERCEPT, TAG_RESCALE_SLOPE, TAG_PIXEL_DATA,
    }
    fields = _parse_dataset(raw, pos, explicit, {t: None for t in wanted})
    if TAG_PIXEL_DATA not in fields or TAG_IMAGE_POSITION not in fields:
        return None

    s = DicomSlice()
    s.rows = _decode_us(*fields.get(TAG_ROWS, (b"US", b"\x00\x00")))
    s.cols = _decode_us(*fields.get(TAG_COLS, (b"US", b"\x00\x00")))
    s.bits_allocated = _decode_us(*fields.get(TAG_BITS_ALLOCATED, (b"US", b"\x10\x00")))
    s.pixel_representation = _decode_us(*fields.get(TAG_PIXEL_REPRESENTATION, (b"US", b"\x00\x00")))
    if TAG_PIXEL_SPACING in fields:
        vals = _decode_ds(fields[TAG_PIXEL_SPACING][1])
        if len(vals) >= 2:
            s.pixel_spacing = (vals[0], vals[1])
    if TAG_SLICE_THICKNESS in fields:
        vals = _decode_ds(fields[TAG_SLICE_THICKNESS][1])
        if vals:
            s.slice_thickness = vals[0]
    vals = _decode_ds(fields[TAG_IMAGE_POSITION][1])
    if len(vals) >= 3:
        s.image_position = (vals[0], vals[1], vals[2])
    if TAG_RESCALE_SLOPE in fields:
        vals = _decode_ds(fields[TAG_RESCALE_SLOPE][1])
        if vals:
            s.rescale_slope = vals[0]
    if TAG_RESCALE_INTERCEPT in fields:
        vals = _decode_ds(fields[TAG_RESCALE_INTERCEPT][1])
        if vals:
            s.rescale_intercept = vals[0]
    s.transfer_syntax = syntax
    payload = fields[TAG_PIXEL_DATA][1]
    if isinstance(payload, list):          # encapsulated fragments
        s.fragments = payload
    else:
        s.pixel_bytes = payload
    return s


def _parse_dataset_meta(buf: bytes, pos: int) -> dict:
    """Parse the explicit-VR file meta group (group 0x0002)."""
    out = {"end": pos}
    n = len(buf)
    while pos + 8 <= n:
        group, elem = struct.unpack_from("<HH", buf, pos)
        if group != 0x0002:
            break
        vr = buf[pos + 4 : pos + 6]
        if vr in _EXPLICIT_LONG_VRS:
            length = struct.unpack_from("<I", buf, pos + 8)[0]
            value_off = pos + 12
        else:
            length = struct.unpack_from("<H", buf, pos + 6)[0]
            value_off = pos + 8
        if (group, elem) == TAG_TRANSFER_SYNTAX:
            out["syntax"] = buf[value_off : value_off + length].decode("ascii", "ignore").strip("\x00 ")
        pos = value_off + length
    out["end"] = pos
    return out


def load_dicom_series(dicom_path: str | Path):
    """Load a DICOM series folder into a (Z, Y, X) HU volume.

    Parity with the reference loader (dicom_loader.py:34-106): slices are
    sorted by ImagePositionPatient Z; HU = pixel * RescaleSlope +
    RescaleIntercept; Z spacing from consecutive slice positions.

    Returns (volume[Z,Y,X] float32 HU, spacing (z, y, x) in mm).
    """
    path = Path(dicom_path)
    if path.is_file():
        path = path.parent

    slices: list[DicomSlice] = []
    unsupported: list[UnsupportedTransferSyntaxError] = []
    for f in sorted(path.iterdir()):
        if f.is_file() and f.suffix.lower() in (".dcm", ".ima", ""):
            try:
                s = read_dicom_file(f)
            except UnsupportedTransferSyntaxError as e:
                unsupported.append(e)
                continue
            except Exception:
                continue
            if s is not None:
                slices.append(s)

    if not slices:
        if unsupported:
            raise unsupported[0]
        raise FileNotFoundError(
            f"No valid DICOM files found in: {path}. "
            "Ensure the folder contains .dcm slices."
        )

    slices.sort(key=lambda s: s.image_position[2])

    y_spacing, x_spacing = slices[0].pixel_spacing
    if len(slices) > 1:
        z_spacing = abs(slices[1].image_position[2] - slices[0].image_position[2])
    else:
        z_spacing = slices[0].slice_thickness

    volume = np.zeros((len(slices), slices[0].rows, slices[0].cols), dtype=np.float32)
    for i, s in enumerate(slices):
        volume[i] = s.pixel_array.astype(np.float32) * s.rescale_slope + s.rescale_intercept
    return volume, (float(z_spacing), float(y_spacing), float(x_spacing))


# ── Minimal writer (tests + interchange) ────────────────────────────


def _elem_explicit(group: int, elem: int, vr: bytes, value: bytes) -> bytes:
    if len(value) % 2:
        value += b"\x00" if vr not in (b"DS", b"UI", b"LO") else b" "
    if vr in _EXPLICIT_LONG_VRS:
        return struct.pack("<HH2sHI", group, elem, vr, 0, len(value)) + value
    return struct.pack("<HH2sH", group, elem, vr, len(value)) + value


def encode_rle_frame(pixels: np.ndarray) -> bytes:
    """Encode one int16/uint16/uint8 frame as a DICOM RLE frame."""
    pixels = np.ascontiguousarray(pixels)
    if pixels.dtype.itemsize == 2:
        u = pixels.view(np.uint16).reshape(-1)
        segs = [_packbits_encode((u >> 8).astype(np.uint8)),
                _packbits_encode((u & 0xFF).astype(np.uint8))]
    else:
        segs = [_packbits_encode(pixels.view(np.uint8).reshape(-1))]
    offsets = [0] * 15
    off = 64
    for i, seg in enumerate(segs):
        offsets[i] = off
        off += len(seg)
    header = struct.pack("<I15I", len(segs), *offsets)
    return header + b"".join(segs)


def _encapsulate(frames: list[bytes]) -> bytes:
    """Encapsulated PixelData value: empty BOT item + fragment items +
    sequence delimiter (undefined-length OB element body)."""
    out = [struct.pack("<HHI", 0xFFFE, 0xE000, 0)]    # empty offset table
    for fr in frames:
        if len(fr) % 2:
            fr += b"\x00"
        out.append(struct.pack("<HHI", 0xFFFE, 0xE000, len(fr)) + fr)
    out.append(struct.pack("<HHI", 0xFFFE, 0xE0DD, 0))
    return b"".join(out)


def write_dicom_slice(
    path: str | Path,
    pixels: np.ndarray,
    position: tuple[float, float, float],
    pixel_spacing: tuple[float, float] = (1.0, 1.0),
    slice_thickness: float = 1.0,
    rescale_slope: float = 1.0,
    rescale_intercept: float = 0.0,
    transfer_syntax: str = EXPLICIT_LE,
):
    """Write one CT slice (Explicit VR LE, RLE Lossless, or JPEG Baseline).

    The compressed writers exist for interchange/testing parity with the
    reader (RLE roundtrips losslessly; JPEG Baseline is 8-bit lossy and
    expects uint8 input)."""
    if transfer_syntax == JPEG_BASELINE:
        pixels = np.ascontiguousarray(pixels, dtype=np.uint8)
        bits = 8
    else:
        pixels = np.ascontiguousarray(pixels, dtype=np.int16)
        bits = 16
    rows, cols = pixels.shape

    def ds(*vals):
        return "\\".join(f"{v:g}" for v in vals).encode("ascii")

    meta_elems = _elem_explicit(0x0002, 0x0010, b"UI",
                                transfer_syntax.encode("ascii"))
    meta = _elem_explicit(0x0002, 0x0000, b"UL", struct.pack("<I", len(meta_elems))) + meta_elems

    if transfer_syntax == RLE_LOSSLESS:
        pix_elem = (struct.pack("<HH2sHI", 0x7FE0, 0x0010, b"OB", 0,
                                0xFFFFFFFF)
                    + _encapsulate([encode_rle_frame(pixels)]))
    elif transfer_syntax == JPEG_BASELINE:
        from io import BytesIO

        from PIL import Image

        buf = BytesIO()
        Image.fromarray(pixels, mode="L").save(buf, format="JPEG",
                                               quality=95)
        pix_elem = (struct.pack("<HH2sHI", 0x7FE0, 0x0010, b"OB", 0,
                                0xFFFFFFFF)
                    + _encapsulate([buf.getvalue()]))
    else:
        pix_elem = _elem_explicit(0x7FE0, 0x0010, b"OW", pixels.tobytes())

    body = b"".join([
        _elem_explicit(0x0008, 0x0060, b"CS", b"CT"),
        _elem_explicit(0x0018, 0x0050, b"DS", ds(slice_thickness)),
        _elem_explicit(0x0020, 0x0032, b"DS", ds(*position)),
        _elem_explicit(0x0028, 0x0010, b"US", struct.pack("<H", rows)),
        _elem_explicit(0x0028, 0x0011, b"US", struct.pack("<H", cols)),
        _elem_explicit(0x0028, 0x0030, b"DS", ds(*pixel_spacing)),
        _elem_explicit(0x0028, 0x0100, b"US", struct.pack("<H", bits)),
        _elem_explicit(0x0028, 0x0101, b"US", struct.pack("<H", bits)),
        _elem_explicit(0x0028, 0x0102, b"US", struct.pack("<H", bits - 1)),
        _elem_explicit(0x0028, 0x0103, b"US",
                       struct.pack("<H", 1 if bits == 16 else 0)),
        _elem_explicit(0x0028, 0x1052, b"DS", ds(rescale_intercept)),
        _elem_explicit(0x0028, 0x1053, b"DS", ds(rescale_slope)),
        pix_elem,
    ])
    with open(path, "wb") as f:
        f.write(b"\x00" * 128 + b"DICM" + meta + body)
