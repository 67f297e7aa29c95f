"""Flat-block relays for holding the port's colour management to cv2: random
Y'CbCr codes (R'G'B' in the unit cube, or any code), laid out as 16 x 16
blocks whose centres no chroma filter of either side reaches across, and the
two 8-bit H.264 relays whose cv2 output `tests/make_colour_samples.py`
commits for `chip_smoke.py` (no cv2 on the card's machine).  numpy only."""

from __future__ import annotations

import numpy as np

# (Kr, Kb) of the matrices the relays use
KR_KB = {1: (0.2126, 0.0722), 9: (0.2627, 0.0593)}
# the committed relays: name -> (full range, primaries, transfer, matrix); 8 bits
RELAYS = {"hlg8": (0, 9, 18, 9), "pq8": (0, 9, 16, 9)}
IN_CUBE, WHOLE = 2048, 1024


def codes_in_cube(rng, n: int, bit_depth: int, matrix: int, full: bool) -> np.ndarray:
    """n Y'CbCr code triples of random R'G'B' in [0, 1]."""
    kr, kb = KR_KB[matrix]
    r, g, b = rng.random((3, n))
    y = kr * r + (1 - kr - kb) * g + kb * b
    u, v = (b - y) / (2 * (1 - kb)), (r - y) / (2 * (1 - kr))
    s = 1 << (bit_depth - 8)
    if full:
        ycc = [y * 255 * s, (u * 255 + 128) * s, (v * 255 + 128) * s]
    else:
        ycc = [(16 + 219 * y) * s, (128 + 224 * u) * s, (128 + 224 * v) * s]
    return np.clip(np.rint(np.stack(ycc, 1)), 0, (1 << bit_depth) - 1).astype(np.int64)


def relay_codes(seed, bit_depth: int, matrix: int, full: bool) -> np.ndarray:
    """IN_CUBE codes in the cube, then WHOLE over the whole code range."""
    rng = np.random.default_rng(seed)
    return np.concatenate([codes_in_cube(rng, IN_CUBE, bit_depth, matrix, full),
                           rng.integers(0, 1 << bit_depth, (WHOLE, 3))])


def flat_picture(codes: np.ndarray, bit_depth: int, per_row: int = 128):
    """Planes of 16 x 16 blocks, one a code triple, `per_row` a row."""
    rows = -(-len(codes) // per_row)
    grid = np.zeros((rows * per_row, 3), np.int64)
    grid[:len(codes)] = codes
    grid[len(codes):] = codes[0]
    grid = grid.reshape(rows, per_row, 3)
    dtype = np.uint8 if bit_depth == 8 else np.uint16
    y = np.repeat(np.repeat(grid[..., 0], 16, 0), 16, 1).astype(dtype)
    cb, cr = (np.repeat(np.repeat(grid[..., k], 8, 0), 8, 1).astype(dtype) for k in (1, 2))
    return y, cb, cr


def centres(image: np.ndarray, n: int) -> np.ndarray:
    """The first n blocks' centre pixels, (n, 3)."""
    return image[8::16, 8::16].reshape(-1, 3)[:n].astype(np.int64)


def relay(name: str):
    """A committed relay's tags, codes and planes."""
    full, primaries, transfer, matrix = RELAYS[name]
    codes = relay_codes(list(name.encode()), 8, matrix, bool(full))
    return RELAYS[name], codes, flat_picture(codes, 8)


def gaps(ours: np.ndarray, theirs: np.ndarray) -> dict:
    """Mean and max difference at the relay's block centres, in the cube and
    over the whole range."""
    d = np.abs(ours.astype(np.int64) - theirs.astype(np.int64))
    cube, whole = d[:IN_CUBE], d[IN_CUBE:]
    return {"cube_mean": float(cube.mean()), "cube_max": int(cube.max()),
            "whole_mean": float(whole.mean()), "whole_max": int(whole.max())}
