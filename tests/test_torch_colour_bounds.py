"""The port's colour management (`omfs4d_torch.io.colour`) held to cv2 at
flat 16 x 16 blocks' centres, on the CPU: for each tag set cv2 manages
(BT.2020 with HLG, PQ and BT.709's transfer, BT.709 primaries with HLG and
PQ, Display P3), at 8 and 10 bits and in both ranges, one I_PCM relay
(`torch_h264_syntax.pcm_stream`) of 2048 random colours whose R'G'B' lie in
[0, 1] and 1024 random code triples over the whole code range (super-whites,
sub-blacks, colours outside the R'G'B' cube).  Bounds: in the cube a mean
of 0.3 levels and a max of 8; over the whole range a mean of 0.5 and a max
of 16."""

import pytest

from omfs4d_torch.io import h264
from tests import torch_h264_syntax as syn
from tests.colour_relays import centres, flat_picture, gaps, relay_codes
from tests.test_torch_h264 import cv2_read

# (full range, colour_primaries, transfer_characteristics, matrix_coefficients)
TAGS = [(9, 18, 9), (9, 16, 9), (9, 1, 9), (1, 18, 1), (1, 16, 1), (12, 1, 1)]
CASES = [(full,) + t + (bd,) for t in TAGS for bd in (8, 10) for full in (0, 1)]
CUBE_MEAN, CUBE_MAX, WHOLE_MEAN, WHOLE_MAX = 0.3, 8, 0.5, 16


@pytest.mark.parametrize("full, primaries, transfer, matrix, bit_depth", CASES,
                         ids=[f"{p}-{t}-{m}-{bd}bit-{'full' if f else 'limited'}"
                              for f, p, t, m, bd in CASES])
def test_managed_tags_are_within_the_bounds_of_cv2(tmp_path, capfd, full, primaries, transfer,
                                                   matrix, bit_depth):
    codes = relay_codes([primaries, transfer, matrix, bit_depth, full], bit_depth, matrix,
                        bool(full))
    planes = flat_picture(codes, bit_depth)
    path = tmp_path / "relay.h264"
    path.write_bytes(syn.pcm_stream([planes], (full, primaries, transfer, matrix),
                                    bit_depth=bit_depth))
    (bgr,) = cv2_read(path, capfd)
    ours = h264.ycbcr_to_rgb(*planes, full_range=bool(full), matrix=matrix, bit_depth=bit_depth,
                             primaries=primaries, transfer=transfer)
    g = gaps(centres(ours, len(codes)), centres(bgr[..., ::-1], len(codes)))
    assert g["cube_mean"] <= CUBE_MEAN and g["cube_max"] <= CUBE_MAX, g
    assert g["whole_mean"] <= WHOLE_MEAN and g["whole_max"] <= WHOLE_MAX, g
