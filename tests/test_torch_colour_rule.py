"""Which colour tags cv2 maps, held on the whole grid of colour_primaries {1,
2, 4-12, 22} x transfer_characteristics {1, 2, 4-8, 11, 13-18} through
H.264 (one I_PCM picture a pair, each with its own SPS): exactly where
`omfs4d_torch.io.colour.managed` says.  swscale rebuilds its table at each
managed pair (most of a second on the CPU), so this file holds the grid
alone; `test_torch_colour.py` holds its rows and columns through HEVC and
MPEG-4."""

from tests.test_torch_colour import GRID_PRIMARIES, GRID_TRANSFERS, rule_held_to_cv2


def test_the_managed_rule_is_cv2s_on_the_whole_grid(tmp_path, capfd):
    rule_held_to_cv2(tmp_path, capfd, "h264",
                     [(p, t) for p in GRID_PRIMARIES for t in GRID_TRANSFERS])
