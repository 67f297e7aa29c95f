"""The tools of HEVC Main and Main 10 that the port's host HEVC decoder
(`omfs4d_torch/io/hevcdec.cpp`) reads beside `tests/test_torch_hevc.py`'s
sets: tiles, long-term reference pictures, scaling lists, PCM and
transquant bypass, held to cv2's FFmpeg as that file holds the rest.

- Random legal-syntax streams (`tests/torch_hevc_syntax.py`) in nine feature
  sets over two seeds: cv2's decode of each equals its decode of an I_PCM
  relay of the port's pictures (`held_to_ffmpeg`), and at 10 bits its raw
  luma too, with no `[hevc @` line; each set holds what it is about, and over
  the sets every tool's syntax occurs.  Tiles with wavefront parallel
  processing, which cv2's FFmpeg decodes otherwise than the standard, are
  refused by name.
- Truncated and bit-flipped slice segments of streams that use the tools,
  and values out of range in their syntax, raise ValueError (in a child
  process, so that a crash fails the test), never crash."""

import pytest

from omfs4d_torch.io import container, hevc
from omfs4d_torch.io import video as tvideo
from tests import torch_hevc_syntax as syn
from tests.test_torch_hevc import fuzz, held_to_ffmpeg

# the feature sets, and what each must exercise.  SAO stays at CTBs of 32 and
# 64, and slice_loop_filter_across_slices_enabled_flag one value a stream
# where SAO is on (FFmpeg departs from 8.7.3 otherwise: ROADMAP.md section 3)
FEATURES = {
    "tiles_uniform": dict(gop="pyramid", frames=5, tiles=(3, 2), width=192, height=128, ctb=32,
                          sao=True, lf_across=(1,), lf_tiles=(1,), dependent=0.5),
    "tiles_explicit": dict(gop="pyramid", frames=5, tiles=(4, 3), tile_uniform=False,
                           width=192, height=128, ctb=32, sao=True, lf_across=(0,),
                           lf_tiles=(0,), deblock=("on", "offsets")),
    "tiles_slices": dict(gop="p", frames=4, tiles=(4, 3), width=128, height=96, ctb=16,
                         multi_tile=0.4, split_tile=0.6, dependent=0.5,
                         constrained_intra=True, lf_tiles=(0, 1)),
    "tiles_wpp": dict(gop="pyramid", frames=3, tiles=(2, 2), wpp=True, width=96, height=80,
                      ctb=16),
    "long_term": dict(gop="pyramid", frames=21, cra=True, long_term=2, poc_lsb_bits=4, refs=2,
                      num_ref_idx=3, list_mod=True, width=64, height=48),
    "scaling_lists": dict(gop="p", frames=6, idr_every=2, param_sets=2, scaling="both",
                          width=96, height=64, max_tb=32, depth_intra=3, intra_in_inter=0.3),
    "pcm": dict(gop="pyramid", frames=5, pcm=0.3, pcm_sizes=(3, 5), pcm_depths=(7, 6),
                pcm_lf=(1,), intra_in_inter=0.3, width=96, height=64, ctb=32, sao=True,
                lf_across=(1,)),
    "transquant_bypass": dict(gop="pyramid", frames=5, bypass=0.3, sign_hiding="always",
                              width=96, height=64, sao=True, lf_across=(1,)),
    "main10_tools": dict(gop="pyramid", frames=9, bit_depth=10, qp=(-12, 30), tiles=(2, 2),
                         long_term=1, poc_lsb_bits=4, scaling="default", pcm=0.25,
                         pcm_sizes=(3, 5), pcm_depths=(10, 8), pcm_lf=(0,), bypass=0.25,
                         sao=True, lf_across=(1,), width=96, height=64, ctb=32),
}
EXPECT = {
    "tiles_uniform": ["tile_boundary_sync", "lf_tiles1", "multi_tile_slice", "B"],
    "tiles_explicit": ["tiles_explicit", "lf_tiles0", "tile_boundary_sync", "sao_edge"],
    "tiles_slices": ["multi_tile_slice", "mid_tile_segment", "dependent", "mid_row_slice"],
    "tiles_wpp": ["tile_wpp", "wpp_sync"],
    "long_term": ["lt_sps", "lt_slice", "lt_msb_present", "lt_msb_absent", "lt_used",
                  "lt_unused", "list_mod", "nal21", "nal8"],
    "scaling_lists": ["scaling_sps", "scaling_pps", "scaling_coded", "scaling_pred_copy",
                      "scaling_pred_default", "scaling_dc", "transform_skip"],
    "pcm": ["pcm16", "pcm_depth_below", "pcm_lf_disabled", "sao_band"],
    "transquant_bypass": ["bypass_cu", "bypass_residual", "sign_hidden"],
    "main10_tools": ["bd10", "tile_boundary_sync", "lt_used", "scaling_defaults",
                     "pcm_lf_disabled0", "bypass_cu", "qp_negative"],
}
# a pair that stays refused: cv2's FFmpeg loads the contexts WPP stored at a
# tile's first CTB and takes a tile's CTB rows for the picture's
REFUSED = {"tiles_wpp": "tiles with wavefront parallel processing"}
CASES = [(name, seed) for name in FEATURES for seed in (0, 1)]


@pytest.fixture(autouse=True)
def no_ffmpeg(monkeypatch):
    monkeypatch.setattr(tvideo, "find_ffmpeg", lambda: None)


@pytest.mark.parametrize("name, seed", CASES, ids=[f"{n}-{s}" for n, s in CASES])
def test_tool_streams_decode_as_ffmpeg_does(tmp_path, capfd, name, seed):
    """Each feature set over two seeds: cv2 decodes the stream to exactly the
    port's pictures, as many, with no FFmpeg warning (at 10 bits its raw luma
    too), and the stream held what the set is about; tiles with WPP raise
    UnsupportedCodecError naming the pair and ffmpeg, from probe_video with
    no decode and from the decoder."""
    features = FEATURES[name]
    writer = syn.Writer(seed, **features)
    aus = writer.stream()
    missing = [k for k in EXPECT[name] if not writer.stats[k]]
    assert not missing, (missing, dict(writer.stats))
    if name in REFUSED:
        path = tmp_path / "clip.mp4"
        syn.write_mov(path, aus, features["width"], features["height"], quicktime=False,
                      audio=False)
        for call in (lambda: tvideo.probe_video(path), lambda: hevc.decode_annexb(syn.annexb(aus))):
            with pytest.raises(container.UnsupportedCodecError, match="ffmpeg") as err:
                call()
            assert REFUSED[name] in str(err.value)
        return
    ours = held_to_ffmpeg(tmp_path, capfd, aus, features.get("colour"),
                          features.get("bit_depth", 8))
    assert ours[0][0].shape == (features["height"], features["width"])
    assert len(ours) == sum(p.output for p in writer.pics)


def test_the_tool_sets_cover_the_tools():
    """Over the sets: a tile boundary inside a slice segment (contexts
    initialised, the engine realigned), uniform and explicit spacing, loop
    filtering across tiles on and off, slices of several tiles and tiles of
    several slices, dependent segments starting at a tile and inside one;
    long-term pictures from the SPS's candidates and the slice header, with
    and without their POC's MSBs (a cycle above 0 too), used and not, one the
    collocated picture; scaling lists in the SPS, in the PPS over the SPS's,
    the defaults with no data, each list coded (its DC too), copied or the
    default, with 4x4 transform skip; PCM CUs of 8, 16 and 32, at depths
    below the picture's, with the loop filter on and off, one in a bypass CU;
    bypass CUs with residuals beside sign data hiding; all of it at 10
    bits."""
    total = syn.Counter()
    for name, seed in CASES:
        writer = syn.Writer(seed, **FEATURES[name])
        writer.stream()
        total.update(writer.stats)
    wanted = ["tile_boundary_sync", "tiles_explicit", "lf_tiles0", "lf_tiles1",
              "multi_tile_slice", "mid_tile_segment", "dependent_at_tile", "mid_row_slice",
              "lt_sps", "lt_slice", "lt_msb_present", "lt_msb_absent", "lt_msb_cycle",
              "lt_used", "lt_unused", "lt_collocated", "scaling_sps", "scaling_pps",
              "scaling_in_sps", "scaling_in_pps", "scaling_defaults", "scaling_coded",
              "scaling_pred_copy", "scaling_pred_default", "scaling_dc", "transform_skip",
              "pcm8", "pcm16", "pcm32", "pcm_depth_below", "pcm_lf_disabled0",
              "pcm_lf_disabled1", "pcm_bypass", "bypass_cu", "bypass_residual",
              "sign_hidden", "bd10"]
    assert not [k for k in wanted if not total[k]], dict(total)


# ── corrupt input ───────────────────────────────────────────

FUZZ_TOOLS = [("tiles", dict(FEATURES["tiles_slices"], frames=3)),
              ("lt_pcm", dict(gop="pyramid", frames=9, long_term=1, poc_lsb_bits=4, pcm=0.1,
                              pcm_depths=(8, 8), scaling="both", width=64, height=48))]
FUZZ_TOOLS_10BIT = [("main10", dict(FEATURES["main10_tools"], frames=5, width=64, height=48))]


def test_corrupt_tool_streams_raise_and_never_crash():
    """Truncated and bit-flipped slice segments of streams with tiles,
    long-term references, scaling lists, PCM and bypass CUs raise ValueError
    (or, where the damage falls where nothing reads it, decode), never crash
    the interpreter."""
    out = fuzz(FUZZ_TOOLS)
    assert set(out["truncated"]) <= {"ValueError", "decoded"}, out
    assert out["truncated"].count("ValueError") >= 40, out
    assert set(out["flipped"]) <= {"ValueError", "unsupported", "decoded"}
    assert out["flipped"].count("ValueError") >= 15, out


def test_corrupt_ten_bit_tool_streams_raise_and_never_crash():
    """The same over a Main 10 stream with all five tools."""
    out = fuzz(FUZZ_TOOLS_10BIT)
    assert set(out["truncated"]) <= {"ValueError", "decoded"}, out
    assert out["truncated"].count("ValueError") >= 20, out
    assert set(out["flipped"]) <= {"ValueError", "unsupported", "decoded"}
    assert out["flipped"].count("ValueError") >= 8, out


CORRUPT_FEATURES = {
    "tile_sizes": dict(FEATURES["tiles_explicit"], frames=1),
    "entry_points": dict(FEATURES["tiles_uniform"], frames=1),
    "lt_idx_sps": dict(FEATURES["long_term"], frames=13),
    "lt_missing": dict(FEATURES["long_term"], frames=13),
    "scaling_delta": dict(FEATURES["scaling_lists"], frames=2),
    "pcm_sizes": dict(FEATURES["pcm"], frames=1),
    "pcm_depth": dict(FEATURES["pcm"], frames=1, pcm_depths=(8, 8)),
}


@pytest.mark.parametrize("kind", syn.CORRUPT)
def test_values_out_of_range_raise(kind):
    """A tile grid past the picture, entry points past the slice segment's
    data, an lt_idx_sps past the SPS's candidates, a
    scaling_list_pred_matrix_id_delta past its matrix, PCM sizes above 32 and
    a PCM depth above the picture's raise ValueError; a long-term reference
    that is not in the DPB decodes, grey, as FFmpeg makes it."""
    aus = syn.write_stream(3, corrupt=kind, **CORRUPT_FEATURES[kind])
    if kind == "lt_missing":
        assert len(hevc.decode_annexb(syn.annexb(aus))) == len(aus)
        return
    with pytest.raises(ValueError):
        hevc.decode_annexb(syn.annexb(aus))
