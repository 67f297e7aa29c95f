"""The port's multi-sequence head reconstruction (`omfs4d_torch.headrecon`)
against the JAX package's, on the CPU.

The host NumPy steps (`ingest_sequences`, `register_sequences`,
`build_canonical_head`, the coverage reports) run on one capture root in both
packages and must write the same manifest, the same registration table (atol
1e-12), the same canonical asset and the same reports.  `fit_shared_shape`
runs the landmark stages of both packages' trackers on two sequences cut from
the 4-frame clip of `tests/test_torch_track.py` (the shapes of
`tests/test_torch_track_stages.py`), from the same init, and is held to the
stage tolerances: loss rel 2e-3, parameters atol 1e-4.
"""

import json

import numpy as np
import pytest

from omfs4d import headrecon as jhr
from omfs4d.headrecon import pipeline as jhp
from omfs4d_torch import headrecon as thr
from omfs4d_torch.headrecon import pipeline as thp
from omfs4d_torch.io.video import write_image
from omfs4d_torch.predict.surgery import choose_rig_mode
from tests.test_torch_track import clip, one_torch_thread, trackers  # noqa: F401

POSES = {"seq_a": ([0.0, 0.2, 0.0], [0.01, 0.0, -0.02]),
         "seq_b": ([0.0, -0.9, 0.1], [-0.03, 0.02, 0.05]),
         "seq_c": ([0.3, 0.1, -0.2], [0.0, 0.01, 0.0])}


def capture_root(root):
    """Sequences of every kind the probe tells apart: tracked with a
    transforms file, tracked with no pose keys, images only, an empty
    directory, an unreadable transforms file, and a stray file."""
    for name, (rot, trans) in POSES.items():
        d = root / name
        (d / "images").mkdir(parents=True)
        for i in range(3):
            write_image(d / "images" / f"{i:05d}.png", np.zeros((4, 4, 3), np.uint8))
        (d / "images" / "extra.jpg").write_bytes(b"\xff\xd8")
        (d / "transforms_train.json").write_text(json.dumps(
            {"frames": [{"timestep_index": i} for i in range(7 + 6 * len(name) % 5)]}))
        np.savez(d / "flame_param.npz", rotation=np.asarray([rot, rot], np.float32),
                 translation=np.asarray([trans, trans], np.float32))
    (root / "seq_d_no_pose").mkdir()
    (root / "seq_d_no_pose" / "transforms_train.json").write_text('{"frames": [{}, {}]}')
    np.savez(root / "seq_d_no_pose" / "flame_param.npz", shape=np.zeros(3))
    (root / "seq_e_images" / "images").mkdir(parents=True)
    for i in range(5):
        write_image(root / "seq_e_images" / "images" / f"{i}.png", np.zeros((4, 4, 3), np.uint8))
    (root / "seq_f_empty").mkdir()
    (root / "seq_g_bad_json").mkdir()
    (root / "seq_g_bad_json" / "transforms_train.json").write_text("{not json")
    (root / "notes.txt").write_text("not a sequence")
    return root


def both(fn_name, *args, out):
    return (getattr(jhp, fn_name)(*args, out / "j"), getattr(thp, fn_name)(*args, out / "t"))


def test_public_names_match_the_reference():
    names = [n for n in dir(jhr) if not n.startswith("_")]
    assert [n for n in dir(thr) if not n.startswith("_")] == names
    assert set(names) >= {"ingest_sequences", "register_sequences", "fit_shared_shape",
                          "build_canonical_head", "evaluate_head_coverage",
                          "evaluate_multi_coverage"}


@pytest.mark.parametrize("aa", [[0.0, 0.0, 0.0], [1e-13, 0.0, 0.0], [0.3, -0.2, 0.1],
                                [0.0, 3.0, 0.0], [-2.0, 1.0, 0.5]])
def test_rodrigues_matches_the_reference(aa):
    aa = np.asarray(aa)
    R = thp._aa_to_matrix(aa)
    np.testing.assert_allclose(R, jhp._aa_to_matrix(aa), rtol=0, atol=1e-12)
    np.testing.assert_allclose(R @ R.T, np.eye(3), atol=1e-12)


def test_scaffold_matches_the_reference(tmp_path):
    root = capture_root(tmp_path / "captures")
    out = tmp_path / "out"
    mj, mt = both("ingest_sequences", root, out=out)
    manifest = json.loads(mt.read_text())
    assert manifest == json.loads(mj.read_text())
    names = [s["name"] for s in manifest["sequences"]]
    # an empty directory is not a sequence; an unreadable transforms file is
    assert names == ["seq_a", "seq_b", "seq_c", "seq_d_no_pose", "seq_e_images",
                     "seq_g_bad_json"]

    tj, tt = (jhp.register_sequences(mj, out / "j"), thp.register_sequences(mt, out / "t"))
    rows_j = json.loads(tj.read_text())["registrations"]
    rows_t = json.loads(tt.read_text())["registrations"]
    assert [r["name"] for r in rows_t] == [r["name"] for r in rows_j] == names
    for rt, rj in zip(rows_t, rows_j):
        assert rt["canonical"] == rj["canonical"]
        np.testing.assert_allclose(rt["transform"], rj["transform"], rtol=0, atol=1e-12)
        assert abs(rt["residual"] - rj["residual"]) <= 1e-12
    by_name = {r["name"]: r for r in rows_t}
    assert by_name["seq_a"]["residual"] == 0.0 and by_name["seq_e_images"]["residual"] == -1.0
    assert 0.0 <= by_name["seq_b"]["residual"] < 1e-5

    shape = np.random.default_rng(0).normal(size=300).astype(np.float32)
    for flame_shape in (shape, None):
        aj = jhp.build_canonical_head(tj, out / "j" / "canonical.npz", flame_shape)
        at = thp.build_canonical_head(tt, out / "t" / "canonical.npz", flame_shape)
        with np.load(aj) as zj, np.load(at) as zt:
            assert sorted(zj.files) == sorted(zt.files)
            for k in zj.files:
                np.testing.assert_array_equal(zt[k], zj[k], err_msg=k)
    assert choose_rig_mode("hybrid_full_head", str(at))[0] == "hybrid_full_head"

    for seq in ("seq_a", "seq_b"):
        cj, ct = both("evaluate_head_coverage", root / seq, out=out)
        assert ct == cj and ct["buckets"]["front"] > 0
        assert ((out / "t" / "head_coverage_report.json").read_text()
                == (out / "j" / "head_coverage_report.json").read_text())
    mcj, mct = both("evaluate_multi_coverage", mt, out=out)
    assert mct == mcj and mct["sequence_count"] == len(names)


def test_registration_without_a_tracked_canonical_falls_back_to_identity(tmp_path):
    root = tmp_path / "captures"
    for name in ("a_untracked", "b_tracked"):
        (root / name / "images").mkdir(parents=True)
    np.savez(root / "b_tracked" / "flame_param.npz", rotation=np.ones((1, 3), np.float32),
             translation=np.ones((1, 3), np.float32))
    out = tmp_path / "out"
    mj, mt = both("ingest_sequences", root, out=out)
    rows_t = json.loads(thp.register_sequences(mt, out / "t").read_text())["registrations"]
    rows_j = json.loads(jhp.register_sequences(mj, out / "j").read_text())["registrations"]
    assert rows_t == rows_j
    assert rows_t[1]["transform"] == np.eye(4).tolist() and rows_t[1]["residual"] == -1.0


def test_fit_shared_shape_matches_the_reference():
    """Two sequences of 2 frames each, landmark stages only (40 + 40 steps),
    one shared shape vector, per-sequence parameters split back."""
    steps = dict(photometric=False, steps_lmk_init_rigid=40, steps_lmk_init_all=40, lr=0.02)
    jt_, tt_ = trackers(**steps)
    _, lmk, _ = clip()
    seqs = [(lmk[:2], np.ones(2, bool)), (lmk[2:], np.ones(2, bool))]
    results = {}
    for name, tracker in (("j", jt_), ("t", tt_)):
        fit = tracker.fit

        def noted(*a, _fit=fit, _name=name, **kw):
            results[_name] = _fit(*a, **kw)
            return results[_name]

        tracker.fit = noted
    shape_j, per_j = jhp.fit_shared_shape(jt_, seqs)
    shape_t, per_t = thp.fit_shared_shape(tt_, seqs)

    lj, lt = results["j"].losses["landmark"], results["t"].losses["landmark"]
    assert abs(lt - lj) <= 2e-3 * lj, (lt, lj)
    assert shape_t.shape == (300,) and np.abs(shape_t).max() > 1e-3
    np.testing.assert_allclose(shape_t, np.asarray(shape_j), atol=1e-4)
    assert len(per_t) == len(per_j) == 2
    for pt, pj, n in zip(per_t, per_j, (2, 2)):
        assert set(pt) == set(pj)
        assert pt["shape"] is shape_t or np.array_equal(pt["shape"], shape_t)
        for k in pt:
            want_len = None if k in ("shape", "static_offset") else n
            if want_len is not None:
                assert pt[k].shape[0] == n, k
            np.testing.assert_allclose(pt[k], np.asarray(pj[k]), atol=1e-4, err_msg=k)
