"""Host seconds a picture of the HEVC decoder (`omfs4d_torch/io/hevcdec.cpp`) of
several trees, in one call, so that two versions meet on one host:

    python -m omfs4d_torch.scripts.hevc_times --trees _archive/parent . . _archive/parent

Each tree (a directory holding an `omfs4d_torch/` package, e.g. a parent
commit unpacked with `git archive HEAD omfs4d_torch | tar -x -C
_archive/parent`) is timed in a process of its own, in the order given,
`--reps` times: it builds its decoder with g++ (into that tree's `_build/`),
then decodes each clip of `--clips` from the committed corpus picture by
picture, timing each picture's push and end_picture apart.  A clip a tree
cannot read (Main 10 before it was read) is reported as refused.  One JSON
line a tree and run, then a table of the medians by tree, clip and slice
type.  Host clock; the card's name and power limit are printed beside it
where `nvidia-smi` answers.
"""

from __future__ import annotations

import argparse
import json
import statistics
import subprocess
import sys
from pathlib import Path

CORPUS = Path(__file__).resolve().parents[2] / "tests" / "data" / "hevc"
CLIPS = ("clip_hevc.mp4", "clip_hevc10.mov")

# run in each tree's own process: argv = tree, corpus, clips...
_CHILD = r"""
import json, sys, time
from pathlib import Path
sys.path[:0] = [sys.argv[1]]
from omfs4d_torch.io import container, hevc
corpus = Path(sys.argv[2])
manifest = json.loads((corpus / "manifest.json").read_text())["streams"]
t0 = time.perf_counter()
hevc._library()
out = {"tree": sys.argv[1], "build_s": time.perf_counter() - t0, "clips": {}}
for name in sys.argv[3:]:
    kinds = manifest[name]["kinds"]
    try:
        clip = hevc.frames(corpus / name)
    except container.UnsupportedCodecError as err:
        out["clips"][name] = {"refused": str(err)[:120]}
        continue
    dec = hevc.Decoder()
    for unit in clip.header_units():
        dec.push(unit)
    by_kind = {}
    for i in range(len(clip.offsets)):
        units = clip.units(i)
        t0 = time.perf_counter()
        for unit in units:
            dec.push(unit)
        dec.end_picture()
        by_kind.setdefault(kinds[i], []).append(time.perf_counter() - t0)
        dec.pictures()
    dec.flush()
    out["clips"][name] = by_kind
print(json.dumps(out))
"""


def card() -> str:
    try:
        res = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                              "--format=csv,noheader"], capture_output=True, text=True,
                             timeout=30)
        return res.stdout.strip().splitlines()[0] if res.returncode == 0 else "no nvidia-smi"
    except (OSError, subprocess.TimeoutExpired, IndexError):
        return "no nvidia-smi"


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--trees", nargs="+", default=["."])
    ap.add_argument("--clips", nargs="+", default=list(CLIPS))
    ap.add_argument("--reps", type=int, default=1, help="passes over the list of trees")
    args = ap.parse_args(argv)
    host = card()
    runs: dict[tuple[str, str, str], list[float]] = {}
    for _ in range(args.reps):
        for tree in args.trees:
            res = subprocess.run([sys.executable, "-c", _CHILD, str(Path(tree).resolve()),
                                  str(CORPUS), *args.clips], capture_output=True, text=True,
                                 timeout=600)
            if res.returncode:
                print(res.stderr[-3000:], file=sys.stderr)
                return 1
            line = json.loads(res.stdout.strip().splitlines()[-1])
            line["host"] = host
            print(json.dumps(line))
            for clip, by_kind in line["clips"].items():
                for kind, seconds in by_kind.items():
                    if kind != "refused":
                        runs.setdefault((tree, clip, kind), []).extend(seconds)
    print(f"median host s a picture [{host}]")
    for (tree, clip, kind), seconds in sorted(runs.items()):
        print(f"  {tree:<24} {clip:<18} {kind}  {statistics.median(seconds):.4f}  "
              f"(n {len(seconds)}, {min(seconds):.4f}-{max(seconds):.4f})")
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
