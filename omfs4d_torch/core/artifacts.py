"""Artifact store with content-hashed stage caching + experiment manifests.

Copy of `omfs4d.core.artifacts` (host-only code; the port imports nothing of
the JAX package).  A stage is keyed by (stage-name, input-hash, config-hash)
and skipped when the key's outputs already exist; experiment manifests record
a SHA-256 dataset fingerprint.
"""

from __future__ import annotations

import hashlib
import json
import os
from datetime import datetime, timezone
from pathlib import Path
from typing import Any, Callable


def sha256_file(path: str | Path) -> str:
    h = hashlib.sha256()
    with open(path, "rb") as f:
        while True:
            chunk = f.read(1 << 20)
            if not chunk:
                break
            h.update(chunk)
    return h.hexdigest()


def sha256_obj(obj: Any) -> str:
    return hashlib.sha256(
        json.dumps(obj, sort_keys=True, default=str).encode("utf-8")
    ).hexdigest()


def dataset_fingerprint(data_dir: str | Path) -> dict:
    """Reproducible dataset fingerprint."""
    data_path = Path(data_dir)
    key_files = [
        "transforms_train.json",
        "transforms_test.json",
        "transforms_val.json",
        "flame_param.npz",
        "canonical_flame_param.npz",
    ]
    file_hashes = {}
    for rel in key_files:
        p = data_path / rel
        if p.exists():
            file_hashes[rel] = sha256_file(p)
    aggregate = hashlib.sha256(
        json.dumps(file_hashes, sort_keys=True).encode("utf-8")
    ).hexdigest()
    return {"files": file_hashes, "dataset_hash": aggregate}


def write_experiment_manifest(
    out_dir: str | Path,
    data_dir: str | Path,
    config: dict,
    extra: dict | None = None,
) -> Path:
    """Experiment manifest with UTC stamp, config, dataset fingerprint and
    checkpoint lineage."""
    out = Path(out_dir)
    manifests_dir = out / "experiment_manifests"
    manifests_dir.mkdir(parents=True, exist_ok=True)
    now = datetime.now(timezone.utc)
    manifest_path = manifests_dir / f"{now.strftime('%Y%m%dT%H%M%SZ')}.json"

    lineage = []
    for ckpt in sorted(out.glob("checkpoints/*")):
        lineage.append({
            "name": ckpt.name,
            "size_bytes": sum(
                p.stat().st_size for p in ckpt.rglob("*") if p.is_file()
            ) if ckpt.is_dir() else ckpt.stat().st_size,
            "modified_utc": datetime.fromtimestamp(
                ckpt.stat().st_mtime, tz=timezone.utc
            ).isoformat(),
        })

    payload = {
        "created_utc": now.isoformat(),
        "data_dir": str(Path(data_dir).resolve()),
        "output_dir": str(out.resolve()),
        "config": config,
        "dataset_fingerprint": dataset_fingerprint(data_dir),
        "checkpoint_lineage": lineage,
        "extra": extra or {},
    }
    with open(manifest_path, "w", encoding="utf-8") as f:
        json.dump(payload, f, indent=2)
    return manifest_path


class ArtifactStore:
    """Content-addressed stage cache.

    >>> store = ArtifactStore(root)
    >>> out_dir = store.run("track", inputs={"video": path}, cfg=cfg_dict,
    ...                     fn=lambda out: do_tracking(out))

    If a prior run with identical input hashes + config exists and is marked
    complete, ``fn`` is skipped and the cached directory returned.
    """

    def __init__(self, root: str | Path):
        self.root = Path(root)
        self.root.mkdir(parents=True, exist_ok=True)

    def stage_key(self, name: str, inputs: dict, cfg: dict) -> str:
        input_hashes = {}
        for k, v in sorted(inputs.items()):
            p = Path(str(v))
            if p.is_file():
                input_hashes[k] = sha256_file(p)
            elif p.is_dir():
                # hash directory listing + sizes (cheap, stable)
                entries = sorted(
                    (str(q.relative_to(p)), q.stat().st_size)
                    for q in p.rglob("*") if q.is_file()
                )
                input_hashes[k] = sha256_obj(entries)
            else:
                input_hashes[k] = sha256_obj(v)
        return sha256_obj({"stage": name, "inputs": input_hashes, "cfg": cfg})[:16]

    def run(
        self,
        name: str,
        inputs: dict,
        cfg: dict,
        fn: Callable[[Path], Any],
        force: bool = False,
    ) -> Path:
        key = self.stage_key(name, inputs, cfg)
        out_dir = self.root / f"{name}-{key}"
        done_marker = out_dir / ".stage_complete.json"
        if done_marker.exists() and not force:
            return out_dir
        out_dir.mkdir(parents=True, exist_ok=True)
        result = fn(out_dir)
        with open(done_marker, "w", encoding="utf-8") as f:
            json.dump({
                "stage": name,
                "key": key,
                "completed_utc": datetime.now(timezone.utc).isoformat(),
                "result": result if isinstance(result, (dict, list, str, int, float, type(None))) else str(result),
            }, f, indent=2)
        return out_dir

    def latest(self, name: str) -> Path | None:
        candidates = sorted(
            (p for p in self.root.glob(f"{name}-*") if (p / ".stage_complete.json").exists()),
            key=lambda p: os.path.getmtime(p / ".stage_complete.json"),
        )
        return candidates[-1] if candidates else None
