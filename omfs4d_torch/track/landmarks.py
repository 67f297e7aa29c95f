"""Facial-landmark detection interface (host-side stage).

Port of `omfs4d.track.landmarks`.  Detection is a pluggable host stage: any
callable (images_dir | array) -> ((T, 68, 2) landmarks, (T,) valid) can be
registered; built-ins cover files on disk, the synthetic ground-truth path
used by tests and benches, and adapters for MediaPipe FaceMesh and the FAN
detector that raise when their library is not installed.  The MediaPipe
478 -> 68 index map is kept so that a MediaPipe plugin drops in unchanged.

The self-trained `neural` detector is not ported yet: it, and `auto` when it
finds no `landmarks.npz`, raise `NotImplementedError`.
"""

from __future__ import annotations

from pathlib import Path
from typing import Callable

import numpy as np

# 68-point subset of MediaPipe's 478 landmarks, kept for plugin detectors
MEDIAPIPE_TO_68 = [
    10, 338, 297, 332, 284, 251, 389, 356, 454,
    323, 361, 288, 397, 365, 379, 378, 400,
    46, 53, 52, 65, 55,
    285, 295, 282, 283, 276,
    6, 197, 195, 5,
    48, 115, 220, 45, 4,
    33, 160, 158, 133, 153, 144,
    362, 385, 387, 263, 373, 380,
    61, 40, 37, 0, 267, 270, 291,
    321, 314, 17, 84, 91,
    78, 82, 13, 312, 308, 317, 14, 87,
]

_DETECTORS: dict[str, Callable] = {}


def register_detector(name: str):
    def deco(fn: Callable):
        _DETECTORS[name] = fn
        return fn
    return deco


@register_detector("file")
def _from_file(source, **kw):
    """Load landmarks from `<dir>/landmarks.npz` (keys: landmarks, valid)."""
    p = Path(source)
    npz = p / "landmarks.npz" if p.is_dir() else p
    data = np.load(npz)
    lmk = np.asarray(data["landmarks"], np.float32)
    valid = np.asarray(data.get("valid", np.ones(len(lmk), bool)))
    return lmk, valid


@register_detector("synthetic")
def _synthetic(source, model=None, params=None, cameras=None, **kw):
    """Project the ground-truth FLAME landmarks (tests/benches: a perfect
    detector), on the model's device.  `cameras`: one Camera or one per frame."""
    import torch

    from omfs4d_torch.models.flame import flame_forward, flame_landmarks
    from omfs4d_torch.ops.camera import Camera, project_points

    with torch.no_grad():
        verts = flame_forward(model, params)
        lmk3d = flame_landmarks(model, verts)          # (T, 68, 3)
        T = lmk3d.shape[0]
        out = np.zeros((T, lmk3d.shape[1], 2), np.float32)
        for i in range(T):
            cam = cameras if isinstance(cameras, Camera) else cameras[i]
            uv, _ = project_points(cam, lmk3d[i])
            out[i] = uv.cpu().numpy()
    return out, np.ones(T, bool)


def _load_frames(source) -> np.ndarray:
    """images dir | (T,H,W,3) array -> uint8 frame stack."""
    if isinstance(source, np.ndarray):
        return source
    from omfs4d_torch.io.video import read_image

    p = Path(source)
    images_dir = p / "images" if (p / "images").is_dir() else p
    paths = sorted(images_dir.glob("*.png")) + sorted(images_dir.glob("*.jpg"))
    if not paths:
        raise FileNotFoundError(f"no frames under {images_dir}")
    return np.stack([read_image(q) for q in paths])


@register_detector("neural")
def _neural(source, **kw):
    """The self-trained CNN regressor of the JAX package
    (`omfs4d.track.detector`) is not ported yet."""
    raise NotImplementedError(
        "landmark detector 'neural' waits for the port's detector slice "
        "(track/detector.py); provide landmarks.npz (method='file') or use "
        "method='mediapipe' / 'face_alignment'")


@register_detector("mediapipe")
def _mediapipe(source, **kw):
    """Adapter for MediaPipe FaceMesh (478 -> 68 map), when importable."""
    try:
        import mediapipe as mp
    except ImportError as e:
        raise RuntimeError(
            "mediapipe is not installed; provide landmarks.npz "
            "(method='file')"
        ) from e

    frames = _load_frames(source)
    T, H, W = frames.shape[:3]
    out = np.zeros((T, len(MEDIAPIPE_TO_68), 2), np.float32)
    valid = np.zeros((T,), bool)
    with mp.solutions.face_mesh.FaceMesh(
        static_image_mode=False, refine_landmarks=True,
        max_num_faces=1, min_detection_confidence=0.5,
    ) as mesh:
        for i in range(T):
            res = mesh.process(frames[i])
            if not res.multi_face_landmarks:
                continue
            pts = res.multi_face_landmarks[0].landmark
            out[i] = [(pts[j].x * W, pts[j].y * H) for j in MEDIAPIPE_TO_68]
            valid[i] = True
    return out, valid


@register_detector("face_alignment")
def _face_alignment(source, **kw):
    """Adapter for the FAN 68-pt detector (VHAP's default), when importable."""
    try:
        import face_alignment
    except ImportError as e:
        raise RuntimeError(
            "face_alignment is not installed; provide landmarks.npz "
            "(method='file')"
        ) from e

    frames = _load_frames(source)
    fa = face_alignment.FaceAlignment(
        face_alignment.LandmarksType.TWO_D, flip_input=False, device="cpu")
    T = len(frames)
    out = np.zeros((T, 68, 2), np.float32)
    valid = np.zeros((T,), bool)
    for i in range(T):
        preds = fa.get_landmarks(frames[i])
        if preds:
            out[i] = preds[0][:, :2]
            valid[i] = True
    return out, valid


@register_detector("auto")
def _auto(source, **kw):
    """file if landmarks.npz exists next to the frames, else neural (which
    is not ported yet and raises)."""
    if not isinstance(source, np.ndarray):
        p = Path(source)
        for cand in (p / "landmarks.npz", p.parent / "landmarks.npz"):
            if cand.exists():
                return _from_file(cand)
    return _neural(source, **kw)


def detect_landmarks(source, method: str = "file", **kw):
    """Run a registered detector; returns ((T, L, 2) float32, (T,) valid)."""
    if method not in _DETECTORS:
        raise KeyError(
            f"landmark detector {method!r} not registered; "
            f"available: {sorted(_DETECTORS)}"
        )
    return _DETECTORS[method](source, **kw)


def save_landmarks(path, landmarks: np.ndarray, valid: np.ndarray | None = None):
    p = Path(path)
    p.parent.mkdir(parents=True, exist_ok=True)
    np.savez(p, landmarks=landmarks,
             valid=valid if valid is not None else np.ones(len(landmarks), bool))
