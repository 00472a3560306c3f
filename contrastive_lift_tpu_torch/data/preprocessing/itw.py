"""In-the-wild capture ingestion: nerfstudio ``transforms.json`` -> common
layout. The port's copy of ``contrastive_lift_tpu/data/preprocessing/
itw.py``.

  * keyframe selection: least-blurry frame per window (variance of a
    Laplacian of PIL's grey conversion, ``utils/image.py::to_grey_pil``);
  * nerfstudio pose ingestion: ``transform_matrix`` is OpenGL cam2world;
    right-multiplying diag(1,-1,-1,1) flips to the OpenCV convention the
    renderer uses;
  * undistortion: plain OpenCV model (k1,k2,p1,p2) or OPENCV_FISHEYE
    (k1..k4), with a new camera matrix and, for fisheye, per-frame invalid
    masks where the remap leaves the source image.

The remap is numpy: destination pixels are pushed through the FORWARD
distortion model (closed form) to source pixels and sampled bilinearly;
only the new-camera-matrix estimate needs the inverse model, solved for the
pinhole model by the Newton iteration the ray loader uses, in float32 on
the host (``utils/geometry.py::radial_tangential_undistort``), and for the
fisheye model in float64.
"""
from __future__ import annotations

import argparse
import json
from pathlib import Path
from typing import Optional

import numpy as np

from ...utils import geometry as geo
from ...utils.image import (image_mode, image_palette, image_size,
                             read_image, to_grey_pil)
from ...utils.png import write_png
from .common import blur_score, numeric_stem_key, select_keyframes


# ---------------------------------------------------------------------------
# Distortion models (normalized coordinates)
# ---------------------------------------------------------------------------

def distort_pinhole(x, y, k1=0.0, k2=0.0, p1=0.0, p2=0.0):
    """OpenCV radial(2)+tangential model, forward direction."""
    r2 = x * x + y * y
    d = 1.0 + r2 * (k1 + r2 * k2)
    xd = d * x + 2 * p1 * x * y + p2 * (r2 + 2 * x * x)
    yd = d * y + 2 * p2 * x * y + p1 * (r2 + 2 * y * y)
    return xd, yd


def distort_fisheye(x, y, k1=0.0, k2=0.0, k3=0.0, k4=0.0):
    """OpenCV fisheye (equidistant) model, forward direction."""
    r = np.sqrt(x * x + y * y)
    theta = np.arctan(r)
    t2 = theta * theta
    theta_d = theta * (1 + t2 * (k1 + t2 * (k2 + t2 * (k3 + t2 * k4))))
    scale = np.where(r > 1e-9, theta_d / np.maximum(r, 1e-9), 1.0)
    return x * scale, y * scale


def _undistort_points(xd, yd, model: str, dist) -> tuple:
    """Inverse distortion at a few boundary points (Newton; host-side)."""
    if model == "fisheye":
        # invert theta_d(theta) per point, then r = tan(theta)
        k1, k2, k3, k4 = dist
        rd = np.sqrt(xd * xd + yd * yd)
        theta = rd.copy()
        for _ in range(12):
            t2 = theta * theta
            f = theta * (1 + t2 * (k1 + t2 * (k2 + t2 * (k3 + t2 * k4)))) - rd
            df = (1 + t2 * (3 * k1 + t2 * (5 * k2 + t2 * (7 * k3
                                                          + t2 * 9 * k4))))
            theta = theta - f / np.maximum(df, 1e-9)
        r = np.tan(theta)
        scale = np.where(rd > 1e-9, r / np.maximum(rd, 1e-9), 1.0)
        return xd * scale, yd * scale
    k1, k2, p1, p2 = dist
    x, y = geo.radial_tangential_undistort(xd, yd, k1=k1, k2=k2, p1=p1, p2=p2)
    return np.asarray(x), np.asarray(y)


def estimate_new_camera(K, dist, hw, model: str) -> np.ndarray:
    """New pinhole K for the undistorted image.

    Pinhole mirrors cv2.getOptimalNewCameraMatrix(alpha=0): the INNER
    rectangle of the undistorted boundary fills the image (all pixels valid).
    Fisheye mirrors cv2.fisheye.estimateNewCameraMatrixForUndistortRectify
    (balance=1): the OUTER box is kept (full field of view, invalid corners
    masked). Both are boundary-grid estimates, host-side."""
    h, w = hw
    fx, fy, cx, cy = K[0, 0], K[1, 1], K[0, 2], K[1, 2]
    t = np.linspace(0, 1, 64)
    edges = np.concatenate([
        np.stack([t * (w - 1), np.zeros_like(t)], -1),
        np.stack([t * (w - 1), np.full_like(t, h - 1)], -1),
        np.stack([np.zeros_like(t), t * (h - 1)], -1),
        np.stack([np.full_like(t, w - 1), t * (h - 1)], -1)])
    xd = (edges[:, 0] - cx) / fx
    yd = (edges[:, 1] - cy) / fy
    x, y = _undistort_points(xd, yd, model, dist)
    if model == "fisheye":
        # outer box: min focal that keeps every undistorted boundary point
        x0, x1 = float(np.min(x)), float(np.max(x))
        y0, y1 = float(np.min(y)), float(np.max(y))
    else:
        # inner rectangle: per-edge extrema (top edge's lowest y, etc.)
        n = len(t)
        top, bottom, left, right = (y[:n], y[n:2 * n], x[2 * n:3 * n],
                                    x[3 * n:])
        x0, x1 = float(np.max(left)), float(np.min(right))
        y0, y1 = float(np.max(top)), float(np.min(bottom))
    nfx = (w - 1) / max(x1 - x0, 1e-9)
    nfy = (h - 1) / max(y1 - y0, 1e-9)
    ncx = -x0 * nfx
    ncy = -y0 * nfy
    return np.array([[nfx, 0, ncx], [0, nfy, ncy], [0, 0, 1]], np.float64)


def undistort_image(img: np.ndarray, K, dist, newK, model: str):
    """Remap ``img`` to the undistorted camera ``newK``.

    Returns (undistorted uint8 image, valid mask) — dest pixels whose source
    lands outside the frame are zeroed and masked invalid (the fisheye
    ``invalid/`` masks of preprocess_itw.py:100-104)."""
    h, w = img.shape[:2]
    u, v = np.meshgrid(np.arange(w), np.arange(h))
    x = (u - newK[0, 2]) / newK[0, 0]
    y = (v - newK[1, 2]) / newK[1, 1]
    if model == "fisheye":
        xd, yd = distort_fisheye(x, y, *dist)
    else:
        xd, yd = distort_pinhole(x, y, *dist)
    sx = xd * K[0, 0] + K[0, 2]
    sy = yd * K[1, 1] + K[1, 2]
    valid = (sx >= 0) & (sx <= w - 1) & (sy >= 0) & (sy <= h - 1)
    sx = np.clip(sx, 0, w - 1.001)
    sy = np.clip(sy, 0, h - 1.001)
    x0, y0 = sx.astype(np.int32), sy.astype(np.int32)
    fx_, fy_ = (sx - x0)[..., None], (sy - y0)[..., None]
    im = img.astype(np.float32)
    if im.ndim == 2:
        im = im[..., None]
    out = (im[y0, x0] * (1 - fx_) * (1 - fy_)
           + im[y0, x0 + 1] * fx_ * (1 - fy_)
           + im[y0 + 1, x0] * (1 - fx_) * fy_
           + im[y0 + 1, x0 + 1] * fx_ * fy_)
    out = np.where(valid[..., None], out, 0.0)
    out = np.clip(np.round(out), 0, 255).astype(np.uint8)
    if img.ndim == 2:
        out = out[..., 0]
    return out, valid


# ---------------------------------------------------------------------------
# transforms.json ingestion
# ---------------------------------------------------------------------------

_FLIP = np.diag([1.0, -1.0, -1.0, 1.0])


def read_transforms(transforms_path) -> dict:
    """Parse nerfstudio transforms.json -> K, distortion, model, poses.

    Poses are cam2world in OUR (OpenCV) convention: transform_matrix @
    diag(1,-1,-1,1) (reference preprocess_itw.py:62-72)."""
    tr = json.loads(Path(transforms_path).read_text())
    K = np.array([[tr["fl_x"], 0, tr["cx"]],
                  [0, tr["fl_y"], tr["cy"]],
                  [0, 0, 1]], np.float64)
    if tr.get("camera_model") == "OPENCV_FISHEYE":
        model = "fisheye"
        dist = tuple(float(tr.get(k, 0.0)) for k in ("k1", "k2", "k3", "k4"))
    else:
        model = "pinhole"
        dist = tuple(float(tr.get(k, 0.0)) for k in ("k1", "k2", "p1", "p2"))
    poses = {}
    for frame in tr["frames"]:
        stem = Path(frame["file_path"]).stem
        poses[stem] = np.asarray(frame["transform_matrix"], np.float64) @ _FLIP
    return {"K": K, "dist": dist, "model": model, "poses": poses,
            "hw": (int(tr["h"]), int(tr["w"]))}


def preprocess_itw(transforms_path, frames_dir, output_dir,
                   gt_semantics_dir=None, gt_instance_dir=None, m2f_dir=None,
                   num_classes: Optional[int] = None, thing_classes=(),
                   keyframe_window: int = 1, test_fraction: float = 0.2,
                   image_hw=None) -> dict:
    """Full itw drive: keyframes -> undistort -> poses -> common layout.

    Writes an ``undistorted/`` staging folder (color + pose txts + intrinsic
    + invalid masks) then runs the generic common-layout converter on it, so
    downstream (train/render/evaluate CLIs) see the same scene layout as
    every other dataset family."""
    from .generic import preprocess_generic

    frames_dir = Path(frames_dir)
    output_dir = Path(output_dir)
    meta = read_transforms(transforms_path)
    K, dist, model = meta["K"], meta["dist"], meta["model"]

    names = sorted([p.stem for p in frames_dir.iterdir()
                    if p.suffix.lower() in (".jpg", ".png", ".jpeg")],
                   key=numeric_stem_key)
    names = [n for n in names if n in meta["poses"]]
    paths = [next(frames_dir.glob(f"{n}.*")) for n in names]
    if keyframe_window > 1:
        # least-blurry frame per window, one frame in memory at a time (a
        # video capture has thousands)
        scores = [blur_score(to_grey_pil(read_image(p), image_palette(p),
                                         image_mode(p)))
                  for p in paths]
        keep = select_keyframes(scores, keyframe_window)
        names = [names[i] for i in keep]
        paths = [paths[i] for i in keep]

    w, h = image_size(paths[0])
    newK = estimate_new_camera(K, dist, (h, w), model)
    stage = output_dir / "undistorted"
    for sub in ("color", "pose", "intrinsic", "invalid"):
        (stage / sub).mkdir(parents=True, exist_ok=True)
    intr4 = np.eye(4)
    intr4[:3, :3] = newK
    np.savetxt(stage / "intrinsic" / "intrinsic_color.txt", intr4)

    any_invalid = False
    for name, path in zip(names, paths):
        arr = read_image(path)[..., :3]
        und, valid = undistort_image(arr, K, dist, newK, model)
        write_png(stage / "color" / f"{name}.png", und)
        np.savetxt(stage / "pose" / f"{name}.txt", meta["poses"][name])
        if not valid.all():
            any_invalid = True
            write_png(stage / "invalid" / f"{name}.png",
                      ((~valid) * 255).astype(np.uint8))

    return preprocess_generic(
        stage / "color", stage / "pose",
        stage / "intrinsic" / "intrinsic_color.txt", output_dir,
        gt_semantics_dir=gt_semantics_dir, gt_instance_dir=gt_instance_dir,
        m2f_dir=m2f_dir, num_classes=num_classes,
        thing_classes=thing_classes, image_hw=image_hw,
        test_fraction=test_fraction,
        invalid_dir=(stage / "invalid") if any_invalid else None)


def main(argv=None):
    parser = argparse.ArgumentParser(description=__doc__)
    parser.add_argument("--transforms", required=True)
    parser.add_argument("--frames_dir", required=True)
    parser.add_argument("--output_dir", required=True)
    parser.add_argument("--gt_semantics_dir", default=None)
    parser.add_argument("--gt_instance_dir", default=None)
    parser.add_argument("--m2f_dir", default=None)
    parser.add_argument("--num_classes", type=int, default=None)
    parser.add_argument("--thing_classes", type=int, nargs="*", default=[])
    parser.add_argument("--keyframe_window", type=int, default=1)
    args = parser.parse_args(argv)
    print(preprocess_itw(
        args.transforms, args.frames_dir, args.output_dir,
        args.gt_semantics_dir, args.gt_instance_dir, args.m2f_dir,
        args.num_classes, args.thing_classes, args.keyframe_window))


if __name__ == "__main__":
    main()
