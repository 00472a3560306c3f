"""Novel-view camera trajectories (fly-through rendering).

Port of ``contrastive_lift_tpu/data/trajectory.py`` (numpy): a pickled list
of cam2world matrices rendered rays-only, and a procedural spherical orbit.
``load_trajectory`` unpickles its file, so give it only trajectories this
program or its user wrote.
"""
from __future__ import annotations

import pickle
from pathlib import Path
from typing import List, Optional

import numpy as np

from ..utils import geometry as geo
from .base import FrameData


def rays_for_poses(poses: List[np.ndarray], intrinsics: np.ndarray,
                   image_dim) -> List[FrameData]:
    """Rays-only FrameData for each cam2(norm)scene pose."""
    h, w = image_dim
    dirs = geo.ray_directions_from_intrinsics(h, w, intrinsics)
    frames = []
    for i, pose in enumerate(poses):
        rays = np.asarray(geo.make_ray_bundle(dirs, pose), np.float32)
        frames.append(FrameData(
            name=f"{i:04d}", rays=rays,
            rgbs=np.zeros((h * w, 3), np.float32),
            semantics=np.zeros(h * w, np.int64),
            instances=np.zeros(h * w, np.int64),
            probabilities=np.zeros((h * w, 1), np.float32),
            confidences=np.ones(h * w, np.float32),
            mask=np.ones(h * w, bool),
            intrinsics=np.asarray(intrinsics, np.float32),
            cam2normscene=np.asarray(pose, np.float32)))
    return frames


def load_trajectory(path, intrinsics, image_dim,
                    scene2normscene: Optional[np.ndarray] = None):
    """Pickled trajectory (list of 4x4 cam2world, or dict with 'poses')."""
    with open(Path(path), "rb") as f:
        data = pickle.load(f)
    poses = data["poses"] if isinstance(data, dict) else data
    poses = [np.asarray(p, np.float32) for p in poses]
    if scene2normscene is not None:
        poses = [np.asarray(scene2normscene, np.float32) @ p for p in poses]
    return rays_for_poses(poses, intrinsics, image_dim)


def _look_at(eye: np.ndarray, target: np.ndarray) -> np.ndarray:
    fwd = target - eye
    fwd = fwd / np.linalg.norm(fwd)
    up = np.array([0.0, 0.0, 1.0])
    if abs(np.dot(fwd, up)) > 0.95:
        up = np.array([0.0, 1.0, 0.0])
    right = np.cross(fwd, up)
    right /= np.linalg.norm(right)
    down = np.cross(fwd, right)
    c2w = np.eye(4, dtype=np.float32)
    c2w[:3, 0], c2w[:3, 1], c2w[:3, 2], c2w[:3, 3] = right, down, fwd, eye
    return c2w


def spherical_orbit(num_frames: int, radius: float = 0.75,
                    height: float = 0.25, target=(0.0, 0.0, 0.0),
                    revolutions: float = 1.0) -> List[np.ndarray]:
    """Orbit poses around a target point inside the normalized scene."""
    target = np.asarray(target, np.float32)
    poses = []
    for i in range(num_frames):
        angle = 2 * np.pi * revolutions * i / num_frames
        eye = target + np.array([radius * np.cos(angle),
                                 radius * np.sin(angle), height], np.float32)
        poses.append(_look_at(eye, target))
    return poses
