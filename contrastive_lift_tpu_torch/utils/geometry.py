"""Camera / ray geometry in numpy (float32).

Port of the ray-generation part of ``contrastive_lift_tpu/utils/geometry.py``
(pinhole rays, unit-sphere far plane, the 8-float ray layout), which the
synthetic scene needs to regenerate its frames.
"""
from __future__ import annotations

import numpy as np


def pixel_grid(height: int, width: int):
    """Pixel-center (i=x, j=y) grids of shape [H, W]: i varies along width,
    j along height."""
    i = np.tile(np.arange(width, dtype=np.float32)[None, :], (height, 1))
    j = np.tile(np.arange(height, dtype=np.float32)[:, None], (1, width))
    return i, j


def ray_directions_from_intrinsics(height: int, width: int, intrinsics) -> np.ndarray:
    """Per-pixel camera-space ray directions [H, W, 3] for a pinhole camera
    (+z forward, unnormalized)."""
    intrinsics = np.asarray(intrinsics, np.float32)
    fx, fy = intrinsics[0, 0], intrinsics[1, 1]
    cx, cy = intrinsics[0, 2], intrinsics[1, 2]
    i, j = pixel_grid(height, width)
    return np.stack([(i - cx) / fx, (j - cy) / fy, np.ones_like(i)], axis=-1)


def rays_world(directions, cam2world):
    """World-space (origins, normalized directions), each [N, 3]."""
    cam2world = np.asarray(cam2world, np.float32)
    directions = np.asarray(directions, np.float32).reshape(-1, 3)
    rays_d = directions @ cam2world[:3, :3].T
    rays_d = rays_d / np.linalg.norm(rays_d, axis=-1, keepdims=True)
    rays_o = np.broadcast_to(cam2world[:3, 3], rays_d.shape)
    return rays_o, rays_d


def rays_intersect_sphere(rays_o, rays_d, radius: float = 1.0):
    """Forward intersection distance t with the sphere ||o + t d|| = radius
    (cameras must lie inside the sphere)."""
    odotd = np.sum(rays_o * rays_d, axis=-1)
    d_norm_sq = np.sum(rays_d**2, axis=-1)
    o_norm_sq = np.sum(rays_o**2, axis=-1)
    determinant = odotd**2 + (np.float32(radius**2) - o_norm_sq) * d_norm_sq
    return (np.sqrt(determinant) - odotd) / d_norm_sq


def make_ray_bundle(directions, cam2world, near: float = 0.01):
    """Assemble the 8-float ray layout [o(3) d(3) near far]; far is the
    unit-sphere exit distance."""
    rays_o, rays_d = rays_world(directions, cam2world)
    far = rays_intersect_sphere(rays_o, rays_d, 1.0)
    near_col = np.full_like(far, near)
    return np.concatenate([rays_o, rays_d, near_col[:, None], far[:, None]],
                          axis=-1)
