"""Camera / ray geometry in numpy (float32).

Port of ``contrastive_lift_tpu/utils/geometry.py``: the ray generation
(pinhole and undistorted rays, unit-sphere far plane, the 8-float ray
layout, NDC rays), the frustum-union scene normalisation of the PanopLi and
MOS readers, the distance <-> depth conversion of the render's
visualisations, (un)projection, and the Newton-iteration radial/tangential
undistortion.
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


def ray_directions_undistorted(height: int, width: int, intrinsics,
                               distortion) -> np.ndarray:
    """Ray directions [H, W, 3] with radial/tangential undistortion
    (``distortion`` = k1, k2, k3, k4[, p1, p2])."""
    intrinsics = np.asarray(intrinsics, np.float32)
    fx, fy = intrinsics[0, 0], intrinsics[1, 1]
    cx, cy = intrinsics[0, 2], intrinsics[1, 2]
    i, j = pixel_grid(height, width)
    x, y = radial_tangential_undistort((i - cx) / fx, (j - cy) / fy,
                                       *distortion)
    return np.stack([x, y, np.ones_like(i)], axis=-1)


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


def ndc_rays(height: int, width: int, focal_length: float, near: float,
             rays_o, rays_d):
    """Shift rays to the near plane and project them into NDC space (for
    forward-facing captures)."""
    t = -(near + rays_o[..., 2]) / rays_d[..., 2]
    rays_o = rays_o + t[..., None] * rays_d
    ox_oz = rays_o[..., 0] / rays_o[..., 2]
    oy_oz = rays_o[..., 1] / rays_o[..., 2]
    o0 = -1.0 / (width / (2.0 * focal_length)) * ox_oz
    o1 = -1.0 / (height / (2.0 * focal_length)) * oy_oz
    o2 = 1.0 + 2.0 * near / rays_o[..., 2]
    d0 = -1.0 / (width / (2.0 * focal_length)) * (
        rays_d[..., 0] / rays_d[..., 2] - ox_oz)
    d1 = -1.0 / (height / (2.0 * focal_length)) * (
        rays_d[..., 1] / rays_d[..., 2] - oy_oz)
    d2 = 1.0 - o2
    return np.stack([o0, o1, o2], -1), np.stack([d0, d1, d2], -1)


# ---------------------------------------------------------------------------
# Scene normalization: fit the union of camera frustums into the unit sphere.
# ---------------------------------------------------------------------------

def frustum_world_sphere(dims, intrinsics, cam2worlds, max_depth: float):
    """(center, radius) of a sphere containing all camera frustums.

    dims [N,2] (h,w); intrinsics [N,3,3]; cam2worlds [N,4,4]."""
    dims = np.asarray(dims, np.float32)
    intrinsics = np.asarray(intrinsics, np.float32)
    cam2worlds = np.asarray(cam2worlds, np.float32)
    n = len(dims)
    # three homogeneous image-corner skeleton points in (h, w, 1) order
    h_img_corners = np.array([[0, 1, 1], [1, 0, 1], [1, 1, 1]], np.float32)
    intr_hw = intrinsics[:, [1, 0, 2]]  # K rows are WH-major -> convert to HW
    intr_inv = np.linalg.inv(intr_hw)
    hw1 = np.concatenate([dims, np.ones((n, 1), np.float32)], axis=1)  # [N,3]
    skel = hw1[:, None, :] * h_img_corners[None, :, :]                 # [N,3,3]
    corners_far = np.einsum("nij,nkj->nki", intr_inv, skel) * max_depth
    corners_near = np.einsum("nij,nkj->nki", intr_inv, skel) * 0.01
    corners = np.concatenate([corners_far, corners_near], axis=0)      # [2N,3,3]
    corners_h = np.concatenate(
        [corners, np.ones((*corners.shape[:2], 1), np.float32)], -1)
    c2w2 = np.concatenate([cam2worlds, cam2worlds], axis=0)
    world = np.einsum("nij,nkj->nki", c2w2, corners_h).reshape(-1, 4)[:, :3]
    center = world.mean(axis=0)
    radius = np.linalg.norm(world - center, axis=1).max()
    return center, radius


def compute_world2normscene(dims, intrinsics, cam2worlds, max_depth: float,
                            rescale_factor: float = 1.0) -> np.ndarray:
    """4x4 transform scaling the scene so all frustums fit in the unit
    sphere."""
    if rescale_factor < 1.0:
        raise ValueError(f"rescale_factor {rescale_factor} is below 1")
    center, radius = frustum_world_sphere(dims, intrinsics, cam2worlds,
                                          max_depth)
    scale = 1.0 / (rescale_factor * radius)
    transform = np.eye(4, dtype=np.float32)
    transform[:3, :3] *= scale
    transform[:3, 3] = -center * scale
    return transform


# ---------------------------------------------------------------------------
# Distance <-> depth
# ---------------------------------------------------------------------------

def _homogeneous_pixels(height: int, width: int) -> np.ndarray:
    """(i, j, 1) of every pixel, [H*W, 3] float32."""
    i, j = pixel_grid(height, width)
    return np.stack([i.reshape(-1), j.reshape(-1),
                     np.ones(height * width, np.float32)], axis=-1)


def _pixel_norms(intrinsics, height: int, width: int) -> np.ndarray:
    """|K^-1 (i, j, 1)| of every pixel, [H*W] float32."""
    intrinsics = np.asarray(intrinsics, np.float32)
    pts = _homogeneous_pixels(height, width) @ np.linalg.inv(intrinsics).T
    return np.linalg.norm(pts, axis=-1)


def distance_to_depth(intrinsics, dist, height: int, width: int) -> np.ndarray:
    """Per-pixel ray distance -> z-depth; ``dist`` flat [H*W] or [H, W]."""
    dist = np.asarray(dist).reshape(-1)
    return dist / _pixel_norms(intrinsics, height, width)


def depth_to_distance(intrinsics, depth, height: int, width: int) -> np.ndarray:
    """Per-pixel z-depth -> ray distance; ``depth`` flat [H*W] or [H, W]."""
    depth = np.asarray(depth).reshape(-1)
    return depth * _pixel_norms(intrinsics, height, width)


def unproject_2d_3d(cam2world, intrinsics, depth, height: int, width: int):
    """Back-project a z-depth map into world points [H*W, 3]."""
    cam2world = np.asarray(cam2world, np.float32)
    intrinsics = np.asarray(intrinsics, np.float32)
    cam_pts = ((_homogeneous_pixels(height, width)
                @ np.linalg.inv(intrinsics).T)
               * np.reshape(np.asarray(depth, np.float32), (-1, 1)))
    return cam_pts @ cam2world[:3, :3].T + cam2world[:3, 3]


def project_3d_2d(cam2world, intrinsics, world_points):
    """Project world points [N, 3] to continuous pixel coordinates [N, 2]."""
    cam2world = np.asarray(cam2world, np.float32)
    intrinsics = np.asarray(intrinsics, np.float32)
    world_points = np.asarray(world_points, np.float32)
    world2cam = np.linalg.inv(cam2world)
    pts_h = np.concatenate([world_points, np.ones_like(world_points[:, :1])],
                           -1)
    img = (pts_h @ world2cam.T)[:, :3] @ intrinsics.T
    return img[:, :2] / img[:, 2:3]


# ---------------------------------------------------------------------------
# Undistortion (Newton iterations)
# ---------------------------------------------------------------------------

def _undistort_residual_jacobian(x, y, xd, yd, k1, k2, k3, k4, p1, p2):
    r = x * x + y * y
    d = 1.0 + r * (k1 + r * (k2 + r * (k3 + r * k4)))
    fx = d * x + 2 * p1 * x * y + p2 * (r + 2 * x * x) - xd
    fy = d * y + 2 * p2 * x * y + p1 * (r + 2 * y * y) - yd
    d_r = k1 + r * (2.0 * k2 + r * (3.0 * k3 + r * 4.0 * k4))
    d_x = 2.0 * x * d_r
    d_y = 2.0 * y * d_r
    fx_x = d + d_x * x + 2.0 * p1 * y + 6.0 * p2 * x
    fx_y = d_y * x + 2.0 * p1 * x + 2.0 * p2 * y
    fy_x = d_x * y + 2.0 * p2 * y + 2.0 * p1 * x
    fy_y = d + d_y * y + 2.0 * p2 * x + 6.0 * p1 * y
    return fx, fy, fx_x, fx_y, fy_x, fy_y


def radial_tangential_undistort(xd, yd, k1=0.0, k2=0.0, k3=0.0, k4=0.0,
                                p1=0.0, p2=0.0, eps=1e-9, max_iterations=10):
    """(x, y) with the distortion of (xd, yd) undone by ``max_iterations``
    Newton steps; a step is skipped where the Jacobian is singular."""
    xd = np.asarray(xd, np.float32)
    yd = np.asarray(yd, np.float32)
    x, y = xd, yd
    for _ in range(max_iterations):
        fx, fy, fx_x, fx_y, fy_x, fy_y = _undistort_residual_jacobian(
            x, y, xd, yd, k1, k2, k3, k4, p1, p2)
        denom = fy_x * fx_y - fx_x * fy_y
        ok = np.abs(denom) > eps
        safe = np.where(ok, denom, np.float32(1.0))
        x = x + np.where(ok, (fx * fy_y - fy * fx_y) / safe, np.float32(0.0))
        y = y + np.where(ok, (fy * fx_x - fx * fy_x) / safe, np.float32(0.0))
    return x, y
