"""Per-instance 3D bounding-box estimation from clustered surface points.

Port of ``contrastive_lift_tpu/inference/bboxes.py`` (numpy and scipy, on
the host, as there): density-based outlier filtering (``cKDTree``), then
one of
  * axis-aligned box,
  * PCA-oriented box,
  * minimum-volume enclosing ellipsoid (Khachiyan iteration) -> oriented box,
  * convex-hull footprint (``ConvexHull``) + rotating-calipers minimum
    bounding rectangle (gravity-aligned box with optimal yaw).
"""
from __future__ import annotations

from typing import Dict, Tuple

import numpy as np


def filter_points_by_density(points: np.ndarray, k: int = 10,
                             keep_fraction: float = 0.9) -> np.ndarray:
    """Drop the sparsest points by k-NN radius (a KD-tree query)."""
    from scipy.spatial import cKDTree
    if len(points) <= k + 1:
        return points
    tree = cKDTree(points)
    dists, _ = tree.query(points, k=k + 1)
    radius = dists[:, -1]
    keep = radius <= np.quantile(radius, keep_fraction)
    return points[keep]


def axis_aligned_box(points: np.ndarray) -> Dict[str, np.ndarray]:
    lo, hi = points.min(0), points.max(0)
    return {"position": (lo + hi) / 2, "extent": hi - lo,
            "orientation": np.eye(3)}


def pca_box(points: np.ndarray) -> Dict[str, np.ndarray]:
    """Oriented box from the principal axes of the point cloud."""
    mean = points.mean(0)
    centered = points - mean
    _, _, vt = np.linalg.svd(centered, full_matrices=False)
    if np.linalg.det(vt) < 0:
        vt[-1] = -vt[-1]
    local = centered @ vt.T
    lo, hi = local.min(0), local.max(0)
    center_local = (lo + hi) / 2
    return {"position": mean + center_local @ vt,
            "extent": hi - lo, "orientation": vt.T}


def min_volume_ellipsoid(points: np.ndarray, tolerance: float = 1e-3,
                         max_iter: int = 1000) -> Tuple[np.ndarray, np.ndarray]:
    """Khachiyan's algorithm: (A, center) with (x-c)^T A (x-c) <= 1."""
    pts = np.asarray(points, np.float64)
    n, d = pts.shape
    q = np.concatenate([pts, np.ones((n, 1))], axis=1).T  # [d+1, n]
    u = np.full(n, 1.0 / n)
    for _ in range(max_iter):
        x = q @ np.diag(u) @ q.T
        m = np.einsum("in,ij,jn->n", q, np.linalg.inv(x), q)
        j = int(np.argmax(m))
        step = (m[j] - d - 1.0) / ((d + 1) * (m[j] - 1.0))
        new_u = (1 - step) * u
        new_u[j] += step
        if np.linalg.norm(new_u - u) < tolerance:
            u = new_u
            break
        u = new_u
    center = pts.T @ u
    cov = (pts.T @ np.diag(u) @ pts) - np.outer(center, center)
    a = np.linalg.inv(cov) / d
    return a, center


def ellipsoid_box(points: np.ndarray) -> Dict[str, np.ndarray]:
    """Oriented box from the minimum-volume enclosing ellipsoid's axes."""
    a, center = min_volume_ellipsoid(points)
    eigvals, eigvecs = np.linalg.eigh(a)
    radii = 1.0 / np.sqrt(np.maximum(eigvals, 1e-12))
    if np.linalg.det(eigvecs) < 0:
        eigvecs[:, -1] = -eigvecs[:, -1]
    return {"position": center, "extent": 2 * radii, "orientation": eigvecs}


def minimum_bounding_rectangle(points_2d: np.ndarray):
    """Rotating-calipers minimum-area rectangle of 2D points.

    Returns (corners [4,2], angle, extent [2]).
    """
    from scipy.spatial import ConvexHull
    pts = np.asarray(points_2d, np.float64)
    hull = pts[ConvexHull(pts).vertices]
    edges = np.diff(np.vstack([hull, hull[:1]]), axis=0)
    angles = np.unique(np.mod(np.arctan2(edges[:, 1], edges[:, 0]), np.pi / 2))
    best = None
    for angle in angles:
        c, s = np.cos(angle), np.sin(angle)
        rot = np.array([[c, -s], [s, c]])
        local = hull @ rot
        lo, hi = local.min(0), local.max(0)
        area = np.prod(hi - lo)
        if best is None or area < best[0]:
            best = (area, angle, lo, hi, rot)
    _, angle, lo, hi, rot = best
    corners_local = np.array([[lo[0], lo[1]], [hi[0], lo[1]],
                              [hi[0], hi[1]], [lo[0], hi[1]]])
    return corners_local @ rot.T, angle, hi - lo


def mbr_box(points: np.ndarray) -> Dict[str, np.ndarray]:
    """Gravity-aligned oriented box: rotating-calipers footprint in xy, tight z."""
    corners, angle, extent_xy = minimum_bounding_rectangle(points[:, :2])
    z_lo, z_hi = points[:, 2].min(), points[:, 2].max()
    center_xy = corners.mean(0)
    c, s = np.cos(angle), np.sin(angle)
    orientation = np.array([[c, -s, 0], [s, c, 0], [0, 0, 1]]).T
    return {"position": np.array([center_xy[0], center_xy[1], (z_lo + z_hi) / 2]),
            "extent": np.array([extent_xy[0], extent_xy[1], z_hi - z_lo]),
            "orientation": orientation}


BOX_METHODS = {"aabb": axis_aligned_box, "pca": pca_box,
               "ellipsoid": ellipsoid_box, "mbr": mbr_box}


def instance_bounding_boxes(points: np.ndarray, instance_ids: np.ndarray,
                            method: str = "mbr", min_points: int = 20,
                            density_filter: bool = True) -> Dict[int, dict]:
    """Tight boxes per clustered instance id (0/background skipped)."""
    fn = BOX_METHODS[method]
    boxes = {}
    for inst in np.unique(instance_ids):
        if inst <= 0:
            continue
        pts = points[instance_ids == inst]
        if len(pts) < min_points:
            continue
        if density_filter:
            pts = filter_points_by_density(pts)
        if len(pts) < 4:
            continue
        boxes[int(inst)] = fn(pts)
    return boxes
