"""Point-cloud / camera export for debugging (PLY + OBJ).

Port of ``contrastive_lift_tpu/utils/points.py`` (numpy). ``plot_camera_poses``
imports matplotlib when it is called, as the JAX one does, so it raises
``ImportError`` naming matplotlib on a host without it.
"""
from __future__ import annotations

from pathlib import Path

import numpy as np


def save_ply(path, points: np.ndarray, colors=None) -> None:
    """Binary-less ASCII PLY of [N,3] points with optional [N,3] colors in [0,1]."""
    points = np.asarray(points, np.float32)
    n = len(points)
    header = ["ply", "format ascii 1.0", f"element vertex {n}",
              "property float x", "property float y", "property float z"]
    if colors is not None:
        header += ["property uchar red", "property uchar green",
                   "property uchar blue"]
        rgb = (np.clip(np.asarray(colors), 0, 1) * 255).astype(np.uint8)
    header += ["end_header"]
    lines = header
    for i in range(n):
        row = f"{points[i, 0]} {points[i, 1]} {points[i, 2]}"
        if colors is not None:
            row += f" {rgb[i, 0]} {rgb[i, 1]} {rgb[i, 2]}"
        lines.append(row)
    Path(path).write_text("\n".join(lines) + "\n")


def save_obj_points(path, points: np.ndarray, colors=None) -> None:
    """OBJ vertex cloud (v x y z [r g b])."""
    points = np.asarray(points, np.float32)
    lines = []
    for i in range(len(points)):
        row = f"v {points[i, 0]} {points[i, 1]} {points[i, 2]}"
        if colors is not None:
            c = np.clip(np.asarray(colors)[i], 0, 1)
            row += f" {c[0]} {c[1]} {c[2]}"
        lines.append(row)
    Path(path).write_text("\n".join(lines) + "\n")


def camera_frustum_points(cam2world: np.ndarray, intrinsics: np.ndarray,
                          image_hw, depth: float = 0.2) -> np.ndarray:
    """Five points (center + 4 image corners at given depth) for pose viz."""
    h, w = image_hw
    inv_k = np.linalg.inv(np.asarray(intrinsics))
    corners = np.array([[0, 0, 1], [w, 0, 1], [w, h, 1], [0, h, 1]], np.float64)
    cam_pts = (corners @ inv_k.T) * depth
    pts = np.concatenate([np.zeros((1, 3)), cam_pts])
    r = cam2world[:3, :3]
    t = cam2world[:3, 3]
    return pts @ r.T + t


def export_camera_poses(path, cam2worlds, intrinsics, image_hw) -> None:
    """All camera frustums as one OBJ point cloud."""
    pts = np.concatenate([camera_frustum_points(c2w, intrinsics, image_hw)
                          for c2w in cam2worlds])
    save_obj_points(path, pts)


def plot_camera_poses(path, cam2worlds, focal_len_scaled: float = 1.0,
                      aspect_ratio: float = 0.35, color="limegreen",
                      color_by_index: bool = False) -> None:
    """Matplotlib 3D figure of camera frustum pyramids (PDF/PNG by suffix).

    Each extrinsic is drawn as a 5-vertex pyramid (apex at the camera
    center, base toward -z in the camera frame), its alpha a depth cue along
    the scene's dominant axis (0.1..0.35 back to front), the axis limits the
    pose extents +1; ``color_by_index`` colours by frame index (rainbow)
    with a colorbar.
    """
    import matplotlib
    matplotlib.use("Agg")
    import matplotlib.pyplot as plt
    from mpl_toolkits.mplot3d.art3d import Poly3DCollection

    poses = np.asarray(cam2worlds, np.float64)  # [N,4,4]
    f = -focal_len_scaled  # base plane toward -z, as the reference flips it
    a = abs(f) * aspect_ratio
    vertex_std = np.array([[0, 0, 0, 1], [a, -a, f, 1], [a, a, f, 1],
                           [-a, a, f, 1], [-a, -a, f, 1]])  # apex + 4 corners
    verts = np.einsum("vj,nij->nvi", vertex_std, poses)[:, :, :3]  # [N,5,3]

    t = poses[:, :3, 3]
    # depth-cue alpha along the axis of largest camera spread (the reference
    # hardcodes y for MOS corridors; generalizing keeps the cue meaningful
    # for arbitrary scenes)
    axis = int(np.argmax(t.max(0) - t.min(0))) if len(t) > 1 else 1
    span = max(float(t[:, axis].max() - t[:, axis].min()), 1e-9)
    alphas = (t[:, axis] - t[:, axis].min()) / span * 0.25 + 0.1

    fig = plt.figure(figsize=(18, 7))
    ax = fig.add_subplot(projection="3d")
    mins, maxes = t.min(0), t.max(0)
    ax.set_xlim(mins[0] - 1, maxes[0] + 1)
    ax.set_ylim(mins[1] - 1, maxes[1] + 1)
    ax.set_zlim(mins[2] - 1, maxes[2] + 1)
    ax.set_xlabel("x"), ax.set_ylabel("y"), ax.set_zlabel("z")
    cmap = plt.get_cmap("rainbow")
    for i, (v, alpha) in enumerate(zip(verts, alphas)):
        faces = [[v[0], v[1], v[2]], [v[0], v[2], v[3]], [v[0], v[3], v[4]],
                 [v[0], v[4], v[1]], [v[1], v[2], v[3], v[4]]]
        c = cmap(i / max(len(verts) - 1, 1)) if color_by_index else color
        ax.add_collection3d(Poly3DCollection(
            faces, facecolors=c, linewidths=0.3, edgecolors=c,
            alpha=float(alpha)))
    if color_by_index:
        norm = matplotlib.colors.Normalize(vmin=0, vmax=len(verts))
        fig.colorbar(matplotlib.cm.ScalarMappable(norm=norm, cmap=cmap),
                     ax=ax, orientation="vertical", label="Frame Number")
    ax.set_title("Extrinsic Parameters")
    fig.savefig(path, dpi=300, bbox_inches="tight")
    plt.close(fig)


def export_scene_point_cloud(path, frames, subsample: int = 10,
                             color_by: str = "rgb") -> None:
    """Back-project frames with depth into a world point cloud (PLY)."""
    from ..utils.colors import DistinctColors
    all_pts, all_cols = [], []
    dc = DistinctColors()
    for f in frames:
        if f.depth is None:
            continue
        sel = np.arange(0, f.rays.shape[0], subsample)
        o, d = f.rays[sel, :3], f.rays[sel, 3:6]
        pts = o + f.depth.reshape(-1)[sel, None] * d
        all_pts.append(pts)
        if color_by == "semantics":
            all_cols.append(dc.apply(f.semantics.reshape(-1)[sel]))
        elif color_by == "instances":
            all_cols.append(dc.apply(f.instances.reshape(-1)[sel]))
        else:
            all_cols.append(f.rgbs[sel])
    if not all_pts:
        raise ValueError("no frames with depth to export")
    save_ply(path, np.concatenate(all_pts), np.concatenate(all_cols))
