"""Procedural synthetic scene: textured floor + colored spheres with
frame-INCONSISTENT instance pseudo-labels (the port's numpy copy of
``contrastive_lift_tpu/data/synthetic.py``; same seed, same frames).

Serves the role of the reference's "overfit smoke mode" (reference:
dataset/panopli.py:45-47) but with analytically known geometry, so the full
train -> render -> cluster -> PQ pipeline can be tested end-to-end without any
dataset download. Semantics: class 0 = floor (stuff), classes 1..K = thing
classes. Instance ids are randomly permuted per frame — exactly the noise
regime the slow-fast loss is designed for.

Geometry is the classic outside-in capture: cameras sit OUTSIDE a tight scene
AABB looking in, so ray samples start at the box entry — there is no
camera-adjacent sample for the degenerate "opaque near-plane light field"
optimum to occupy (with inside-the-box cameras and smooth colors that
solution reproduces training images exactly and gradient descent finds it).
High-frequency checker texture further penalizes any view-memorization
shortcut.
"""
from __future__ import annotations

import numpy as np

from ..utils import geometry as geo
from .base import FrameData, SceneData, SegmentationData

AABB_HALF = 0.55          # scene AABB is [-AABB_HALF, AABB_HALF]^3
FLOOR_Z = -0.4


def _look_at(eye: np.ndarray, target: np.ndarray) -> np.ndarray:
    """cam2world with +z forward (matching ray_directions convention)."""
    fwd = target - eye
    fwd = fwd / np.linalg.norm(fwd)
    up = np.array([0.0, 0.0, 1.0])
    if abs(np.dot(fwd, up)) > 0.95:
        up = np.array([0.0, 1.0, 0.0])
    right = np.cross(fwd, up)
    right /= np.linalg.norm(right)
    down = np.cross(fwd, right)
    c2w = np.eye(4, dtype=np.float32)
    c2w[:3, 0] = right
    c2w[:3, 1] = down
    c2w[:3, 2] = fwd
    c2w[:3, 3] = eye
    return c2w


def _render_analytic(rays_o, rays_d, centers, radii, colors, classes,
                     checker_freq: float = 40.0):
    """Nearest hit per ray against spheres + the floor plane.

    Returns (rgb, semantics, instances(1-based), depth, valid_mask): floor =
    class 0 / instance 0; rays missing everything inside the AABB are invalid
    (masked out of supervision, GT = white). ``checker_freq`` sets the
    positional-texture frequency: 40 (default) aliases at 48x64 render
    resolution — intentional view-memorization pressure for tiny train runs —
    while reference-scale e2e fixtures pass a lower frequency so the texture
    stays resolvable and raw PQ^scene is non-zero (VERDICT r4 #5).
    """
    n = rays_o.shape[0]
    # floor plane z = FLOOR_Z (valid while the hit stays inside the AABB)
    dz = np.where(np.abs(rays_d[:, 2]) < 1e-8, 1e-8, rays_d[:, 2])
    t_floor = (FLOOR_Z - rays_o[:, 2]) / dz
    floor_pts = rays_o + t_floor[:, None] * rays_d
    floor_ok = ((t_floor > 0.01)
                & (np.abs(floor_pts[:, 0]) <= AABB_HALF)
                & (np.abs(floor_pts[:, 1]) <= AABB_HALF))
    best_t = np.where(floor_ok, t_floor, np.inf).astype(np.float32)
    hit_idx = np.full(n, -1, np.int32)  # -1 = floor (when valid)

    for i, (c, r) in enumerate(zip(centers, radii)):
        oc = rays_o - c
        b = np.sum(oc * rays_d, -1)
        cc = np.sum(oc * oc, -1) - r * r
        disc = b * b - cc
        t = -b - np.sqrt(np.maximum(disc, 0.0))
        valid = (disc > 0) & (t > 0.01) & (t < best_t)
        best_t = np.where(valid, t, best_t)
        hit_idx = np.where(valid, i, hit_idx)

    hit = np.isfinite(best_t)
    best_t = np.where(hit, best_t, 0.0)
    pts = rays_o + best_t[:, None] * rays_d
    light = np.array([0.3, -0.5, 0.8])
    light = light / np.linalg.norm(light)
    # high-frequency positional texture (see module docstring)
    f = checker_freq
    checker = (0.75 + 0.25 * np.sign(np.sin(pts[:, 0] * f)
                                     * np.sin(pts[:, 1] * f)
                                     * np.sin((pts[:, 2] + 0.03) * f))
               ).astype(np.float32)
    base = 0.35 + 0.25 * (pts / AABB_HALF + 1.0) / 2.0
    rgb = base.astype(np.float32)
    for i, (c, col) in enumerate(zip(centers, colors)):
        m = hit_idx == i
        if not m.any():
            continue
        normal = (pts[m] - c)
        normal /= np.linalg.norm(normal, axis=-1, keepdims=True)
        shade = 0.6 + 0.4 * np.clip(normal @ light, 0, 1)
        rgb[m] = col[None, :] * shade[:, None]
    rgb = rgb * checker[:, None]
    rgb = np.where(hit[:, None], rgb, 1.0).astype(np.float32)  # sky = white
    semantics = np.where(hit_idx >= 0, classes[np.maximum(hit_idx, 0)], 0)
    semantics = np.where(hit, semantics, 0).astype(np.int32)
    instances = np.where(hit_idx >= 0, hit_idx + 1, 0).astype(np.int32)
    depth = best_t.astype(np.float32)
    return rgb, semantics, instances, depth, hit


def make_synthetic_scene(num_spheres: int = 5, num_train: int = 12,
                         num_val: int = 4, image_dim=(48, 64),
                         num_thing_classes: int = 2, seed: int = 0,
                         consistent_labels: bool = False,
                         checker_freq: float = 40.0) -> SceneData:
    """Build a full SceneData with all three supervision streams derivable."""
    rng = np.random.default_rng(seed)
    h, w = image_dim
    centers = np.stack([
        rng.uniform(-0.3, 0.3, num_spheres),
        rng.uniform(-0.3, 0.3, num_spheres),
        rng.uniform(FLOOR_Z + 0.12, 0.25, num_spheres)], -1).astype(np.float32)
    radii = rng.uniform(0.09, 0.15, num_spheres).astype(np.float32)
    colors = rng.uniform(0.3, 1.0, (num_spheres, 3)).astype(np.float32)
    classes = (1 + rng.integers(0, num_thing_classes, num_spheres)).astype(np.int32)
    num_classes = 1 + num_thing_classes

    focal = 0.9 * w
    intr = np.array([[focal, 0, w / 2], [0, focal, h / 2], [0, 0, 1]], np.float32)

    def make_frame(idx: int, is_val: bool) -> FrameData:
        # cameras OUTSIDE the AABB (|eye| > sqrt(3)*AABB_HALF is not needed —
        # just outside the box), inside the unit sphere, looking down-in
        angle = 2 * np.pi * (idx / (num_train + num_val)) + (0.4 if is_val else 0.0)
        radius = 0.80 + 0.05 * rng.uniform()
        eye = np.array([radius * np.cos(angle), radius * np.sin(angle),
                        0.35 + 0.2 * rng.uniform()], np.float32)
        target = np.array([0.0, 0.0, -0.15], np.float32) \
            + rng.uniform(-0.08, 0.08, 3).astype(np.float32)
        c2w = _look_at(eye, target)
        dirs = geo.ray_directions_from_intrinsics(h, w, intr)
        rays = geo.make_ray_bundle(dirs, c2w)
        rgb, sem, inst, depth, valid = _render_analytic(
            rays[:, 0:3], rays[:, 3:6], centers, radii, colors, classes,
            checker_freq)
        # frame-inconsistent machine labels: permute instance ids per frame
        if consistent_labels:
            noisy_inst = inst
        else:
            perm = rng.permutation(num_spheres) + 1
            noisy_inst = np.where(inst > 0, perm[np.maximum(inst - 1, 0)], 0)
        probs = np.eye(num_classes, dtype=np.float32)[sem]
        probs = 0.9 * probs + 0.1 / num_classes
        conf = np.full(rays.shape[0], 0.95, np.float32)
        return FrameData(
            name=f"{idx:04d}", rays=rays.astype(np.float32), rgbs=rgb,
            semantics=sem, instances=noisy_inst, probabilities=probs,
            confidences=conf, mask=valid,
            gt_semantics=sem, gt_instances=inst,
            intrinsics=intr, cam2normscene=c2w, depth=depth)

    train = [make_frame(i, False) for i in range(num_train)]
    val = [make_frame(num_train + i, True) for i in range(num_val)]
    seg = SegmentationData(
        fg_classes=sorted(set(classes.tolist())),
        bg_classes=[0],
        num_semantic_classes=num_classes,
        instance_to_semantics={i + 1: int(c) for i, c in enumerate(classes)},
        num_instances=num_spheres)
    bounds = np.array([[-AABB_HALF] * 3, [AABB_HALF] * 3], np.float32)
    return SceneData(train_frames=train, val_frames=val, segmentation=seg,
                     image_dim=image_dim, scene_bounds=bounds,
                     things_filtered=set(seg.fg_classes),
                     stuff_filtered={0})
