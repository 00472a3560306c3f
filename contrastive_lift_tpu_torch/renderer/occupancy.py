"""Occupancy maintenance: dense alpha evaluation, dilation, AABB shrink.

Port of ``contrastive_lift_tpu/renderer/occupancy.py``. These run between
epochs, where the grids change shape; the dense density is evaluated one
x-slice at a time (the JAX package's ``lax.map``), so the intermediates stay
small at r5b's final grid (2.08 M voxels). The voxel lattice is the JAX
package's bit for bit, so the new AABB, which is the min and max of occupied
lattice points, is too. ``get_instance_clusters`` and
``export_instance_clusters`` label that lattice with the instance head, for
debugging.
"""
from __future__ import annotations

from typing import Optional, Tuple

import numpy as np
import torch
import torch.nn.functional as F

from ..models import tensorf as tf
from ..ops.grid_sample import lattice
from ..utils.device import resolve_device
from .render import RenderState, make_render_state


def voxel_lattice(state_r: RenderState, grid_dim) -> torch.Tensor:
    """World coordinates [gx, gy, gz, 3] of the voxel lattice over the AABB:
    ``lo * (1 - t) + hi * t`` on the lattice ``t`` of ``jnp.linspace(0, 1,
    g)``, rounded as XLA's CPU fusion rounds it (the first product exact
    inside a fused multiply-add with the rounded second), which float64
    reproduces."""
    dev = state_r.bbox_aabb.device
    t = torch.stack(torch.meshgrid(*(lattice(0.0, 1.0, int(g), dev)
                                     for g in grid_dim), indexing="ij"), -1)
    lo, hi = state_r.bbox_aabb[0], state_r.bbox_aabb[1]
    return (lo.double() * (1.0 - t).double() + (hi * t).double()).float()


def _slices(params, mcfg, state_r: RenderState, grid_dim, fn):
    """(``fn(sigma)`` on the voxel lattice [gx, gy, gz], lattice), one
    x-slice at a time."""
    xyz = voxel_lattice(state_r, grid_dim)
    gy, gz = int(grid_dim[1]), int(grid_dim[2])
    with torch.no_grad():
        out = torch.stack([
            fn(tf.compute_density(
                params, mcfg,
                (xs.reshape(-1, 3) - state_r.bbox_aabb[0])
                * state_r.inv_box_extent - 1.0)).reshape(gy, gz)
            for xs in xyz])
    return out, xyz


def dense_alpha(params, mcfg: tf.TensoRFConfig, state_r: RenderState,
                grid_dim: Tuple[int, int, int]):
    """(alpha = 1 - exp(-sigma * step) [gx, gy, gz], lattice [gx, gy, gz, 3]
    in world coordinates)."""
    return _slices(params, mcfg, state_r, grid_dim,
                   lambda sigma: 1.0 - torch.exp(-sigma * state_r.step_size))


def _max_pool3d(alpha: torch.Tensor, kernel: int = 3) -> torch.Tensor:
    """3D max-pool dilation, stride 1, same size (``-inf`` padding)."""
    pad = kernel // 2
    padded = F.pad(alpha[None, None], (pad,) * 6, value=float("-inf"))
    return F.max_pool3d(padded, kernel, stride=1)[0, 0]


def dilated_occupancy(params, mcfg: tf.TensoRFConfig, state_r: RenderState,
                      grid_dim, alpha_mask_threshold: float = 0.0075):
    """(dilated alpha [gx, gy, gz], its occupied mask ``>= threshold``, the
    lattice): the field ``update_bbox_and_shrink`` thresholds."""
    alpha, xyz = dense_alpha(params, mcfg, state_r, grid_dim)
    dilated = _max_pool3d(torch.clamp(alpha, 0.0, 1.0))
    return dilated, dilated >= alpha_mask_threshold, xyz


def occupied_box(occupied: np.ndarray, xyz: np.ndarray,
                 state_r: RenderState, grid_dim,
                 fractional_lenience: float = 1.0):
    """(new AABB [2, 3] float32, t_l, b_r) of an occupied mask [gx, gy, gz]
    over the lattice ``xyz``: the box of the occupied lattice points
    (scaled about its centre by ``fractional_lenience``, clipped to the
    current AABB) and the voxel range [t_l, b_r) it crops. None when no
    voxel is occupied."""
    if not occupied.any():
        return None
    valid = xyz[occupied]
    xyz_min = valid.min(axis=0)
    xyz_max = valid.max(axis=0)
    extent = xyz_max - xyz_min
    position = (xyz_min + xyz_max) / 2
    xyz_min = position - extent * fractional_lenience / 2
    xyz_max = position + extent * fractional_lenience / 2
    box = state_r.bbox_aabb.cpu().numpy()
    xyz_min = np.maximum(box[0], xyz_min)
    xyz_max = np.minimum(box[1], xyz_max)
    new_aabb = np.stack([xyz_min, xyz_max]).astype(np.float32)
    units = state_r.units.cpu().numpy()
    t_l = np.round(np.round((xyz_min - box[0]) / units)).astype(np.int64)
    b_r = np.round((xyz_max - box[0]) / units).astype(np.int64) + 1
    b_r = np.minimum(b_r, np.asarray(grid_dim))
    return new_aabb, t_l, b_r


def shrink_to_box(params, state_r: RenderState, grid_dim, box,
                  step_ratio: float = 0.5):
    """Crop the factor grids to ``box`` (``occupied_box``'s result).

    Returns (new params, new render state, new grid_dim), or the inputs
    unchanged when ``box`` is None (no voxel occupied) or the cropped size
    is not positive."""
    if box is None:
        return params, state_r, grid_dim
    new_aabb, t_l, b_r = box
    new_size = b_r - t_l
    if not np.all(new_size > 0):
        return params, state_r, grid_dim
    new_params = tf.shrink_volume_grid(params, t_l, b_r)
    new_grid_dim = tuple(int(s) for s in new_size)
    new_state = make_render_state(new_aabb, new_grid_dim, step_ratio,
                                  device=state_r.bbox_aabb.device)
    return new_params, new_state, new_grid_dim


def update_bbox_and_shrink(params, mcfg: tf.TensoRFConfig, state_r: RenderState,
                           grid_dim: Tuple[int, int, int],
                           alpha_mask_threshold: float = 0.0075,
                           step_ratio: float = 0.5,
                           fractional_lenience: float = 1.0):
    """Recompute the occupied AABB and crop the factor grids to it
    (``shrink_to_box``)."""
    _, occupied, xyz = dilated_occupancy(params, mcfg, state_r, grid_dim,
                                         alpha_mask_threshold)
    box = occupied_box(occupied.cpu().numpy(), xyz.cpu().numpy(), state_r,
                       grid_dim, fractional_lenience)
    return shrink_to_box(params, state_r, grid_dim, box, step_ratio)


def dense_sigma(params, mcfg: tf.TensoRFConfig, state_r: RenderState,
                grid_dim: Tuple[int, int, int], upsample: int = 1):
    """Dense density volume [gx, gy, gz] at ``upsample`` times the grid
    resolution."""
    return _slices(params, mcfg, state_r,
                   tuple(int(g) * upsample for g in grid_dim),
                   lambda sigma: sigma)[0]


def get_instance_clusters(params, mcfg: tf.TensoRFConfig, state_r: RenderState,
                          grid_dim: Tuple[int, int, int], mode: str = "alpha",
                          alpha_mask_threshold: float = 0.0075,
                          max_samples: Optional[int] = None, seed: int = 0,
                          device="cuda"):
    """Dense-grid instance argmax -> labelled point cloud for debugging, on
    ``device`` (where the parameters and ``state_r`` lie).

    Returns (xyz [N,3], labels [N]) as numpy: with ``mode`` "alpha" the
    lattice points whose alpha reaches ``alpha_mask_threshold`` (at most
    2^18), else every lattice point (at most 2^16); a seeded numpy choice
    keeps ``max_samples`` of them."""
    dev = resolve_device(device)
    if state_r.step_size.device != dev:
        raise ValueError(f"render state is on {state_r.step_size.device}, "
                         f"get_instance_clusters was asked for {dev}")
    alpha, xyz = dense_alpha(params, mcfg, state_r, grid_dim)
    xyz_flat = xyz.reshape(-1, 3)
    alpha_flat = np.clip(alpha.reshape(-1).cpu().numpy(), 0, 1)
    norm = (xyz_flat - state_r.bbox_aabb[0]) * state_r.inv_box_extent - 1.0
    # chunked head evaluation over the dense lattice; the fast half in
    # slow-fast mode
    labels = []
    with torch.no_grad():
        for i in range(0, norm.shape[0], 262144):
            feats = tf.render_instances(params, mcfg, norm[i:i + 262144])
            labels.append(torch.argmax(feats[:, :mcfg.instance_out_channels],
                                       dim=-1).cpu().numpy())
    labels = np.concatenate(labels)
    if mode == "alpha":
        keep = alpha_flat >= alpha_mask_threshold
        default_cap = 2 ** 18
    else:
        keep = np.ones_like(alpha_flat, bool)
        default_cap = 2 ** 16
    xyz_keep, labels_keep = xyz_flat.cpu().numpy()[keep], labels[keep]
    cap = max_samples or default_cap
    if len(xyz_keep) > cap:
        sel = np.random.default_rng(seed).choice(len(xyz_keep), cap, False)
        xyz_keep, labels_keep = xyz_keep[sel], labels_keep[sel]
    return xyz_keep, labels_keep


def export_instance_clusters(params, mcfg, state_r, grid_dim, output_dir,
                             device="cuda"):
    """Coloured OBJ point clouds of the clustered field: ``alpha.obj`` and
    ``full.obj`` under ``output_dir``."""
    from pathlib import Path
    from ..utils.colors import DistinctColors
    from ..utils.points import save_obj_points
    out = Path(output_dir)
    out.mkdir(parents=True, exist_ok=True)
    dc = DistinctColors()
    for mode in ("alpha", "full"):
        xyz, labels = get_instance_clusters(params, mcfg, state_r, grid_dim,
                                            mode, device=device)
        save_obj_points(out / f"{mode}.obj", xyz, dc.apply(labels))


def get_target_resolution(state_r: RenderState,
                          n_voxels: int) -> Tuple[int, int, int]:
    """Resolution of about ``n_voxels`` voxels in all, proportional to the
    AABB's extent; each axis truncated."""
    aabb = state_r.bbox_aabb.cpu().numpy()
    extent = aabb[1] - aabb[0]
    voxel_size = float((np.prod(extent) / n_voxels) ** (1 / 3))
    res = np.int64(extent / voxel_size)
    return tuple(int(max(r, 1)) for r in res)


def grid_upscale_voxel_counts(min_grid_dim: int, max_grid_dim: int,
                              num_upscales: int):
    """The log-spaced voxel counts of the grid upscales."""
    counts = np.exp(np.linspace(np.log(min_grid_dim**3),
                                np.log(max_grid_dim**3), num_upscales + 1))
    return [int(round(c)) for c in counts[1:]]
