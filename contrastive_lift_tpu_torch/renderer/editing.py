"""Scene-editing render passes: delete / extract / duplicate / manipulate.

Port of ``contrastive_lift_tpu/renderer/editing.py``. Objects are selected
by oriented 3D bounding boxes; edits act by zeroing density inside (or
outside) the box and/or warping sample coordinates + view directions. The
passes sample the VM factors directly (no brick atlas, no empty-space
skipping), every sample of every ray, without gradients, as in the JAX
package.
"""
from __future__ import annotations

from dataclasses import dataclass

import numpy as np
import torch

from ..models import tensorf as tf
from ..ops.compositing import composite, raw_to_alpha
from ..utils.device import resolve_device
from ..utils.transforms import inverse_rigid, trs_comp
from .render import (RenderConfig, RenderState, _head_weights,
                     _semantic_map_postprocess, normalize_coordinates,
                     sample_points_in_box)


@dataclass(frozen=True)
class EditKind:
    DELETE = "delete"
    EXTRACT = "extract"
    DUPLICATE = "duplicate"
    MANIPULATE = "manipulate"


def _host(x) -> np.ndarray:
    return (x.detach().cpu().numpy() if isinstance(x, torch.Tensor)
            else np.asarray(x))


def points_in_oriented_box(xyz: torch.Tensor, extent, position, orientation):
    """Mask of points [N, 3] inside an oriented box: inverse-transform the
    points, then test |p_i| <= extent_i / 2. The box's pose is composed on
    the host in float64 (``trs_comp``), its inverse in float32 on the
    points' device."""
    extent = torch.as_tensor(_host(extent), dtype=torch.float32,
                             device=xyz.device)
    tr = trs_comp(_host(position), _host(orientation), 1.0)
    inv = inverse_rigid(torch.from_numpy(tr).to(xyz.device))
    local = xyz @ inv[:3, :3].T + inv[:3, 3]
    return torch.all(torch.abs(local) <= extent / 2.0, dim=-1)


def edited_weights(params, mcfg: tf.TensoRFConfig, rcfg: RenderConfig,
                   state: RenderState, rays: torch.Tensor, kind, bbox: dict,
                   translation=None, rotation=None):
    """The samples and compositing weights of an edited pass: (normalized
    sample coordinates [R*S, 3], view directions [R*S, 3], weights [R, S],
    z_vals [R, S]). ``kind`` None is the unedited field."""
    xyz, z_vals, in_box = sample_points_in_box(rays, state, rcfg.n_samples)
    R, S = z_vals.shape
    dev = rays.device
    flat_world = xyz.reshape(-1, 3)
    viewdirs = rays[:, None, 3:6].expand(R, S, 3).reshape(-1, 3)

    def tensor(x):
        return torch.as_tensor(_host(x), dtype=torch.float32, device=dev)

    extent = tensor(bbox["extent"])
    position = tensor(bbox["position"])
    orientation = tensor(bbox["orientation"])
    translation = (torch.zeros(3, device=dev) if translation is None
                   else tensor(translation))
    rotation = (torch.eye(3, device=dev) if rotation is None
                else tensor(rotation))

    zero_sigma_mask = torch.zeros(flat_world.shape[0], dtype=torch.bool,
                                  device=dev)
    warped = flat_world
    warped_dirs = viewdirs

    if kind is None:
        pass
    elif kind == EditKind.DELETE:
        zero_sigma_mask = points_in_oriented_box(flat_world, extent, position,
                                                 orientation)
    elif kind == EditKind.EXTRACT:
        zero_sigma_mask = ~points_in_oriented_box(flat_world, extent, position,
                                                  orientation)
    elif kind == EditKind.DUPLICATE:
        target_pos = rotation @ position + translation
        target_orient = rotation @ orientation
        moved = points_in_oriented_box(flat_world, extent, target_pos,
                                       target_orient)
        inv_rot = torch.linalg.inv(rotation)
        warped = torch.where(moved[:, None], flat_world - translation,
                             flat_world)
        warped_dirs = torch.where(moved[:, None], viewdirs @ inv_rot.T,
                                  viewdirs)
    elif kind == EditKind.MANIPULATE:
        target_pos = position + translation
        target_orient = rotation @ orientation
        moved = points_in_oriented_box(flat_world, extent, target_pos,
                                       target_orient)
        source = points_in_oriented_box(flat_world, extent, position,
                                        orientation)
        inv_rot = torch.linalg.inv(rotation)
        back = (flat_world - position) @ rotation.T + position - translation
        warped = torch.where(moved[:, None], back, flat_world)
        warped_dirs = torch.where(moved[:, None], viewdirs @ inv_rot.T,
                                  viewdirs)
        zero_sigma_mask = source & ~moved
    else:
        raise ValueError(kind)

    flat = normalize_coordinates(state, warped.reshape(R, S, 3)).reshape(-1, 3)
    sigma = tf.compute_density(params, mcfg, flat).reshape(R, S)
    sigma = torch.where(in_box, sigma, 0.0)
    sigma = torch.where(zero_sigma_mask.reshape(R, S), 0.0, sigma)
    dists = torch.cat([z_vals[:, 1:] - z_vals[:, :-1],
                       torch.zeros_like(z_vals[:, :1])], dim=-1)
    _, weight, _ = raw_to_alpha(sigma, dists * rcfg.distance_scale)
    return flat, warped_dirs, weight, z_vals


def render_edited(params, mcfg: tf.TensoRFConfig, rcfg: RenderConfig,
                  state: RenderState, rays, kind: str, bbox: dict,
                  translation=None, rotation=None, white_bg: bool = False,
                  device="cuda"):
    """One edited render pass of ``rays`` [R, 8] on ``device`` (where the
    parameters and ``state`` lie). Returns the rgb, semantics, instances
    and depth maps as tensors.

    bbox: {"extent": [3], "position": [3], "orientation": [3,3]}.
    delete: zero density inside the box;
    extract: zero density outside;
    duplicate: warp samples inside the translated box back to the source so
      the object appears twice;
    manipulate: move/rotate the object — samples in the target box map back
      into the source box, source-box leftovers are cleared.
    """
    if kind not in (EditKind.DELETE, EditKind.EXTRACT, EditKind.DUPLICATE,
                    EditKind.MANIPULATE):
        raise ValueError(kind)
    dev = resolve_device(device)
    if state.step_size.device != dev:
        raise ValueError(f"render state is on {state.step_size.device}, "
                         f"render_edited was asked for {dev}")
    with torch.no_grad():
        rays = torch.as_tensor(_host(rays), dtype=torch.float32, device=dev)
        flat, warped_dirs, weight, z_vals = edited_weights(
            params, mcfg, rcfg, state, rays, kind, bbox, translation,
            rotation)
        R, S = z_vals.shape
        rgb = tf.render_appearance(params, mcfg, warped_dirs,
                                   flat).reshape(R, S, 3)
        distilled = None
        if mcfg.use_distilled:
            distilled = tf.render_distilled(params, mcfg, flat)
        semantics = tf.render_semantics(
            params, mcfg, flat,
            distilled if mcfg.use_distilled_features_semantic else None
        ).reshape(R, S, -1)
        instances = tf.render_instances(
            params, mcfg, flat,
            distilled if mcfg.use_distilled_features_instance else None
        ).reshape(R, S, -1)

        opacity = torch.sum(weight, -1)
        rgb_map = composite(weight, rgb)
        w = _head_weights(rcfg, weight)
        semantic_map = _semantic_map_postprocess(rcfg,
                                                 torch.sum(w * semantics, -2))
        instance_map = torch.sum(w * instances, -2)
        if white_bg:
            rgb_map = rgb_map + (1.0 - opacity[..., None])
        rgb_map = torch.clamp(rgb_map, 0.0, 1.0)
        depth_map = torch.sum(weight * z_vals, -1)
    return {"rgb": rgb_map, "semantics": semantic_map,
            "instances": instance_map, "depth": depth_map}
