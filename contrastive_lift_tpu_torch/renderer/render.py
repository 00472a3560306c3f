"""Volume renderer for the TensoRF panoptic field: the dense path.

Port of the dense path of ``contrastive_lift_tpu/renderer/render.py``: every
ray carries ``n_samples`` AABB-clipped uniform samples, the density of each
goes through the brick-atlas kernel (``ops/brick_interp.py``), and every head
runs on every sample, with samples below ``raymarch_weight_thres`` masked to
zero. This is the fp32 render that ``tools/pq_fidelity_gate.py`` uses as its
reference.

``RenderConfig`` keeps every field of the JAX config so the two compare field
by field. The empty-space-skipping, top-k and two-phase head fields select
paths that are not ported yet: ``render_rays`` raises ``NotImplementedError``
naming the field when one is set.
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import NamedTuple, Optional

import numpy as np
import torch

from ..models import tensorf as tf
from ..ops.compositing import composite, distortion_loss, raw_to_alpha
from ..ops.fused_grid import (FusedGrids, sample_density_brick,
                              sample_feature_fused)


@dataclass(frozen=True)
class RenderConfig:
    """Static renderer knobs; fields and defaults as in the JAX package."""
    n_samples: int
    num_semantic_classes: int
    dim_feature_instance: int
    semantic_weight_mode: str = "softmax"   # none|softmax|argmax
    stop_semantic_grad: bool = True
    feature_stop_grad: bool = False
    distance_scale: float = 25.0
    raymarch_weight_thres: float = 1e-4
    alpha_mask_threshold: float = 0.0075
    perturb: float = 1.0
    white_bg: bool = False
    # top-k head compaction (not ported: must be None here)
    head_topk: Optional[int] = None
    head_topk_semins: Optional[int] = None
    head_dtype: str = "float32"             # float32|bfloat16 head matmuls
    atlas_dtype: str = "float32"            # float32|bfloat16 density atlas
    # empty-space skipping (not ported: coarse_stride/sub_stride must be None)
    coarse_stride: Optional[int] = None
    max_segments: int = 48
    occ_alpha_thres: float = 1e-5
    sub_stride: Optional[int] = None
    max_subsegments: int = 24
    max_subsegments_light: int = 0
    heavy_fraction: float = 0.125
    occ_group_l1: int = 0
    occ_group_l2: bool = False
    use_l1: bool = True
    l2_flat_group: int = 0
    term_first: int = 0
    term_fraction: float = 0.25
    # two-phase heads and the other top-k refinements (not ported)
    head_term_first: int = 0
    head_term_fraction: float = 0.25
    head_tail_complete: bool = False
    head_dedup_cells: Optional[int] = None
    head_select: str = "sort"
    fine_span_rows: Optional[int] = None

    def __post_init__(self):
        if self.head_topk_semins is not None and self.head_topk is None:
            raise ValueError("head_topk_semins compacts a prefix of the "
                             "head_topk sort; set head_topk too")
        if (self.sub_stride is not None and self.coarse_stride is not None
                and self.sub_stride < self.coarse_stride
                and self.coarse_stride % self.sub_stride != 0):
            raise ValueError(
                f"coarse_stride ({self.coarse_stride}) must be a multiple of "
                f"sub_stride ({self.sub_stride})")
        if not self.use_l1 and self.sub_stride is None:
            raise ValueError("use_l1=False (L2-only selection) requires "
                             "sub_stride")
        if self.head_dedup_cells is not None and self.head_topk is None:
            raise ValueError("head_dedup_cells dedups the top-k head gather "
                             "stream; set head_topk too")
        if self.head_term_first and self.head_topk is None:
            raise ValueError("head_term_first splits the top-k head sample "
                             "budget; set head_topk too")
        if self.head_select not in ("sort", "iter", "rank"):
            raise ValueError(f"head_select must be 'sort', 'iter', or 'rank', "
                             f"got {self.head_select!r}")
        if self.fine_span_rows is not None and self.fine_span_rows < 2:
            raise ValueError("fine_span_rows must be >= 2; None disables "
                             "span gathers")
        if self.atlas_dtype not in ("float32", "bfloat16"):
            raise ValueError(f"atlas_dtype must be 'float32' or 'bfloat16', "
                             f"got {self.atlas_dtype!r}")


def check_dense(rcfg: RenderConfig) -> None:
    """Raise ``NotImplementedError`` naming each set option whose path is not
    ported (the dense path runs with all of them off)."""
    unported = [name for name in ("coarse_stride", "sub_stride", "head_topk",
                                  "head_dedup_cells", "fine_span_rows")
                if getattr(rcfg, name) is not None]
    if rcfg.head_select != "sort":
        unported.append(f"head_select={rcfg.head_select!r}")
    if unported:
        raise NotImplementedError(
            f"RenderConfig options not ported yet (dense path only): "
            f"{', '.join(unported)}")


class RenderState(NamedTuple):
    """Dynamic renderer state (tensors on the render device)."""
    bbox_aabb: torch.Tensor       # [2, 3]
    inv_box_extent: torch.Tensor  # [3] = 2/extent
    units: torch.Tensor           # [3] voxel size
    step_size: torch.Tensor       # scalar


def make_render_state(bbox_aabb, grid_dim, step_ratio: float = 0.5,
                      device="cpu") -> RenderState:
    """Derive the step size from the AABB and the grid resolution (float32)."""
    bbox_aabb = torch.as_tensor(np.asarray(bbox_aabb, np.float32))
    grid_dim = torch.as_tensor(np.asarray(grid_dim, np.float32))
    extent = bbox_aabb[1] - bbox_aabb[0]
    units = extent / (grid_dim - 1 + 1e-3)
    # mean as XLA computes it (sum times the reciprocal count), so the step
    # size, and every sample position, agrees with the JAX package's bit for bit
    step_size = torch.sum(units) * (1.0 / units.numel()) * step_ratio
    return RenderState(*(t.to(device) for t in
                         (bbox_aabb, 2.0 / extent, units, step_size)))


def compute_n_samples(bbox_aabb, grid_dim, step_ratio: float = 0.5) -> int:
    """Host-side static sample count: box_diag/step + 1."""
    bbox_aabb = np.asarray(bbox_aabb, np.float32)
    grid_dim = np.asarray(grid_dim, np.float32)
    extent = bbox_aabb[1] - bbox_aabb[0]
    units = extent / (grid_dim - 1 + 1e-3)
    step = float(np.mean(units) * step_ratio)
    diag = float(np.sqrt(np.sum(extent**2)))
    return int(diag / step) + 1


def normalize_coordinates(state: RenderState, xyz: torch.Tensor) -> torch.Tensor:
    return (xyz - state.bbox_aabb[0]) * state.inv_box_extent - 1.0


def sample_points_in_box(rays, state: RenderState, n_samples: int):
    """AABB-clipped uniform samples along each ray, without jitter.

    rays [R, 8] = [o, d, near, far]. Returns (xyz [R,S,3], z_vals [R,S],
    in_box mask [R,S])."""
    rays_o, rays_d = rays[:, 0:3], rays[:, 3:6]
    nears, fars = rays[:, 6], rays[:, 7]
    vec = torch.where(rays_d == 0, torch.full_like(rays_d, 1e-6), rays_d)
    rate_a = (state.bbox_aabb[1] - rays_o) / vec
    rate_b = (state.bbox_aabb[0] - rays_o) / vec
    t_min = torch.amax(torch.minimum(rate_a, rate_b), dim=-1)
    t_min = torch.minimum(torch.maximum(t_min, nears), fars)
    steps = torch.arange(n_samples, dtype=torch.float32,
                         device=rays.device)[None, :]
    z_vals = t_min[:, None] + steps * state.step_size
    xyz = rays_o[:, None, :] + rays_d[:, None, :] * z_vals[..., None]
    in_box = torch.all((xyz >= state.bbox_aabb[0]) & (xyz <= state.bbox_aabb[1]),
                       dim=-1)
    return xyz, z_vals, in_box


def _intervals(z_vals):
    dists = torch.cat([z_vals[:, 1:] - z_vals[:, :-1],
                       torch.zeros_like(z_vals[:, :1])], dim=-1)
    mids = torch.cat([(z_vals[:, 1:] + z_vals[:, :-1]) / 2,
                      z_vals[:, -2:-1]], dim=-1)
    return dists, mids


def _density_weights(mcfg, rcfg, state, rays, fused: FusedGrids):
    """Density at every sample through the brick-atlas kernel, then alpha
    compositing weights (the brick-atlas branch of the JAX function).
    Returns (xyz_n, z_vals, dists, mids, weight)."""
    xyz, z_vals, in_box = sample_points_in_box(rays, state, rcfg.n_samples)
    dists, mids = _intervals(z_vals)
    xyz_n = normalize_coordinates(state, xyz)
    raw = sample_density_brick(fused, xyz_n.reshape(-1, 3),
                               mcfg.splus_density_shift)
    # softplus as log(1 + e^x): F.softplus switches to the identity above 20
    sigma = torch.logaddexp(raw, torch.zeros((), device=raw.device))
    sigma = torch.where(in_box, sigma.reshape(xyz.shape[:2]), 0.0)
    _, weight, _ = raw_to_alpha(sigma, dists * rcfg.distance_scale)
    return xyz_n, z_vals, dists, mids, weight


def _branch_feats(fused: FusedGrids, name: str, flat):
    """Dense-grid features of a VM branch, or None for an xyz-MLP head."""
    if name in fused.features:
        return sample_feature_fused(fused, name, flat)
    return None


def _semantic_map_postprocess(rcfg, semantic_map):
    if rcfg.semantic_weight_mode == "softmax":
        semantic_map = semantic_map / (torch.sum(semantic_map, -1, keepdim=True) + 1e-8)
        semantic_map = torch.log(semantic_map + 1e-8)
    return semantic_map


def _head_weights(rcfg, weight):
    """The per-sample compositing weights used for semantic/instance heads."""
    if rcfg.semantic_weight_mode == "argmax":
        hot = torch.nn.functional.one_hot(torch.argmax(weight, dim=1),
                                          weight.shape[1]).to(weight.dtype)
        return hot[..., None]
    return weight[..., None]


def render_rays(params, mcfg: tf.TensoRFConfig, rcfg: RenderConfig,
                state: RenderState, rays: torch.Tensor,
                rng=None, is_train: bool = False,
                fused: Optional[FusedGrids] = None):
    """Dense render pass: rgb / semantics / instances / depth / dist-reg.

    Inference only (``is_train`` and ``rng`` belong to training, not ported).
    ``fused`` are the grids of ``ops/fused_grid.py::build_render_grids``; the
    density of every sample goes through the brick-atlas kernel."""
    if is_train or rng is not None:
        raise NotImplementedError("render_rays: is_train / rng (training "
                                  "render) is not ported")
    if fused is None:
        raise NotImplementedError("render_rays: fused=None (direct VM "
                                  "sampling) is not ported; pass "
                                  "build_render_grids(params)")
    if mcfg.use_distilled:
        raise NotImplementedError("render_rays: distilled-feature heads "
                                  "(use_distilled_features_*) are not ported")
    check_dense(rcfg)
    xyz_n, z_vals, dists, mids, weight = _density_weights(mcfg, rcfg, state,
                                                         rays, fused)
    R, S = weight.shape
    dist_reg = distortion_loss(weight, mids, dists)
    compute_dtype = (torch.bfloat16 if rcfg.head_dtype == "bfloat16"
                     else torch.float32)

    flat = xyz_n.reshape(-1, 3)
    mask_flat = (weight > rcfg.raymarch_weight_thres).reshape(-1, 1)
    viewdirs = rays[:, None, 3:6].expand(R, S, 3).reshape(-1, 3)
    rgb = tf.render_appearance(params, mcfg, viewdirs, flat, compute_dtype,
                               feats=_branch_feats(fused, "appearance", flat))
    rgb = torch.where(mask_flat, rgb, 0.0).reshape(R, S, 3)
    semantics = tf.render_semantics(
        params, mcfg, flat, None, compute_dtype,
        feats=_branch_feats(fused, "semantic", flat))
    instances = tf.render_instances(
        params, mcfg, flat, None, compute_dtype,
        feats=_branch_feats(fused, "instance", flat))
    semantics = torch.where(mask_flat, semantics, 0.0).reshape(R, S, -1)
    instances = torch.where(mask_flat, instances, 0.0).reshape(R, S, -1)

    opacity = torch.sum(weight, -1)
    rgb_map = composite(weight, rgb)
    w = _head_weights(rcfg, weight)
    semantic_map = _semantic_map_postprocess(rcfg, torch.sum(w * semantics, dim=-2))
    instance_map = torch.sum(w * instances, dim=-2)
    return _finish_maps(rcfg, weight, z_vals, opacity, rgb_map, semantic_map,
                        instance_map, dist_reg)


def _finish_maps(rcfg, weight, z_vals, opacity, rgb_map, semantic_map,
                 instance_map, dist_reg):
    """Map finishing at inference: white-background compositing, depth."""
    if rcfg.white_bg:
        rgb_map = rgb_map + (1.0 - opacity[..., None])
    rgb_map = torch.clamp(rgb_map, 0.0, 1.0)
    depth_map = torch.sum(weight * z_vals, -1)
    return {"rgb": rgb_map, "semantics": semantic_map,
            "instances": instance_map, "depth": depth_map,
            "dist_reg": dist_reg, "opacity": opacity}
