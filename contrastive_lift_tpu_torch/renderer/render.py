"""Volume renderer for the TensoRF panoptic field: inference and training.

Port of ``contrastive_lift_tpu/renderer/render.py``:

* the dense path: every ray carries ``n_samples`` AABB-clipped uniform
  samples, the density of each goes through the brick-atlas kernel
  (``ops/brick_interp.py``), through the cell-corner rows of
  ``build_density_only`` (training), or is sampled from the VM factors
  directly (``fused=None``), and every head runs on every sample, with
  samples below ``raymarch_weight_thres`` masked to zero (the fp32 reference
  of ``tools/pq_fidelity_gate.py``);
* the production path (``coarse_stride`` / ``sub_stride``): the segments or
  sub-segments of each ray are tested against the occupancy tables, the
  fine density runs only at the nearest occupied ones, optionally in two
  passes with early termination (``term_first``), and with ``head_topk`` the
  heads run only on the k heaviest samples per ray, optionally in two phases
  (``head_term_first``), with tail completion (``head_tail_complete``);
* training (``is_train`` with random draws): jittered samples and the
  background coin in ``render_rays``, and the stop-gradient instance and
  segment passes (``render_instance_features``, ``render_segment_features``)
  with train-time empty-space skipping and top-k heads (``_aux_topk``).

Randomness comes from a ``torch.Generator`` or, so that a run can take the
JAX package's draws, from the draws themselves (``RayDraws``).

``RenderConfig`` keeps every field of the JAX config so the two compare field
by field; ``check_ported`` names the options whose paths are not ported.
"""
from __future__ import annotations

from dataclasses import dataclass, replace
from typing import NamedTuple, Optional

import numpy as np
import torch

from ..models import tensorf as tf
from ..ops.compositing import composite, distortion_loss, raw_to_alpha
from ..ops.fused_grid import (FusedGrids, sample_coarse_occ,
                              sample_density_brick, sample_density_fused,
                              sample_feature_fused, sample_occ_bits_grouped)


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
    # top-k head compaction
    head_topk: Optional[int] = None
    head_topk_semins: Optional[int] = None
    head_dtype: str = "float32"             # float32|bfloat16 head matmuls
    atlas_dtype: str = "float32"            # float32|bfloat16 density atlas
    # empty-space skipping; the L1 segment level (use_l1) is not ported
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
    # two-phase heads, tail completion; dedup, iter/rank select and span
    # gathers are not ported
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


def check_ported(rcfg: RenderConfig) -> None:
    """Raise ``NotImplementedError`` naming each set option whose path is not
    ported."""
    unported = [name for name in ("head_dedup_cells", "fine_span_rows")
                if getattr(rcfg, name) is not None]
    if rcfg.head_select != "sort":
        unported.append(f"head_select={rcfg.head_select!r}")
    if unported:
        raise NotImplementedError(
            f"RenderConfig options not ported yet: {', '.join(unported)}")


class RayDraws(NamedTuple):
    """The random draws of one training render: the per-ray jitter
    (U[0,1), scaled by ``perturb`` steps) and the background coin (U[0,1),
    white background below 0.5)."""
    jitter: torch.Tensor                 # [R]
    coin: Optional[torch.Tensor] = None  # []


def ray_draws(rng, n_rays: int, device) -> Optional[RayDraws]:
    """``rng`` as the draws of a render of ``n_rays`` rays on ``device``:
    ``None`` stays ``None``, ``RayDraws`` are moved to the device, and a
    ``torch.Generator`` draws the jitter, then the coin."""
    if rng is None:
        return None
    if isinstance(rng, RayDraws):
        return RayDraws(*(None if t is None else t.to(device) for t in rng))
    if not isinstance(rng, torch.Generator):
        raise TypeError(f"rng must be None, RayDraws or a torch.Generator, "
                        f"got {type(rng).__name__}")
    jitter = torch.rand(n_rays, generator=rng, device=rng.device)
    coin = torch.rand((), generator=rng, device=rng.device)
    return RayDraws(jitter.to(device), coin.to(device))


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


def _ray_tmin(state: RenderState, rays: torch.Tensor):
    """(origins, directions, AABB entry parameter clipped to [near, far])."""
    rays_o, rays_d = rays[:, 0:3], rays[:, 3:6]
    nears, fars = rays[:, 6], rays[:, 7]
    vec = torch.where(rays_d == 0, torch.full_like(rays_d, 1e-6), rays_d)
    rate_a = (state.bbox_aabb[1] - rays_o) / vec
    rate_b = (state.bbox_aabb[0] - rays_o) / vec
    t_min = torch.amax(torch.minimum(rate_a, rate_b), dim=-1)
    return rays_o, rays_d, torch.minimum(torch.maximum(t_min, nears), fars)


_softplus = tf._softplus


def sample_points_in_box(rays, state: RenderState, n_samples: int,
                         perturb: float = 0.0,
                         jitter: Optional[torch.Tensor] = None):
    """AABB-clipped uniform samples along each ray; with ``jitter`` [R] the
    whole ladder of a ray moves by ``perturb * jitter`` steps.

    rays [R, 8] = [o, d, near, far]. Returns (xyz [R,S,3], z_vals [R,S],
    in_box mask [R,S])."""
    rays_o, rays_d, t_min = _ray_tmin(state, rays)
    steps = torch.arange(n_samples, dtype=torch.float32,
                         device=rays.device)[None, :]
    if jitter is not None and perturb != 0:
        steps = steps + (perturb * jitter)[:, None]
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


def _density_at(params, mcfg, fused: Optional[FusedGrids], flat):
    """Density (after softplus) at [P,3] normalized coords: through the
    brick-atlas kernel, the cell-corner rows, or the VM factors."""
    if fused is not None and fused.brick_atlas is not None:
        return _softplus(sample_density_brick(fused, flat,
                                              mcfg.splus_density_shift))
    if fused is not None:
        return _softplus(sample_density_fused(fused, flat,
                                              mcfg.splus_density_shift))
    return tf.compute_density(params, mcfg, flat)


def _density_weights(params, mcfg, rcfg, state, rays, jitter=None,
                     stop_grad: bool = False,
                     fused: Optional[FusedGrids] = None):
    """Density at every sample, then alpha-compositing weights. With
    ``stop_grad`` no gradient flows back to the field. Returns (xyz_n,
    z_vals, in_box, dists, mids, alpha, weight, bg_weight)."""
    xyz, z_vals, in_box = sample_points_in_box(rays, state, rcfg.n_samples,
                                               rcfg.perturb, jitter)
    dists, mids = _intervals(z_vals)
    xyz_n = normalize_coordinates(state, xyz)
    with torch.set_grad_enabled(torch.is_grad_enabled() and not stop_grad):
        sigma = _density_at(params, mcfg, fused,
                            xyz_n.reshape(-1, 3)).reshape(xyz.shape[:2])
    sigma = torch.where(in_box, sigma, 0.0)
    alpha, weight, bg_weight = raw_to_alpha(sigma, dists * rcfg.distance_scale)
    return xyz_n, z_vals, in_box, dists, mids, alpha, weight, bg_weight


def occ_grouping_for(rcfg: RenderConfig, state: RenderState,
                     supervoxel: int = 4) -> RenderConfig:
    """Group sizes of the occupancy tests that one neighborhood row can serve:
    a group of G consecutive tests fits when its advance (G-1) * stride *
    step stays within 4 supervoxels of the smallest-unit axis. Host-side.
    Port of ``occ_grouping_for``."""
    if rcfg.coarse_stride is None:
        return rcfg
    min_unit = float(state.units.min())
    step = float(state.step_size)
    # the tolerance shrinks the admitted span: a group that overshoots the
    # neighborhood by a float sliver would read an empty pad bit
    margin = 4 * supervoxel * min_unit * (1 - 1e-6)
    adv1 = rcfg.coarse_stride * step
    g1 = min(8, int(margin / adv1) + 1) if adv1 > 0 else 0
    g2_ok = (rcfg.sub_stride is not None
             and (rcfg.coarse_stride - rcfg.sub_stride) * step <= margin)
    adv2 = (rcfg.sub_stride or 0) * step
    g2f = min(8, int(margin / adv2) + 1) if adv2 > 0 else 0
    return replace(rcfg, occ_group_l1=g1 if g1 >= 2 else 0, occ_group_l2=g2_ok,
                   l2_flat_group=g2f if g2f >= 2 else 0)


def _occ_alpha_test(mcfg, rcfg: RenderConfig, state: RenderState, raw_up):
    """occupied = per-sample alpha of the density upper bound > threshold."""
    sigma_up = _softplus(raw_up + mcfg.splus_density_shift)
    alpha_up = 1.0 - torch.exp(-sigma_up * state.step_size * rcfg.distance_scale)
    return alpha_up > rcfg.occ_alpha_thres


def _first_k_set(mask: torch.Tensor, k: int):
    """Per-row indices of the first ``k`` True entries, in order: mask [R, C]
    -> (idx [R, k] clamped to C-1, valid [R, k]). A cumsum and a count."""
    pos = torch.cumsum(mask.to(torch.int32), dim=1)                # [R, C]
    targets = torch.arange(1, k + 1, device=mask.device)
    # idx of the j-th set bit = number of candidates whose rank is below j
    idx = torch.sum(pos[:, :, None] < targets, dim=1)              # [R, k]
    valid = targets[None, :] <= pos[:, -1:]
    return torch.clamp(idx, max=mask.shape[1] - 1), valid


def _select_segments(mcfg, rcfg: RenderConfig, state: RenderState,
                     rays_o, rays_d, t_min, fused: FusedGrids):
    """Level 1: the midpoint of every ``coarse_stride`` segment is tested
    against the block-dilated occupancy (one bit-packed neighborhood row per
    ``occ_group_l1`` consecutive tests when the grids carry them), and the
    first ``max_segments`` occupied ones are kept. Port of
    ``_select_segments``. Returns (seg_idx [R, k_seg] nearest-first,
    seg_valid [R, k_seg])."""
    cs = rcfg.coarse_stride
    S_c = -(-rcfg.n_samples // cs)
    k_seg = min(rcfg.max_segments, S_c)
    R = rays_o.shape[0]
    group = rcfg.occ_group_l1 if fused.occ_bits_group is not None else 0
    S_cp = -(-S_c // group) * group if group >= 2 else S_c
    # pad midpoints lie further along the ray; their tests are sliced away
    steps_c = ((torch.arange(S_cp, dtype=torch.float32, device=rays_o.device)
                * cs + 0.5 * cs) * state.step_size)
    z_c = t_min[:, None] + steps_c[None, :]
    xyz_c = rays_o[:, None, :] + rays_d[:, None, :] * z_c[..., None]
    xyz_cn = normalize_coordinates(state, xyz_c)
    if group >= 2:
        occupied = sample_occ_bits_grouped(fused, xyz_cn, group)[:, :S_c]
    else:
        raw_up = sample_coarse_occ(fused, xyz_cn.reshape(-1, 3)).reshape(R, S_cp)
        occupied = _occ_alpha_test(mcfg, rcfg, state, raw_up)
    return _first_k_set(occupied, k_seg)


def _select_subsegments(mcfg, rcfg: RenderConfig, state: RenderState,
                        rays_o, rays_d, t_min, fused: FusedGrids,
                        seg_idx=None, seg_valid=None):
    """Level 2: sub-segment midpoints against the tight occupancy, the first
    ``max_subsegments`` occupied ones kept. With ``seg_idx=None`` (L2-only)
    every sub-segment of the ray is a candidate and ``l2_flat_group``
    consecutive tests share one neighborhood row; otherwise the candidates
    are the sub-segments of the selected segments, one row per segment with
    ``occ_group_l2``. Port of ``_select_subsegments``.

    Returns (fine_steps [R, k_sub, sub] in sample steps, sample_valid
    [R, k_sub, sub], needed [R] occupied candidates per ray)."""
    S = rcfg.n_samples
    sub = rcfg.sub_stride
    R = rays_o.shape[0]
    dev = rays_o.device
    if seg_idx is None:
        cand = -(-S // sub)
        g = rcfg.l2_flat_group if fused.occ_bits_group_tight is not None else 0
        candp = -(-cand // g) * g if g >= 2 else cand
        # pad candidates lie further along the ray (same spacing, so the
        # group span holds); their tests are sliced away
        sub_steps_p = (torch.arange(candp, dtype=torch.float32, device=dev)
                       * sub + 0.5 * sub)
        z_s = t_min[:, None] + sub_steps_p[None, :] * state.step_size
        xyz_s = rays_o[:, None, :] + rays_d[:, None, :] * z_s[..., None]
        xyz_sn = normalize_coordinates(state, xyz_s)
        if g >= 2:
            occ2 = sample_occ_bits_grouped(fused, xyz_sn, g, tight=True)[:, :cand]
        else:
            raw_up2 = sample_coarse_occ(fused, xyz_sn.reshape(-1, 3),
                                        tight=True).reshape(R, candp)[:, :cand]
            occ2 = _occ_alpha_test(mcfg, rcfg, state, raw_up2)
        occ2 = occ2 & (sub_steps_p[None, :cand] < S)
    else:
        cs = rcfg.coarse_stride
        n_sub = cs // sub
        cand = seg_idx.shape[1] * n_sub
        sub_j = torch.arange(n_sub, dtype=torch.float32, device=dev)
        sub_steps = (seg_idx[..., None].to(torch.float32) * cs
                     + sub_j * sub + 0.5 * sub).reshape(R, cand)
        z_s = t_min[:, None] + sub_steps * state.step_size
        xyz_s = rays_o[:, None, :] + rays_d[:, None, :] * z_s[..., None]
        xyz_sn = normalize_coordinates(state, xyz_s)
        if rcfg.occ_group_l2 and fused.occ_bits_group_tight is not None:
            # one row per segment serves its n_sub tests
            occ2 = sample_occ_bits_grouped(fused, xyz_sn, n_sub, tight=True)
        else:
            raw_up2 = sample_coarse_occ(fused, xyz_sn.reshape(-1, 3),
                                        tight=True).reshape(R, cand)
            occ2 = _occ_alpha_test(mcfg, rcfg, state, raw_up2)
        occ2 = (occ2 & torch.repeat_interleave(seg_valid, n_sub, dim=1)
                & (sub_steps < S))
    sub_idx, sub_valid = _first_k_set(occ2, min(rcfg.max_subsegments, cand))
    if seg_idx is None:
        # candidate j starts at sample step j * sub
        sub_start = sub_idx.to(torch.float32) * sub
    else:
        sub_start = torch.gather(sub_steps - 0.5 * sub, 1, sub_idx)
    offs = torch.arange(sub, dtype=torch.float32, device=dev)
    fine_steps = sub_start[..., None] + offs
    sample_valid = (fine_steps < S) & sub_valid[..., None]
    return fine_steps, sample_valid, torch.sum(occ2, dim=1)


def fine_positions(state: RenderState, rays_o, rays_d, t_min, fine_steps,
                   sample_valid):
    """(z_vals [R,K], in_box [R,K], xyz_n [R,K,3]) of the selected fine
    samples: the positions ``_fine_density`` passes to the density kernel."""
    R = rays_o.shape[0]
    z_vals = (t_min[:, None, None] + fine_steps * state.step_size).reshape(R, -1)
    xyz = rays_o[:, None, :] + rays_d[:, None, :] * z_vals[..., None]
    in_box = torch.all((xyz >= state.bbox_aabb[0]) & (xyz <= state.bbox_aabb[1]),
                       dim=-1) & sample_valid.reshape(R, -1)
    return z_vals, in_box, normalize_coordinates(state, xyz)


def _fine_density(mcfg, rcfg: RenderConfig, state: RenderState,
                  rays_o, rays_d, t_min, fused: FusedGrids,
                  fine_steps, sample_valid):
    """Exact density at the selected fine samples (through the brick-atlas
    kernel, or the cell-corner rows of training's grids), then compositing
    weights. Returns (xyz_n, z_vals, in_box, dists, mids, alpha, weight,
    bg_weight)."""
    R = rays_o.shape[0]
    z_vals, in_box, xyz_n = fine_positions(state, rays_o, rays_d, t_min,
                                           fine_steps, sample_valid)
    sigma = torch.where(in_box, _density_at(None, mcfg, fused,
                                            xyz_n.reshape(-1, 3)).reshape(R, -1),
                        0.0)
    # per-sample interval = step (uniform marching), as in the dense path
    dists = state.step_size.expand_as(z_vals)
    mids = z_vals + 0.5 * state.step_size
    alpha, weight, bg_weight = raw_to_alpha(sigma, dists * rcfg.distance_scale)
    return xyz_n, z_vals, in_box, dists, mids, alpha, weight, bg_weight


def _tail_weight(weight: torch.Tensor, group: int) -> torch.Tensor:
    """Max over rays of the compositing weight in the deepest kept group: the
    budget-truncation guardrail (0 on a well-calibrated scene)."""
    return torch.amax(torch.sum(weight[:, -group:], dim=-1))


def _two_level_density(mcfg, rcfg: RenderConfig, state: RenderState,
                       rays: torch.Tensor, fused: FusedGrids,
                       jitter: Optional[torch.Tensor] = None):
    """Density with empty-space skipping: the L1 segment selection
    (``_select_segments``) unless the selection is L2-only (``use_l1``
    False), the L2 sub-segment selection when ``sub_stride`` is finer, then
    the fine density in one pass, or in two with early termination
    (``term_first``): pass A on every ray's first ``term_first``
    sub-segments, pass B on the ``term_fraction`` rays with the largest
    residual transmittance among those with candidates left, spliced by
    T_B *= T_A. With ``jitter`` [R] (training) the whole sample ladder of a
    ray moves by ``perturb * jitter`` steps. Port of ``_two_level_density``
    (its heavy/light bucketing raises).

    Returns (xyz_n, z_vals, in_box, dists, mids, alpha, weight, bg_weight,
    budget_tail) with K = max_subsegments * sub_stride (or max_segments *
    coarse_stride) samples per ray."""
    R = rays.shape[0]
    cs = rcfg.coarse_stride
    rays_o, rays_d, t_min = _ray_tmin(state, rays)
    if jitter is not None and rcfg.perturb != 0:
        t_min = t_min + rcfg.perturb * jitter * state.step_size
    use_sub = (rcfg.sub_stride is not None and rcfg.sub_stride < cs
               and fused.coarse_occ_tight is not None)
    seg_idx = seg_valid = None
    if not (use_sub and not rcfg.use_l1):
        seg_idx, seg_valid = _select_segments(mcfg, rcfg, state, rays_o,
                                              rays_d, t_min, fused)
    if use_sub:
        fine_steps, sample_valid, _ = _select_subsegments(
            mcfg, rcfg, state, rays_o, rays_d, t_min, fused, seg_idx,
            seg_valid)
        group = rcfg.sub_stride
    else:
        # every fine sample of the selected segments
        offs = torch.arange(cs, dtype=torch.float32, device=rays.device)
        fine_steps = seg_idx[..., None].to(torch.float32) * cs + offs
        sample_valid = (fine_steps < rcfg.n_samples) & seg_valid[..., None]
        group = cs
    k_sub = fine_steps.shape[1]
    kA = rcfg.term_first
    if use_sub and 0 < kA < k_sub:
        n_s = max(1, min(R, int(round(R * rcfg.term_fraction))))
        out_a = _fine_density(mcfg, rcfg, state, rays_o, rays_d, t_min, fused,
                              fine_steps[:, :kA], sample_valid[:, :kA])
        T_res = out_a[7][:, 0]
        # survivors: the largest residuals among rays with occupied
        # candidates left (a ray that missed all geometry keeps T = 1 but
        # has nothing to add). Stable sorts, as jnp.argsort: many rays tie
        # at -1, and the survivor set must be the JAX package's
        has_tail = sample_valid[:, kA:].flatten(1).any(dim=1)
        T_live = torch.where(has_tail, T_res, -1.0)
        order = torch.argsort(T_live, stable=True)
        inv = torch.argsort(order, stable=True)
        surv = order[R - n_s:]
        out_b = list(_fine_density(mcfg, rcfg, state, rays_o[surv],
                                   rays_d[surv], t_min[surv], fused,
                                   fine_steps[surv, kA:],
                                   sample_valid[surv, kA:]))
        # transmittance is multiplicative across contiguous rank blocks
        t_surv = T_res[surv][:, None]
        out_b[6] = out_b[6] * t_surv
        out_b[7] = out_b[7] * t_surv

        def expand(b):
            # zero rows for the rays that stopped, back in input ray order
            pad = torch.zeros((R - n_s,) + b.shape[1:], dtype=b.dtype,
                              device=b.device)
            return torch.cat([pad, b])[inv]

        merged = [torch.cat([out_a[i], expand(out_b[i])], dim=1)
                  for i in range(7)]
        # a ray that stopped sends its residual to the background
        survived = torch.zeros(R, dtype=torch.bool, device=rays.device)
        survived[surv] = True
        merged.append(torch.where(survived[:, None], expand(out_b[7]),
                                  T_res[:, None]))
        # a stopped ray's missing weight is at most its residual
        tail = _tail_weight(out_b[6], group)
        if n_s < R:
            tail = torch.maximum(
                tail, torch.amax(torch.clamp(T_live[order[:R - n_s]], min=0.0)))
        return tuple(merged) + (tail,)
    hn = int(round(R * rcfg.heavy_fraction))
    if use_sub and 0 < rcfg.max_subsegments_light < k_sub and 0 < hn < R:
        raise NotImplementedError(
            "max_subsegments_light > 0 (heavy/light ray bucketing) is not "
            "ported; render with termination (term_first), as "
            "render_frames(termination=True) calibrates")
    out = _fine_density(mcfg, rcfg, state, rays_o, rays_d, t_min, fused,
                        fine_steps, sample_valid)
    return out + (_tail_weight(out[6], group),)


def _needed_budget(weight: torch.Tensor, group: int, eps: float) -> torch.Tensor:
    """Per ray, the deepest nearest-first rank of ``group`` samples whose
    weight exceeds ``eps``: [R, K*group] -> [R]."""
    w_rank = weight.reshape(weight.shape[0], -1, group).sum(-1)   # [R, K]
    ranks = torch.arange(1, w_rank.shape[1] + 1, device=weight.device)
    return torch.amax(torch.where(w_rank > eps, ranks, 0), dim=1)


def _needed_budget_bounded(weight: torch.Tensor, group: int,
                           tail_eps: float) -> torch.Tensor:
    """Per ray, the smallest rank prefix whose truncation leaves less than
    ``tail_eps`` of compositing weight behind: [R, K*group] -> [R]."""
    w_rank = weight.reshape(weight.shape[0], -1, group).sum(-1)   # [R, K]
    cum = torch.cumsum(w_rank, dim=1)
    return torch.sum(cum[:, -1:] - cum >= tail_eps, dim=1) + 1


def calibrate_budgets(mcfg, rcfg: RenderConfig, state: RenderState,
                      probe_rays, fused: FusedGrids,
                      quantile: float = 0.999, margin: int = 2,
                      round_to: int = 4, weight_eps: float = 1e-3,
                      termination: bool = False, tail_eps: float = 0.0,
                      head_term: bool = False,
                      head_tail_eps: float = 2e-3) -> RenderConfig:
    """Scene-adaptive budgets from the density of probe rays (no heads):
    ``max_subsegments`` at the ``quantile`` of the per-ray need (the
    deepest rank carrying weight above ``weight_eps``, or with ``tail_eps``
    the proven residual bound at the probe max), plus ``margin``, rounded;
    with ``termination`` the pass-A budget and survivor fraction of least
    expected cost; otherwise the heavy/light light budget; with
    ``head_term`` the two-phase head split, adopted only on a 15% expected
    saving. Port of ``calibrate_budgets`` (L2-only selection; its L1
    segment budget raises)."""
    check_ported(rcfg)
    if rcfg.coarse_stride is None or fused.coarse_occ is None:
        return rcfg
    if (rcfg.use_l1 or rcfg.sub_stride is None
            or rcfg.sub_stride >= rcfg.coarse_stride):
        raise NotImplementedError(
            "calibrate_budgets: the L1 segment budget (use_l1=True, or no "
            "finer sub_stride) is not ported; calibrate L2-only selection "
            "(render_frames(l2_only=True))")
    probe = torch.as_tensor(np.asarray(probe_rays, np.float32),
                            device=fused.brick_atlas.device)
    cs = rcfg.coarse_stride
    S_c = -(-rcfg.n_samples // cs)

    def need_of(w, group):
        if tail_eps > 0:
            return _needed_budget_bounded(w, group, tail_eps)
        return _needed_budget(w, group, weight_eps)

    def pick_q(needed, cap, q):
        need = int(np.quantile(needed, q)) + margin
        need = -(-need // round_to) * round_to
        return max(8, min(cap, need))

    def pick(needed, cap):
        # the bounded need is a per-ray proof: honor its max
        return pick_q(needed, cap, 1.0 if tail_eps > 0 else quantile)

    # L2-only: every segment is a candidate
    out = replace(rcfg, max_segments=S_c)
    sub = rcfg.sub_stride
    cand = out.max_segments * (cs // sub)
    full2 = replace(out, max_subsegments=cand, max_subsegments_light=0,
                    term_first=0)
    w2 = _two_level_density(mcfg, full2, state, probe, fused)[6]
    needed2 = need_of(w2, sub).cpu().numpy()
    out = replace(out, max_subsegments=pick(needed2, cand))
    if termination:
        # pass-A budget kA minimizing kA + P(need > kA) * margin * (k_sub -
        # kA); the survivor fraction gets 1.5x plus a floor for drift
        k_sub = out.max_subsegments
        best = None
        for q in (0.5, 0.625, 0.75, 0.875):
            kA = max(4, min(k_sub - round_to,
                            -(-int(np.quantile(needed2, q)) // round_to)
                            * round_to))
            frac = min(1.0, float((needed2 > kA).mean()) * 1.5 + 1 / 64)
            cost = kA + frac * (k_sub - kA)
            if best is None or cost < best[0]:
                best = (cost, kA, frac)
        if best is not None and best[1] < k_sub:
            out = replace(out, term_first=best[1], term_fraction=best[2],
                          max_subsegments_light=0)
    elif out.heavy_fraction > 0:
        light = pick_q(needed2, cand, 1.0 - out.heavy_fraction / 2)
        if light < out.max_subsegments:
            out = replace(out, max_subsegments_light=light)
    if head_term and out.head_topk is not None:
        # pass-A head budget minimizing kA + P(dropped mass > head_tail_eps)
        # * margin * (head_topk - kA), with the same drift margin
        k = min(out.head_topk, w2.shape[1])
        w_kp = torch.sort(w2, dim=1, descending=True).values[:, :k]
        w_kp = w_kp.cpu().numpy()
        # below-threshold samples add nothing to the head composite
        w_kp = np.where(w_kp > out.raymarch_weight_thres, w_kp, 0.0)
        tail_mass = np.cumsum(w_kp[:, ::-1], axis=1)[:, ::-1]
        best_h = None
        for kA in (4, 6, 8, 12, 16):
            if kA >= k:
                continue
            over = tail_mass[:, kA] > head_tail_eps
            frac = min(1.0, float(over.mean()) * 1.5 + 1 / 64)
            cost = kA + frac * (k - kA)
            if best_h is None or cost < best_h[0]:
                best_h = (cost, kA, frac)
        # a marginal split still pays for a second pass: require 15%
        if best_h is not None and best_h[0] < 0.85 * k:
            out = replace(out, head_term_first=best_h[1],
                          head_term_fraction=best_h[2])
    return out


def _branch_feats(fused: Optional[FusedGrids], name: str, flat):
    """Dense-grid features of a VM branch, or None: the head then samples
    the VM factors directly (or reads xyz, for an MLP head)."""
    if fused is not None and name in fused.features:
        return sample_feature_fused(fused, name, flat)
    return None


def _semantic_map_postprocess(rcfg, semantic_map):
    if rcfg.semantic_weight_mode == "softmax":
        semantic_map = semantic_map / (torch.sum(semantic_map, -1, keepdim=True) + 1e-8)
        semantic_map = torch.log(semantic_map + 1e-8)
    return semantic_map


def _tail_ratio(m_full, m_kept):
    """Per-ray completion ratio full/kept, 1.0 on empty rays ([R] -> [R]):
    above 1 only by the above-threshold mass the head compaction dropped."""
    return torch.where(m_kept > 1e-12,
                       m_full / torch.clamp(m_kept, min=1e-12), 1.0)


def _head_select(weight: torch.Tensor, k: int):
    """The k heaviest samples per ray, sorted: (w_k [R,k], idx [R,k],
    head_tail = max k-th kept weight). The "sort" mode of ``_head_select``:
    a stable descending sort keeps ties lowest index first, as
    ``lax.top_k`` does (many rays tie at zero weight)."""
    w_sorted, idx = torch.sort(weight, dim=1, descending=True, stable=True)
    w_k = w_sorted[:, :k]
    return w_k, idx[:, :k], torch.amax(w_k[:, -1])


def _head_weights(rcfg, weight):
    """The per-sample compositing weights used for semantic/instance heads
    (no gradient to the density with ``stop_semantic_grad``)."""
    w = weight[..., None]
    if rcfg.semantic_weight_mode == "argmax":
        hot = torch.nn.functional.one_hot(torch.argmax(weight, dim=1),
                                          weight.shape[1]).to(weight.dtype)
        w = hot[..., None]
    return w.detach() if rcfg.stop_semantic_grad else w


def _app_block(params, mcfg, fused, xyz_s, view_r, mask_s, compute_dtype):
    """rgb [Rn, Ks, 3] at samples xyz_s [Rn, Ks, 3] of rays with view
    directions view_r [Rn, 3], zero where ``mask_s`` is False."""
    Rn, Ks = xyz_s.shape[:2]
    flat = xyz_s.reshape(-1, 3)
    vd = view_r[:, None, :].expand(Rn, Ks, 3).reshape(-1, 3)
    rgb = tf.render_appearance(params, mcfg, vd, flat, compute_dtype,
                               feats=_branch_feats(fused, "appearance", flat))
    return torch.where(mask_s.reshape(-1, 1), rgb, 0.0).reshape(Rn, Ks, 3)


def _semins_block(params, mcfg, fused, xyz_s, mask_s, compute_dtype):
    """(semantics, instances) [Rn, Ks, C] at samples xyz_s, zero where
    ``mask_s`` is False."""
    Rn, Ks = xyz_s.shape[:2]
    flat = xyz_s.reshape(-1, 3)
    mf = mask_s.reshape(-1, 1)
    sem = tf.render_semantics(params, mcfg, flat, None, compute_dtype,
                              feats=_branch_feats(fused, "semantic", flat))
    ins = tf.render_instances(params, mcfg, flat, None, compute_dtype,
                              feats=_branch_feats(fused, "instance", flat))
    return (torch.where(mf, sem, 0.0).reshape(Rn, Ks, -1),
            torch.where(mf, ins, 0.0).reshape(Rn, Ks, -1))


def _heads_one_pass(params, mcfg, rcfg, fused, rays, xyz_h, head_weight,
                    app_mask, k2, compute_dtype, m_full):
    """Heads on every column of xyz_h [R, Sh, 3] (the sem/ins heads on the
    first k2), composited with ``head_weight``; with ``m_full`` the rgb and
    instance maps are completed by the dropped above-threshold mass."""
    rgb = _app_block(params, mcfg, fused, xyz_h, rays[:, 3:6], app_mask,
                     compute_dtype)
    semantics, instances = _semins_block(params, mcfg, fused, xyz_h[:, :k2],
                                         app_mask[:, :k2], compute_dtype)
    rgb_map = composite(head_weight, rgb)
    w = _head_weights(rcfg, head_weight)
    semantic_map = torch.sum(w[:, :k2] * semantics, dim=-2)
    instance_map = torch.sum(w[:, :k2] * instances, dim=-2)
    if m_full is not None:
        mask_f = app_mask.to(head_weight.dtype)
        rgb_map = rgb_map * _tail_ratio(
            m_full, torch.sum(head_weight * mask_f, -1))[:, None]
        if rcfg.semantic_weight_mode != "argmax":
            instance_map = instance_map * _tail_ratio(
                m_full, torch.sum(head_weight[:, :k2] * mask_f[:, :k2], -1)
            )[:, None]
    return rgb_map, semantic_map, instance_map


def _heads_two_phase(params, mcfg, rcfg: RenderConfig, fused, rays, xyz_k,
                     w_k, app_mask, k2: int, compute_dtype, head_tail,
                     m_full=None):
    """Two-phase heads (``head_term_first``): pass A on every ray's kA
    heaviest samples; pass B on the remaining samples of the
    ``head_term_fraction`` rays with the most above-threshold mass left,
    added back per ray (the maps are weighted sums). ``head_tail`` grows to
    the largest mass a non-survivor drops. Port of ``_heads_two_phase``."""
    R, k = w_k.shape
    kA = rcfg.head_term_first
    k2A = min(kA, k2)
    n_s = max(1, min(R, int(round(R * rcfg.head_term_fraction))))
    # only above-threshold mass counts: the heads zero the rest
    drop_key = torch.sum(w_k[:, kA:] * app_mask[:, kA:].to(w_k.dtype), dim=1)
    order = torch.argsort(drop_key, stable=True)
    surv = order[R - n_s:]
    if n_s < R:
        head_tail = torch.maximum(head_tail,
                                  torch.amax(drop_key[order[:R - n_s]]))
    w_h = _head_weights(rcfg, w_k)                      # [R, k, 1]
    viewdirs = rays[:, 3:6]

    rgbA = _app_block(params, mcfg, fused, xyz_k[:, :kA], viewdirs,
                      app_mask[:, :kA], compute_dtype)
    semA, insA = _semins_block(params, mcfg, fused, xyz_k[:, :k2A],
                               app_mask[:, :k2A], compute_dtype)
    rgb_map = torch.sum(w_k[:, :kA, None] * rgbA, dim=-2)
    semantic_map = torch.sum(w_h[:, :k2A] * semA, dim=-2)
    instance_map = torch.sum(w_h[:, :k2A] * insA, dim=-2)

    xyzB = xyz_k[surv, kA:]
    maskB = app_mask[surv, kA:]
    rgbB = _app_block(params, mcfg, fused, xyzB, viewdirs[surv], maskB,
                      compute_dtype)
    w_kB = w_k[surv, kA:]
    w_hB = w_h[surv, kA:]
    rgb_map = rgb_map.index_add(0, surv, torch.sum(w_kB[..., None] * rgbB,
                                                   dim=-2))
    nB2 = k2 - k2A
    if nB2 > 0:
        semB, insB = _semins_block(params, mcfg, fused, xyzB[:, :nB2],
                                   maskB[:, :nB2], compute_dtype)
        semantic_map = semantic_map.index_add(
            0, surv, torch.sum(w_hB[:, :nB2] * semB, dim=-2))
        instance_map = instance_map.index_add(
            0, surv, torch.sum(w_hB[:, :nB2] * insB, dim=-2))
    if m_full is not None:
        # kept masses accumulate in the same pass-A + splice pattern
        mask_f = app_mask.to(w_k.dtype)
        maskB_f = maskB.to(w_k.dtype)
        m_rgb = torch.sum(w_k[:, :kA] * mask_f[:, :kA], -1).index_add(
            0, surv, torch.sum(w_kB * maskB_f, -1))
        rgb_map = rgb_map * _tail_ratio(m_full, m_rgb)[:, None]
        if rcfg.semantic_weight_mode != "argmax":
            m_ins = torch.sum(w_k[:, :k2A] * mask_f[:, :k2A], -1)
            if nB2 > 0:
                m_ins = m_ins.index_add(
                    0, surv, torch.sum(w_kB[:, :nB2] * maskB_f[:, :nB2], -1))
            instance_map = instance_map * _tail_ratio(m_full, m_ins)[:, None]
    return rgb_map, semantic_map, instance_map, head_tail


def render_rays(params, mcfg: tf.TensoRFConfig, rcfg: RenderConfig,
                state: RenderState, rays: torch.Tensor,
                rng=None, is_train: bool = False,
                fused: Optional[FusedGrids] = None):
    """Render pass: rgb / semantics / instances / depth / dist-reg, and the
    guardrails ``budget_tail`` and ``head_tail`` (``dedup_tail`` is 0: head
    dedup is not ported).

    ``fused``: the grids of ``ops/fused_grid.py::build_render_grids`` (the
    density of every sample through the brick-atlas kernel, head features
    from the dense grids), of ``build_density_only`` (training: density from
    the cell-corner rows, heads sampling the VM factors), or None (the VM
    factors sampled directly). With occupancy tables and ``coarse_stride``
    the samples are selected by empty-space skipping, except in training;
    with ``head_topk`` the heads run on the k heaviest samples per ray.

    ``is_train`` with ``rng`` (a ``torch.Generator`` or ``RayDraws``)
    jitters the samples and flips the background coin; training takes no
    two-phase heads and no tail completion, as in the JAX package."""
    if mcfg.use_distilled:
        raise NotImplementedError("render_rays: distilled-feature heads "
                                  "(use_distilled_features_*) are not ported")
    check_ported(rcfg)
    draws = ray_draws(rng, rays.shape[0], rays.device) if is_train else None
    jitter = draws.jitter if draws is not None else None
    two_level = (rcfg.coarse_stride is not None and fused is not None
                 and fused.coarse_occ is not None and not is_train)
    if two_level:
        (xyz_n, z_vals, _, dists, mids, _, weight, _,
         budget_tail) = _two_level_density(mcfg, rcfg, state, rays, fused)
    else:
        xyz_n, z_vals, _, dists, mids, _, weight, _ = _density_weights(
            params, mcfg, rcfg, state, rays, jitter, fused=fused)
        budget_tail = torch.zeros((), device=weight.device)
    R, S = weight.shape
    dist_reg = distortion_loss(weight, mids, dists)
    compute_dtype = (torch.bfloat16 if rcfg.head_dtype == "bfloat16"
                     else torch.float32)

    head_tail = torch.zeros((), device=weight.device)
    topk = rcfg.head_topk is not None and rcfg.head_topk < S
    if topk:
        w_k, idx, head_tail = _head_select(weight, rcfg.head_topk)
        xyz_h = torch.gather(xyz_n, 1, idx[..., None].expand(*idx.shape, 3))
        head_weight = w_k
        Sh = rcfg.head_topk
        # the sem/ins heads take a prefix of the sorted k: the top k2
        k2 = (Sh if rcfg.head_topk_semins is None
              else min(rcfg.head_topk_semins, Sh))
    else:
        xyz_h, head_weight, Sh, k2 = xyz_n, weight, S, S
    app_mask = head_weight > rcfg.raymarch_weight_thres         # [R, Sh]
    m_full = None
    if rcfg.head_tail_complete and topk and not is_train:
        m_full = torch.sum(weight * (weight > rcfg.raymarch_weight_thres), -1)
    if topk and 0 < rcfg.head_term_first < Sh and not is_train:
        rgb_map, semantic_map, instance_map, head_tail = _heads_two_phase(
            params, mcfg, rcfg, fused, rays, xyz_h, head_weight, app_mask, k2,
            compute_dtype, head_tail, m_full)
    else:
        rgb_map, semantic_map, instance_map = _heads_one_pass(
            params, mcfg, rcfg, fused, rays, xyz_h, head_weight, app_mask, k2,
            compute_dtype, m_full)
    coin = draws.coin if draws is not None else None
    out = _finish_maps(rcfg, coin, weight, z_vals, torch.sum(weight, -1),
                       rgb_map, _semantic_map_postprocess(rcfg, semantic_map),
                       instance_map, dist_reg)
    out.update(budget_tail=budget_tail, head_tail=head_tail,
               dedup_tail=torch.zeros((), device=weight.device))
    return out


def _finish_maps(rcfg, coin, weight, z_vals, opacity, rgb_map, semantic_map,
                 instance_map, dist_reg):
    """Map finishing: white-background compositing (in training also where
    the coin, a U[0,1) draw, falls below 0.5), depth."""
    white = rcfg.white_bg
    if coin is not None:
        white = white | (coin < 0.5)
    if isinstance(white, torch.Tensor):
        rgb_map = torch.where(white, rgb_map + (1.0 - opacity[..., None]),
                              rgb_map)
    elif white:
        rgb_map = rgb_map + (1.0 - opacity[..., None])
    rgb_map = torch.clamp(rgb_map, 0.0, 1.0)
    depth_map = torch.sum(weight * z_vals, -1)
    return {"rgb": rgb_map, "semantics": semantic_map,
            "instances": instance_map, "depth": depth_map,
            "dist_reg": dist_reg, "opacity": opacity}


# ---------------------------------------------------------------------------
# The stop-gradient passes of training (instance and segment losses)
# ---------------------------------------------------------------------------

def _aux_topk(rcfg: RenderConfig, weight, xyz_n, z_vals, live=None):
    """The k heaviest samples per ray (``head_topk``) for the stop-gradient
    passes: exact while at most k samples of a ray clear
    ``raymarch_weight_thres``, since only those reach the heads. Returns
    (w_k, xyz_k, z_k, tail), ``tail`` the fraction of live rays with more
    than k samples above the threshold (0: this batch was exact). Port of
    ``_aux_topk`` (its "sort" mode)."""
    R, S = weight.shape
    if rcfg.head_topk is None or rcfg.head_topk >= S:
        return weight, xyz_n, z_vals, torch.zeros((), device=weight.device)
    k = rcfg.head_topk
    over = torch.sum(weight > rcfg.raymarch_weight_thres, dim=-1) > k
    if live is not None:
        # zero-padded stream rays must not trip the guardrail
        over = over & live
    tail = torch.mean(over.to(torch.float32))
    w_k, idx, _ = _head_select(weight, k)
    xyz_k = torch.gather(xyz_n, 1, idx[..., None].expand(*idx.shape, 3))
    return w_k, xyz_k, torch.gather(z_vals, 1, idx), tail


def aux_density_weights(params, mcfg: tf.TensoRFConfig, rcfg: RenderConfig,
                        state: RenderState, rays, rng, is_train: bool,
                        fused: Optional[FusedGrids]):
    """Stop-gradient density and weights for the aux passes, with
    train-time empty-space skipping when the grids carry occupancy and
    ``coarse_stride`` is set. Returns (xyz_n, z_vals, weight, budget_tail),
    ``budget_tail`` the largest compositing weight in the deepest kept group
    over live rays (0 without skipping). Port of ``aux_density_weights``."""
    draws = ray_draws(rng, rays.shape[0], rays.device) if is_train else None
    jitter = draws.jitter if draws is not None else None
    with torch.no_grad():
        if (fused is not None and fused.coarse_occ is not None
                and rcfg.coarse_stride is not None):
            out = _two_level_density(mcfg, rcfg, state, rays, fused, jitter)
            xyz_n, z_vals, weight = out[0], out[1], out[6]
            # zero-padded stream rays degenerate to one in-box point and
            # would trip the guardrail: mask them out
            live = torch.any(rays[:, 3:6] != 0, dim=-1)
            group = rcfg.sub_stride or rcfg.coarse_stride
            budget_tail = torch.amax(torch.where(
                live, torch.sum(weight[:, -group:], dim=-1), 0.0))
        else:
            xyz_n, z_vals, _, _, _, _, weight, _ = _density_weights(
                params, mcfg, rcfg, state, rays, jitter, stop_grad=True,
                fused=fused)
            budget_tail = torch.zeros((), device=weight.device)
    return xyz_n, z_vals, weight, budget_tail


def _aux_heads(params, mcfg, rcfg, state, rays, rng, is_train, fused):
    """Shared front of the aux passes: (weight_k, flat xyz_k, app_mask,
    compute dtype, distance map, tail, budget_tail)."""
    if mcfg.use_distilled:
        raise NotImplementedError("distilled-feature heads "
                                  "(use_distilled_features_*) are not ported")
    check_ported(rcfg)
    xyz_n, z_vals, weight, budget_tail = aux_density_weights(
        params, mcfg, rcfg, state, rays, rng, is_train, fused)
    distance_map = torch.sum(weight * z_vals, -1)
    live = torch.any(rays[:, 3:6] != 0, dim=-1)
    weight, xyz_n, z_vals, tail = _aux_topk(rcfg, weight, xyz_n, z_vals, live)
    app_mask = (weight > rcfg.raymarch_weight_thres).reshape(-1, 1)
    # the heads honor head_dtype; compositing promotes back to float32
    compute_dtype = (torch.bfloat16 if rcfg.head_dtype == "bfloat16"
                     else torch.float32)
    return (weight, xyz_n.reshape(-1, 3), app_mask, compute_dtype,
            distance_map, tail, budget_tail)


def render_instance_features(params, mcfg: tf.TensoRFConfig,
                             rcfg: RenderConfig, state: RenderState,
                             rays: torch.Tensor, rng=None,
                             is_train: bool = True,
                             fused: Optional[FusedGrids] = None,
                             return_tail: bool = False):
    """Instance-embedding pass on stop-gradient weights. Returns
    (instance_map [R, D], surface points [R, 3]); with ``return_tail`` also
    the ``_aux_topk`` and skipping guardrails. Port of
    ``render_instance_features``."""
    (weight, flat, app_mask, compute_dtype, distance_map, tail,
     budget_tail) = _aux_heads(params, mcfg, rcfg, state, rays, rng,
                               is_train, fused)
    R, S = weight.shape
    instances = tf.render_instances(params, mcfg, flat, None, compute_dtype)
    instances = torch.where(app_mask, instances, 0.0).reshape(R, S, -1)
    instance_map = composite(weight, instances)
    points_xyz = (rays[:, 0:3] + distance_map[:, None] * rays[:, 3:6]).detach()
    if return_tail:
        return instance_map, points_xyz, tail, budget_tail
    return instance_map, points_xyz


def render_segment_features(params, mcfg: tf.TensoRFConfig,
                            rcfg: RenderConfig, state: RenderState,
                            rays: torch.Tensor, rng=None,
                            is_train: bool = True,
                            fused: Optional[FusedGrids] = None,
                            return_tail: bool = False):
    """Semantic-logit pass on stop-gradient weights, for the segment-grouping
    loss. Port of ``render_segment_features``."""
    (weight, flat, app_mask, compute_dtype, _, tail,
     budget_tail) = _aux_heads(params, mcfg, rcfg, state, rays, rng,
                               is_train, fused)
    R, S = weight.shape
    segments = tf.render_semantics(params, mcfg, flat, None, compute_dtype)
    segments = torch.where(app_mask, segments, 0.0).reshape(R, S, -1)
    segment_map = _semantic_map_postprocess(rcfg, composite(weight, segments))
    if return_tail:
        return segment_map, tail, budget_tail
    return segment_map
