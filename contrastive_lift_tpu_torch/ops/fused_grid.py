"""Dense grids built from the VM factors, occupancy tables, and their samplers.

Port of the parts of ``contrastive_lift_tpu/ops/fused_grid.py`` that the
render and the training step read. Trilinear interpolation is multilinear, so each factorized
field plane(x,y) * line(z) equals the trilinear interpolation of one dense
voxel grid built from the factors; the density becomes a brick atlas sampled
by the ``brick_interp`` kernel, the projected appearance (and any other VM
branch) a dense [g^3, F] grid sampled with 8 row reads.

Empty-space skipping (``build_render_grids(compact=True)``) adds per
supervoxel block: the raw density maxima (dilated by one block, and with the
tight node margin), both thresholded and bit-packed into 5^3-neighborhood
rows, and the slot map of the blocks whose features the heads may read. Every
table that only moves or maxes data equals the JAX package's.

Training (``build_density_only``) builds the density as one 8-corner row per
cell (``_cell_corner_grid``) and samples it with one row gather
(``sample_density_fused``); both are differentiable back to the VM factors
through ``build_dense_density``, so the main phase's gradient reaches the
planes and lines.

Not ported on purpose: the corner-redundant feature tables
(``_cell_corner_feature``, ``build_compact_tables``) are a TPU gather layout,
one 8-corner row per cell. At the r5b grid the full table would hold
2,028,000 rows of 256 values and the compacted one 2,408,512 rows (1.23 GB in
bf16). The 8 reads of the dense grid give the same corner values, and the slot
map keeps the compact table's semantics: a sample in a block without a slot
reads zero features.
"""
from __future__ import annotations

from typing import Dict, NamedTuple, Optional, Tuple

import numpy as np
import torch
import torch.nn.functional as F

from . import brick_interp as bi

SUPERVOXEL = 4


class FusedGrids(NamedTuple):
    """Dense grids for one set of parameters (built once per render, or per
    training step)."""
    grid_dim: Tuple[int, int, int]
    brick_atlas: Optional[torch.Tensor]  # [Bx*By*Bz, 128] f32 or bf16
    features: Dict[str, torch.Tensor]   # branch -> [gx*gy*gz, out_dim]
    # empty-space skipping, per supervoxel block b (flat over coarse_dim):
    # raw density max dilated by one block, and with the tight node margin
    coarse_occ: Optional[torch.Tensor] = None        # [C] f32
    coarse_dim: Optional[Tuple[int, int, int]] = None
    supervoxel: int = SUPERVOXEL
    coarse_occ_tight: Optional[torch.Tensor] = None  # [C] f32
    # the occupancy tests baked at the raw threshold: row b packs the bits
    # of blocks [b, b+4]^3 at bit dx*25+dy*5+dz into 4 words of 32 bits
    occ_bits_group: Optional[torch.Tensor] = None        # [C, 4] int64
    occ_bits_group_tight: Optional[torch.Tensor] = None  # [C, 4] int64
    # 1-based slot of each block whose features the heads read, 0 = none
    slot_map: Optional[torch.Tensor] = None              # [C] int64
    # the 8 corners of each cell in one row (training's density)
    density_cells: Optional[torch.Tensor] = None  # [(gx-1)(gy-1)(gz-1), 8]


def build_dense_density(params: dict) -> torch.Tensor:
    """[gx, gy, gz] pre-activation density grid (without the softplus shift)."""
    planes = params["density"]["planes"]
    lines = params["density"]["lines"]
    d = torch.einsum("cyx,cz->xyz", planes[0], lines[0])
    d = d + torch.einsum("czx,cy->xyz", planes[1], lines[1])
    d = d + torch.einsum("czy,cx->xyz", planes[2], lines[2])
    return d


def _cell_corner_grid(dense: torch.Tensor) -> torch.Tensor:
    """[gx,gy,gz] -> [(gx-1)(gy-1)(gz-1), 8]: the 8 corners of each cell
    (dx, dy, dz with dz fastest) in one row, so a trilinear sample is one
    row read."""
    gx, gy, gz = dense.shape
    corners = [dense[dx:gx - 1 + dx, dy:gy - 1 + dy, dz:gz - 1 + dz]
               for dx in (0, 1) for dy in (0, 1) for dz in (0, 1)]
    return torch.stack(corners, dim=-1).reshape(-1, 8)


def build_density_only(params: dict, with_atlas: bool = False,
                       with_occupancy: bool = False) -> FusedGrids:
    """Density-only grids for the training passes: the cell-corner rows
    (differentiable to the factors), with ``with_occupancy`` the
    block-dilated coarse occupancy for train-time empty-space skipping, and
    with ``with_atlas`` the brick atlas. Port of ``build_density_only``."""
    dense = build_dense_density(params)
    coarse_occ, coarse_dim = None, None
    if with_occupancy:
        dilated = _build_coarse_occ(dense, SUPERVOXEL)
        coarse_occ, coarse_dim = dilated.reshape(-1), tuple(dilated.shape)
    return FusedGrids(tuple(dense.shape),
                      build_brick_atlas(dense) if with_atlas else None, {},
                      coarse_occ=coarse_occ, coarse_dim=coarse_dim,
                      density_cells=_cell_corner_grid(dense))


def build_dense_feature(params: dict, name: str,
                        dtype: torch.dtype = torch.float32) -> torch.Tensor:
    """[gx*gy*gz, out_dim] dense projected feature grid for a VM branch,
    computed in float32 and rounded to ``dtype``.

    dense[v] = concat_axis(plane (.) line)[v] @ basis, with the basis matmul
    folded in per axis (block rows of the basis matrix)."""
    planes = params[name]["planes"]
    lines = params[name]["lines"]
    basis = params[f"{name}_basis"]["w"]
    offs = 0
    total = None
    einsums = ("cyx,cz->xyzc", "czx,cy->xyzc", "czy,cx->xyzc")
    for i in range(3):
        c = planes[i].shape[0]
        prod = torch.einsum(einsums[i], planes[i], lines[i])
        contrib = torch.einsum("xyzc,cf->xyzf", prod, basis[offs:offs + c])
        total = contrib if total is None else total + contrib
        offs += c
    gx, gy, gz, f = total.shape
    return total.reshape(gx * gy * gz, f).to(dtype)


def build_brick_atlas(dense: torch.Tensor,
                      dtype: torch.dtype = torch.float32) -> torch.Tensor:
    """[gx,gy,gz] pre-activation density -> [Bx*By*Bz, 128] brick rows of
    ``dtype`` (float32 or bfloat16; rounded from the float32 grid).

    Brick (i,j,k) covers voxels [4i,4i+4]x[4j,..]x[4k,..]; its row holds the
    5^3 corner lattice at lane a*25+b*5+c (edge-clamped at grid boundaries),
    zero-padded to 128 lanes. Port of ``_build_brick_atlas(dense, dtype)``."""
    if dtype not in bi.ROW_DTYPES:
        raise TypeError(f"brick atlas dtype must be float32 or bfloat16, "
                        f"got {dtype}")
    bx, by, bz = bi.brick_atlas_dims(dense.shape)
    idx = [torch.clamp(torch.arange(4 * b + 1, device=dense.device), max=g - 1)
           for b, g in zip((bx, by, bz), dense.shape)]
    padded = dense[idx[0]][:, idx[1]][:, :, idx[2]]
    corners = [padded[a:a + 4 * bx - 3:4, b:b + 4 * by - 3:4, c:c + 4 * bz - 3:4]
               for a in range(5) for b in range(5) for c in range(5)]
    atlas = torch.stack(corners, dim=-1).reshape(bx * by * bz, 125)
    return torch.nn.functional.pad(atlas, (0, bi.LANES - 125)).to(dtype)


def _window_max(vol: torch.Tensor, window: int, stride: int,
                pads) -> torch.Tensor:
    """Max over ``window``^3 windows at ``stride`` of ``vol`` [X,Y,Z] padded
    per axis by ``pads`` ((before, after) node counts) with -inf: the
    ``reduce_window(max, padding="VALID")`` of the JAX package."""
    flat_pads = [n for lo_hi in reversed(pads) for n in lo_hi]
    padded = F.pad(vol, flat_pads, value=-float("inf"))
    return F.max_pool3d(padded[None, None], window, stride)[0, 0]


def _build_coarse_occ(dense: torch.Tensor, sv: int) -> torch.Tensor:
    """Max raw density per supervoxel block, dilated by one block: every
    trilinear value inside a block's neighborhood is at most this.
    Port of ``_build_coarse_occ``; returns the [cx,cy,cz] dilated grid."""
    coarse = _window_max(dense, sv, sv, [(0, (-s) % sv) for s in dense.shape])
    # max_pool3d pads with -inf itself
    return F.max_pool3d(coarse[None, None], 3, 1, padding=1)[0, 0]


def _block_node_max(dense: torch.Tensor, sv: int) -> torch.Tensor:
    """Per-block max over the (sv+1)^3 node lattice the block's cells
    interpolate from (window sv+1, stride sv): the undilated bound the slot
    map is built from. Port of ``_block_node_max``."""
    cdims = [-(-s // sv) for s in dense.shape]
    return _window_max(dense, sv + 1, sv,
                       [(0, sv * c + 1 - s) for c, s in zip(cdims, dense.shape)])


def tight_occ_pads(sub_stride: int, step_size: float, min_unit: float,
                   supervoxel: int = SUPERVOXEL) -> Tuple[int, int]:
    """Node margins the tight-occupancy window needs around a block so that
    every fine sample of a sub-segment whose midpoint falls in the block keeps
    its interpolation corners inside the window. Port of ``tight_occ_pads``."""
    sr = step_size / max(min_unit, 1e-12)
    left = int(np.ceil(sub_stride / 2 * sr + 1 - 1e-6))
    right = int(np.ceil((sub_stride / 2 - 1) * sr + 1 - 1e-6))
    return max(2, left), max(2, right)


def _build_tight_occ(dense: torch.Tensor, sv: int,
                     pads: Tuple[int, int] = (3, 3)) -> torch.Tensor:
    """Max raw density per block over nodes [sv*b - pads[0], sv*b + sv +
    pads[1]] (window sv + pads[0] + pads[1], stride sv): the occupancy the
    sub-segment tests read. Port of ``_build_tight_occ``; [cx,cy,cz]."""
    lo, hi = pads
    win = sv + lo + hi
    cdims = [-(-g // sv) for g in dense.shape]
    return _window_max(dense, win, sv,
                       [(lo, sv * (c - 1) + win - lo - g)
                        for c, g in zip(cdims, dense.shape)])


def _pack_neighborhood_bits(bits3d: torch.Tensor) -> torch.Tensor:
    """[cx,cy,cz] occupancy bools -> [cx*cy*cz, 4] words: row b packs the
    occupancy of blocks [b, b+4]^3 at bit dx*25+dy*5+dz of word bit//32
    (out-of-grid neighbors are empty). Port of ``_pack_neighborhood_bits``
    (which pads each row to 8 words; the 4 pad words are zero)."""
    cx, cy, cz = bits3d.shape
    padded = F.pad(bits3d.to(torch.int64), (0, 4, 0, 4, 0, 4))
    bits = torch.stack([padded[dx:dx + cx, dy:dy + cy, dz:dz + cz]
                        for dx in range(5) for dy in range(5) for dz in range(5)],
                       dim=-1).reshape(cx * cy * cz, 125)
    bits = F.pad(bits, (0, 3)).reshape(-1, 4, 32)
    shifts = torch.arange(32, device=bits.device)
    return torch.sum(bits << shifts, dim=-1)


def raw_occupancy_threshold(splus_shift: float, step_size: float,
                            distance_scale: float,
                            occ_alpha_thres: float) -> float:
    """Pre-activation density whose per-sample alpha equals
    ``occ_alpha_thres`` (alpha = 1-exp(-softplus(raw+shift)*step*ds)).
    Port of ``raw_occupancy_threshold`` (host-side)."""
    v = -np.log1p(-occ_alpha_thres) / (float(step_size) * distance_scale)
    raw = float(np.log(np.expm1(v))) if v < 30 else v
    return raw - splus_shift


def build_render_grids(params: dict, mcfg, rcfg, state_r, compact: bool = True,
                       feature_dtype: str = "bfloat16", dense_override=None,
                       atlas_dtype: str = "float32") -> FusedGrids:
    """What the render reads: the density brick atlas of ``atlas_dtype``
    ("float32" or "bfloat16"), a dense projected grid of ``feature_dtype``
    for every VM feature branch of ``params`` (appearance; the semantic /
    instance branches of grid-head models) and, with ``compact``, the
    empty-space-skipping tables. Port of ``build_render_grids``.

    ``dense_override`` replaces the VM density grid with any [gx,gy,gz]
    pre-activation grid (analytic fields). With ``compact`` the occupancy
    bits are taken at ``raw_occupancy_threshold`` of ``occ_alpha_thres``,
    with the tight window of ``tight_occ_pads`` for the state's step, and the
    slot map marks the blocks whose node max clears the threshold of
    ``raymarch_weight_thres`` (the JAX package's compact feature mask)."""
    dense = (build_dense_density(params) if dense_override is None
             else dense_override)
    fdtype = getattr(torch, feature_dtype)
    features = {name: build_dense_feature(params, name, fdtype)
                for name in ("appearance", "semantic", "instance")
                if name in params}
    fused = FusedGrids(tuple(dense.shape),
                       build_brick_atlas(dense, getattr(torch, atlas_dtype)),
                       features)
    if not compact:
        return fused
    step = float(state_r.step_size)
    pads = (3, 3)
    if rcfg.sub_stride:
        pads = tight_occ_pads(rcfg.sub_stride, step, float(state_r.units.min()))

    def above(vals, weight_thres):
        thres = raw_occupancy_threshold(mcfg.splus_density_shift, step,
                                        rcfg.distance_scale, weight_thres)
        return vals > thres

    sv = SUPERVOXEL
    dilated = _build_coarse_occ(dense, sv)
    tight = _build_tight_occ(dense, sv, pads)
    keep = above(_block_node_max(dense, sv).reshape(-1),
                 rcfg.raymarch_weight_thres)
    return fused._replace(
        coarse_occ=dilated.reshape(-1), coarse_dim=tuple(dilated.shape),
        supervoxel=sv, coarse_occ_tight=tight.reshape(-1),
        occ_bits_group=_pack_neighborhood_bits(above(dilated,
                                                     rcfg.occ_alpha_thres)),
        occ_bits_group_tight=_pack_neighborhood_bits(
            above(tight, rcfg.occ_alpha_thres)),
        slot_map=torch.cumsum(keep.to(torch.int64), 0) * keep)


def sample_density_brick(fused: FusedGrids, xyz: torch.Tensor,
                         splus_shift: float) -> torch.Tensor:
    """Pre-activation density + shift at [P,3] coords in [-1,1]: one atlas
    row per sample, interpolated by the ``brick_interp`` kernel."""
    return bi.sample_density_brick(fused.brick_atlas, xyz.contiguous(),
                                   fused.grid_dim, splus_shift)


def _cell_coords(grid_dim, xyz: torch.Tensor):
    g = torch.tensor(grid_dim, dtype=torch.float32, device=xyz.device)
    p = (xyz + 1.0) * 0.5 * (g - 1.0)
    i = torch.minimum(torch.clamp(torch.floor(p), min=0.0), g - 2.0)
    return i.to(torch.int64), p - i


def _corner_weights(f: torch.Tensor) -> torch.Tensor:
    """Trilinear corner weights [P, 8] from in-cell fractions [P, 3]
    (corner order dx, dy, dz with dz fastest)."""
    fx, fy, fz = f[:, 0:1], f[:, 1:2], f[:, 2:3]
    return torch.cat([
        (1 - fx) * (1 - fy) * (1 - fz), (1 - fx) * (1 - fy) * fz,
        (1 - fx) * fy * (1 - fz), (1 - fx) * fy * fz,
        fx * (1 - fy) * (1 - fz), fx * (1 - fy) * fz,
        fx * fy * (1 - fz), fx * fy * fz], dim=-1)


def sample_density_fused(fused: FusedGrids, xyz: torch.Tensor,
                         splus_shift: float) -> torch.Tensor:
    """Pre-activation density plus the shift at [P,3] coords in [-1,1]: one
    cell-corner row per sample, weighted trilinearly. Port of
    ``sample_density_fused``; its backward scatter-adds into the rows."""
    _, gy, gz = fused.grid_dim
    i, f = _cell_coords(fused.grid_dim, xyz)
    flat = (i[:, 0] * (gy - 1) + i[:, 1]) * (gz - 1) + i[:, 2]
    rows = fused.density_cells[flat]
    return torch.sum(rows * _corner_weights(f), dim=-1) + splus_shift


def _block_coords(fused: FusedGrids, xyz: torch.Tensor) -> torch.Tensor:
    """[..., 3] coords in [-1,1] -> [..., 3] supervoxel block of each, clipped
    to the block grid. The position is truncated toward zero before the
    floor division, as ``p.astype(int32) // sv`` in the JAX package."""
    g = torch.tensor(fused.grid_dim, dtype=torch.float32, device=xyz.device)
    p = (xyz + 1.0) * 0.5 * (g - 1.0)
    i = torch.div(p.to(torch.int32), fused.supervoxel, rounding_mode="floor")
    top = torch.tensor(fused.coarse_dim, dtype=torch.int32,
                       device=xyz.device) - 1
    return torch.minimum(torch.clamp(i, min=0), top).to(torch.int64)


def _flat_block(fused: FusedGrids, block: torch.Tensor) -> torch.Tensor:
    _, cy, cz = fused.coarse_dim
    return (block[..., 0] * cy + block[..., 1]) * cz + block[..., 2]


def sample_occ_bits_grouped(fused: FusedGrids, xyz: torch.Tensor, group: int,
                            tight: bool = False) -> torch.Tensor:
    """Occupancy test result (bool [R, T]) at [R, T, 3] coords, one
    neighborhood row per ``group`` consecutive tests (T % group == 0; the
    group's blocks span at most 5 per axis, ``renderer.occ_grouping_for``).
    Port of ``sample_occ_bits_grouped``."""
    R, T, _ = xyz.shape
    ig = _block_coords(fused, xyz).reshape(R, T // group, group, 3)
    origin = ig.amin(dim=2)                                        # [R,nG,3]
    table = fused.occ_bits_group_tight if tight else fused.occ_bits_group
    words = table[_flat_block(fused, origin).reshape(-1)].reshape(
        R, T // group, 4)
    off = ig - origin[:, :, None, :]                               # [R,nG,G,3]
    lane = off[..., 0] * 25 + off[..., 1] * 5 + off[..., 2]        # [R,nG,G]
    word = torch.gather(words, 2, lane >> 5)
    return ((word >> (lane & 31)) & 1).bool().reshape(R, T)


def sample_coarse_occ(fused: FusedGrids, xyz: torch.Tensor,
                      tight: bool = False) -> torch.Tensor:
    """Raw-density upper bound at [P,3] coords (nearest supervoxel block):
    the ungrouped test, where the step is too long for grouping. Port of
    ``sample_coarse_occ``."""
    table = fused.coarse_occ_tight if tight else fused.coarse_occ
    return table[_flat_block(fused, _block_coords(fused, xyz))]


def _cell_slot(fused: FusedGrids, i: torch.Tensor) -> torch.Tensor:
    """Cell coords [P,3] -> the slot of their block (0: no features). The
    slot half of ``_compact_row_index``; the in-brick offset is not needed,
    since the corners are read from the dense grid."""
    sv = fused.supervoxel
    top = torch.tensor(fused.coarse_dim, device=i.device) - 1
    return fused.slot_map[_flat_block(fused, torch.minimum(i // sv, top))]


def sample_feature_fused(fused: FusedGrids, name: str,
                         xyz: torch.Tensor) -> torch.Tensor:
    """Projected branch features (float32) at [P,3] coords in [-1,1]: 8 row
    reads of the dense grid, weighted trilinearly. With a slot map, samples
    in a block without a slot read zero features, as the compact-table
    branch of the JAX function gives them (its sentinel rows)."""
    gx, gy, gz = fused.grid_dim
    i, f = _cell_coords(fused.grid_dim, xyz)
    grid = fused.features[name]
    base = (i[:, 0] * gy + i[:, 1]) * gz + i[:, 2]
    w = _corner_weights(f)
    out = 0.0
    k = 0
    for dx in (0, 1):
        for dy in (0, 1):
            for dz in (0, 1):
                idx = base + (dx * gy + dy) * gz + dz
                out = out + grid[idx].to(torch.float32) * w[:, k:k + 1]
                k += 1
    if fused.slot_map is not None:
        out = torch.where(_cell_slot(fused, i)[:, None] > 0, out, 0.0)
    return out
