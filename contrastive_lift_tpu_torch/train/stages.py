"""The stage changes of a trained checkpoint, held to a golden.

``stage_changes`` runs on one checkpoint what ``Trainer.on_epoch_start``
runs at a shrink epoch followed by an upscale epoch: the dilated occupancy
of ``update_bbox_and_shrink`` and the crop it makes, the voxel schedule, and
for each of its counts the target resolution of the shrunk AABB and the
factor grids upsampled to it.
``check_stages`` holds the result to a golden the JAX package made the same
way (``tests/test_torch_port_golden.py stage``): every index equal, the
AABB equal (or one float32 step off, reported), the occupied count within
0.01%, and each upsampled leaf's sketch within 1e-5 of its norm.
"""
from __future__ import annotations

import time

import numpy as np
import torch

from ..config import Config
from ..factory import make_model_config
from ..io.checkpoint import load_checkpoint
from ..io.convert import params_from_numpy
from ..models import tensorf as tf
from ..renderer import occupancy as occ
from ..renderer import render as R
from ..utils.device import resolve_device
from ..utils.tree import path_str, tree_leaves_with_path
from .resume import leaf_sketches

COUNT_RTOL = 1e-4
SKETCH_TOL = 1e-5
INDEX_KEYS = ("grid_dim", "t_l", "b_r", "voxel_schedule", "target_res")


def face_alphas(dilated: np.ndarray, occupied: np.ndarray) -> np.ndarray:
    """[6, 2] for the faces x-, x+, y-, y+, z-, z+ of the occupied box: the
    largest dilated alpha of the occupied voxels on the face's plane, and
    the largest on the plane just outside (NaN at the grid's edge). How far
    each is from the threshold tells a flip from a fault."""
    idx = np.nonzero(occupied)
    out = np.full((6, 2), np.nan)
    for a in range(3):
        lo, hi = idx[a].min(), idx[a].max()
        for j, (plane, outside) in enumerate(((lo, lo - 1), (hi, hi + 1))):
            on = np.take(dilated, plane, axis=a)
            out[2 * a + j, 0] = on[np.take(occupied, plane, axis=a)].max()
            if 0 <= outside < dilated.shape[a]:
                out[2 * a + j, 1] = np.take(dilated, outside, axis=a).max()
    return out


def grid_leaves(params: dict):
    """[(path string, tensor)] of the factor grids (planes and lines), in
    JAX leaf order."""
    return [(path_str(p), t) for p, t in tree_leaves_with_path(params)
            if p[0] in tf._GRID_BRANCHES]


def stage_changes(ckpt_path, cfg: Config, device="cuda") -> dict:
    """The shrink and the upscales of ``cfg``'s schedule on the
    checkpoint's field, on ``device``: the occupied count and face alphas,
    the new grid_dim, t_l, b_r and AABB, the voxel schedule, per count the
    target resolution (``target_res`` [counts, 3]) and the sketches of the
    upsampled grid leaves (``leaf_paths``, ``sketches`` [counts, leaves,
    17]), and the seconds of the shrink (occupancy pass, box and crop,
    as ``update_bbox_and_shrink`` runs them) and of each upscale."""
    dev = resolve_device(device)
    params, meta = load_checkpoint(ckpt_path)
    n_classes = params["semantic_mlp"]["layers"][-1]["b"].shape[0]
    mcfg = make_model_config(cfg, n_classes)
    grid_dim = tuple(meta["grid_dim"])
    state_r = R.make_render_state(np.asarray(meta["bbox_aabb"], np.float32),
                                  grid_dim, device=dev)
    params = params_from_numpy(params, dev)

    def sync():
        if dev.type == "cuda":
            torch.cuda.synchronize(dev)

    sync()
    t0 = time.perf_counter()
    dilated, occupied, xyz = occ.dilated_occupancy(params, mcfg, state_r,
                                                   grid_dim)
    dilated, occupied = dilated.cpu().numpy(), occupied.cpu().numpy()
    box = occ.occupied_box(occupied, xyz.cpu().numpy(), state_r, grid_dim)
    new_params, new_state, new_grid = occ.shrink_to_box(params, state_r,
                                                        grid_dim, box)
    sync()
    shrink_s = time.perf_counter() - t0
    if box is None:
        raise ValueError(f"{ckpt_path}: no voxel is occupied")
    _, t_l, b_r = box
    schedule = occ.grid_upscale_voxel_counts(
        cfg.min_grid_dim, cfg.max_grid_dim, len(cfg.grid_upscale_epochs))
    targets, sketches, upscale_s = [], [], []
    for count in schedule:
        t0 = time.perf_counter()
        targets.append(occ.get_target_resolution(new_state, count))
        up = tf.upsample_volume_grid(new_params, targets[-1])
        sync()
        upscale_s.append(time.perf_counter() - t0)
        leaves = grid_leaves(up)
        sketches.append([leaf_sketches(i, t)[0]
                         for i, (_, t) in enumerate(leaves)])
    return {"occupied": int(occupied.sum()),
            "face_alphas": face_alphas(dilated, occupied),
            "grid_dim": tuple(new_grid), "t_l": tuple(int(x) for x in t_l),
            "b_r": tuple(int(x) for x in b_r),
            "bbox_aabb": new_state.bbox_aabb.cpu().numpy(),
            "voxel_schedule": tuple(schedule),
            "target_res": np.asarray(targets),
            "leaf_paths": [p for p, _ in leaves],
            "sketches": np.asarray(sketches),
            "seconds": {"shrink": shrink_s, "upscale": upscale_s}}


def check_stages(res: dict, golden) -> tuple:
    """(failures, notes) of ``stage_changes``' result against a golden:
    the indices equal, the AABB equal (a float32 step apart is a note, more
    a failure), the occupied count within COUNT_RTOL, every sketch within
    SKETCH_TOL of its leaf's norm."""
    bad, notes = [], []
    for key in INDEX_KEYS:
        want = tuple(int(x) for x in np.asarray(golden[key]).ravel())
        if tuple(int(x) for x in np.asarray(res[key]).ravel()) != want:
            bad.append(f"{key} {res[key]} != {want}")
    got_box = np.asarray(res["bbox_aabb"], np.float32)
    want_box = np.asarray(golden["bbox_aabb"], np.float32)
    if not np.array_equal(got_box, want_box):
        ulps = np.abs(got_box.view(np.int32).astype(np.int64)
                      - want_box.view(np.int32).astype(np.int64))
        msg = f"bbox_aabb {got_box.tolist()} vs {want_box.tolist()}"
        (notes if ulps.max() <= 1 else bad).append(
            f"{msg}: {ulps.max()} float32 steps at {np.argwhere(ulps).tolist()}")
    want_count = int(golden["occupied"])
    if not abs(res["occupied"] - want_count) <= COUNT_RTOL * want_count:
        bad.append(f"occupied {res['occupied']} vs {want_count}")
    if list(res["leaf_paths"]) != [str(p) for p in golden["leaf_paths"]]:
        bad.append(f"leaf paths {res['leaf_paths']}")
    else:
        for count, got_c, want_c in zip(res["voxel_schedule"],
                                        res["sketches"], golden["sketches"]):
            for path, got, want in zip(res["leaf_paths"], got_c, want_c):
                err = float(np.abs(got - want).max() / max(want[0], 1e-30))
                if not err <= SKETCH_TOL:
                    bad.append(f"{path} at {count} voxels: sketch error "
                               f"{err:.3g}")
    return bad, notes
