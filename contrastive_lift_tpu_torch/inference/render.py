"""Inference pipeline: checkpoint -> rendered maps -> clustering -> artifacts.

Port of ``load_model_for_inference``, ``render_frames`` and
``render_checkpoint_outputs`` from ``contrastive_lift_tpu/inference/
render.py``. The grids (with the empty-space-skipping tables when the
config skips) are built once per call, the budgets are calibrated on a
probe of the frames' rays, every chunk of rays renders through
``renderer.render_rays`` on the device, and the maps come back as numpy
arrays. ``render_checkpoint_outputs`` then keeps the fast half of the
slow-fast embeddings, clusters them and writes the reference's artifact
tree: ``instance_features.npy``, ``thing_features.npy``,
``slow_features.npy``, ``pred_semantics/*.png`` (uint8),
``pred_surrogateid/*.png`` (uint16) and the visualisation grids, the PNGs
through ``utils/png.py`` where the JAX package uses PIL.

With a ``mesh`` (``parallel/mesh.py``) every rank builds the grids, rank 0
calibrates the budgets and broadcasts its render config, and rank r renders
the whole chunks r, r + W, ... of the frames' chunks at the same chunk size,
so each chunk is computed exactly as in the unsharded render (the
termination survivors are picked among a chunk's rays). Each frame's maps
go to the host once its chunks are rendered and are gathered through the
host, in frame order, on every rank (``render_checkpoint_outputs``: on rank
0 alone, which clusters and writes the artifacts); the guardrail maxima are
all-reduced.
"""
from __future__ import annotations

import dataclasses
import pickle
import time
import warnings
from pathlib import Path
from typing import List, NamedTuple

import numpy as np
import torch

from ..config import Config
from ..data.base import FrameData
from ..factory import make_model_config, make_render_config
from ..io.checkpoint import load_checkpoint
from ..io.convert import params_from_numpy
from ..ops.fused_grid import FusedGrids, build_render_grids
from ..parallel import mesh as pmesh
from ..renderer import render as R
from ..utils import geometry as geo
from ..utils.device import resolve_device
from ..utils.png import write_png
from ..utils.viz import save_image, visualize_panoptic_outputs
from .cluster import (assign_clusters, cluster, cluster_segmentwise,
                      create_instances_from_semantics)

MAP_KEYS = ("rgb", "semantics", "instances", "depth")


def load_model_for_inference(ckpt_path, cfg: Config, num_semantic_classes: int,
                             step_ratio: float = 0.25, white_bg: bool = False,
                             head_topk: str | int | None = "auto",
                             device="cuda"):
    """Rebuild (params, mcfg, rcfg, state_r, meta) at the checkpoint's shapes,
    with the parameters and render state on ``device``.

    ``head_topk="auto"`` resolves to 8, the smallest k that passed the JAX
    package's PQ gate with tail completion (the ``render_frames`` default);
    ``None`` renders the heads densely."""
    if head_topk == "auto":
        head_topk = 8
    dev = resolve_device(device)
    params, meta = load_checkpoint(ckpt_path)
    grid_dim = tuple(meta["grid_dim"])
    bbox_aabb = np.asarray(meta["bbox_aabb"], np.float32)
    mcfg = make_model_config(cfg, num_semantic_classes)
    rcfg = make_render_config(cfg, bbox_aabb, grid_dim, mcfg,
                              step_ratio=step_ratio, white_bg=white_bg)
    # None (or 0) renders the heads densely, whatever the config's
    # head_topk_train would give make_render_config
    rcfg = dataclasses.replace(rcfg, head_topk=int(head_topk) if head_topk
                               else None)
    state_r = R.make_render_state(bbox_aabb, grid_dim, step_ratio, device=dev)
    return params_from_numpy(params, dev), mcfg, rcfg, state_r, meta


def _build_render_grids(params, mcfg, rcfg, state_r) -> FusedGrids:
    return build_render_grids(params, mcfg, rcfg, state_r,
                              compact=rcfg.coarse_stride is not None,
                              feature_dtype=rcfg.head_dtype,
                              atlas_dtype=rcfg.atlas_dtype)


def prepare_render(params, mcfg, rcfg, state_r, frames: List[FrameData],
                   auto_budget: bool = True, termination: bool = True,
                   head_term: bool = True, l2_only: bool = True,
                   head_tail_eps: float = 2e-3, tail_complete: bool | None = None,
                   use_fused: bool = True, mesh=None):
    """(render config, grids) that ``render_frames`` renders with, in the
    JAX package's order: the grids (None without ``use_fused``: the render
    samples the VM factors directly, without skipping); the tail-completion
    default (on wherever ``head_topk`` is); L2-only selection; the occupancy
    group sizes; and, with ``auto_budget``, budgets calibrated on a probe of
    up to 8 frames (4,096 rays), on a ``mesh`` by rank 0 alone and
    broadcast."""
    R.check_ported(rcfg)
    if not use_fused:
        if tail_complete is None:
            tail_complete = rcfg.head_topk is not None
        if rcfg.head_topk is not None:
            rcfg = dataclasses.replace(rcfg, head_tail_complete=tail_complete)
        return rcfg, None
    fused = _build_render_grids(params, mcfg, rcfg, state_r)
    if tail_complete is None:
        tail_complete = rcfg.head_topk is not None
    if rcfg.head_topk is not None and tail_complete != rcfg.head_tail_complete:
        rcfg = dataclasses.replace(rcfg, head_tail_complete=tail_complete)
    if (l2_only and rcfg.sub_stride is not None
            and fused.coarse_occ_tight is not None):
        rcfg = dataclasses.replace(rcfg, use_l1=False)
    if fused.occ_bits_group is not None:
        rcfg = R.occ_grouping_for(rcfg, state_r)
    if (auto_budget and frames and rcfg.coarse_stride is not None
            and fused.coarse_occ is not None):
        if mesh is None or mesh.rank == 0:
            sel = frames[::max(1, len(frames) // 8)][:8]
            per = max(1, 4096 // len(sel))
            probe = np.concatenate(
                [f.rays[::max(1, len(f.rays) // per)][:per] for f in sel])
            rcfg = R.calibrate_budgets(mcfg, rcfg, state_r, probe, fused,
                                       termination=termination,
                                       head_term=head_term,
                                       head_tail_eps=head_tail_eps)
        if mesh is not None:
            rcfg = pmesh.broadcast_object(mesh, rcfg)
    return rcfg, fused


class RenderReport(NamedTuple):
    """What ``render_frames_report`` returns beside the maps."""
    maps: List[dict]
    rcfg: R.RenderConfig    # the config the chunks rendered with
    budget_tail: float      # max over chunks of render_rays' guardrails
    head_tail: float


def _guardrail_warnings(rcfg, budget_tail: float, head_tail: float,
                        head_tail_eps: float) -> None:
    """The warnings ``render_frames`` raises on the guardrails, with the JAX
    package's thresholds."""
    if budget_tail > 1e-2:
        warnings.warn(
            f"empty-space-skipping budget margin exhausted: deepest kept "
            f"segment carries weight {budget_tail:.3g} on some ray — rendered "
            f"views exceed the calibration probe; raise max_segments/"
            f"max_subsegments or re-probe with these frames")
    if rcfg.head_topk is not None and rcfg.head_tail_complete:
        # completion renormalizes the dropped mass: warn only far outside
        # what the PQ gate adjudicated
        if head_tail > 0.25:
            warnings.warn(
                f"head compaction tail is extreme: head_tail {head_tail:.3g} "
                f"(k-th kept weight, or dropped mass under rank-select/"
                f"two-phase heads) at head_topk={rcfg.head_topk} — tail "
                f"completion renormalizes it, but this operating point "
                f"is far outside the gate-adjudicated regime; re-run "
                f"tools/pq_fidelity_gate.py at this k or raise head_topk")
    elif rcfg.head_term_first > 0:
        if head_tail > max(2 * rcfg.raymarch_weight_thres, head_tail_eps):
            warnings.warn(
                f"head dropped-mass bound exceeded: a ray drops "
                f"compositing mass {head_tail:.3g} "
                f"(calibrated bound {head_tail_eps:g}) — rendered views "
                f"exceed the calibration probe; re-probe with these "
                f"frames, raise head_term_fraction/head_topk, or enable "
                f"tail completion")
    elif head_tail > rcfg.raymarch_weight_thres * 2:
        warnings.warn(
            f"head_topk budget tight: the k-th kept compositing weight "
            f"reaches {head_tail:.3g} (threshold "
            f"{rcfg.raymarch_weight_thres:g}) — some above-threshold "
            f"samples were dropped from the head evaluation; raise "
            f"head_topk")


def render_frames_report(params, mcfg, rcfg, state_r, frames: List[FrameData],
                         chunk: int = 8192, progress: bool = False,
                         use_fused: bool = True, mesh=None,
                         data_axis: str = "data", auto_budget: bool = True,
                         bake_heads: bool = False, termination: bool = True,
                         head_term: bool = True, dispatch_group: int = 4,
                         l2_only: bool = True, head_tail_eps: float = 2e-3,
                         tail_complete: bool | None = None,
                         device="cuda", maps_on_every_rank: bool = True
                         ) -> RenderReport:
    """``render_frames``, returning with the maps the render config the
    chunks used (calibrated budgets included) and the guardrail maxima. On
    a ``mesh`` without ``maps_on_every_rank`` only rank 0 gets the maps
    (the others' are None)."""
    if mesh is not None and chunk % mesh.size:
        raise ValueError(f"chunk={chunk} must divide mesh size {mesh.size}")
    if bake_heads:
        raise NotImplementedError("render_frames: bake_heads is not ported")
    dev = resolve_device(device)
    if state_r.step_size.device != dev:
        raise ValueError(f"render state is on {state_r.step_size.device}, "
                         f"render_frames was asked for {dev}")
    first = np.cumsum([0] + [-(-len(f.rays) // chunk) for f in frames])
    # the port's chunk-to-rank assignment: rank r renders the whole chunks
    # r, r + W, ... of all the frames' chunks (without a mesh, every chunk)
    mine = set(range(first[-1]) if mesh is None
               else pmesh.group_batch_sharding(mesh, int(first[-1])))
    outs, tails = {}, []
    with torch.no_grad():
        rcfg, fused = prepare_render(
            params, mcfg, rcfg, state_r, frames, auto_budget=auto_budget,
            termination=termination, head_term=head_term, l2_only=l2_only,
            head_tail_eps=head_tail_eps, tail_complete=tail_complete,
            use_fused=use_fused, mesh=mesh)
        for fi, f in enumerate(frames):
            js = [j for j in range(first[fi], first[fi + 1]) if j in mine]
            rays_dev = (torch.from_numpy(_pad_to_chunks(f.rays, chunk)).to(dev)
                        if js else None)
            frame = {j: R.render_rays(
                params, mcfg, rcfg, state_r,
                rays_dev[(j - first[fi]) * chunk:][:chunk], fused=fused)
                for j in js}
            tails.extend(torch.stack([o["budget_tail"], o["head_tail"]])
                         for o in frame.values())
            # a frame's maps leave the card once its chunks are rendered
            outs.update({j: {k: o[k].cpu().numpy() for k in MAP_KEYS}
                         for j, o in frame.items()})
            if progress and (mesh is None or mesh.rank == 0):
                print(f"rendered frame {fi + 1}/{len(frames)}", flush=True)
    if mesh is not None and frames:
        outs = pmesh.gather_chunks(mesh, outs,
                                   dst=None if maps_on_every_rank else 0)
        tail = (torch.stack(tails).amax(dim=0) if tails
                else torch.zeros(2, device=dev))
        tails = [pmesh.all_reduce_(mesh, tail, "max")]
    results = None
    if mesh is None or maps_on_every_rank or mesh.rank == 0:
        results = [{k: np.concatenate([outs[j][k] for j in
                                       range(first[fi], first[fi + 1])])
                    [:len(f.rays)] for k in MAP_KEYS}
                   for fi, f in enumerate(frames)]
    budget_tail, head_tail = (torch.stack(tails).amax(dim=0).tolist()
                              if tails else (0.0, 0.0))
    if tails:
        _guardrail_warnings(rcfg, budget_tail, head_tail, head_tail_eps)
    return RenderReport(results, rcfg, budget_tail, head_tail)


def _pad_to_chunks(rays: np.ndarray, chunk: int) -> np.ndarray:
    """``rays`` padded to whole chunks by repeating the last real ray (not
    zeros, which would compete for termination survivor slots)."""
    rays = rays.astype(np.float32)
    pad = (-rays.shape[0]) % chunk
    if pad:
        rays = np.concatenate([rays, np.repeat(rays[-1:], pad, axis=0)])
    return rays


def render_frames(params, mcfg, rcfg, state_r, frames: List[FrameData],
                  chunk: int = 8192, progress: bool = False,
                  use_fused: bool = True, mesh=None, data_axis: str = "data",
                  auto_budget: bool = True, bake_heads: bool = False,
                  termination: bool = True, head_term: bool = True,
                  dispatch_group: int = 4, l2_only: bool = True,
                  head_tail_eps: float = 2e-3,
                  tail_complete: bool | None = None, device="cuda"):
    """Chunked full-pass render of a frame list -> per-frame numpy map dicts
    (rgb, semantics, instances, depth). The JAX signature and defaults, plus
    ``device``.

    Each frame's rays are padded to whole chunks by repeating the last ray
    and the padding is cut off again. ``dispatch_group`` only batched device
    dispatches on the TPU; here the chunks run as a plain loop. ``mesh``
    (``parallel/mesh.py``; ``data_axis`` names its axis) renders whole
    chunks on each rank and returns every map on every rank (see the module
    docstring); ``chunk`` must divide over it, as in the JAX package.
    Guardrail warnings are raised as in the JAX package. ``use_fused=False``
    samples the VM factors directly. The unported options (``bake_heads``,
    and those ``renderer.render.check_ported`` names) raise."""
    return render_frames_report(
        params, mcfg, rcfg, state_r, frames, chunk=chunk, progress=progress,
        use_fused=use_fused, mesh=mesh, data_axis=data_axis,
        auto_budget=auto_budget, bake_heads=bake_heads,
        termination=termination, head_term=head_term,
        dispatch_group=dispatch_group, l2_only=l2_only,
        head_tail_eps=head_tail_eps, tail_complete=tail_complete,
        device=device).maps


def render_checkpoint_outputs(
        params, mcfg, rcfg, state_r, cfg: Config,
        frames: List[FrameData], thing_classes, output_dir,
        bandwidth: float = 0.15, use_dbscan: bool = False,
        segmentwise: bool = False, use_silverman: bool = False,
        cluster_size: int = 500, cached_centroids_path=None,
        chunk: int = 8192, save_visualizations: bool = True,
        mesh=None, termination: bool = True,
        head_term: bool = True, l2_only: bool = True,
        tail_complete: bool | None = None, device="cuda") -> dict:
    """Full inference: render + cluster + write artifacts. Returns the
    summary (frames, render and cluster seconds, rays/s, output dir). On a
    ``mesh`` every rank renders its chunks; rank 0 alone clusters and
    writes, and the other ranks' summaries have no cluster seconds."""
    output_dir = Path(output_dir)
    writer = mesh is None or mesh.rank == 0
    if writer:
        for sub in ("vis_semantics_and_surrogate", "pred_semantics",
                    "pred_surrogateid"):
            (output_dir / sub).mkdir(parents=True, exist_ok=True)
    h, w = cfg.image_dim

    t_render0 = time.perf_counter()
    per_frame = render_frames_report(
        params, mcfg, rcfg, state_r, frames, chunk, mesh=mesh,
        data_axis=cfg.data_axis, termination=termination,
        head_term=head_term, l2_only=l2_only, tail_complete=tail_complete,
        device=device, maps_on_every_rank=False).maps
    t_render = time.perf_counter() - t_render0
    rays_total = len(frames) * h * w
    summary = {"num_frames": len(frames), "render_seconds": t_render,
               "cluster_seconds": None,
               "rays_per_second": rays_total / max(t_render, 1e-9),
               "output_dir": str(output_dir)}
    if not writer:
        return summary

    all_sem = [f["semantics"] for f in per_frame]
    all_inst = np.concatenate([f["instances"] for f in per_frame])
    slow_features = None
    if mcfg.slow_fast_mode:
        slow_features = all_inst[:, cfg.max_instances:]
        all_inst = all_inst[:, :cfg.max_instances]  # keep fast features
    if cfg.use_delta:
        rays = np.concatenate([f.rays for f in frames])
        dists = np.concatenate([f["depth"] for f in per_frame])
        all_inst = all_inst + rays[:, 0:3] + dists[:, None] * rays[:, 3:6]

    np.save(output_dir / "instance_features.npy", all_inst)
    sem_cat = np.concatenate(all_sem)
    thing_features = create_instances_from_semantics(all_inst, sem_cat,
                                                     thing_classes)
    np.save(output_dir / "thing_features.npy", thing_features)
    if slow_features is not None:
        np.save(output_dir / "slow_features.npy", slow_features)

    t_cluster0 = time.perf_counter()
    num_images = len(frames)
    if cached_centroids_path is not None:
        with open(cached_centroids_path, "rb") as f:
            all_centroids = pickle.load(f)
        instances_oh = assign_clusters(thing_features, sem_cat, all_centroids,
                                       num_images, device=device)
    elif segmentwise:
        instances_oh, _ = cluster_segmentwise(
            thing_features, sem_cat, bandwidth, num_images, use_dbscan,
            use_silverman, cluster_size, device=device)
    else:
        instances_oh = cluster(thing_features, bandwidth, num_images,
                               use_dbscan, use_silverman, cluster_size,
                               device=device)
    t_cluster = time.perf_counter() - t_cluster0

    for i, frame in enumerate(frames):
        name = f"{frame.name}.png"
        out = per_frame[i]
        sem_label = out["semantics"].argmax(-1).reshape(h, w)
        inst_label = np.asarray(instances_oh[i]).argmax(-1).reshape(h, w)
        write_png(output_dir / "pred_semantics" / name,
                  sem_label.astype(np.uint8))
        write_png(output_dir / "pred_surrogateid" / name,
                  inst_label.astype(np.uint16))
        if save_visualizations:
            depth = (geo.distance_to_depth(frame.intrinsics, out["depth"], h, w)
                     if frame.intrinsics is not None else out["depth"])
            grid = visualize_panoptic_outputs(
                out["rgb"], out["semantics"], np.asarray(instances_oh[i]),
                np.asarray(depth), None, None, None, h, w,
                thing_classes=thing_classes, visualize_entropy=False)
            save_image(output_dir / "vis_semantics_and_surrogate" / name, grid)

    summary["cluster_seconds"] = t_cluster
    return summary
