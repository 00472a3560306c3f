"""Inference pipeline, first half: checkpoint -> rendered per-frame maps.

Port of ``load_model_for_inference`` and ``render_frames`` from
``contrastive_lift_tpu/inference/render.py``. The grids (with the
empty-space-skipping tables when the config skips) are built once per call,
the budgets are calibrated on a probe of the frames' rays, every chunk of
rays renders through ``renderer.render_rays`` on the device, and the maps
come back as numpy arrays. Artifact writing (PNGs,
``render_checkpoint_outputs``) is not ported yet.
"""
from __future__ import annotations

import dataclasses
import warnings
from typing import List, NamedTuple

import numpy as np
import torch

from ..config import Config
from ..data.base import FrameData
from ..factory import make_model_config, make_render_config
from ..io.checkpoint import load_checkpoint
from ..io.convert import params_from_numpy
from ..ops.fused_grid import FusedGrids, build_render_grids
from ..renderer import render as R
from ..utils.device import resolve_device

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
    if head_topk:
        rcfg = dataclasses.replace(rcfg, head_topk=int(head_topk))
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
                   use_fused: bool = True):
    """(render config, grids) that ``render_frames`` renders with, in the
    JAX package's order: the grids (None without ``use_fused``: the render
    samples the VM factors directly, without skipping); the tail-completion
    default (on wherever ``head_topk`` is); L2-only selection; the occupancy
    group sizes; and, with ``auto_budget``, budgets calibrated on a probe of
    up to 8 frames (4,096 rays)."""
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
        sel = frames[::max(1, len(frames) // 8)][:8]
        per = max(1, 4096 // len(sel))
        probe = np.concatenate(
            [f.rays[::max(1, len(f.rays) // per)][:per] for f in sel])
        rcfg = R.calibrate_budgets(mcfg, rcfg, state_r, probe, fused,
                                   termination=termination,
                                   head_term=head_term,
                                   head_tail_eps=head_tail_eps)
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
                         device="cuda") -> RenderReport:
    """``render_frames``, returning with the maps the render config the
    chunks used (calibrated budgets included) and the guardrail maxima."""
    if mesh is not None:
        raise NotImplementedError("render_frames: mesh (multi-device "
                                  "render) is not ported")
    if bake_heads:
        raise NotImplementedError("render_frames: bake_heads is not ported")
    dev = resolve_device(device)
    if state_r.step_size.device != dev:
        raise ValueError(f"render state is on {state_r.step_size.device}, "
                         f"render_frames was asked for {dev}")
    results = []
    tails = []
    with torch.no_grad():
        rcfg, fused = prepare_render(
            params, mcfg, rcfg, state_r, frames, auto_budget=auto_budget,
            termination=termination, head_term=head_term, l2_only=l2_only,
            head_tail_eps=head_tail_eps, tail_complete=tail_complete,
            use_fused=use_fused)
        for fi, frame in enumerate(frames):
            rays = frame.rays.astype(np.float32)
            n = rays.shape[0]
            pad = (-n) % chunk
            if pad:
                # repeat the last real ray (not zeros, which would compete
                # for termination survivor slots); sliced away below
                rays = np.concatenate([rays, np.repeat(rays[-1:], pad, axis=0)])
            rays_dev = torch.from_numpy(rays).to(dev)
            outs = [R.render_rays(params, mcfg, rcfg, state_r,
                                  rays_dev[i:i + chunk], fused=fused)
                    for i in range(0, len(rays), chunk)]
            tails.extend(torch.stack([o["budget_tail"], o["head_tail"]])
                         for o in outs)
            results.append({k: torch.cat([o[k] for o in outs])[:n].cpu().numpy()
                            for k in MAP_KEYS})
            if progress:
                print(f"rendered frame {fi + 1}/{len(frames)}", flush=True)
    budget_tail, head_tail = (torch.stack(tails).amax(dim=0).tolist()
                              if tails else (0.0, 0.0))
    if tails:
        _guardrail_warnings(rcfg, budget_tail, head_tail, head_tail_eps)
    return RenderReport(results, rcfg, budget_tail, head_tail)


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
    dispatches on the TPU, and ``data_axis`` names the axis of a ``mesh``;
    here the chunks run as a plain loop. Guardrail warnings are raised as in
    the JAX package. ``use_fused=False`` samples the VM factors directly. The
    unported options (``mesh``, ``bake_heads``, and those ``renderer.render.check_ported`` names)
    raise."""
    return render_frames_report(
        params, mcfg, rcfg, state_r, frames, chunk=chunk, progress=progress,
        use_fused=use_fused, mesh=mesh, data_axis=data_axis,
        auto_budget=auto_budget, bake_heads=bake_heads,
        termination=termination, head_term=head_term,
        dispatch_group=dispatch_group, l2_only=l2_only,
        head_tail_eps=head_tail_eps, tail_complete=tail_complete,
        device=device).maps
