"""Inference pipeline, first half: checkpoint -> rendered per-frame maps.

Port of ``load_model_for_inference`` and the dense loop of ``render_frames``
from ``contrastive_lift_tpu/inference/render.py``. The dense grids are built
once per call, every chunk of rays renders through ``renderer.render_rays``
on the device, and the maps come back as numpy arrays. Artifact writing
(PNGs, ``render_checkpoint_outputs``) is not ported yet.
"""
from __future__ import annotations

import dataclasses
from typing import List

import numpy as np
import torch

from ..config import Config
from ..data.base import FrameData
from ..factory import make_model_config, make_render_config
from ..io.checkpoint import load_checkpoint
from ..io.convert import params_from_numpy
from ..ops.fused_grid import build_render_grids
from ..renderer import render as R
from ..utils.device import resolve_device

MAP_KEYS = ("rgb", "semantics", "instances", "depth")


def load_model_for_inference(ckpt_path, cfg: Config, num_semantic_classes: int,
                             step_ratio: float = 0.25, white_bg: bool = False,
                             head_topk: str | int | None = "auto",
                             device="cuda"):
    """Rebuild (params, mcfg, rcfg, state_r, meta) at the checkpoint's shapes,
    with the parameters and render state on ``device``.

    ``head_topk`` is passed through to the render config. Its JAX default
    ``"auto"`` (top-k head compaction at k=8) is not ported and raises; pass
    ``None`` for the dense render."""
    if head_topk == "auto":
        raise NotImplementedError(
            "load_model_for_inference: head_topk='auto' (top-k head "
            "compaction, k=8) is not ported; pass head_topk=None")
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


def render_frames(params, mcfg, rcfg, state_r, frames: List[FrameData],
                  chunk: int = 8192, progress: bool = False,
                  use_fused: bool = True, mesh=None, bake_heads: bool = False,
                  dispatch_group: int = 4, device="cuda"):
    """Chunked full-pass render of a frame list -> per-frame numpy map dicts
    (rgb, semantics, instances, depth).

    Each frame's rays are padded to whole chunks by repeating the last ray
    and the padding is cut off again. ``dispatch_group`` only batched device
    dispatches on the TPU; here the chunks run as a plain loop. The
    unported options (``use_fused=False``, ``mesh``, ``bake_heads``, and the
    render-config options ``renderer.render.check_dense`` lists) raise."""
    if not use_fused:
        raise NotImplementedError("render_frames: use_fused=False (direct VM "
                                  "sampling) is not ported")
    if mesh is not None:
        raise NotImplementedError("render_frames: mesh (multi-device "
                                  "render) is not ported")
    if bake_heads:
        raise NotImplementedError("render_frames: bake_heads is not ported")
    R.check_dense(rcfg)
    dev = resolve_device(device)
    if state_r.step_size.device != dev:
        raise ValueError(f"render state is on {state_r.step_size.device}, "
                         f"render_frames was asked for {dev}")
    results = []
    with torch.no_grad():
        fused = build_render_grids(params, rcfg.atlas_dtype)
        for fi, frame in enumerate(frames):
            rays = frame.rays.astype(np.float32)
            n = rays.shape[0]
            pad = (-n) % chunk
            if pad:
                # repeat the last real ray (not zeros); sliced away below
                rays = np.concatenate([rays, np.repeat(rays[-1:], pad, axis=0)])
            rays_dev = torch.from_numpy(rays).to(dev)
            outs = [R.render_rays(params, mcfg, rcfg, state_r,
                                  rays_dev[i:i + chunk], fused=fused)
                    for i in range(0, len(rays), chunk)]
            results.append({k: torch.cat([o[k] for o in outs])[:n].cpu().numpy()
                            for k in MAP_KEYS})
            if progress:
                print(f"rendered frame {fi + 1}/{len(frames)}", flush=True)
    return results
