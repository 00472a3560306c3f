"""What the ranks run in the tests of the data-parallel paths.

Each function here is also callable in one process (no launch: no mesh)
for the unsharded run it is held to: ``term_steps`` takes one step per loss
term whose global normaliser a data-parallel step must reproduce,
``render_sharded`` renders frames with the production defaults, and
``fail_on_rank`` fails one rank while the others wait in a collective. They
live in the package, so spawned workers import the port and nothing else;
no entry point of the port calls them.
"""
from __future__ import annotations

import dataclasses
from typing import Optional

import numpy as np
import torch

from ..config import Config
from ..data.base import (FrameData, InstanceBundleSampler, RayPoolSampler,
                         SegmentBundleSampler)
from ..data.synthetic import make_synthetic_scene
from ..factory import build_model, class_weights_for
from ..inference.render import load_model_for_inference, render_frames_report
from ..train.state import init_train_state
from ..train.step import TrainGates, make_train_step
from ..utils.tree import path_str
from . import mesh as pmesh
from .dryrun import replica_digests


def rank_mesh(device, backend=None) -> Optional[pmesh.Mesh]:
    """This rank's mesh when the process is a rank of a launch, else None."""
    return (pmesh.make_mesh(device=device, backend=backend)
            if pmesh.launched() else None)


# ---------------------------------------------------------------------------
# one step per globally normalised loss term
# ---------------------------------------------------------------------------

TERM_CFG = dict(min_grid_dim=12, max_grid_dim=12, max_instances=3,
                instance_loss_mode="slow_fast", use_DINO_style=True,
                batch_size=64, batch_size_contrastive=2, max_rays_instances=32,
                max_labels_per_image=8, batch_size_segments=4,
                max_rays_segments=16, chunk_segment=24, lambda_dist_reg=0.01,
                lambda_tv_density=1.0, lambda_tv_appearance=1.0,
                weight_class_0=1.0, seed=0)
# case -> (config changes, gates, chain whose gradients are compared)
TERM_CASES = {
    # psnr of the global mse, beside the rgb, semantic and distortion means
    "psnr": ({}, TrainGates(semantics_on=True), "main"),
    # a TV-only step: no pixel is valid, no semantics, no distortion
    "tv": ({"lambda_dist_reg": 0.0}, TrainGates(semantics_on=False), "main"),
    # the segment loss over valid rays, the ranks holding unequal padding
    "segment": ({"lambda_rgb": 0.0},
                TrainGates(semantics_on=False, segments_on=True), "main"),
    # the instance loss, image k mixing its slow net by 0.9^k
    "instance": ({"optimize_instance_only": True},
                 TrainGates(semantics_on=False, instances_on=True), "inst"),
}


def slab_field(params: dict) -> dict:
    """``params`` with a density field that is empty but for an opaque slab
    3 voxels deep across a disk in the middle of the grid (in place), so
    the heads see above-threshold samples."""
    planes, lines = params["density"]["planes"], params["density"]["lines"]
    g = lines[0].shape[1]
    y, x = torch.meshgrid(torch.arange(planes[0].shape[1]),
                          torch.arange(planes[0].shape[2]), indexing="ij")
    mid = (g - 1) / 2
    with torch.no_grad():
        for p in planes:
            p.mul_(2.0)
        planes[0][0] = (((y - mid) ** 2 + (x - mid) ** 2) < (g / 3) ** 2).to(
            planes[0].dtype)
        z = torch.arange(g)
        lines[0][0] = torch.where((z >= g // 2 - 1) & (z <= g // 2 + 1),
                                  30.0, 0.0)
        planes[0][1], lines[0][1] = 1.0, -8.0
    return params


def term_steps(device="cpu", backend=None) -> dict:
    """One step of each ``TERM_CASES`` case from the same parameters (a
    ``slab_field``), batches (drawn from seed 0 at the global shapes) and
    generator draws:
    {case: {"metrics", "grads" (the compared chain's, numpy by path),
    "param_digests"}}. On a mesh the batches are sharded; in the segment
    case the second half of the segments keeps a quarter of its rays valid,
    the first half all of them. ``backend``: the group's (default NCCL on
    cards, gloo on the CPU)."""
    mesh = rank_mesh(device, backend)
    dev = torch.device(device) if mesh is None else mesh.device
    scene = make_synthetic_scene(num_spheres=3, num_train=2, num_val=1,
                                 image_dim=(16, 16), seed=0)
    out = {}
    for case, (changes, gates, chain) in TERM_CASES.items():
        cfg = Config(**{**TERM_CFG, **changes}).resolve_epochs()
        mcfg, params, rcfg, state_r = build_model(
            cfg, scene.num_semantic_classes, scene.scene_bounds,
            (cfg.min_grid_dim,) * 3, device=dev)
        state = init_train_state(cfg, slab_field(params))
        if mesh is not None:
            pmesh.replicate_tree(mesh, state)
        rng = np.random.default_rng(0)
        frames = scene.train_frames
        b_main = RayPoolSampler(frames, scene.num_semantic_classes).sample(
            rng, cfg.batch_size)
        b_inst = InstanceBundleSampler(
            frames, cfg.max_rays_instances, cfg.max_labels_per_image).sample(
            rng, cfg.batch_size_contrastive)
        b_seg = SegmentBundleSampler(frames, cfg.max_rays_segments).sample(
            rng, cfg.batch_size_segments)
        if case == "tv":
            b_main["mask"][:] = False
        if case == "segment":
            half = b_seg["valid"].shape[0] // 2
            keep = np.arange(half) % 4 == 0
            b_seg["valid"][half:] &= keep
        if mesh is not None:
            b_main, b_seg = (pmesh.shard_main_batch(mesh, b)
                             for b in (b_main, b_seg))
            b_inst = pmesh.shard_instance_batch(mesh, b_inst)
        step = make_train_step(cfg, mcfg, rcfg, gates,
                               class_weights_for(cfg, scene.segmentation,
                                                 device=dev),
                               params, keep_grads=True, mesh=mesh)
        gen = torch.Generator(device=dev).manual_seed(0)
        state, m = step(state, state_r, b_main,
                        b_inst if gates.instances_on else None,
                        b_seg if gates.segments_on else None, gen, 1.0,
                        cfg.lambda_dist_reg)
        out[case] = {"metrics": {k: float(v) for k, v in m.items()},
                     "grads": {path_str(p): g.cpu().numpy()
                               for p, g in step.grads[chain].items()},
                     "param_digests": replica_digests(mesh, state.params)}
    return out


# ---------------------------------------------------------------------------
# the production render
# ---------------------------------------------------------------------------

def render_sharded(ckpt, cfg_kw: dict, n_classes: int, rays: list,
                   chunk: int, device="cpu", step_ratio: float = 0.25,
                   backend=None) -> dict:
    """``render_frames`` with the production defaults of ``ckpt`` (loaded
    with ``Config(**cfg_kw)``) on frames of the ``rays`` arrays, on this
    rank's mesh when launched: the maps, the calibrated render config (as a
    dict) and the guardrail maxima."""
    mesh = rank_mesh(device, backend)
    dev = torch.device(device) if mesh is None else mesh.device
    cfg = Config(**cfg_kw).resolve_epochs()
    p, m, r, s, _ = load_model_for_inference(ckpt, cfg, n_classes,
                                             step_ratio=step_ratio,
                                             device=dev)
    frames = [FrameData(str(i), np.asarray(x, np.float32), *([None] * 6))
              for i, x in enumerate(rays)]
    rep = render_frames_report(p, m, r, s, frames, chunk=chunk, mesh=mesh,
                               device=dev)
    return {"maps": rep.maps, "rcfg": dataclasses.asdict(rep.rcfg),
            "budget_tail": rep.budget_tail, "head_tail": rep.head_tail}


def fail_on_rank(rank: int, device="cpu") -> None:
    """Rank ``rank`` raises while the others wait for it in a collective:
    what a launch must stop rather than hang on."""
    mesh = rank_mesh(device)
    if mesh.rank == rank:
        raise RuntimeError(f"rank {rank} fails")
    pmesh.agree(mesh, True, "a rank's failure")
