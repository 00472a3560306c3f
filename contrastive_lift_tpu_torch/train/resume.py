"""Resume training from a checkpoint: the state the JAX ``Trainer`` restores.

``restore_state`` rebuilds, from a checkpoint with optimizer state, what
``Trainer.restore`` (``train/loop.py``, as the JAX package's) installs, and
``restore_training`` adds what the start of ``Trainer.train_epoch`` sets up
for the next epoch: the model at the stored grid, both Adam chains with
their stored moments, the render config and state, the class weights, the
epoch's gates, lr scale and distortion weight, and the three samplers of
the scene. ``step_batches`` draws a step's batches as the ``Trainer``
does, and ``leaf_sketches`` condenses a tensor into its norm and 16 random
projections, which is how a training golden stores gradients and
parameters (seeded by the leaf's index, so any machine with numpy draws
the same probes). ``golden_step`` takes the first step of such a
golden with the port and ``check_train_step`` holds it to the golden.
"""
from __future__ import annotations

import time
from typing import NamedTuple

import numpy as np
import torch

from ..data.base import (InstanceBundleSampler, RayPoolSampler, SceneData,
                         SegmentBundleSampler)
from ..factory import class_weights_for, make_model_config, make_render_config
from ..io.checkpoint import load_checkpoint, opt_state_from_leaves
from ..io.convert import params_from_numpy
from ..renderer import render as R
from ..utils.device import resolve_device
from ..utils.tree import tree_leaves_with_path
from .loop import calibrate_aux_topk
from .schedule import lr_scale_for_epoch
from .state import TrainState, make_optimizers
from .step import StepDraws, TrainGates, gates_for_epoch, make_train_step

N_PROBES = 16
# what a training golden holds, and its bars: every metric within
# METRIC_RTOL (the parity bar of the JAX package's training tests), every
# sketch within SKETCH_TOL (a cosine of 0.999 between equal-norm vectors)
TRAIN_METRICS = ("loss_main", "loss_rgb", "loss_semantics", "loss_dist_reg",
                 "loss_segment", "loss_clustering", "aux_budget_tail",
                 "aux_head_tail", "main_head_tail")
SKETCHES = ("grad_main", "grad_inst", "after", "delta")
METRIC_RTOL = 2e-3
SKETCH_TOL = 4.5e-2
# the guardrails are also held absolutely: far below their warning levels
# (1e-2 and 2e-4), where a relative bar on a near-zero tail means nothing
GUARDRAIL_ATOL = 1e-6


class TrainSetup(NamedTuple):
    cfg: object
    mcfg: object
    rcfg: R.RenderConfig
    state_r: R.RenderState
    state: TrainState
    class_weights: torch.Tensor
    epoch: int
    global_step: int
    gates: TrainGates
    lr_scale: float
    lambda_dist_reg: float
    samplers: tuple   # (RayPoolSampler, InstanceBundleSampler, SegmentBundleSampler)


class RestoredState(NamedTuple):
    grid_dim: tuple
    rcfg: R.RenderConfig
    state_r: R.RenderState
    state: TrainState
    epoch: int
    global_step: int
    has_opt_state: bool


def restore_state(ckpt_path, cfg, mcfg, white_bg: bool,
                  device) -> RestoredState:
    """The model and optimizer state of ``ckpt_path`` on ``device`` at the
    stored grid, epoch and step, as the JAX ``Trainer.restore`` rebuilds
    them: weight decay zeroed on ``cfg`` once an upscale epoch has passed,
    both Adam chains with their stored moments (zero moments when the
    checkpoint has no optimizer state)."""
    dev = resolve_device(device)
    params, meta = load_checkpoint(ckpt_path)
    grid_dim = tuple(meta["grid_dim"])
    bbox = np.asarray(meta["bbox_aabb"], np.float32)
    epoch, step = int(meta["epoch"]), int(meta["global_step"])
    rcfg = make_render_config(cfg, bbox, grid_dim, mcfg, white_bg=white_bg)
    if any(e < epoch for e in cfg.grid_upscale_epochs):
        cfg.weight_decay = 0.0  # zeroed when the upscale ran
    state_r = R.make_render_state(bbox, grid_dim, device=dev)
    params = params_from_numpy(params, dev)
    main_tx, inst_tx, _ = make_optimizers(cfg, params)
    if "opt_leaves" in meta:
        opt_main, opt_inst = opt_state_from_leaves(
            main_tx, inst_tx, meta["opt_leaves"], params, dev)
    else:
        opt_main, opt_inst = main_tx.init(params), inst_tx.init(params)
    state = TrainState(params, opt_main, opt_inst,
                       torch.tensor(step, dtype=torch.int32, device=dev))
    return RestoredState(grid_dim, rcfg, state_r, state, epoch, step,
                         "opt_leaves" in meta)


def restore_training(ckpt_path, cfg, scene: SceneData,
                     device="cuda") -> TrainSetup:
    """The training state of ``ckpt_path`` for ``scene`` on ``device``,
    at the stored grid, epoch and step, with the stored optimizer state
    (a checkpoint without it starts both chains from zero moments)."""
    dev = resolve_device(device)
    mcfg = make_model_config(cfg, scene.num_semantic_classes)
    st = restore_state(ckpt_path, cfg, mcfg, scene.white_bg, dev)
    epoch = st.epoch
    frames = scene.train_frames
    samplers = (
        RayPoolSampler(frames, scene.num_semantic_classes,
                       load_depth=cfg.lambda_depth > 0),
        InstanceBundleSampler(frames, cfg.max_rays_instances,
                              cfg.max_labels_per_image),
        SegmentBundleSampler(frames, cfg.max_rays_segments)
        if cfg.segment_grouping_mode != "none" else None)
    return TrainSetup(
        cfg, mcfg, st.rcfg, st.state_r, st.state,
        class_weights_for(cfg, scene.segmentation, device=dev), epoch,
        st.global_step, gates_for_epoch(cfg, epoch),
        lr_scale_for_epoch(epoch, cfg.decay_step, cfg.decay_gamma,
                           cfg.warmup_epochs, cfg.warmup_multiplier),
        cfg.lambda_dist_reg * (1 - np.exp(-0.25 * epoch)), samplers)


def step_batches(setup: TrainSetup, rng: np.random.Generator):
    """(main, instance, segment) batches of one step, drawn from ``rng`` in
    the ``Trainer``'s order; None for a closed gate."""
    cfg, gates = setup.cfg, setup.gates
    main, inst, seg = setup.samplers
    bm = main.sample(rng, cfg.batch_size)
    bi = inst.sample(rng, cfg.batch_size_contrastive) if gates.instances_on else None
    bs = (seg.sample(rng, cfg.batch_size_segments)
          if gates.segments_on and seg is not None else None)
    return bm, bi, bs


def leaf_sketches(index: int, *xs) -> list:
    """[norm, 16 projections] (float64) of each of ``xs`` (one leaf's
    tensors or arrays): the projections on 16 N(0,1) float32 probe vectors
    drawn from ``np.random.default_rng(index)``."""
    vs = [np.asarray(torch.as_tensor(x).detach().to(torch.float32).cpu()
                     ).ravel().astype(np.float64) for x in xs]
    probes = np.random.default_rng(index).standard_normal(
        (N_PROBES, vs[0].size), dtype=np.float32)
    return [np.concatenate([[np.linalg.norm(v)], probes @ v]) for v in vs]


def sketch_error(got: np.ndarray, want: np.ndarray) -> float:
    """Relative error of a sketch's projections (a cosine of 0.999 between
    two vectors of equal norm gives about 4.5e-2); 0 when both are zero."""
    ref = np.linalg.norm(want[1:])
    diff = np.linalg.norm(got[1:] - want[1:])
    if ref == 0:
        return 0.0 if diff == 0 else float("inf")
    return float(diff / ref)


def golden_step(ckpt_path, cfg, scene: SceneData, golden,
                device="cuda", mesh=None) -> dict:
    """Step 1 of a training golden with the port: restore ``ckpt_path``,
    calibrate the head budget, draw the batches of the golden's sampler
    seed and take one step with the golden's draws. Returns the budget, the
    metrics (floats), the sketches of every leaf (``sketch_<name>`` [leaves,
    17]; gradients of leaves a chain does not train are zero), the setup,
    the new state, the step function and the seconds of each part.
    ``mesh``: take the step as the ranks of a data-parallel step do (a
    1-rank mesh runs the sharded code on the whole batch)."""
    t0 = time.perf_counter()
    setup = restore_training(ckpt_path, cfg, scene, device)
    t1 = time.perf_counter()
    p = setup.state.params
    k = calibrate_aux_topk(cfg, p, setup.mcfg, setup.rcfg, setup.state_r,
                           setup.gates, setup.epoch, setup.samplers[0])
    t2 = time.perf_counter()
    bm, bi, bs = step_batches(setup, np.random.default_rng(int(golden["seed"])))
    dev = setup.state_r.step_size.device

    def g(name):
        return torch.as_tensor(np.asarray(golden[name]), device=dev)

    draws = StepDraws(R.RayDraws(g("draw_main_jitter"), g("draw_main_coin")),
                      g("draw_seg_jitter"), g("draw_inst_jitter"))
    step = make_train_step(cfg, setup.mcfg, setup.rcfg, setup.gates,
                           setup.class_weights, p, aux_head_topk=k,
                           keep_grads=True, mesh=mesh)
    state, metrics = step(setup.state, setup.state_r, bm, bi, bs, draws,
                          setup.lr_scale, setup.lambda_dist_reg)
    metrics = {name: float(v) for name, v in metrics.items()}
    t3 = time.perf_counter()
    out = {"aux_head_topk": k, "metrics": metrics, "setup": setup,
           "state": state, "step": step,
           "seconds": {"restore": t1 - t0, "calibrate": t2 - t1,
                       "step": t3 - t2}}
    sk = {name: [] for name in SKETCHES}
    after = dict(tree_leaves_with_path(state.params))
    for i, (path, before) in enumerate(tree_leaves_with_path(p)):
        zero = torch.zeros_like(before)
        new = after[path]
        for name, v in zip(SKETCHES, leaf_sketches(
                i, step.grads["main"].get(path, zero),
                step.grads["inst"].get(path, zero), new, new - before)):
            sk[name].append(v)
    out.update({f"sketch_{name}": np.stack(v) for name, v in sk.items()})
    out["seconds"]["sketch"] = time.perf_counter() - t3
    return out


def check_train_step(res: dict, golden) -> list:
    """The gates of ``golden_step``'s result against the golden: the
    calibrated budget equal, every loss within METRIC_RTOL, every guardrail
    within METRIC_RTOL or GUARDRAIL_ATOL, every leaf's sketches within
    SKETCH_TOL.
    Returns the failures, as text."""
    bad = []
    if res["aux_head_topk"] != np.asarray(golden["aux_head_topk"]).item():
        bad.append(f"aux_head_topk {res['aux_head_topk']} != "
                   f"{np.asarray(golden['aux_head_topk']).item()}")
    for m in TRAIN_METRICS:
        got, want = float(res["metrics"][m]), float(golden[f"metric_{m}"])
        atol = GUARDRAIL_ATOL if m.endswith("_tail") else 0.0
        if not abs(got - want) <= METRIC_RTOL * abs(want) + atol:
            bad.append(f"{m} {got} vs {want}")
    for name in SKETCHES:
        for i, path in enumerate(golden["leaf_paths"]):
            err = sketch_error(res[f"sketch_{name}"][i],
                               golden[f"sketch_{name}"][i])
            if not err <= SKETCH_TOL:
                bad.append(f"{name} {path} sketch error {err:.3g}")
    return bad
