"""The two-phase train step.

Port of ``contrastive_lift_tpu/train/step.py``. One step of every open phase:

  phase 1: render the main ray batch; MSE + TV + distortion + semantic CE,
           plus the segment-grouping loss in the same backward pass; update
           with the main Adam chain;
  EMA:     slow <- 0.9^I slow + (1 - 0.9^I) fast (slow_fast mode, I images);
  phase 2: render the per-image instance ray bundles on stop-gradient
           density, apply the instance loss, update with the instance chain.

The JAX package's ``jax.checkpoint`` + ``lax.map`` over the segment chunks is
``torch.utils.checkpoint`` in a loop, and its ``vmap`` over the instance
images a loop. Randomness is drawn up front (``StepDraws``): from a
``torch.Generator``, or given, so that a run can take the JAX package's draws
and the checkpointed chunks recompute the same samples.

With a ``mesh`` (``parallel/mesh.py``) the step computes what the JAX
package's GSPMD program computes on the global batch, rank by rank: the
draws are made (or given) at the global shape and each rank takes its rows;
every batch mean is a local sum over the global count (the depth and
segment normalisers all-reduced first), so the ranks' losses add up to the
global loss; image k of the instance phase mixes its slow net by 0.9^k with
its global index k; one all-reduce per optimizer chain sums the gradients,
and the TV term, which depends on the parameters alone, adds its gradient
once, after it; the metrics are the global ones (sums, and maxima of the
guardrail tails), psnr from the global mse.
"""
from __future__ import annotations

import dataclasses
from dataclasses import dataclass
from typing import NamedTuple, Optional

import numpy as np
import torch
from torch.utils.checkpoint import checkpoint

from ..losses import losses as L
from ..models import tensorf as tf
from ..ops.fused_grid import build_density_only
from ..parallel import mesh as pmesh
from ..renderer import render as R
from ..utils.tree import tree_leaves_with_path, tree_map, tree_map_with_path
from .state import TrainState, ema_update_slow, make_optimizers


@dataclass(frozen=True)
class TrainGates:
    """Epoch gates of the phases."""
    semantics_on: bool = True
    instances_on: bool = False
    segments_on: bool = False
    features_on: bool = False  # distilled-feature L1 still being optimized


def gates_for_epoch(cfg, epoch: int) -> TrainGates:
    return TrainGates(
        semantics_on=epoch >= cfg.late_semantic_optimization,
        instances_on=epoch >= cfg.instance_optimization_epoch,
        segments_on=(cfg.segment_grouping_mode != "none"
                     and epoch >= cfg.segment_optimization_epoch),
        features_on=(epoch <= cfg.feature_optimization_end_epoch),
    )


def _gate_epoch(cfg, gates: TrainGates) -> int:
    """An epoch value consistent with the gates, for the TV epoch gating."""
    epoch = 0
    if gates.semantics_on:
        epoch = max(epoch, cfg.late_semantic_optimization)
    if gates.instances_on:
        epoch = max(epoch, cfg.instance_optimization_epoch)
    return epoch


class StepDraws(NamedTuple):
    """The random draws of one step, all U[0,1): the main render's per-ray
    jitter and background coin, the per-ray jitter every segment chunk
    shares (the JAX step passes one key to every chunk), and the jitter of
    each instance image."""
    main: R.RayDraws                 # jitter [Rm], coin []
    seg_jitter: Optional[torch.Tensor]   # [chunk_segment]
    inst_jitter: Optional[torch.Tensor]  # [I, Ri]


def draw_step(gen: torch.Generator, cfg, n_main: int, n_seg: int = 0,
              inst_shape=None) -> StepDraws:
    """Draws of one step from ``gen``: main jitter, coin, segment jitter,
    instance jitter, in that order."""
    def u(*shape):
        return torch.rand(shape, generator=gen, device=gen.device)

    main = R.RayDraws(u(n_main), u())
    seg = u(min(cfg.chunk_segment, n_seg)) if n_seg else None
    inst = u(*inst_shape) if inst_shape is not None else None
    return StepDraws(main, seg, inst)


def shard_draws(draws: StepDraws, rank: int, n_main: int,
                n_images: int) -> StepDraws:
    """Rank ``rank``'s part of a step's global draws, for its ``n_main`` main
    rays and ``n_images`` instance images: its rows of the main and
    instance jitter, the coin and the segment jitter whole (a segment ray
    takes the jitter of its global position)."""
    jitter = draws.main.jitter
    if jitter.shape[0] < (rank + 1) * n_main:
        raise ValueError(f"draws for {jitter.shape[0]} main rays: a sharded "
                         "step takes the global batch's draws")
    main = R.RayDraws(jitter[rank * n_main:(rank + 1) * n_main],
                      draws.main.coin)
    inst = draws.inst_jitter
    if inst is not None:
        inst = inst[rank * n_images:(rank + 1) * n_images]
    return StepDraws(main, draws.seg_jitter, inst)


def main_phase_loss(params, cfg, mcfg: tf.TensoRFConfig, rcfg: R.RenderConfig,
                    state_r: R.RenderState, gates: TrainGates, batch: dict,
                    rng, lambda_dist_reg, class_weights, head_topk=None,
                    counts: Optional[dict] = None):
    """Phase-1 loss. Returns (loss, metrics). ``head_topk`` runs the heads on
    the k heaviest samples per ray; ``main_head_tail`` (the largest k-th
    kept weight) guards that no above-threshold sample was dropped.

    ``counts`` (a rank of a sharded step: ``"rays"``, the global batch's
    ray count, and ``"mask"``, its ``sum(mask)``) makes the loss and the
    losses in the metrics this rank's shares of the global ones, leaves the
    TV term out (``metrics["tv"]``: lambda_rgb times the TV loss, for the
    step to add once) and gives ``metrics["mse"]``, the share of the mse,
    in place of the psnr."""
    if head_topk and rcfg.head_topk is None:
        rcfg = dataclasses.replace(rcfg, head_topk=int(head_topk))
    if mcfg.use_distilled:
        raise NotImplementedError("main_phase_loss: distilled-feature "
                                  "training is not ported")
    fused = None
    if getattr(cfg, "fused_main_density", False):
        # built inside the loss: the gradient flows through the densify
        # einsums to the factors; the heads sample the factors directly
        fused = build_density_only(params)
    out = R.render_rays(params, mcfg, rcfg, state_r, batch["rays"], rng,
                        is_train=True, fused=fused)
    mask = batch["mask"]
    rgb = torch.where(mask[:, None], out["rgb"], 0.0)
    rgbs = torch.where(mask[:, None], batch["rgbs"], 0.0)
    confs = torch.where(mask, batch["confidences"], 0.0)

    metrics = {}
    n_rays = count_rgb = None
    mask_total = torch.sum(mask)
    dist_reg = out["dist_reg"]
    if counts is not None:
        n_rays = counts["rays"]
        count_rgb = n_rays * rgb.shape[1]
        mask_total = counts["mask"]
        # the render's mean over this rank's rays, as a share of the global
        dist_reg = dist_reg * (rgb.shape[0] / n_rays)
    loss = torch.zeros((), device=rgb.device)
    if cfg.lambda_rgb > 0:
        loss_rgb = L.mse_loss(rgb, rgbs, count_rgb)
        loss_tv = L.total_tv_loss(params, cfg, _gate_epoch(cfg, gates))
        if counts is None:
            loss = cfg.lambda_rgb * (loss_rgb + loss_tv
                                     + dist_reg * lambda_dist_reg)
        else:
            loss = cfg.lambda_rgb * (loss_rgb + dist_reg * lambda_dist_reg)
            metrics["tv"] = cfg.lambda_rgb * loss_tv
        if cfg.lambda_depth > 0 and "depth" in batch:
            depth_err = torch.abs(out["depth"] - batch["depth"]) * mask
            loss_depth = torch.sum(depth_err) / torch.clamp(mask_total,
                                                            min=1.0)
            loss = loss + cfg.lambda_depth * loss_depth
            metrics["loss_depth"] = loss_depth
        metrics.update(loss_rgb=loss_rgb,
                       loss_feat=torch.zeros((), device=rgb.device),
                       loss_dist_reg=dist_reg)
    loss_sem = torch.zeros((), device=rgb.device)
    if gates.semantics_on:
        loss_sem = L.semantic_loss(
            out["semantics"], batch["semantics"], batch["probabilities"],
            confs, cfg.probabilistic_ce_mode, class_weights,
            cfg.use_symmetric_ce, cfg.ce_alpha, cfg.ce_beta, n_rays)
        loss = loss + cfg.lambda_semantics * loss_sem
    metrics["loss_semantics"] = loss_sem
    mse = L.mse_loss(rgb.detach(), rgbs, count_rgb)
    if counts is None:
        metrics["psnr"] = -10.0 * torch.log10(mse)
    else:
        metrics["mse"] = mse
    if head_topk:
        metrics["main_head_tail"] = out["head_tail"]
    return loss, metrics


def _aux_density_grids(params, cfg):
    """Stop-gradient density grids for the instance and segment passes, with
    the coarse occupancy for train-time skipping when ``ess_train_stride``
    is set; None without ``fused_aux_density``."""
    if not getattr(cfg, "fused_aux_density", True):
        return None
    with torch.no_grad():
        return build_density_only(
            params, with_occupancy=bool(getattr(cfg, "ess_train_stride", 0)))


def _aux_rcfg(cfg, rcfg: R.RenderConfig, aux_head_topk=None) -> R.RenderConfig:
    """Render config of the stop-gradient passes: train-time skipping on
    ``ess_train_stride`` segments (no sub level), and the calibrated top-k
    head budget."""
    repl = {}
    stride = int(getattr(cfg, "ess_train_stride", 0))
    if stride and getattr(cfg, "fused_aux_density", True):
        repl.update(coarse_stride=stride,
                    max_segments=int(getattr(cfg, "ess_train_segments", 32)),
                    sub_stride=None)
    if aux_head_topk and rcfg.head_topk is None:
        repl.update(head_topk=int(aux_head_topk))
    return dataclasses.replace(rcfg, **repl) if repl else rcfg


def segment_phase_loss(params, cfg, mcfg, rcfg, state_r, batch_seg: dict,
                       rng, class_weights, aux_head_topk=None,
                       offset: int = 0, valid_total=None):
    """Segment-grouping loss over checkpointed ray chunks of
    ``chunk_segment`` rays (the backward recomputes one chunk at a time).
    ``rng``: the jitter every chunk of its length shares (the ray at global
    position g takes entry g mod its length), or a generator. A rank of a
    sharded step passes the global position of its first ray, ``offset``,
    and the global count of valid rays, ``valid_total``; its groups are
    whole, so each group's target stays local. Returns (loss, top-k tail,
    skipping budget tail)."""
    rays = batch_seg["rays"]
    n = rays.shape[0]
    chunk = min(cfg.chunk_segment, n)
    pad = (-n) % chunk
    rays_p = torch.nn.functional.pad(rays, (0, 0, 0, pad))
    if isinstance(rng, torch.Tensor):
        pos = ((offset + torch.arange(n + pad, device=rng.device))
               % rng.shape[0])
        jitter = rng[pos].to(rays.device)

        def draws_at(i):
            return R.RayDraws(jitter[i:i + chunk])
    else:
        draws = R.ray_draws(rng, chunk, rays.device)

        def draws_at(i):
            return draws
    fused = _aux_density_grids(params, cfg)
    rcfg_aux = _aux_rcfg(cfg, rcfg, aux_head_topk)

    def render_chunk(r, draws):
        return R.render_segment_features(params, mcfg, rcfg_aux, state_r, r,
                                         draws, is_train=True, fused=fused,
                                         return_tail=True)

    maps, tails, btails = [], [], []
    for i in range(0, rays_p.shape[0], chunk):
        seg_map, tail, btail = checkpoint(render_chunk, rays_p[i:i + chunk],
                                          draws_at(i), use_reentrant=False)
        maps.append(seg_map)
        tails.append(tail)
        btails.append(btail)
    seg_map = torch.cat(maps)[:n]
    loss = L.segment_grouping_loss(
        seg_map, batch_seg["group"], batch_seg["confidences"],
        cfg.batch_size_segments, class_weights, cfg.segment_grouping_mode,
        valid=batch_seg.get("valid"), count=valid_total)
    return loss, torch.stack(tails).amax(), torch.stack(btails).amax()


def _interp_slow(params: dict, coeff, use_proj: bool) -> dict:
    """Params with slow <- coeff * slow + (1 - coeff) * fast, without
    gradient: k EMA updates of momentum m toward a fixed fast net are one
    mix with coeff m^k."""
    def mix(slow_tree, fast_tree):
        return tree_map(lambda s, f: (coeff * s + (1.0 - coeff) * f).detach(),
                        slow_tree, fast_tree)

    out = dict(params)
    imlp = dict(params["instance_mlp"])
    imlp["slow"] = mix(imlp["slow"], imlp["fast"])
    out["instance_mlp"] = imlp
    if use_proj and "proj" in params:
        proj = dict(params["proj"])
        proj["slow"] = mix(proj["slow"], proj["fast"])
        out["proj"] = proj
    return out


def instance_phase_loss(params, cfg, mcfg, rcfg, state_r, batch_inst: dict,
                        rng, aux_head_topk=None, first_image: int = 0):
    """Phase-2 loss, summed over the images of the instance bundles
    (rays [I,R,8], labels, confidences, valid [I,R]). In slow_fast mode
    image k is rendered with the slow net mixed toward the fast one by
    coefficient 0.9^k, the slow net as of k EMA updates; k counts from
    ``first_image``, the global index of a rank's first image. ``rng``: the
    jitter [I, R], or a generator. Returns (loss, top-k tail, skipping
    budget tail)."""
    num_images, n_rays = batch_inst["rays"].shape[:2]
    dev = batch_inst["rays"].device
    if isinstance(rng, torch.Generator):
        rng = torch.rand((num_images, n_rays), generator=rng,
                         device=rng.device)
    jitter = None if rng is None else rng.to(dev)
    fused = _aux_density_grids(params, cfg)
    rcfg_aux = _aux_rcfg(cfg, rcfg, aux_head_topk)
    coeffs = torch.pow(torch.tensor(0.9, device=dev),
                       torch.arange(first_image, first_image + num_images,
                                    dtype=torch.float32, device=dev))
    losses, tails, btails = [], [], []
    for k in range(num_images):
        rays, labels = batch_inst["rays"][k], batch_inst["labels"][k]
        confs, valid = batch_inst["confidences"][k], batch_inst["valid"][k]
        p_img = (_interp_slow(params, coeffs[k], mcfg.use_proj)
                 if cfg.instance_loss_mode == "slow_fast" else params)
        draws = None if jitter is None else R.RayDraws(jitter[k])
        feats, points_xyz, tail, btail = R.render_instance_features(
            p_img, mcfg, rcfg_aux, state_r, rays, draws, is_train=True,
            fused=fused, return_tail=True)
        if cfg.instance_loss_mode == "slow_fast":
            half = mcfg.dim_feature_instance // 2
            fast, slow = feats[:, :half], feats[:, half:]
            if mcfg.use_proj:
                fast, slow = tf.apply_proj(p_img, fast, slow)
            loss = L.slow_fast_loss(fast, slow.detach(), labels, confs,
                                    cfg.max_labels_per_image, valid=valid)
        elif cfg.instance_loss_mode == "contrastive":
            if cfg.use_delta:
                feats = points_xyz + feats
            loss = L.contrastive_loss(feats, labels, cfg.temperature,
                                      valid=valid)
            if cfg.use_delta:
                loss = loss + 0.1 * torch.mean(
                    torch.linalg.norm(feats - points_xyz, dim=-1))
        elif cfg.instance_loss_mode == "linear_assignment":
            loss = L.linear_assignment_loss(feats, labels, confs,
                                            cfg.max_labels_per_image,
                                            valid=valid)
        else:
            raise NotImplementedError(cfg.instance_loss_mode)
        losses.append(loss)
        tails.append(tail)
        btails.append(btail)
    return (torch.stack(losses).sum(), torch.stack(tails).amax(),
            torch.stack(btails).amax())


def _batch_to(batch: Optional[dict], dev) -> Optional[dict]:
    if batch is None:
        return None
    return {k: torch.as_tensor(np.asarray(v) if not isinstance(v, torch.Tensor)
                               else v, device=dev) for k, v in batch.items()}


def _grads(loss, params: dict, paths) -> dict:
    """{path: d loss / d leaf} for the leaves at ``paths`` (zeros where the
    loss does not reach a leaf)."""
    leaves = dict(tree_leaves_with_path(params))
    wanted = [p for p in paths if leaves[p].requires_grad]
    got = torch.autograd.grad(loss, [leaves[p] for p in wanted],
                              allow_unused=True)
    out = {p: torch.zeros_like(leaves[p]) for p in paths}
    out.update({p: g for p, g in zip(wanted, got) if g is not None})
    return out


def _with_grad(params: dict, paths) -> dict:
    """A copy of ``params`` whose leaves at ``paths`` require grad."""
    wanted = set(paths)
    return tree_map_with_path(
        lambda p, t: t.detach().requires_grad_(p in wanted), params)


def _apply(params: dict, updates: dict, lr_scale) -> dict:
    return tree_map_with_path(
        lambda p, t: (t + updates[p] * lr_scale).detach() if p in updates
        else t.detach(), params)


def _global_counts(mesh, cfg, batch_main: dict, batch_seg: Optional[dict],
                   seg_on: bool) -> dict:
    """The global counts a rank's losses divide by: the main rays, and,
    all-reduced in one buffer, the main batch's ``sum(mask)`` and the
    segment batch's valid rays."""
    mask = batch_main["mask"]
    local = [torch.sum(mask).to(torch.float32)]
    if seg_on:
        valid = batch_seg.get("valid")
        local.append(torch.tensor(float(batch_seg["rays"].shape[0]),
                                  device=mask.device) if valid is None
                     else torch.sum(valid).to(torch.float32))
    total = pmesh.all_reduce_(mesh, torch.stack(local))
    counts = {"rays": mask.shape[0] * mesh.size, "mask": total[0]}
    if seg_on:
        counts["seg_valid"] = total[1]
    return counts


def _all_reduce_grads(mesh, grads: dict) -> dict:
    """The sums over the ranks of one chain's gradients: one all-reduce."""
    paths = list(grads)
    return dict(zip(paths, pmesh.all_reduce_tensors(
        mesh, [grads[p] for p in paths])))


def _reduce_metrics(mesh, metrics: dict) -> dict:
    """The global metrics from the ranks' shares: guardrail tails by
    maximum, everything else by sum (one all-reduce each)."""
    out = dict(metrics)
    for op, keys in (("max", [k for k in metrics if k.endswith("_tail")]),
                     ("sum", [k for k in metrics if not k.endswith("_tail")])):
        if keys:
            vals = pmesh.all_reduce_(mesh, torch.stack(
                [metrics[k].to(torch.float32) for k in keys]), op)
            out.update(zip(keys, vals))
    return out


def make_train_step(cfg, mcfg: tf.TensoRFConfig, rcfg: R.RenderConfig,
                    gates: TrainGates, class_weights, params,
                    donate: bool = True, aux_head_topk=None,
                    keep_grads: bool = False, mesh=None):
    """The train step for one (stage, gates) combination, with the JAX
    signature: ``step(state, state_r, batch_main, batch_inst, batch_seg,
    rng, lr_scale, lambda_dist_reg) -> (new state, metrics)``.

    ``params`` gives the parameter groups; ``donate`` has no effect (the
    step returns new tensors). ``aux_head_topk`` is the calibrated top-k
    head budget of every train-phase head; the metrics carry the
    ``aux_head_tail`` / ``main_head_tail`` guardrails. ``rng`` is a
    ``torch.Generator`` or the ``StepDraws``; batches are numpy arrays or
    tensors and go to the parameters' device. With ``keep_grads`` the step
    keeps the gradients it applied as ``step.grads = {"main": {path: g},
    "inst": {path: g}}`` (the trained leaves of each chain).

    ``mesh``: a rank of a data-parallel step (see the module docstring).
    The batches are this rank's rows of the global batch; ``rng`` draws, or
    gives, the global batch's draws. The state stays replicated and the
    metrics are the global ones on every rank."""
    main_tx, inst_tx, _ = make_optimizers(cfg, params)
    rank, size = (0, 1) if mesh is None else (mesh.rank, mesh.size)

    def step(state: TrainState, state_r: R.RenderState, batch_main: dict,
             batch_inst: Optional[dict], batch_seg: Optional[dict],
             rng, lr_scale, lambda_dist_reg):
        params_ = state.params
        dev = tree_leaves_with_path(params_)[0][1].device
        batch_main = _batch_to(batch_main, dev)
        batch_inst = _batch_to(batch_inst, dev)
        batch_seg = _batch_to(batch_seg, dev)
        n_main = batch_main["rays"].shape[0]
        n_seg = batch_seg["rays"].shape[0] if batch_seg is not None else 0
        n_img = batch_inst["rays"].shape[0] if batch_inst is not None else 0
        if isinstance(rng, torch.Generator):
            rng = draw_step(
                rng, cfg, n_main * size, n_seg * size,
                (n_img * size, batch_inst["rays"].shape[1])
                if batch_inst is not None else None)
        counts = tv_main = None
        if mesh is not None:
            rng = shard_draws(rng, rank, n_main, n_img)
            counts = _global_counts(
                mesh, cfg, batch_main, batch_seg,
                gates.segments_on and batch_seg is not None
                and not cfg.optimize_instance_only)
        metrics = {}
        opt_main = state.opt_state_main
        if not cfg.optimize_instance_only:
            paths = main_tx.trained_paths()
            p = _with_grad(params_, paths)
            loss, m = main_phase_loss(
                p, cfg, mcfg, rcfg, state_r, gates, batch_main, rng.main,
                lambda_dist_reg, class_weights, head_topk=aux_head_topk,
                counts=counts)
            if gates.segments_on and batch_seg is not None:
                seg, seg_tail, seg_btail = segment_phase_loss(
                    p, cfg, mcfg, rcfg, state_r, batch_seg, rng.seg_jitter,
                    class_weights, aux_head_topk, offset=rank * n_seg,
                    valid_total=None if counts is None
                    else counts["seg_valid"])
                loss = loss + cfg.lambda_semantics * cfg.lambda_segment * seg
                m["loss_segment"] = seg
                m["aux_budget_tail"] = seg_btail
                if aux_head_topk:
                    m["aux_head_tail"] = seg_tail
            grads = _grads(loss, p, paths)
            if mesh is not None:
                grads = _all_reduce_grads(mesh, grads)
                tv = m.pop("tv", None)
                if tv is not None:
                    # the parameters' own term: its gradient enters once
                    for path, g in _grads(tv, p, paths).items():
                        grads[path] = grads[path] + g
                    tv_main = tv.detach()
            if keep_grads:
                step.grads["main"] = grads
            leaves = dict(tree_leaves_with_path(params_))
            updates, opt_main = main_tx.update(grads, opt_main, leaves)
            params_ = _apply(params_, updates, lr_scale)
            metrics.update({k: v.detach() for k, v in m.items()})
            metrics["loss_main"] = loss.detach()

        opt_inst = state.opt_state_inst
        if gates.instances_on and batch_inst is not None:
            paths = inst_tx.trained_paths()
            p = _with_grad(params_, paths)
            loss_i, tail_i, btail_i = instance_phase_loss(
                p, cfg, mcfg, rcfg, state_r, batch_inst, rng.inst_jitter,
                aux_head_topk, first_image=rank * n_img)
            grads_i = _grads(loss_i, p, paths)
            if mesh is not None:
                grads_i = _all_reduce_grads(mesh, grads_i)
            if keep_grads:
                step.grads["inst"] = grads_i
            metrics["aux_budget_tail"] = torch.maximum(
                metrics.get("aux_budget_tail", torch.zeros((), device=dev)),
                btail_i)
            if aux_head_topk:
                metrics["aux_head_tail"] = torch.maximum(
                    metrics.get("aux_head_tail", torch.zeros((), device=dev)),
                    tail_i)
            if cfg.instance_loss_mode == "slow_fast":
                # commit slow_I after the gradients are taken and before the
                # instance update: one EMA per image of the global batch
                params_ = ema_update_slow(params_, 0.9 ** (n_img * size),
                                          mcfg.use_proj)
            leaves = dict(tree_leaves_with_path(params_))
            updates_i, opt_inst = inst_tx.update(grads_i, opt_inst, leaves)
            params_ = _apply(params_, updates_i, lr_scale)
            metrics["loss_clustering"] = loss_i.detach()

        if mesh is not None:
            metrics = _reduce_metrics(mesh, metrics)
            if "mse" in metrics:
                metrics["psnr"] = -10.0 * torch.log10(metrics.pop("mse"))
            if tv_main is not None:
                metrics["loss_main"] = metrics["loss_main"] + tv_main
        return TrainState(params_, opt_main, opt_inst, state.step + 1), metrics

    step.grads = {}
    return step
