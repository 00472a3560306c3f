"""Training orchestration: stages, epoch gates, validation, checkpoints.

Port of ``contrastive_lift_tpu/train/loop.py``. Structure, as there:

  * an epoch loop; at ``bbox_aabb_reset_epochs`` the AABB is recomputed and
    the grids shrink; at ``grid_upscale_epochs`` the grids upsample along
    the log-spaced voxel schedule. Both change shapes, so each starts a new
    *stage*: the step is rebuilt with ``make_train_step`` and both Adam
    chains start afresh. A stage is keyed by (grid_dim, gates, n_samples);
    a new calibrated head budget alone rebuilds the step and keeps the
    optimizer state;
  * per step the host only draws the batches (numpy, the JAX order);
  * validation renders whole val frames in ray chunks on the direct VM
    path and reports PSNR / mIoU / PQ / SQ / RQ;
  * data parallel: ``n_data_shards`` > 1 (or 0 = every visible device)
    makes this process one rank of a ``data`` mesh (``parallel/mesh.py``):
    parameters and optimizer state replicated, every rank drawing the global
    batches and keeping its rows, the step reproducing the global program
    (``train/step.py``); stage decisions computed on every rank and checked
    to agree; validation chunks split whole between the ranks; only rank 0
    writes files. The ranks are started by ``torchrun`` or by the CLI
    (``parallel/launch.py``).

``calibrate_aux_topk`` is the per-stage head-budget calibration, as a
function.
"""
from __future__ import annotations

import time
from collections import defaultdict
from dataclasses import dataclass
from pathlib import Path
from typing import Callable, Optional

import numpy as np
import torch

from ..config import Config
from ..data.base import (InstanceBundleSampler, RayPoolSampler, SceneData,
                         SegmentBundleSampler)
from ..factory import build_model, class_weights_for, make_render_config
from ..io.checkpoint import save_checkpoint
from ..metrics.metrics import ConfusionMatrix
from ..metrics.panoptic_quality import panoptic_quality
from ..models import tensorf as tf
from ..parallel import launch
from ..parallel import mesh as pmesh
from ..renderer import occupancy as occ
from ..renderer import render as R
from ..utils.device import resolve_device
from ..utils.tree import tree_map
from .schedule import lr_scale_for_epoch
from .state import TrainState, init_train_state
from .step import (TrainGates, _aux_density_grids, _aux_rcfg,
                   gates_for_epoch, make_train_step)


def calibrate_aux_topk(cfg, params, mcfg, rcfg: R.RenderConfig,
                       state_r: R.RenderState, gates: TrainGates, epoch: int,
                       main_sampler) -> Optional[int]:
    """The top-k head budget of every train-phase head for one stage.

    Probes, on up to 4,096 rays of ``main_sampler`` drawn from a generator
    seeded by (seed, 0x70CA1, epoch), the largest per-ray count of samples
    above ``raymarch_weight_thres``, in the aux passes' skipping render and
    in the main phase's dense one, and returns k = ceil((1.25 count + 8) /
    16) * 16. None (dense heads) when the feature is off, before the
    instance and segment gates open, on an empty field, or when k would
    cover every sample. An explicit ``head_topk_train`` wins."""
    explicit = int(getattr(cfg, "head_topk_train", 0))
    if explicit:
        return explicit
    if not getattr(cfg, "head_topk_train_auto", True):
        return None
    if not (gates.instances_on or gates.segments_on):
        return None
    rcfg_aux = _aux_rcfg(cfg, rcfg)
    S = (rcfg_aux.max_segments * rcfg_aux.coarse_stride
         if rcfg_aux.coarse_stride else rcfg_aux.n_samples)
    probe_rng = np.random.default_rng((cfg.seed or 0, 0x70CA1, epoch))
    rays = main_sampler.sample(probe_rng, min(4096, 2 * cfg.batch_size))["rays"]
    probe = torch.as_tensor(rays, device=state_r.step_size.device)
    fused = _aux_density_grids(params, cfg)
    w = R.aux_density_weights(params, mcfg, rcfg_aux, state_r, probe, None,
                              False, fused)[2]
    cnt_aux = torch.amax(torch.sum(w > rcfg_aux.raymarch_weight_thres, -1))
    # the main phase samples densely, without skipping: probe it as well
    w_main = R.aux_density_weights(params, mcfg, rcfg, state_r, probe, None,
                                   False, None)[2]
    cnt_main = torch.amax(torch.sum(w_main > rcfg.raymarch_weight_thres, -1))
    cnt = int(torch.maximum(cnt_aux, cnt_main))
    if cnt == 0:
        return None
    k = int(np.ceil((cnt * 1.25 + 8) / 16.0) * 16)
    return k if k < S else None


@dataclass
class Trainer:
    """The JAX ``Trainer`` on ``device`` (default ``"cuda"``).

    ``params``: initial parameters (a tree of tensors or numpy arrays, e.g.
    the JAX package's through ``io/convert.py::params_from_numpy``); by
    default ``build_model`` draws them. ``draws``: a function of
    ``global_step`` giving that step's ``StepDraws`` or a
    ``torch.Generator``; by default one generator on the device seeded by
    ``cfg.seed``. The batches come from ``np.random.default_rng(cfg.seed)``
    in the JAX order, so both packages draw the same ones.
    ``seconds`` collects, per kind (``shrink``, ``upscale``, ``calibrate``,
    ``rebuild``, ``step``, ``validate``, ``visualize``, ``save``),
    (epoch, seconds) pairs. ``stages`` holds one record per
    ``on_epoch_start`` (the sanity validation's included): ``epoch``,
    ``grid_dim``, ``bbox_aabb``, the calibrated ``aux_k`` and
    ``n_samples``; on the card, ``train_epoch`` adds
    ``max_memory_allocated``, the device's peak since its last reset.
    With ``n_data_shards`` other than 1 the trainer is one rank of a launch
    (``mesh``; ``device`` is then this rank's) and ``draws`` gives the
    global batch's draws."""
    cfg: Config
    scene: SceneData
    run_dir: Path
    log_every: int = 50
    device: object = "cuda"
    params: Optional[dict] = None
    draws: Optional[Callable] = None

    def __post_init__(self):
        self.device = resolve_device(self.device)
        cfg = self.cfg
        self.mesh = self._make_mesh()
        if self.mesh is not None:
            self.device = self.mesh.device
        # only rank 0 writes files and prints
        self.writer = self.mesh is None or self.mesh.rank == 0
        self.run_dir = Path(self.run_dir)
        if self.writer:
            (self.run_dir / "checkpoints").mkdir(parents=True, exist_ok=True)
            cfg.save(self.run_dir / "config.json")
        self.grid_dim = (cfg.min_grid_dim,) * 3
        self.mcfg, params, self.rcfg, self.state_r = build_model(
            cfg, self.scene.num_semantic_classes, self.scene.scene_bounds,
            self.grid_dim, white_bg=self.scene.white_bg, device=self.device)
        if self.params is not None:
            params = tree_map(lambda x: torch.as_tensor(x).to(self.device),
                              self.params)
            if tf.grid_dim_of(params) != self.grid_dim:
                raise ValueError(f"params are at grid {tf.grid_dim_of(params)}"
                                 f", the trainer starts at {self.grid_dim}")
        self.class_weights = class_weights_for(cfg, self.scene.segmentation,
                                               device=self.device)
        self.state = init_train_state(cfg, params)
        frames = self.scene.train_frames
        self.main_sampler = RayPoolSampler(
            frames, self.scene.num_semantic_classes,
            load_depth=cfg.lambda_depth > 0)
        self.inst_sampler = InstanceBundleSampler(
            frames, cfg.max_rays_instances, cfg.max_labels_per_image)
        self.seg_sampler = (SegmentBundleSampler(frames, cfg.max_rays_segments)
                            if cfg.segment_grouping_mode != "none" else None)
        self.rng = np.random.default_rng(cfg.seed or 0)
        self._gen = torch.Generator(device=self.device).manual_seed(
            int(cfg.seed or 0))
        self.global_step = 0
        self.start_epoch = 0
        self._step_fn = None
        self._step_key = None
        self._aux_k = None
        self._render_fn = None
        self._preserve_opt_once = False  # set by restore(); survives one rebuild
        self.seconds = defaultdict(list)
        self.stages = []
        from ..utils.logger import NullLogger, make_logger, snapshot_source
        from ..utils.observability import (install_signal_handlers,
                                           print_model_summary)
        try:
            # SIGUSR1 dumps the stacks, SIGUSR2 exits
            install_signal_handlers()
        except ValueError:  # pragma: no cover - not the main thread
            pass
        self.logger = NullLogger()
        if self.writer:
            snapshot_source(self.run_dir)
            self.logger = make_logger(cfg.logger, self.run_dir)
            print_model_summary(params)
        self.voxel_schedule = occ.grid_upscale_voxel_counts(
            cfg.min_grid_dim, cfg.max_grid_dim, len(cfg.grid_upscale_epochs))
        self._replicate_state()

    # -- mesh / sharding ----------------------------------------------------

    def _make_mesh(self):
        """The data-parallel mesh of ``n_data_shards`` (0 = every visible
        device, 1 = off; ``parallel/launch.py::data_shards``), with the JAX
        package's checks. More than one shard needs this process to be a
        rank of a launch."""
        n = launch.data_shards(self.cfg.n_data_shards, self.device)
        if n == 1:
            return None
        if not pmesh.launched():
            raise ValueError(
                f"n_data_shards={n} but only 1 devices in a process outside "
                "a launch: start the ranks with torchrun or through "
                "cli/train.py, which spawns them")
        for name, size in (("batch_size", self.cfg.batch_size),
                           ("batch_size_contrastive",
                            self.cfg.batch_size_contrastive),
                           ("batch_size_segments",
                            self.cfg.batch_size_segments),
                           ("chunk", self.cfg.chunk)):
            if size % n:
                raise ValueError(
                    f"{name}={size} must divide n_data_shards={n} (the batch "
                    "leading axis is sharded over the data mesh; the reference "
                    "DDP analogously requires per-rank slices)")
        return pmesh.make_mesh(n, self.cfg.data_axis, device=self.device)

    def _replicate_state(self):
        """Rank 0's parameters and optimizer state on every rank."""
        if self.mesh is not None:
            pmesh.replicate_tree(self.mesh, self.state)

    def _shard_batch(self, batch, shard=pmesh.shard_main_batch):
        """This rank's part of ``batch`` (``shard``: its rows, or
        ``pmesh.shard_instance_batch``'s whole images); without a mesh, all
        of it."""
        if batch is None or self.mesh is None:
            return batch
        return shard(self.mesh, batch)

    def _agree(self, value, what: str):
        """``value`` as every rank computed it (they must agree)."""
        if self.mesh is None:
            return value
        return pmesh.agree(self.mesh, value, what)

    def _timed(self, kind: str, epoch: int, fn, *args):
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)
        t0 = time.perf_counter()
        out = fn(*args)
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)
        self.seconds[kind].append((epoch, time.perf_counter() - t0))
        return out

    # -- stage management ---------------------------------------------------

    def _calibrate_aux_topk(self, gates: TrainGates, epoch: int):
        """Per-stage head top-k of every train-phase head (main + aux):
        ``calibrate_aux_topk`` on the current field."""
        return self._agree(
            calibrate_aux_topk(self.cfg, self.state.params, self.mcfg,
                               self.rcfg, self.state_r, gates, epoch,
                               self.main_sampler), "the head budget")

    def _rebuild_stage(self, epoch: int):
        """Rebuild the step and reset the optimizer state after any shape
        change."""
        gates = gates_for_epoch(self.cfg, epoch)
        aux_k = self._timed("calibrate", epoch, self._calibrate_aux_topk,
                            gates, epoch)
        key = (self.grid_dim, gates, self.rcfg.n_samples)
        if key == self._step_key and self._step_fn is not None:
            if aux_k != self._aux_k:
                # only the calibrated head budget moved: a new step, the
                # optimizer state kept
                self._aux_k = aux_k
                self._step_fn = make_train_step(
                    self.cfg, self.mcfg, self.rcfg, gates, self.class_weights,
                    self.state.params, aux_head_topk=aux_k, mesh=self.mesh)
            return
        t0 = time.perf_counter()
        params = self.state.params
        if self._preserve_opt_once:
            # restore() just installed the stored optimizer state at the
            # current shapes: keep it for this one rebuild
            self._preserve_opt_once = False
        else:
            fresh = init_train_state(self.cfg, params)
            self.state = TrainState(params, fresh.opt_state_main,
                                    fresh.opt_state_inst, fresh.step)
        self._aux_k = aux_k
        self._step_fn = make_train_step(self.cfg, self.mcfg, self.rcfg, gates,
                                        self.class_weights, params,
                                        aux_head_topk=aux_k, mesh=self.mesh)
        # validation renders the VM factors directly, dense, at the
        # training render config
        mcfg, rcfg = self.mcfg, self.rcfg
        self._render_fn = (
            lambda p, sr, r: R.render_rays(p, mcfg, rcfg, sr, r, None, False))
        self._step_key = key
        self.seconds["rebuild"].append((epoch, time.perf_counter() - t0))

    def _shrink(self):
        params, state_r, grid_dim = occ.update_bbox_and_shrink(
            self.state.params, self.mcfg, self.state_r, self.grid_dim)
        self._agree((tuple(grid_dim), state_r.bbox_aabb.cpu().numpy()),
                    "the shrunk grid and AABB")
        return params, state_r, grid_dim

    def _upscale(self, epoch: int):
        target_voxels = self.voxel_schedule[
            list(self.cfg.grid_upscale_epochs).index(epoch)]
        target_res = self._agree(
            occ.get_target_resolution(self.state_r, target_voxels),
            "the upscale resolution")
        return tf.upsample_volume_grid(self.state.params, target_res), target_res

    def on_epoch_start(self, epoch: int):
        cfg = self.cfg
        shape_changed = False
        if epoch in cfg.bbox_aabb_reset_epochs:
            params, state_r, grid_dim = self._timed("shrink", epoch,
                                                    self._shrink)
            if grid_dim != self.grid_dim:
                self.state = self.state._replace(params=params)
                self.state_r, self.grid_dim = state_r, grid_dim
                shape_changed = True
        if epoch in cfg.grid_upscale_epochs:
            params, target_res = self._timed("upscale", epoch, self._upscale,
                                             epoch)
            self.state = self.state._replace(params=params)
            self.grid_dim = target_res
            self.state_r = R.make_render_state(
                self.state_r.bbox_aabb.cpu().numpy(), target_res,
                device=self.device)
            self.cfg.weight_decay = 0.0  # the reference zeroes wd after upscale
            shape_changed = True
        if shape_changed:
            self.rcfg = make_render_config(
                self.cfg, self.state_r.bbox_aabb.cpu().numpy(), self.grid_dim,
                self.mcfg, white_bg=self.scene.white_bg)
            self._step_key = None
            self._preserve_opt_once = False  # shapes moved; restored opt is stale
        self._rebuild_stage(epoch)
        self.stages.append({"epoch": epoch, "grid_dim": tuple(self.grid_dim),
                            "bbox_aabb": self.state_r.bbox_aabb.cpu().tolist(),
                            "aux_k": self._aux_k,
                            "n_samples": self.rcfg.n_samples})

    # -- main loops ----------------------------------------------------------

    def steps_per_epoch(self) -> int:
        return max(1, self.main_sampler.n // self.cfg.batch_size)

    def _val_steps_within_epoch(self) -> list:
        """Mid-epoch validation steps for val_check_interval < 1 (a
        fraction of an epoch)."""
        interval = self.cfg.val_check_interval
        if interval >= 1:
            return []
        spe = self.steps_per_epoch()
        stride = max(1, int(spe * interval))
        return [s for s in range(stride, spe, stride)]

    def train_epoch(self, epoch: int) -> dict:
        cfg = self.cfg
        self.on_epoch_start(epoch)
        gates = gates_for_epoch(cfg, epoch)
        lr_scale = lr_scale_for_epoch(epoch, cfg.decay_step, cfg.decay_gamma,
                                      cfg.warmup_epochs, cfg.warmup_multiplier)
        lambda_dist = cfg.lambda_dist_reg * (1 - np.exp(-0.25 * epoch))
        mid_val_steps = set(self._val_steps_within_epoch())
        last_metrics = {}
        t0 = time.time()
        for it in range(self.steps_per_epoch()):
            t_step = time.perf_counter()
            batch_main = self.main_sampler.sample(self.rng, cfg.batch_size)
            batch_inst = (self.inst_sampler.sample(self.rng, cfg.batch_size_contrastive)
                          if gates.instances_on else None)
            batch_seg = (self.seg_sampler.sample(self.rng, cfg.batch_size_segments)
                         if gates.segments_on and self.seg_sampler else None)
            rng = (self.draws(self.global_step) if self.draws is not None
                   else self._gen)
            self.state, metrics = self._step_fn(
                self.state, self.state_r, self._shard_batch(batch_main),
                self._shard_batch(batch_inst, pmesh.shard_instance_batch),
                self._shard_batch(batch_seg),
                rng, lr_scale, lambda_dist)
            self.global_step += 1
            if self.global_step % self.log_every == 0:
                last_metrics = {k: float(v) for k, v in metrics.items()}
                self._log({"epoch": epoch, "step": self.global_step,
                           "lr_scale": lr_scale, **last_metrics})
            self.seconds["step"].append((epoch, time.perf_counter() - t_step))
            if (cfg.save_every_n_train_steps
                    and self.global_step % cfg.save_every_n_train_steps == 0):
                self.save(f"step_{self.global_step:06d}", epoch=epoch)
            if it in mid_val_steps:
                self._log({"epoch": epoch, "val": self.validate(epoch)})
        last_metrics["epoch_seconds"] = time.time() - t0
        if self.device.type == "cuda":
            self.stages[-1]["max_memory_allocated"] = (
                torch.cuda.max_memory_allocated(self.device))
        return last_metrics

    def fit(self, max_epoch: Optional[int] = None):
        cfg = self.cfg
        if self.start_epoch == 0 and cfg.sanity_steps != 0 and self.scene.val_frames:
            # render a few val frames before training, to fail fast
            n = (len(self.scene.val_frames) if cfg.sanity_steps < 0
                 else min(cfg.sanity_steps, len(self.scene.val_frames)))
            self.on_epoch_start(0)
            sanity = self.validate(-1, max_frames=n)
            self._log({"sanity_val": sanity})
        every_n = max(1, int(cfg.val_check_interval))
        for epoch in range(self.start_epoch, max_epoch or cfg.max_epoch):
            m = self.train_epoch(epoch)
            record = {"epoch": epoch, **m}
            if (epoch + 1) % every_n == 0 or epoch + 1 == (max_epoch or cfg.max_epoch):
                record["val"] = self.validate(epoch)
                self._timed("visualize", epoch, self.visualize)
            self._log(record)
            self._timed("save", epoch, self.save, "last", epoch + 1)
        return self.state

    # -- validation ----------------------------------------------------------

    def render_frame(self, rays: np.ndarray, chunk: Optional[int] = None) -> dict:
        """The maps (numpy) of ``rays``, rendered in chunks of ``chunk``
        (default ``cfg.chunk``; the last chunk padded with zero rays); on a
        mesh each rank renders whole chunks and every rank gets the maps."""
        if self._render_fn is None:
            self._rebuild_stage(self.start_epoch)
        chunk = chunk or self.cfg.chunk
        keys = ("rgb", "semantics", "instances", "depth")
        n = rays.shape[0]
        pad = (-n) % chunk
        rays_p = torch.as_tensor(np.pad(rays, ((0, pad), (0, 0))),
                                 device=self.device)
        n_chunks = len(rays_p) // chunk
        mine = (range(n_chunks) if self.mesh is None
                else pmesh.group_batch_sharding(self.mesh, n_chunks))
        outs = {}
        with torch.no_grad():
            for j in mine:
                o = self._render_fn(self.state.params, self.state_r,
                                    rays_p[j * chunk:(j + 1) * chunk])
                outs[j] = {k: o[k] for k in keys}
        if self.mesh is None:
            return {k: torch.cat([outs[j][k] for j in range(n_chunks)])
                    .cpu().numpy()[:n] for k in keys}
        outs = pmesh.gather_chunks(self.mesh, outs)
        return {k: np.concatenate([outs[j][k] for j in range(n_chunks)])[:n]
                for k in keys}

    def validate(self, epoch: int, max_frames: Optional[int] = None) -> dict:
        t0 = time.perf_counter()
        frames = self.scene.val_frames
        limit = max(1, int(len(frames) * self.cfg.val_check_percent))
        frames = frames[:min(limit, max_frames or len(frames))]
        rows = []
        for frame in frames:
            out = self.render_frame(frame.rays)
            mask = frame.mask
            rgb = np.where(mask[:, None], out["rgb"], 0.0)
            gt = np.where(mask[:, None], frame.rgbs, 0.0)
            mse = float(np.mean((rgb - gt) ** 2))
            psnr = -10 * np.log10(max(mse, 1e-12))
            sem_pred = out["semantics"].argmax(-1)
            sem_pred_m = np.where(frame.semantics == 0, 0, sem_pred)
            cm = ConfusionMatrix(self.scene.num_semantic_classes, ignore_class=[0])
            iou = cm.add_batch(sem_pred_m, frame.semantics, return_miou=True)
            # in-training instance "PQ": an argmax over the rendered
            # embedding channels, a progress signal, not the clustered PQ
            inst_pred = out["instances"].argmax(-1)
            pq, sq, rq = panoptic_quality(
                np.stack([sem_pred_m, inst_pred], -1),
                np.stack([frame.semantics, frame.instances], -1),
                self.scene.things_filtered, self.scene.stuff_filtered,
                allow_unknown_preds_category=True)
            row = {"psnr": psnr, "iou": iou, "pq": pq, "sq": sq, "rq": rq}
            if frame.gt_semantics is not None:
                cm_gt = ConfusionMatrix(self.scene.num_semantic_classes,
                                        ignore_class=list(self.scene.faulty_classes))
                row["rs_iou"] = cm_gt.add_batch(sem_pred, frame.gt_semantics,
                                                return_miou=True)
                rs_pq, rs_sq, rs_rq = panoptic_quality(
                    np.stack([sem_pred, inst_pred], -1),
                    np.stack([frame.gt_semantics, frame.gt_instances], -1),
                    self.scene.things_filtered, self.scene.stuff_filtered,
                    allow_unknown_preds_category=True)
                row.update(rs_pq=rs_pq, rs_sq=rs_sq, rs_rq=rs_rq)
            rows.append(row)
        keys = rows[0].keys()
        out = {k: float(np.nanmean([r[k] for r in rows])) for k in keys}
        self.seconds["validate"].append((epoch, time.perf_counter() - t0))
        return out

    # -- io -------------------------------------------------------------------

    def save(self, tag: str, epoch: Optional[int] = None):
        """Full training checkpoint: params, both optimizer states and the
        geometry. ``epoch`` counts COMPLETED epochs (``fit`` saves "last"
        with epoch + 1); step checkpoints store the epoch in progress. On a
        mesh only rank 0 writes."""
        if not self.writer:
            return
        save_checkpoint(
            self.run_dir / "checkpoints" / f"{tag}.npz", self.state.params,
            grid_dim=self.grid_dim,
            bbox_aabb=self.state_r.bbox_aabb.cpu().numpy(),
            epoch=(epoch if epoch is not None
                   else self.global_step // max(1, self.steps_per_epoch())),
            global_step=self.global_step,
            config_dict=self.cfg.to_dict(),
            opt_state=(self.state.opt_state_main, self.state.opt_state_inst))

    def restore(self, ckpt_path) -> None:
        """Resume mid-schedule: the model at the checkpoint's grid and AABB,
        its params and both optimizer states, and ``start_epoch`` so that
        upscale and reset epochs already passed are not replayed
        (``train/resume.py::restore_state``)."""
        from .resume import restore_state
        st = restore_state(ckpt_path, self.cfg, self.mcfg,
                           self.scene.white_bg, self.device)
        self.grid_dim, self.rcfg, self.state_r, self.state = (
            st.grid_dim, st.rcfg, st.state_r, st.state)
        self.start_epoch, self.global_step = st.epoch, st.global_step
        if not st.has_opt_state and self.writer:
            print("[resume] checkpoint has no optimizer state; cold restart "
                  "of Adam moments")
        self._step_key = None
        self._step_fn = None
        self._render_fn = None
        self._preserve_opt_once = st.has_opt_state
        self._replicate_state()
        if self.writer:
            print(f"resumed from {ckpt_path}: epoch {self.start_epoch}, "
                  f"step {self.global_step}, grid {self.grid_dim}")

    def _log(self, record: dict):
        flat = {}
        for k, v in record.items():
            if isinstance(v, dict):  # nested blocks (val, sanity_val) -> k/sub
                flat.update({f"{k}/{sk}": sv for sk, sv in v.items()})
            else:
                flat[k] = v
        self.logger.log(flat, step=self.global_step)
        if self.writer:
            printable = {k: (round(v, 4) if isinstance(v, float) else v)
                         for k, v in flat.items()}
            print(printable, flush=True)

    def visualize(self, indices=None, max_frames: int = 4):
        """Save panoptic visualization grids of selected val frames."""
        from ..utils.viz import visualize_panoptic_outputs
        h, w = self.scene.image_dim
        indices = (self.cfg.visualized_indices
                   if indices is None and self.cfg.visualized_indices
                   else indices) or list(range(min(max_frames,
                                                   len(self.scene.val_frames))))
        for idx in indices:
            frame = self.scene.val_frames[idx]
            out = self.render_frame(frame.rays)
            inst_onehot = np.eye(int(out["instances"].argmax(-1).max()) + 1,
                                 dtype=np.float32)[out["instances"].argmax(-1)]
            grid = visualize_panoptic_outputs(
                out["rgb"], out["semantics"], inst_onehot, out["depth"],
                frame.rgbs, frame.gt_semantics, frame.gt_instances, h, w,
                thing_classes=self.scene.segmentation.fg_classes,
                m2f_semantics=frame.semantics, m2f_instances=frame.instances)
            self.logger.log_image(f"val/{idx:04d}", grid, self.global_step)
