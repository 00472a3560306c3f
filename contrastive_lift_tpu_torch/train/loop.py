"""Training orchestration helpers.

Port of the per-stage head-budget calibration of
``contrastive_lift_tpu/train/loop.py`` (``Trainer._calibrate_aux_topk``), as
a function. The ``Trainer`` itself (epochs, grid growth, validation,
checkpoints) is not ported yet.
"""
from __future__ import annotations

from typing import Optional

import numpy as np
import torch

from ..renderer import render as R
from .step import TrainGates, _aux_density_grids, _aux_rcfg


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
