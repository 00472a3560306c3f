"""Wiring helpers: Config -> model, renderer configs and class weights.

Port of ``contrastive_lift_tpu/factory.py``; the two packages build equal
configs from the same ``Config``.
"""
from __future__ import annotations

import numpy as np
import torch

from .config import Config
from .losses.losses import get_semantic_weights
from .models import tensorf as tf
from .renderer import render as R
from .utils.device import resolve_device


def make_model_config(cfg: Config, num_semantic_classes: int) -> tf.TensoRFConfig:
    return tf.TensoRFConfig(
        num_semantic_classes=num_semantic_classes,
        dim_feature_instance=cfg.dim_feature_instance,
        num_semantics_comps=(32, 32, 32),
        num_instance_comps=(32, 32, 32),
        pe_sem=cfg.pe_sem, pe_ins=cfg.pe_ins,
        semantic_output_softmax=cfg.semantic_weight_mode == "softmax",
        use_semantic_mlp=cfg.use_mlp_for_semantics,
        use_instance_mlp=cfg.use_mlp_for_instances,
        use_distilled_features_semantic=cfg.use_distilled_features_semantic,
        use_distilled_features_instance=cfg.use_distilled_features_instance,
        slow_fast_mode=cfg.instance_loss_mode == "slow_fast",
        use_proj=cfg.use_proj,
    )


def make_render_config(cfg: Config, scene_bounds, grid_dim, mcfg: tf.TensoRFConfig,
                       step_ratio: float = 0.5, white_bg: bool = False,
                       n_samples_override=None, head_topk=None) -> R.RenderConfig:
    n_samples = (n_samples_override if n_samples_override is not None
                 else R.compute_n_samples(scene_bounds, grid_dim, step_ratio))
    if head_topk is None and getattr(cfg, "head_topk_train", 0):
        # opt-in train-time top-k head compaction (Config.head_topk_train);
        # inference callers pass an explicit head_topk and are unaffected
        head_topk = int(cfg.head_topk_train)
    return R.RenderConfig(
        n_samples=n_samples,
        num_semantic_classes=mcfg.num_semantic_classes,
        dim_feature_instance=mcfg.dim_feature_instance,
        semantic_weight_mode=cfg.semantic_weight_mode,
        stop_semantic_grad=cfg.stop_semantic_grad,
        feature_stop_grad=cfg.feature_stop_grad,
        perturb=cfg.perturb,
        white_bg=white_bg,
        head_topk=head_topk,
        head_dtype="bfloat16" if cfg.precision in ("bf16", "bfloat16") else "float32",
        coarse_stride=cfg.coarse_stride or None,
        max_segments=cfg.max_segments,
        sub_stride=getattr(cfg, "sub_stride", 0) or None,
        max_subsegments=getattr(cfg, "max_subsegments", 24),
    )


def build_model(cfg: Config, num_semantic_classes: int, scene_bounds=None,
                grid_dim=None, seed=None, step_ratio: float = 0.5,
                white_bg: bool = False, device="cuda"):
    """(mcfg, params, rcfg, render_state) at the initial grid resolution,
    on ``device``. The parameters are drawn from a ``torch.Generator``
    seeded with ``seed`` (default ``cfg.seed``), with the JAX package's
    distributions, not its draws."""
    dev = resolve_device(device)
    if scene_bounds is None:
        scene_bounds = np.array([[-1., -1., -1.], [1., 1., 1.]], np.float32)
    if grid_dim is None:
        grid_dim = (cfg.min_grid_dim,) * 3
    seed = cfg.seed if seed is None else seed
    mcfg = make_model_config(cfg, num_semantic_classes)
    gen = torch.Generator().manual_seed(int(seed or 0))
    params = tf.init_tensorf(gen, mcfg, grid_dim, device=dev)
    rcfg = make_render_config(cfg, scene_bounds, grid_dim, mcfg, step_ratio,
                              white_bg)
    state_r = R.make_render_state(scene_bounds, grid_dim, step_ratio,
                                  device=dev)
    return mcfg, params, rcfg, state_r


def class_weights_for(cfg: Config, segmentation, device="cuda") -> torch.Tensor:
    return get_semantic_weights(cfg.reweight_fg, segmentation.fg_classes,
                                segmentation.num_semantic_classes,
                                cfg.weight_class_0,
                                device=resolve_device(device))
