"""Wiring helpers: Config -> model and renderer configs.

Port of ``make_model_config`` / ``make_render_config`` from
``contrastive_lift_tpu/factory.py``; the two packages build equal configs
from the same ``Config``.
"""
from __future__ import annotations

from .config import Config
from .models import tensorf as tf
from .renderer import render as R


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
