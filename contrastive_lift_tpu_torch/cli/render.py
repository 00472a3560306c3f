"""Render CLI: the port's ``contrastive_lift_tpu/cli/render.py``.

Usage:
    python -m contrastive_lift_tpu_torch.cli.render --ckpt_path RUN/checkpoints/final.npz \
        [--device cuda] [--output_dir DIR] [--image_dim H W] [--subsample N] \
        [--use_dbscan] [--segmentwise] [...]

Renders the test split of the run's scene (``RUN/config.json``) from a
checkpoint at 2x samples, clusters the instance embeddings (mean-shift,
HDBSCAN or cached centroids), and writes the reference's artifact tree
(instance_features.npy, thing_features.npy, slow_features.npy,
pred_semantics/, pred_surrogateid/, vis grids). ``--device`` defaults to
``cuda`` and raises without a card; ``--device cpu`` renders on the CPU.
"""
from __future__ import annotations

import argparse
import json
from pathlib import Path

from ..config import Config, load_config
from ..data import load_scene
from ..inference.render import (load_model_for_inference,
                                render_checkpoint_outputs)
from ..utils.device import resolve_device


def parse_head_topk(value: str):
    """``--head-topk``: "auto" (k=8 with tail completion), "none" or "0"
    (dense heads), or an integer k."""
    if value == "auto":
        return "auto"
    if value in ("none", "0"):
        return None
    return int(value)


def run_config(ckpt, image_dim, subsample: int | None) -> Config:
    """The config of the run that ``ckpt`` belongs to (the ``config.json``
    snapshotted beside its ``checkpoints/`` folder, else the defaults), set
    to render every ``subsample``-th frame (None keeps the config's) at
    ``image_dim``."""
    cfg_path = Path(ckpt).parents[1] / "config.json"
    cfg = load_config(cfg_path) if cfg_path.exists() else Config()
    if subsample is not None:
        cfg.subsample_frames = subsample
    cfg.image_dim = tuple(image_dim)
    return cfg


def main(argv=None):
    parser = argparse.ArgumentParser(description=__doc__)
    parser.add_argument("--ckpt_path", type=str, required=True)
    parser.add_argument("--bandwidth", type=float, default=0.15)
    parser.add_argument("--cluster_size", type=int, default=500,
                        help="min_cluster_size for HDBSCAN")
    parser.add_argument("--use_dbscan", action="store_true")
    parser.add_argument("--segmentwise", action="store_true")
    parser.add_argument("--subsample", type=int, default=1)
    parser.add_argument("--use_silverman", action="store_true")
    parser.add_argument("--cached_centroids_path", type=str, default=None)
    parser.add_argument("--image_dim", type=int, nargs=2, default=[256, 384],
                        help="render resolution (reference hardcodes 256x384)")
    parser.add_argument("--output_dir", type=str, default=None)
    parser.add_argument("--chunk", type=int, default=8192)
    parser.add_argument("--n_data_shards", type=int, default=None,
                        help="devices for sharded rendering (default: the run "
                        "config's n_data_shards); only 1 is ported")
    parser.add_argument("--no-term", dest="term", action="store_false",
                        default=True,
                        help="disable two-phase early-termination fine "
                        "evaluation (RenderConfig.term_first)")
    parser.add_argument("--no-hterm", dest="head_term", action="store_false",
                        default=True,
                        help="disable the two-phase head-evaluation "
                        "calibration (RenderConfig.head_term_first)")
    parser.add_argument("--no-tail-complete", dest="tail_complete",
                        action="store_false", default=None,
                        help="disable top-k tail completion (RenderConfig."
                        "head_tail_complete; on by default whenever "
                        "head_topk is set)")
    parser.add_argument("--head-topk", default="auto",
                        help="per-ray head-evaluation budget: 'auto' (k=8 "
                        "with tail completion), an integer, or 'none' (or "
                        "0) for dense head evaluation")
    parser.add_argument("--l1", dest="l2_only", action="store_false",
                        default=True,
                        help="restore the L1 segment cascade (default: "
                        "L2-only flat grouped-bit selection)")
    parser.add_argument("--device", type=str, default="cuda",
                        help="torch device to render on (default: cuda)")
    args = parser.parse_args(argv)
    device = resolve_device(args.device)  # no card: raise before any work

    ckpt = Path(args.ckpt_path)
    cfg = run_config(ckpt, args.image_dim, args.subsample)
    n_shards = (args.n_data_shards if args.n_data_shards is not None
                else cfg.n_data_shards)
    if n_shards != 1:
        raise NotImplementedError(
            f"--n_data_shards {n_shards}: sharded rendering is not ported "
            "(ROADMAP queue 1, item 12)")

    scene = load_scene(cfg, load_train=False)
    params, mcfg, rcfg, state_r, _ = load_model_for_inference(
        ckpt, cfg, scene.num_semantic_classes, white_bg=scene.white_bg,
        head_topk=parse_head_topk(args.head_topk), device=device)

    suffix = (("_dbscan" if args.use_dbscan else "")
              + ("_seg" if args.segmentwise else ""))
    output_dir = (Path(args.output_dir) if args.output_dir else
                  Path("runs") / f"{Path(cfg.dataset_root).stem}_test_"
                  f"{cfg.experiment}{suffix}")
    summary = render_checkpoint_outputs(
        params, mcfg, rcfg, state_r, cfg, scene.val_frames,
        scene.segmentation.fg_classes, output_dir,
        bandwidth=args.bandwidth, use_dbscan=args.use_dbscan,
        segmentwise=args.segmentwise, use_silverman=args.use_silverman,
        cluster_size=args.cluster_size,
        cached_centroids_path=args.cached_centroids_path, chunk=args.chunk,
        termination=args.term, head_term=args.head_term,
        l2_only=args.l2_only, tail_complete=args.tail_complete,
        device=device)
    print(json.dumps(summary, indent=2))
    return summary


if __name__ == "__main__":
    main()
