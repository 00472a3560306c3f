"""Centroid-extraction CLI: the port's ``contrastive_lift_tpu/cli/extract_centroids.py``.

Usage:
    python -m contrastive_lift_tpu_torch.cli.extract_centroids --ckpt_path RUN/checkpoints/final.npz \
        [--device cuda] [--bandwidth B] [--use_dbscan] [--cluster_size N] \
        [--use_silverman] [--subsample N] [--image_dim H W] [--output_path P]

Renders every ``subsample``-th TRAIN view of the run's scene, clusters the
thing embeddings per class and pickles {thing_class: centroids} to
``all_centroids.pkl`` (beside the checkpoint by default), which
``cli/render.py --cached_centroids_path`` reads. ``--device`` defaults to
``cuda`` and raises without a card; ``--device cpu`` runs on the CPU.
"""
from __future__ import annotations

import argparse
from pathlib import Path

from ..data import load_scene
from ..inference.calibrate import extract_train_centroids
from ..inference.render import load_model_for_inference
from ..utils.device import resolve_device
from .render import run_config


def main(argv=None):
    parser = argparse.ArgumentParser(description=__doc__)
    parser.add_argument("--ckpt_path", type=str, required=True)
    parser.add_argument("--bandwidth", type=float, default=0.15)
    parser.add_argument("--cluster_size", type=int, default=500)
    parser.add_argument("--use_dbscan", action="store_true")
    parser.add_argument("--use_silverman", action="store_true")
    parser.add_argument("--subsample", type=int, default=1)
    parser.add_argument("--image_dim", type=int, nargs=2, default=[128, 128])
    parser.add_argument("--output_path", type=str, default=None)
    parser.add_argument("--chunk", type=int, default=8192)
    parser.add_argument("--device", type=str, default="cuda",
                        help="torch device to render and cluster on "
                        "(default: cuda)")
    args = parser.parse_args(argv)
    device = resolve_device(args.device)  # no card: raise before any work

    ckpt = Path(args.ckpt_path)
    cfg = run_config(ckpt, args.image_dim, args.subsample)
    scene = load_scene(cfg, load_val=False)
    params, mcfg, rcfg, state_r, _ = load_model_for_inference(
        ckpt, cfg, scene.num_semantic_classes, white_bg=scene.white_bg,
        device=device)
    output_path = (Path(args.output_path) if args.output_path
                   else ckpt.parent / "all_centroids.pkl")
    centroids = extract_train_centroids(
        params, mcfg, rcfg, state_r, cfg, scene.train_frames,
        scene.segmentation.fg_classes, bandwidth=args.bandwidth,
        use_dbscan=args.use_dbscan, use_silverman=args.use_silverman,
        cluster_size=args.cluster_size, chunk=args.chunk,
        output_path=output_path, device=device)
    print(f"wrote {output_path}: "
          + ", ".join(f"class {k}: {len(v)} centroids" for k, v in centroids.items()))
    return centroids


if __name__ == "__main__":
    main()
