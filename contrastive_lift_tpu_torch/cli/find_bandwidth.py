"""Bandwidth-sweep CLI: the port's ``contrastive_lift_tpu/cli/find_bandwidth.py``.

Usage:
    python -m contrastive_lift_tpu_torch.cli.find_bandwidth --ckpt_path RUN/checkpoints/final.npz \
        [--device cuda] [--use_dbscan] [--segmentwise] [--subsample N] \
        [--image_dim H W] [--output_dir DIR] [--chunk N]

Renders every ``subsample``-th TRAIN view of the run's scene
(``RUN/config.json``), sweeps the mean-shift bandwidth (or HDBSCAN's
min_cluster_size) and scores each value with per-frame PQ against the
machine pseudo-labels; writes ``all_thing_features_train.npy`` (and the
curve's plot where matplotlib is installed) to the output directory and
prints the best value. ``--device`` defaults to ``cuda`` and raises without
a card; ``--device cpu`` runs on the CPU.
"""
from __future__ import annotations

import argparse
import json
from pathlib import Path

from ..data import load_scene
from ..inference.calibrate import find_bandwidth
from ..inference.render import load_model_for_inference
from ..utils.device import resolve_device
from .render import run_config


def main(argv=None):
    parser = argparse.ArgumentParser(description=__doc__)
    parser.add_argument("--ckpt_path", type=str, required=True)
    parser.add_argument("--use_dbscan", action="store_true")
    parser.add_argument("--segmentwise", action="store_true")
    parser.add_argument("--subsample", type=int, default=1)
    parser.add_argument("--image_dim", type=int, nargs=2, default=[128, 128])
    parser.add_argument("--output_dir", type=str, default=None)
    parser.add_argument("--chunk", type=int, default=8192)
    parser.add_argument("--device", type=str, default="cuda",
                        help="torch device to render and cluster on "
                        "(default: cuda)")
    args = parser.parse_args(argv)
    device = resolve_device(args.device)  # no card: raise before any work

    ckpt = Path(args.ckpt_path)
    cfg = run_config(ckpt, args.image_dim, args.subsample)
    # calibration runs on TRAIN views against pseudo-labels, never GT
    scene = load_scene(cfg, load_val=False)
    params, mcfg, rcfg, state_r, _ = load_model_for_inference(
        ckpt, cfg, scene.num_semantic_classes, white_bg=scene.white_bg,
        device=device)
    output_dir = (Path(args.output_dir) if args.output_dir else
                  Path("runs") / f"{Path(cfg.dataset_root).stem}_bandwidth_{cfg.experiment}")
    result = find_bandwidth(
        params, mcfg, rcfg, state_r, cfg, scene.train_frames,
        scene.segmentation.fg_classes, use_dbscan=args.use_dbscan,
        segmentwise=args.segmentwise, chunk=args.chunk, output_dir=output_dir,
        device=device)
    print(json.dumps({k: v for k, v in result.items() if k != "curve"}, indent=2))
    return result


if __name__ == "__main__":
    main()
