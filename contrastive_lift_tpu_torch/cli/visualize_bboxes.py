"""BBox visualization CLI: the port's ``contrastive_lift_tpu/cli/visualize_bboxes.py``.

Usage:
    python -m contrastive_lift_tpu_torch.cli.visualize_bboxes --ckpt_path RUN/checkpoints/final.npz \
        [--device cuda] [--method aabb|pca|ellipsoid|mbr] [--bandwidth B] \
        [--image_dim H W] [--output_dir DIR] [--chunk N]

Renders the test split of the run's scene, back-projects the rendered depth
into world points labelled by their clustered (mean-shift) instance ids,
fits one box per instance (``inference/bboxes.py``) and writes
``points.obj`` (the points coloured by instance) and ``boxes.json``.
``--device`` defaults to ``cuda`` and raises without a card; ``--device
cpu`` runs on the CPU.
"""
from __future__ import annotations

import argparse
import json
from pathlib import Path

import numpy as np

from ..data import load_scene
from ..inference.bboxes import instance_bounding_boxes
from ..inference.cluster import cluster, create_instances_from_semantics
from ..inference.render import load_model_for_inference, render_frames
from ..utils.colors import DistinctColors
from ..utils.device import resolve_device
from ..utils.points import save_obj_points
from .render import run_config


def main(argv=None):
    parser = argparse.ArgumentParser(description=__doc__)
    parser.add_argument("--ckpt_path", type=str, required=True)
    parser.add_argument("--method", choices=["aabb", "pca", "ellipsoid", "mbr"],
                        default="mbr")
    parser.add_argument("--bandwidth", type=float, default=0.15)
    parser.add_argument("--image_dim", type=int, nargs=2, default=[128, 128])
    parser.add_argument("--output_dir", type=str, default=None)
    parser.add_argument("--chunk", type=int, default=8192)
    parser.add_argument("--device", type=str, default="cuda",
                        help="torch device to render and cluster on "
                        "(default: cuda)")
    args = parser.parse_args(argv)
    device = resolve_device(args.device)  # no card: raise before any work

    ckpt = Path(args.ckpt_path)
    # the test frames the run's config subsamples, as the JAX CLI renders
    cfg = run_config(ckpt, args.image_dim, None)
    scene = load_scene(cfg, load_train=False)
    frames = scene.val_frames
    params, mcfg, rcfg, state_r, _ = load_model_for_inference(
        ckpt, cfg, scene.num_semantic_classes, white_bg=scene.white_bg,
        device=device)

    per_frame = render_frames(params, mcfg, rcfg, state_r, frames, args.chunk,
                              device=device)
    sem_cat = np.concatenate([f["semantics"] for f in per_frame])
    inst_cat = np.concatenate([f["instances"] for f in per_frame])
    if mcfg.slow_fast_mode:
        inst_cat = inst_cat[:, :cfg.max_instances]
    thing_feats = create_instances_from_semantics(
        inst_cat, sem_cat, scene.segmentation.fg_classes)
    onehot = cluster(thing_feats, args.bandwidth, num_images=len(frames),
                     device=device)

    # back-project rendered depth into world surface points
    pts, ids = [], []
    for i, frame in enumerate(frames):
        o, d = frame.rays[:, :3], frame.rays[:, 3:6]
        pts.append(o + per_frame[i]["depth"][:, None] * d)
        ids.append(np.asarray(onehot[i]).argmax(-1))
    points = np.concatenate(pts)
    inst_ids = np.concatenate(ids)

    boxes = instance_bounding_boxes(points, inst_ids, method=args.method)
    output_dir = Path(args.output_dir or
                      Path("runs") / f"{Path(cfg.dataset_root).stem}_bboxes")
    output_dir.mkdir(parents=True, exist_ok=True)
    save_obj_points(output_dir / "points.obj", points,
                    DistinctColors().apply(inst_ids))
    (output_dir / "boxes.json").write_text(json.dumps(
        {str(k): {kk: np.asarray(vv).tolist() for kk, vv in v.items()}
         for k, v in boxes.items()}, indent=2))
    print(f"{len(boxes)} boxes -> {output_dir}")
    return boxes


if __name__ == "__main__":
    main()
