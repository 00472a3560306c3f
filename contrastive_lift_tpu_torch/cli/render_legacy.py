"""Legacy render CLI: the port's ``contrastive_lift_tpu/cli/render_legacy.py``.

Usage:
    python -m contrastive_lift_tpu_torch.cli.render_legacy --ckpt_path RUN/checkpoints/final.npz \
        [--device cuda] [--image_dim H W] [--subsample N] [--output_dir DIR] \
        [--render_trajectory [--trajectory_path POSES.pkl] [--trajectory_frames N]]

Argmax-channel instance ids, no clustering: for linear-assignment models
whose instance head emits per-channel logits. Renders the test split, or
with ``--render_trajectory`` a novel-view trajectory (a pickled list of
cam2world matrices, else a spherical orbit of ``--trajectory_frames``
poses), and writes ``pred_semantics/*.png`` (uint8),
``pred_surrogateid/*.png`` (uint16) and the visualisation grids under
``vis/``, through ``utils/png.py`` where the JAX CLI uses PIL. ``--device``
defaults to ``cuda`` and raises without a card; ``--device cpu`` runs on the
CPU.
"""
from __future__ import annotations

import argparse
import json
from pathlib import Path

import numpy as np

from ..data import load_scene
from ..data.trajectory import load_trajectory, rays_for_poses, spherical_orbit
from ..inference.render import load_model_for_inference, render_frames
from ..utils.device import resolve_device
from ..utils.png import write_png
from ..utils.viz import save_image, visualize_panoptic_outputs
from .render import run_config


def main(argv=None):
    parser = argparse.ArgumentParser(description=__doc__)
    parser.add_argument("--ckpt_path", type=str, required=True)
    parser.add_argument("--image_dim", type=int, nargs=2, default=[256, 384])
    parser.add_argument("--subsample", type=int, default=1)
    parser.add_argument("--render_trajectory", action="store_true")
    parser.add_argument("--trajectory_path", type=str, default=None,
                        help="pickled cam2world list; default: spherical orbit")
    parser.add_argument("--trajectory_frames", type=int, default=60)
    parser.add_argument("--output_dir", type=str, default=None)
    parser.add_argument("--chunk", type=int, default=8192)
    parser.add_argument("--device", type=str, default="cuda",
                        help="torch device to render on (default: cuda)")
    args = parser.parse_args(argv)
    device = resolve_device(args.device)  # no card: raise before any work

    ckpt = Path(args.ckpt_path)
    cfg = run_config(ckpt, args.image_dim, args.subsample)
    scene = load_scene(cfg, load_train=False)
    params, mcfg, rcfg, state_r, _ = load_model_for_inference(
        ckpt, cfg, scene.num_semantic_classes, white_bg=scene.white_bg,
        device=device)

    if args.render_trajectory:
        intr = scene.val_frames[0].intrinsics
        if args.trajectory_path:
            frames = load_trajectory(args.trajectory_path, intr, cfg.image_dim)
        else:
            frames = rays_for_poses(
                spherical_orbit(args.trajectory_frames), intr, cfg.image_dim)
        tag = "trajectory"
    else:
        frames = scene.val_frames
        tag = "test"

    output_dir = (Path(args.output_dir) if args.output_dir else
                  Path("runs") / f"{Path(cfg.dataset_root).stem}_{tag}_{cfg.experiment}_original")
    for sub in ("vis", "pred_semantics", "pred_surrogateid"):
        (output_dir / sub).mkdir(parents=True, exist_ok=True)

    per_frame = render_frames(params, mcfg, rcfg, state_r, frames, args.chunk,
                              device=device)
    h, w = cfg.image_dim
    for i, frame in enumerate(frames):
        out = per_frame[i]
        sem = out["semantics"].argmax(-1).reshape(h, w)
        inst_logits = out["instances"][:, :cfg.max_instances]  # fast half
        inst = inst_logits.argmax(-1).reshape(h, w)
        name = f"{frame.name}.png"
        write_png(output_dir / "pred_semantics" / name, sem.astype(np.uint8))
        write_png(output_dir / "pred_surrogateid" / name,
                  inst.astype(np.uint16))
        onehot = np.eye(int(inst.max()) + 1, dtype=np.float32)[inst.reshape(-1)]
        grid = visualize_panoptic_outputs(
            out["rgb"], out["semantics"], onehot, out["depth"], None, None,
            None, h, w, thing_classes=scene.segmentation.fg_classes,
            visualize_entropy=False)
        save_image(output_dir / "vis" / name, grid)
    summary = {"num_frames": len(frames), "output_dir": str(output_dir)}
    print(json.dumps(summary))
    return summary


if __name__ == "__main__":
    main()
