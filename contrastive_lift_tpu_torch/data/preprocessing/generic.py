"""Generic frames+poses -> common layout converter (Replica / in-the-wild):
the port's copy of ``contrastive_lift_tpu/data/preprocessing/generic.py``.

Replica renders and in-the-wild captures both reduce to: a directory of RGB
frames (PNG or JPEG, any size), per-frame 4x4 cam2world poses (one txt
each, or one json list), a shared pinhole intrinsic, and optional GT /
Mask2Former label directories. Frames are resized as PIL's LANCZOS and
labels and invalid masks as PIL's NEAREST (``utils/image.py``).
"""
from __future__ import annotations

import argparse
import json
from pathlib import Path
from typing import Optional

import numpy as np

from ...utils.image import (image_palette, image_size, read_image,
                             resize_pil)
from .common import (SceneWriter, fold_semantics, numeric_stem_key,
                     renumber_instances, save_id_image)


def _load_poses(pose_path: Path, names):
    if pose_path.is_dir():
        return [np.loadtxt(pose_path / f"{n}.txt") for n in names]
    data = json.loads(pose_path.read_text())
    poses = data["poses"] if isinstance(data, dict) else data
    return [np.asarray(p, np.float64) for p in poses]


def preprocess_generic(frames_dir, pose_path, intrinsics_path, output_dir,
                       gt_semantics_dir=None, gt_instance_dir=None,
                       m2f_dir=None, num_classes: Optional[int] = None,
                       thing_classes=(), label_mapping: Optional[dict] = None,
                       image_hw=None, test_fraction: float = 0.2,
                       subsample: int = 1, invalid_dir=None) -> dict:
    frames_dir = Path(frames_dir)
    names = sorted([p.stem for p in frames_dir.iterdir()
                    if p.suffix.lower() in (".jpg", ".png", ".jpeg")],
                   key=numeric_stem_key)[::subsample]
    poses = _load_poses(Path(pose_path), names)
    intr = np.loadtxt(intrinsics_path)
    if intr.shape == (3, 3):
        intr4 = np.eye(4)
        intr4[:3, :3] = intr
        intr = intr4

    w0, h0 = image_size(next(frames_dir.glob(f"{names[0]}.*")))
    h, w = image_hw or (h0, w0)
    writer = SceneWriter(output_dir)
    scale = np.diag([w / w0, h / h0, 1, 1])
    writer.write_intrinsics(scale @ intr)

    thing_classes = set(int(t) for t in thing_classes)
    gt_sems, gt_insts = [], []
    for name, pose in zip(names, poses):
        frame = next(frames_dir.glob(f"{name}.*"))
        # PIL resizes a palette frame's indices NEAREST
        rgb = resize_pil(read_image(frame), (h, w),
                         lanczos=image_palette(frame) is None)[..., :3]
        sem = inst = None
        if gt_semantics_dir is not None:
            sem = resize_pil(read_image(Path(gt_semantics_dir) / f"{name}.png"),
                             (h, w), lanczos=False).astype(np.int64)
            if label_mapping:
                sem = fold_semantics(sem, label_mapping)
            gt_sems.append(sem)
        if gt_instance_dir is not None:
            inst = resize_pil(read_image(Path(gt_instance_dir) / f"{name}.png"),
                              (h, w), lanczos=False).astype(np.int64)
            gt_insts.append(inst)
        if m2f_dir is not None:
            m2f = np.load(Path(m2f_dir) / f"{name}.npz")
            m2f_sem, m2f_inst = m2f["semantics"], m2f["instance"]
            probs, conf = m2f["probability"], m2f["confidence"]
        else:
            nc = num_classes or (int(max(s.max() for s in gt_sems)) + 1
                                 if gt_sems else 2)
            m2f_sem = sem if sem is not None else np.zeros((h, w), np.int64)
            m2f_inst = inst if inst is not None else np.zeros((h, w), np.int64)
            probs = np.eye(nc, dtype=np.float32)[m2f_sem]
            conf = np.ones((h, w), np.float32)
        invalid = None
        if invalid_dir is not None:
            # per-frame invalid masks (fisheye undistortion dead zones,
            # itw.py)
            mask_path = Path(invalid_dir) / f"{name}.png"
            if mask_path.exists():
                invalid = resize_pil(read_image(mask_path), (h, w),
                                     lanczos=False) > 0
        writer.add_frame(name, rgb, pose, m2f_sem, m2f_inst, probs, conf,
                         gt_semantics=sem, gt_instance=inst,
                         segments=m2f_inst, invalid=invalid)

    inst_to_sem = {0: 0}
    if gt_insts and gt_sems:
        renumbered, inst_to_sem = renumber_instances(gt_insts, gt_sems,
                                                     thing_classes)
        for name, inst in zip(names, renumbered):
            # scene-wide renumbered ids can exceed 255 — widen, don't wrap
            # (this write replaces the staged gt_instance SceneWriter wrote)
            save_id_image(inst, writer.root / "rs_instance" / f"{name}.png")

    split_at = int(len(names) * (1 - test_fraction))
    writer.write_splits(names[:split_at], names[split_at:])
    all_classes = set(range(num_classes)) if num_classes else (
        thing_classes | {0})
    writer.write_segmentation_data(
        fg_classes=sorted(thing_classes),
        bg_classes=sorted(all_classes - thing_classes),
        instance_to_semantics=inst_to_sem)
    return {"frames": len(names), "output": str(writer.root)}


def main(argv=None):
    parser = argparse.ArgumentParser(description=__doc__)
    parser.add_argument("--frames_dir", required=True)
    parser.add_argument("--pose_path", required=True)
    parser.add_argument("--intrinsics_path", required=True)
    parser.add_argument("--output_dir", required=True)
    parser.add_argument("--gt_semantics_dir", default=None)
    parser.add_argument("--gt_instance_dir", default=None)
    parser.add_argument("--m2f_dir", default=None)
    parser.add_argument("--num_classes", type=int, default=None)
    parser.add_argument("--thing_classes", type=int, nargs="*", default=[])
    parser.add_argument("--subsample", type=int, default=1)
    args = parser.parse_args(argv)
    print(preprocess_generic(
        args.frames_dir, args.pose_path, args.intrinsics_path, args.output_dir,
        args.gt_semantics_dir, args.gt_instance_dir, args.m2f_dir,
        args.num_classes, args.thing_classes, subsample=args.subsample))


if __name__ == "__main__":
    main()
