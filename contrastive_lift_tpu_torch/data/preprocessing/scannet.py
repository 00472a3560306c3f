"""ScanNet -> common layout preprocessing script: the port's copy of
``contrastive_lift_tpu/data/preprocessing/scannet.py``.

Pipeline:
  1. stream the .sens container (color jpeg + zlib depth + poses +
     intrinsics), decoding every streamed frame to score its blur;
  2. blur-scored keyframe subsampling;
  3. fold raw ScanNet semantic ids -> the reduced class set, mark
     thing/stuff;
  4. renumber GT instances densely and consistently;
  5. write color/pose/intrinsic/rs_*/m2f_* folders + splits.json +
     segmentation_data.pkl via SceneWriter.

Colour is resized as PIL's LANCZOS, labels as PIL's NEAREST in mode I
(int32, so raw ids above 255 survive) and depth in mode F
(``utils/image.py``). Machine labels (Mask2Former panoptic output) are
ingested from per-frame npz files {semantics, instance, probability,
confidence}, or converted from raw panoptic dumps (``--panoptic_dir``,
``m2f.py``).
"""
from __future__ import annotations

import argparse
import json
from pathlib import Path
from typing import Dict, Optional

import numpy as np

from ...utils.image import resize_lanczos_uint8, resize_nearest
from ...utils.png import read_png
from .common import (SceneWriter, blur_score, fold_semantics,
                     renumber_instances, save_id_image, select_keyframes)
from .sens_reader import iter_frames

# Reduced indoor class set used for ScanNet-style scenes. Index 0 is void.
# Thing/stuff flags follow the usual indoor panoptic convention (structural
# surfaces are stuff, movable objects are things).
REDUCED_CLASSES = [
    ("void", False), ("wall", False), ("floor", False), ("ceiling", False),
    ("chair", True), ("table", True), ("sofa", True), ("bed", True),
    ("cabinet", True), ("shelf", True), ("desk", True), ("door", False),
    ("window", False), ("curtain", False), ("refrigerator", True),
    ("television", True), ("toilet", True), ("sink", True), ("bathtub", True),
    ("bag", True), ("other", True),
]


def reduced_thing_flags():
    return [is_thing for _, is_thing in REDUCED_CLASSES]


def reduced_class_names():
    return [name for name, _ in REDUCED_CLASSES]


def load_raw_to_reduced(mapping_path: Optional[str]) -> Dict[int, int]:
    """Raw ScanNet id -> reduced id mapping from a JSON/TSV file.

    ScanNet's label ids come from its label_mapping tsv; ship the mapping as a
    sidecar file rather than hardcoding hundreds of ids.
    """
    if mapping_path is None:
        return {}
    path = Path(mapping_path)
    if path.suffix == ".json":
        raw = json.loads(path.read_text())
        return {int(k): int(v) for k, v in raw.items()}
    mapping = {}
    for line in path.read_text().splitlines():
        if not line.strip() or line.startswith("#"):
            continue
        src, dst = line.split()[:2]
        mapping[int(src)] = int(dst)
    return mapping


def preprocess_scannet(sens_path, output_dir, label_dir=None, m2f_dir=None,
                       label_mapping=None, frame_skip: int = 10,
                       keyframe_window: int = 4, image_hw=(480, 640),
                       test_fraction: float = 0.2,
                       panoptic_dir=None, coco_remap: bool = False) -> dict:
    """Convert one ScanNet scene. Returns a summary dict."""
    writer = SceneWriter(output_dir)
    mapping = load_raw_to_reduced(label_mapping)
    thing_flags = reduced_thing_flags()
    thing_classes = {i for i, t in enumerate(thing_flags) if t}
    h, w = image_hw

    # pass 1: stream frames, score blur, keep the sharpest per window
    frames = []
    header = None
    for idx, header, frame in iter_frames(sens_path, frame_skip=frame_skip):
        rgb = frame.color_image()
        frames.append((idx, frame, blur_score(rgb[::4, ::4])))
    if not frames:
        raise ValueError("no frames in .sens")
    keep = select_keyframes([f[2] for f in frames], window=keyframe_window)
    kept = [frames[i][:2] for i in keep]

    # intrinsics scaled to the target resolution
    intr = header.intrinsic_color.copy()
    scale = np.diag([w / header.color_width, h / header.color_height, 1, 1])
    writer.write_intrinsics(scale @ intr)

    names = []
    gt_instances, gt_semantics = [], []
    for idx, frame in kept:
        name = str(idx)
        rgb = resize_lanczos_uint8(frame.color_image(), (h, w))
        depth = frame.depth_image(header)
        sem = inst = None
        if label_dir is not None:
            sem_raw = read_png(Path(label_dir) / f"{idx}_sem.png")
            inst_raw = read_png(Path(label_dir) / f"{idx}_inst.png")
            sem = fold_semantics(sem_raw, mapping) if mapping else sem_raw
            # nearest-resize as int32 (PIL's mode I): raw ScanNet label and
            # instance ids exceed 255 and a uint8 staging cast would wrap
            sem = resize_nearest(sem.astype(np.int32), (h, w))
            inst = resize_nearest(inst_raw.astype(np.int32), (h, w))
            gt_semantics.append(sem)
            gt_instances.append(inst)
        if m2f_dir is not None:
            m2f = np.load(Path(m2f_dir) / f"{idx}.npz")
            m2f_sem = m2f["semantics"]
            m2f_inst = m2f["instance"]
            probs = m2f["probability"]
            conf = m2f["confidence"]
        else:  # no machine labels: fall back to GT (rs-supervised training)
            num_c = len(REDUCED_CLASSES)
            m2f_sem = sem if sem is not None else np.zeros((h, w), np.uint8)
            m2f_inst = inst if inst is not None else np.zeros((h, w), np.uint8)
            probs = np.eye(num_c, dtype=np.float32)[m2f_sem]
            conf = np.ones((h, w), np.float32)
        writer.add_frame(
            name, rgb, frame.camera_to_world, m2f_sem, m2f_inst, probs, conf,
            gt_semantics=sem, gt_instance=inst, segments=m2f_inst,
            depth=resize_nearest(depth, (h, w)))
        names.append(name)

    if gt_instances:
        renumbered, inst_to_sem = renumber_instances(
            gt_instances, gt_semantics, thing_classes)
        for name, inst in zip(names, renumbered):
            # scene-wide renumbered ids can exceed 255 — widen, don't wrap
            save_id_image(inst, writer.root / "rs_instance" / f"{name}.png")
    else:
        inst_to_sem = {0: 0}

    split_at = int(len(names) * (1 - test_fraction))
    writer.write_splits(names[:split_at], names[split_at:])
    writer.write_segmentation_data(
        fg_classes=sorted(thing_classes),
        bg_classes=sorted(set(range(len(REDUCED_CLASSES))) - thing_classes),
        instance_to_semantics=inst_to_sem)
    if panoptic_dir is not None:
        # raw Mask2Former panoptic dumps -> m2f_* machine labels (replaces
        # the placeholder m2f folders written above)
        from .m2f import map_panoptic_outputs
        map_panoptic_outputs(writer.root, panoptic_dir,
                             use_coco_remap=coco_remap, frame_names=names)
    return {"frames": len(names), "output": str(writer.root)}


def main(argv=None):
    parser = argparse.ArgumentParser(description=__doc__)
    parser.add_argument("--sens_path", required=True)
    parser.add_argument("--output_dir", required=True)
    parser.add_argument("--label_dir", default=None,
                        help="per-frame <idx>_sem.png / <idx>_inst.png GT labels")
    parser.add_argument("--m2f_dir", default=None,
                        help="per-frame <idx>.npz machine labels")
    parser.add_argument("--label_mapping", default=None)
    parser.add_argument("--frame_skip", type=int, default=10)
    parser.add_argument("--panoptic_dir", default=None,
                        help="raw Mask2Former panoptic dumps "
                             "(<idx>.ptz/.pt/.npz) to convert to m2f_*")
    parser.add_argument("--coco_remap", action="store_true",
                        help="fold COCO category names via the shipped csv")
    args = parser.parse_args(argv)
    print(preprocess_scannet(args.sens_path, args.output_dir, args.label_dir,
                             args.m2f_dir, args.label_mapping, args.frame_skip,
                             panoptic_dir=args.panoptic_dir,
                             coco_remap=args.coco_remap))


if __name__ == "__main__":
    main()
