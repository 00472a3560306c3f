"""HyperSim -> common layout (HDF5 scene captures): the port's copy of
``contrastive_lift_tpu/data/preprocessing/hypersim.py``.

HyperSim ships per-frame HDF5 files (tonemapped color, semantic + instance
ids, depth as distance-to-center) and a per-scene camera CSV. Needs h5py,
imported inside ``preprocess_hypersim``: a host without it raises
``ModuleNotFoundError`` there and nowhere else.
"""
from __future__ import annotations

import argparse
from pathlib import Path

import numpy as np

from .common import SceneWriter, renumber_instances, save_id_image

# HyperSim uses NYU40 ids; the usual thing subset for panoptic evaluation
NYU40_THING_IDS = {3, 4, 5, 6, 7, 10, 12, 14, 24, 25, 32, 33, 34, 35, 36, 37,
                   38, 39, 40}


def _tonemap(rgb_hdr: np.ndarray, gamma: float = 1.0 / 2.2,
             percentile: float = 90, target: float = 0.8) -> np.ndarray:
    """HyperSim's scale-to-percentile tonemap -> uint8."""
    brightness = (0.3 * rgb_hdr[..., 0] + 0.59 * rgb_hdr[..., 1]
                  + 0.11 * rgb_hdr[..., 2])
    ref = np.percentile(brightness, percentile)
    scale = (target ** (1 / gamma)) / max(ref, 1e-8)
    out = np.clip((scale * rgb_hdr) ** gamma, 0, 1)
    return (out * 255).astype(np.uint8)


def preprocess_hypersim(scene_dir, output_dir, cam: str = "cam_00",
                        image_hw=(768, 1024), test_fraction: float = 0.2,
                        subsample: int = 1) -> dict:
    import h5py  # only this script needs it

    scene_dir = Path(scene_dir)
    img_dir = scene_dir / "images" / f"scene_{cam}_final_hdf5"
    geo_dir = scene_dir / "images" / f"scene_{cam}_geometry_hdf5"
    frame_ids = sorted(int(p.stem.split(".")[1]) for p in
                       img_dir.glob("frame.*.color.hdf5"))[::subsample]

    # camera poses from the scene's per-frame camera files
    detail = scene_dir / "_detail" / cam
    positions = np.array(h5py.File(detail / "camera_keyframe_positions.hdf5")["dataset"])
    orientations = np.array(h5py.File(detail / "camera_keyframe_orientations.hdf5")["dataset"])
    meters_per_unit = 1.0
    scale_file = scene_dir / "_detail" / "metadata_scene.csv"
    if scale_file.exists():
        for line in scale_file.read_text().splitlines():
            if "meters_per_asset_unit" in line:
                meters_per_unit = float(line.split(",")[-1])

    h, w = image_hw
    # HyperSim uses a unit-focal camera model scaled by image size (fov ~ 60deg
    # horizontal by default)
    fov_x = np.pi / 3
    fx = w / (2 * np.tan(fov_x / 2))
    intr = np.eye(4)
    intr[0, 0] = fx
    intr[1, 1] = fx
    intr[0, 2] = w / 2
    intr[1, 2] = h / 2
    writer = SceneWriter(output_dir)
    writer.write_intrinsics(intr)

    names, gt_sems, gt_insts = [], [], []
    flip = np.diag([1.0, -1.0, -1.0])  # hypersim looks down -z
    for fid in frame_ids:
        name = f"{fid:04d}"
        rgb_hdr = np.array(h5py.File(
            img_dir / f"frame.{fid:04d}.color.hdf5")["dataset"])
        rgb = _tonemap(rgb_hdr)
        sem = np.array(h5py.File(
            geo_dir / f"frame.{fid:04d}.semantic.hdf5")["dataset"]).astype(np.int64)
        inst = np.array(h5py.File(
            geo_dir / f"frame.{fid:04d}.semantic_instance.hdf5")["dataset"]).astype(np.int64)
        sem[sem < 0] = 0
        inst[inst < 0] = 0
        pose = np.eye(4)
        pose[:3, :3] = orientations[fid] @ flip
        pose[:3, 3] = positions[fid] * meters_per_unit
        num_c = 41
        probs = np.eye(num_c, dtype=np.float32)[np.clip(sem, 0, num_c - 1)]
        writer.add_frame(name, rgb, pose, sem, inst, probs,
                         np.ones(sem.shape, np.float32),
                         gt_semantics=sem, gt_instance=inst, segments=inst)
        names.append(name)
        gt_sems.append(sem)
        gt_insts.append(inst)

    renumbered, inst_to_sem = renumber_instances(gt_insts, gt_sems,
                                                 NYU40_THING_IDS)
    for name, inst in zip(names, renumbered):
        # scene-wide renumbered ids can exceed 255 — widen, don't wrap
        save_id_image(inst, writer.root / "rs_instance" / f"{name}.png")
    split_at = int(len(names) * (1 - test_fraction))
    writer.write_splits(names[:split_at], names[split_at:])
    writer.write_segmentation_data(
        fg_classes=sorted(NYU40_THING_IDS),
        bg_classes=sorted(set(range(41)) - NYU40_THING_IDS),
        instance_to_semantics=inst_to_sem)
    return {"frames": len(names), "output": str(writer.root)}


def main(argv=None):
    parser = argparse.ArgumentParser(description=__doc__)
    parser.add_argument("--scene_dir", required=True)
    parser.add_argument("--output_dir", required=True)
    parser.add_argument("--cam", default="cam_00")
    parser.add_argument("--subsample", type=int, default=1)
    args = parser.parse_args(argv)
    print(preprocess_hypersim(args.scene_dir, args.output_dir, args.cam,
                              subsample=args.subsample))


if __name__ == "__main__":
    main()
