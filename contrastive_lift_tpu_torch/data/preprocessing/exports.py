"""Baseline-export dumps: converted scenes -> other papers' input layouts.
The port's copy of ``contrastive_lift_tpu/data/preprocessing/exports.py``.

Capability match for the reference's one-time export utilities
(reference: dataset/preprocessing/preprocess_scannet.py:825-930,
preprocess_replica.py:187-330): the dm-nerf combined semantic-instance
masks, the semantic-NeRF ``Sequence_1`` layout, and the Replica
``traj_w_c.txt`` trajectory format. These exist so the reference's baselines
(dm-nerf, semantic-NeRF, mmdet-style evaluators) can train on the same
converted scenes; they write files only, no compute path.
"""
from __future__ import annotations

import argparse
import json
import pickle
import shutil
from pathlib import Path
from typing import Dict

import numpy as np

from ...utils.png import read_png, write_png
from .common import numeric_stem_key
from .m2f import load_thing_flags


def dmnerf_instance_map(semantics: np.ndarray, instance: np.ndarray,
                        stuff_classes, i2s: Dict[int, int]) -> np.ndarray:
    """One frame -> dm-nerf combined map (vectorized LUT form of the
    reference's per-class loop, preprocess_scannet.py:839-855): stuff pixels
    get their class's index within ``stuff_classes``; thing pixels with a
    nonzero instance id get len(stuff_classes) + id."""
    stuff_classes = list(stuff_classes)
    max_c = int(semantics.max()) + 1
    stuff_lut = np.full(max(max_c, max(stuff_classes) + 1), -1, np.int64)
    for idx, c in enumerate(stuff_classes):
        stuff_lut[c] = idx
    stuff_idx = stuff_lut[semantics]
    is_stuff = stuff_idx >= 0
    out = np.zeros_like(instance)
    out[is_stuff] = stuff_idx[is_stuff]
    thing = (~is_stuff) & (instance != 0)
    out[thing] = len(stuff_classes) + instance[thing]
    for idx, c in enumerate(stuff_classes):
        if np.any(stuff_idx == idx):
            i2s[idx] = int(c)
    if thing.any():
        pairs = np.unique(np.stack([instance[thing], semantics[thing]]),
                          axis=1)
        for u, c in pairs.T:
            i2s[len(stuff_classes) + int(u)] = int(c)
    return out


def create_instances_for_dmnerf(scene_dir, correspondences: bool = False,
                                class_set: str = "reduced") -> Path:
    """m2f semantic+instance folders -> m2f_notta_dmnerf* combined masks +
    dmnerf_i2s*.pkl (reference preprocess_scannet.py:825-856)."""
    scene_dir = Path(scene_dir)
    suffix_o = "_no_correspondences" if not correspondences else ""
    suffix_i = "_correspondences" if correspondences else ""
    sem_dir = scene_dir / "m2f_notta_semantics"
    inst_dir = scene_dir / f"m2f_notta_instance{suffix_i}"
    out_dir = scene_dir / f"m2f_notta_dmnerf{suffix_o}"
    if out_dir.exists():
        shutil.rmtree(out_dir)
    out_dir.mkdir()
    thing_flags = load_thing_flags(class_set)
    stuff_classes = [i for i, t in enumerate(thing_flags) if not t]
    i2s: Dict[int, int] = {}
    for f in sorted(sem_dir.iterdir()):
        sem = read_png(f).astype(np.int64)
        inst = read_png(inst_dir / f.name).astype(np.int64)
        combined = dmnerf_instance_map(sem, inst, stuff_classes, i2s)
        write_png(out_dir / f.name, combined.astype(np.uint16))
    with open(scene_dir / f"dmnerf_i2s{suffix_o}.pkl", "wb") as fh:
        pickle.dump(i2s, fh)
    return out_dir


def write_replica_traj(scene_dir, pose_subdir: str = "pose",
                       out_name: str = "traj_w_c.txt",
                       out_path=None) -> Path:
    """pose/*.txt -> one row-major 4x4-per-line trajectory file
    (reference preprocess_scannet.py:858-865). Writes to ``out_path`` when
    given (exports must not mutate the source scene layout), else next to
    the poses."""
    scene_dir = Path(scene_dir)
    poses = sorted((scene_dir / pose_subdir).iterdir(),
                   key=lambda x: numeric_stem_key(x.stem))
    lines = []
    for pf in poses:
        rt = np.loadtxt(pf).reshape(4, 4)
        lines.append(" ".join(f"{v:.18g}" for v in rt[:3].ravel())
                     + " 0.00 0.00 0.00 1.00")
    out = Path(out_path) if out_path is not None else scene_dir / out_name
    out.write_text("\n".join(lines) + "\n")
    return out


def export_for_semantic_nerf(scene_dir, out_dir) -> Path:
    """Converted scene -> semantic-NeRF ``Sequence_1`` layout: rgb/ +
    splits.json (zero-padded names) + intrinsic + traj_w_c.txt
    (reference preprocess_scannet.py:888-910)."""
    scene_dir, out_dir = Path(scene_dir), Path(out_dir)
    if out_dir.exists():
        shutil.rmtree(out_dir)
    (out_dir / "rgb").mkdir(parents=True)
    splits = json.loads((scene_dir / "splits.json").read_text())
    for split in ("train", "val"):
        if split in splits:
            splits[split] = [f"{int(x):04d}" if str(x).isdecimal() else x
                             for x in splits[split]]
    (out_dir / "splits.json").write_text(json.dumps(splits))
    intr = scene_dir / "intrinsic" / "intrinsic_color.txt"
    if intr.exists():
        shutil.copyfile(intr, out_dir / "intrinsic_color.txt")
    write_replica_traj(scene_dir, out_path=out_dir / "traj_w_c.txt")
    for f in sorted((scene_dir / "color").iterdir()):
        stem = f"{int(f.stem):04d}" if f.stem.isdecimal() else f.stem
        shutil.copyfile(f, out_dir / "rgb" / f"{stem}{f.suffix}")
    depth = scene_dir / "depth"
    if depth.exists():
        shutil.copytree(depth, out_dir / "depth", dirs_exist_ok=True)
    return out_dir


def main(argv=None):
    parser = argparse.ArgumentParser(description=__doc__)
    parser.add_argument("--scene_dir", required=True)
    parser.add_argument("--mode", choices=["dmnerf", "semantic_nerf", "traj"],
                        required=True)
    parser.add_argument("--out_dir", default=None)
    parser.add_argument("--correspondences", action="store_true")
    parser.add_argument("--class_set", default="reduced")
    args = parser.parse_args(argv)
    if args.mode == "dmnerf":
        print(create_instances_for_dmnerf(args.scene_dir,
                                          args.correspondences,
                                          args.class_set))
    elif args.mode == "semantic_nerf":
        out = args.out_dir or (Path(args.scene_dir) / "export_semantic_nerf"
                               / "Sequence_1")
        print(export_for_semantic_nerf(args.scene_dir, out))
    else:
        print(write_replica_traj(args.scene_dir))


if __name__ == "__main__":
    main()
