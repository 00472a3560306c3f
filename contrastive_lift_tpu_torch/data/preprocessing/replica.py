"""Replica ingestion: fold object-id renders to the scannet-reduced classes.
The port's copy of ``contrastive_lift_tpu/data/preprocessing/replica.py``.

  * ``info_semantic.json`` lists the scene's objects as {id, class_name};
    ``resources/replica_to_scannet_reduced.csv`` maps each Replica class
    name to a scannet-reduced class name, giving an object-id -> reduced
    class LUT;
  * GT comes as per-frame OBJECT-ID images; semantics = LUT[object_id] and
    instances keep the object id where the mapped class is a thing;
  * optional per-scene object-id fixes override single ids.

``preprocess_replica`` writes staged rs-semantic/instance folders and runs
the generic common-layout converter, so downstream CLIs see the same scene
layout as every other dataset family.
"""
from __future__ import annotations

import argparse
import json
from pathlib import Path
from typing import Dict, Optional

import numpy as np

from ...utils.png import read_png, write_png
from .m2f import RESOURCES, load_class_names, load_thing_flags


def build_replica_label_mapping(info_semantic_path,
                                sc_classes: str = "reduced",
                                resources_dir=None,
                                object_fixes: Optional[Dict[int, int]] = None,
                                max_objects: int = 300) -> np.ndarray:
    """Object-id -> scannet-<sc_classes> class LUT for one Replica scene.

    Reference: preprocess_replica.py:137-150 (get_replica_to_scannet).
    Unlisted classes/ids map to 0 (void). ``object_fixes`` overrides single
    object ids (the reference's scene_specific_fixes_objectid)."""
    root = Path(resources_dir) if resources_dir else RESOURCES
    classnames = load_class_names(sc_classes, resources_dir)
    name_to_reduced: Dict[str, int] = {}
    csv = (root / "replica_to_scannet_reduced.csv").read_text()
    for line in csv.strip().splitlines():
        cols = [c.strip() for c in line.split(",")]
        if len(cols) >= 2 and cols[1] in classnames:
            name_to_reduced[cols[0]] = classnames.index(cols[1])

    info = json.loads(Path(info_semantic_path).read_text())
    lut = np.zeros(max_objects, np.int64)
    for obj in info["objects"]:
        cls = name_to_reduced.get(obj["class_name"], 0)
        oid = int(obj["id"])
        if 0 <= oid < max_objects:
            lut[oid] = cls
    for oid, cls in (object_fixes or {}).items():
        lut[int(oid)] = int(cls)
    return lut


def fold_object_ids(object_ids: np.ndarray, lut: np.ndarray,
                    thing_flags) -> tuple:
    """(semantics, instances) from an object-id image.

    Instances keep the raw object id on thing pixels, 0 elsewhere
    (reference convert_from_semantics_and_instances_to_reduced,
    preprocess_replica.py:125-133). Ids outside the LUT (>= max_objects or
    negative — stray render values) fold to class 0 (void), not to whatever
    class the clipped boundary entry happens to hold."""
    oid = np.asarray(object_ids, np.int64)
    in_range = (oid >= 0) & (oid < len(lut))
    sem = np.where(in_range, lut[np.clip(oid, 0, len(lut) - 1)], 0)
    thing = np.asarray(thing_flags)[sem]
    inst = np.where(thing & in_range, oid, 0)
    return sem, inst


def preprocess_replica(frames_dir, pose_path, intrinsics_path,
                       object_id_dir, info_semantic_path, output_dir,
                       sc_classes: str = "reduced", m2f_dir=None,
                       object_fixes: Optional[Dict[int, int]] = None,
                       image_hw=None, test_fraction: float = 0.2,
                       subsample: int = 1) -> dict:
    """Full Replica drive: fold GT object ids -> common layout."""
    from .generic import preprocess_generic

    output_dir = Path(output_dir)
    lut = build_replica_label_mapping(info_semantic_path, sc_classes,
                                      object_fixes=object_fixes)
    thing_flags = load_thing_flags(sc_classes)
    classnames = load_class_names(sc_classes)
    stage_sem = output_dir / "staged_rs_semantics"
    stage_inst = output_dir / "staged_rs_instance"
    stage_sem.mkdir(parents=True, exist_ok=True)
    stage_inst.mkdir(parents=True, exist_ok=True)
    for p in sorted(Path(object_id_dir).iterdir()):
        if p.suffix.lower() != ".png":
            continue
        obj = read_png(p).astype(np.int64)
        sem, inst = fold_object_ids(obj, lut, thing_flags)
        write_png(stage_sem / p.name, sem.astype(np.uint8))
        write_png(stage_inst / p.name, inst.astype(np.uint16))

    thing_classes = [i for i, t in enumerate(thing_flags) if t]
    return preprocess_generic(
        frames_dir, pose_path, intrinsics_path, output_dir,
        gt_semantics_dir=stage_sem, gt_instance_dir=stage_inst,
        m2f_dir=m2f_dir, num_classes=len(classnames),
        thing_classes=thing_classes, image_hw=image_hw,
        test_fraction=test_fraction, subsample=subsample)


def main(argv=None):
    parser = argparse.ArgumentParser(description=__doc__)
    parser.add_argument("--frames_dir", required=True)
    parser.add_argument("--pose_path", required=True)
    parser.add_argument("--intrinsics_path", required=True)
    parser.add_argument("--object_id_dir", required=True)
    parser.add_argument("--info_semantic", required=True)
    parser.add_argument("--output_dir", required=True)
    parser.add_argument("--m2f_dir", default=None)
    parser.add_argument("--sc_classes", default="reduced")
    parser.add_argument("--subsample", type=int, default=1)
    args = parser.parse_args(argv)
    print(preprocess_replica(
        args.frames_dir, args.pose_path, args.intrinsics_path,
        args.object_id_dir, args.info_semantic, args.output_dir,
        args.sc_classes, args.m2f_dir, subsample=args.subsample))


if __name__ == "__main__":
    main()
