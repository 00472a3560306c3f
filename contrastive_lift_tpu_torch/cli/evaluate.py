"""Evaluate CLI: folder-vs-folder mIoU + PQ^scene, the port's
``contrastive_lift_tpu/cli/evaluate.py``.

Usage:
    python -m contrastive_lift_tpu_torch.cli.evaluate --root_path SCENE \
        --exp_path PRED [--image_size H W] [--things ...] [--stuff ...]

Reads the GT of SCENE (PanopLi ``rs_semantics``/``rs_instance`` PNGs or MOS
``semantic``/``instance`` npys) and the predictions of PRED
(``pred_semantics``, ``pred_surrogateid``), prints the scores as JSON and
writes them to ``PRED/metrics.txt``. It runs on the host.
"""
from __future__ import annotations

import argparse
import json
import pickle
from pathlib import Path

from ..inference.evaluate import evaluate_folders


def main(argv=None):
    parser = argparse.ArgumentParser(description=__doc__)
    parser.add_argument("--root_path", required=True,
                        help="dataset root with rs_semantics/rs_instance GT folders")
    parser.add_argument("--exp_path", required=True,
                        help="prediction dir with pred_semantics/pred_surrogateid")
    parser.add_argument("--image_size", type=int, nargs=2, default=[512, 512])
    parser.add_argument("--things", type=int, nargs="*", default=None,
                        help="thing class ids (default: from segmentation_data.pkl)")
    parser.add_argument("--stuff", type=int, nargs="*", default=None)
    args = parser.parse_args(argv)

    root = Path(args.root_path)
    exp = Path(args.exp_path)
    if args.things is not None:
        things = set(args.things)
        stuff = set(args.stuff or [])
    elif (root / "segmentation_data.pkl").exists():
        with open(root / "segmentation_data.pkl", "rb") as f:
            seg = pickle.load(f)
        things = set(seg["fg_classes"]) - {0}
        stuff = set(seg["bg_classes"]) - {0}
    else:  # MOS layout: two classes, fg=1
        things, stuff = {1}, {0}

    image_size = tuple(args.image_size)
    metrics = evaluate_folders(exp, root, things, stuff, image_size)
    iou, pq, sq, rq = metrics["iou"], metrics["pq"], metrics["sq"], metrics["rq"]
    result = {"iou": iou, "pq_scene": pq, "sq_scene": sq, "rq_scene": rq}
    print(json.dumps(result, indent=2))
    (exp / "metrics.txt").write_text(
        f"iou: {iou}\npq: {pq}\nsq: {sq}\nrq: {rq}\n")
    return result


if __name__ == "__main__":
    main()
