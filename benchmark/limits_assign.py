"""Readings of a linear-assignment train cell's match, beside ``limits.py``.

    python3 benchmark/limits_assign.py --workload mos.train_fixed --seeds 1 2 3

For each seed: the program's first steps and the check of them, with the
images whose program match is not the reference's own optimum (on the
labels present), which the reference replays where they lie within its
``BAND`` (``followed``); then, on the first ``--fault-seeds`` seeds, the
same steps with the program's Hungarian solve replaced by a wrong match:
``rolled`` (each label's match moved one channel over) and ``identity``
(label i to channel i). Prints one JSON line a seed and reading.
``limits.py`` gives the TF32 control and the other faults.
"""
from __future__ import annotations

import argparse
import json
import sys
import time
from pathlib import Path

import numpy as np

ROOT = Path(__file__).resolve().parents[1]
FAULTS = ("rolled", "identity")


def wrong(fault: str, solve, channels: int):
    """A stand-in for the port's Hungarian solve ``solve`` that returns a
    wrong match: ``rolled`` or ``identity``."""
    if fault not in FAULTS:
        raise ValueError(fault)

    def stand_in(cost):
        if fault == "rolled":
            return (solve(cost) + 1) % channels
        return np.arange(np.asarray(cost).shape[0])
    return stand_in


def followed(record: dict, want: dict) -> int:
    """The images whose recorded match differs, on the labels present,
    from the reference's own optimum."""
    return sum(bool((m != opt)[cost[:, 0] < 1e6].any())
               for ms, a in zip(record["matches"], want["assigned"])
               for m, (cost, opt, _) in zip(ms, a))


def readings(cell_name: str, seeds, fault_seeds: int, device):
    """Yield (seed, what, numbers)."""
    from benchmark import run
    from benchmark.core import lookup
    from contrastive_lift_tpu_torch.losses import losses
    bench = run.load_json(ROOT / "BENCHMARK.json")
    _, spec, mix, _ = run.cell_spec(cell_name, bench)
    td = lookup.kind_module(mix["kind"], "drivers")
    n, channels = mix["check"]["steps"], spec["model"]["instance_out"]
    for i, seed in enumerate(seeds):
        cell = td.TrainCell(spec, mix, seed, device)
        record = td.steps_checked(cell, n)
        cell.state = None
        nums, want = td.check(cell, record)
        yield seed, "program", {**nums, "followed": followed(record, want),
                                "images": sum(map(len, record["matches"]))}
        if i >= fault_seeds:
            continue
        for fault in FAULTS:
            cell = td.TrainCell(spec, mix, seed, device)
            solve = losses.hungarian
            losses.hungarian = wrong(fault, solve, channels)
            try:
                rec = td.steps_checked(cell, n)
            finally:
                losses.hungarian = solve
            cell.state = None
            yield seed, fault, td.check(cell, rec)[0]


def main(argv=None) -> int:
    p = argparse.ArgumentParser()
    p.add_argument("--workload", required=True)
    p.add_argument("--seeds", type=int, nargs="+", required=True)
    p.add_argument("--fault-seeds", type=int, default=3)
    args = p.parse_args(argv)
    sys.path.insert(0, str(ROOT))
    import torch
    if not torch.cuda.is_available():
        print("needs a CUDA device", file=sys.stderr)
        return 1
    t0 = time.perf_counter()
    for seed, what, nums in readings(args.workload, args.seeds,
                                     args.fault_seeds,
                                     torch.device("cuda", 0)):
        print(json.dumps({"workload": args.workload, "seed": seed,
                          "render": what, **nums,
                          "seconds": time.perf_counter() - t0}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
