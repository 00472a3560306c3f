"""The train cell of Panoptic Lifting's step: ``train/step.py::make_train_step``
under the linear-assignment instance loss (kind ``train.assign``).

The train driver (``drivers/train.py``) with three changes:
- a mix of 2 classes is labelled as the port's Messy Rooms reader labels
  its frames (``traffic/messy.py``: background confidence 1.0), any other
  as ``traffic/frames.py`` labels ScanNet's 21 (``labelling``);
- the checked steps record the program's match of each instance image
  (``Matches``: the port's ``losses/losses.py::hungarian`` wrapped while
  they run, never in the timed window);
- the reference (``reference/train.assign.py``) replays a recorded match
  wherever it costs, on the reference's own cost, within the reference's
  ``BAND`` of its optimum, and its own optimum elsewhere. The check adds
  ``assign_excess``: the worst excess of a match over the optimum, over
  the optimum's magnitude (``reference/train.assign.py::excess``), where
  the reference reports what it solved (its ``Step.assigned``).
"""
from __future__ import annotations

import time

import numpy as np
import torch

from benchmark.core import lookup
from benchmark.core import trace as tr
from benchmark.drivers import train as base
from benchmark.drivers.train import (LIMIT_KEYS, gaps, step_flops,  # noqa: F401
                                     worst)
from benchmark.traffic import frames, messy

KIND = "train.assign"


def labelling(mix: dict):
    """The module that makes and checks the mix's frames: Messy Rooms' for
    2 classes, else ``traffic/frames.py``."""
    return messy if mix["train"]["classes"] == 2 else frames


class TrainCell(base.TrainCell):
    """``drivers/train.py::TrainCell`` on frames labelled by ``labelling``:
    the shared set-up reads its frames, their counts and their labelling
    through its module name ``tf``, bound here for the set-up's length."""

    def __init__(self, spec: dict, mix: dict, seed: int, device,
                 grid_dim=None, mix_overrides=None, config_overrides=None):
        shared = base.tf
        base.tf = labelling({**mix, **(mix_overrides or {})})
        try:
            super().__init__(spec, mix, seed, device, grid_dim, mix_overrides,
                             config_overrides)
        finally:
            base.tf = shared


class Matches:
    """The program's matches while the checked steps run: the port's
    ``hungarian`` (module attribute of ``losses/losses.py``, which
    ``linear_assignment_loss`` calls) wrapped to keep each result, in call
    order."""

    def __init__(self):
        from contrastive_lift_tpu_torch.losses import losses
        self.losses, self.saved, self.kept = losses, losses.hungarian, []

    def __enter__(self):
        solve = self.saved

        def hungarian(cost):
            out = solve(cost)
            self.kept.append(np.array(out))
            return out
        self.losses.hungarian = hungarian
        return self

    def __exit__(self, *exc):
        self.losses.hungarian = self.saved
        return False


def steps_checked(cell: TrainCell, n: int) -> dict:
    """``drivers/train.py::steps_checked`` with each step's matches, one an
    instance image (``matches``)."""
    with Matches() as m:
        record = base.steps_checked(cell, n)
    per = cell.cfg.batch_size_contrastive
    if len(m.kept) != n * per:
        raise RuntimeError(f"{len(m.kept)} matches in {n} steps of {per} "
                           "instance images")
    record["matches"] = [m.kept[i * per:(i + 1) * per] for i in range(n)]
    return record


def replay(cell: TrainCell, record: dict, tf32: bool = False,
           flips=None, dtype=torch.float32, follow: bool = False) -> dict:
    """``drivers/train.py::replay``, each reference step given the
    recorded matches to follow where ``follow``; the replay's record adds
    ``assigned``: per step and instance image, (the cost the reference
    solved, its optimum, the match it used)."""
    dev = cell.device

    def cast(t):
        t = torch.as_tensor(t, device=dev)
        return t.to(dtype) if t.is_floating_point() else t
    ref = cell.ref
    step = ref.Step(cell.spec, cell.mix, cell.bounds, cell.grid_dim, dev,
                    dtype)
    params = ref.rebuild(cell.params, {p: cast(t)
                                       for p, t in record["p0"].items()})
    adam, losses, grads, ties, assigned = {}, [], None, [], []
    for i, (b, d) in enumerate(zip(record["batches"], record["draws"])):
        main, inst, seg = ({k: cast(v) for k, v in x.items()} for x in b)
        draws = {"main": cast(d.main.jitter), "coin": cast(d.main.coin),
                 "seg": cast(d.seg_jitter), "inst": cast(d.inst_jitter)}
        step.follow = record["matches"][i] if follow else None
        params, adam, l, g = step.run(params, adam,
                                      {"main": main, "inst": inst, "seg": seg},
                                      draws, cell.lr_scale, cell.lambda_dist,
                                      tf32=tf32,
                                      flip=(flips or {}).get(i, {}))
        losses.append(l)
        ties.append(step.ties)
        assigned.append(getattr(step, "assigned", []))
        if i == 0:
            grads = ref.norms(g)
    return {"losses": losses, "grads": grads, "p0": record["p0"],
            "p_end": dict(ref.leaves(params)), "ties": ties,
            "matches": [[m for _, _, m in a] for a in assigned],
            "assigned": assigned}


def replays(cell: TrainCell, record: dict):
    """``drivers/train.py::replays``: the reference's replay following the
    program's matches, and each other way of breaking the first two tied
    segment groups."""
    want = replay(cell, record, follow=True)
    tied = [(i, j, c) for i, t in enumerate(want["ties"]) for j, c in t][:2]
    out = [want]
    for mask in range(1, 1 << len(tied)):
        flips = {}
        for b, (i, j, c) in enumerate(tied):
            if mask >> b & 1:
                flips.setdefault(i, {})[j] = c
        out.append(replay(cell, record, flips=flips, follow=True))
    return out


def compare(got: dict, want: dict) -> dict:
    """``drivers/train.py::compare``, and ``assign_excess``: the worst
    excess of ``got``'s matches on ``want``'s costs."""
    nums = base.compare(got, want)
    solved = [(m, a) for ms, steps in zip(got["matches"], want["assigned"])
              for m, a in zip(ms, steps)]
    if solved:
        excess = lookup.kind_module(KIND, "reference").excess
        nums["assign_excess"] = max(excess(cost, m, optimum)
                                    for m, (cost, optimum, _) in solved)
    return nums


def closest(got: dict, wants: list):
    """(numbers, replay) of the replay in ``wants`` that ``got`` follows
    closest."""
    nums = [compare(got, w) for w in wants]
    k = min(range(len(wants)), key=lambda i: max(nums[i].values()))
    return nums[k], wants[k]


def rows_off(cell: TrainCell, record: dict) -> int:
    """The rows of the recorded batches that are not the frames' pixels with
    their labels (``labelling``'s ``RowCheck``)."""
    rc = labelling(cell.mix).RowCheck(cell.mix, cell.boxes, cell.layout,
                                      cell.device, cell.counts)
    cfg = cell.cfg
    return sum(rc.main(main)
               + rc.instance(inst, cfg.max_labels_per_image)
               + rc.segment(seg, cfg.batch_size_segments)
               for main, inst, seg in record["batches"])


def check(cell: TrainCell, record: dict):
    """(numbers, the reference's record) of the program's first steps, as
    ``drivers/train.py::check``, with ``assign_excess``."""
    nums, want = closest(record, replays(cell, record))
    return {**nums, "rows_off": rows_off(cell, record)}, want


def run(spec: dict, mix: dict, cell_name: str, seed: int, seconds: float,
        trace: bool, device, t_start: float, limits: dict,
        grid_dim=None, mix_overrides=None, config_overrides=None) -> dict:
    """One run of the cell: ``drivers/train.py::run`` with this kind's
    cell, checked steps and check."""
    cell = TrainCell(spec, mix, seed, device, grid_dim, mix_overrides,
                     config_overrides)
    record = steps_checked(cell, cell.mix["check"]["steps"])
    if device.type == "cuda":
        torch.cuda.synchronize()
    setup_s = time.perf_counter() - t_start
    steps = 0
    window = None

    def window_loop():
        nonlocal steps
        t0 = time.perf_counter()
        while time.perf_counter() - t0 < seconds:
            with torch.profiler.record_function("bench.train_step"):
                cell.one()
            steps += 1
        if device.type == "cuda":
            torch.cuda.synchronize()
        return time.perf_counter() - t0

    if trace:
        with tr.Window(torch) as window:
            elapsed = window_loop()
    else:
        elapsed = window_loop()
    peak = (torch.cuda.max_memory_allocated(device)
            if device.type == "cuda" else 0)
    cell.state = None                # the program's state, before the check
    numbers, _ = check(cell, record)
    correct = all(numbers[k] <= lim["limit"] for k, lim in limits.items())
    out = {"correct": correct, "attempted": steps, "failed": 0,
           "values": {"train_steps_per_s": steps / elapsed,
                      "setup_s": setup_s},
           "memory_peak_bytes": int(peak),
           "checks": {k: {"value": numbers[k], "limit": lim["limit"]}
                      for k, lim in limits.items()}}
    if trace:
        t = window.trace
        out["trace"] = t
        out["context"] = {"trace": t, "steps": steps,
                          "flops_per_step": step_flops(cell, record),
                          "peak_flops": base.fl.PEAK[cell.rcfg.head_dtype]}
    return out
