"""Readings that a cell's limits are set from.

    python3 benchmark/limits.py --workload CELL --seeds 1 2 3 --calls 2

For each seed: the cell's set-up, ``--calls`` calls at the cell's own size
and chunk, the seeded sample of their rays as a run keeps it, and then the
per-ray gaps of three renders against the float32 reference (TF32 off):
the program's maps (the lower reading), the reference in TF32 (the control:
the nearest precision below the configuration's float32) and the reference
with bfloat16 heads. Prints one JSON line a seed and render: quantiles of
each map's gaps and the share of rays over each of a ladder of ``tau``.

For a train cell: the program's first steps against the reference's replay
of them (the lower reading; beside it each number's median over its leaves,
the reference's second replay and its float64 replay against its first),
the reference in TF32 in the program's place (the control) and, on the
first ``--fault-seeds`` seeds, the program with a fault planted: half of
the main batch left out (the mean over the rest) and the rendered rgb
altered where ``render_rays`` produces it. A state
left unchanged reads 1 on ``change`` and needs no run.
"""
from __future__ import annotations

import argparse
import json
import sys
import time
from pathlib import Path

import numpy as np

ROOT = Path(__file__).resolve().parents[1]
TAUS = (1e-6, 3e-6, 1e-5, 3e-5, 1e-4, 3e-4, 1e-3, 3e-3, 1e-2, 3e-2)
QUANTILES = (0.5, 0.9, 0.99, 0.999, 1.0)


def summarise(g: dict) -> dict:
    return {k: {"q": [float(np.quantile(v, q)) for q in QUANTILES],
                "over": [float(np.mean(v > t)) for t in TAUS]}
            for k, v in g.items()}


def readings(cell_name: str, seeds, calls: int, device, **overrides):
    """Yield (seed, render, summary) for the program, the TF32 control and
    the bfloat16 control."""
    import torch
    from benchmark import run
    from benchmark.core import lookup
    bench = run.load_json(ROOT / "BENCHMARK.json")
    _, spec, mix, _ = run.cell_spec(cell_name, bench)
    rd = lookup.kind_module(mix["kind"], "drivers")
    options = overrides.pop("options", None)
    if options:
        mix = {**mix, "render_options": {**mix.get("render_options", {}),
                                         **options}}
    for seed in seeds:
        cell = rd.Cell(spec, mix, seed, device, **overrides)
        sampler = rd.Sampler(cell, mix["check"])
        for i in range(calls):
            sampler.keep(i, cell.call(i))
        rays = torch.as_tensor(np.concatenate(sampler.rays), device=device)
        args = (cell.params, spec["model"], rays, cell.bounds, cell.grid_dim,
                mix["step_ratio"])
        want = cell.ref.render(*args)
        want = {k: want[k].cpu().numpy() for k in rd.MAPS}
        got = {k: np.concatenate(v) for k, v in sampler.maps.items()}
        yield seed, "program", summarise(rd.gaps(got, want))
        for name, kw in (("tf32", {"tf32": True}),
                         ("bf16_heads", {"head_dtype": torch.bfloat16})):
            ctl = cell.ref.render(*args, **kw)
            yield seed, name, summarise(rd.gaps(
                {k: ctl[k].cpu().numpy() for k in rd.MAPS}, want))
        del cell, sampler
        if device.type == "cuda":
            torch.cuda.empty_cache()


def plant(cell, fault: str):
    """Plant ``fault`` in a train cell's program; returns the undo."""
    from contrastive_lift_tpu_torch.renderer import render as R
    if fault == "half_batch":
        step = cell.step

        def half(state, state_r, main, inst, seg, draws, *a):
            n = main["rays"].shape[0] // 2
            draws = draws._replace(main=draws.main._replace(
                jitter=draws.main.jitter[:n]))
            return step(state, state_r, {k: v[:n] for k, v in main.items()},
                        inst, seg, draws, *a)
        cell.step = half
        return lambda: setattr(cell, "step", step)
    if fault == "answer_altered":
        render_rays = R.render_rays

        def altered(*a, **kw):
            out = render_rays(*a, **kw)
            out["rgb"] = out["rgb"] + 0.01
            return out
        R.render_rays = altered
        return lambda: setattr(R, "render_rays", render_rays)
    raise ValueError(fault)


def _medians(td, got: dict, want: dict) -> dict:
    return {f"{k}_median": float(np.median(list(v.values())))
            for k, v in td.gaps(got, want).items()}


def train_readings(cell_name: str, seeds, fault_seeds: int, device,
                   **overrides):
    """Yield (seed, what, numbers) of a train cell."""
    import torch
    from benchmark import run
    from benchmark.core import lookup
    bench = run.load_json(ROOT / "BENCHMARK.json")
    _, spec, mix, _ = run.cell_spec(cell_name, bench)
    td = lookup.kind_module(mix["kind"], "drivers")
    n = mix["check"]["steps"]
    for i, seed in enumerate(seeds):
        cell = td.TrainCell(spec, mix, seed, device, **overrides)
        record = td.steps_checked(cell, n)
        cell.state = None
        wants = td.replays(cell, record)
        nums, want = td.closest(record, wants)
        medians = _medians(td, record, want)
        # the reference against a second replay of itself (the rounding of
        # its own scatter-adds) and against itself in float64 (how far
        # float32 rounding alone moves each number on these inputs)
        again = td.closest(td.replay(cell, record), [want])[0]
        rec64 = td.replay(cell, record, dtype=torch.float64)
        f64 = {**td.closest(rec64, [want])[0], **_medians(td, rec64, want)}
        yield seed, "program", {**nums, **td.worst(record, want), **medians,
                                **{f"{k}_self": v for k, v in again.items()},
                                **{f"{k}_f64": v for k, v in f64.items()},
                                "rows_off": td.rows_off(cell, record),
                                "aux_k": cell.aux_k,
                                "ties": want["ties"],
                                "guardrails": record["guardrails"]}
        ctl = td.replay(cell, record, tf32=True)
        nums, want = td.closest(ctl, wants)
        yield seed, "tf32", {**nums, **_medians(td, ctl, want)}
        if i < fault_seeds:
            for fault in ("half_batch", "answer_altered"):
                cell = td.TrainCell(spec, mix, seed, device, **overrides)
                undo = plant(cell, fault)
                try:
                    rec = td.steps_checked(cell, n)
                finally:
                    undo()
                cell.state = None
                nums, want = td.check(cell, rec)
                yield seed, fault, {**nums, **_medians(td, rec, want)}


def main(argv=None) -> int:
    p = argparse.ArgumentParser()
    p.add_argument("--workload", required=True)
    p.add_argument("--seeds", type=int, nargs="+", required=True)
    p.add_argument("--calls", type=int, default=2)
    p.add_argument("--fault-seeds", type=int, default=3)
    p.add_argument("--options", default="{}",
                   help="render_frames keywords over the mix's, as JSON: "
                   "'{\"use_fused\": false}' renders the program's dense path")
    args = p.parse_args(argv)
    sys.path.insert(0, str(ROOT))
    import torch
    if not torch.cuda.is_available():
        print("needs a CUDA device", file=sys.stderr)
        return 1
    t0 = time.perf_counter()
    from benchmark import run
    mix = run.cell_spec(args.workload, run.load_json(ROOT / "BENCHMARK.json"))[2]
    if mix["kind"].split(".")[0] == "train":
        for seed, what, nums in train_readings(
                args.workload, args.seeds, args.fault_seeds,
                torch.device("cuda", 0)):
            print(json.dumps({"workload": args.workload, "seed": seed,
                              "render": what, **nums,
                              "seconds": time.perf_counter() - t0}),
                  flush=True)
        return 0
    options = json.loads(args.options)
    for seed, name, summary in readings(args.workload, args.seeds, args.calls,
                                        torch.device("cuda", 0),
                                        options=options):
        print(json.dumps({"workload": args.workload, "seed": seed,
                          "options": options,
                          "render": name, "taus": TAUS, "quantiles": QUANTILES,
                          **summary,
                          "seconds": time.perf_counter() - t0}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
