"""A traced run of one cell, read by the program's own spans.

    python3 benchmark/spans.py --workload CELL --seed N --seconds S

Runs the cell as ``run.py --trace 1`` does and prints one JSON line: the
cell's per-layer metrics, the breakdown of ``core/trace.py``, and what the
port's spans and counters add (``core/program.py``): ``idle_by_program_span``
(the device's idle time, each stretch of it given to the innermost port
span open during it), ``idle_outside_program`` (the stretches under no port
span, summed by what the host was doing at each one's start, as
``idle_gaps`` names it), ``idle_by_step_phase`` in a training cell (the
same, over the step's phases ``train.*`` alone), each span's count and host
seconds, and the counters. Exits 1 without a result where there is no
card.
"""
from __future__ import annotations

import time

T_START = time.perf_counter()

import argparse  # noqa: E402
import json  # noqa: E402
import sys  # noqa: E402
from pathlib import Path  # noqa: E402

ROOT = Path(__file__).resolve().parents[1]


def traced(cell: str, seed: int, seconds: float, device, t_start: float,
           **overrides) -> dict:
    """The traced run's result line with the program's breakdown."""
    import torch
    from benchmark import run
    from benchmark.core import lookup, program
    from benchmark.core import trace as tr
    bench = run.load_json(ROOT / "BENCHMARK.json")
    w, spec, mix, limits = run.cell_spec(cell, bench)
    out = lookup.kind_module(mix["kind"], "drivers").run(
        spec, mix, cell, seed, seconds, True, device, t_start, limits,
        **overrides)
    ctx, t = out["context"], out["trace"]
    metrics = {}
    for m in run.metrics_of(bench, cell, "per_layer"):
        v = run.read_metric(m["name"], ctx)
        if v is not None:
            metrics[m["name"]] = {"value": v, "unit": m["unit"]}
    got = program.spans(ctx) or []
    outside = [(a, b) for name, a, b in program.idle_parts(t, got)
               if name == program.OUTSIDE]
    phases = [x for x in got if x[0].startswith("train.")]
    per_span = {}
    for name, a, b in got:
        n, s = per_span.get(name, (0, 0.0))
        per_span[name] = (n + 1, s + (b - a) / 1e9)
    return {"correct": bool(out["correct"]), "attempted": out["attempted"],
            "metrics": metrics,
            "device": {"kind": (torch.cuda.get_device_name(device)
                                if device.type == "cuda" else "cpu"),
                       "busy_s": t.busy_s, "window_s": t.window_s,
                       "memory_peak_bytes": out["memory_peak_bytes"]},
            "breakdown": {**tr.breakdown(t),
                          "idle_by_program_span": program.idle_by_span(t, got),
                          "idle_outside_program": by_host(t, outside),
                          **({"idle_by_step_phase":
                              program.idle_by_span(t, phases)}
                             if phases else {})},
            "spans": {k: {"count": n, "host_s": s}
                      for k, (n, s) in sorted(per_span.items())},
            "counters": program.counters(ctx)}


def by_host(t, parts, top: int = 10) -> list:
    """[[benchmark span / host op, seconds]] of the stretches ``parts``,
    each named by the innermost benchmark span and host op of the window's
    thread at its start (``core/trace.py::breakdown``'s names)."""
    from benchmark.core import trace as tr
    starts = [a for a, _ in parts]
    spans = tr._innermost_at(t.spans, starts)
    ops = tr._innermost_at(t.cpu_ops, starts)
    out = {}
    for (a, b), span, op in zip(parts, spans, ops):
        key = f"{span or 'outside the calls'} / {op or 'python'}"
        out[key] = out.get(key, 0) + (b - a)
    return [[k, ns / 1e9] for k, ns in sorted(out.items(),
                                               key=lambda kv: -kv[1])[:top]]


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--workload", required=True)
    p.add_argument("--seed", type=int, required=True)
    p.add_argument("--seconds", type=float, required=True)
    args = p.parse_args(argv)
    if str(ROOT) not in sys.path:
        sys.path.insert(0, str(ROOT))
    import torch
    if not torch.cuda.is_available():
        print("needs a CUDA device", file=sys.stderr)
        return 1
    device = torch.device("cuda", 0)
    torch.cuda.set_device(device)
    print(json.dumps(traced(args.workload, args.seed, args.seconds, device,
                            T_START)), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
