"""Benchmark of contrastive_lift_tpu_torch on NVIDIA GPUs.

    python3 benchmark/run.py --workload CELL --seed N --seconds S --trace 0|1

Runs one cell of ``BENCHMARK.json`` (its configuration, ``configs/``, and
its traffic mix, ``traffic/``, found by name; the mix's ``kind`` names the
cell's driver, ``drivers/``, and plain reference, ``reference/``, found by
``core/lookup.py``) on the card, and prints one JSON line as the last line
of standard output: ``correct``, ``attempted``, ``failed``, ``metrics``
(the cell's end-to-end metrics, or with ``--trace 1`` its per-layer
metrics, each read by ``metrics/<name>.py`` or the shared
``metrics/<quantity>.py``), ``device`` and, last, ``checks``: each number
compared with the plain reference beside its limit (``checks/<cell>.json``),
also printed as the last lines of standard error. Exits 1 without a result
when there is no card, fewer cards than the cell asks for, or when JAX or
the JAX package was loaded.
"""
from __future__ import annotations

import time

T_START = time.perf_counter()

import argparse  # noqa: E402
import json  # noqa: E402
import sys  # noqa: E402
from pathlib import Path  # noqa: E402

ROOT = Path(__file__).resolve().parents[1]
if str(ROOT) not in sys.path:
    sys.path.insert(0, str(ROOT))

from benchmark.core import lookup  # noqa: E402
from benchmark.core.lookup import metric_file  # noqa: E402

FORBIDDEN = ("jax", "jaxlib", "flax", "contrastive_lift_tpu")


def load_json(path: Path) -> dict:
    with open(path) as f:
        return json.load(f)


def cell_spec(name: str, bench: dict):
    """(workload, configuration, traffic mix, limits) of cell ``name``."""
    cells = {w["name"]: w for w in bench["workloads"]}
    if name not in cells:
        raise SystemExit(f"no workload {name!r} in BENCHMARK.json "
                         f"(have {sorted(cells)})")
    w = cells[name]
    cfgs = {c["name"]: c for c in bench["configs"]}
    spec = load_json(ROOT / cfgs[w["config"]]["file"])
    mix = load_json(lookup.HERE / "traffic" / f"{w['traffic']}.json")
    limits = load_json(lookup.HERE / "checks" / f"{name}.json")["numbers"]
    return w, spec, mix, limits


def metrics_of(bench: dict, cell: str, kind: str):
    """The cell's end-to-end or per-layer metric entries."""
    e2e = bench["end_to_end"]
    mine_e2e = {m["name"] for m in e2e
                if "workloads" not in m or cell in m["workloads"]}
    if kind == "end_to_end":
        return [m for m in e2e if m["name"] in mine_e2e]
    return [m for m in bench["per_layer"]
            if (cell in m["workloads"] if "workloads" in m
                else m["moves"] in mine_e2e)]


def read_metric(name: str, ctx: dict):
    return lookup.load_file(metric_file(name), "benchmark.metrics").read(ctx)


def forbidden_modules():
    return sorted({m.split(".", 1)[0] for m in sys.modules}
                  & set(FORBIDDEN))


def run_cell(cell: str, seed: int, seconds: float, trace: bool, device,
             t_start: float, **overrides) -> dict:
    """The result line of one run (before printing)."""
    import torch
    from benchmark.core import trace as tr
    bench = load_json(ROOT / "BENCHMARK.json")
    w, spec, mix, limits = cell_spec(cell, bench)
    out = lookup.kind_module(mix["kind"], "drivers").run(
        spec, mix, cell, seed, seconds, trace, device, t_start, limits,
        **overrides)
    if trace:
        values = {}
        for m in metrics_of(bench, cell, "per_layer"):
            v = read_metric(m["name"], out["context"])
            if v is not None:
                values[m["name"]] = {"value": v, "unit": m["unit"]}
    else:
        values = {m["name"]: {"value": out["values"][m["name"]],
                              "unit": m["unit"]}
                  for m in metrics_of(bench, cell, "end_to_end")}
    dev = {"platform": "gpu" if device.type == "cuda" else device.type,
           "kind": (torch.cuda.get_device_name(device)
                    if device.type == "cuda" else "cpu"),
           "count": int(w["chips"]),
           "memory_peak_bytes": out["memory_peak_bytes"]}
    result = {"correct": bool(out["correct"]), "attempted": out["attempted"],
              "failed": out["failed"], "metrics": values, "device": dev}
    if trace:
        t = out["trace"]
        dev["busy_s"], dev["window_s"] = t.busy_s, t.window_s
        result["breakdown"] = tr.breakdown(t)
    result["checks"] = out["checks"]
    return result


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--workload", required=True)
    p.add_argument("--seed", type=int, required=True)
    p.add_argument("--seconds", type=float, required=True)
    p.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = p.parse_args(argv)
    import torch
    bench = load_json(ROOT / "BENCHMARK.json")
    chips = {w["name"]: w["chips"] for w in bench["workloads"]}.get(
        args.workload)
    if chips is None:
        print(f"no workload {args.workload!r}", file=sys.stderr)
        return 2
    if not torch.cuda.is_available() or torch.cuda.device_count() < chips:
        print(f"needs {chips} CUDA device(s); torch sees "
              f"{torch.cuda.device_count() if torch.cuda.is_available() else 0}",
              file=sys.stderr)
        return 1
    device = torch.device("cuda", 0)
    torch.cuda.set_device(device)
    result = run_cell(args.workload, args.seed, args.seconds,
                      bool(args.trace), device, T_START)
    found = forbidden_modules()
    if found:
        print(f"forbidden modules loaded: {found}", file=sys.stderr)
        return 1
    for k, c in result["checks"].items():
        print(f"check {k}: {c['value']!r} limit {c['limit']!r}",
              file=sys.stderr)
    print(json.dumps(result), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
