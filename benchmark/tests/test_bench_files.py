"""Every file the benchmark finds by name loads; imports stay clean."""
import ast
import importlib.util
import json
import re
from pathlib import Path

import pytest

HERE = Path(__file__).resolve().parents[1]
ROOT = HERE.parent
BENCH = json.loads((ROOT / "BENCHMARK.json").read_text())
NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")
JAX = {"jax", "jaxlib", "flax", "contrastive_lift_tpu"}


def test_benchmark_json_shape():
    assert set(BENCH) == {"command", "paths", "run_seconds", "configs",
                          "workloads", "end_to_end", "per_layer"}
    names = ([c["name"] for c in BENCH["configs"]]
             + [w["name"] for w in BENCH["workloads"]]
             + [m["name"] for m in BENCH["end_to_end"] + BENCH["per_layer"]])
    assert len(names) == len(set(names))
    assert all(NAME.match(n) for n in names)
    assert all(UNIT.match(m["unit"])
               for m in BENCH["end_to_end"] + BENCH["per_layer"])
    assert any(m["name"] == "setup_s" for m in BENCH["end_to_end"])
    cells = {w["name"] for w in BENCH["workloads"]}
    for m in BENCH["per_layer"]:
        moved = next(e for e in BENCH["end_to_end"] if e["name"] == m["moves"])
        assert set(m["workloads"]) <= set(moved.get("workloads", cells))


@pytest.mark.parametrize("cfg", BENCH["configs"], ids=lambda c: c["name"])
def test_config_file_loads(cfg):
    spec = json.loads((ROOT / cfg["file"]).read_text())
    assert spec["name"] == cfg["name"]
    assert spec["reduced"] == cfg["reduced"]
    assert {"config", "model", "grid_dim", "num_semantic_classes",
            "scene_bounds", "assumed"} <= set(spec)


@pytest.mark.parametrize("cell", BENCH["workloads"], ids=lambda w: w["name"])
def test_cell_files_load(cell):
    import sys
    sys.path.insert(0, str(ROOT))
    from benchmark import run
    from benchmark.core import lookup
    w, spec, mix, limits = run.cell_spec(cell["name"], BENCH)
    # the kind's driver and plain reference resolve and load; each limit
    # carries the keys that its driver names
    driver = lookup.kind_module(mix["kind"], "drivers")
    assert lookup.kind_module(mix["kind"], "reference")
    keys = set(driver.LIMIT_KEYS)
    assert limits and all(keys <= set(v) for v in limits.values())
    assert run.metrics_of(BENCH, cell["name"], "end_to_end")
    assert run.metrics_of(BENCH, cell["name"], "per_layer")


@pytest.mark.parametrize("metric", BENCH["per_layer"], ids=lambda m: m["name"])
def test_metric_reader_loads(metric):
    import sys
    sys.path.insert(0, str(ROOT))
    from benchmark import run
    path = run.metric_file(metric["name"])
    spec = importlib.util.spec_from_file_location("m", path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    assert callable(mod.read)


def imported(path: Path):
    """Top-level names of every module ``path`` imports."""
    tree = ast.parse(path.read_text())
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            yield from (a.name.split(".", 1)[0] for a in node.names)
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            yield node.module.split(".", 1)[0]


SOURCES = sorted(p for p in HERE.rglob("*.py") if "tests" not in p.parts)


@pytest.mark.parametrize("path", SOURCES, ids=lambda p: str(p.relative_to(HERE)))
def test_no_jax_anywhere(path):
    # whole top-level names: the port's name begins with the JAX package's
    assert not set(imported(path)) & JAX


@pytest.mark.parametrize("path", sorted((HERE / "reference").glob("*.py")),
                         ids=lambda p: p.name)
def test_reference_imports_nothing_of_the_program(path):
    assert set(imported(path)) <= {"__future__", "contextlib", "numpy",
                                   "torch"}
