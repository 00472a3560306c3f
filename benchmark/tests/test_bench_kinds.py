"""A cell's driver and plain reference are found by its traffic mix's kind.

``core/lookup.py::kind_file`` takes ``<folder>/<kind>.py``, or else the file
that the kind's dotted names share, ``<folder>/<kind up to the first
dot>.py``; ``kind_module`` loads it. Today's cells resolve to today's files,
the modules an import statement reaches; a dotted kind finds its own
reference and the shared driver; a kind with neither file raises with the
paths it tried; ``run.py`` and ``spans.py`` reach the same driver. On the
CPU at a small size, new kinds run through ``run_cell`` with their files
added beside a copy of the benchmark's own: one on the shared reference,
and a linear-assignment one on a configuration with no slow head, traced.
The train check reads no ``slow_change`` where the parameters have no slow
head, and its other numbers as they were; the FLOP count of a step follows
the configuration's instance heads.
"""
import json
import shutil
import sys
import time

import pytest
import torch

from benchmark import run
from benchmark.core import lookup
from benchmark.tests.test_bench_program import TRAIN_SMALL

TODAY = {"cl.render_fixed": "render", "mos.render_fixed": "render",
         "cl.train_fixed": "train"}


@pytest.mark.parametrize("cell", sorted(TODAY))
def test_cell_resolves_to_todays_files(cell):
    bench = run.load_json(run.ROOT / "BENCHMARK.json")
    mix = run.cell_spec(cell, bench)[2]
    for folder in ("drivers", "reference"):
        path = lookup.HERE / folder / f"{TODAY[cell]}.py"
        assert lookup.kind_file(mix["kind"], folder) == path
        mod = lookup.kind_module(mix["kind"], folder)
        assert mod.__file__ == str(path)
        # one module of the file in a process, whichever way it is reached
        assert mod is sys.modules[f"benchmark.{folder}.{TODAY[cell]}"]


def test_dotted_kind_resolves_to_its_own_reference_and_the_shared_driver(
        tmp_path, monkeypatch):
    for rel in ("drivers/train.py", "reference/train.py",
                "reference/train.assign.py"):
        (tmp_path / rel).parent.mkdir(exist_ok=True)
        (tmp_path / rel).write_text(f"FILE = {rel!r}\n")
    monkeypatch.setattr(lookup, "HERE", tmp_path)
    assert lookup.kind_file("train.assign", "drivers") == \
        tmp_path / "drivers" / "train.py"
    assert lookup.kind_file("train.assign", "reference") == \
        tmp_path / "reference" / "train.assign.py"
    assert lookup.kind_module("train.assign", "reference").FILE == \
        "reference/train.assign.py"
    assert lookup.kind_module("train.assign", "drivers").FILE == \
        "drivers/train.py"
    assert lookup.kind_module("train", "reference").FILE == \
        "reference/train.py"


@pytest.mark.parametrize("folder", ["drivers", "reference"])
def test_kind_with_neither_file_raises_with_the_paths_it_tried(
        folder, tmp_path, monkeypatch):
    (tmp_path / folder).mkdir()
    monkeypatch.setattr(lookup, "HERE", tmp_path)
    with pytest.raises(LookupError) as err:
        lookup.kind_file("nosuch.assign", folder)
    for name in ("nosuch.assign.py", "nosuch.py"):
        assert str(tmp_path / folder / name) in str(err.value)


class Reached(Exception):
    """Raised by the driver that a run reached, before it runs."""


@pytest.mark.parametrize("cell", sorted(TODAY))
def test_spans_and_run_reach_the_same_driver(cell, monkeypatch):
    from benchmark import spans
    reached = []
    find = lookup.kind_module

    def spy(kind, folder):
        mod = find(kind, folder)
        if folder == "drivers":
            reached.append(mod)
            raise Reached
        return mod
    monkeypatch.setattr(lookup, "kind_module", spy)
    cpu = torch.device("cpu")
    with pytest.raises(Reached):
        run.run_cell(cell, 1, 0.1, False, cpu, time.perf_counter())
    with pytest.raises(Reached):
        spans.traced(cell, 1, 0.1, cpu, time.perf_counter())
    assert len(reached) == 2 and reached[0] is reached[1]
    assert reached[0].__file__ == str(lookup.HERE / "drivers"
                                      / f"{TODAY[cell]}.py")


ECHO = '''"""The shared train reference, its Step counted."""
from .train import *  # noqa: F401,F403
from .train import Step as SharedStep

MADE = []


class Step(SharedStep):
    def __init__(self, *a, **kw):
        super().__init__(*a, **kw)
        MADE.append(self)
'''

ASSIGN = '''"""The shared train reference with a linear-assignment instance loss.

Each instance image: the fast head's logits composited over the ray; each
label matched to a channel by the Hungarian solve of minus the label's mean
softmax mass; confidence-weighted cross entropy against the matched
channel, 0 where every valid ray's argmax is already its match.
"""
import torch
from scipy.optimize import linear_sum_assignment

from .train import *  # noqa: F401,F403
from .train import Step as SharedStep
from .train import _ce, _composite, _live_heads, mlp


class Step(SharedStep):
    def instance_loss(self, params, batch, jitter):
        loss = 0.0
        layers = params["instance_mlp"]["fast"]["layers"]
        num_labels = self.cfg["max_labels_per_image"]
        for k in range(batch["rays"].shape[0]):
            rays = batch["rays"][k]
            w, xyz_n = self.aux_weights(params, rays, jitter[k])
            r, wl, p = _live_heads(w, xyz_n,
                                   self.model["raymarch_weight_thres"])
            logits = _composite(rays.shape[0], r, wl,
                                mlp(layers, p, self.dtype))
            labels = batch["labels"][k].long()
            valid = batch["valid"][k]
            vf = valid.to(logits.dtype)
            with torch.no_grad():
                probs = torch.softmax(logits, -1) * vf[:, None]
                sums = torch.zeros(num_labels, logits.shape[1],
                                   dtype=logits.dtype,
                                   device=logits.device).index_add(
                    0, labels, probs)
                counts = torch.zeros(num_labels, dtype=logits.dtype,
                                     device=logits.device).index_add(
                    0, labels, vf)
                cost = torch.where((counts > 0)[:, None],
                                   -(sums / (counts[:, None] + 1e-4)), 1e6)
                rows, cols = linear_sum_assignment(
                    cost.double().cpu().numpy())
                match = torch.empty(num_labels, dtype=torch.long)
                match[torch.as_tensor(rows)] = torch.as_tensor(cols)
                target = match.to(logits.device)[labels]
            ones = torch.ones(logits.shape[1], dtype=logits.dtype,
                              device=logits.device)
            per = _ce(logits, target, ones) * batch["confidences"][k] * vf
            if bool(((logits.argmax(-1) != target) & valid).any()):
                loss = loss + per.sum() / vf.sum().clamp(min=1.0)
        return loss
'''


def bench_with_kind(tmp_path, monkeypatch, kind: str, reference: str,
                    config: dict, drop=()):
    """A copy of the benchmark's own folders under ``tmp_path`` with a new
    kind added there as new files only: its traffic mix (the train cell's,
    under ``kind``), its checks (the train cell's, less ``drop``), its
    reference (``reference/<kind>.py``), its configuration and its cell
    ``x.<kind>`` in a copy of ``BENCHMARK.json``, listed where the train
    cell is. The lookup and ``run.py`` read the copy. Returns the cell's
    name and the copy's benchmark folder."""
    here = tmp_path / "benchmark"
    for folder in ("configs", "traffic", "checks", "metrics", "drivers",
                   "reference"):
        shutil.copytree(lookup.HERE / folder, here / folder,
                        ignore=shutil.ignore_patterns("__pycache__"))
    cell, mix_name = f"x.{kind}", kind.replace(".", "_")
    mix = json.loads((here / "traffic" / "train_room12_fixed.json").read_text())
    (here / "traffic" / f"{mix_name}.json").write_text(
        json.dumps({**mix, "kind": kind}))
    numbers = json.loads((here / "checks" / "cl.train_fixed.json")
                         .read_text())["numbers"]
    (here / "checks" / f"{cell}.json").write_text(json.dumps(
        {"numbers": {k: v for k, v in numbers.items() if k not in drop}}))
    (here / "reference" / f"{kind}.py").write_text(reference)
    (here / "configs" / f"{mix_name}.json").write_text(json.dumps(config))
    bench = run.load_json(run.ROOT / "BENCHMARK.json")
    bench["configs"].append({"name": config["name"],
                             "source": "a test configuration",
                             "file": f"benchmark/configs/{mix_name}.json",
                             "reduced": [], "why": "a new kind"})
    bench["workloads"].append({"name": cell, "config": config["name"],
                               "traffic": mix_name, "chips": 1,
                               "why": "the shared train driver, a new kind"})
    for m in bench["end_to_end"] + bench["per_layer"]:
        if "cl.train_fixed" in m.get("workloads", ()):
            m["workloads"].append(cell)
    (tmp_path / "BENCHMARK.json").write_text(json.dumps(bench))
    monkeypatch.setattr(run, "ROOT", tmp_path)
    monkeypatch.setattr(lookup, "HERE", here)
    return cell, here


def test_new_kind_runs_through_run_cell_with_files_added(tmp_path,
                                                         monkeypatch):
    """A new kind ``train.echo`` on the contrastive_lift configuration, its
    reference the shared one with its Step subclassed: the run takes the
    shared driver and the new reference, and comes out correct."""
    spec = run.load_json(lookup.HERE / "configs" / "contrastive_lift.json")
    cell, here = bench_with_kind(tmp_path, monkeypatch, "train.echo", ECHO,
                                 {**spec, "name": "x_echo"})
    res = run.run_cell(cell, 2 ** 31 + 41, 0.1, False,
                       torch.device("cpu"), time.perf_counter(), **TRAIN_SMALL)
    assert res["correct"], res["checks"]
    assert set(res["metrics"]) == {"train_steps_per_s", "setup_s"}
    assert set(res["checks"]) == set(run.load_json(
        here / "checks" / f"{cell}.json")["numbers"])
    assert lookup.kind_file("train.echo", "drivers") == \
        here / "drivers" / "train.py"
    # the check's replays and the FLOP count each made one Step
    assert lookup.kind_module("train.echo", "reference").MADE
    assert not run.forbidden_modules()


def test_assignment_kind_without_a_slow_head_runs_traced(tmp_path,
                                                         monkeypatch):
    """A linear-assignment kind ``train.assign`` on a configuration whose
    only instance head is ``fast`` (500 channels, as Panoptic Lifting's),
    its checks less ``slow_change``, traced: the run is correct, reads the
    train cell's per-layer metrics, the step's FLOPs among them, and
    compares no ``slow_change``. (The stand-in reference solves with
    scipy; one under ``reference/`` imports only numpy and torch.)"""
    spec = run.load_json(lookup.HERE / "configs" / "contrastive_lift.json")
    config = {**spec, "name": "x_assign",
              "config": {**spec["config"],
                         "instance_loss_mode": "linear_assignment",
                         "max_instances": 500},
              "model": {**spec["model"], "instance_heads": ["fast"],
                        "instance_out": 500}}
    cell, _ = bench_with_kind(tmp_path, monkeypatch, "train.assign", ASSIGN,
                              config, drop=("slow_change",))
    monkeypatch.setattr(torch.cuda, "synchronize", lambda *a: None)
    res = run.run_cell(cell, 2 ** 31 + 43, 0.1, True, torch.device("cpu"),
                       time.perf_counter(), **TRAIN_SMALL)
    assert res["correct"], res["checks"]
    assert "slow_change" not in res["checks"]
    assert 0 < res["metrics"]["mfu.train"]["value"]
    assert 0 < res["metrics"]["head_live_pct.train"]["value"] <= 100
    assert not run.forbidden_modules()


def test_grid_groups_are_the_references():
    """The driver's grid groups (the field's) are those the train reference
    trains at the grid's rate."""
    from benchmark.fields.params import GRID_GROUPS
    assert lookup.kind_module("train", "reference").MAIN_GRID == GRID_GROUPS


def test_train_flops_follow_the_configurations_instance_heads():
    """Both configurations' step FLOPs from one set of counts: with a slow
    head as the count read before (the fast head 3 times, the slow head
    once), without one the fast head alone."""
    from benchmark.count import flops as fl
    counts = {"main": (100, 50.0, 10.0), "segment": (40, 30.0, 5.0),
              "instance": (20, 40.0, 8.0)}
    for name, heads in (("contrastive_lift", {"fast", "slow"}),
                        ("panopli_mos", {"fast"})):
        spec = run.load_json(lookup.HERE / "configs" / f"{name}.json")
        model, C = spec["model"], spec["num_semantic_classes"]
        assert set(model["instance_heads"]) == heads
        h, d = fl.head_parts(model, C), fl.density_flops(model)
        inst = 3 * h["instance_mlp.fast"] + (
            h["instance_mlp.slow"] if "slow" in heads else 0)
        want = (100 * 3 * (50.0 * d + 10.0 * (h["appearance_mlp"]
                                              + h["semantic_mlp"]))
                + 40 * (30.0 * d + 3 * 5.0 * h["semantic_mlp"])
                + 20 * (40.0 * d + 8.0 * inst))
        assert fl.train_step_flops(model, C, counts) == want


def leaf(v: float):
    return torch.tensor([v], dtype=torch.float64)


def records(slow: bool):
    """(program's record, reference's record) of two steps on five trained
    leaves and, with ``slow``, a slow-head leaf; the values chosen so that
    one gap of each number reads 0.1 (``grad`` and ``change`` 0.05) and
    the others 0."""
    trained = {("density", "planes", 0): (1.0, 1.2, 0.4, 0.44),
               ("appearance", "planes", 0): (3.0, 3.0, 0.2, 0.2),
               ("appearance_mlp", "layers", 0, "w"): (1.0, 1.0, 0.5, 0.55),
               ("semantic_mlp", "layers", 0, "w"): (2.0, 2.1, 1.0, 1.0),
               ("instance_mlp", "fast", "layers", 0, "w"): (4.0, 4.0,
                                                            2.0, 2.0)}
    p0 = {p: leaf(0.0) for p in trained}
    want = {"losses": [{"main": 2.0, "instance": 1.0},
                       {"main": 4.0, "instance": 1.0}],
            "grads": {p: v[0] for p, v in trained.items()},
            "p_end": {p: leaf(v[2]) for p, v in trained.items()},
            "p0": p0, "ties": [[], []]}
    got = {"losses": [{"main": 2.0, "instance": 1.0},
                      {"main": 4.4, "instance": 1.0}],
           "grads": {p: v[1] for p, v in trained.items()},
           "p_end": {p: leaf(v[3]) for p, v in trained.items()},
           "p0": p0}
    if slow:
        p = ("instance_mlp", "slow", "layers", 0, "w")
        p0[p], want["p_end"][p], got["p_end"][p] = (leaf(0.0), leaf(0.5),
                                                    leaf(0.55))
    return got, want


# what the check read on ``records(True)`` before the slow head became
# optional, digit for digit, and where each worst gap lay
BEFORE = {"loss": 0.10000000000000009, "grad": 0.050000000000000044,
          "change": 0.050000000000000044, "grid_grad": 0.09999999999999998,
          "grid_change": 0.09999999999999995,
          "slow_change": 0.10000000000000009}
BEFORE_AT = {"loss_at": "1/main", "grad_at": "semantic_mlp/layers/0/w",
             "change_at": "appearance_mlp/layers/0/w",
             "grid_grad_at": "density/planes/0",
             "grid_change_at": "density/planes/0",
             "slow_change_at": "instance_mlp/slow/layers/0/w",
             "left_out_net": 0, "left_out_grid": 0}


@pytest.mark.parametrize("slow", [True, False], ids=["slow_head", "no_slow"])
def test_train_check_follows_the_configurations_heads(slow):
    """Each number the worst gap of its leaves: ``loss`` 0.4 over 4;
    ``grad`` 0.1 over the median leaf's 2; ``change`` 0.05 over the median
    leaf's 1; ``grid_grad`` 0.2 over 2; ``grid_change`` 0.04 over 0.4;
    ``slow_change`` 0.05 over 0.5: with a slow head as before, without one
    the same numbers and no ``slow_change``."""
    from benchmark.drivers import train as td
    got, want = records(slow)
    drop = () if slow else ("slow_change", "slow_change_at")
    assert td.compare(got, want) == {k: v for k, v in BEFORE.items()
                                     if k not in drop}
    assert td.worst(got, want) == {k: v for k, v in BEFORE_AT.items()
                                   if k not in drop}
