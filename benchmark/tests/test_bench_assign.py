"""The linear-assignment train cell, ``mos.train_fixed`` (kind
``train.assign``): its files, its Messy Rooms labelling and its check.

The cell resolves to its own driver and reference. On the CPU at a small
size (grid 24, 4 frames of 32x32, a quarter of the batches), past the
harness's look for a card: a traced run is correct and reads the cell's
per-layer metrics that a CPU run has; the frames carry Messy Rooms' labels
(2 classes, one-hot, background confidence 1.0) and the row check holds
the batches to them; a sampler that pairs rays with the wrong labels, and
a wrong match planted in the program's solve (one channel over, or label
i to channel i), come out not correct. The new readers report nothing for
a program without the span and counters.
"""
import time

import numpy as np
import pytest
import torch

from benchmark import run
from benchmark.core import lookup
from benchmark.tests.test_bench_train import labels_rolled

CELL = "mos.train_fixed"
SMALL = {"grid_dim": (24, 24, 24),
         "mix_overrides": {"train": {"frames": 4, "hw": [32, 32],
                                     "classes": 2, "confidence": 0.9}},
         "config_overrides": {"batch_size": 512, "batch_size_segments": 8,
                              "max_rays_segments": 256,
                              "max_rays_instances": 256}}
NEW = ("assign_ms.train", "assign_idle_pct.train", "assign_live_pct.train")


def _spec():
    return run.cell_spec(CELL, run.load_json(run.ROOT / "BENCHMARK.json"))


def test_cell_resolves_to_its_own_driver_and_reference():
    mix = _spec()[2]
    assert mix["kind"] == "train.assign"
    for folder in ("drivers", "reference"):
        path = lookup.HERE / folder / "train.assign.py"
        assert lookup.kind_file(mix["kind"], folder) == path
        assert lookup.kind_module(mix["kind"], folder).__file__ == str(path)


def test_traced_run_is_correct_and_reads_the_cells_metrics(monkeypatch):
    """The nine per-layer metrics are the cell's; those with something to
    read on the CPU are read (the optimizer's device time, the kernels and
    the device's idle share need a card)."""
    monkeypatch.setattr(torch.cuda, "synchronize", lambda *a: None)
    bench = run.load_json(run.ROOT / "BENCHMARK.json")
    names = {m["name"] for m in run.metrics_of(bench, CELL, "per_layer")}
    assert names == {"adam_ms.train", "kernels_per_step.train", "mfu.train",
                     "device_idle_pct.train", "head_live_pct.train",
                     "sample_ms.train", *NEW}
    res = run.run_cell(CELL, 2 ** 31 + 71, 0.2, True, torch.device("cpu"),
                       time.perf_counter(), **SMALL)
    assert res["correct"], res["checks"]
    assert "slow_change" not in res["checks"]
    m = {k: v["value"] for k, v in res["metrics"].items()}
    assert m["mfu.train"] > 0
    assert 0 < m["head_live_pct.train"] <= 100
    assert m["sample_ms.train"] > 0
    assert m["assign_ms.train"] > 0
    assert 0 < m["assign_live_pct.train"] <= 100
    assert 0 <= m["assign_idle_pct.train"] <= 100
    assert not run.forbidden_modules()


@pytest.mark.parametrize("name", NEW)
def test_new_readers_report_nothing_without_the_span_or_counters(name):
    from benchmark.core import trace as tr
    ctx = {"program_spans": [], "program_counters": {}, "steps": 3,
           "trace": tr.Trace(window_s=1.0, busy_s=0.0, ops=[], spans=[])}
    assert run.read_metric(name, ctx) is None


def test_frames_carry_messy_rooms_labels():
    from benchmark.fields.room import room_boxes
    from benchmark.traffic import frames, messy
    _, _, mix, _ = _spec()
    mix = {**mix, **SMALL["mix_overrides"]}
    boxes = room_boxes(mix["room"], 1)
    with pytest.raises(ValueError):     # the 21-class labelling cannot
        frames.tables(mix, len(boxes["lo"]), 1)
    lab = messy.tables(mix, len(boxes["lo"]), 1)
    assert lab["cls"][:frames.N_STUFF].tolist() == [0] * frames.N_STUFF
    assert (lab["cls"][frames.N_STUFF:] == 1).all()
    made = messy.training_frames(mix, boxes, 1, torch.device("cpu"))
    for f in made:
        box = f["instances"] > 0
        assert box.any() and (~box).any()
        assert np.array_equal(f["semantics"], box.astype(np.int32))
        assert np.array_equal(f["probabilities"],
                              np.eye(2, dtype=np.float32)[f["semantics"]])
        assert (f["confidences"][box] == np.float32(0.9)).all()
        assert (f["confidences"][~box] == 1.0).all()


@pytest.mark.parametrize("fault", [None, "labels_rolled", "rolled",
                                   "identity"])
def test_fault_comes_out_not_correct(fault, monkeypatch):
    """A sound run is correct; a mislabelling sampler fails ``rows_off``; a
    wrong match fails ``assign_excess``."""
    from benchmark import limits_assign
    from contrastive_lift_tpu_torch.data import base as B
    from contrastive_lift_tpu_torch.losses import losses
    if fault == "labels_rolled":
        monkeypatch.setattr(B.RayPoolSampler, "sample",
                            labels_rolled(B.RayPoolSampler.sample))
    elif fault is not None:
        monkeypatch.setattr(losses, "hungarian", limits_assign.wrong(
            fault, losses.hungarian, 500))
    res = run.run_cell(CELL, 2 ** 31 + 81, 0.1, False, torch.device("cpu"),
                       time.perf_counter(), **SMALL)
    assert res["correct"] is (fault is None), res["checks"]
    c = res["checks"]
    if fault == "labels_rolled":
        assert c["rows_off"]["value"] > c["rows_off"]["limit"]
    elif fault is not None:
        assert c["assign_excess"]["value"] > c["assign_excess"]["limit"]
    assert not run.forbidden_modules()
