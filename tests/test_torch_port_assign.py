"""The port's linear-assignment training step (Panoptic Lifting's) against the
benchmark's plain reference, ``benchmark/reference/train.assign.py``.

On the CPU at a small size: the port's ``make_train_step`` with the
linear-assignment instance loss on a fast-only 500-channel head, driven by
the benchmark's ``mos.train_fixed`` driver on a grid-16 field and a few
32x32 frames, replayed by the reference from the same parameters, batches,
draws and matches: losses, first gradients and changes after 2 steps within
the cell's limits. The reference's cost, match, loss and gradient against
the port's loss on the same logits, a bundle that already agrees with its
match among them. The reference's own Hungarian solve against scipy's on
tie-free costs, and its excess over the optimum. The loss's span
``train.assign`` and its counters ``assign.rows`` and ``assign.slots``
under a profiler.
"""
import json
from pathlib import Path

import numpy as np
import pytest
import torch
from scipy.optimize import linear_sum_assignment

from benchmark import run
from benchmark.core import lookup

ROOT = Path(__file__).resolve().parents[1]
CELL = "mos.train_fixed"
SMALL = {"grid_dim": (16, 16, 16),
         "mix_overrides": {"train": {"frames": 2, "hw": [32, 32],
                                     "classes": 2, "confidence": 0.9}},
         "config_overrides": {"batch_size": 256, "batch_size_segments": 4,
                              "max_rays_segments": 128,
                              "max_rays_instances": 256}}


def _reference():
    return lookup.kind_module("train.assign", "reference")


def test_assign_step_matches_the_reference():
    bench = run.load_json(ROOT / "BENCHMARK.json")
    _, spec, mix, limits = run.cell_spec(CELL, bench)
    assert spec["model"]["instance_heads"] == ["fast"]
    assert spec["model"]["instance_out"] == 500
    assert spec["config"]["instance_loss_mode"] == "linear_assignment"
    td = lookup.kind_module(mix["kind"], "drivers")
    cell = td.TrainCell(spec, mix, 2 ** 31 + 61, torch.device("cpu"),
                        **SMALL)
    record = td.steps_checked(cell, 2)
    assert len(record["matches"]) == 2
    assert all(r["instance"] > 0 for r in record["losses"])
    cell.state = None
    numbers, _ = td.check(cell, record)
    assert set(numbers) == set(limits)
    for k, lim in limits.items():
        assert numbers[k] <= lim["limit"], (k, numbers[k])


@pytest.mark.parametrize("case", ["mismatch", "consistent"])
def test_reference_loss_equals_the_ports(case, monkeypatch):
    """On the same logits the reference's cost, match, loss and gradient
    are the port's; where every valid ray's argmax is already its label's
    match the loss is 0, a tensor whose gradient is 0."""
    from contrastive_lift_tpu_torch.losses import losses
    ref = _reference()
    gen = torch.Generator().manual_seed(1)
    labels = torch.randint(0, 6, (96,), generator=gen)
    valid = torch.rand(96, generator=gen) < 0.9
    conf = torch.rand(96, generator=gen)
    logits = torch.randn(96, 500, generator=gen, dtype=torch.float64)
    if case == "consistent":
        logits[torch.arange(96), 7 * labels] += 50.0
    costs = []
    solve = losses.hungarian
    monkeypatch.setattr(losses, "hungarian",
                        lambda c: costs.append(c) or solve(c))
    x = logits.clone().requires_grad_(True)
    got = losses.linear_assignment_loss(x, labels, conf, 16, valid)
    g_got, = torch.autograd.grad(got, x)
    cost = ref.assignment_cost(logits, labels, valid, 16)
    np.testing.assert_allclose(cost, costs[0], rtol=1e-12, atol=0)
    match = ref.hungarian(cost)
    assert np.array_equal(match, solve(costs[0]))
    y = logits.clone().requires_grad_(True)
    want = ref.assignment_loss(y, labels, conf, valid, match)
    g_want, = torch.autograd.grad(want, y)
    torch.testing.assert_close(got, want, rtol=1e-12, atol=0)
    torch.testing.assert_close(g_got, g_want, rtol=1e-10, atol=1e-15)
    assert (float(want.detach()) == 0.0) is (case == "consistent")
    assert bool(g_want.any()) is (case == "mismatch")


def _cost(rng, n, m, pad):
    """A random [n, m] cost, its last ``pad`` rows padded at 1e6."""
    cost = rng.standard_normal((n, m))
    cost[n - pad:] = 1e6
    return cost


SHAPES = [(1, 1), (1, 7), (2, 2), (3, 5), (4, 4), (5, 12), (8, 8), (9, 30),
          (16, 16), (16, 64), (24, 100), (32, 32), (40, 500), (64, 128),
          (64, 500), (100, 100), (100, 500), (128, 128), (128, 500),
          (128, 500)]


@pytest.mark.parametrize("case", range(len(SHAPES)))
def test_reference_hungarian_equals_scipys(case):
    """The reference's NumPy solve gives scipy's match, padded rows among
    them (every other case pads a quarter of its rows)."""
    n, m = SHAPES[case]
    rng = np.random.default_rng(case)
    cost = _cost(rng, n, m, n // 4 if case % 2 else 0)
    rows, cols = linear_sum_assignment(cost)
    want = np.empty(n, np.int64)
    want[rows] = cols
    got = _reference().hungarian(cost)
    assert np.array_equal(got, want)
    assert _reference().excess(cost, got) == 0.0


def test_excess_reads_a_wrong_match():
    """A match one channel over costs more than the optimum; one that gives
    two labels a channel reads infinite; padded rows do not count."""
    ref = _reference()
    cost = -np.random.default_rng(0).uniform(0, 1, (6, 9))
    cost[4:] = ref.ABSENT
    best = ref.hungarian(cost)
    assert ref.excess(cost, (best + 1) % 9) > 1e-3
    twice = best.copy()
    twice[1] = twice[0]
    assert ref.excess(cost, twice) == float("inf")
    padded = best.copy()
    padded[4:] = padded[4:][::-1]
    assert ref.excess(cost, padded) == 0.0


def test_band_is_the_checks_limit():
    limits = json.loads((ROOT / "benchmark" / "checks"
                         / f"{CELL}.json").read_text())["numbers"]
    assert _reference().BAND == limits["assign_excess"]["limit"]


def test_assign_span_and_counters_under_a_profiler():
    """Under a profiler the loss records one ``train.assign`` span a call
    and counts the labels present and the rows solved; without one,
    nothing."""
    from contrastive_lift_tpu_torch.losses.losses import \
        linear_assignment_loss
    from contrastive_lift_tpu_torch.utils import observability as obs
    gen = torch.Generator().manual_seed(0)
    logits = torch.randn(64, 500, generator=gen)
    labels = torch.randint(0, 5, (64,), generator=gen)
    labels[labels == 3] = 4                        # label 3 absent
    valid = torch.ones(64, dtype=torch.bool)
    conf = torch.full((64,), 0.9)
    obs.take_spans(), obs.take_counters()
    linear_assignment_loss(logits, labels, conf, 16, valid)
    assert obs.take_spans() == [] and obs.take_counters() == {}
    with torch.profiler.profile():
        for _ in range(2):
            linear_assignment_loss(logits, labels, conf, 16, valid)
    spans = [s for s in obs.take_spans() if s[0] == "train.assign"]
    assert len(spans) == 2 and all(b >= a for _, a, b in spans)
    counters = obs.take_counters()
    assert counters["assign.rows"] == 2 * 4
    assert counters["assign.slots"] == 2 * 16
