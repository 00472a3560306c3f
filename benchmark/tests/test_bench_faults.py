"""A run with the timed path broken underneath comes out not correct.

Each test drives the rest of a run on the CPU at a small size (the kernel
wrappers run their plain versions), past the harness's look for a card,
with the program's ``render_rays`` broken for the whole run: an answer
altered where it is produced (a quarter of each chunk's rays), half of the
batch left out (each chunk renders its first half and repeats it). A sound
run at the same size comes out correct.
"""
import time

import pytest
import torch

from benchmark import run

SMALL = {"grid_dim": (32, 32, 32),
         "mix_overrides": {"height": 12, "width": 16, "chunk": 256}}


def altered(render_rays):
    def broken(params, mcfg, rcfg, state, rays, *a, **kw):
        out = render_rays(params, mcfg, rcfg, state, rays, *a, **kw)
        q = rays.shape[0] // 4
        for k in ("rgb", "semantics", "instances", "depth"):
            out[k] = torch.cat([out[k][:q] + 0.05, out[k][q:]])
        return out
    return broken


def half_left_out(render_rays):
    def broken(params, mcfg, rcfg, state, rays, *a, **kw):
        h = rays.shape[0] // 2
        out = render_rays(params, mcfg, rcfg, state, rays[:h], *a, **kw)
        for k in ("rgb", "semantics", "instances", "depth"):
            out[k] = torch.cat([out[k], out[k]])[:rays.shape[0]]
        return out
    return broken


def one_run(cell, seed):
    return run.run_cell(cell, seed, 0.5, False, torch.device("cpu"),
                        time.perf_counter(), **SMALL)


@pytest.mark.parametrize("cell", ["cl.render_fixed", "mos.render_fixed"])
@pytest.mark.parametrize("fault", [None, altered, half_left_out],
                         ids=["sound", "answer_altered", "half_left_out"])
def test_fault_comes_out_not_correct(cell, fault, monkeypatch):
    from contrastive_lift_tpu_torch.renderer import render as R
    if fault is not None:
        monkeypatch.setattr(R, "render_rays", fault(R.render_rays))
    res = one_run(cell, 2 ** 31 + 11)
    assert res["correct"] is (fault is None), res["checks"]
    assert not run.forbidden_modules()
