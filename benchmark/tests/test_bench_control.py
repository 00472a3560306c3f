"""The control comes out as not correct, and the program as correct.

The control is the reference in the program's place in TF32, the nearest
precision below the configuration's float32 with TF32 off. On the card,
at a size a test run holds (render: grid 96^3, 8 frames of 48x64; train:
grid 48^3, 4 frames of 64x64), each cell's numbers are taken for the
program and for the control on three seeds: the program's are within the
cell's limits, the control's exceed one of them. The cell's own size is
run by ``benchmark/limits.py``.

    python -m pytest --noconftest benchmark/tests -m cuda
"""
import pytest

from benchmark import run

SEEDS = (2 ** 31 + 101, 2 ** 31 + 102, 2 ** 31 + 103)
SIZE = {"grid_dim": (96, 96, 96),
        "mix_overrides": {"height": 48, "width": 64, "chunk": 8192}}


@pytest.mark.cuda
@pytest.mark.parametrize("cell", ["cl.render_fixed", "mos.render_fixed"])
def test_control_fails_and_program_passes(cell):
    import numpy as np
    import torch
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    from benchmark.drivers import render as rd
    bench = run.load_json(run.ROOT / "BENCHMARK.json")
    _, spec, mix, limits = run.cell_spec(cell, bench)
    dev = torch.device("cuda", 0)
    for seed in SEEDS:
        c = rd.Cell(spec, mix, seed, dev, **SIZE)
        sampler = rd.Sampler(c, mix["check"])
        for i in range(2):
            sampler.keep(i, c.call(i))
        program, _ = rd.check(c, sampler, limits)
        assert all(program[k] <= lim["limit"] for k, lim in limits.items()), program
        rays = torch.as_tensor(np.concatenate(sampler.rays), device=dev)
        ctl = c.ref.render(c.params, spec["model"], rays, c.bounds,
                           c.grid_dim, c.mix["step_ratio"], tf32=True)
        sampler.maps = {k: [ctl[k].cpu().numpy()] for k in rd.MAPS}
        control, _ = rd.check(c, sampler, limits)
        assert any(control[k] > lim["limit"] for k, lim in limits.items()), control


TRAIN_SIZE = {"grid_dim": (48, 48, 48),
              "mix_overrides": {"train": {"frames": 4, "hw": [64, 64],
                                          "classes": 21, "confidence": 0.9}},
              "config_overrides": {"batch_size_segments": 8}}


@pytest.mark.cuda
def test_train_control_fails_and_program_passes():
    """The train cell's first three steps on three seeds, at grid 48^3 on
    4 frames of 64x64 with 8 segment bundles: the program's numbers within
    the limits, the reference's TF32 replay in its place past one."""
    import torch
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    from benchmark.drivers import train as td
    bench = run.load_json(run.ROOT / "BENCHMARK.json")
    _, spec, mix, limits = run.cell_spec("cl.train_fixed", bench)
    dev = torch.device("cuda", 0)
    for seed in SEEDS:
        cell = td.TrainCell(spec, mix, seed, dev, **TRAIN_SIZE)
        record = td.steps_checked(cell, mix["check"]["steps"])
        cell.state = None
        program, want = td.check(cell, record)
        assert all(program[k] <= lim["limit"] for k, lim in limits.items()), program
        control = td.closest(td.replay(cell, record, tf32=True), [want])[0]
        assert any(control[k] > lim["limit"] for k, lim in limits.items()
                   if k in control), control
