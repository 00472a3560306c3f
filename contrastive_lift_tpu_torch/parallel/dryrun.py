"""Data-parallel dry runs: the production ``Trainer`` and ``render_frames``
over N ranks, against one process.

``dryrun_multichip`` is the counterpart of ``__graft_entry__.py::
dryrun_multichip``: it spawns N ranks (gloo on the CPU, NCCL on cards) that
run the ``Trainer`` with ``n_data_shards=N`` for one tiny epoch with a
sharded sanity validation, one more epoch for fresh metrics, then render the
val frames of ``last.npz`` with ``render_frames(mesh=)`` and without.

``trainer_steps`` takes a ``Trainer``'s first steps as
``tests/test_multichip.py`` takes the JAX package's, in one process or on
each rank of a launch, and ``compare_steps`` holds N ranks' steps to one
process's. The tests' own rank functions are in ``parallel/testing.py``.

    python -m contrastive_lift_tpu_torch.parallel.dryrun [--ranks N] [--device cuda]

runs the dry run on N ranks (NCCL on N cards, gloo on the CPU), then the
first 3 steps of ``TRAINER_CFG``'s Trainer on N ranks against one process
(metrics within rtol 2e-3, replicas bitwise equal), prints one JSON line
for each and exits non-zero on a failure.
"""
from __future__ import annotations

import dataclasses
import tempfile
from pathlib import Path
from typing import Optional

import numpy as np
import torch
import torch.distributed as dist

from ..config import Config
from ..data.synthetic import make_synthetic_scene
from ..inference.render import load_model_for_inference, render_frames_report
from ..renderer import render as R
from ..train.loop import Trainer
from ..train.step import StepDraws
from ..utils.device import resolve_device
from ..utils.tree import path_str, tree_leaves_with_path
from . import launch
from . import mesh as pmesh

MAP_KEYS = ("rgb", "semantics", "instances", "depth")


def replica_digests(mesh, tree) -> list:
    """Every rank's ``mesh.digest`` of ``tree`` (one, without a mesh)."""
    mine = pmesh.digest(tree)
    if mesh is None:
        return [mine]
    out = [None] * mesh.size
    dist.all_gather_object(out, mine, group=mesh.host_group)
    return out


def _floats(metrics: dict) -> dict:
    return {k: float(v) for k, v in metrics.items()}


def _draws(arrays: dict, device) -> StepDraws:
    """StepDraws from numpy arrays ``main``, ``coin``, ``seg``, ``inst``."""
    def t(name):
        return torch.as_tensor(np.asarray(arrays[name]), device=device)
    return StepDraws(R.RayDraws(t("main"), t("coin")), t("seg"), t("inst"))


# ---------------------------------------------------------------------------
# the Trainer's first steps
# ---------------------------------------------------------------------------

# tests/test_multichip.py::_make_trainer's configuration and scene: every
# phase open from epoch 0, every batch axis divisible by 1, 2, 4 and 8
TRAINER_CFG = dict(
    batch_size=256, chunk=256, min_grid_dim=16, max_grid_dim=16,
    max_instances=3, instance_loss_mode="slow_fast", use_DINO_style=True,
    batch_size_contrastive=8, max_rays_instances=64, max_labels_per_image=8,
    batch_size_segments=8, max_rays_segments=32, seed=0,
    late_semantic_optimization=0, instance_optimization_epoch=0,
    segment_optimization_epoch=0, bbox_aabb_reset_epochs=[],
    grid_upscale_epochs=[], sanity_steps=0, save_every_n_train_steps=0,
    lambda_dist_reg=0.0, logger="none")
TRAINER_SCENE = dict(num_spheres=3, num_train=8, num_val=1,
                     image_dim=(16, 16), seed=0)
METRIC_RTOL, METRIC_ATOL = 2e-3, 1e-5

def trainer_steps(cfg_kw: dict, scene_kw: dict, run_dir, device="cuda",
                  params=None, draws=None, steps: int = 3) -> dict:
    """A ``Trainer`` of ``Config(**cfg_kw)`` on ``make_synthetic_scene(
    **scene_kw)``: ``on_epoch_start(0)``, then ``steps`` steps on batches
    drawn from its ``rng`` and sharded as ``train_epoch`` shards them, at lr
    scale 1 and distortion weight 0, with ``draws[i]`` (numpy arrays, see
    ``_draws``; through the Trainer's draws hook, as global draws) or the
    trainer's generator. ``params``: initial parameters (numpy tree).
    Returns each step's metrics, the calibrated head budget, the final
    parameters (numpy, rank 0's) and every rank's digest of its parameters
    and of its optimizer state."""
    cfg = Config(**cfg_kw).resolve_epochs()
    scene = make_synthetic_scene(**scene_kw)
    hook = None if draws is None else (
        lambda step: _draws(draws[step], tr.device))
    tr = Trainer(cfg, scene, Path(run_dir), log_every=1, device=device,
                 params=params, draws=hook)
    tr.on_epoch_start(0)
    metrics = []
    for i in range(steps):
        b_main = tr.main_sampler.sample(tr.rng, cfg.batch_size)
        b_inst = tr.inst_sampler.sample(tr.rng, cfg.batch_size_contrastive)
        b_seg = tr.seg_sampler.sample(tr.rng, cfg.batch_size_segments)
        rng = tr._gen if tr.draws is None else tr.draws(i)
        tr.state, m = tr._step_fn(
            tr.state, tr.state_r, tr._shard_batch(b_main),
            tr._shard_batch(b_inst, pmesh.shard_instance_batch),
            tr._shard_batch(b_seg), rng, 1.0, 0.0)
        metrics.append(_floats(m))
    state = tr.state
    return {"metrics": metrics, "aux_k": tr._aux_k,
            "params": {path_str(p): v for p, v in _numpy_leaves(state.params)},
            "param_digests": replica_digests(tr.mesh, state.params),
            "opt_digests": replica_digests(
                tr.mesh, (state.opt_state_main, state.opt_state_inst))}


def _numpy_leaves(tree):
    return [(p, t.detach().cpu().numpy())
            for p, t in tree_leaves_with_path(tree)]


# ---------------------------------------------------------------------------
# the dry run
# ---------------------------------------------------------------------------

def dryrun_config(n: int) -> dict:
    """The JAX dry run's configuration for ``n`` ranks: tiny shapes, every
    batch axis divisible by n, every phase open from epoch 0."""
    return dict(
        batch_size=64 * n, chunk=64 * n, min_grid_dim=16, max_grid_dim=16,
        max_instances=3, instance_loss_mode="slow_fast", use_DINO_style=True,
        batch_size_contrastive=n, max_rays_instances=64,
        max_labels_per_image=8, batch_size_segments=2 * n,
        max_rays_segments=32, seed=0, n_data_shards=n,
        late_semantic_optimization=0, instance_optimization_epoch=0,
        segment_optimization_epoch=0, bbox_aabb_reset_epochs=[],
        grid_upscale_epochs=[], sanity_steps=1, save_every_n_train_steps=0,
        logger="none")


def _dryrun(n: int, device, run_dir) -> dict:
    cfg = Config(**dryrun_config(n)).resolve_epochs()
    scene = make_synthetic_scene(num_spheres=3, num_train=max(4, n),
                                 num_val=1, image_dim=(16, 16), seed=0)
    trainer = Trainer(cfg, scene, Path(run_dir), log_every=1, device=device)
    if trainer.mesh is None or trainer.mesh.size != n:
        raise RuntimeError(f"the dry run's trainer has no {n}-rank mesh")
    trainer.fit(max_epoch=1)
    metrics = trainer.train_epoch(1)  # one more epoch for fresh metrics
    metrics.pop("epoch_seconds", None)
    val = trainer.validate(1)
    bad = {k: v for k, v in {**metrics, **val}.items()
           if not np.isfinite(float(v))}
    if bad:
        raise AssertionError(f"dry run metrics are not finite: {bad}")
    mesh = trainer.mesh
    ckpt = Path(run_dir) / "checkpoints" / "last.npz"
    p, m, r, s, _ = load_model_for_inference(
        ckpt, cfg, scene.num_semantic_classes, step_ratio=0.25,
        device=mesh.device)
    frames = scene.val_frames
    one = render_frames_report(p, m, r, s, frames, chunk=cfg.chunk,
                               device=mesh.device)
    many = render_frames_report(p, m, r, s, frames, chunk=cfg.chunk,
                                mesh=mesh, device=mesh.device)
    map_err = max(float(np.abs(a[k] - b[k]).max())
                  for a, b in zip(one.maps, many.maps) for k in MAP_KEYS)
    return {"metrics": _floats(metrics), "val": val,
            "stages": trainer.stages, "render_max_abs_err": map_err,
            "budgets_equal": dataclasses.asdict(one.rcfg)
            == dataclasses.asdict(many.rcfg),
            "param_digests": replica_digests(mesh, trainer.state.params)}


def dryrun_multichip(n_devices: int, device="cuda",
                     timeout: Optional[float] = None,
                     store_dir=None) -> dict:
    """The production ``Trainer`` over ``n_devices`` ranks for one tiny
    epoch with a sharded sanity validation, one more epoch, a sharded
    validation, and ``render_frames(mesh=)`` of the val frames against one
    rank's unsharded render; rank 0's summary. Raises when a metric is not
    finite or a worker fails, and before any rank starts when ``device``
    is a card this host lacks."""
    resolve_device(device)
    with tempfile.TemporaryDirectory(dir=store_dir) as tmp:
        res = launch.spawn(_dryrun, n_devices, (n_devices, str(device), tmp),
                           timeout=timeout, store_dir=store_dir)
    if not res["budgets_equal"] or not res["render_max_abs_err"] <= 1e-6:
        raise AssertionError(
            f"the sharded render differs from the unsharded one: budgets "
            f"equal {res['budgets_equal']}, maps {res['render_max_abs_err']}")
    if len(set(res["param_digests"])) != 1:
        raise AssertionError("the replicas' parameters drifted apart")
    return res


def compare_steps(got: dict, want: dict) -> tuple:
    """(failures, largest relative metric error) of ``trainer_steps``'
    result against another's: every metric of every step within
    METRIC_RTOL / METRIC_ATOL, the replicas bitwise equal."""
    bad, worst = [], 0.0
    for i, (g, w) in enumerate(zip(got["metrics"], want["metrics"])):
        if set(g) != set(w):
            bad.append(f"step {i}: metrics {sorted(g)} vs {sorted(w)}")
        for key, value in w.items():
            err = abs(g.get(key, np.nan) - value)
            worst = max(worst, err / max(abs(value), 1e-30))
            if not err <= METRIC_RTOL * abs(value) + METRIC_ATOL:
                bad.append(f"step {i} {key} {g.get(key)} vs {value}")
    for key in ("param_digests", "opt_digests"):
        if len(set(got[key])) != 1:
            bad.append(f"the ranks' {key} differ")
    return bad, worst


def main(argv=None) -> int:
    import argparse
    import json
    import time
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--ranks", type=int, default=2)
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--timeout", type=float, default=600.0)
    args = ap.parse_args(argv)
    t0 = time.perf_counter()
    res = dryrun_multichip(args.ranks, args.device, timeout=args.timeout)
    print(json.dumps({"part": "dryrun", "ranks": args.ranks,
                      "device": args.device, "metrics": res["metrics"],
                      "val": res["val"],
                      "render_max_abs_err": res["render_max_abs_err"],
                      "seconds": time.perf_counter() - t0}), flush=True)
    with tempfile.TemporaryDirectory() as tmp:
        t0 = time.perf_counter()
        many = launch.spawn(trainer_steps, args.ranks,
                            (dict(TRAINER_CFG, n_data_shards=args.ranks),
                             TRAINER_SCENE, f"{tmp}/many", args.device),
                            timeout=args.timeout)
        seconds = time.perf_counter() - t0
        one = trainer_steps(dict(TRAINER_CFG, n_data_shards=1),
                            TRAINER_SCENE, f"{tmp}/one", args.device)
    bad, worst = compare_steps(many, one)
    param_err = max(float(np.abs(many["params"][p] - one["params"][p]).max())
                    for p in one["params"])
    print(json.dumps({"part": "trainer_steps", "ranks": args.ranks,
                      "device": args.device, "metric_max_rel_err": worst,
                      "param_max_abs_err": param_err, "failures": bad,
                      "seconds": seconds}), flush=True)
    return 1 if bad else 0


if __name__ == "__main__":
    raise SystemExit(main())
