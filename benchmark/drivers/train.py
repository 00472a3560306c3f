"""The train cell: ``train/step.py::make_train_step`` at the final stage.

Set-up draws the configuration's parameters on the device from the seed,
writes the mix's room into the density factors, makes the seeded training
frames with their labels (``traffic/frames.py``), builds the program's
samplers (``data/base.py``), its optimizer state and the step of the
stage's gates at the mix's head budget. It then drives that step through
its first ``check.steps`` steps on fresh batches and draws made from the
seed: these are the warm-up and what the check replays. The window runs
the same step object on, sampling included, until ``seconds`` have passed.

Once the window has closed and the peak memory has been read, the plain
reference of the mix's ``kind`` (``reference/train.py`` for ``train``,
found by ``core/lookup.py``) replays the first steps from the same
parameters, batches and draws; the numbers compared are each step's
losses, each trained leaf's first gradient (from the program's Adam state
after one step) and its change after the first steps, by the worst leaf,
the MLPs and the VM factors apart, and, where the configuration has a slow
head, its change under the EMA. The batches' rows are held to the frames
they were sampled from (``rows_off``), since the reference replays them as
they are.
"""
from __future__ import annotations

import time

import numpy as np
import torch

from benchmark.core import lookup
from benchmark.core import trace as tr
from benchmark.count import flops as fl
from benchmark.fields.params import GRID_GROUPS, make_params
from benchmark.fields.room import room_boxes, write_room
from benchmark.traffic import frames as tf

# Adam's first-moment decay in both chains: mu after one step is 0.1 g
B1 = 0.9
# the keys of each of a cell's limits (``checks/<cell>.json``)
LIMIT_KEYS = ("limit",)


class TrainCell:
    """The program's training step set up for one cell and seed."""

    def __init__(self, spec: dict, mix: dict, seed: int, device,
                 grid_dim=None, mix_overrides=None, config_overrides=None):
        from contrastive_lift_tpu_torch.config import load_config
        from contrastive_lift_tpu_torch.data.base import (
            FrameData, InstanceBundleSampler, RayPoolSampler,
            SegmentBundleSampler)
        from contrastive_lift_tpu_torch.factory import (make_model_config,
                                                        make_render_config)
        from contrastive_lift_tpu_torch.losses.losses import \
            get_semantic_weights
        from contrastive_lift_tpu_torch.renderer import render as R
        from contrastive_lift_tpu_torch.train import step as S
        from contrastive_lift_tpu_torch.train.loop import calibrate_aux_topk
        from contrastive_lift_tpu_torch.train.schedule import \
            lr_scale_for_epoch
        from contrastive_lift_tpu_torch.train.state import init_train_state

        self.S, self.R = S, R
        self.spec, self.seed, self.device = spec, int(seed), device
        self.mix = {**mix, **(mix_overrides or {})}
        self.ref = lookup.kind_module(self.mix["kind"], "reference")
        self.grid_dim = tuple(grid_dim or spec["grid_dim"])
        self.bounds = np.asarray(spec["scene_bounds"], np.float32)
        # the room, its frames and the Trainer's head-budget probe come from
        # the mix's layout seed, so every run seed trains the same scene at
        # the same budget; the run seed draws the weights, the batches'
        # order and the step's draws
        layout = self.layout = int(self.mix["layout_seed"])
        self.params = make_params(spec, seed, device, self.grid_dim)
        self.boxes = room_boxes(self.mix["room"], layout)
        write_room(self.params, self.mix["room"], self.boxes)
        stage = self.mix["stage"]
        # the mix's settings of the program (its head budget), then a test's
        spec = {**spec, "config": {**spec["config"],
                                   **self.mix.get("config", {}),
                                   **(config_overrides or {})}}
        self.spec = spec
        # the Trainer's values at this stage: weight decay is 0 after the
        # last upscale
        cfg = load_config(overrides={**spec["config"], "seed": layout,
                                     "weight_decay": stage["weight_decay"]})
        self.cfg = cfg
        self.mcfg = make_model_config(cfg, spec["num_semantic_classes"])
        self.rcfg = make_render_config(cfg, self.bounds, self.grid_dim,
                                       self.mcfg, self.mix["step_ratio"])
        self.state_r = R.make_render_state(self.bounds, self.grid_dim,
                                           self.mix["step_ratio"],
                                           device=device)
        made = tf.training_frames(self.mix, self.boxes, layout, device)
        self.counts = tf.surface_counts(
            made, tf.tables(self.mix, len(self.boxes["lo"]), layout)["order"])
        frames = [FrameData(f"{i:03d}", f["rays"], f["rgbs"], f["semantics"],
                            f["instances"], f["probabilities"],
                            f["confidences"],
                            np.ones(len(f["rays"]), bool), segments=f["segments"])
                  for i, f in enumerate(made)]
        del made
        C = spec["num_semantic_classes"]
        self.main_sampler = RayPoolSampler(frames, C)
        self.inst_sampler = InstanceBundleSampler(
            frames, cfg.max_rays_instances, cfg.max_labels_per_image)
        self.seg_sampler = SegmentBundleSampler(frames, cfg.max_rays_segments)
        self.epoch = stage["epoch"]
        self.gates = S.gates_for_epoch(cfg, self.epoch)
        self.class_w = get_semantic_weights(cfg.reweight_fg, [], C,
                                            cfg.weight_class_0, device=device)
        self.state = init_train_state(cfg, self.params)
        self.aux_k = calibrate_aux_topk(cfg, self.params, self.mcfg, self.rcfg,
                                        self.state_r, self.gates, self.epoch,
                                        self.main_sampler)
        self.step = S.make_train_step(cfg, self.mcfg, self.rcfg, self.gates,
                                      self.class_w, self.params,
                                      aux_head_topk=self.aux_k)
        self.lr_scale = lr_scale_for_epoch(self.epoch, cfg.decay_step,
                                           cfg.decay_gamma)
        self.lambda_dist = cfg.lambda_dist_reg * (1 - np.exp(-0.25 * self.epoch))
        self.rng = np.random.default_rng([self.seed, 0x54524149])
        self.gen = torch.Generator(device=device)
        self.gen.manual_seed(self.seed % (1 << 63))

    def batches(self):
        cfg = self.cfg
        return (self.main_sampler.sample(self.rng, cfg.batch_size),
                self.inst_sampler.sample(self.rng, cfg.batch_size_contrastive),
                self.seg_sampler.sample(self.rng, cfg.batch_size_segments))

    def draws(self, main, inst, seg):
        """The step's draws, all U[0,1) from the run's seed: the main
        jitter and coin, the jitter every segment chunk shares, each
        instance image's jitter."""
        def u(*shape):
            return torch.rand(shape, generator=self.gen, device=self.device)
        n_seg = seg["rays"].shape[0]
        return self.S.StepDraws(self.R.RayDraws(u(main["rays"].shape[0]), u()),
                                u(min(self.cfg.chunk_segment, n_seg)),
                                u(*inst["rays"].shape[:2]))

    def one(self):
        """One step on fresh batches and draws: (batches, draws, metrics)."""
        main, inst, seg = self.batches()
        d = self.draws(main, inst, seg)
        self.state, metrics = self.step(self.state, self.state_r, main, inst,
                                        seg, d, self.lr_scale,
                                        self.lambda_dist)
        return (main, inst, seg), d, metrics


def _clone(cell: TrainCell, tree):
    return {p: t.detach().clone() for p, t in cell.ref.leaves(tree)}


def group(path) -> str:
    """The numbers a trained leaf's gaps go to: the VM factors of the main
    chain's grid group (``grid``) or the MLPs and the appearance basis
    (``net``)."""
    return "grid" if path[0] in GRID_GROUPS else "net"


def slow_paths(tree: dict) -> list:
    """The leaves of the slow instance head, which the EMA moves."""
    return [p for p in tree if p[:2] == ("instance_mlp", "slow")]


def kept(grads: dict) -> dict:
    """{group: leaves}: each group's leaves whose reference first gradient
    reaches a thousandth of its median leaf's. A leaf under that gets a
    gradient that is nought to rounding (a bias under a softmax) and moves
    under Adam by round-off alone."""
    out = {}
    for grp in ("net", "grid"):
        g = {p: v for p, v in grads.items() if group(p) == grp}
        if g:
            med = float(np.median(list(g.values())))
            out[grp] = [p for p, v in g.items() if v >= 1e-3 * med]
    return out


def _leaf_gaps(prog: dict, want: dict, keep) -> dict:
    """{leaf: |norm(prog) - norm(want)| / max(norm(want), the median
    leaf's norm)} over the leaves ``keep``."""
    med = float(np.median([want[p] for p in keep]))
    return {p: abs(prog[p] - want[p]) / max(want[p], med) for p in keep}


def _change(rec: dict, p0: dict, keep) -> dict:
    return {p: float(torch.linalg.norm((rec["p_end"][p] - p0[p]).double()))
            for p in keep}


def replay(cell: TrainCell, record: dict, tf32: bool = False,
           flips=None, dtype=torch.float32) -> dict:
    """The reference's first steps from the recorded parameters, batches and
    draws, computed in ``dtype``: a record of its own (losses, first
    gradients' norms, parameters after the steps, and the segment groups that
    tied at each step). ``flips`` maps a step to {group: the class its
    target takes}."""
    dev = cell.device

    def cast(t):
        t = torch.as_tensor(t, device=dev)
        return t.to(dtype) if t.is_floating_point() else t
    ref = cell.ref
    step = ref.Step(cell.spec, cell.mix, cell.bounds, cell.grid_dim, dev,
                    dtype)
    params = ref.rebuild(cell.params, {p: cast(t)
                                       for p, t in record["p0"].items()})
    adam, losses, grads, ties = {}, [], None, []
    for i, (b, d) in enumerate(zip(record["batches"], record["draws"])):
        main, inst, seg = ({k: cast(v) for k, v in x.items()} for x in b)
        draws = {"main": cast(d.main.jitter), "coin": cast(d.main.coin),
                 "seg": cast(d.seg_jitter), "inst": cast(d.inst_jitter)}
        params, adam, l, g = step.run(params, adam,
                                      {"main": main, "inst": inst, "seg": seg},
                                      draws, cell.lr_scale, cell.lambda_dist,
                                      tf32=tf32,
                                      flip=(flips or {}).get(i, {}))
        losses.append(l)
        ties.append(step.ties)
        if i == 0:
            grads = ref.norms(g)
    return {"losses": losses, "grads": grads, "p0": record["p0"],
            "p_end": dict(ref.leaves(params)), "ties": ties}


def replays(cell: TrainCell, record: dict):
    """The reference's replay, and where a segment group's target tied
    (two group means within ``reference/train.py::TIE``), each other way of
    breaking the first two such ties: the program may break a tie either
    way, so each is a replay the program may follow."""
    want = replay(cell, record)
    tied = [(i, j, c) for i, t in enumerate(want["ties"]) for j, c in t][:2]
    out = [want]
    for mask in range(1, 1 << len(tied)):
        flips = {}
        for b, (i, j, c) in enumerate(tied):
            if mask >> b & 1:
                flips.setdefault(i, {})[j] = c
        out.append(replay(cell, record, flips=flips))
    return out


def gaps(got: dict, want: dict) -> dict:
    """{number: {where: gap}}. ``loss``: each step's losses, each gap over
    the larger of its reference value and that loss's median over the steps
    (a loss can cross zero: the slow-fast one does). ``grad`` and
    ``change`` (the MLPs and basis), ``grid_grad`` and ``grid_change`` (the
    VM factors): each kept leaf's gap of first-gradient norms and of
    change norms after the steps (``kept``, ``_leaf_gaps``).
    ``slow_change``, where the parameters have a slow head (the
    configuration's ``instance_heads``): each slow-head leaf's gap of
    change norms."""
    p0 = want["p0"]
    scale = {k: float(np.median([abs(w[k]) for w in want["losses"]]))
             for k in want["losses"][0]}
    out = {"loss": {(i, k): abs(a[k] - w[k]) / max(abs(w[k]), scale[k], 1e-12)
                    for i, (a, w) in enumerate(zip(got["losses"],
                                                   want["losses"]))
                    for k in w}}
    for grp, keep in kept(want["grads"]).items():
        pre = "" if grp == "net" else f"{grp}_"
        out[pre + "grad"] = _leaf_gaps(got["grads"], want["grads"], keep)
        out[pre + "change"] = _leaf_gaps(_change(got, p0, keep),
                                         _change(want, p0, keep), keep)
    slow = slow_paths(p0)
    if slow:
        out["slow_change"] = _leaf_gaps(_change(got, p0, slow),
                                        _change(want, p0, slow), slow)
    return out


def compare(got: dict, want: dict) -> dict:
    """The numbers: each the worst of its gaps (``gaps``)."""
    return {k: max(v.values()) for k, v in gaps(got, want).items()}


def worst(got: dict, want: dict) -> dict:
    """Where each number's worst reading lies, and how many trained leaves
    each group leaves out."""
    out = {f"{k}_at": "/".join(map(str, max(v, key=v.get)))
           for k, v in gaps(got, want).items()}
    keep = kept(want["grads"])
    for grp in keep:
        out[f"left_out_{grp}"] = sum(group(p) == grp
                                     for p in want["grads"]) - len(keep[grp])
    return out


def rows_off(cell: "TrainCell", record: dict) -> int:
    """The rows of the recorded batches that the program's samplers did not
    take from the frames as they are (``traffic/frames.py::RowCheck``)."""
    rc = tf.RowCheck(cell.mix, cell.boxes, cell.layout, cell.device,
                     cell.counts)
    cfg = cell.cfg
    return sum(rc.main(main)
               + rc.instance(inst, cfg.max_labels_per_image)
               + rc.segment(seg, cfg.batch_size_segments)
               for main, inst, seg in record["batches"])


def check(cell: TrainCell, record: dict):
    """(numbers, the reference's record) of the program's first steps: the
    reference's replay that the program follows closest (more than one only
    where a segment group's target tied), and the batches' rows that are
    not the frames' (``rows_off``)."""
    nums, want = closest(record, replays(cell, record))
    return {**nums, "rows_off": rows_off(cell, record)}, want


def closest(got: dict, wants: list):
    """(numbers, replay) of the replay in ``wants`` that ``got`` follows
    closest."""
    nums = [compare(got, w) for w in wants]
    k = min(range(len(wants)), key=lambda i: max(nums[i].values()))
    return nums[k], wants[k]


def run(spec: dict, mix: dict, cell_name: str, seed: int, seconds: float,
        trace: bool, device, t_start: float, limits: dict,
        grid_dim=None, mix_overrides=None, config_overrides=None) -> dict:
    """One run of a train cell: the result's fields, as the render
    driver's."""
    cell = TrainCell(spec, mix, seed, device, grid_dim, mix_overrides,
                     config_overrides)
    record = steps_checked(cell, cell.mix["check"]["steps"])
    if device.type == "cuda":
        torch.cuda.synchronize()
    setup_s = time.perf_counter() - t_start
    steps = 0
    window = None

    def window_loop():
        nonlocal steps
        t0 = time.perf_counter()
        while time.perf_counter() - t0 < seconds:
            with torch.profiler.record_function("bench.train_step"):
                cell.one()
            steps += 1
        if device.type == "cuda":
            torch.cuda.synchronize()
        return time.perf_counter() - t0

    if trace:
        with tr.Window(torch) as window:
            elapsed = window_loop()
    else:
        elapsed = window_loop()
    peak = (torch.cuda.max_memory_allocated(device)
            if device.type == "cuda" else 0)
    cell.state = None                # the program's state, before the check
    numbers, _ = check(cell, record)
    correct = all(numbers[k] <= lim["limit"] for k, lim in limits.items())
    out = {"correct": correct, "attempted": steps, "failed": 0,
           "values": {"train_steps_per_s": steps / elapsed,
                      "setup_s": setup_s},
           "memory_peak_bytes": int(peak),
           "checks": {k: {"value": numbers[k], "limit": lim["limit"]}
                      for k, lim in limits.items()}}
    if trace:
        t = window.trace
        out["trace"] = t
        out["context"] = {"trace": t, "steps": steps,
                          "flops_per_step": step_flops(cell, record),
                          "peak_flops": fl.PEAK[cell.rcfg.head_dtype]}
    return out


def steps_checked(cell: TrainCell, n: int) -> dict:
    """Run the first ``n`` steps, keeping what the check replays."""
    record = {"p0": _clone(cell, cell.params), "batches": [], "draws": [],
              "losses": []}
    for i in range(n):
        b, d, metrics = cell.one()
        record["batches"].append(b)
        record["draws"].append(d)
        record["losses"].append({
            "main": float(metrics["loss_main"]),
            "segment": float(metrics["loss_segment"]),
            "instance": float(metrics["loss_clustering"])})
        record.setdefault("guardrails", []).append(
            {k: float(v) for k, v in metrics.items() if k.endswith("_tail")})
        if i == 0:
            grads = {}
            for st in (cell.state.opt_state_main, cell.state.opt_state_inst):
                for group in st.values():
                    for p, mu in group.mu.items():
                        grads[p] = float(torch.linalg.norm(
                            (mu / (1 - B1)).double()))
            record["grads"] = grads
    record["p_end"] = _clone(cell, cell.state.params)
    return record


def step_flops(cell: TrainCell, record: dict) -> float:
    """Model FLOPs of one step from the configuration's shapes and the
    reference's sample counts on the first step's batches (valid rays)."""
    step = cell.ref.Step(cell.spec, cell.mix, cell.bounds, cell.grid_dim,
                         cell.device)
    params = cell.ref.rebuild(cell.params, record["p0"])
    (main, inst, seg), d = record["batches"][0], record["draws"][0]
    thres = cell.spec["model"]["raymarch_weight_thres"]
    counts = {}
    for name, rays, jitter, valid in (
            ("main", main["rays"], d.main.jitter, None),
            ("segment", seg["rays"], d.seg_jitter, seg["valid"]),
            ("instance", inst["rays"][0], d.inst_jitter[0],
             inst["valid"][0])):
        rays = torch.as_tensor(rays, device=cell.device)
        j = jitter[torch.arange(rays.shape[0], device=cell.device)
                   % jitter.shape[0]]
        w, xyz_n = step.aux_weights(params, rays, j)
        keep = (torch.ones(rays.shape[0], dtype=torch.bool, device=cell.device)
                if valid is None else torch.as_tensor(valid, device=cell.device))
        in_box = (xyz_n.abs() <= 1.0).all(-1).sum(-1)[keep].double()
        heads = (w > thres).sum(-1)[keep].double()
        counts[name] = (int(keep.sum()), float(in_box.mean()),
                        float(heads.mean()))
    return fl.train_step_flops(cell.spec["model"],
                               cell.spec["num_semantic_classes"], counts)
