"""The render cells: ``render_frames`` called back to back on seeded frames.

Set-up draws the configuration's parameters on the device from the seed,
writes the mix's room into the density factors, builds the program's model
and render configs as ``cli/render.py`` does (step ratio, head top-k, no
white background), makes a pool of calls' frames from the seed and renders
one call to warm every kernel and shape up. The window then calls
``inference/render.py::render_frames`` on the pool's calls in turn, each
call a test shard of ``frames_per_call`` frames at the mix's chunk and
``render_options`` (``render_frames``' keywords), until
``seconds`` have passed; the rate is every ray of the completed calls over
the time from the window's start to the last completion.

From each completed call a seeded sample of rays is kept with the maps the
program returned for them. Once the window has closed and the peak memory
has been read, the plain reference of the mix's ``kind``
(``reference/render.py`` for ``render``, found by ``core/lookup.py``)
renders the sampled rays and the maps are compared (``check``).
"""
from __future__ import annotations

import dataclasses
import time

import numpy as np
import torch

from benchmark.core import lookup
from benchmark.core import trace as tr
from benchmark.count import flops as fl
from benchmark.count import k1_bytes
from benchmark.fields.params import make_params
from benchmark.fields.room import room_boxes, write_room
from benchmark.traffic import cameras

MAPS = ("rgb", "depth", "semantics", "instances")
# the keys of each of a cell's limits (``checks/<cell>.json``): the map, its
# gap's threshold and the largest share of sampled rays over it
LIMIT_KEYS = ("map", "tau", "limit")
# the device bytes of K1's positions kept for the byte count of a traced run
K1_CAPTURE_BYTES = 1 << 30


class Cell:
    """The program's render set up for one cell and seed."""

    def __init__(self, spec: dict, mix: dict, seed: int, device,
                 grid_dim=None, mix_overrides=None):
        from contrastive_lift_tpu_torch.config import load_config
        from contrastive_lift_tpu_torch.data.base import FrameData
        from contrastive_lift_tpu_torch.factory import (make_model_config,
                                                        make_render_config)
        from contrastive_lift_tpu_torch.inference import render as IR
        from contrastive_lift_tpu_torch.renderer import render as R

        self.spec, self.seed, self.device = spec, int(seed), device
        self.mix = {**mix, **(mix_overrides or {})}
        self.grid_dim = tuple(grid_dim or spec["grid_dim"])
        self.bounds = np.asarray(spec["scene_bounds"], np.float32)
        self.IR, self.R = IR, R
        self.ref = lookup.kind_module(self.mix["kind"], "reference")
        self.params = make_params(spec, seed, device, self.grid_dim)
        self.boxes = room_boxes(self.mix["room"], seed)
        write_room(self.params, self.mix["room"], self.boxes)
        cfg = load_config(overrides=dict(spec["config"]))
        self.mcfg = make_model_config(cfg, spec["num_semantic_classes"])
        check_model(self.mcfg, spec["model"])
        rcfg = make_render_config(cfg, self.bounds, self.grid_dim, self.mcfg,
                                  step_ratio=self.mix["step_ratio"],
                                  white_bg=False)
        self.rcfg = dataclasses.replace(rcfg, head_topk=self.mix["head_topk"])
        self.state = R.make_render_state(self.bounds, self.grid_dim,
                                         self.mix["step_ratio"], device=device)
        self.pool = []
        for call in range(self.mix["calls_in_pool"]):
            c2w = cameras.poses(self.mix, self.boxes, seed, call)
            rays = cameras.rays(self.mix, c2w, device).cpu().numpy()
            empty = np.zeros((0,), np.float32)
            self.pool.append([FrameData(f"{call:03d}_{i:02d}", r, empty,
                                        empty, empty, empty, empty, empty)
                              for i, r in enumerate(rays)])
        self.rays_per_call = (self.mix["frames_per_call"] * self.mix["height"]
                              * self.mix["width"])

    def call(self, i: int):
        """One ``render_frames`` call on the pool's call ``i``: the maps."""
        return self.IR.render_frames(
            self.params, self.mcfg, self.rcfg, self.state,
            self.pool[i % len(self.pool)], chunk=self.mix["chunk"],
            device=self.device, **self.mix.get("render_options", {}))


def check_model(mcfg, model: dict) -> None:
    """The program's model config has the configuration's widths."""
    want = {"num_density_comps": tuple(model["num_density_comps"]),
            "num_appearance_comps": tuple(model["num_appearance_comps"]),
            "dim_appearance": model["dim_appearance"],
            "pe_view": model["pe_view"], "pe_feat": model["pe_feat"],
            "dim_mlp_color": model["dim_mlp_color"],
            "dim_mlp_instance": model["mlp_width"],
            "splus_density_shift": model["splus_density_shift"],
            "instance_out_channels": model["instance_out"],
            "slow_fast_mode": len(model["instance_heads"]) == 2,
            "semantic_output_softmax": model["semantic_softmax"],
            "use_semantic_mlp": True, "use_instance_mlp": True,
            "use_distilled": False, "pe_sem": 0, "pe_ins": 0}
    got = {k: getattr(mcfg, k) for k in want}
    if got != want:
        raise RuntimeError(f"the program's model config {got} is not the "
                           f"configuration's {want}")


class Sampler:
    """The seeded rays of each completed call and the program's maps of
    them."""

    def __init__(self, cell: Cell, check: dict):
        self.cell, self.per_call = cell, check["rays_per_call"]
        self.cap = check["max_rays"]
        self.rays, self.maps = [], {k: [] for k in MAPS}
        self.failed = 0

    def keep(self, call: int, maps) -> None:
        if sum(map(len, self.rays)) >= self.cap:
            return
        frames = self.cell.pool[call % len(self.cell.pool)]
        hw = len(frames[0].rays)
        rng = np.random.default_rng([self.cell.seed, 0x434845434B, call])
        pick = np.sort(rng.choice(len(frames) * hw, self.per_call,
                                  replace=False))
        f, p = pick // hw, pick % hw
        if len(maps) != len(frames) or any(
                not np.all(np.isfinite(m[k])) for m in maps for k in MAPS):
            self.failed += 1
        self.rays.append(np.stack([frames[a].rays[b] for a, b in zip(f, p)]))
        for k in MAPS:
            self.maps[k].append(np.stack([maps[a][k][b] for a, b in zip(f, p)]))


def gaps(got: dict, want: dict) -> dict:
    """Per-ray gaps of each map: the largest absolute difference over its
    channels."""
    out = {}
    for k in MAPS:
        d = np.abs(np.asarray(got[k], np.float64)
                   - np.asarray(want[k], np.float64))
        out[k] = d.reshape(d.shape[0], -1).max(axis=1)
    return out


def check(cell: Cell, sampler: Sampler, limits: dict):
    """(numbers, reference counts): the program's maps of the sampled rays
    against the reference's. A number is the share of sampled rays whose gap
    in a map exceeds that map's ``tau``."""
    rays = torch.as_tensor(np.concatenate(sampler.rays), device=cell.device)
    want = cell.ref.render(cell.params, cell.spec["model"], rays,
                           cell.bounds, cell.grid_dim, cell.mix["step_ratio"])
    got = {k: np.concatenate(v) for k, v in sampler.maps.items()}
    g = gaps(got, {k: want[k].cpu().numpy() for k in MAPS})
    numbers = {}
    for k, lim in limits.items():
        numbers[k] = float(np.mean(g[lim["map"]] > lim["tau"]))
    counts = {"in_box": float(want["in_box"].float().mean()),
              "heads": float(want["heads"].float().mean()),
              "rays": int(rays.shape[0])}
    return numbers, counts


class Instruments:
    """The traced run's wrappers around the program's module attributes:
    ``prepare_render`` (host ms, with a synchronise so the grid build's
    device time is inside), ``render_rays`` (a span per chunk) and K1
    (``ops/brick_interp.py::sample_density_brick``: its positions, kept for
    the byte count, up to ``K1_CAPTURE_BYTES``)."""

    def __init__(self, cell: Cell):
        from contrastive_lift_tpu_torch.ops import brick_interp as bi
        self.cell, self.bi = cell, bi
        self.prepare_ms, self.k1 = [], []
        self.k1_bytes_kept = 0
        self.saved = (cell.IR.prepare_render, cell.R.render_rays,
                      bi.sample_density_brick)

    def __enter__(self):
        IR, R, bi = self.cell.IR, self.cell.R, self.bi
        prepare, render_rays, k1 = self.saved

        def prepare_render(*a, **kw):
            with torch.profiler.record_function("bench.prepare_render"):
                t0 = time.perf_counter()
                out = prepare(*a, **kw)
                torch.cuda.synchronize()
                self.prepare_ms.append((time.perf_counter() - t0) * 1e3)
            return out

        def chunk(*a, **kw):
            with torch.profiler.record_function("bench.render_rays"):
                return render_rays(*a, **kw)

        def density(atlas, xyz, grid_dim, splus_shift):
            nbytes = xyz.numel() * 4
            if self.k1_bytes_kept + nbytes <= K1_CAPTURE_BYTES:
                self.k1.append((xyz.clone(), tuple(grid_dim),
                                atlas.element_size()))
                self.k1_bytes_kept += nbytes
            else:
                self.k1.append(None)
            return k1(atlas, xyz, grid_dim, splus_shift)

        density.dtype_launches = k1.dtype_launches
        IR.prepare_render, R.render_rays = prepare_render, chunk
        bi.sample_density_brick = density
        return self

    def __exit__(self, *exc):
        (self.cell.IR.prepare_render, self.cell.R.render_rays,
         self.bi.sample_density_brick) = self.saved
        return False

    def k1_roofline(self, trace) -> dict | None:
        """Bytes over the HBM rate, over device time, for the launches whose
        positions were kept, matched in order to the trace's K1 kernels."""
        kernels = [o for o in trace.kernels()
                   if "sample_density_brick" in o[0]]
        if not kernels or len(kernels) != len(self.k1):
            return None
        need_s = dev_s = 0.0
        for launch, k in zip(self.k1, kernels):
            if launch is None:
                continue
            xyz, grid, elem = launch
            need_s += k1_bytes.launch_bytes(xyz, grid, elem) / k1_bytes.HBM_BYTES_PER_S
            dev_s += k[3] / 1e9
        return {"need_s": need_s, "device_s": dev_s,
                "launches": len(kernels)} if dev_s > 0 else None


def run(spec: dict, mix: dict, cell_name: str, seed: int, seconds: float,
        trace: bool, device, t_start: float, limits: dict,
        grid_dim=None, mix_overrides=None) -> dict:
    """One run of a render cell: the result's fields (``correct``,
    ``attempted``, ``failed``, ``metrics`` values, ``device`` extras,
    ``checks``, and with ``trace`` the reader context and breakdown)."""
    cell = Cell(spec, mix, seed, device, grid_dim, mix_overrides)
    cell.call(len(cell.pool) - 1)            # warm up: build, calibrate, launch
    if device.type == "cuda":
        torch.cuda.synchronize()
    setup_s = time.perf_counter() - t_start
    sampler = Sampler(cell, mix["check"])
    calls = 0
    inst = window = None

    def window_loop():
        nonlocal calls
        t0 = time.perf_counter()
        t_last = t0
        while time.perf_counter() - t0 < seconds:
            with torch.profiler.record_function("bench.render_frames"):
                maps = cell.call(calls)
            t_last = time.perf_counter()
            sampler.keep(calls, maps)
            del maps
            calls += 1
        return t_last - t0

    if trace:
        with Instruments(cell) as inst, tr.Window(torch) as window:
            elapsed = window_loop()
    else:
        elapsed = window_loop()
    peak = (torch.cuda.max_memory_allocated(device)
            if device.type == "cuda" else 0)
    k1 = inst.k1_roofline(window.trace) if trace else None
    if inst is not None:
        inst.k1.clear()              # the kept positions, before the check
    numbers, counts = check(cell, sampler, limits)
    correct = sampler.failed == 0 and all(
        numbers[k] <= lim["limit"] for k, lim in limits.items())
    rays = calls * cell.rays_per_call
    out = {"correct": correct, "attempted": calls, "failed": sampler.failed,
           "values": {"render_rays_per_s": rays / elapsed, "setup_s": setup_s},
           "memory_peak_bytes": int(peak),
           "checks": {k: {"value": numbers[k], "limit": lim["limit"]}
                      for k, lim in limits.items()}}
    if trace:
        t = window.trace
        out["trace"] = t
        out["context"] = {
            "trace": t, "rays": rays, "calls": calls,
            "prepare_ms": inst.prepare_ms, "k1": k1,
            "flops_per_ray": fl.render_flops(
                spec["model"], spec["num_semantic_classes"],
                counts["in_box"], counts["heads"]),
            "peak_flops": fl.PEAK[cell.rcfg.head_dtype]}
    return out
