#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port on one CUDA card and check it end to end.

    python3 chip_smoke.py [--profile]

Phases, each printing one JSON line with its seconds:

1. device   - the card (``nvidia-smi`` name and power limit, torch's name);
2. build    - nvcc builds ``contrastive_lift_tpu_torch/csrc/brick_interp.cu``
              into ``contrastive_lift_tpu_torch/_build/``;
3. kernels  - both kernel entry points against their plain PyTorch versions
              at the r5b shapes (a 131x131x121 N(0,1) density grid, its
              32,670-row atlas, 1,024 rays x 879 samples uniform in
              [-1.02, 1.02]^3 so out-of-box samples are exercised), with
              CUDA-event times of the kernel, the plain version and one
              library call (``F.grid_sample``) as yardstick, each with the
              50 MB L2 flushed before every timed call;
4. main     - the port's dense render of the committed r5b checkpoint on the
              4 val frames of its scene, then mean-shift and PQ^scene
              (``inference/fidelity.py::run_dense``), held against the JAX
              golden ``contrastive_lift_tpu_torch/testdata/
              r5b_dense_golden.npz``: maps within 1e-3 at the golden's 2,048
              rays, PQ^scene and masked PQ within 0.5 pt. The launch counts
              are zeroed just before and read just after; the density kernel
              must have run;
5. profile  - only with ``--profile``: one more render of the 4 val frames
              under ``torch.profiler``, with its wall and device seconds, the
              idle share, device time by kernel kind (matmul, density
              kernel, other) and the top kernels.

Then one line ``{"kernels": [...]}`` and, last, ``{"ok": true, "device":
{...}}``. Any failed check raises and the script exits non-zero; without a
CUDA device, or without the rest of the repository beside it, it exits
non-zero before printing any result.
"""
import argparse
import json
import subprocess
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parent
GOLDEN = ROOT / "contrastive_lift_tpu_torch" / "testdata" / "r5b_dense_golden.npz"
TPU_KERNEL = "contrastive_lift_tpu/ops/pallas_interp.py:64"
KERNEL_SOURCE = "contrastive_lift_tpu_torch/csrc/brick_interp.cu"

# r5b: grid 131x131x121, 879 samples per ray at step_ratio 0.25, chunks of
# 1,024 rays (its scene and checkpoint are in inference/fidelity.py)
GRID = (131, 131, 121)
SAMPLES_PER_CHUNK = 1024 * 879
KERNEL_TOL = 1e-5
MAP_TOL = 1e-3
PQ_TOL = 0.005
# H100 SXM peaks from NVIDIA's data sheet: HBM bytes/s, fp32 FLOP/s (non-tensor)
HBM_BYTES_PER_S = 3.35e12
FP32_FLOP_PER_S = 67e12
# flops per sample of the fused kernel: coordinates (~18), six hat weights
# (24), twelve weight products, eight multiply-adds (16) and the shift
FLOPS_PER_SAMPLE = 70
# written before every timed call: more than twice the H100's 50 MB L2
L2_FLUSH_BYTES = 128 << 20
# about 0.1 s of spinning at the H100's 1.98 GHz boost clock: longer than
# the host takes to queue any timed loop here
SPIN_CYCLES = 200_000_000


def emit(record: dict) -> None:
    print(json.dumps(record), flush=True)


def cuda_ms(fn, iters: int = 20, warmup: int = 3, flush: bool = True) -> float:
    """Mean milliseconds per call by CUDA events, after a warm-up. A spin
    kernel holds the device while every timed call is queued, so no event
    pair spans a wait for the host. With ``flush`` the L2 is overwritten
    before every timed call, as the render leaves it: its head MLPs move
    about a GB between density launches."""
    import torch
    scratch = torch.empty(L2_FLUSH_BYTES // 4, device="cuda")
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    torch.cuda._sleep(SPIN_CYCLES)
    events = []
    for _ in range(iters):
        if flush:
            scratch.zero_()
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        fn()
        end.record()
        events.append((start, end))
    torch.cuda.synchronize()
    return sum(s.elapsed_time(e) for s, e in events) / iters


def bound(n_bytes: float, n_flops: float):
    """(bound_ms, bound_by): the larger of bytes over the HBM rate and fp32
    operations over the fp32 peak."""
    t_bytes = n_bytes / HBM_BYTES_PER_S * 1e3
    t_ops = n_flops / FP32_FLOP_PER_S * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


def dense_yardstick(dense, xyz, shift: float):
    """One ``F.grid_sample`` call on the dense [gx,gy,gz] grid: the same
    trilinear value as ``sample_density_brick`` for samples in the box. The
    views are made here, so the returned call times only the library."""
    import torch.nn.functional as F
    vol = dense.permute(2, 1, 0).contiguous()[None, None]
    grid = xyz.view(1, 1, 1, -1, 3)
    return lambda: F.grid_sample(vol, grid, mode="bilinear",
                                 padding_mode="zeros",
                                 align_corners=True).view(-1) + shift


def lattice_yardstick(rows, frac):
    """One ``F.grid_sample`` call on each [128] row viewed as its 5^3 lattice
    (lane a*25+b*5+c is D=a, H=b, W=c): zero padding gives the clamped hat
    weights, so this is ``brick_interp`` for every frac."""
    import torch.nn.functional as F
    n = rows.shape[0]
    lattice = rows.as_strided((n, 1, 5, 5, 5), (128, 128, 25, 5, 1))
    grid = (frac[:, [2, 1, 0]] * 0.5 - 1.0).view(n, 1, 1, 1, 3)
    return lambda: F.grid_sample(lattice, grid, mode="bilinear",
                                 padding_mode="zeros",
                                 align_corners=True).view(n)


def phase_device():
    import torch
    t0 = time.perf_counter()
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True, check=True)
    print(smi.stdout.strip().splitlines()[0], flush=True)
    name = torch.cuda.get_device_name(0)
    emit({"phase": "device", "kind": name,
          "count": torch.cuda.device_count(),
          "torch": torch.__version__, "cuda": torch.version.cuda,
          "seconds": time.perf_counter() - t0})
    return name


def phase_build():
    from contrastive_lift_tpu_torch.ops import brick_interp as bi
    t0 = time.perf_counter()
    lib = bi.build()
    emit({"phase": "build", "library": str(lib.relative_to(ROOT)),
          "seconds": time.perf_counter() - t0})


def phase_kernels():
    import torch
    from contrastive_lift_tpu_torch.ops import brick_interp as bi
    from contrastive_lift_tpu_torch.ops.fused_grid import build_brick_atlas

    t0 = time.perf_counter()
    gen = torch.Generator(device="cuda").manual_seed(0)
    dense = torch.randn(GRID, generator=gen, device="cuda")
    atlas = build_brick_atlas(dense)
    xyz = torch.rand((SAMPLES_PER_CHUNK, 3), generator=gen,
                     device="cuda") * 2.04 - 1.02
    shift = -10.0
    n = xyz.shape[0]
    records = {}

    # fused entry: the form the render calls
    got = bi.sample_density_brick(atlas, xyz, GRID, shift)
    ref = bi.sample_density_brick_reference(atlas, xyz, GRID, shift)
    torch.cuda.synchronize()
    err = float((got - ref).abs().max())
    library = dense_yardstick(dense, xyz, shift)
    in_box = (xyz.abs() <= 1.0).all(dim=1)
    in_box_err = float((library() - got)[in_box].abs().max())
    b_ms, b_by = bound(4 * (atlas.numel() + xyz.numel() + n),
                       FLOPS_PER_SAMPLE * n)
    records["sample_density_brick"] = {
        "max_abs_err": err, "library_in_box_max_abs_err": in_box_err,
        "ms": cuda_ms(lambda: bi.sample_density_brick(atlas, xyz, GRID, shift)),
        "l2_warm_ms": cuda_ms(lambda: bi.sample_density_brick(
            atlas, xyz, GRID, shift), flush=False),
        "plain_ms": cuda_ms(lambda: bi.sample_density_brick_reference(
            atlas, xyz, GRID, shift)),
        "bound_ms": b_ms, "bound_by": b_by, "library_ms": cuda_ms(library)}

    # literal counterpart of the Pallas kernel: gathered rows + positions
    row, frac = bi.brick_coords(GRID, xyz)
    rows = atlas[row].contiguous()
    frac = frac.contiguous()
    got = bi.brick_interp(rows, frac)
    ref = bi.brick_interp_reference(rows, frac)
    library_rows = lattice_yardstick(rows, frac)
    lib_err = float((library_rows() - got).abs().max())
    torch.cuda.synchronize()
    # the function needs the 8 lanes of each row whose hat weight can be
    # non-zero (which 8 depends on frac), not the whole 128-lane row
    b_ms, b_by = bound(4 * (8 * n + frac.numel() + n), FLOPS_PER_SAMPLE * n)
    records["brick_interp"] = {
        "max_abs_err": float((got - ref).abs().max()),
        "library_max_abs_err": lib_err,
        "ms": cuda_ms(lambda: bi.brick_interp(rows, frac)),
        "plain_ms": cuda_ms(lambda: bi.brick_interp_reference(rows, frac)),
        "bound_ms": b_ms, "bound_by": b_by, "library_ms": cuda_ms(library_rows)}

    emit({"phase": "kernels", "samples": n, "atlas_rows": atlas.shape[0],
          "out_of_box_samples": int((~in_box).sum()), "tolerance": KERNEL_TOL,
          **{f"{k}_{m}": v[m] for k, v in records.items() for m in v},
          "seconds": time.perf_counter() - t0})
    for name, rec in records.items():
        if not rec["max_abs_err"] <= KERNEL_TOL:
            raise AssertionError(f"{name}: kernel vs plain max abs err "
                                 f"{rec['max_abs_err']} > {KERNEL_TOL}")
    if not records["brick_interp"]["library_max_abs_err"] <= KERNEL_TOL:
        raise AssertionError("brick_interp: F.grid_sample yardstick computes "
                             "another function")
    return records


def phase_main():
    import numpy as np
    import torch
    from contrastive_lift_tpu_torch.inference.fidelity import (
        R5B_CKPT, R5B_SCENE, e2e_scene, run_dense)
    from contrastive_lift_tpu_torch.ops import brick_interp as bi

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    scene = e2e_scene(*R5B_SCENE)
    kernels = (bi.brick_interp, bi.sample_density_brick)
    for k in kernels:
        k.launches = 0
    t0 = time.perf_counter()
    res = run_dense(R5B_CKPT, scene, device="cuda")
    seconds = time.perf_counter() - t0
    launches = {k.__name__: k.launches for k in kernels}
    # a second, warm run: steady-state render time, and the same scores
    warm = run_dense(R5B_CKPT, scene, device="cuda")

    n_rays = sum(len(f.rays) for f in scene.val_frames)
    with np.load(GOLDEN) as g:
        idx = g["ray_index"]
        map_err = {key: float(np.abs(np.concatenate(
            [f[key] for f in res["maps"]])[idx] - g[key]).max())
            for key in ("rgb", "semantics", "instances", "depth")}
        gold = {key: float(g[key]) for key in ("pq_scene", "pq_masked",
                                               "sq", "rq")}
    emit({"phase": "main", "grid_dim": list(res["grid_dim"]),
          "n_samples": res["n_samples"], "rays": n_rays,
          "launches": launches, "map_max_abs_err": map_err,
          **{k: res[k] for k in ("pq_scene", "pq_masked", "sq", "rq")},
          "golden": gold,
          "render_seconds": res["render_seconds"],
          "cluster_seconds": res["cluster_seconds"],
          "rays_per_second": n_rays / res["render_seconds"],
          "warm_render_seconds": warm["render_seconds"],
          "warm_cluster_seconds": warm["cluster_seconds"],
          "warm_rays_per_second": n_rays / warm["render_seconds"],
          "warm_pq_scene": warm["pq_scene"],
          "warm_pq_masked": warm["pq_masked"],
          "seconds": seconds})
    if launches["sample_density_brick"] < 1:
        raise AssertionError("the main path never launched sample_density_brick")
    if res["n_samples"] != 879 or tuple(res["grid_dim"]) != GRID:
        raise AssertionError(f"unexpected r5b shapes {res['grid_dim']} "
                             f"{res['n_samples']}")
    for key, err in map_err.items():
        if not err <= MAP_TOL:
            raise AssertionError(f"{key} map differs from the JAX golden by "
                                 f"{err} > {MAP_TOL}")
    for key in ("pq_scene", "pq_masked"):
        for run in (res, warm):
            if not abs(run[key] - gold[key]) <= PQ_TOL:
                raise AssertionError(f"{key} {run[key]} vs JAX golden "
                                     f"{gold[key]}: beyond {PQ_TOL}")
    return launches


def _device_us(event) -> float:
    # renamed from self_cuda_time_total in recent PyTorch releases
    for attr in ("self_device_time_total", "self_cuda_time_total"):
        if hasattr(event, attr):
            return float(getattr(event, attr))
    return 0.0


def _kernel_kind(name: str) -> str:
    if "sample_density_brick" in name or "brick_interp" in name:
        return "density_kernel"
    if "gemm" in name.lower() or "cutlass" in name.lower():
        return "matmul"
    return "other"


def phase_profile(top: int = 12):
    """A warm render of the 4 val frames under torch.profiler: where the
    device time goes, and the device's idle share."""
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    from contrastive_lift_tpu_torch.inference.fidelity import (
        CHUNK, R5B_CKPT, R5B_SCENE, e2e_scene, load_dense)
    from contrastive_lift_tpu_torch.inference.render import render_frames

    t0 = time.perf_counter()
    scene = e2e_scene(*R5B_SCENE)
    _, params, mcfg, rcfg, state_r, _ = load_dense(R5B_CKPT, scene)

    def render():
        render_frames(params, mcfg, rcfg, state_r, scene.val_frames,
                      chunk=CHUNK)
        torch.cuda.synchronize()

    render()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t_wall = time.perf_counter()
        render()
        wall = time.perf_counter() - t_wall
    # kernel events only: a CPU op's own entry repeats its kernels' time
    kernels = [(e.key, _device_us(e), e.count) for e in prof.key_averages()
               if e.device_type == DeviceType.CUDA and _device_us(e) > 0]
    busy_s = sum(us for _, us, _ in kernels) / 1e6
    by_kind = {}
    for kname, us, _ in kernels:
        kind = _kernel_kind(kname)
        by_kind[kind] = by_kind.get(kind, 0.0) + us / 1e3
    kernels.sort(key=lambda k: -k[1])
    emit({"phase": "profile", "rays": sum(len(f.rays) for f in scene.val_frames),
          "wall_s": wall, "device_busy_s": busy_s,
          "idle_share": 1.0 - busy_s / wall, "device_ms_by_kind": by_kind,
          "top": [{"name": kname[:100], "device_ms": us / 1e3, "calls": count}
                  for kname, us, count in kernels[:top]],
          "seconds": time.perf_counter() - t0})
    if busy_s <= 0.0:
        raise AssertionError("the profiler recorded no device time")


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--profile", action="store_true",
                    help="also profile one warm render of the main path")
    args = ap.parse_args()
    import torch
    if not torch.cuda.is_available():
        print("chip_smoke: torch.cuda.is_available() is False; this script "
              "needs a CUDA card", file=sys.stderr)
        return 2
    for needed in (GOLDEN, ROOT / KERNEL_SOURCE):
        if not needed.exists():
            print(f"chip_smoke: {needed} is missing; run from a checkout of "
                  "the repository", file=sys.stderr)
            return 2
    sys.path.insert(0, str(ROOT))
    name = phase_device()
    phase_build()
    records = phase_kernels()
    launches = phase_main()
    if args.profile:
        phase_profile()
    emit({"kernels": [
        {"name": kname, "route": "cuda", "source": KERNEL_SOURCE,
         "replaces": TPU_KERNEL, "launches": launches[kname],
         **{k: records[kname][k] for k in ("max_abs_err", "ms", "plain_ms",
                                            "bound_ms", "bound_by",
                                            "library_ms")}}
        for kname in ("brick_interp", "sample_density_brick")]})
    emit({"ok": True, "device": {"platform": "gpu", "kind": name,
                                 "count": torch.cuda.device_count()}})
    return 0


if __name__ == "__main__":
    sys.exit(main())
