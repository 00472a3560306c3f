#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port on one CUDA card and check it end to end.

    python3 chip_smoke.py [--profile] [--against SOURCE.cu ...]

Phases, each printing JSON lines with their seconds:

1. device  - the card (``nvidia-smi`` name and power limit, torch's name);
2. build   - nvcc builds ``contrastive_lift_tpu_torch/csrc/brick_interp.cu``
             into ``contrastive_lift_tpu_torch/_build/``;
3. kernels - both kernel entry points, on float32 and on bfloat16 rows,
             against their plain PyTorch versions on two input sets at the
             r5b dense chunk shape (1,024 rays x 879 samples):
             ``random``: a 131x131x121 N(0,1) density grid and samples
             uniform in [-1.02, 1.02]^3 (out-of-box samples included);
             ``render_chunk``: the r5b checkpoint's own density grid and the
             samples of the first 1,024 rays of val frame 0, exactly as the
             dense render passes them to the kernel
             (``inference/fidelity.py::render_chunk``);
             and the fused form on a third set, ``production_chunk``: the
             pass-A samples of the first 4,096-ray chunk of the production
             render of val frame 0 (4,096 rays x 12 sub-segments x 8 samples
             at the calibrated budgets), exactly as ``_fine_density`` passes
             them to the kernel (``inference/fidelity.py::production_chunk``).
             The literal form gets the atlas rows gathered at the samples.
             One line per form x input set x type: the kernel's CUDA-event
             time as the median and spread of 5 repeats of a 20-launch loop,
             with the 50 MB L2 flushed before every launch (as the render
             leaves it) and L2-warm; the plain version's time; one library
             call's time (``F.grid_sample``, the same function; bf16 values
             upcast to float32 outside the timed call) as yardstick; the
             bound (the bytes these inputs need over the HBM rate: each
             needed row element once, positions in, values out) and the
             kernel's share of it; the sector floor (the same with each
             needed 32-B sector read whole); for the literal form the 64-B
             pieces its corner lanes lie in; two yardsticks of the timing
             itself: an empty kernel, and one library copy that reads the
             positions' memory and writes one float per sample (their first
             column), the kernel's traffic without the rows; and, with
             ``--against``, the same kernel built from other sources of
             ``brick_interp.cu`` (an earlier commit's), timed on the same
             inputs in the same process;
4. main    - the port's dense render of the committed r5b checkpoint on the
             4 val frames of its scene, then mean-shift and PQ^scene
             (``inference/fidelity.py::run_dense``), held against the JAX
             golden ``contrastive_lift_tpu_torch/testdata/
             r5b_dense_golden.npz``: maps within 1e-3 at the golden's 2,048
             rays, PQ^scene and masked PQ within 0.5 pt. The launch counts
             are zeroed just before and read just after; the float32
             density kernel must have run;
5. main_bf16_atlas - the same render with ``atlas_dtype="bfloat16"`` (heads
             fp32, TF32 off): the bfloat16 density kernel must have run (and
             the float32 one not), PQ^scene and masked PQ within 0.5 pt of
             the golden (the bar of ``tools/pq_fidelity_gate.py
             --atlas_dtype bfloat16``); the maps' distance from the golden
             is printed, not gated;
6. main_production - the production render (``render_frames`` defaults:
             empty-space skipping with calibrated budgets and two-pass
             termination, top-8 bf16 heads with tail completion, chunks of
             4,096 rays; ``inference/fidelity.py::run_production``), cold and
             warm, TF32 off, then mean-shift and PQ^scene, held against the
             eager JAX golden ``contrastive_lift_tpu_torch/testdata/
             r5b_production_golden.npz``: calibrated budgets equal, maps
             within 3e-2 (bf16 heads) at the golden's 2,048 rays, PQ^scene
             and masked PQ within 0.5 pt, the same guardrail warnings (none
             unless the golden raised one; compared by guardrail, the values
             they quote are printed), and the float32 density kernel
             launched; the warm rays/s is printed beside the dense path's;
7. train_r5b - one training step of r5b (``train/resume.py``): resumed
             from ``final.npz`` and its optimizer state on ``cuda`` with r5b's
             own configuration, the head budget calibrated, step 1 on the
             batches of the golden's sampler seed and the golden's random
             draws with TF32 off, held against the eager JAX golden
             ``contrastive_lift_tpu_torch/testdata/r5b_train_step_golden.npz``:
             the budget equal, every loss and guardrail within rtol 2e-3,
             every parameter leaf's sketches (its main-phase and
             instance-phase gradients, its value after the step and its
             change) within 4.5e-2; then 10 more steps on the port's own
             samplers and generator, every metric finite, with the warm
             steps/s, rays/s and peak device memory beside the card's name
             and power limit;
8. profile - only with ``--profile``: one more warm render of the 4 val
             frames on the dense path and one on the production path under
             ``torch.profiler``, each with its wall and device seconds, the
             idle share, device time by kernel kind (matmul, density kernel,
             sort/top-k, other elementwise) and the top kernels; and one warm
             training step the same way, by training kind (K8 grid sampling,
             K9 and other gathers and scatters, K10 and compositing scans,
             head matmuls, the Adam updates), with K8-K10 also timed alone
             at the step's shapes against their bounds.

Then one line ``{"kernels": [...]}`` (each entry point and row type, timed
on the render-chunk inputs, the fused form also on the production chunk) and,
last, ``{"ok": true, "device": {...}}``.
Any failed check raises and the script exits non-zero; without a CUDA
device, or without the rest of the repository beside it, it exits non-zero
before printing any result.
"""
import argparse
import json
import subprocess
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parent
GOLDEN = ROOT / "contrastive_lift_tpu_torch" / "testdata" / "r5b_dense_golden.npz"
PRODUCTION_GOLDEN = GOLDEN.with_name("r5b_production_golden.npz")
TRAIN_GOLDEN = GOLDEN.with_name("r5b_train_step_golden.npz")
# warm steps of train_r5b after step 1, and the sampler seed of those
TRAIN_STEPS = 10
TRAIN_STEP_SEED = 1
TPU_KERNEL = "contrastive_lift_tpu/ops/pallas_interp.py:64"
KERNEL_SOURCE = "contrastive_lift_tpu_torch/csrc/brick_interp.cu"

# r5b: grid 131x131x121, 879 samples per ray at step_ratio 0.25, chunks of
# 1,024 rays (its scene and checkpoint are in inference/fidelity.py)
GRID = (131, 131, 121)
SAMPLES_PER_CHUNK = 1024 * 879
DTYPES = ("float32", "bfloat16")
# kernel vs plain: float32 sums of the same (widened) values, in another
# order. On the random set (N(0,1) grid) the bar is absolute; the r5b grid's
# densities reach ~100, where one float32 step is 7.6e-6, so on the render
# chunk the bar scales with the size of the terms summed: |err| <= KERNEL_TOL
# * max(1, sum |row * w|)
KERNEL_TOL = 1e-5
MAP_TOL = 1e-3
# bf16 heads against the JAX package's bf16 heads: the bar it accepts for
# bf16 against fp32 heads
BF16_MAP_TOL = 3e-2
PQ_TOL = 0.005
# H100 SXM peaks from NVIDIA's data sheet: HBM bytes/s, fp32 FLOP/s (non-tensor)
HBM_BYTES_PER_S = 3.35e12
FP32_FLOP_PER_S = 67e12
# flops per sample of the fused kernel: coordinates (~18), six hat weights
# (24), twelve weight products, eight multiply-adds (16) and the shift
FLOPS_PER_SAMPLE = 70
# HBM and L2 move data in 32-B sectors; scattered reads are served from
# device memory in 64-B pieces
SECTOR_BYTES = 32
PIECE_BYTES = 64
# lanes of a sample's 2x2x2 corners, relative to lane a0*25+b0*5+c0
CORNER_LANES = (0, 1, 5, 6, 25, 26, 30, 31)
# written before every timed call: more than twice the H100's 50 MB L2
L2_FLUSH_BYTES = 128 << 20
# about 25 ms of spinning at the H100's 1.98 GHz boost clock: longer than
# the host takes to queue any timed loop here
SPIN_CYCLES = 50_000_000
# each time is the median of REPEATS loops of ITERS launches
REPEATS = 5
ITERS = 20


def emit(record: dict) -> None:
    print(json.dumps(record), flush=True)


def cuda_ms(fn, iters: int = ITERS, warmup: int = 3, flush: bool = True) -> float:
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


def timed(fn, flush: bool = True):
    """(median, max - min) of ``cuda_ms`` over REPEATS loops."""
    runs = sorted(cuda_ms(fn, flush=flush) for _ in range(REPEATS))
    return runs[len(runs) // 2], runs[-1] - runs[0]


def bound(n_bytes: float, n_flops: float):
    """(bound_ms, bound_by): the larger of bytes over the HBM rate and fp32
    operations over the fp32 peak."""
    t_bytes = n_bytes / HBM_BYTES_PER_S * 1e3
    t_ops = n_flops / FP32_FLOP_PER_S * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


def weighted(frac):
    """[P] whether a sample has a non-zero hat weight on every axis (frac in
    (-1, 5)): samples without one have value 0 and need no row data."""
    return ((frac > -1.0) & (frac < 5.0)).all(dim=1)


def corner_lanes(frac):
    """[P,8] the lanes of each sample's 2x2x2 corners, ascending."""
    import torch
    lo = torch.clamp(torch.floor(frac), 0, 3).to(torch.int64)
    base = lo[:, 0] * 25 + lo[:, 1] * 5 + lo[:, 2]
    return base[:, None] + torch.tensor(CORNER_LANES, device=frac.device)


def corner_blocks(frac, elem_bytes: int, block_bytes: int):
    """[P] count of distinct ``block_bytes`` blocks of its row that each
    sample's 8 corner lanes occupy (rows start on a block boundary); 0 for
    samples that need no row data."""
    blocks = corner_lanes(frac) * elem_bytes // block_bytes
    return (1 + (blocks[:, 1:] != blocks[:, :-1]).sum(dim=1)) * weighted(frac)


def atlas_needs(row, frac, elem_bytes: int):
    """(elements, 32-B sectors) of the atlas that samples with a non-zero
    weight read, each counted once however many samples read it."""
    import torch
    w = weighted(frac)
    elems = torch.unique(row[w, None] * 128 + corner_lanes(frac[w]))
    return (int(elems.numel()),
            int(torch.unique(elems * elem_bytes // SECTOR_BYTES).numel()))


def scaled_err(got, ref, magnitude):
    """max |got - ref| / max(1, magnitude): the kernel bar's measure."""
    import torch
    return float(((got - ref).abs() / torch.clamp(magnitude, min=1.0)).max())


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


def card_line() -> str:
    """The card's name and power limit, as nvidia-smi gives them."""
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True, check=True)
    return smi.stdout.strip().splitlines()[0]


def phase_device():
    import torch
    t0 = time.perf_counter()
    print(card_line(), flush=True)
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


def kernel_inputs():
    """name -> (dense float32 grid [gx,gy,gz], xyz [P,3], splus shift)."""
    import numpy as np
    import torch
    from contrastive_lift_tpu_torch.inference.fidelity import (
        PRODUCTION_CHUNK, R5B_CKPT, R5B_SCENE, e2e_scene, production_chunk,
        render_chunk)
    gen = torch.Generator(device="cuda").manual_seed(0)
    dense = torch.randn(GRID, generator=gen, device="cuda")
    xyz = torch.rand((SAMPLES_PER_CHUNK, 3), generator=gen,
                     device="cuda") * 2.04 - 1.02
    scene = e2e_scene(*R5B_SCENE)
    chunk = render_chunk(R5B_CKPT, scene, device="cuda")
    if tuple(chunk[0].shape) != GRID or chunk[2].shape != xyz.shape:
        raise AssertionError(f"unexpected r5b chunk shapes "
                             f"{tuple(chunk[0].shape)} {tuple(chunk[2].shape)}")
    prod = production_chunk(R5B_CKPT, scene, device="cuda")
    with np.load(PRODUCTION_GOLDEN) as g:
        # pass A: term_first sub-segments of 8 samples for every ray
        n_prod = PRODUCTION_CHUNK * int(g["budget_term_first"]) * 8
    if prod[2].shape != (n_prod, 3):
        raise AssertionError(f"unexpected r5b production chunk shape "
                             f"{tuple(prod[2].shape)}, expected {n_prod} "
                             "samples")
    return {"random": (dense, xyz, -10.0),
            "render_chunk": (chunk[0], chunk[2].contiguous(), chunk[1]),
            "production_chunk": (prod[0], prod[2].contiguous(), prod[1])}


def time_case(kernel, plain, library, positions):
    """The timings every case reports; ``positions`` is the [P,3] input the
    kernel streams (xyz or frac)."""
    ms, spread = timed(kernel)
    warm, warm_spread = timed(kernel, flush=False)
    lib_ms, lib_spread = timed(library)
    return {"ms": ms, "ms_spread": spread, "l2_warm_ms": warm,
            "l2_warm_spread": warm_spread, "plain_ms": timed(plain)[0],
            "library_ms": lib_ms, "library_spread": lib_spread,
            "stream_ms": timed(lambda: positions[:, 0].clone())[0]}


# other sources of csrc/brick_interp.cu (``--against``), timed beside the
# repository's on the same inputs
OTHER_SOURCES = []


def other_library(source: Path):
    """(library, takes_bf16) for another source of the kernel, built with the
    repository's nvcc flags. A source whose C entry points take no row-type
    argument (the float32-only interface) has takes_bf16 False."""
    import ctypes
    import hashlib
    from contrastive_lift_tpu_torch.ops import brick_interp as bi

    text = source.read_bytes()
    out = bi.BUILD_DIR / f"against_{hashlib.sha256(text).hexdigest()[:16]}.so"
    if not out.exists():
        bi.BUILD_DIR.mkdir(parents=True, exist_ok=True)
        subprocess.run([bi._nvcc(), *bi.NVCC_FLAGS, "-o", str(out),
                        str(source)], check=True, capture_output=True)
    lib = ctypes.CDLL(str(out))
    typed = b"int atlas_bf16" in text
    p, i64, i32 = ctypes.c_void_p, ctypes.c_int64, ctypes.c_int
    row_type = [i32] if typed else []
    lib.brick_interp_launch.argtypes = [p, *row_type, p, p, i64, p]
    lib.sample_density_brick_launch.argtypes = [
        p, *row_type, p, p, i64, i32, i32, i32, ctypes.c_float, p]
    return lib, typed


def other_call(source: Path, kname: str, rows, positions, *grid_args):
    """A call of ``kname`` from another source on the same inputs as the
    repository's wrapper, or None when that source does not take this row
    type. Not counted as a launch of the repository's kernel."""
    import torch
    from contrastive_lift_tpu_torch.ops import brick_interp as bi

    lib, typed = other_library(source)
    if rows.dtype != torch.float32 and not typed:
        return None
    n = positions.shape[0]
    out = torch.empty(n, dtype=torch.float32, device=rows.device)
    head = [rows.data_ptr()] + ([bi.ROW_DTYPES[rows.dtype]] if typed else [])
    tail = []
    if grid_args:
        grid, shift = grid_args
        tail = [*(int(g) for g in grid), float(shift)]

    def call():
        err = getattr(lib, kname + "_launch")(
            *head, positions.data_ptr(), out.data_ptr(), n, *tail,
            torch.cuda.current_stream().cuda_stream)
        if err:
            raise RuntimeError(f"{source} {kname}: cudaError {err}")
        return out
    return call


def time_other(source: Path, kname: str, ref, magnitude, rows, positions,
               *grid_args):
    """Another source's kernel on the same inputs: its error against the
    plain version and its time, measured as the repository's."""
    call = other_call(source, kname, rows, positions, *grid_args)
    if call is None:
        return {"source": str(source), "ms": None}
    got = call()
    ms, spread = timed(call)
    return {"source": str(source), "ms": ms, "ms_spread": spread,
            "max_abs_err": float((got - ref).abs().max()),
            "max_scaled_err": scaled_err(got, ref, magnitude)}


def fused_case(dense, xyz, shift, dtype):
    import torch
    from contrastive_lift_tpu_torch.ops import brick_interp as bi
    from contrastive_lift_tpu_torch.ops.fused_grid import build_brick_atlas

    n = xyz.shape[0]
    atlas = build_brick_atlas(dense, getattr(torch, dtype))
    got = bi.sample_density_brick(atlas, xyz, GRID, shift)
    ref = bi.sample_density_brick_reference(atlas, xyz, GRID, shift)
    magnitude = bi.sample_density_brick_reference(atlas.abs(), xyz, GRID, 0.0)
    # the library reads the atlas's values, upcast outside the timed call
    library = dense_yardstick(dense.to(atlas.dtype).float(), xyz, shift)
    in_box = (xyz.abs() <= 1.0).all(dim=1)
    row, frac = bi.brick_coords(GRID, xyz)
    rows_touched = int(torch.unique(row[weighted(frac)]).numel())
    elems, sectors = atlas_needs(row, frac, atlas.element_size())
    torch.cuda.synchronize()
    # the atlas elements these samples need, once; positions in, values out
    b_ms, b_by = bound(elems * atlas.element_size() + 16 * n,
                       FLOPS_PER_SAMPLE * n)
    floor_ms, _ = bound(SECTOR_BYTES * sectors + 16 * n, 0)
    rec = {"max_abs_err": float((got - ref).abs().max()),
           "max_scaled_err": scaled_err(got, ref, magnitude),
           "library_in_box_max_abs_err": float(
               (library() - got)[in_box].abs().max()),
           "out_of_box_samples": int((~in_box).sum()),
           "atlas_rows": atlas.shape[0], "rows_touched": rows_touched,
           "elements_touched": elems, "sectors_touched": sectors,
           **time_case(lambda: bi.sample_density_brick(atlas, xyz, GRID, shift),
                       lambda: bi.sample_density_brick_reference(
                           atlas, xyz, GRID, shift), library, xyz),
           "bound_ms": b_ms, "bound_by": b_by, "sector_floor_ms": floor_ms,
           "against": [time_other(src, "sample_density_brick", ref,
                                  magnitude, atlas, xyz, GRID, shift)
                       for src in OTHER_SOURCES]}
    return rec


def literal_case(dense, xyz, dtype):
    import torch
    from contrastive_lift_tpu_torch.ops import brick_interp as bi
    from contrastive_lift_tpu_torch.ops.fused_grid import build_brick_atlas

    n = xyz.shape[0]
    atlas = build_brick_atlas(dense, getattr(torch, dtype))
    row, frac = bi.brick_coords(GRID, xyz)
    rows = atlas[row].contiguous()
    frac = frac.contiguous()
    del atlas, row
    got = bi.brick_interp(rows, frac)
    ref = bi.brick_interp_reference(rows, frac)
    magnitude = bi.brick_interp_reference(rows.abs(), frac)
    library = lattice_yardstick(rows.float(), frac)
    lib_got = library()
    esize = rows.element_size()
    sectors = corner_blocks(frac, esize, SECTOR_BYTES)
    pieces = corner_blocks(frac, esize, PIECE_BYTES)
    n_weighted = int(weighted(frac).sum())
    torch.cuda.synchronize()
    # the function needs the 8 lanes of each row whose hat weight can be
    # non-zero (which 8 depends on frac), not the whole 128-lane row, and
    # none of a row whose sample has no non-zero weight on some axis
    b_ms, b_by = bound(8 * esize * n_weighted + 16 * n, FLOPS_PER_SAMPLE * n)
    floor_ms, _ = bound(SECTOR_BYTES * float(sectors.sum()) + 16 * n, 0)
    rec = {"max_abs_err": float((got - ref).abs().max()),
           "max_scaled_err": scaled_err(got, ref, magnitude),
           "library_max_abs_err": float((lib_got - got).abs().max()),
           "library_max_scaled_err": scaled_err(lib_got, got, magnitude),
           "weighted_samples": n_weighted,
           "sectors_per_sample": float(sectors.float().mean()),
           "pieces64_per_sample": float(pieces.float().mean()),
           **time_case(lambda: bi.brick_interp(rows, frac),
                       lambda: bi.brick_interp_reference(rows, frac), library,
                       frac),
           "bound_ms": b_ms, "bound_by": b_by, "sector_floor_ms": floor_ms,
           "against": [time_other(src, "brick_interp", ref, magnitude, rows,
                                  frac)
                       for src in OTHER_SOURCES]}
    return rec


def phase_kernels():
    """records[(kernel, inputs, dtype)] for every case; raises on a kernel
    that disagrees with its plain version or a yardstick that computes
    another function."""
    import torch
    records = {}
    # what the timing loop gives an empty kernel
    empty_kernel_ms = timed(lambda: torch.cuda._sleep(0))[0]
    for inputs, (dense, xyz, shift) in kernel_inputs().items():
        for dtype in DTYPES:
            cases = [("sample_density_brick",
                      lambda: fused_case(dense, xyz, shift, dtype))]
            # the production path reads the atlas through the fused form only
            if inputs != "production_chunk":
                cases.append(("brick_interp",
                              lambda: literal_case(dense, xyz, dtype)))
            for kname, case in cases:
                t0 = time.perf_counter()
                rec = case()
                rec["bound_share"] = rec["bound_ms"] / rec["ms"]
                rec["empty_kernel_ms"] = empty_kernel_ms
                records[(kname, inputs, dtype)] = rec
                emit({"phase": "kernels", "kernel": kname, "inputs": inputs,
                      "dtype": dtype, "samples": xyz.shape[0],
                      "tolerance": KERNEL_TOL, **rec,
                      "seconds": time.perf_counter() - t0})
                torch.cuda.empty_cache()
                measure = "max_abs_err" if inputs == "random" else "max_scaled_err"
                if not rec[measure] <= KERNEL_TOL:
                    raise AssertionError(
                        f"{kname} {inputs} {dtype}: kernel vs plain {measure} "
                        f"{rec[measure]} > {KERNEL_TOL}")
                if not rec.get("library_" + measure, 0.0) <= KERNEL_TOL:
                    raise AssertionError(
                        f"brick_interp {inputs} {dtype}: F.grid_sample "
                        "yardstick computes another function")
    return records


def golden(path=GOLDEN):
    """(ray index, golden maps, golden scores) of a JAX golden."""
    import numpy as np
    with np.load(path) as g:
        maps = {key: g[key] for key in ("rgb", "semantics", "instances",
                                        "depth")}
        scores = {key: float(g[key]) for key in ("pq_scene", "pq_masked",
                                                 "sq", "rq")}
        return g["ray_index"], maps, scores


def map_errors(res, path=GOLDEN):
    import numpy as np
    idx, maps, _ = golden(path)
    return {key: float(np.abs(np.concatenate(
        [f[key] for f in res["maps"]])[idx] - want).max())
        for key, want in maps.items()}


def check_pq(runs, label: str, path=GOLDEN):
    gold = golden(path)[2]
    for key in ("pq_scene", "pq_masked"):
        for run in runs:
            if not abs(run[key] - gold[key]) <= PQ_TOL:
                raise AssertionError(f"{label}: {key} {run[key]} vs JAX "
                                     f"golden {gold[key]}: beyond {PQ_TOL}")


def launch_counts():
    from contrastive_lift_tpu_torch.ops import brick_interp as bi
    return {k.__name__: dict(k.dtype_launches) for k in bi.KERNELS}


def phase_main():
    import torch
    from contrastive_lift_tpu_torch.inference.fidelity import (
        R5B_CKPT, R5B_SCENE, e2e_scene, run_dense)
    from contrastive_lift_tpu_torch.ops import brick_interp as bi

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    scene = e2e_scene(*R5B_SCENE)
    bi.reset_launches()
    t0 = time.perf_counter()
    res = run_dense(R5B_CKPT, scene, device="cuda")
    seconds = time.perf_counter() - t0
    launches = launch_counts()
    # a second, warm run: steady-state render time, and the same scores
    warm = run_dense(R5B_CKPT, scene, device="cuda")

    n_rays = sum(len(f.rays) for f in scene.val_frames)
    map_err = map_errors(res)
    emit({"phase": "main", "grid_dim": list(res["grid_dim"]),
          "n_samples": res["n_samples"], "rays": n_rays,
          "launches": launches, "map_max_abs_err": map_err,
          **{k: res[k] for k in ("pq_scene", "pq_masked", "sq", "rq")},
          "golden": golden()[2],
          "render_seconds": res["render_seconds"],
          "cluster_seconds": res["cluster_seconds"],
          "rays_per_second": n_rays / res["render_seconds"],
          "warm_render_seconds": warm["render_seconds"],
          "warm_cluster_seconds": warm["cluster_seconds"],
          "warm_rays_per_second": n_rays / warm["render_seconds"],
          "warm_pq_scene": warm["pq_scene"],
          "warm_pq_masked": warm["pq_masked"],
          "seconds": seconds})
    if launches["sample_density_brick"].get("float32", 0) < 1:
        raise AssertionError("the main path never launched the float32 "
                             "sample_density_brick kernel")
    if res["n_samples"] != 879 or tuple(res["grid_dim"]) != GRID:
        raise AssertionError(f"unexpected r5b shapes {res['grid_dim']} "
                             f"{res['n_samples']}")
    for key, err in map_err.items():
        if not err <= MAP_TOL:
            raise AssertionError(f"{key} map differs from the JAX golden by "
                                 f"{err} > {MAP_TOL}")
    check_pq((res, warm), "main")
    return launches, n_rays / warm["render_seconds"]


def phase_main_bf16_atlas():
    import torch
    from contrastive_lift_tpu_torch.inference.fidelity import (
        R5B_CKPT, R5B_SCENE, e2e_scene, run_dense)
    from contrastive_lift_tpu_torch.ops import brick_interp as bi

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    scene = e2e_scene(*R5B_SCENE)
    bi.reset_launches()
    t0 = time.perf_counter()
    res = run_dense(R5B_CKPT, scene, device="cuda", atlas_dtype="bfloat16")
    seconds = time.perf_counter() - t0
    launches = launch_counts()
    n_rays = sum(len(f.rays) for f in scene.val_frames)
    emit({"phase": "main_bf16_atlas", "launches": launches,
          "map_max_abs_err_vs_fp32_golden": map_errors(res),
          **{k: res[k] for k in ("pq_scene", "pq_masked", "sq", "rq")},
          "golden": golden()[2],
          "render_seconds": res["render_seconds"],
          "cluster_seconds": res["cluster_seconds"],
          "rays_per_second": n_rays / res["render_seconds"],
          "seconds": seconds})
    density = launches["sample_density_brick"]
    if density.get("bfloat16", 0) < 1 or density.get("float32", 0) != 0:
        raise AssertionError(f"the bf16-atlas render launched {density}; "
                             "expected the bfloat16 kernel only")
    check_pq((res,), "main_bf16_atlas")
    return launches


def phase_main_production(dense_warm_rays_per_second: float):
    import numpy as np
    import torch
    from contrastive_lift_tpu_torch.inference.fidelity import (
        BUDGET_FIELDS, R5B_CKPT, R5B_SCENE, e2e_scene, guardrail,
        run_production)
    from contrastive_lift_tpu_torch.ops import brick_interp as bi

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    scene = e2e_scene(*R5B_SCENE)
    bi.reset_launches()
    t0 = time.perf_counter()
    res = run_production(R5B_CKPT, scene, device="cuda")
    seconds = time.perf_counter() - t0
    launches = launch_counts()
    warm = run_production(R5B_CKPT, scene, device="cuda")
    with np.load(PRODUCTION_GOLDEN) as g:
        gold_budgets = {f: g[f"budget_{f}"].item() for f in BUDGET_FIELDS}
        gold_warnings = [str(w) for w in g["warnings"]]
        gold_tails = {k: float(g[k]) for k in ("budget_tail_max",
                                               "head_tail_max")}
    n_rays = sum(len(f.rays) for f in scene.val_frames)
    map_err = map_errors(res, PRODUCTION_GOLDEN)
    budgets = {f: getattr(res["rcfg"], f) for f in BUDGET_FIELDS}
    emit({"phase": "main_production", "rays": n_rays, "launches": launches,
          "budgets": budgets, "golden_budgets": gold_budgets,
          "map_max_abs_err": map_err,
          **{k: res[k] for k in ("pq_scene", "pq_masked", "sq", "rq",
                                 "budget_tail", "head_tail", "warnings")},
          "golden": golden(PRODUCTION_GOLDEN)[2], "golden_tails": gold_tails,
          "golden_warnings": gold_warnings,
          "render_seconds": res["render_seconds"],
          "cluster_seconds": res["cluster_seconds"],
          "rays_per_second": n_rays / res["render_seconds"],
          "warm_render_seconds": warm["render_seconds"],
          "warm_cluster_seconds": warm["cluster_seconds"],
          "warm_rays_per_second": n_rays / warm["render_seconds"],
          "dense_warm_rays_per_second": dense_warm_rays_per_second,
          "warm_pq_scene": warm["pq_scene"],
          "warm_pq_masked": warm["pq_masked"],
          "seconds": seconds})
    if launches["sample_density_brick"].get("float32", 0) < 1:
        raise AssertionError("the production path never launched the "
                             "float32 sample_density_brick kernel")
    for run in (res, warm):
        got = {f: getattr(run["rcfg"], f) for f in BUDGET_FIELDS}
        if got != gold_budgets:
            raise AssertionError(f"calibrated budgets {got} differ from the "
                                 f"JAX golden's {gold_budgets}")
        if ([guardrail(m) for m in run["warnings"]]
                != [guardrail(m) for m in gold_warnings]):
            raise AssertionError(f"guardrail warnings {run['warnings']}; the "
                                 f"JAX golden raised {gold_warnings}")
    for key, err in map_err.items():
        if not err <= BF16_MAP_TOL:
            raise AssertionError(f"production {key} map differs from the JAX "
                                 f"golden by {err} > {BF16_MAP_TOL}")
    check_pq((res, warm), "main_production", PRODUCTION_GOLDEN)
    return launches


def _device_us(event) -> float:
    # renamed from self_cuda_time_total in recent PyTorch releases
    for attr in ("self_device_time_total", "self_cuda_time_total"):
        if hasattr(event, attr):
            return float(getattr(event, attr))
    return 0.0


def _kernel_kind(name: str) -> str:
    low = name.lower()
    if "sample_density_brick" in name or "brick_interp" in name:
        return "density_kernel"
    if "gemm" in low or "cutlass" in low:
        return "matmul"
    if "sort" in low or "topk" in low or "radix" in low:
        return "sort_topk"
    return "other_elementwise"


def profile_render(label: str, render, rays: int, top: int = 12):
    """One warm call of ``render`` under torch.profiler: where the device
    time goes, and the device's idle share."""
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    def run():
        render()
        torch.cuda.synchronize()

    t0 = time.perf_counter()
    run()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t_wall = time.perf_counter()
        run()
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
    emit({"phase": "profile", "path": label, "rays": rays,
          "wall_s": wall, "device_busy_s": busy_s,
          "idle_share": 1.0 - busy_s / wall, "device_ms_by_kind": by_kind,
          "kernel_launches": sum(count for _, _, count in kernels),
          "top": [{"name": kname[:100], "device_ms": us / 1e3, "calls": count}
                  for kname, us, count in kernels[:top]],
          "seconds": time.perf_counter() - t0})
    if busy_s <= 0.0:
        raise AssertionError("the profiler recorded no device time")


def phase_profile():
    """A warm render of the 4 val frames on the dense path and one on the
    production path, each under torch.profiler."""
    import torch
    from contrastive_lift_tpu_torch.inference.fidelity import (
        CHUNK, PRODUCTION_CHUNK, R5B_CKPT, R5B_SCENE, e2e_scene, load_dense,
        load_production)
    from contrastive_lift_tpu_torch.inference.render import render_frames

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    scene = e2e_scene(*R5B_SCENE)
    rays = sum(len(f.rays) for f in scene.val_frames)
    for label, load, chunk in (("dense", load_dense, CHUNK),
                               ("production", load_production,
                                PRODUCTION_CHUNK)):
        _, params, mcfg, rcfg, state_r, _ = load(R5B_CKPT, scene)
        profile_render(label, lambda: render_frames(
            params, mcfg, rcfg, state_r, scene.val_frames, chunk=chunk), rays)


# profiler ranges of the training step (not kernels; their device time
# overlaps the kernels they enclose)
TRAIN_RANGES = ("adam_update",)


def _train_kind(name: str) -> str:
    low = name.lower()
    if "grid_sampler" in low or "bilinear_sampler" in low:
        return "K8_grid_sample"
    if "gemm" in low or "cutlass" in low or "xmma" in low:
        return "head_matmul"
    if "index" in low or "gather" in low or "scatter" in low:
        return "K9_and_other_gather_scatter"
    if "scan" in low or "cumsum" in low or "cumprod" in low:
        return "K10_and_compositing_scans"
    if "sort" in low or "topk" in low or "radix" in low:
        return "sort_topk"
    return "other_elementwise"


def phase_train_r5b(profile: bool):
    """One r5b training step held to the JAX golden, then warm steps."""
    import numpy as np
    import torch
    from contrastive_lift_tpu_torch.config import load_config
    from contrastive_lift_tpu_torch.inference.fidelity import (
        R5B_CKPT, R5B_CONFIG, R5B_SCENE, e2e_scene)
    from contrastive_lift_tpu_torch.train import resume
    from contrastive_lift_tpu_torch.train.step import make_train_step

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    card = card_line()
    scene = e2e_scene(*R5B_SCENE)
    cfg = load_config(R5B_CONFIG)
    with np.load(TRAIN_GOLDEN) as g:
        gold = {k: g[k] for k in g.files}
    t0 = time.perf_counter()
    res = resume.golden_step(R5B_CKPT, cfg, scene, gold, device="cuda")
    bad = resume.check_train_step(res, gold)
    sketch_err = {
        name: max(resume.sketch_error(a, b) for a, b in
                  zip(res[f"sketch_{name}"], gold[f"sketch_{name}"]))
        for name in resume.SKETCHES}
    setup = res["setup"]
    emit({"phase": "train_r5b", "step": 1, "card": card,
          "aux_head_topk": res["aux_head_topk"],
          "golden_aux_head_topk": gold["aux_head_topk"].item(),
          "metrics": {m: res["metrics"][m] for m in resume.TRAIN_METRICS},
          "golden": {m: float(gold[f"metric_{m}"])
                     for m in resume.TRAIN_METRICS},
          "max_sketch_err": sketch_err, "failures": bad,
          "epoch": setup.epoch, "lr_scale": setup.lr_scale,
          "n_samples": setup.rcfg.n_samples,
          "part_seconds": res["seconds"],
          "seconds": time.perf_counter() - t0})
    if bad:
        raise AssertionError(f"train_r5b step 1 differs from the JAX golden: "
                             f"{bad[:10]}")
    cfg = setup.cfg
    step = make_train_step(cfg, setup.mcfg, setup.rcfg, setup.gates,
                           setup.class_weights, setup.state.params,
                           aux_head_topk=res["aux_head_topk"])
    state = res["state"]
    gen = torch.Generator(device="cuda").manual_seed(int(cfg.seed or 0))
    rng = np.random.default_rng(TRAIN_STEP_SEED)
    rays_per_step = (cfg.batch_size
                     + cfg.batch_size_contrastive * cfg.max_rays_instances
                     + cfg.batch_size_segments * cfg.max_rays_segments)

    def one_step(state):
        bm, bi, bs = resume.step_batches(setup, rng)
        state, m = step(state, setup.state_r, bm, bi, bs, gen,
                        setup.lr_scale, setup.lambda_dist_reg)
        return state, {k: float(v) for k, v in m.items()}

    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    times, losses = [], []
    t0 = time.perf_counter()
    for _ in range(TRAIN_STEPS):
        t = time.perf_counter()
        state, m = one_step(state)
        times.append(time.perf_counter() - t)
        losses.append(m)
        if not all(np.isfinite(v) for v in m.values()):
            raise AssertionError(f"train_r5b: a metric is not finite: {m}")
    peak = torch.cuda.max_memory_allocated()
    warm = times[2:]
    steps_per_s = len(warm) / sum(warm)
    emit({"phase": "train_r5b", "steps": TRAIN_STEPS, "card": card,
          "step_seconds": times, "warm_steps_per_second": steps_per_s,
          "rays_per_step": rays_per_step,
          "warm_rays_per_second": steps_per_s * rays_per_step,
          "max_memory_allocated_bytes": peak,
          "loss_main": [m["loss_main"] for m in losses],
          "loss_clustering": [m["loss_clustering"] for m in losses],
          "seconds": time.perf_counter() - t0})
    print(f"train_r5b: {steps_per_s:.3f} warm steps/s, "
          f"{steps_per_s * rays_per_step:.0f} rays/s, peak "
          f"{peak / 2**30:.2f} GiB on {card}", flush=True)
    if profile:
        profile_train(one_step, state, setup, res["aux_head_topk"], card)


def profile_train(one_step, state, setup, k: int, card: str, top: int = 15):
    """One warm step under torch.profiler by training kind, and K8-K10
    alone at the step's shapes (forward and backward) against their
    bounds."""
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    from contrastive_lift_tpu_torch.models import tensorf as tf
    from contrastive_lift_tpu_torch.ops import fused_grid as fg
    from contrastive_lift_tpu_torch.ops.compositing import distortion_loss

    t0 = time.perf_counter()
    state, _ = one_step(state)
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t_wall = time.perf_counter()
        state, _ = one_step(state)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t_wall
    events = prof.key_averages()
    kernels = [(e.key, _device_us(e), e.count) for e in events
               if e.device_type == DeviceType.CUDA and _device_us(e) > 0
               and e.key not in TRAIN_RANGES]
    busy_s = sum(us for _, us, _ in kernels) / 1e6
    by_kind = {}
    for kname, us, _ in kernels:
        kind = _train_kind(kname)
        by_kind[kind] = by_kind.get(kind, 0.0) + us / 1e3
    # the range's own device entry spans its kernels
    adam_ms = sum(_device_us(e) for e in events if e.key == "adam_update"
                  and e.device_type == DeviceType.CUDA) / 1e3
    kernels.sort(key=lambda x: -x[1])

    # K8-K10 alone, forward + backward, at the main phase's shapes
    cfg, rcfg = setup.cfg, setup.rcfg
    params = state.params
    R_main, S = cfg.batch_size, rcfg.n_samples
    gen = torch.Generator(device="cuda").manual_seed(0)
    xyz_h = torch.rand((R_main * k, 3), generator=gen, device="cuda") * 2 - 1
    xyz_d = torch.rand((R_main * S, 3), generator=gen, device="cuda") * 2 - 1
    app = {n: params[n] for n in ("appearance", "appearance_basis")}
    dens = {"density": params["density"]}

    def with_grad(tree):
        return {n: ({kk: tuple(t.detach().requires_grad_() for t in v)
                     for kk, v in b.items()} if "planes" in b
                    else {kk: v.detach().requires_grad_()
                          for kk, v in b.items()})
                for n, b in tree.items()}

    def k8():
        p = with_grad(app)
        tf._branch_feature(p, "appearance", xyz_h).sum().backward()

    def k9():
        p = with_grad(dens)
        fg.sample_density_fused(fg.build_density_only(p), xyz_d,
                                -10.0).sum().backward()

    w = torch.rand((R_main, S), generator=gen, device="cuda") / S
    mids = torch.cumsum(torch.rand((R_main, S), generator=gen,
                                   device="cuda"), 1)
    dists = torch.rand((R_main, S), generator=gen, device="cuda")

    def k10():
        ww = w.detach().requires_grad_()
        distortion_loss(ww, mids, dists).backward()

    planes = params["appearance"]["planes"]
    lines = params["appearance"]["lines"]
    f_bytes = 4 * sum(t.numel() for t in planes + lines)
    comps = sum(t.shape[0] for t in planes)
    P = R_main * k
    # plane 0 is [C, gy, gx], line 0 is [C, gz]
    _, gy, gx = params["density"]["planes"][0].shape
    gz = params["density"]["lines"][0].shape[1]
    cells = (gx - 1) * (gy - 1) * (gz - 1)
    dcomp = sum(t.shape[0] for t in params["density"]["planes"])
    d_bytes = 4 * sum(t.numel() for t in params["density"]["planes"]
                      + params["density"]["lines"])
    PD = R_main * S
    alone = {
        # positions in, features out; backward: feature grads in, factor
        # grads out. 4 plane + 2 line taps, a product and the basis matmul
        "K8_vm_feature_appearance": (
            k8, f"{P} samples x {comps} components",
            2 * (P * 12 + P * comps * 4) + 2 * f_bytes + P * 27 * 4 * 2,
            P * comps * (2 * 14 + 2 * 27)),
        # the densify einsums (g^3 x 3 x C multiply-adds, forward and
        # backward), the cell rows written and read back, one row and the
        # position per sample, the value out; backward the same in reverse
        "K9_density_cells": (
            k9, f"{PD} samples, grid {gx}x{gy}x{gz}",
            2 * (d_bytes + gx * gy * gz * 4 + cells * 32 + PD * (12 + 32 + 4)),
            2 * (2 * 3 * dcomp * gx * gy * gz) + PD * 2 * 40),
        # weights, midpoints and intervals in, the weights' gradient out
        "K10_distortion": (
            k10, f"{R_main} rays x {S} samples",
            R_main * S * 4 * 4, R_main * S * 20),
    }
    # the whole step's share of each: K8 and K10 run only in the main phase;
    # K9 adds two stop-gradient builds (the segment and instance passes,
    # each with its coarse occupancy) and their forward samples, the
    # segment chunks' twice (the checkpointed backward recomputes them)
    aux_samples = (2 * cfg.batch_size_segments * cfg.max_rays_segments
                   + cfg.batch_size_contrastive * cfg.max_rays_instances) * (
        cfg.ess_train_segments * cfg.ess_train_stride)
    k9_build_bytes = d_bytes + gx * gy * gz * 4 + cells * 32
    step_extra = {
        "K8_vm_feature_appearance": (0, 0),
        "K9_density_cells": (
            2 * (k9_build_bytes + gx * gy * gz * 4) + aux_samples * 48,
            2 * (2 * 3 * dcomp * gx * gy * gz) + aux_samples * 40),
        "K10_distortion": (0, 0)}
    isolated = {}
    for name, (fn, shape, n_bytes, n_flops) in alone.items():
        ms, spread = timed(fn, flush=True)
        b_ms, b_by = bound(n_bytes, n_flops)
        extra_bytes, extra_flops = step_extra[name]
        s_ms, s_by = bound(n_bytes + extra_bytes, n_flops + extra_flops)
        isolated[name] = {"shape": shape, "ms": ms, "spread_ms": spread,
                          "bound_ms": b_ms, "bound_by": b_by,
                          "bytes": n_bytes, "flops": n_flops,
                          "step_bound_ms": s_ms, "step_bound_by": s_by,
                          "step_bytes": n_bytes + extra_bytes,
                          "step_flops": n_flops + extra_flops}
    emit({"phase": "profile", "path": "train_step", "card": card,
          "wall_s": wall, "device_busy_s": busy_s,
          "idle_share": 1.0 - busy_s / wall, "device_ms_by_kind": by_kind,
          "adam_update_device_ms": adam_ms,
          "kernel_launches": sum(count for _, _, count in kernels),
          "top": [{"name": kname[:100], "device_ms": us / 1e3, "calls": count}
                  for kname, us, count in kernels[:top]],
          "alone": isolated, "seconds": time.perf_counter() - t0})
    if busy_s <= 0.0:
        raise AssertionError("the profiler recorded no device time")


def kernel_line(records, launches):
    """The ``kernels`` line: each entry point and row type, with its numbers
    on the render-chunk inputs (the dense main path's own) and its launches
    in the dense render of that row type; the fused form also with its time
    on the production chunk and its launches in ``main_production``."""
    entries = []
    for kname in ("brick_interp", "sample_density_brick"):
        for dtype in DTYPES:
            rec = records[(kname, "render_chunk", dtype)]
            entry = {
                "name": f"{kname}_{'f32' if dtype == 'float32' else 'bf16'}",
                "dtype": dtype, "route": "cuda", "source": KERNEL_SOURCE,
                "replaces": TPU_KERNEL,
                "launches": launches[dtype][kname].get(dtype, 0),
                "max_abs_err": max(rec_["max_abs_err"] for (k, _, d), rec_
                                   in records.items()
                                   if k == kname and d == dtype),
                **{k: rec[k] for k in ("ms", "plain_ms", "bound_ms",
                                       "bound_by", "library_ms")},
                "random_ms": records[(kname, "random", dtype)]["ms"]}
            prod = records.get((kname, "production_chunk", dtype))
            if prod is not None:
                entry.update(
                    production_chunk_ms=prod["ms"],
                    production_chunk_bound_ms=prod["bound_ms"],
                    production_chunk_library_ms=prod["library_ms"],
                    main_production_launches=launches["production"][kname]
                    .get(dtype, 0))
            entries.append(entry)
    return {"kernels": entries}


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--profile", action="store_true",
                    help="also profile one warm render of the dense and of "
                         "the production path, and one warm training step")
    ap.add_argument("--against", type=Path, nargs="*", default=[],
                    metavar="SOURCE",
                    help="other sources of csrc/brick_interp.cu (an earlier "
                         "commit's) to time beside this one in the kernels "
                         "phase")
    args = ap.parse_args()
    OTHER_SOURCES.extend(args.against)
    import torch
    if not torch.cuda.is_available():
        print("chip_smoke: torch.cuda.is_available() is False; this script "
              "needs a CUDA card", file=sys.stderr)
        return 2
    for needed in (GOLDEN, PRODUCTION_GOLDEN, TRAIN_GOLDEN,
                   ROOT / KERNEL_SOURCE):
        if not needed.exists():
            print(f"chip_smoke: {needed} is missing; run from a checkout of "
                  "the repository", file=sys.stderr)
            return 2
    sys.path.insert(0, str(ROOT))
    name = phase_device()
    phase_build()
    records = phase_kernels()
    dense_launches, dense_warm_rays_per_second = phase_main()
    launches = {"float32": dense_launches,
                "bfloat16": phase_main_bf16_atlas(),
                "production": phase_main_production(
                    dense_warm_rays_per_second)}
    phase_train_r5b(args.profile)
    if args.profile:
        phase_profile()
    emit(kernel_line(records, launches))
    emit({"ok": True, "device": {"platform": "gpu", "kind": name,
                                 "count": torch.cuda.device_count()}})
    return 0


if __name__ == "__main__":
    sys.exit(main())
