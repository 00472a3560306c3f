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
             inputs in the same process; then the span form
             (``sample_density_brick_span``, 4 atlas rows a span) in float32
             and bfloat16 against its plain version on ``random`` spans
             (4,096 x 12 spans of 8 samples a quarter voxel apart on random
             lines through the N(0,1) grid) and on ``span_chunk`` (the
             pass-A samples of the first 4,096-ray chunk of r5b's render
             with span gathers, ``fidelity.production_chunk(option="span")``),
             and bit for bit against the fused form on every span whose
             runs fit its rows, timed as above with the fused form's time on
             the same samples beside it;
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
7. options_r5b - each render option of ``inference/fidelity.py::OPTIONS``
             (the production point with the L1 cascade, with termination
             off so that the calibration picks heavy/light bucketing, with
             iter and with rank head selection, with 6-cell head dedup, with
             span gathers of 4 rows, with baked heads) through
             ``run_production(option=)``, cold and warm, each with the launch
             counts zeroed just before and read just after, held to the
             eager JAX golden ``contrastive_lift_tpu_torch/testdata/
             r5b_options_golden.npz`` at main_production's bars (budgets
             equal, maps within 3e-2, PQ^scene and masked PQ within 0.5 pt,
             the same guardrail warnings), a float32 launch of the density
             kernel in every option (the fused form, or under span gathers
             the span form, which the span render must launch); each
             option's warm rays/s is printed beside the production render's
             with the card's name and power limit;
8. train_r5b - one training step of r5b (``train/resume.py``): resumed
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
9. stage_r5b - the stage changes of the JAX ``Trainer`` on ``final.npz``
             with r5b's config (``train/stages.py``): the AABB shrink and the
             upsamples to each count of r5b's voxel schedule, held against
             the JAX golden ``contrastive_lift_tpu_torch/testdata/
             r5b_stage_golden.npz``: grid_dim, t_l, b_r, the schedule and
             the target resolutions equal, the AABB equal (one float32 step
             is reported, more fails), the occupied count within 0.01%,
             every upsampled plane and line's sketch within 1e-5 of its norm;
10. train_loop_r5b - ``Trainer.fit`` from scratch on ``cuda`` with r5b's
             configuration and widths, cut to 8 train frames of r5b's scene,
             4 epochs (instance phase from 2, segment phase from 3), one
             sanity frame and half the val frames: the shrinks at epochs 1
             and 2 and the upscales to 741,455 and 2,097,152 voxels. Per
             epoch: grid, AABB, head budget, the seconds of each stage
             change, of the steps, validation, visualisation and the
             checkpoint, warm steps/s and peak memory, beside the card's
             name and power limit. Gates: every logged metric finite, each
             upscale's voxel count at most its target and within 4% of it,
             the last validation's psnr above the sanity one, ``last.npz``
             read back with epoch 4 and the trainer's step and grid; a fresh
             ``Trainer`` restores it bitwise (parameters and both Adam
             chains) and one more step on fixed batches and draws from both
             agrees within rtol 1e-5; then the fused form, in float32 and
             bfloat16, against its plain version on ``loop_chunk``: the
             first pass-A chunk of the production render of ``last.npz``
             (its own grid and calibrated budgets,
             ``inference/fidelity.py::production_chunk``), timed and bounded
             as in the kernels phase; then ``run_production`` renders
             ``last.npz`` (launch counts zeroed just before): the float32
             density kernel must have run, its first chunk must be
             ``loop_chunk``'s shape and every map be finite;
11. cli_r5b - the render and evaluate CLIs as a user runs them
             (``inference/fidelity.py::run_cli``): r5b's synthetic scene
             written in the MOS layout (``write_mos_scene``: PNG colour, npy
             labels, metadata.json cameras; the reader renormalises the
             poses, so these views are not the PQ gate's) and a run
             directory with r5b's config naming it and a link to
             ``final.npz`` (``cli_run_dir``); ``cli.render.main`` at 64x96,
             4,096-ray chunks, every 4th of the 14 test frames (4 frames,
             24,576 rays), once with mean-shift and once with
             ``--use_dbscan``, each followed by ``cli.evaluate.main``;
             launch counts zeroed just before and read just after. Held to
             the eager JAX golden ``contrastive_lift_tpu_torch/testdata/
             r5b_cli_golden.npz`` (``fidelity.check_cli``): calibrated
             budgets equal, pred_semantics equal on at least 99.9% of the
             pixels, instance_features.npy within 3e-2 (bf16 heads),
             pred_surrogateid 16-bit, iou/pq/sq/rq within 0.005 for both
             clusterings; the port's HDBSCAN on the card gives the golden's
             scikit-learn labels on its sample up to a permutation; the
             float32 density kernel launched; then the fused form in
             float32 and bfloat16 against its plain version on
             ``cli_chunk``, the first pass-A chunk of the CLI's render
             (``fidelity.cli_chunk``), timed and bounded as in the kernels
             phase. Prints render and cluster seconds and rays/s of each
             clustering beside the card's name and power limit;
12. tools_r5b - the tools of slice 3a as a user runs them, on the same
             scene with a run directory rendering every 4th test frame
             (``inference/fidelity.py::tools_run_dir``, ``run_tools``):
             ``cli.find_bandwidth`` on every 18th train frame (3 frames,
             the reference's 50-value MOS grid), ``cli.extract_centroids``
             at its best bandwidth, ``cli.render --cached_centroids_path``
             then ``cli.evaluate``, ``cli.visualize_bboxes`` with the mbr and
             the aabb method, ``cli.render_legacy`` on the test frames and
             on a 4-pose orbit; ``renderer/editing.py::render_edited`` with
             each edit on the golden's 512 rays and box, float32 heads, TF32
             off (``run_edits``); and a reference-layout Lightning
             checkpoint at r5b's widths from a seeded generator, saved with
             ``torch.save``, converted by ``io/torch_import.py`` and its
             first val frame rendered on the production path
             (``run_import``). Held to the eager JAX golden
             ``contrastive_lift_tpu_torch/testdata/r5b_tools_golden.npz``
             (``fidelity.check_tools``, ``check_edits``): the curve as long
             and each PQ within 0.005, the best bandwidth equal; per class
             as many centroids, each within 3e-2 of the golden's nearest;
             the cached-centroid render's budgets equal, pred_semantics
             99.9%, iou/pq/sq/rq within 0.005; as many boxes, matched up
             to a permutation of the ids, position and extent within 1e-2 of
             the AABB's extent; the legacy semantics on 99.9% and surrogate
             ids on 99% of the pixels; the edits' maps within 1e-4, delete
             lowering and extract zeroing the opacity; the imported render's
             maps finite with a float32 density-kernel launch; the float32
             density kernel launched in the phase. Prints each tool's host
             seconds and rays/s and the phase's kernel launches by row type
             beside the card's name and power limit;
13. ddp_r5b - data parallel (``parallel/mesh.py``) on the one card:
             (a) the r5b golden step (``train/resume.py::golden_step``)
             through the sharded step code on an explicit 1-rank NCCL group,
             held to ``r5b_train_step_golden.npz`` at train_r5b's bars; (b)
             r5b resumed with r5b's widths and batch sizes but 2 instance
             images (r5b's 1 does not split over 2 ranks;
             ``inference/fidelity.py::DDP_OVERRIDES``): 3 steps and the
             production render of the 4 val frames, unsharded in this
             process (twice: the card's own spread is printed), then on 2
             gloo ranks spawned on the same card (``fidelity.ddp_r5b``),
             held to the unsharded run (``fidelity.check_ddp``: budget,
             losses rtol 4e-4, leaf sketches after the steps 5e-5 and of
             their change 3.5e-2, replicas bitwise equal, render budgets
             equal and maps within 1e-6, a float32 density-kernel launch on
             every rank, the same PQ) and the sharded render to
             ``r5b_production_golden.npz`` at main_production's bars. Prints
             the seconds of a sharded step beside an unsharded one (two
             ranks share one card: not a scaling number), the all-reduce
             bytes a step and the milliseconds of one all-reduce of that
             size, and each rank's kernel launches;
14. distilled_r5b - r5b with distilled-feature heads grafted on
             (``inference/fidelity.py::write_distilled_checkpoint``: a
             seeded 96-d ``feature`` VM branch at r5b's grid, its basis, the
             96-256-256-64 ``feature_mlp`` and 64 input rows on each head's
             first layer, r5b's optimizer state carried over) and unit-norm
             64-d targets on its scene (``distilled_targets``): (a) the
             golden step (``train/resume.py::golden_step``) with
             ``distilled_config`` (both distilled inputs, the feature gate
             open) held to the eager JAX golden ``contrastive_lift_tpu_torch/
             testdata/r5b_distilled_golden.npz`` at train_r5b's bars with
             ``loss_feat`` among the losses and non-zero; (b) the production
             render of the 4 val frames from the grafted checkpoint (launch
             counts zeroed just before and read just after), cold and warm,
             held to the golden at main_production's bars (budgets equal,
             maps within 3e-2, PQ^scene and masked PQ within 0.5 pt, the
             same warnings) with a float32 launch of the fused density
             kernel; (c) the ``distilled`` map of the render's first chunk
             (``fidelity.distilled_chunk``) within 3e-2 of the golden's, its
             rows of unit norm where a ray hits; then 3 warm steps. Prints
             the warm steps/s and peak memory beside train_r5b's, the warm
             render rays/s beside main_production's and the phase's kernel
             launches, with the card's name and power limit;
15. preprocess_scannet - the paper's pipeline from raw data on: (a) a raw
             ScanNet capture at ScanNet's own sizes
             (``inference/fidelity.py::write_raw_scannet``: a version-4
             ``.sens`` of 12 frames of 968x1296 colour, JPEG at quality 90
             through the port's encoder, 480x640 zlib depth; uint16 labels
             with raw ids past 255; Mask2Former dumps) under the gitignored
             ``runs/``, the ``.sens`` sha256 equal to the golden's (PIL
             encoded the golden's, so the encoder is checked byte for byte);
             (b) ``data/preprocessing/scannet.py::preprocess_scannet`` (every
             frame streamed and decoded, keyframe window 2: 6 frames, split
             4 / 2, 480x640, the dumps converted) with every file of the
             tree at its digest in ``contrastive_lift_tpu_torch/testdata/
             scannet_preprocess_golden.npz`` (written by the JAX package with
             PIL: JPEG, txt and json bytes, PNG headers and pixels, npz
             arrays, pickled objects); (c) the port's PanopLi reader on the
             tree at 480x640, its arrays equal and its rays within 1e-6 of
             the golden's record of the JAX reader; (d) ``Trainer.fit`` at
             r5b's widths on the scene read at 60x80, 2 epochs (the cuts in
             ``fidelity.PREPROCESS_OVERRIDES``), then ``render_frames`` of
             the 2 test frames at 480x640 (614,400 rays, launch counts zeroed
             just before and read just after): finite losses and maps and a
             float32 launch of the fused density kernel. Prints the encode
             and decode seconds of one 968x1296 frame, the preprocessing,
             reader and fit seconds, the warm steps/s, the render rays/s and
             the launches, with the card's name and power limit;
16. profile - only with ``--profile``: one more warm render of the 4 val
             frames on the dense path and one on the production path under
             ``torch.profiler``, each with its wall and device seconds, the
             idle share, device time by kernel kind (matmul, density kernel,
             sort/top-k, other elementwise) and the top kernels; and one warm
             training step the same way, by training kind (K8 grid sampling,
             K9 and other gathers and scatters, K10 and compositing scans,
             head matmuls, the Adam updates), with K8-K10 also timed alone
             at the step's shapes against their bounds.

Then one line ``{"kernels": [...]}`` (each entry point and row type, timed
on the render-chunk inputs, the fused form also on the production chunk,
the loop chunk and the CLI chunk, with its launches in main_production, in
each option of options_r5b, in train_loop_r5b's render, in cli_r5b, in
tools_r5b, summed over the ranks in ddp_r5b, in distilled_r5b's render
and in preprocess_scannet's render; the span form timed on
the span chunk with its launches in the span render) and, last, ``{"ok": true, "device": {...}}``.
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
STAGE_GOLDEN = GOLDEN.with_name("r5b_stage_golden.npz")
CLI_GOLDEN = GOLDEN.with_name("r5b_cli_golden.npz")
TOOLS_GOLDEN = GOLDEN.with_name("r5b_tools_golden.npz")
OPTIONS_GOLDEN = GOLDEN.with_name("r5b_options_golden.npz")
DISTILLED_GOLDEN = GOLDEN.with_name("r5b_distilled_golden.npz")
PREPROCESS_GOLDEN = GOLDEN.with_name("scannet_preprocess_golden.npz")
# warm steps of train_r5b after step 1, and the sampler seed of those
TRAIN_STEPS = 10
DISTILLED_STEPS = 3
TRAIN_STEP_SEED = 1
# train_loop_r5b: r5b's configuration and widths, cut to 8 train frames
# (24 steps an epoch) and 4 epochs, with every phase open by the last
LOOP_TRAIN_FRAMES = 8
LOOP_OVERRIDES = {"max_epoch": 4, "instance_optimization_epoch": 2,
                  "segment_optimization_epoch": 3, "sanity_steps": 1,
                  "val_check_percent": 0.5}
# the resumed step against the step before the save: cuDNN's grid_sample
# backward adds with atomics, so the two need not be bitwise equal
RESUME_RTOL = 1e-5
TPU_KERNEL = "contrastive_lift_tpu/ops/pallas_interp.py:64"
KERNEL_SOURCE = "contrastive_lift_tpu_torch/csrc/brick_interp.cu"
# the span form ports the JAX package's opt-in span gathers, an XLA twin of
# the TPU kernel for spans
SPAN_REPLACES = "contrastive_lift_tpu/ops/fused_grid.py:572"

# r5b: grid 131x131x121, 879 samples per ray at step_ratio 0.25, chunks of
# 1,024 rays (its scene and checkpoint are in inference/fidelity.py)
GRID = (131, 131, 121)
SAMPLES_PER_CHUNK = 1024 * 879
DTYPES = ("float32", "bfloat16")
# random spans for the span form: 4,096 rays x 12 spans x 8 samples a
# quarter voxel apart (the production chunk's pass-A shape and r5b's step)
SPAN_SHAPE = (4096, 12, 8)
SPAN_STEP_VOXELS = 0.25
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
    grid = tuple(dense.shape)
    atlas = build_brick_atlas(dense, getattr(torch, dtype))
    got = bi.sample_density_brick(atlas, xyz, grid, shift)
    ref = bi.sample_density_brick_reference(atlas, xyz, grid, shift)
    magnitude = bi.sample_density_brick_reference(atlas.abs(), xyz, grid, 0.0)
    # the library reads the atlas's values, upcast outside the timed call
    library = dense_yardstick(dense.to(atlas.dtype).float(), xyz, shift)
    in_box = (xyz.abs() <= 1.0).all(dim=1)
    row, frac = bi.brick_coords(grid, xyz)
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
           **time_case(lambda: bi.sample_density_brick(atlas, xyz, grid, shift),
                       lambda: bi.sample_density_brick_reference(
                           atlas, xyz, grid, shift), library, xyz),
           "bound_ms": b_ms, "bound_by": b_by, "sector_floor_ms": floor_ms,
           "against": [time_other(src, "sample_density_brick", ref,
                                  magnitude, atlas, xyz, grid, shift)
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


def span_inputs():
    """name -> (dense float32 grid, xyz [R,K,T,3] spans, splus shift, atlas
    rows a span) for the span form: ``random``, spans of 8 samples a quarter
    voxel apart on random lines through a 131x131x121 N(0,1) grid (out-of-box
    samples included), and ``span_chunk``, the pass-A samples of the first
    4,096-ray chunk of r5b's render with span gathers
    (``inference/fidelity.py::production_chunk(option="span")``)."""
    import numpy as np
    import torch
    from contrastive_lift_tpu_torch.inference.fidelity import (
        OPTIONS, PRODUCTION_CHUNK, R5B_CKPT, R5B_SCENE, e2e_scene,
        production_chunk)
    rows = OPTIONS["span"][0]["fine_span_rows"]
    gen = torch.Generator(device="cuda").manual_seed(1)
    dense = torch.randn(GRID, generator=gen, device="cuda")
    g = torch.tensor(GRID, dtype=torch.float32, device="cuda")
    R, K, T = SPAN_SHAPE
    o = torch.rand((R, K, 1, 3), generator=gen, device="cuda") * (g + 1) - 1
    d = torch.randn((R, K, 1, 3), generator=gen, device="cuda")
    d = d / d.norm(dim=-1, keepdim=True)
    t = torch.arange(T, device="cuda", dtype=torch.float32)[:, None]
    xyz = ((o + d * t * SPAN_STEP_VOXELS) / (g - 1) * 2 - 1).contiguous()
    chunk = production_chunk(R5B_CKPT, e2e_scene(*R5B_SCENE), device="cuda",
                             option="span")
    with np.load(OPTIONS_GOLDEN) as gold:
        k_a = int(gold["span_budget_term_first"])
    if chunk[2].shape != (PRODUCTION_CHUNK * k_a * T, 3):
        raise AssertionError(f"unexpected span chunk shape "
                             f"{tuple(chunk[2].shape)}")
    return {"random": (dense, xyz, -10.0, rows),
            "span_chunk": (chunk[0], chunk[2].reshape(PRODUCTION_CHUNK, k_a,
                                                      T, 3).contiguous(),
                           chunk[1], rows)}


def span_rows_used(grid, xyz, rows: int):
    """([P] the atlas row each sample of [R,K,T,3] spans reads in the span
    form: its run's, clamped as the JAX function clamps; [P,3] its in-brick
    position; [R,K] whether the span's runs fit in ``rows``)."""
    import torch
    from contrastive_lift_tpu_torch.ops import brick_interp as bi
    moves, run_row, frac = bi.span_runs(grid, xyz, rows)
    used = torch.gather(run_row, 2, torch.clamp(moves, max=rows - 1))
    return used.reshape(-1), frac, moves[..., -1] < rows


def span_case(dense, xyz, shift, dtype, rows):
    """The span form against its plain version and, on the spans whose runs
    fit, bit for bit against the fused form's kernel; timed as every case,
    with the fused form's time on the same samples beside it."""
    import torch
    from contrastive_lift_tpu_torch.ops import brick_interp as bi
    from contrastive_lift_tpu_torch.ops.fused_grid import build_brick_atlas

    grid = tuple(dense.shape)
    flat = xyz.view(-1, 3)
    n = flat.shape[0]
    atlas = build_brick_atlas(dense, getattr(torch, dtype))
    got = bi.sample_density_brick_span(atlas, xyz, grid, shift, rows)
    ref = bi.sample_density_brick_span_reference(atlas, xyz, grid, shift, rows)
    magnitude = bi.sample_density_brick_span_reference(atlas.abs(), xyz, grid,
                                                       0.0, rows)
    fused = bi.sample_density_brick(atlas, flat, grid, shift).view(got.shape)
    row, frac, fits = span_rows_used(grid, xyz, rows)
    library = dense_yardstick(dense.to(atlas.dtype).float(), flat, shift)
    in_box = ((flat.abs() <= 1.0).all(dim=1).view(got.shape)
              & fits[..., None]).reshape(-1)
    elems, sectors = atlas_needs(row, frac, atlas.element_size())
    torch.cuda.synchronize()
    if not torch.equal(got[fits], fused[fits]):
        raise AssertionError(f"span form {dtype}: differs from the fused "
                             "form on spans whose runs fit")
    b_ms, b_by = bound(elems * atlas.element_size() + 16 * n,
                       FLOPS_PER_SAMPLE * n)
    floor_ms, _ = bound(SECTOR_BYTES * sectors + 16 * n, 0)
    return {"max_abs_err": float((got - ref).abs().max()),
            "max_scaled_err": scaled_err(got.view(-1), ref.view(-1),
                                         magnitude.view(-1)),
            "library_in_box_max_abs_err": float(
                (library() - got.view(-1))[in_box].abs().max()),
            "rows_per_span": rows, "spans": int(fits.numel()),
            "spans_clamped": int((~fits).sum()),
            "rows_touched": int(torch.unique(row).numel()),
            "elements_touched": elems, "sectors_touched": sectors,
            **time_case(lambda: bi.sample_density_brick_span(
                atlas, xyz, grid, shift, rows),
                lambda: bi.sample_density_brick_span_reference(
                    atlas, xyz, grid, shift, rows), library, flat),
            "fused_ms": timed(lambda: bi.sample_density_brick(
                atlas, flat, grid, shift))[0],
            "bound_ms": b_ms, "bound_by": b_by, "sector_floor_ms": floor_ms}


def run_case(phase, kname, inputs, dtype, case, samples, empty_kernel_ms):
    """Run one case, print it and return its record; raises on a kernel
    that disagrees with its plain version or a yardstick that computes
    another function."""
    import torch
    t0 = time.perf_counter()
    rec = case()
    rec["bound_share"] = rec["bound_ms"] / rec["ms"]
    rec["empty_kernel_ms"] = empty_kernel_ms
    emit({"phase": phase, "kernel": kname, "inputs": inputs, "dtype": dtype,
          "samples": samples, "tolerance": KERNEL_TOL, **rec,
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
    return rec


def empty_kernel():
    """What the timing loop gives an empty kernel."""
    import torch
    return timed(lambda: torch.cuda._sleep(0))[0]


def phase_kernels():
    """records[(kernel, inputs, dtype)] for every case (``run_case``)."""
    records = {}
    empty_kernel_ms = empty_kernel()
    for inputs, (dense, xyz, shift) in kernel_inputs().items():
        for dtype in DTYPES:
            cases = [("sample_density_brick",
                      lambda: fused_case(dense, xyz, shift, dtype))]
            # the production path reads the atlas through the fused form only
            if inputs != "production_chunk":
                cases.append(("brick_interp",
                              lambda: literal_case(dense, xyz, dtype)))
            for kname, case in cases:
                records[(kname, inputs, dtype)] = run_case(
                    "kernels", kname, inputs, dtype, case, xyz.shape[0],
                    empty_kernel_ms)
    kname = "sample_density_brick_span"
    for inputs, (dense, xyz, shift, rows) in span_inputs().items():
        for dtype in DTYPES:
            records[(kname, inputs, dtype)] = run_case(
                "kernels", kname, inputs, dtype,
                lambda: span_case(dense, xyz, shift, dtype, rows),
                xyz.numel() // 3, empty_kernel_ms)
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
    return launches, n_rays / warm["render_seconds"]


def phase_options_r5b(production_warm_rays_per_second: float):
    """Each render option of ``inference/fidelity.py::OPTIONS`` through
    ``run_production(option=)`` (launch counts zeroed just before, read just
    after), cold and warm, held to ``r5b_options_golden.npz``. Returns the
    launch counts of each option's cold render."""
    import numpy as np
    import torch
    from contrastive_lift_tpu_torch.inference.fidelity import (
        BUDGET_FIELDS, OPTIONS, R5B_CKPT, R5B_SCENE, e2e_scene, guardrail,
        run_production)
    from contrastive_lift_tpu_torch.ops import brick_interp as bi

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    card = card_line()
    scene = e2e_scene(*R5B_SCENE)
    n_rays = sum(len(f.rays) for f in scene.val_frames)
    with np.load(OPTIONS_GOLDEN) as g:
        gold = {k: g[k] for k in g.files}
    idx = gold["ray_index"]
    t_phase = time.perf_counter()
    launches, rates, bad = {}, {}, []
    for name in OPTIONS:
        bi.reset_launches()
        t0 = time.perf_counter()
        res = run_production(R5B_CKPT, scene, device="cuda", option=name)
        seconds = time.perf_counter() - t0
        launches[name] = launch_counts()
        warm = run_production(R5B_CKPT, scene, device="cuda", option=name)
        rates[name] = n_rays / warm["render_seconds"]
        gold_budgets = {f: gold[f"{name}_budget_{f}"].item()
                        for f in BUDGET_FIELDS}
        gold_warnings = [str(w) for w in gold[f"{name}_warnings"]]
        map_err = {key: float(np.abs(np.concatenate(
            [f[key] for f in res["maps"]])[idx] - gold[f"{name}_{key}"]).max())
            for key in ("rgb", "semantics", "instances", "depth")}
        emit({"phase": "options_r5b", "option": name, "card": card,
              "launches": launches[name],
              "budgets": {f: getattr(res["rcfg"], f) for f in BUDGET_FIELDS},
              "golden_budgets": gold_budgets, "map_max_abs_err": map_err,
              **{k: res[k] for k in ("pq_scene", "pq_masked", "sq", "rq",
                                     "budget_tail", "head_tail", "warnings")},
              "golden": {k: float(gold[f"{name}_{k}"]) for k in (
                  "pq_scene", "pq_masked", "sq", "rq")},
              "golden_warnings": gold_warnings,
              "render_seconds": res["render_seconds"],
              "warm_render_seconds": warm["render_seconds"],
              "warm_rays_per_second": rates[name],
              "production_warm_rays_per_second":
                  production_warm_rays_per_second,
              "seconds": seconds})
        for run in (res, warm):
            got = {f: getattr(run["rcfg"], f) for f in BUDGET_FIELDS}
            if got != gold_budgets:
                bad.append(f"{name}: budgets {got}, golden {gold_budgets}")
            if ([guardrail(m) for m in run["warnings"]]
                    != [guardrail(m) for m in gold_warnings]):
                bad.append(f"{name}: warnings {run['warnings']}, golden "
                           f"{gold_warnings}")
            for key in ("pq_scene", "pq_masked"):
                if not abs(run[key] - float(gold[f"{name}_{key}"])) <= PQ_TOL:
                    bad.append(f"{name}: {key} {run[key]}, golden "
                               f"{float(gold[f'{name}_{key}'])}")
        bad += [f"{name}: {key} map differs by {err}"
                for key, err in map_err.items() if not err <= BF16_MAP_TOL]
        k1 = (launches[name]["sample_density_brick"].get("float32", 0)
              + launches[name]["sample_density_brick_span"].get("float32", 0))
        if k1 < 1:
            bad.append(f"{name}: no float32 launch of the density kernel")
        if (name == "span" and launches[name]["sample_density_brick_span"]
                .get("float32", 0) < 1):
            bad.append("span: no float32 launch of the span form")
    emit({"phase": "options_r5b", "card": card, "failures": bad,
          "seconds": time.perf_counter() - t_phase})
    print("options_r5b warm rays/s: " + ", ".join(
        f"{k} {v:.0f}" for k, v in rates.items())
        + f" (production {production_warm_rays_per_second:.0f}) on {card}",
        flush=True)
    if bad:
        raise AssertionError(f"options_r5b differs from the JAX golden: {bad}")
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
    return steps_per_s, peak


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


def phase_stage_r5b():
    """The shrink and the upscales of r5b's schedule on its checkpoint,
    held to the JAX golden (``train/stages.py``)."""
    import numpy as np
    import torch
    from contrastive_lift_tpu_torch.config import load_config
    from contrastive_lift_tpu_torch.inference.fidelity import (R5B_CKPT,
                                                               R5B_CONFIG)
    from contrastive_lift_tpu_torch.train.stages import (INDEX_KEYS,
                                                         check_stages,
                                                         stage_changes)

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    t0 = time.perf_counter()
    res = stage_changes(R5B_CKPT, load_config(R5B_CONFIG), device="cuda")
    with np.load(STAGE_GOLDEN) as g:
        bad, notes = check_stages(res, g)
        gold = {k: np.asarray(g[k]).tolist() for k in
                INDEX_KEYS + ("bbox_aabb", "occupied", "face_alphas")}
        sketch_err = float(np.max(np.abs(res["sketches"] - g["sketches"])
                                  / g["sketches"][..., :1]))
    emit({"phase": "stage_r5b", "card": card_line(),
          **{k: np.asarray(res[k]).tolist() for k in
             INDEX_KEYS + ("bbox_aabb", "occupied", "face_alphas")},
          "golden": gold, "max_sketch_err": sketch_err, "notes": notes,
          "failures": bad, "part_seconds": res["seconds"],
          "seconds": time.perf_counter() - t0})
    for note in notes:
        print(f"stage_r5b: {note}", flush=True)
    if bad:
        raise AssertionError(f"stage_r5b differs from the JAX golden: {bad}")


def phase_train_loop_r5b():
    """``Trainer.fit`` at r5b's widths from scratch through both stage
    changes, then a resume and a production render of its checkpoint, with
    the fused kernel held to its plain version on that render's first
    pass-A chunk (``loop_chunk``). Returns (the density-kernel launches of
    that render, records[(kernel, "loop_chunk", dtype)])."""
    import tempfile

    import numpy as np
    import torch
    from contrastive_lift_tpu_torch.config import load_config
    from contrastive_lift_tpu_torch.inference.fidelity import (
        BUDGET_FIELDS, PRODUCTION_CHUNK, R5B_CONFIG, R5B_SCENE, e2e_scene,
        production_chunk, run_production)
    from contrastive_lift_tpu_torch.io.checkpoint import load_checkpoint
    from contrastive_lift_tpu_torch.ops import brick_interp as bi
    from contrastive_lift_tpu_torch.train import resume
    from contrastive_lift_tpu_torch.train.loop import Trainer
    from contrastive_lift_tpu_torch.train.schedule import lr_scale_for_epoch
    from contrastive_lift_tpu_torch.train.step import (draw_step,
                                                       gates_for_epoch,
                                                       make_train_step)
    from contrastive_lift_tpu_torch.utils.tree import tree_leaves_with_path

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    card = card_line()
    image_dim, _, checker_freq = R5B_SCENE
    scene = e2e_scene(image_dim, LOOP_TRAIN_FRAMES, checker_freq)
    cfg = load_config(R5B_CONFIG, LOOP_OVERRIDES).resolve_epochs()
    emit({"phase": "train_loop_r5b", "card": card,
          "cuts": {"train_frames": LOOP_TRAIN_FRAMES, **LOOP_OVERRIDES},
          "widths": {"density_comps": 16, "appearance_comps": 48,
                     "instance_mlp": 256, "precision": cfg.precision,
                     "batch_size": cfg.batch_size,
                     "instance_rays": [cfg.batch_size_contrastive,
                                       cfg.max_rays_instances],
                     "segment_rays": [cfg.batch_size_segments,
                                      cfg.max_rays_segments]}})
    runs = ROOT / "runs"
    runs.mkdir(exist_ok=True)
    with tempfile.TemporaryDirectory(dir=runs) as tmp:
        torch.cuda.reset_peak_memory_stats()
        t_start = time.perf_counter()
        trainer = Trainer(cfg, scene, Path(tmp) / "run", log_every=1,
                          device="cuda")
        trainer.fit()
        fit_seconds = time.perf_counter() - t_start
        run = Path(tmp) / "run"
        records = [json.loads(line) for line in
                   (run / "metrics.jsonl").read_text().splitlines()]
        sec = trainer.seconds
        per_epoch = []
        for epoch in range(cfg.max_epoch):
            steps = [s for e, s in sec["step"] if e == epoch]
            warm = steps[1:]
            stage = [st for st in trainer.stages if st["epoch"] == epoch][-1]
            val = [r for r in records if r.get("epoch") == epoch
                   and "val/psnr" in r]
            per_epoch.append({
                **stage, "voxels": int(np.prod(stage["grid_dim"])),
                **{k: sum(s for e, s in sec[k] if e == epoch)
                   for k in ("shrink", "upscale", "calibrate", "rebuild",
                             "validate", "visualize", "save")},
                "steps": len(steps), "train_seconds": sum(steps),
                "warm_steps_per_second": len(warm) / sum(warm),
                "val": {k[4:]: v for k, v in val[-1].items()
                        if k.startswith("val/")} if val else None})
            emit({"phase": "train_loop_r5b", "card": card, **per_epoch[-1]})
        sanity = [r for r in records if "sanity_val/psnr" in r][0]
        last_val = [r for r in records if "val/psnr" in r][-1]
        emit({"phase": "train_loop_r5b", "card": card, "fit": True,
              "global_step": trainer.global_step,
              "sanity_val": {k: v for k, v in sanity.items()
                             if k.startswith("sanity_val/")},
              "sanity_seconds": [s for e, s in sec["validate"] if e == -1],
              "max_memory_allocated_bytes": trainer.stages[-1][
                  "max_memory_allocated"],
              "fit_seconds": fit_seconds})
        bad = [r for r in records if not all(
            np.isfinite(v) for v in r.values() if isinstance(v, float))]
        if bad:
            raise AssertionError(f"train_loop_r5b: non-finite metrics {bad[:3]}")
        for i, epoch in enumerate(cfg.grid_upscale_epochs):
            target = trainer.voxel_schedule[i]
            voxels = per_epoch[epoch]["voxels"]
            if not 0.96 * target <= voxels <= target:
                raise AssertionError(f"train_loop_r5b: {voxels} voxels after "
                                     f"the upscale to {target}")
        if not last_val["val/psnr"] > sanity["sanity_val/psnr"]:
            raise AssertionError(
                f"train_loop_r5b: last validation psnr {last_val['val/psnr']}"
                f" is not above the sanity one {sanity['sanity_val/psnr']}")
        last = run / "checkpoints" / "last.npz"
        _, meta = load_checkpoint(last)
        got = (meta["epoch"], meta["global_step"], tuple(meta["grid_dim"]))
        want = (cfg.max_epoch, trainer.global_step, tuple(trainer.grid_dim))
        if got != want:
            raise AssertionError(f"last.npz holds {got}, the trainer {want}")

        # resume: one more step from the trainer's state and from a fresh
        # trainer restored from last.npz, on the same batches and draws
        epoch = cfg.max_epoch
        gates = gates_for_epoch(cfg, epoch)
        lr_scale = lr_scale_for_epoch(epoch, cfg.decay_step, cfg.decay_gamma,
                                      cfg.warmup_epochs, cfg.warmup_multiplier)
        lambda_dist = cfg.lambda_dist_reg * (1 - np.exp(-0.25 * epoch))
        rng = np.random.default_rng(TRAIN_STEP_SEED)
        bm = trainer.main_sampler.sample(rng, cfg.batch_size)
        bi_ = trainer.inst_sampler.sample(rng, cfg.batch_size_contrastive)
        bs = trainer.seg_sampler.sample(rng, cfg.batch_size_segments)
        draws = draw_step(torch.Generator(device="cuda").manual_seed(1), cfg,
                          cfg.batch_size, len(bs["rays"]),
                          tuple(bi_["rays"].shape[:2]))
        k = trainer._aux_k
        fresh = Trainer(load_config(R5B_CONFIG, LOOP_OVERRIDES).resolve_epochs(),
                        scene, Path(tmp) / "resumed", device="cuda")
        fresh.restore(last)
        mismatched = []
        for name, a, b in (
                ("params", trainer.state.params, fresh.state.params),
                ("opt_main", trainer.state.opt_state_main,
                 fresh.state.opt_state_main),
                ("opt_inst", trainer.state.opt_state_inst,
                 fresh.state.opt_state_inst)):
            la, lb = tree_leaves_with_path(a), tree_leaves_with_path(b)
            if [p for p, _ in la] != [p for p, _ in lb]:
                mismatched.append(f"{name}: leaf paths differ")
                continue
            mismatched += [f"{name} {path}" for (path, x), (_, y)
                           in zip(la, lb) if not torch.equal(x, y)]
        metrics = []
        for tr in (trainer, fresh):
            step = make_train_step(tr.cfg, tr.mcfg, tr.rcfg, gates,
                                   tr.class_weights, tr.state.params,
                                   aux_head_topk=k)
            _, m = step(tr.state, tr.state_r, bm, bi_, bs, draws, lr_scale,
                        lambda_dist)
            metrics.append({name: float(v) for name, v in m.items()})
        rel = {name: abs(metrics[1][name] - v) / max(abs(v), 1e-12)
               for name, v in metrics[0].items()}
        emit({"phase": "train_loop_r5b", "resume": True,
              "restored_epoch": fresh.start_epoch,
              "restored_step": fresh.global_step,
              "mismatched_leaves": mismatched[:10], "aux_k": k,
              "metrics_a": metrics[0], "metrics_b": metrics[1],
              "max_rel_diff": max(rel.values())})
        if mismatched:
            raise AssertionError(f"restore differs from the saved state: "
                                 f"{mismatched[:10]}")
        for name, r in rel.items():
            if not (r <= RESUME_RTOL or abs(metrics[1][name]
                                            - metrics[0][name]) <= 1e-9):
                raise AssertionError(f"resumed step {name}: {metrics[1][name]}"
                                     f" vs {metrics[0][name]}")

        # the fused kernel against its plain version on the first pass-A
        # chunk of the render below (its grid, budgets and samples), then
        # the loop's checkpoint through the production render
        dense, shift, xyz = production_chunk(last, scene, device="cuda")
        xyz = xyz.contiguous()
        empty_kernel_ms = empty_kernel()
        loop_records = {
            ("sample_density_brick", "loop_chunk", dtype): run_case(
                "train_loop_r5b", "sample_density_brick", "loop_chunk", dtype,
                lambda: fused_case(dense, xyz, shift, dtype), xyz.shape[0],
                empty_kernel_ms)
            for dtype in DTYPES}
        got_chunk = (xyz.shape[0], tuple(dense.shape))
        del dense, xyz
        torch.cuda.empty_cache()
        bi.reset_launches()
        t0 = time.perf_counter()
        res = run_production(last, scene, device="cuda")
        seconds = time.perf_counter() - t0
        launches = launch_counts()
        n_rays = sum(len(f.rays) for f in scene.val_frames)
        emit({"phase": "train_loop_r5b", "render": True, "card": card,
              "launches": launches,
              "budgets": {f: getattr(res["rcfg"], f) for f in BUDGET_FIELDS},
              **{k: res[k] for k in ("pq_scene", "pq_masked", "sq", "rq",
                                     "budget_tail", "head_tail", "warnings",
                                     "n_samples", "grid_dim")},
              "render_seconds": res["render_seconds"],
              "rays_per_second": n_rays / res["render_seconds"],
              "cluster_seconds": res["cluster_seconds"], "seconds": seconds})
        print(f"train_loop_r5b: {trainer.global_step} steps in "
              f"{fit_seconds:.1f} s, peak "
              f"{trainer.stages[-1]['max_memory_allocated'] / 2**30:.2f} GiB, "
              f"render {n_rays / res['render_seconds']:.0f} rays/s on {card}",
              flush=True)
        if launches["sample_density_brick"].get("float32", 0) < 1:
            raise AssertionError("the loop checkpoint's production render "
                                 "never launched the float32 "
                                 "sample_density_brick kernel")
        n_chunk = (PRODUCTION_CHUNK * res["rcfg"].term_first * 8,
                   tuple(res["grid_dim"]))
        if got_chunk != n_chunk:
            raise AssertionError(f"loop_chunk has (samples, grid) {got_chunk}"
                                 f", the render's first chunk {n_chunk}")
        for frame in res["maps"]:
            for key, value in frame.items():
                if not np.isfinite(value).all():
                    raise AssertionError(f"render of last.npz: {key} map is "
                                         "not finite")
    return launches, loop_records


def phase_cli_r5b():
    """The render and evaluate CLIs on r5b laid out as files, held to the
    CLI golden, then the fused kernel against its plain version on the CLI
    render's first pass-A chunk (``cli_chunk``). Returns (the density-kernel
    launches of the two CLI renders, records[(kernel, "cli_chunk",
    dtype)])."""
    import tempfile

    import numpy as np
    import torch
    from contrastive_lift_tpu_torch.inference.fidelity import (
        PRODUCTION_CHUNK, R5B_SCENE, check_cli, cli_chunk, cli_run_dir,
        e2e_scene, labels_match, run_cli, write_mos_scene)
    from contrastive_lift_tpu_torch.inference.hdbscan import hdbscan_labels
    from contrastive_lift_tpu_torch.ops import brick_interp as bi

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    card = card_line()
    runs = ROOT / "runs"
    runs.mkdir(exist_ok=True)
    with tempfile.TemporaryDirectory(dir=runs) as tmp:
        tmp = Path(tmp)
        t0 = time.perf_counter()
        scene_root = write_mos_scene(e2e_scene(*R5B_SCENE), tmp / "scene")
        ckpt = cli_run_dir(tmp / "run", scene_root)
        write_seconds = time.perf_counter() - t0
        bi.reset_launches()
        t0 = time.perf_counter()
        res = run_cli(ckpt, scene_root, tmp / "out", device="cuda")
        seconds = time.perf_counter() - t0
        launches = launch_counts()
        with np.load(CLI_GOLDEN) as g:
            bad, measured = check_cli(res, g)
            gold = {k: g[k].item() for k in g.files
                    if k.startswith(("meanshift_", "dbscan_"))}
            t0 = time.perf_counter()
            labels = hdbscan_labels(g["hdbscan_sample"],
                                    int(g["hdbscan_min_cluster_size"]),
                                    device="cuda")
            hdbscan_seconds = time.perf_counter() - t0
            if not labels_match(labels, g["hdbscan_labels"]):
                bad.append("HDBSCAN on the card differs from scikit-learn's "
                           "labels of the golden's sample")
            n_chunk = PRODUCTION_CHUNK * int(g["budget_term_first"]) * 8
            hdbscan = {"points": len(labels),
                       "clusters": int(labels.max()) + 1,
                       "noise": int((labels == -1).sum()),
                       "seconds": hdbscan_seconds}
        for name, run in res.items():
            emit({"phase": "cli_r5b", "clustering": name, "card": card,
                  **run["summary"], "scores": run["scores"],
                  "golden_scores": {k[len(name) + 1:]: v for k, v in
                                    gold.items() if k.startswith(name)},
                  "budgets": run["budgets"], **measured[name]})
        emit({"phase": "cli_r5b", "card": card, "launches": launches,
              "hdbscan_golden_sample": hdbscan, "failures": bad,
              "write_seconds": write_seconds, "seconds": seconds})
        print("cli_r5b: " + ", ".join(
            f"{name} render {run['summary']['render_seconds']:.2f} s "
            f"({run['summary']['rays_per_second']:.0f} rays/s), cluster "
            f"{run['summary']['cluster_seconds']:.2f} s"
            for name, run in res.items()) + f" on {card}", flush=True)
        if bad:
            raise AssertionError(f"cli_r5b differs from the JAX golden: {bad}")
        if launches["sample_density_brick"].get("float32", 0) < 1:
            raise AssertionError("the render CLI never launched the float32 "
                                 "sample_density_brick kernel")

        # the fused kernel against its plain version on the first pass-A
        # chunk of the CLI's render (its scene, model and budgets)
        dense, shift, xyz = cli_chunk(ckpt, device="cuda")
        xyz = xyz.contiguous()
        if xyz.shape[0] != n_chunk:
            raise AssertionError(f"cli_chunk has {xyz.shape[0]} samples, the "
                                 f"CLI render's first chunk {n_chunk}")
        empty_kernel_ms = empty_kernel()
        records = {
            ("sample_density_brick", "cli_chunk", dtype): run_case(
                "cli_r5b", "sample_density_brick", "cli_chunk", dtype,
                lambda: fused_case(dense, xyz, shift, dtype), xyz.shape[0],
                empty_kernel_ms)
            for dtype in DTYPES}
        del dense, xyz
        torch.cuda.empty_cache()
    return launches, records


def phase_tools_r5b():
    """The calibration, bounding-box, legacy-render and editing tools and
    the importer on r5b laid out as files, held to the tools golden.
    Returns the density-kernel launches of the phase."""
    import tempfile

    import numpy as np
    import torch
    from contrastive_lift_tpu_torch.inference import fidelity as fid
    from contrastive_lift_tpu_torch.ops import brick_interp as bi

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    card = card_line()
    runs = ROOT / "runs"
    runs.mkdir(exist_ok=True)
    t_phase = time.perf_counter()
    with tempfile.TemporaryDirectory(dir=runs) as tmp, \
            np.load(TOOLS_GOLDEN) as g:
        tmp = Path(tmp)
        scene_root = fid.write_mos_scene(fid.e2e_scene(*fid.R5B_SCENE),
                                         tmp / "scene")
        ckpt = fid.tools_run_dir(tmp / "run", scene_root)
        bi.reset_launches()
        res = fid.run_tools(ckpt, scene_root, tmp / "out", device="cuda")
        edits = fid.run_edits(ckpt, g, device="cuda")
        before_import = launch_counts()
        imported = fid.run_import(tmp / "import", device="cuda")
        launches = launch_counts()
        bad, measured = fid.check_tools(res, g)
        bad_edits, edit_errs = fid.check_edits(edits, g)
        bad += bad_edits
        golden_best = [float(g["bw_best_value"]), float(g["bw_best_pq"])]
    import_f32 = (launches["sample_density_brick"].get("float32", 0)
                  - before_import["sample_density_brick"].get("float32", 0))
    for key, value in imported["maps"].items():
        if not np.isfinite(value).all():
            bad.append(f"imported checkpoint: {key} map is not finite")
    if import_f32 < 1:
        bad.append("the imported checkpoint's render never launched the "
                   "float32 sample_density_brick kernel")
    if launches["sample_density_brick"].get("float32", 0) < 1:
        bad.append("tools_r5b never launched the float32 "
                   "sample_density_brick kernel")
    tools = {name: (run["seconds"], run["rays"]) for name, run in res.items()}
    tools.update({f"render_edited_{k}": (run["seconds"], run["rays"])
                  for k, run in edits.items()})
    tools["import_render"] = (imported["seconds"], imported["rays"])
    for name, (sec, rays) in tools.items():
        emit({"phase": "tools_r5b", "tool": name, "card": card,
              "seconds": sec, "rays": rays, "rays_per_second": rays / sec})
    bw = res["find_bandwidth"]
    emit({"phase": "tools_r5b", "card": card, "launches": launches,
          "import_f32_launches": import_f32,
          "thing_points": bw["thing_points"],
          "best_bandwidth": bw["result"]["best_value"],
          "best_pq": bw["result"]["best_pq"],
          "golden_best": golden_best,
          "cached_scores": res["render_cached"]["scores"],
          "boxes": {m: len(res[f"visualize_bboxes_{m}"]["boxes"]["ids"])
                    for m in fid.BOX_RUN_METHODS},
          "edit_max_abs_err": edit_errs, **measured,
          "import_info": imported["info"],
          "import_seconds": imported["import_seconds"],
          "failures": bad, "seconds": time.perf_counter() - t_phase})
    print("tools_r5b: " + ", ".join(f"{name} {sec:.2f} s ({rays / sec:.0f} "
                                    f"rays/s)" for name, (sec, rays)
                                    in tools.items()) + f" on {card}",
          flush=True)
    if bad:
        raise AssertionError(f"tools_r5b differs from the JAX golden: {bad}")
    return launches


# the seconds the 2 ranks of ddp_r5b may take, start-up included
DDP_TIMEOUT = 300


def phase_ddp_r5b():
    """The data-parallel step and render: one NCCL rank held to the train
    golden, two gloo ranks on the card held to one process and the
    production golden. Returns each rank's density-kernel launches in its
    sharded render."""
    import tempfile

    import numpy as np
    import torch
    from contrastive_lift_tpu_torch.config import load_config
    from contrastive_lift_tpu_torch.inference import fidelity as fid
    from contrastive_lift_tpu_torch.parallel import launch
    from contrastive_lift_tpu_torch.parallel import mesh as pmesh
    from contrastive_lift_tpu_torch.train import resume

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    card = card_line()
    t_phase = time.perf_counter()
    scene = fid.e2e_scene(*fid.R5B_SCENE)
    runs = ROOT / "runs"
    runs.mkdir(exist_ok=True)
    # (a) the golden step through the sharded code, one NCCL rank
    with tempfile.TemporaryDirectory(dir=runs) as tmp, \
            np.load(TRAIN_GOLDEN) as g:
        gold = {k: g[k] for k in g.files}
        mesh = pmesh.make_mesh(1, backend="nccl", device="cuda",
                               init_method=f"file://{tmp}/store")
        try:
            res = resume.golden_step(fid.R5B_CKPT, load_config(fid.R5B_CONFIG),
                                     scene, gold, device="cuda", mesh=mesh)
            nccl_bytes = mesh.all_reduce_bytes
        finally:
            pmesh.close_mesh()
    bad = resume.check_train_step(res, gold)
    emit({"phase": "ddp_r5b", "part": "nccl_1_rank", "card": card,
          "backend": "nccl", "ranks": 1,
          "aux_head_topk": res["aux_head_topk"],
          "metrics": {m: res["metrics"][m] for m in resume.TRAIN_METRICS},
          "golden": {m: float(gold[f"metric_{m}"])
                     for m in resume.TRAIN_METRICS},
          "max_sketch_err": {
              name: max(resume.sketch_error(a, b) for a, b in
                        zip(res[f"sketch_{name}"], gold[f"sketch_{name}"]))
              for name in resume.SKETCHES},
          "all_reduce_bytes": nccl_bytes, "failures": bad})
    if bad:
        raise AssertionError(f"ddp_r5b: the 1-rank NCCL step differs from "
                             f"the JAX golden: {bad[:10]}")
    # (b) one process, then two gloo ranks sharing the card
    torch.cuda.empty_cache()
    one = fid.ddp_r5b("cuda")
    # the card's own spread: the unsharded run again, held to the first
    _, repeat = fid.check_ddp(fid.ddp_r5b("cuda"), one)
    t0 = time.perf_counter()
    two = launch.spawn(fid.ddp_r5b, 2, ("cuda", fid.DDP_STEPS, "gloo"),
                       timeout=DDP_TIMEOUT)
    spawn_s = time.perf_counter() - t0
    bad, measured = fid.check_ddp(two, one)
    cfg = fid.e2e_config(scene.image_dim)
    scores = {}
    for name, run in (("unsharded", one), ("sharded", two)):
        onehot = fid.cluster_maps(run["maps"], scene, fid.BANDWIDTH,
                                  cfg.max_instances, "cuda")
        scores[name] = dict(zip(("pq_scene", "sq", "rq", "pq_masked"),
                                fid.pq_for(run["maps"], onehot, scene,
                                           cfg.max_instances)))
    if scores["sharded"] != scores["unsharded"]:
        bad.append(f"sharded PQ {scores['sharded']} vs unsharded "
                   f"{scores['unsharded']}")
    with np.load(PRODUCTION_GOLDEN) as g:
        gold_budgets = {f: g[f"budget_{f}"].item() for f in fid.BUDGET_FIELDS}
    budgets = {f: getattr(two["rcfg"], f) for f in fid.BUDGET_FIELDS}
    if budgets != gold_budgets:
        bad.append(f"sharded render budgets {budgets} vs the JAX golden's "
                   f"{gold_budgets}")
    map_err = map_errors(two, PRODUCTION_GOLDEN)
    bad.extend(f"sharded {key} map differs from the JAX golden by {err}"
               for key, err in map_err.items() if not err <= BF16_MAP_TOL)
    gold_scores = golden(PRODUCTION_GOLDEN)[2]
    bad.extend(f"sharded {key} {scores['sharded'][key]} vs the JAX golden's "
               f"{gold_scores[key]}" for key in ("pq_scene", "pq_masked")
               if not abs(scores["sharded"][key] - gold_scores[key])
               <= PQ_TOL)
    warm = slice(1, None)
    emit({"phase": "ddp_r5b", "part": "gloo_2_ranks_one_card", "card": card,
          "backend": "gloo", "ranks": two["ranks"],
          "overrides": fid.DDP_OVERRIDES,
          "aux_head_topk": two["aux_head_topk"],
          "metrics": two["metrics"], "unsharded_metrics": one["metrics"],
          **measured, "unsharded_repeat": repeat,
          "replica_param_digests": two["param_digests"],
          "replica_opt_digests": two["opt_digests"],
          "step_seconds": two["step_seconds"],
          "unsharded_step_seconds": one["step_seconds"],
          "all_reduce_bytes_per_step": two["all_reduce_bytes"],
          "all_reduce_ms": two["all_reduce_ms"],
          "budgets": budgets, "golden_budgets": gold_budgets,
          "map_max_abs_err_vs_golden": map_err, "scores": scores,
          "golden": gold_scores,
          "render_seconds": two["render_seconds"],
          "unsharded_render_seconds": one["render_seconds"],
          "launches_per_rank": two["launches"],
          "unsharded_launches": one["launches"][0],
          "spawn_seconds": spawn_s, "failures": bad,
          "seconds": time.perf_counter() - t_phase})
    per_rank = [r["sample_density_brick"].get("float32", 0)
                for r in two["launches"]]
    print(f"ddp_r5b: 2 gloo ranks sharing one card (not a scaling number): "
          f"warm step {np.mean(two['step_seconds'][warm]):.4f} s against "
          f"{np.mean(one['step_seconds'][warm]):.4f} s unsharded; "
          f"{two['all_reduce_bytes'][-1]} all-reduce bytes a step, one "
          f"all-reduce of them {two['all_reduce_ms']:.2f} ms; render "
          f"{two['render_seconds']:.3f} s against "
          f"{one['render_seconds']:.3f} s; fused float32 launches per rank "
          f"{per_rank} on {card}", flush=True)
    if bad:
        raise AssertionError(f"ddp_r5b: {bad[:10]}")
    return two["launches"]


def phase_distilled_r5b(train_warm_steps_per_second: float,
                        train_peak_bytes: int,
                        production_warm_rays_per_second: float):
    """r5b with grafted distilled-feature heads: the golden step, the
    production render and its first chunk's distilled map held to the JAX
    golden, then warm steps. Returns the density-kernel launches of the
    render."""
    import tempfile

    import numpy as np
    import torch
    from contrastive_lift_tpu_torch.inference import fidelity as fid
    from contrastive_lift_tpu_torch.ops import brick_interp as bi
    from contrastive_lift_tpu_torch.train import resume
    from contrastive_lift_tpu_torch.train.step import make_train_step

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    card = card_line()
    t_phase = time.perf_counter()
    with np.load(DISTILLED_GOLDEN) as g:
        gold = {k: g[k] for k in g.files}
    scene = fid.distilled_targets(fid.e2e_scene(*fid.R5B_SCENE),
                                  int(gold["distilled_seed"]))
    rcfg_render = fid.distilled_render_config(scene.image_dim)
    runs = ROOT / "runs"
    runs.mkdir(exist_ok=True)
    with tempfile.TemporaryDirectory(dir=runs) as tmp:
        t0 = time.perf_counter()
        ckpt = fid.write_distilled_checkpoint(Path(tmp) / "distilled.npz",
                                              int(gold["distilled_seed"]))
        graft_s = time.perf_counter() - t0
        # (a) step 1 against the golden
        res = resume.golden_step(ckpt, fid.distilled_config(), scene, gold,
                                 device="cuda")
        bad = resume.check_train_step(res, gold, resume.DISTILLED_METRICS)
        if not res["metrics"]["loss_feat"] > 0:
            bad.append(f"loss_feat {res['metrics']['loss_feat']} is not "
                       "positive: the feature gate is closed")
        # (b) the production render, launch counts zeroed just before
        bi.reset_launches()
        prod = fid.run_production(ckpt, scene, device="cuda",
                                  cfg=rcfg_render)
        launches = launch_counts()
        warm = fid.run_production(ckpt, scene, device="cuda",
                                  cfg=rcfg_render)
        # (c) the first chunk's distilled map
        dist = fid.distilled_chunk(ckpt, scene, device="cuda").cpu().numpy()
    n_rays = sum(len(f.rays) for f in scene.val_frames)
    budgets = {f: getattr(prod["rcfg"], f) for f in fid.BUDGET_FIELDS}
    gold_budgets = {f: gold[f"budget_{f}"].item() for f in fid.BUDGET_FIELDS}
    gold_warnings = [str(w) for w in gold["warnings"]]
    map_err = map_errors(prod, DISTILLED_GOLDEN)
    gold_scores = golden(DISTILLED_GOLDEN)[2]
    rows = dist[gold["distilled_ray_index"]]
    dist_err = float(np.abs(rows - gold["distilled"]).max())
    norms = np.linalg.norm(dist, axis=-1)
    hit = np.linalg.norm(gold["distilled"], axis=-1) > 0.5
    norm_err = float(np.abs(norms[gold["distilled_ray_index"]][hit]
                            - 1.0).max())
    for run in (prod, warm):
        got = {f: getattr(run["rcfg"], f) for f in fid.BUDGET_FIELDS}
        if got != gold_budgets:
            bad.append(f"render budgets {got} vs the JAX golden's "
                       f"{gold_budgets}")
        if ([fid.guardrail(m) for m in run["warnings"]]
                != [fid.guardrail(m) for m in gold_warnings]):
            bad.append(f"warnings {run['warnings']}; the JAX golden raised "
                       f"{gold_warnings}")
        bad.extend(f"{key} {run[key]} vs the JAX golden's {gold_scores[key]}"
                   for key in ("pq_scene", "pq_masked")
                   if not abs(run[key] - gold_scores[key]) <= PQ_TOL)
    bad.extend(f"{key} map differs from the JAX golden by {err}"
               for key, err in map_err.items() if not err <= BF16_MAP_TOL)
    if not dist_err <= BF16_MAP_TOL:
        bad.append(f"distilled map differs from the JAX golden by {dist_err}")
    if not (hit.any() and norm_err <= 1e-4):
        bad.append(f"distilled rows are not of unit norm: {norm_err}")
    if launches["sample_density_brick"].get("float32", 0) < 1:
        bad.append("the distilled render never launched the float32 "
                   "sample_density_brick kernel")
    # warm steps on the port's own samplers and generator
    setup = res["setup"]
    cfg = setup.cfg
    step = make_train_step(cfg, setup.mcfg, setup.rcfg, setup.gates,
                           setup.class_weights, setup.state.params,
                           aux_head_topk=res["aux_head_topk"])
    state = res["state"]
    gen = torch.Generator(device="cuda").manual_seed(int(cfg.seed or 0))
    rng = np.random.default_rng(TRAIN_STEP_SEED)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    times, feat_losses = [], []
    for _ in range(1 + DISTILLED_STEPS):
        t = time.perf_counter()
        bm, bi_, bs = resume.step_batches(setup, rng)
        state, m = step(state, setup.state_r, bm, bi_, bs, gen,
                        setup.lr_scale, setup.lambda_dist_reg)
        m = {k: float(v) for k, v in m.items()}
        times.append(time.perf_counter() - t)
        feat_losses.append(m["loss_feat"])
        if not all(np.isfinite(v) for v in m.values()):
            bad.append(f"a warm step's metric is not finite: {m}")
    peak = torch.cuda.max_memory_allocated()
    steps_per_s = DISTILLED_STEPS / sum(times[1:])
    emit({"phase": "distilled_r5b", "card": card,
          "aux_head_topk": res["aux_head_topk"],
          "golden_aux_head_topk": gold["aux_head_topk"].item(),
          "metrics": {m: res["metrics"][m] for m in resume.DISTILLED_METRICS},
          "golden": {m: float(gold[f"metric_{m}"])
                     for m in resume.DISTILLED_METRICS},
          "max_sketch_err": {
              name: max(resume.sketch_error(a, b) for a, b in
                        zip(res[f"sketch_{name}"], gold[f"sketch_{name}"]))
              for name in resume.SKETCHES},
          "launches": launches, "budgets": budgets,
          "golden_budgets": gold_budgets, "map_max_abs_err": map_err,
          "distilled_max_abs_err": dist_err,
          "distilled_norm_max_err": norm_err,
          **{k: prod[k] for k in ("pq_scene", "pq_masked", "sq", "rq",
                                  "warnings")},
          "golden_scores": gold_scores,
          "render_seconds": prod["render_seconds"],
          "warm_render_seconds": warm["render_seconds"],
          "warm_rays_per_second": n_rays / warm["render_seconds"],
          "main_production_warm_rays_per_second":
              production_warm_rays_per_second,
          "step_seconds": times, "warm_steps_per_second": steps_per_s,
          "train_r5b_warm_steps_per_second": train_warm_steps_per_second,
          "max_memory_allocated_bytes": peak,
          "train_r5b_max_memory_allocated_bytes": train_peak_bytes,
          "loss_feat": feat_losses, "graft_seconds": graft_s,
          "part_seconds": res["seconds"], "failures": bad,
          "seconds": time.perf_counter() - t_phase})
    print(f"distilled_r5b: {steps_per_s:.3f} warm steps/s (train_r5b "
          f"{train_warm_steps_per_second:.3f}), peak {peak / 2**30:.2f} GiB "
          f"(train_r5b {train_peak_bytes / 2**30:.2f}); warm render "
          f"{n_rays / warm['render_seconds']:.0f} rays/s (main_production "
          f"{production_warm_rays_per_second:.0f}); fused float32 launches "
          f"{launches['sample_density_brick'].get('float32', 0)} on {card}",
          flush=True)
    if bad:
        raise AssertionError(f"distilled_r5b: {bad[:10]}")
    return launches


def phase_preprocess_scannet():
    """A raw ScanNet capture through the port's preprocessing, reader,
    training and render, held to the JAX package's golden (see the module
    docstring). Returns the density-kernel launches of the render."""
    import hashlib
    import tempfile

    import numpy as np
    import torch
    from contrastive_lift_tpu_torch.data.preprocessing.sens_reader import (
        iter_frames)
    from contrastive_lift_tpu_torch.inference import fidelity as fid
    from contrastive_lift_tpu_torch.ops import brick_interp as bi
    from contrastive_lift_tpu_torch.utils.jpeg import decode_jpeg, encode_jpeg

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    card = card_line()
    t_phase = time.perf_counter()
    with np.load(PREPROCESS_GOLDEN) as g:
        gold = {k: g[k] for k in g.files}
    bad = []
    runs = ROOT / "runs"
    runs.mkdir(exist_ok=True)
    with tempfile.TemporaryDirectory(dir=runs) as tmp:
        tmp = Path(tmp)
        # (a) the raw capture, its .sens byte for byte the golden's
        t0 = time.perf_counter()
        raw = fid.write_raw_scannet(tmp / "raw")
        write_s = time.perf_counter() - t0
        sha = hashlib.sha256(raw["sens"].read_bytes()).hexdigest()
        if sha != str(gold["sens_sha256"]):
            raise AssertionError(f"preprocess_scannet: .sens sha256 {sha}, "
                                 f"the golden's {gold['sens_sha256']}")
        _, _, frame = next(iter_frames(raw["sens"]))
        t0 = time.perf_counter()
        rgb = decode_jpeg(frame.color_bytes)
        decode_s = time.perf_counter() - t0
        t0 = time.perf_counter()
        encode_jpeg(rgb, fid.SCANNET_QUALITY)
        encode_s = time.perf_counter() - t0
        # (b) the preprocessing, (c) the reader: every file and array at
        # the golden
        pre = fid.run_preprocess(raw, tmp / "tree")
        t0 = time.perf_counter()
        scene = fid.load_preprocessed(tmp / "tree")
        reader_s = time.perf_counter() - t0
        t0 = time.perf_counter()
        checked = fid.check_preprocess(tmp / "tree", gold, scene=scene)
        check_s = time.perf_counter() - t0
        # (d) training at r5b's widths, then the render at 480x640
        torch.cuda.reset_peak_memory_stats()
        fit = fid.train_preprocessed(tmp / "tree", tmp / "run")
        losses = [r for r in fit["records"] if "loss_main" in r]
        if not losses or not all(np.isfinite(v) for r in fit["records"]
                                 for v in r.values()
                                 if isinstance(v, float)):
            bad.append(f"non-finite or missing training metrics "
                       f"{fit['records'][-2:]}")
        opened = {k for r in losses for k in r}
        if not {"loss_clustering", "loss_segment"} <= opened:
            bad.append(f"the instance and segment losses never ran: "
                       f"{sorted(opened)}")
        bi.reset_launches()
        out = fid.render_preprocessed(fit["last"], fit["cfg"], scene)
        launches = launch_counts()
        peak = torch.cuda.max_memory_allocated()
        for m in out["maps"]:
            bad.extend(f"render map {k} is not finite"
                       for k, v in m.items() if not np.isfinite(v).all())
        shapes = {k: v.shape for k, v in out["maps"][0].items()}
    rays_per_s = out["rays"] / out["render_seconds"]
    k1 = launches["sample_density_brick"].get("float32", 0)
    if k1 < 1:
        bad.append("the render never launched the float32 "
                   "sample_density_brick kernel")
    emit({"phase": "preprocess_scannet", "card": card,
          "sens_sha256": sha, "raw_frames": fid.SCANNET_FRAMES,
          "color_hw": fid.SCANNET_COLOR_HW, "image_hw": fid.SCANNET_IMAGE_HW,
          "write_raw_seconds": write_s,
          "encode_seconds_per_frame": encode_s,
          "decode_seconds_per_frame": decode_s,
          "preprocess_seconds": pre["seconds"], "frames": pre["frames"],
          "reader_seconds": reader_s, "check_seconds": check_s, **checked,
          "train_cuts": {"image_dim": fid.PREPROCESS_TRAIN_HW,
                         **fid.PREPROCESS_OVERRIDES},
          "fit_seconds": fit["fit_seconds"], "steps": fit["steps"],
          "fit_parts_seconds": {k: sum(s for _, s in v) for k, v in
                                fit["trainer"].seconds.items()},
          "step_seconds": [s for _, s in fit["trainer"].seconds["step"]],
          "warm_steps_per_second": fit["warm_steps_per_second"],
          "last_losses": {k: v for k, v in losses[-1].items()
                          if k.startswith("loss")} if losses else None,
          "render_rays": out["rays"], "render_seconds": out["render_seconds"],
          "rays_per_second": rays_per_s, "map_shapes": shapes,
          "max_memory_allocated_bytes": peak, "launches": launches,
          "failures": bad, "seconds": time.perf_counter() - t_phase})
    print(f"preprocess_scannet: 968x1296 frame encode {encode_s:.3f} s, "
          f"decode {decode_s:.3f} s; preprocess {pre['seconds']:.1f} s, "
          f"reader {reader_s:.1f} s, fit {fit['fit_seconds']:.1f} s at "
          f"{fit['warm_steps_per_second']:.2f} warm steps/s, render "
          f"{rays_per_s:.0f} rays/s, fused float32 launches {k1} on {card}",
          flush=True)
    if bad:
        raise AssertionError(f"preprocess_scannet: {bad[:10]}")
    return launches


def kernel_line(records, launches):
    """The ``kernels`` line: each entry point and row type, with its numbers
    on the render-chunk inputs (the dense main path's own) and its launches
    in the dense render of that row type; the fused form also with its time
    on the production chunk and its launches in ``main_production``, and
    with its time and error on the loop chunk and its launches in
    ``train_loop_r5b``'s render, and on the CLI chunk with its launches in
    ``cli_r5b``; every entry with its launches in ``tools_r5b``, summed
    over the ranks in ``ddp_r5b``, in ``distilled_r5b``'s render and in
    ``preprocess_scannet``'s render."""
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
                    .get(dtype, 0),
                    train_loop_r5b_launches=launches["train_loop"][kname]
                    .get(dtype, 0),
                    cli_r5b_launches=launches["cli"][kname].get(dtype, 0))
            entry["tools_r5b_launches"] = launches["tools"][kname].get(dtype, 0)
            entry["options_r5b_launches"] = {
                name: counts[kname].get(dtype, 0)
                for name, counts in launches["options"].items()}
            entry["ddp_r5b_launches"] = sum(rank[kname].get(dtype, 0)
                                            for rank in launches["ddp"])
            entry["distilled_r5b_launches"] = launches["distilled"][kname] \
                .get(dtype, 0)
            entry["preprocess_scannet_launches"] = launches["preprocess"][
                kname].get(dtype, 0)
            loop = records.get((kname, "loop_chunk", dtype))
            if loop is not None:
                entry.update(loop_chunk_ms=loop["ms"],
                             loop_chunk_plain_ms=loop["plain_ms"],
                             loop_chunk_bound_ms=loop["bound_ms"],
                             loop_chunk_library_ms=loop["library_ms"],
                             loop_chunk_max_abs_err=loop["max_abs_err"])
            cli = records.get((kname, "cli_chunk", dtype))
            if cli is not None:
                entry.update(cli_chunk_ms=cli["ms"],
                             cli_chunk_plain_ms=cli["plain_ms"],
                             cli_chunk_bound_ms=cli["bound_ms"],
                             cli_chunk_library_ms=cli["library_ms"],
                             cli_chunk_max_abs_err=cli["max_abs_err"])
            entries.append(entry)
    kname = "sample_density_brick_span"
    for dtype in DTYPES:
        rec = records[(kname, "span_chunk", dtype)]
        entries.append({
            "name": f"{kname}_{'f32' if dtype == 'float32' else 'bf16'}",
            "dtype": dtype, "route": "cuda", "source": KERNEL_SOURCE,
            "replaces": SPAN_REPLACES,
            "launches": launches["options"]["span"][kname].get(dtype, 0),
            "max_abs_err": max(rec_["max_abs_err"] for (k, _, d), rec_
                               in records.items() if k == kname and d == dtype),
            **{k: rec[k] for k in ("ms", "plain_ms", "bound_ms", "bound_by",
                                   "library_ms", "l2_warm_ms", "fused_ms")},
            "random_ms": records[(kname, "random", dtype)]["ms"],
            "random_bound_ms": records[(kname, "random", dtype)]["bound_ms"],
            "options_r5b_launches": {
                name: counts[kname].get(dtype, 0)
                for name, counts in launches["options"].items()},
            "distilled_r5b_launches": launches["distilled"][kname]
            .get(dtype, 0),
            "preprocess_scannet_launches": launches["preprocess"][kname]
            .get(dtype, 0)})
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
    for needed in (GOLDEN, PRODUCTION_GOLDEN, TRAIN_GOLDEN, STAGE_GOLDEN,
                   CLI_GOLDEN, TOOLS_GOLDEN, OPTIONS_GOLDEN, DISTILLED_GOLDEN,
                   PREPROCESS_GOLDEN, ROOT / KERNEL_SOURCE):
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
                "bfloat16": phase_main_bf16_atlas()}
    launches["production"], production_warm_rays_per_second = \
        phase_main_production(dense_warm_rays_per_second)
    launches["options"] = phase_options_r5b(production_warm_rays_per_second)
    train_warm, train_peak = phase_train_r5b(args.profile)
    phase_stage_r5b()
    launches["train_loop"], loop_records = phase_train_loop_r5b()
    records.update(loop_records)
    launches["cli"], cli_records = phase_cli_r5b()
    records.update(cli_records)
    launches["tools"] = phase_tools_r5b()
    launches["ddp"] = phase_ddp_r5b()
    launches["distilled"] = phase_distilled_r5b(
        train_warm, train_peak, production_warm_rays_per_second)
    launches["preprocess"] = phase_preprocess_scannet()
    if args.profile:
        phase_profile()
    emit(kernel_line(records, launches))
    emit({"ok": True, "device": {"platform": "gpu", "kind": name,
                                 "count": torch.cuda.device_count()}})
    return 0


if __name__ == "__main__":
    sys.exit(main())
