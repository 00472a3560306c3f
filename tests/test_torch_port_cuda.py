"""The brick-atlas CUDA kernel against its plain PyTorch versions, and the
card's paths against the CPU's or one process's, on a card.

These tests need a CUDA card and skip without one (the kernel has no CPU
mode). The file imports no JAX, so it runs on a GPU host that has none:

    python -m pytest --noconftest tests/test_torch_port_cuda.py -q -m cuda
"""
import numpy as np
import pytest
import torch

from contrastive_lift_tpu_torch.ops import brick_interp as bi
from contrastive_lift_tpu_torch.ops import fused_grid as tfg


DTYPES = [torch.float32, torch.bfloat16]
# one sample; sizes around brick_interp's 1,024-sample block and
# sample_density_brick's 64-sample warp tile; and more samples than one pass
# of sample_density_brick's resident warps covers (about 200k on an H100), so
# each warp takes several tiles
SIZES = [1, 5, 511, 513, 4 * 512 + 3, 600_001]


def _name(dtype):
    return str(dtype).removeprefix("torch.")


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the brick_interp kernel has no CPU mode")
    return torch.device("cuda")


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", DTYPES)
def test_kernels_match_plain_versions_on_card(cuda_device, dtype):
    grid_dim = (131, 131, 121)
    gen = torch.Generator(device=cuda_device).manual_seed(0)
    atlas = tfg.build_brick_atlas(torch.randn(grid_dim, generator=gen,
                                              device=cuda_device), dtype)
    xyz = torch.rand((100_000, 3), generator=gen, device=cuda_device) * 2.04 - 1.02
    n0 = bi.launch_total(bi.sample_density_brick)
    got = bi.sample_density_brick(atlas, xyz, grid_dim, -10.0)
    assert bi.launch_total(bi.sample_density_brick) == n0 + 1
    want = bi.sample_density_brick_reference(atlas, xyz, grid_dim, -10.0)
    torch.testing.assert_close(got, want, rtol=0, atol=1e-5)
    row, frac = bi.brick_coords(grid_dim, xyz)
    rows = atlas[row].contiguous()
    torch.testing.assert_close(bi.brick_interp(rows, frac.contiguous()),
                               bi.brick_interp_reference(rows, frac),
                               rtol=0, atol=1e-5)


@pytest.mark.cuda
def test_kernel_wrappers_reject_what_the_kernel_does_not_take(cuda_device):
    grid_dim = (14, 14, 14)
    atlas = tfg.build_brick_atlas(torch.randn(grid_dim, device=cuda_device))
    xyz = torch.zeros((8, 3), device=cuda_device)
    with pytest.raises(TypeError, match="float16"):
        bi.sample_density_brick(atlas.half(), xyz, grid_dim, 0.0)
    with pytest.raises(TypeError, match="float16"):
        bi.brick_interp(atlas[:8].half(), xyz)
    with pytest.raises(TypeError, match="bfloat16"):
        bi.brick_interp(atlas[:8], xyz.bfloat16())
    with pytest.raises(ValueError, match="rows"):
        bi.sample_density_brick(atlas[:-1].contiguous(), xyz, grid_dim, 0.0)
    with pytest.raises(ValueError, match="contiguous"):
        bi.brick_interp(atlas[:8], xyz.t().contiguous().t())
    # rows are read in aligned 16-B chunks (the literal form's corner pairs,
    # the rows the fused form stages whole): a view 4 B into a buffer is
    # refused by both
    buf = torch.zeros(8 * 128 + 1, device=cuda_device)
    with pytest.raises(ValueError, match="aligned"):
        bi.brick_interp(buf[1:].view(8, 128), xyz)
    buf = torch.zeros(atlas.numel() + 1, device=cuda_device)
    with pytest.raises(ValueError, match="aligned"):
        bi.sample_density_brick(buf[1:].view(atlas.shape), xyz, grid_dim, 0.0)


def _frac_all_cells(n, gen, device):
    """In-brick positions that visit all 64 lower corners (a0,b0,c0), so the
    first lane of every corner pair sits at every offset in its 16-B chunk,
    and a share of positions outside [0,4]^3 (clamped hat weights)."""
    cell = torch.arange(n, device=device) % 64
    lo = torch.stack([cell // 16, (cell // 4) % 4, cell % 4], 1).float()
    frac = lo + torch.rand((n, 3), generator=gen, device=device)
    out = torch.rand(n, generator=gen, device=device) < 0.1
    frac[out] = torch.rand((int(out.sum()), 3), generator=gen,
                           device=device) * 4.6 - 0.3
    return frac.contiguous()


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("n", SIZES)
def test_brick_interp_stress_on_card(cuda_device, dtype, n):
    """Literal form, kernel against plain: 1e-5 absolute in f32; in bf16 the
    same bar, since both sum in f32 the same widened values."""
    gen = torch.Generator(device=cuda_device).manual_seed(n)
    rows = torch.randn((n, 128), generator=gen, device=cuda_device).to(dtype)
    rows[:, 125:] = 0
    frac = _frac_all_cells(n, gen, cuda_device)
    n0 = bi.brick_interp.dtype_launches.get(_name(dtype), 0)
    got = bi.brick_interp(rows, frac)
    torch.cuda.synchronize()
    assert bi.brick_interp.dtype_launches[_name(dtype)] == n0 + 1
    torch.testing.assert_close(got, bi.brick_interp_reference(rows, frac),
                               rtol=0, atol=1e-5)
    # frac 4 B past a 16-B boundary: staged by scalar loads
    buf = torch.empty(3 * n + 1, device=cuda_device)
    buf[1:] = frac.view(-1)
    torch.testing.assert_close(bi.brick_interp(rows, buf[1:].view(n, 3)), got,
                               rtol=0, atol=0)


def _xyz_cases(grid_dim, n, gen, device):
    """Sample sets that drive each branch of the fused kernel's row sharing:
    every warp on one row; no two lanes of a warp on one row; groups of 1-12
    lanes; all 64 corner cells of a brick (every lane alignment); uniform
    points with out-of-box ones."""
    g = torch.tensor(grid_dim, dtype=torch.float32, device=device)

    def to_xyz(p):   # voxel position -> normalized coordinate
        return (p / (g - 1.0) * 2.0 - 1.0).contiguous()

    brick = torch.tensor([1, 2, 1], dtype=torch.float32, device=device)
    one_row = to_xyz(4.0 * brick + torch.rand((n, 3), generator=gen,
                                              device=device) * 3.99)
    nb = [-(-(d - 1) // 4) for d in grid_dim]
    i = torch.arange(n, device=device)
    bricks = torch.stack([i % nb[0], (i // nb[0]) % nb[1],
                          (i // (nb[0] * nb[1])) % nb[2]], 1).float()
    distinct = to_xyz(torch.minimum(4.0 * bricks + 0.5 + torch.rand(
        (n, 3), generator=gen, device=device) * 3.0, g - 1.0))
    group = torch.randint(1, 13, (n,), generator=gen, device=device)
    gid = torch.repeat_interleave(torch.arange(n, device=device), group)[:n]
    gbrick = torch.stack([gid % nb[0], (gid * 7 // nb[0]) % nb[1],
                          (gid * 3) % nb[2]], 1).float()
    grouped = to_xyz(torch.minimum(4.0 * gbrick + torch.rand(
        (n, 3), generator=gen, device=device) * 4.0, g - 1.0))
    cell = i % 64
    lo = torch.stack([cell // 16, (cell // 4) % 4, cell % 4], 1).float()
    cells = to_xyz(4.0 * brick + lo + 0.25 + 0.5 * torch.rand(
        (n, 3), generator=gen, device=device))
    uniform = torch.rand((n, 3), generator=gen, device=device) * 2.04 - 1.02
    return {"one_row": one_row, "distinct_rows": distinct, "groups": grouped,
            "all_cells": cells, "uniform": uniform}


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("n", SIZES)
def test_sample_density_brick_stress_on_card(cuda_device, dtype, n):
    """Fused form, kernel against plain on every sample set of _xyz_cases:
    1e-5 absolute (f32 sums of the same widened values in either type)."""
    grid_dim = (29, 23, 17)
    gen = torch.Generator(device=cuda_device).manual_seed(n)
    atlas = tfg.build_brick_atlas(torch.randn(grid_dim, generator=gen,
                                              device=cuda_device), dtype)
    for name, xyz in _xyz_cases(grid_dim, n, gen, cuda_device).items():
        got = bi.sample_density_brick(atlas, xyz, grid_dim, -3.0)
        want = bi.sample_density_brick_reference(atlas, xyz, grid_dim, -3.0)
        torch.cuda.synchronize()
        torch.testing.assert_close(got, want, rtol=0, atol=1e-5,
                                   msg=lambda m: f"{name}: {m}")
        buf = torch.empty(3 * n + 1, device=cuda_device)
        buf[1:] = xyz.view(-1)
        torch.testing.assert_close(
            bi.sample_density_brick(atlas, buf[1:].view(n, 3), grid_dim, -3.0),
            got, rtol=0, atol=0, msg=lambda m: f"{name}, unaligned xyz: {m}")


def _span_cases(grid_dim, n_rays, K, T, gen, device):
    """[n_rays, K, T, 3] spans of T consecutive samples on random lines
    through the box (out-of-box samples included), at steps of a quarter
    voxel (every span fits in 4 rows), 1.5 voxels (spans cross up to 9
    bricks: the clamp), and 0.01 voxel (most spans stay in one brick: the
    runs past the first are empty)."""
    g = torch.tensor(grid_dim, dtype=torch.float32, device=device)
    out = {}
    for name, step in (("quarter_voxel", 0.25), ("clamped", 1.5),
                       ("one_brick", 0.01)):
        o = torch.rand((n_rays, K, 1, 3), generator=gen, device=device) \
            * (g + 1.0) - 1.0
        d = torch.randn((n_rays, K, 1, 3), generator=gen, device=device)
        d = d / d.norm(dim=-1, keepdim=True)
        t = torch.arange(T, device=device, dtype=torch.float32)[:, None]
        p = o + d * t * step
        out[name] = (p / (g - 1.0) * 2.0 - 1.0).contiguous()
    return out


def _max_runs(grid_dim, xyz):
    """Most bricks any span of [R,K,T,3] visits."""
    row, _ = bi.brick_coords(grid_dim, xyz.reshape(-1, 3))
    row = row.reshape(xyz.shape[:3])
    return 1 + int((row[..., 1:] != row[..., :-1]).sum(-1).max())


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("T,W", [(8, 4), (8, 2), (16, 4), (32, 16), (1, 2),
                                 (5, 3)])
def test_span_form_matches_plain_version_on_card(cuda_device, dtype, T, W):
    """Span form, kernel against plain on spans that fit their rows, spans
    the kernel must clamp as the JAX function does, and spans whose later
    runs are empty, with span counts that leave a warp's last group short:
    1e-5 absolute (float32 sums of the same widened values in another
    order). Where every span fits, the kernel equals the fused form's kernel
    bit for bit; every call counts one launch of its row type."""
    grid_dim = (29, 23, 17)
    gen = torch.Generator(device=cuda_device).manual_seed(T * 31 + W)
    atlas = tfg.build_brick_atlas(torch.randn(grid_dim, generator=gen,
                                              device=cuda_device), dtype)
    for name, xyz in _span_cases(grid_dim, 257, 3, T, gen,
                                 cuda_device).items():
        n0 = bi.sample_density_brick_span.dtype_launches.get(_name(dtype), 0)
        got = bi.sample_density_brick_span(atlas, xyz, grid_dim, -3.0, W)
        torch.cuda.synchronize()
        assert (bi.sample_density_brick_span.dtype_launches[_name(dtype)]
                == n0 + 1)
        want = bi.sample_density_brick_span_reference(atlas, xyz, grid_dim,
                                                      -3.0, W)
        torch.testing.assert_close(got, want, rtol=0, atol=1e-5,
                                   msg=lambda m: f"{name}: {m}")
        if _max_runs(grid_dim, xyz) <= W:
            fused = bi.sample_density_brick(atlas, xyz.view(-1, 3), grid_dim,
                                            -3.0).view(got.shape)
            assert torch.equal(got, fused), name
        elif name == "clamped":
            assert _max_runs(grid_dim, xyz) > W


@pytest.mark.cuda
def test_span_wrapper_rejects_what_the_kernel_does_not_take(cuda_device):
    grid_dim = (14, 14, 14)
    atlas = tfg.build_brick_atlas(torch.randn(grid_dim, device=cuda_device))
    xyz = torch.zeros((4, 2, 8, 3), device=cuda_device)
    with pytest.raises(ValueError, match="rows a span"):
        bi.sample_density_brick_span(atlas, xyz, grid_dim, 0.0, 17)
    with pytest.raises(ValueError, match="samples"):
        bi.sample_density_brick_span(
            atlas, torch.zeros((4, 2, 33, 3), device=cuda_device), grid_dim,
            0.0, 4)
    with pytest.raises(ValueError, match="R, K, T, 3"):
        bi.sample_density_brick_span(atlas, xyz.view(-1, 3), grid_dim, 0.0, 4)
    with pytest.raises(ValueError, match="contiguous"):
        bi.sample_density_brick_span(atlas, xyz.transpose(1, 2), grid_dim,
                                     0.0, 4)
    with pytest.raises(TypeError, match="float16"):
        bi.sample_density_brick_span(atlas.half(), xyz, grid_dim, 0.0, 4)


def _field(rng, grid=14, classes=2, inst=3):
    """A random grid-14 parameter tree of the r5b layout (xyz-MLP semantic
    and slow-fast instance heads), made with numpy."""
    def mlp(dims):
        return {"layers": [{"w": rng.uniform(-1, 1, (a, b)) / np.sqrt(a),
                            "b": rng.uniform(-0.1, 0.1, b)}
                           for a, b in zip(dims[:-1], dims[1:])]}

    def vm(comps, scale):
        return {"planes": tuple(scale[0] * rng.standard_normal((comps, grid, grid))
                                for _ in range(3)),
                "lines": tuple(scale[1] * rng.standard_normal((comps, grid))
                               for _ in range(3))}

    density = vm(16, (1.0, 0.3))
    density["planes"][0][0], density["lines"][0][0] = 3.0, 3.0
    tree = {"density": density, "appearance": vm(48, (0.1, 0.1)),
            "appearance_basis": {"w": rng.standard_normal((144, 27)) / 12},
            "appearance_mlp": mlp([150, 128, 128, 3]),
            "semantic_mlp": mlp([3, 256, 256, 256, 256, classes]),
            "instance_mlp": {"fast": mlp([3, 256, 256, 256, inst]),
                             "slow": mlp([3, 256, 256, 256, inst])}}
    return _float32(tree)


def _float32(tree):
    if isinstance(tree, dict):
        return {k: _float32(v) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return type(tree)(_float32(v) for v in tree)
    return np.asarray(tree, np.float32)


@pytest.mark.cuda
def test_dense_render_on_card_matches_cpu(cuda_device):
    """render_frames on the card (through the kernel) == on the CPU (plain
    version), fp32 with TF32 off: maps within 1e-4."""
    from contrastive_lift_tpu_torch.data.base import FrameData
    from contrastive_lift_tpu_torch.inference.fidelity import dense_config, e2e_config
    from contrastive_lift_tpu_torch.factory import make_model_config, make_render_config
    from contrastive_lift_tpu_torch.inference.render import render_frames
    from contrastive_lift_tpu_torch.io.convert import params_from_numpy
    from contrastive_lift_tpu_torch.renderer.render import make_render_state

    torch.backends.cuda.matmul.allow_tf32 = False
    rng = np.random.default_rng(0)
    tree = _field(rng)
    bbox = np.array([[-1.0] * 3, [1.0] * 3], np.float32)
    cfg = e2e_config((16, 24))
    mcfg = make_model_config(cfg, 2)
    rcfg = dense_config(make_render_config(cfg, bbox, (14,) * 3, mcfg, 0.25))
    o = rng.uniform(-0.3, 0.3, (500, 3)) + [0.0, 0.0, -2.0]
    d = rng.normal(size=(500, 3))
    d[:, 2] = np.abs(d[:, 2]) + 1.0
    d /= np.linalg.norm(d, axis=-1, keepdims=True)
    rays = np.concatenate([o, d, np.full((500, 1), 0.05),
                           np.full((500, 1), 5.0)], -1).astype(np.float32)
    frames = [FrameData("0", rays, *([None] * 6))]
    maps = {}
    for dev in ("cpu", cuda_device):
        n0 = bi.launch_total(bi.sample_density_brick)
        maps[str(dev)] = render_frames(
            params_from_numpy(tree, dev), mcfg, rcfg,
            make_render_state(bbox, (14,) * 3, 0.25, device=dev), frames,
            chunk=128, device=dev)[0]
        launched = bi.launch_total(bi.sample_density_brick) - n0
        assert launched == (4 if dev == cuda_device else 0)
    for key, want in maps["cpu"].items():
        np.testing.assert_allclose(maps[str(cuda_device)][key], want,
                                   atol=1e-4, rtol=0, err_msg=key)
    assert np.mean(np.abs(maps["cpu"]["instances"]).sum(-1) > 0) > 0.2


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", DTYPES)
def test_fused_kernel_on_production_chunk_on_card(cuda_device, dtype):
    """Fused form, kernel against plain on the production render's own
    samples (pass A of the first 4,096-ray chunk of r5b val frame 0, out-of-box
    samples included): within 1e-5 times max(1, sum of |row x weight|), the
    bar chip_smoke.py holds the render chunk to (r5b's densities reach ~100,
    where one float32 step is 7.6e-6)."""
    from contrastive_lift_tpu_torch.inference.fidelity import (
        PRODUCTION_CHUNK, R5B_CKPT, R5B_SCENE, e2e_scene, production_chunk)

    dense, shift, xyz = production_chunk(R5B_CKPT, e2e_scene(*R5B_SCENE),
                                         device=cuda_device)
    assert xyz.shape[0] % (PRODUCTION_CHUNK * 8) == 0
    atlas = tfg.build_brick_atlas(dense, dtype)
    grid_dim = tuple(dense.shape)
    n0 = bi.sample_density_brick.dtype_launches.get(_name(dtype), 0)
    got = bi.sample_density_brick(atlas, xyz, grid_dim, shift)
    torch.cuda.synchronize()
    assert bi.sample_density_brick.dtype_launches[_name(dtype)] == n0 + 1
    want = bi.sample_density_brick_reference(atlas, xyz, grid_dim, shift)
    magnitude = bi.sample_density_brick_reference(atlas.abs(), xyz, grid_dim,
                                                  0.0)
    err = (got - want).abs() / torch.clamp(magnitude, min=1.0)
    assert float(err.max()) <= 1e-5


@pytest.mark.cuda
@pytest.mark.parametrize("term_first", [0, 4])
def test_production_render_on_card_matches_cpu(cuda_device, term_first):
    """render_frames on the production path (empty-space skipping, L2-only
    selection, top-8 heads with tail completion; fp32 heads, TF32 off) on the
    card == on the CPU, at fixed budgets: in one pass, or in two with every
    ray surviving pass A (the survivors of a smaller fraction are the rays of
    largest residual, whose order the last bit of a float can change between
    devices). Every pass launches the kernel on the card; maps within 1e-4."""
    import dataclasses

    from contrastive_lift_tpu_torch.data.base import FrameData
    from contrastive_lift_tpu_torch.factory import make_model_config, make_render_config
    from contrastive_lift_tpu_torch.inference.fidelity import e2e_config
    from contrastive_lift_tpu_torch.inference.render import render_frames_report
    from contrastive_lift_tpu_torch.io.convert import params_from_numpy
    from contrastive_lift_tpu_torch.renderer.render import make_render_state

    torch.backends.cuda.matmul.allow_tf32 = False
    rng = np.random.default_rng(1)
    tree = _field(rng)
    bbox = np.array([[-1.0] * 3, [1.0] * 3], np.float32)
    cfg = e2e_config((16, 24))
    mcfg = make_model_config(cfg, 2)
    rcfg = dataclasses.replace(
        make_render_config(cfg, bbox, (14,) * 3, mcfg, 0.25), head_topk=8,
        max_subsegments=8, term_first=term_first, term_fraction=1.0)
    o = rng.uniform(-0.3, 0.3, (500, 3)) + [0.0, 0.0, -2.0]
    d = rng.normal(size=(500, 3))
    d[:, 2] = np.abs(d[:, 2]) + 1.0
    d /= np.linalg.norm(d, axis=-1, keepdims=True)
    rays = np.concatenate([o, d, np.full((500, 1), 0.05),
                           np.full((500, 1), 5.0)], -1).astype(np.float32)
    frames = [FrameData("0", rays, *([None] * 6))]
    reports = {}
    for dev in ("cpu", cuda_device):
        n0 = bi.launch_total(bi.sample_density_brick)
        reports[str(dev)] = render_frames_report(
            params_from_numpy(tree, dev), mcfg, rcfg,
            make_render_state(bbox, (14,) * 3, 0.25, device=dev), frames,
            chunk=128, auto_budget=False, device=dev)
        launched = bi.launch_total(bi.sample_density_brick) - n0
        passes = 2 if term_first else 1
        assert launched == (passes * 4 if dev == cuda_device else 0)
    cpu, card = reports["cpu"], reports[str(cuda_device)]
    assert dataclasses.asdict(card.rcfg) == dataclasses.asdict(cpu.rcfg)
    assert not card.rcfg.use_l1 and card.rcfg.head_tail_complete
    for key, want in cpu.maps[0].items():
        np.testing.assert_allclose(card.maps[0][key], want, atol=1e-4, rtol=0,
                                   err_msg=key)
    assert np.mean(np.abs(cpu.maps[0]["instances"]).sum(-1) > 0) > 0.2


def _train_world(device, **cfg_kw):
    """A grid-24 slow-fast field (the port's own init, seed 0) with an opaque
    slab, on the synthetic sphere scene, and its first batches and draws;
    ``cfg_kw`` changes the config (with distilled heads the scene gets
    ``fidelity.distilled_targets`` and the main batch its ``feats``)."""
    from contrastive_lift_tpu_torch.config import Config
    from contrastive_lift_tpu_torch.data.base import (InstanceBundleSampler,
                                                      RayPoolSampler,
                                                      SegmentBundleSampler)
    from contrastive_lift_tpu_torch.data.synthetic import make_synthetic_scene
    from contrastive_lift_tpu_torch.factory import build_model, class_weights_for
    from contrastive_lift_tpu_torch.train.step import draw_step

    from contrastive_lift_tpu_torch.inference.fidelity import distilled_targets

    scene = distilled_targets(make_synthetic_scene(
        num_spheres=4, num_train=6, num_val=2, image_dim=(24, 32), seed=0))
    cfg = Config(batch_size=256, chunk=256, min_grid_dim=24, max_grid_dim=32,
                 max_instances=3, instance_loss_mode="slow_fast",
                 use_DINO_style=True, max_rays_instances=128,
                 max_labels_per_image=16, batch_size_segments=4,
                 max_rays_segments=64, chunk_segment=128, seed=0, lr=2e-3,
                 weight_class_0=1.0, late_semantic_optimization=0,
                 instance_optimization_epoch=3,
                 segment_optimization_epoch=6, **cfg_kw).resolve_epochs()
    mcfg, params, rcfg, state_r = build_model(
        cfg, scene.num_semantic_classes, scene.scene_bounds, (24, 24, 24),
        device="cpu")
    y, x = torch.meshgrid(torch.arange(24), torch.arange(24), indexing="ij")
    planes = [p * 2 for p in params["density"]["planes"]]
    lines = [line.clone() for line in params["density"]["lines"]]
    planes[0][0] = (((y - 11.5) ** 2 + (x - 11.0) ** 2) < 16).float()
    lines[0][0] = torch.where((torch.arange(24) >= 11)
                              & (torch.arange(24) <= 13), 30.0, 0.0)
    planes[0][1], lines[0][1] = 1.0, -8.0
    params["density"] = {"planes": tuple(planes), "lines": tuple(lines)}
    rng = np.random.default_rng(1)
    frames = scene.train_frames
    batches = (RayPoolSampler(frames, 2,
                              load_feats=mcfg.use_distilled).sample(rng, 256),
               InstanceBundleSampler(frames, 128, 16).sample(rng, 1),
               SegmentBundleSampler(frames, 64).sample(rng, 4))
    draws = draw_step(torch.Generator().manual_seed(3), cfg, 256, 256,
                      (1, 128))
    return (cfg, mcfg, rcfg, state_r, params,
            class_weights_for(cfg, scene.segmentation, device="cpu"),
            batches, draws)


def _to(tree, device):
    from contrastive_lift_tpu_torch.utils.tree import tree_map
    return tree_map(lambda t: t.to(device), tree)


def _cos(a, b):
    a, b = a.double().flatten().cpu(), b.double().flatten().cpu()
    if not a.any() and not b.any():
        return 1.0
    return float(a @ b / (a.norm() * b.norm()))


@pytest.mark.cuda
def test_train_step_on_card_matches_cpu(cuda_device):
    """One step of every phase on the card and on the CPU from the same
    parameters, batches and draws (TF32 off): metrics within rtol 2e-3, the
    main-phase and instance-phase gradients with a cosine above 0.999 per
    leaf."""
    from contrastive_lift_tpu_torch.renderer import render as R
    from contrastive_lift_tpu_torch.train.state import init_train_state
    from contrastive_lift_tpu_torch.train.step import (StepDraws, TrainGates,
                                                       make_train_step)

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    cfg, mcfg, rcfg, state_r, params, weights, batches, draws = \
        _train_world("cpu")
    gates = TrainGates(semantics_on=True, instances_on=True, segments_on=True)
    out = {}
    for dev in ("cpu", cuda_device):
        p = _to(params, dev)
        sr = R.RenderState(*(t.to(dev) for t in state_r))
        d = StepDraws(R.RayDraws(*(t.to(dev) for t in draws.main)),
                      draws.seg_jitter.to(dev), draws.inst_jitter.to(dev))
        step = make_train_step(cfg, mcfg, rcfg, gates, weights.to(dev), p,
                               aux_head_topk=32, keep_grads=True)
        _, metrics = step(init_train_state(cfg, p), sr, *batches, d, 0.5,
                          0.001)
        out[str(dev)] = ({k: float(v) for k, v in metrics.items()},
                         step.grads)
    (m_cpu, g_cpu), (m_gpu, g_gpu) = out["cpu"], out[str(cuda_device)]
    for name, v in m_cpu.items():
        assert abs(m_gpu[name] - v) <= 2e-3 * abs(v) + 1e-6, name
    for phase in ("main", "inst"):
        assert g_cpu[phase]
        for path, g in g_cpu[phase].items():
            assert _cos(g_gpu[phase][path], g) > 0.999, (phase, path)


DISTILLED_KW = dict(use_distilled_features_semantic=True,
                    use_distilled_features_instance=True)


@pytest.mark.cuda
def test_distilled_train_step_on_card_matches_cpu(cuda_device):
    """One distilled step of every phase (feature gate open, features not
    detached) on the card and on the CPU from the same parameters, batches
    and draws (TF32 off): metrics within rtol 2e-3 with loss_feat non-zero,
    every gradient with a cosine above 0.999 per leaf, the feature branch's
    among them."""
    from contrastive_lift_tpu_torch.renderer import render as R
    from contrastive_lift_tpu_torch.train.state import init_train_state
    from contrastive_lift_tpu_torch.train.step import (StepDraws, TrainGates,
                                                       make_train_step)

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    cfg, mcfg, rcfg, state_r, params, weights, batches, draws = \
        _train_world("cpu", **DISTILLED_KW)
    assert mcfg.use_distilled and "feats" in batches[0]
    gates = TrainGates(True, True, True, features_on=True)
    out = {}
    for dev in ("cpu", cuda_device):
        p = _to(params, dev)
        sr = R.RenderState(*(t.to(dev) for t in state_r))
        d = StepDraws(R.RayDraws(*(t.to(dev) for t in draws.main)),
                      draws.seg_jitter.to(dev), draws.inst_jitter.to(dev))
        step = make_train_step(cfg, mcfg, rcfg, gates, weights.to(dev), p,
                               aux_head_topk=32, keep_grads=True)
        _, metrics = step(init_train_state(cfg, p), sr, *batches, d, 0.5,
                          0.001)
        out[str(dev)] = ({k: float(v) for k, v in metrics.items()},
                         step.grads)
    (m_cpu, g_cpu), (m_gpu, g_gpu) = out["cpu"], out[str(cuda_device)]
    assert m_cpu["loss_feat"] > 0
    for name, v in m_cpu.items():
        assert abs(m_gpu[name] - v) <= 2e-3 * abs(v) + 1e-6, name
    assert any(path[0] == "feature" and g.any()
               for path, g in g_cpu["main"].items())
    for phase in ("main", "inst"):
        for path, g in g_cpu[phase].items():
            assert _cos(g_gpu[phase][path], g) > 0.999, (phase, path)


@pytest.mark.cuda
def test_distilled_production_render_on_card_matches_cpu(cuda_device):
    """A grid-14 field with fidelity.graft_distilled's heads rendered on the
    production path (fixed budgets, top-8 fp32 heads in two phases with
    every ray surviving pass A, TF32 off) on the card == on the CPU: maps
    and the distilled map within 1e-4; the kernel launches on the card."""
    import dataclasses

    from contrastive_lift_tpu_torch.factory import make_model_config, make_render_config
    from contrastive_lift_tpu_torch.inference.fidelity import (
        distilled_render_config, graft_distilled)
    from contrastive_lift_tpu_torch.inference.render import prepare_render
    from contrastive_lift_tpu_torch.io.convert import params_from_numpy
    from contrastive_lift_tpu_torch.renderer import render as R

    torch.backends.cuda.matmul.allow_tf32 = False
    rng = np.random.default_rng(2)
    tree = graft_distilled(_field(rng), 0)
    bbox = np.array([[-1.0] * 3, [1.0] * 3], np.float32)
    cfg = distilled_render_config((16, 24))
    mcfg = make_model_config(cfg, 2)
    assert mcfg.use_distilled
    rcfg = dataclasses.replace(
        make_render_config(cfg, bbox, (14,) * 3, mcfg, 0.25), head_topk=8,
        max_subsegments=8, term_first=4, term_fraction=1.0,
        head_term_first=4, head_term_fraction=1.0)
    o = rng.uniform(-0.3, 0.3, (500, 3)) + [0.0, 0.0, -2.0]
    d = rng.normal(size=(500, 3))
    d[:, 2] = np.abs(d[:, 2]) + 1.0
    d /= np.linalg.norm(d, axis=-1, keepdims=True)
    rays = np.concatenate([o, d, np.full((500, 1), 0.05),
                           np.full((500, 1), 5.0)], -1).astype(np.float32)
    outs = {}
    for dev in ("cpu", cuda_device):
        params = params_from_numpy(tree, dev)
        state = R.make_render_state(bbox, (14,) * 3, 0.25, device=dev)
        n0 = bi.launch_total(bi.sample_density_brick)
        with torch.no_grad():
            rc, fused = prepare_render(params, mcfg, rcfg, state, [],
                                       auto_budget=False)
            outs[str(dev)] = R.render_rays(
                params, mcfg, rc, state, torch.from_numpy(rays).to(dev),
                fused=fused)
        assert (bi.launch_total(bi.sample_density_brick) - n0 > 0) == (
            dev == cuda_device)
    cpu, card = outs["cpu"], outs[str(cuda_device)]
    for key in ("rgb", "semantics", "instances", "depth", "distilled"):
        np.testing.assert_allclose(card[key].cpu().numpy(),
                                   cpu[key].numpy(), atol=1e-4, rtol=0,
                                   err_msg=key)
    assert np.mean(np.abs(cpu["distilled"].numpy()).sum(-1) > 0) > 0.2


@pytest.mark.cuda
def test_direct_sampling_render_on_card_matches_cpu(cuda_device):
    """render_rays(fused=None), the VM factors sampled directly, on the
    card against the CPU: fp32 maps within 1e-4."""
    from contrastive_lift_tpu_torch.renderer import render as R

    torch.backends.cuda.matmul.allow_tf32 = False
    _, mcfg, rcfg, state_r, params, _, batches, _ = _train_world("cpu")
    rays = torch.from_numpy(batches[0]["rays"])
    want = R.render_rays(params, mcfg, rcfg, state_r, rays)
    got = R.render_rays(_to(params, cuda_device), mcfg, rcfg,
                        R.RenderState(*(t.to(cuda_device) for t in state_r)),
                        rays.to(cuda_device))
    for key in ("rgb", "semantics", "instances", "depth"):
        torch.testing.assert_close(got[key].cpu(), want[key], rtol=1e-4,
                                   atol=1e-4)


@pytest.mark.cuda
def test_shrink_and_upsample_on_card_match_cpu(cuda_device):
    """update_bbox_and_shrink of the slab field on the card: grid_dim, AABB
    and the cropped params equal the CPU's; upsample_volume_grid of the
    crop within 1e-6 of the CPU's."""
    from contrastive_lift_tpu_torch.models import tensorf as tf
    from contrastive_lift_tpu_torch.renderer import occupancy as occ
    from contrastive_lift_tpu_torch.renderer import render as R
    from contrastive_lift_tpu_torch.utils.tree import tree_leaves_with_path

    _, mcfg, _, state_r, params, _, _, _ = _train_world("cpu")
    out = {}
    for dev in ("cpu", cuda_device):
        sr = R.RenderState(*(t.to(dev) for t in state_r))
        p, s, g = occ.update_bbox_and_shrink(_to(params, dev), mcfg, sr,
                                             (24, 24, 24))
        up = tf.upsample_volume_grid(p, occ.get_target_resolution(s, 30_000))
        out[str(dev)] = (p, s, g, up)
    (p0, s0, g0, u0), (p1, s1, g1, u1) = out["cpu"], out[str(cuda_device)]
    assert g1 == g0 != (24, 24, 24)
    torch.testing.assert_close(s1.bbox_aabb.cpu(), s0.bbox_aabb, rtol=0,
                               atol=0)
    for (path, a), (_, b) in zip(tree_leaves_with_path(p1),
                                 tree_leaves_with_path(p0)):
        torch.testing.assert_close(a.cpu(), b, rtol=0, atol=0,
                                   msg=lambda m: f"{path}: {m}")
    for (path, a), (_, b) in zip(tree_leaves_with_path(u1),
                                 tree_leaves_with_path(u0)):
        torch.testing.assert_close(a.cpu(), b, rtol=0, atol=1e-6,
                                   msg=lambda m: f"{path}: {m}")


@pytest.mark.cuda
def test_trainer_fit_on_card_matches_cpu(cuda_device, tmp_path):
    """Trainer.fit for two epochs at grid 24 on the card and on the CPU from
    the slab field with the same draws at every step (TF32 off): the shrink,
    the upscale and the instance and segment phases at epoch 1; every step's
    metrics within rtol 2e-3, each stage's grid_dim, AABB and head budget
    equal, the validation psnr within the mse's rtol 2e-3."""
    import json

    from contrastive_lift_tpu_torch.config import Config
    from contrastive_lift_tpu_torch.data.synthetic import make_synthetic_scene
    from contrastive_lift_tpu_torch.train.loop import Trainer
    from contrastive_lift_tpu_torch.train.step import draw_step

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    base, _, _, _, params, _, _, _ = _train_world("cpu")
    scene = make_synthetic_scene(num_spheres=4, num_train=2, num_val=1,
                                 image_dim=(16, 24), seed=0)
    runs = {}
    for dev in ("cpu", cuda_device):
        cfg = Config(**{**base.to_dict(), "max_epoch": 2, "chunk": 384,
                        "bbox_aabb_reset_epochs": [1],
                        "grid_upscale_epochs": [1], "max_grid_dim": 24,
                        "instance_optimization_epoch": 1,
                        "segment_optimization_epoch": 1, "sanity_steps": 1})

        def draws(step, cfg=cfg):
            return draw_step(torch.Generator().manual_seed(step), cfg,
                             cfg.batch_size,
                             cfg.batch_size_segments * cfg.max_rays_segments,
                             (cfg.batch_size_contrastive,
                              cfg.max_rays_instances))

        run = tmp_path / str(dev).replace(":", "")
        tr = Trainer(cfg, scene, run, log_every=1, device=dev, params=params,
                     draws=draws)
        tr.fit()
        records = [json.loads(line) for line in
                   (run / "metrics.jsonl").read_text().splitlines()]
        runs[str(dev)] = (tr.stages, records)
    (st0, rec0), (st1, rec1) = runs["cpu"], runs[str(cuda_device)]
    assert len(st1) == len(st0) == 3 and st0[2]["grid_dim"] != (24, 24, 24)
    for s1, s0 in zip(st1, st0):
        for key in ("epoch", "grid_dim", "bbox_aabb", "aux_k", "n_samples"):
            assert s1[key] == s0[key], key
    assert all(s["max_memory_allocated"] > 0 for s in st1[1:])
    steps0 = [r for r in rec0 if "lr_scale" in r]
    steps1 = [r for r in rec1 if "lr_scale" in r]
    assert len(steps1) == len(steps0) == 6
    for r1, r0 in zip(steps1, steps0):
        assert set(r1) == set(r0)
        for k, v in r0.items():
            assert abs(r1[k] - v) <= 2e-3 * abs(v) + 1e-6, (r0["step"], k)
    vals0 = [r["val/psnr"] for r in rec0 if "val/psnr" in r]
    vals1 = [r["val/psnr"] for r in rec1 if "val/psnr" in r]
    assert len(vals1) == len(vals0) == 2
    for v1, v0 in zip(vals1, vals0):
        assert abs(v1 - v0) <= 10 * np.log10(1 + 2e-3)


@pytest.mark.cuda
@pytest.mark.parametrize("seed,min_cluster_size", [(0, 15), (1, 5), (2, 100)])
def test_hdbscan_on_card_matches_cpu(cuda_device, seed, min_cluster_size):
    """HDBSCAN's spanning tree built on the card gives the labels of the
    CPU run on the same seeded points (blobs, uniform noise and exact
    duplicates): equal."""
    from contrastive_lift_tpu_torch.inference.hdbscan import hdbscan_labels
    rng = np.random.default_rng(seed)
    centers = rng.uniform(0, 1, (4, 3))
    pts = np.concatenate(
        [c + rng.normal(0, 0.04, (rng.integers(50, 400), 3)) for c in centers]
        + [rng.uniform(0, 1, (100, 3))]).astype(np.float32)
    pts = np.concatenate([pts, pts[:30]])
    np.testing.assert_array_equal(
        hdbscan_labels(pts, min_cluster_size, device=cuda_device),
        hdbscan_labels(pts, min_cluster_size, device="cpu"))


EDITS = ["delete", "extract", "duplicate", "manipulate"]


def _rot_z(degrees):
    t = np.deg2rad(degrees)
    return np.array([[np.cos(t), -np.sin(t), 0.0], [np.sin(t), np.cos(t), 0.0],
                     [0.0, 0.0, 1.0]], np.float32)


@pytest.mark.cuda
@pytest.mark.parametrize("kind", EDITS)
def test_render_edited_on_card_matches_cpu(cuda_device, kind):
    """renderer/editing.py::render_edited of the slab field on the card
    against the CPU, TF32 off: maps within 1e-4, the semantics on rays of
    opacity 1e-4 and more (below, the softmax normalisation's 1e-8 competes
    with the weights); the box takes weight from some ray."""
    from contrastive_lift_tpu_torch.renderer import editing
    from contrastive_lift_tpu_torch.renderer import render as R

    torch.backends.cuda.matmul.allow_tf32 = False
    _, mcfg, rcfg, state_r, params, _, batches, _ = _train_world("cpu")
    rays = torch.from_numpy(batches[0]["rays"])
    box = {"extent": [0.6, 0.5, 0.3], "position": [0.05, -0.1, 0.0],
           "orientation": _rot_z(20.0)}
    move = ({"translation": [0.3, -0.1, 0.0], "rotation": _rot_z(30.0)}
            if kind in ("duplicate", "manipulate") else {})
    want = editing.render_edited(params, mcfg, rcfg, state_r, rays, kind, box,
                                 device="cpu", **move)
    n0 = bi.launch_total(bi.sample_density_brick)
    got = editing.render_edited(_to(params, cuda_device), mcfg, rcfg,
                                R.RenderState(*(t.to(cuda_device)
                                                for t in state_r)),
                                rays, kind, box, device=cuda_device, **move)
    assert bi.launch_total(bi.sample_density_brick) == n0  # VM factors only
    weight = editing.edited_weights(params, mcfg, rcfg, state_r, rays, kind,
                                    box, **move)[2]
    base = editing.edited_weights(params, mcfg, rcfg, state_r, rays, None,
                                  box)[2]
    assert (weight - base).abs().sum(-1).max() > 1e-3
    lit = weight.sum(-1) >= 1e-4
    for key in ("rgb", "semantics", "instances", "depth"):
        g, w = got[key].cpu(), want[key]
        if key == "semantics":
            g, w = g[lit], w[lit]
        torch.testing.assert_close(g, w, rtol=0, atol=1e-4, msg=key)


@pytest.mark.cuda
def test_instance_clusters_on_card_match_cpu(cuda_device):
    """renderer/occupancy.py::get_instance_clusters of the slab field on the
    card against the CPU: the same lattice points, labels equal on 99.9% of
    them (argmax of float32 heads summed in another order)."""
    from contrastive_lift_tpu_torch.renderer import occupancy as occ
    from contrastive_lift_tpu_torch.renderer import render as R

    torch.backends.cuda.matmul.allow_tf32 = False
    _, mcfg, _, state_r, params, _, _, _ = _train_world("cpu")
    want = occ.get_instance_clusters(params, mcfg, state_r, (24, 24, 24),
                                     "full", device="cpu")
    got = occ.get_instance_clusters(
        _to(params, cuda_device), mcfg,
        R.RenderState(*(t.to(cuda_device) for t in state_r)), (24, 24, 24),
        "full", device=cuda_device)
    np.testing.assert_allclose(got[0], want[0], rtol=0, atol=1e-6)
    assert (got[1] == want[1]).mean() >= 0.999


# ---------------------------------------------------------------------------
# data parallel on the card (parallel/)
# ---------------------------------------------------------------------------

def _term_bars(two, one):
    for case in one:
        for key, want in one[case]["metrics"].items():
            np.testing.assert_allclose(two[case]["metrics"][key], want,
                                       rtol=1e-5, atol=1e-7,
                                       err_msg=f"{case} {key}")
        for path, want in one[case]["grads"].items():
            np.testing.assert_allclose(two[case]["grads"][path], want,
                                       rtol=0, atol=1e-6,
                                       err_msg=f"{case} {path}")
        assert len(set(two[case]["param_digests"])) == 1


@pytest.mark.cuda
def test_sharded_steps_on_card_match_one_process(cuda_device, tmp_path):
    """Two gloo ranks sharing the card take each globally normalised term's
    step (``parallel/testing.py::term_steps``) as one process does."""
    from contrastive_lift_tpu_torch.parallel import launch
    from contrastive_lift_tpu_torch.parallel import testing as ptesting
    one = ptesting.term_steps("cuda")
    two = launch.spawn(ptesting.term_steps, 2, ("cuda", "gloo"), timeout=300,
                       store_dir=tmp_path)
    _term_bars(two, one)


@pytest.mark.cuda
def test_one_rank_nccl_step_matches_the_unsharded_step(cuda_device,
                                                       tmp_path):
    """A 1-rank NCCL group runs the sharded step code (all-reduces, global
    normalisers, TV after the reduction) as the unsharded step runs."""
    from contrastive_lift_tpu_torch.parallel import launch
    from contrastive_lift_tpu_torch.parallel import testing as ptesting
    one = ptesting.term_steps("cuda")
    nccl = launch.spawn(ptesting.term_steps, 1, ("cuda", "nccl"), timeout=300,
                        store_dir=tmp_path)
    _term_bars(nccl, one)


@pytest.mark.cuda
def test_sharded_render_on_card_equals_one_process(cuda_device, tmp_path):
    """Two gloo ranks sharing the card render whole chunks: the budgets and
    guardrails equal, the maps within 1e-6, of one process's render."""
    from contrastive_lift_tpu_torch.config import Config
    from contrastive_lift_tpu_torch.factory import build_model
    from contrastive_lift_tpu_torch.io.checkpoint import save_checkpoint
    from contrastive_lift_tpu_torch.parallel import dryrun, launch
    from contrastive_lift_tpu_torch.parallel import testing as ptesting
    kw = dict(instance_loss_mode="slow_fast", use_DINO_style=True,
              max_instances=3, use_mlp_for_semantics=True,
              use_mlp_for_instances=True, semantic_weight_mode="softmax",
              image_dim=(16, 24), seed=0)
    bbox = np.array([[-1, -1, -1], [1, 1, 1]], np.float32)
    _, params, _, _ = build_model(Config(**kw).resolve_epochs(), 2, bbox,
                                  (14, 14, 14), step_ratio=0.25, device="cpu")
    ckpt = str(tmp_path / "field.npz")
    save_checkpoint(ckpt, ptesting.slab_field(params), grid_dim=(14, 14, 14),
                    bbox_aabb=bbox, epoch=0, global_step=0)
    rng = np.random.default_rng(0)
    rays = []
    for n in (300, 200):
        o = rng.uniform(-0.3, 0.3, (n, 3)) + np.array([0.0, 0.0, -2.0])
        d = rng.normal(size=(n, 3))
        d[:, 2] = np.abs(d[:, 2]) + 1.0
        d /= np.linalg.norm(d, axis=-1, keepdims=True)
        rays.append(np.concatenate([o, d, np.full((n, 1), 0.05),
                                    np.full((n, 1), 5.0)], -1)
                    .astype(np.float32))
    args = (ckpt, kw, 2, rays, 128, "cuda")
    one = ptesting.render_sharded(*args)
    two = launch.spawn(ptesting.render_sharded, 2, args + (0.25, "gloo"),
                       timeout=300, store_dir=tmp_path)
    assert two["rcfg"] == one["rcfg"] and one["rcfg"]["term_first"] > 0
    assert (two["budget_tail"], two["head_tail"]) == (one["budget_tail"],
                                                      one["head_tail"])
    for a, b in zip(two["maps"], one["maps"]):
        for key in dryrun.MAP_KEYS:
            np.testing.assert_allclose(a[key], b[key], rtol=0, atol=1e-6,
                                       err_msg=key)


# each render option of fidelity.OPTIONS at fixed budgets (no calibration,
# which floats decide at its quantiles): render config changes, keywords
CARD_OPTIONS = {
    "l1": (dict(max_segments=4), dict(l2_only=False)),
    "no_term": (dict(max_subsegments_light=4, heavy_fraction=0.25), {}),
    "iter": (dict(head_select="iter"), {}),
    "rank": (dict(head_select="rank"), {}),
    "dedup": (dict(head_dedup_cells=6), {}),
    "span": (dict(fine_span_rows=4), {}),
    "baked": ({}, dict(bake_heads=True)),
}


@pytest.mark.cuda
@pytest.mark.parametrize("option", sorted(CARD_OPTIONS))
def test_option_render_on_card_matches_cpu(cuda_device, option):
    """render_frames with each render option at grid 14 (top-8 fp32 heads
    with tail completion, fixed budgets, TF32 off) on the card == on the
    CPU: maps within 1e-4 (3e-2 for the baked bf16 tables); every pass
    launches the fused kernel, or with span gathers the span form."""
    import dataclasses

    from contrastive_lift_tpu_torch.data.base import FrameData
    from contrastive_lift_tpu_torch.factory import make_model_config, make_render_config
    from contrastive_lift_tpu_torch.inference.fidelity import e2e_config
    from contrastive_lift_tpu_torch.inference.render import render_frames_report
    from contrastive_lift_tpu_torch.io.convert import params_from_numpy
    from contrastive_lift_tpu_torch.renderer.render import make_render_state

    torch.backends.cuda.matmul.allow_tf32 = False
    changes, kw = CARD_OPTIONS[option]
    rng = np.random.default_rng(2)
    tree = _field(rng)
    bbox = np.array([[-1.0] * 3, [1.0] * 3], np.float32)
    cfg = e2e_config((16, 24))
    mcfg = make_model_config(cfg, 2)
    rcfg = dataclasses.replace(
        make_render_config(cfg, bbox, (14,) * 3, mcfg, 0.25), head_topk=8,
        max_subsegments=8, term_first=0, **changes)
    o = rng.uniform(-0.3, 0.3, (500, 3)) + [0.0, 0.0, -2.0]
    d = rng.normal(size=(500, 3))
    d[:, 2] = np.abs(d[:, 2]) + 1.0
    d /= np.linalg.norm(d, axis=-1, keepdims=True)
    rays = np.concatenate([o, d, np.full((500, 1), 0.05),
                           np.full((500, 1), 5.0)], -1).astype(np.float32)
    frames = [FrameData("0", rays, *([None] * 6))]
    kernel = (bi.sample_density_brick_span if option == "span"
              else bi.sample_density_brick)
    reports = {}
    for dev in ("cpu", cuda_device):
        n0 = bi.launch_total(kernel)
        reports[str(dev)] = render_frames_report(
            params_from_numpy(tree, dev), mcfg, rcfg,
            make_render_state(bbox, (14,) * 3, 0.25, device=dev), frames,
            chunk=128, auto_budget=False, device=dev, **kw)
        passes = 2 if option == "no_term" else 1
        assert bi.launch_total(kernel) - n0 == (
            passes * 4 if dev == cuda_device else 0)
    cpu, card = reports["cpu"], reports[str(cuda_device)]
    assert dataclasses.asdict(card.rcfg) == dataclasses.asdict(cpu.rcfg)
    atol = 3e-2 if option == "baked" else 1e-4
    for key, want in cpu.maps[0].items():
        np.testing.assert_allclose(card.maps[0][key], want, atol=atol, rtol=0,
                                   err_msg=key)
    assert np.mean(np.abs(cpu.maps[0]["instances"]).sum(-1) > 0) > 0.2
