"""The brick-atlas CUDA kernel against its plain PyTorch versions, on a card.

These tests need a CUDA card and skip without one (the kernel has no CPU
mode). The file imports no JAX, so it runs on a GPU host that has none:

    python -m pytest --noconftest tests/test_torch_port_cuda.py -q -m cuda
"""
import numpy as np
import pytest
import torch

from contrastive_lift_tpu_torch.ops import brick_interp as bi
from contrastive_lift_tpu_torch.ops import fused_grid as tfg


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the brick_interp kernel has no CPU mode")
    return torch.device("cuda")


@pytest.mark.cuda
def test_kernels_match_plain_versions_on_card(cuda_device):
    grid_dim = (131, 131, 121)
    gen = torch.Generator(device=cuda_device).manual_seed(0)
    atlas = tfg.build_brick_atlas(torch.randn(grid_dim, generator=gen,
                                              device=cuda_device))
    xyz = torch.rand((100_000, 3), generator=gen, device=cuda_device) * 2.04 - 1.02
    n0 = bi.sample_density_brick.launches
    got = bi.sample_density_brick(atlas, xyz, grid_dim, -10.0)
    assert bi.sample_density_brick.launches == n0 + 1
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
    with pytest.raises(NotImplementedError, match="bfloat16"):
        bi.sample_density_brick(atlas.bfloat16(), xyz, grid_dim, 0.0)
    with pytest.raises(ValueError, match="rows"):
        bi.sample_density_brick(atlas[:-1].contiguous(), xyz, grid_dim, 0.0)
    with pytest.raises(ValueError, match="contiguous"):
        bi.brick_interp(atlas[:8], xyz.t().contiguous().t())


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
        n0 = bi.sample_density_brick.launches
        maps[str(dev)] = render_frames(
            params_from_numpy(tree, dev), mcfg, rcfg,
            make_render_state(bbox, (14,) * 3, 0.25, device=dev), frames,
            chunk=128, device=dev)[0]
        launched = bi.sample_density_brick.launches - n0
        assert launched == (4 if dev == cuda_device else 0)
    for key, want in maps["cpu"].items():
        np.testing.assert_allclose(maps[str(cuda_device)][key], want,
                                   atol=1e-4, rtol=0, err_msg=key)
    assert np.mean(np.abs(maps["cpu"]["instances"]).sum(-1) > 0) > 0.2
