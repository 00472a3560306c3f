"""The port's brick-atlas kernel module against the JAX package.

On the CPU the wrappers run their plain versions (the 128-lane hat reduction),
which are held to the Pallas kernel in interpret mode and to the XLA
``sample_density_brick`` the JAX renderer calls. The CUDA kernel itself is
checked against the plain versions on a card by ``test_torch_port_cuda.py``
and ``chip_smoke.py``.
"""
import numpy as np
import jax.numpy as jnp
import pytest
import torch

from contrastive_lift_tpu.ops import fused_grid as jfg
from contrastive_lift_tpu.ops.pallas_interp import brick_interp as pallas_brick_interp
from contrastive_lift_tpu_torch.ops import brick_interp as bi
from contrastive_lift_tpu_torch.ops import fused_grid as tfg

torch.set_num_threads(2)


def _points(rng, n, lo=-1.0, hi=1.0):
    """Samples in the box plus some just outside it (out-of-box samples get
    clamped hat weights, not linear extrapolation)."""
    pts = rng.uniform(lo, hi, (n, 3))
    pts[: n // 8] = rng.uniform(-1.03, 1.03, (n // 8, 3))
    pts[n // 8: n // 8 + 6] = [[-1.02, 0, 0], [1.02, 0, 0], [0, -1.01, 0],
                               [0, 1.01, 0], [0, 0, -1.025], [0, 0, 1.025]]
    return pts.astype(np.float32)


def _dense(grid_dim, seed=0):
    return np.random.default_rng(seed).standard_normal(grid_dim).astype(np.float32)


def test_brick_interp_reference_matches_pallas():
    rng = np.random.default_rng(3)
    rows = rng.standard_normal((500, 128)).astype(np.float32)
    frac = rng.uniform(0, 4, (500, 3)).astype(np.float32)
    want = np.asarray(pallas_brick_interp(jnp.asarray(rows), jnp.asarray(frac),
                                          interpret=True))
    got = bi.brick_interp_reference(torch.from_numpy(rows), torch.from_numpy(frac))
    np.testing.assert_allclose(got.numpy(), want, atol=1e-6, rtol=0)


@pytest.mark.parametrize("grid_dim", [(14, 14, 14), (30, 17, 22)])
def test_brick_atlas_equal(grid_dim):
    """The atlas only moves data, so it is identical to JAX's (edge-clamped
    padding on grids not divisible by the brick size included)."""
    dense = _dense(grid_dim)
    want = np.asarray(jfg._build_brick_atlas(jnp.asarray(dense)))
    got = tfg.build_brick_atlas(torch.from_numpy(dense)).numpy()
    assert got.shape == (int(np.prod(bi.brick_atlas_dims(grid_dim))), 128)
    np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize("grid_dim", [(14, 14, 14), (30, 17, 22)])
def test_sample_density_brick_matches_jax(grid_dim):
    dense = _dense(grid_dim, seed=1)
    atlas = jfg._build_brick_atlas(jnp.asarray(dense))
    fused = jfg.FusedGrids(None, grid_dim, {}, brick_atlas=atlas)
    pts = _points(np.random.default_rng(2), 4096)
    want = np.asarray(jfg.sample_density_brick(fused, jnp.asarray(pts), -10.0))
    got = bi.sample_density_brick(torch.from_numpy(np.array(atlas)),
                                  torch.from_numpy(pts), grid_dim, -10.0)
    np.testing.assert_allclose(got.numpy(), want, atol=1e-5, rtol=0)


def test_brick_coords_match_jax():
    grid_dim = (30, 17, 22)
    fused = jfg.FusedGrids(None, grid_dim, {})
    pts = _points(np.random.default_rng(4), 2048)
    row_j, frac_j = jfg._brick_coords(fused, jnp.asarray(pts))
    row_t, frac_t = bi.brick_coords(grid_dim, torch.from_numpy(pts))
    np.testing.assert_array_equal(row_t.numpy(), np.asarray(row_j))
    np.testing.assert_array_equal(frac_t.numpy(), np.asarray(frac_j))


def test_cpu_wrappers_are_the_plain_versions():
    """On CPU tensors the wrappers compute the plain version and launch
    nothing."""
    grid_dim = (14, 14, 14)
    atlas = tfg.build_brick_atlas(torch.from_numpy(_dense(grid_dim)))
    xyz = torch.from_numpy(_points(np.random.default_rng(5), 512))
    before = (bi.brick_interp.launches, bi.sample_density_brick.launches)
    got = bi.sample_density_brick(atlas, xyz, grid_dim, 0.5)
    want = bi.sample_density_brick_reference(atlas, xyz, grid_dim, 0.5)
    torch.testing.assert_close(got, want, rtol=0, atol=0)
    row, frac = bi.brick_coords(grid_dim, xyz)
    torch.testing.assert_close(bi.brick_interp(atlas[row], frac),
                               bi.brick_interp_reference(atlas[row], frac),
                               rtol=0, atol=0)
    assert (bi.brick_interp.launches, bi.sample_density_brick.launches) == before


def _chip_smoke():
    import importlib
    import sys
    from pathlib import Path
    sys.path.insert(0, str(Path(__file__).resolve().parents[1]))
    return importlib.import_module("chip_smoke")


def test_lattice_yardstick_is_brick_interp():
    """chip_smoke.py's library call for brick_interp, F.grid_sample on each
    row viewed as its 5^3 lattice, computes the plain version's function on
    rows laid out as the atlas lays them out (pad lanes 125-127 zero), with
    frac outside [0,4]^3 too."""
    rng = np.random.default_rng(5)
    rows = torch.from_numpy(rng.standard_normal((600, 128)).astype(np.float32))
    rows[:, 125:] = 0.0
    frac = torch.from_numpy(rng.uniform(-0.3, 4.3, (600, 3)).astype(np.float32))
    got = _chip_smoke().lattice_yardstick(rows, frac)()
    want = bi.brick_interp_reference(rows, frac)
    np.testing.assert_allclose(got.numpy(), want.numpy(), atol=1e-5)


@pytest.mark.parametrize("grid_dim", [(14, 14, 14), (13, 11, 9)])
def test_dense_yardstick_is_sample_density_brick_in_box(grid_dim):
    """chip_smoke.py's library call for sample_density_brick, F.grid_sample
    on the dense grid, agrees with the plain version for samples in the box."""
    dense = torch.from_numpy(_dense(grid_dim, seed=4))
    xyz = torch.from_numpy(_points(np.random.default_rng(6), 700))
    in_box = (xyz.abs() <= 1.0).all(dim=1)
    got = _chip_smoke().dense_yardstick(dense, xyz, -2.0)()
    want = bi.sample_density_brick_reference(tfg.build_brick_atlas(dense), xyz,
                                             grid_dim, -2.0)
    np.testing.assert_allclose(got[in_box].numpy(), want[in_box].numpy(),
                               atol=1e-5)
