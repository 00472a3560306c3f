"""The FLOP and byte counts on small shapes, worked by hand."""
import json
from pathlib import Path

import pytest
import torch

from benchmark.count import flops, k1_bytes

HERE = Path(__file__).resolve().parents[1]


def model(config):
    return json.loads((HERE / "configs" / f"{config}.json").read_text())


def test_density_flops():
    # 12 a component over 16 x 3 components, 8 for softplus and compositing
    assert flops.density_flops(model("contrastive_lift")["model"]) == 12 * 48 + 8


@pytest.mark.parametrize("config,instances", [
    # two heads 3 -> 256 -> 256 -> 256 -> 3
    ("contrastive_lift", 2 * 2 * (3 * 256 + 2 * 256 * 256 + 256 * 3)),
    # one head 3 -> 256 -> 256 -> 256 -> 500
    ("panopli_mos", 2 * (3 * 256 + 2 * 256 * 256 + 256 * 500)),
])
def test_head_flops(config, instances):
    spec = model(config)
    c = spec["num_semantic_classes"]
    appearance = 11 * 144 + 2 * 144 * 27 + 2 * (150 * 128 + 128 * 128 + 128 * 3)
    semantic = 2 * (3 * 256 + 3 * 256 * 256 + 256 * c)
    assert flops.head_flops(spec["model"], c) == appearance + semantic + instances


def test_render_flops_adds_both_parts():
    m = model("contrastive_lift")["model"]
    assert flops.render_flops(m, 21, 1000, 5) == (
        1000 * flops.density_flops(m) + 5 * flops.head_flops(m, 21))


def lattice_xyz(grid, p):
    """Normalised coords of grid position p (voxel units)."""
    g = torch.tensor(grid, dtype=torch.float32)
    return (torch.tensor(p, dtype=torch.float32) / (g - 1) * 2 - 1)[None]


def test_k1_bytes_one_sample():
    grid = (9, 9, 9)
    xyz = lattice_xyz(grid, (1.5, 1.5, 1.5))
    # its 8 corners, 4 bytes each, then 12 bytes in and 4 out
    assert k1_bytes.launch_bytes(xyz, grid, 4) == 8 * 4 + 16


def test_k1_bytes_count_shared_corners_once():
    grid = (9, 9, 9)
    xyz = torch.cat([lattice_xyz(grid, (1.5, 1.5, 1.5)),
                     lattice_xyz(grid, (1.25, 1.75, 1.5)),
                     lattice_xyz(grid, (2.5, 1.5, 1.5))])
    # the first two share a cell; the third shares 4 corners with them
    assert k1_bytes.launch_bytes(xyz, grid, 2) == 12 * 2 + 3 * 16


def test_k1_bytes_brick_rows():
    grid = (9, 9, 9)
    # a sample in the second brick along z reads that brick's row
    row, frac = k1_bytes.brick_coords(grid, lattice_xyz(grid, (0.5, 0.5, 5.5)))
    assert int(row[0]) == 1 and torch.allclose(frac, torch.tensor([[0.5, 0.5, 1.5]]))
