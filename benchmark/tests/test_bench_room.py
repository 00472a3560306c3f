"""The seeded room's VM factors multiply out to the analytic room."""
import json
from pathlib import Path

import pytest
import torch

from benchmark.fields.params import make_params
from benchmark.fields.room import dense_room, room_boxes, write_room
from benchmark.reference.render import MATRIX_MODE, VECTOR_MODE

HERE = Path(__file__).resolve().parents[1]


def factors_dense(factors, grid_dim):
    """[gx, gy, gz]: sum over axes and components of plane (x) line at the
    lattice."""
    out = torch.zeros(grid_dim)
    letters = "xyz"
    for i in range(3):
        m0, m1 = MATRIX_MODE[i]
        v = VECTOR_MODE[i]
        eq = (f"c{letters[m1]}{letters[m0]},c{letters[v]}->xyz")
        out += torch.einsum(eq, factors["planes"][i], factors["lines"][i])
    return out


@pytest.mark.parametrize("traffic,grid", [
    ("render_room12_fixed", (20, 24, 28)),
    ("render_messy500_fixed", (33, 31, 29)),
])
def test_room_factors_equal_dense_room(traffic, grid):
    mix = json.loads((HERE / "traffic" / f"{traffic}.json").read_text())
    spec = json.loads((HERE / "configs" / "contrastive_lift.json").read_text())
    params = make_params(spec, 7, "cpu", grid)
    boxes = room_boxes(mix["room"], 7)
    write_room(params, mix["room"], boxes)
    got = factors_dense(params["density"], grid)
    want = dense_room(mix["room"], boxes, grid, "cpu")
    assert torch.equal(got, want)
    assert len(boxes["lo"]) == mix["room"]["boxes"]


def test_room_is_seeded():
    mix = json.loads((HERE / "traffic" / "render_room12_fixed.json").read_text())
    a, b = room_boxes(mix["room"], 2 ** 31 + 5), room_boxes(mix["room"], 2 ** 31 + 5)
    c = room_boxes(mix["room"], 2 ** 31 + 6)
    assert (a["lo"] == b["lo"]).all() and not (a["lo"] == c["lo"]).all()


def test_room_refuses_too_many_terms():
    mix = json.loads((HERE / "traffic" / "render_room12_fixed.json").read_text())
    room = dict(mix["room"], boxes=120, heights=40)
    spec = json.loads((HERE / "configs" / "contrastive_lift.json").read_text())
    params = make_params(spec, 1, "cpu", (16, 16, 16))
    with pytest.raises(ValueError, match="terms on VM axis 0"):
        write_room(params, room, room_boxes(room, 1))


@pytest.mark.parametrize("config", ["contrastive_lift", "panopli_mos"])
def test_params_have_the_program_layout(config):
    from contrastive_lift_tpu_torch.factory import make_model_config
    from contrastive_lift_tpu_torch.config import load_config
    from contrastive_lift_tpu_torch.models.tensorf import init_tensorf
    spec = json.loads((HERE / "configs" / f"{config}.json").read_text())
    grid = (12, 10, 8)
    ours = make_params(spec, 3, "cpu", grid)
    cfg = load_config(overrides=spec["config"])
    mcfg = make_model_config(cfg, spec["num_semantic_classes"])
    theirs = init_tensorf(torch.Generator().manual_seed(0), mcfg, grid,
                          device="cpu")
    def shapes(t, prefix=""):
        if isinstance(t, torch.Tensor):
            return {prefix: tuple(t.shape)}
        items = t.items() if isinstance(t, dict) else enumerate(t)
        out = {}
        for k, v in items:
            out.update(shapes(v, f"{prefix}/{k}"))
        return out
    mine, prog = shapes(ours), shapes(theirs)
    assert mine == prog
