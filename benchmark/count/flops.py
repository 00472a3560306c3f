"""Model FLOPs of a render, from the configuration's shapes.

The count is of the work the model defines, whatever implements it:
- density at every in-box sample at the step ratio: per VM component a
  bilinear plane read (4 multiplies, 3 adds), a linear line read (2, 1),
  their product and the sum over components (2), so 12 a component, and 8
  for the shift, softplus, alpha and transmittance;
- the heads at every sample whose weight exceeds the threshold: the
  appearance features (11 a component, then the basis), and each MLP layer
  2 * in * out (bias and activation not counted).
"""
from __future__ import annotations

from benchmark.fields.params import mlp_shapes

# H100 SXM dense peaks (NVIDIA's data sheet), FLOP/s
PEAK = {"float32": 67e12, "tf32": 495e12, "bfloat16": 989e12}


def density_flops(model: dict) -> int:
    return 12 * sum(model["num_density_comps"]) + 8


def head_parts(model: dict, num_classes: int) -> dict:
    """FLOPs a sample of each head: ``appearance_mlp`` with its features,
    ``semantic_mlp``, ``instance_mlp.<name>``."""
    app = sum(model["num_appearance_comps"])
    out = {head: sum(2 * i * o for i, o in layers)
           for head, layers in mlp_shapes(model, num_classes).items()}
    out["appearance_mlp"] += 11 * app + 2 * app * model["dim_appearance"]
    return out


def head_flops(model: dict, num_classes: int) -> int:
    return sum(head_parts(model, num_classes).values())


def train_step_flops(model: dict, num_classes: int, counts: dict) -> float:
    """FLOPs of one training step: ``counts`` gives, for the ``main``,
    ``segment`` and ``instance`` batches, (rays, in-box samples a ray,
    above-threshold samples a ray). A differentiated pass counts 3 times:
    the main render's density and heads (appearance, semantic), the segment
    pass's semantic head and the instance pass's fast head; the passes'
    density without gradient and every other instance head the
    configuration has (the slow head) count once."""
    h = head_parts(model, num_classes)
    d = density_flops(model)
    n, box, hd = counts["main"]
    total = n * 3 * (box * d + hd * (h["appearance_mlp"] + h["semantic_mlp"]))
    n, box, hd = counts["segment"]
    total += n * (box * d + 3 * hd * h["semantic_mlp"])
    n, box, hd = counts["instance"]
    total += n * (box * d + hd * sum(
        (3 if name == "fast" else 1) * h[f"instance_mlp.{name}"]
        for name in model["instance_heads"]))
    return total


def render_flops(model: dict, num_classes: int, in_box: float,
                 heads: float) -> float:
    """FLOPs of rays with ``in_box`` samples in the box and ``heads``
    samples above the weight threshold (totals or means alike)."""
    return (in_box * density_flops(model)
            + heads * head_flops(model, num_classes))
