"""LR schedule: gradual warmup + multi-step decay, as a pure epoch -> scale
function. The port's copy of ``contrastive_lift_tpu/train/schedule.py``:
torch MultiStepLR(milestones=decay_step, gamma) stepped once per epoch,
optionally inside a linear warmup; the scale multiplies every group's lr."""
from __future__ import annotations

import bisect
from typing import Sequence


def lr_scale_for_epoch(epoch: int, decay_step: Sequence[int], decay_gamma: float,
                       warmup_epochs: int = 0, warmup_multiplier: float = 1.0) -> float:
    """Multiplier applied to the base lr at a given epoch (host-side float)."""
    decay = decay_gamma ** bisect.bisect_right(sorted(decay_step), epoch)
    if warmup_epochs > 0 and epoch < warmup_epochs:
        # linear ramp from 1/multiplier .. 1 of the post-warmup lr
        frac = (epoch + 1) / warmup_epochs
        warm = (1.0 + (warmup_multiplier - 1.0) * frac) / warmup_multiplier
        return decay * warm
    return decay
