"""Helpers of the on-disk scene layout shared by the readers: the port's
copy of the part of ``contrastive_lift_tpu/data/preprocessing/common.py``
that they use."""
from __future__ import annotations


def numeric_stem_key(stem: str) -> tuple:
    """Type-stable sort key for frame-file stems: numeric stems first in
    numeric order, then the rest lexically. A mixed directory ('0001.png'
    next to 'frame_extra.png') must sort, not raise. isdecimal (not
    isnumeric) guards the int(): isnumeric admits Unicode numerics like
    '½' that int() rejects."""
    s = str(stem)
    return (0, int(s), "") if s.isdecimal() else (1, 0, s)
