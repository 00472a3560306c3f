"""Device selection for the port's entry points: explicit, never a fallback."""
from __future__ import annotations

import torch


def resolve_device(device) -> torch.device:
    """``device`` as a ``torch.device`` with its index; raises when CUDA is
    asked for but absent.

    Entry points default to ``"cuda"``; a caller that wants the CPU (the
    tests) says so with ``device="cpu"``.
    """
    dev = torch.device(device)
    if dev.type == "cuda":
        if not torch.cuda.is_available():
            raise RuntimeError(
                f"device={device!r} requested but torch.cuda.is_available() "
                "is False; pass device='cpu' to run on the CPU")
        if dev.index is None:
            # "cuda" means the current card; name it, so devices compare equal
            dev = torch.device("cuda", torch.cuda.current_device())
    return dev
