"""contrastive_lift_tpu_torch — the PyTorch/CUDA port of ``contrastive_lift_tpu``.

A second package beside the JAX one, which stays the reference: every module
here is named after its JAX counterpart and is checked against it on the same
weights and rays (``tests/test_torch_port_*.py``). The port imports ``torch``
and ``numpy`` only, never JAX or the JAX package, so it runs on a GPU host
without JAX.

Ported so far: checkpoints (with optimizer state), the TensoRF field and
heads with the distilled-feature heads, the latent-conditioned model, the
brick-atlas density kernel (``csrc/brick_interp.cu``, hand-written for
``sm_90a``, with its span form), the dense and production renders with
every render option, mean-shift and HDBSCAN clustering and PQ^scene, the
training step and loop, the CLIs and tools, observability, and data
parallel training and rendering. Entry points take ``device=`` (default
``"cuda"``) and never fall back to the CPU on their own. Not ported yet:
preprocessing (``data/preprocessing/*``).
"""

__version__ = "0.1.0"
