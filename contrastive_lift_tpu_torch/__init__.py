"""contrastive_lift_tpu_torch — the PyTorch/CUDA port of ``contrastive_lift_tpu``.

A second package beside the JAX one, which stays the reference: every module
here is named after its JAX counterpart and is checked against it on the same
weights and rays (``tests/test_torch_port_*.py``). The port imports ``torch``
and ``numpy`` only, never JAX or the JAX package, so it runs on a GPU host
without JAX.

Ported so far: checkpoints (with optimizer state), the TensoRF field and
heads, the brick-atlas density kernel (``csrc/brick_interp.cu``, hand-written
for ``sm_90a``), the dense and production renders, mean-shift clustering and
PQ^scene, and one training step (``train/step.py::make_train_step``: losses,
both Adam chains, the slow-fast EMA, the samplers).
Entry points take ``device=`` (default ``"cuda"``) and never fall back to the
CPU on their own; options of the JAX functions that are not ported yet raise
``NotImplementedError``.
"""

__version__ = "0.1.0"
