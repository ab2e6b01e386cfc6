"""ray_tpu_torch: the PyTorch/CUDA port of ray_tpu's compute path.

The JAX package ``ray_tpu`` stays the reference; this package keeps its
module names (``ops``, ``models``, ``serve``, ``train``) and computes with
PyTorch on an NVIDIA H100, with hand-written CUDA kernels in place of the
Pallas TPU kernels. It imports nothing from ``ray_tpu`` and never imports JAX.

Entry points run on the CUDA card unless the caller passes
``device="cpu"``; without a card they raise.
"""

from ._device import resolve_device  # noqa: F401
