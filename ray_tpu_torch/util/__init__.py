"""ray_tpu_torch.util: process-local fault injection (``faults``), the part
of ``ray_tpu/util`` that the checkpoint fires."""

from . import faults  # noqa: F401
