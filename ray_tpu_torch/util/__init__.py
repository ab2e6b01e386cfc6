"""ray_tpu_torch.util: the parts of ``ray_tpu/util`` that the port's paths
use, each process-local: fault injection for the checkpoint (``faults``),
metrics (``metrics``) and their exposition (``prometheus``), device
telemetry (``device_metrics``), spans (``timeline``) and usage stats
(``usage_stats``)."""

from . import faults  # noqa: F401
