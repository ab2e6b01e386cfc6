"""ray_tpu_torch.data: device ingest (``ingest.iter_device_batches``), the
counterpart of ``Dataset.iter_jax_batches`` over any iterable of numpy
batches (what ``Dataset.iter_batches(batch_format="numpy")`` yields)."""

from ..util import usage_stats as _usage
from .ingest import iter_device_batches  # noqa: F401

_usage.record_library_usage("data")
