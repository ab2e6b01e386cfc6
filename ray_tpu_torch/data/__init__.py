"""ray_tpu_torch.data: distributed datasets on the port's runtime
(counterpart of ``ray_tpu.data``): numpy column blocks streamed through
CPU tasks and actor pools (GPU pools with ``ray_remote_args={"num_gpus":
1}``), shuffles, groupby, splits and ``streaming_split`` for trainers, and
device ingest (``iter_device_batches``, behind
``Dataset.iter_torch_batches``). Importing it imports no torch:
``iter_device_batches`` loads with its module on first use, so a CPU
block task's worker starts without torch."""

from ..util import usage_stats as _usage
from . import preprocessors  # noqa: F401
from .block import Block, BlockAccessor  # noqa: F401
from .context import DataContext  # noqa: F401
from .dataset import Dataset  # noqa: F401
from .iterator import DataIterator  # noqa: F401
from .read_api import (  # noqa: F401
    from_items,
    from_numpy,
    from_torch,
    range,
    read_binary_files,
    read_numpy,
)

_usage.record_library_usage("data")


def __getattr__(name):
    if name == "iter_device_batches":
        from .ingest import iter_device_batches

        return iter_device_batches
    raise AttributeError(f"module {__name__!r} has no attribute {name!r}")
