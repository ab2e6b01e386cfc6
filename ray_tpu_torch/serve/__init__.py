"""ray_tpu_torch.serve: the continuous-batching LLM engine on the H100."""

from ..util import usage_stats as _usage
from .llm import LLMDeployment, LLMEngine  # noqa: F401

_usage.record_library_usage("serve")
