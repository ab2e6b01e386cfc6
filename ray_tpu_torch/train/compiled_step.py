"""One fused training step for the Llama family (the counterpart of
``ray_tpu/train/compiled_step.py``'s ``CompiledTrainStep``).

A step does, in order: the forward with remat and the chunked
cross-entropy (``models/llama.py``: ``causal_lm_loss``), the backward (the
flash-attention backward kernels where ``cfg.use_flash``), AdamW
(``optim.AdamW``, equal to ``optax.adamw(learning_rate)``), and the update
of parameters and optimizer state in place. For an MoE config the loss
adds ``aux_weight`` times the summed load-balancing loss, and the tree
mixes dtypes: the router and its moments are float32, like the norms.

JAX compiles the step into one XLA program and donates the parameter and
state buffers into it (``donate_argnums=(0, 1)``). PyTorch runs eagerly;
the counterpart of donation is that the step updates the caller's tensors
in place, so no second copy of weights or moments ever exists. The
gradient buffers are allocated once (at :meth:`CompiledTrainStep.init`, or
at the first step for parameters made elsewhere) and reused: the backward
accumulates into them in place through per-layer leaves that share storage
with the stacked weights (``models/llama.py``: ``trainable_leaves``).
"""

from __future__ import annotations

from typing import Any, Dict, Optional, Tuple

import torch

from .._device import DeviceLike, resolve_device
from ..models.llama import (
    LlamaConfig,
    Params,
    causal_lm_loss,
    init_params,
    num_params,
    scan_chunks,
    trainable_leaves,
)
from .optim import AdamState, AdamW, leaves, zeros_like_tree


class CompiledTrainStep:
    """Fused train step for the Llama family: loss, gradients and AdamW.

    >>> step = CompiledTrainStep(cfg)
    >>> params, opt_state = step.init(torch.Generator("cuda").manual_seed(0))
    >>> params, opt_state, loss = step(params, opt_state, tokens)

    ``tokens`` is [B, S+1] (inputs and shifted targets). ``device=None``
    means the CUDA card, and raises without one; ``device="cpu"`` runs the
    same step on the CPU through the kernels' plain versions.
    ``optimizer`` is an object with ``init(params)`` and
    ``update(params, grads, state)`` (default: ``AdamW(learning_rate)``).
    """

    def __init__(
        self,
        cfg: LlamaConfig,
        *,
        learning_rate: float = 1e-3,
        optimizer: Optional[AdamW] = None,
        aux_weight: float = 0.01,
        device: DeviceLike = None,
    ):
        scan_chunks(cfg)  # validate the chunk schedule up front
        self.cfg = cfg
        self.device = resolve_device(device)
        self.optimizer = optimizer or AdamW(learning_rate)
        self.aux_weight = aux_weight
        self._grads: Optional[Params] = None

    def init(self, generator: Optional[torch.Generator] = None,
             ) -> Tuple[Params, AdamState]:
        """Random (params, opt_state) on the step's device, drawn from
        ``generator`` (see ``init_params``), with the gradient buffers."""
        params = init_params(self.cfg, generator, self.device)
        self._grads = zeros_like_tree(params)
        return params, self.optimizer.init(params)

    def _grad_buffers(self, params: Params) -> Params:
        ok = self._grads is not None and all(
            g.shape == p.shape and g.dtype == p.dtype and g.device == p.device
            for g, p in zip(leaves(self._grads), leaves(params)))
        if not ok:
            self._grads = zeros_like_tree(params)
        return self._grads

    def value_and_grad(self, params: Params, tokens: torch.Tensor,
                       ) -> Tuple[torch.Tensor, Params]:
        """(loss, grads) of ``causal_lm_loss`` under ``self.cfg``, with no
        update; ``grads`` are the step's buffers, which the next call
        overwrites."""
        grads = self._grad_buffers(params)
        torch._foreach_zero_(leaves(grads))
        top, layers = trainable_leaves(params, grads)
        with torch.enable_grad():
            loss = causal_lm_loss(top, tokens.to(self.device), self.cfg,
                                  aux_weight=self.aux_weight, layers=layers)
            loss.backward()
        return loss.detach(), grads

    def __call__(self, params: Params, opt_state: AdamState,
                 tokens: torch.Tensor) -> Tuple[Params, AdamState,
                                                torch.Tensor]:
        """One step: returns (params, opt_state, loss). ``params`` and
        ``opt_state`` are updated in place and returned as the same objects
        (JAX's donated buffers)."""
        loss, grads = self.value_and_grad(params, tokens)
        self.optimizer.update(params, grads, opt_state)
        return params, opt_state, loss

    @property
    def grads(self) -> Optional[Params]:
        """The gradient buffers: the last step's gradients until the next
        step overwrites them (None before the first)."""
        return self._grads

    def num_params(self, params: Params) -> int:
        return num_params(params)

    def memory_snapshot(self) -> Dict[str, Any]:
        """The card's allocator: bytes allocated now, at peak (since the
        last ``torch.cuda.reset_peak_memory_stats``) and reserved; {} on
        the CPU."""
        if self.device.type != "cuda":
            return {}
        return {
            "allocated_bytes": torch.cuda.memory_allocated(self.device),
            "peak_bytes": torch.cuda.max_memory_allocated(self.device),
            "reserved_bytes": torch.cuda.memory_reserved(self.device),
        }
