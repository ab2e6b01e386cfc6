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

Under a device mesh (``mesh=``, ``rules=``; JAX ``:89-128,160-167``) the
step is explicit SPMD: each rank holds its local shards of the parameters,
the AdamW moments and the gradient buffers (``param_logical_axes`` under
``rules``), takes its window of the global batch (:meth:`token_sharding`)
and runs the same code, collectives included, at any world size (over
groups of one at world size 1). Each rank's backward starts from the loss
divided by the world size: the collectives' backward passes sum the
gradient over the ranks, so a gradient arrives reduce-scattered over
``fsdp`` (the backward of the per-layer all-gather) and summed onto the
rank that holds its layer over ``pp`` (the backward of the layer's
broadcast), and is then all-reduced over every mesh axis its leaf is
replicated on (``dp``, ``sp``, and ``tp`` for the norms; for the MoE router
also ``ep``), which gives every rank its slice of the single-device
gradient. Every data rank computes the same MoE aux loss from the global
means; its gradient reaches each rank's router logits through the logits'
gather, whose backward sums over the ranks, so with the loss divided by
the world size it counts once.

Telemetry, as in the JAX package (``:117-119,161-203``): the step runs
through ``util/device_metrics.instrumented_step(sample_memory=True)``, so
each new token shape counts one compile under ``fn="train_step"`` and the
device memory gauges are published after it (and, throttled, after the
other steps); ``__call__`` records a ``train_step`` span under the
thread's active trace; ``compile_stats()`` and ``memory_snapshot()`` give
the JAX package's keys.
"""

from __future__ import annotations

import dataclasses
import time
from typing import Any, Dict, Optional, Tuple

import torch

from .._device import DeviceLike, resolve_device
from ..models.llama import (
    LlamaConfig,
    MeshPlan,
    Params,
    causal_lm_loss,
    init_params,
    num_params,
    param_logical_axes,
    scan_chunks,
    trainable_leaves,
)
from ..parallel import collectives as coll
from ..parallel.mesh import AXIS_ORDER
from ..parallel.sharding import (
    DEFAULT_RULES,
    NamedSharding,
    entry_axes,
    prune_spec,
    tree_map,
)
from ..util import device_metrics
from ..util.timeline import record_span
from .optim import AdamState, AdamW, leaves, zeros_like_tree


@dataclasses.dataclass(frozen=True)
class TokenSharding:
    """How a rank cuts the global [B, S+1] token batch: the batch over
    ``sharding``'s dim-0 axes (dp+fsdp), the sequence over its dim-1 axes
    (sp). Its window holds its S/sp inputs and one token more, the next
    window's first, so its targets are the global shift's."""

    sharding: NamedSharding

    def cut(self, tokens: torch.Tensor) -> torch.Tensor:
        """This rank's [B/(dp*fsdp), S/sp + 1] window of ``tokens``."""
        (bi, bn), (si, sn) = self.sharding.coords(0), self.sharding.coords(1)
        B, S = tokens.shape[0], tokens.shape[1] - 1
        if B % bn or S % sn:
            raise ValueError(f"a [{B}, {S}+1] batch does not split into "
                             f"{bn} x {sn} pieces")
        b, s = B // bn, S // sn
        return tokens[bi * b:(bi + 1) * b, si * s:(si + 1) * s + 1]


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

    With ``mesh`` (a ``parallel.mesh.make_mesh`` mesh; ``device`` defaults
    to its device type) parameters, state and gradients are this rank's
    shards under ``rules``, and ``tokens`` is this rank's window
    (``step.token_sharding().cut(global_tokens)``); every rank returns the
    global loss.
    """

    def __init__(
        self,
        cfg: LlamaConfig,
        *,
        learning_rate: float = 1e-3,
        optimizer: Optional[AdamW] = None,
        aux_weight: float = 0.01,
        device: DeviceLike = None,
        mesh=None,
        rules=DEFAULT_RULES,
    ):
        scan_chunks(cfg)  # validate the chunk schedule up front
        self.cfg = cfg
        if mesh is not None:
            device = device if device is not None else mesh.device_type
            if resolve_device(device).type != mesh.device_type:
                raise ValueError(f"device {device} is not the mesh's "
                                 f"{mesh.device_type}")
        self.device = resolve_device(device)
        self.mesh = mesh
        self.rules = rules
        self.plan = None if mesh is None else MeshPlan(cfg, mesh, rules)
        self.optimizer = optimizer or AdamW(learning_rate)
        self.aux_weight = aux_weight
        self._grads: Optional[Params] = None

        def train_step(params, opt_state, tokens):
            loss, grads = self.value_and_grad(params, tokens)
            self.optimizer.update(params, grads, opt_state)
            return params, opt_state, loss

        # Keyed by the token batch's shape, dtype and device (the only
        # top-level tensor): the parameter tree is never walked per step.
        self._step = device_metrics.instrumented_step(train_step,
                                                      sample_memory=True)

    def init(self, generator: Optional[torch.Generator] = None,
             ) -> Tuple[Params, AdamState]:
        """Random (params, opt_state) on the step's device, drawn from
        ``generator`` (see ``init_params``), with the gradient buffers.
        Under a mesh every rank draws the same stream and keeps its shards:
        the slices of the single-device init from the same seed."""
        shard = layers = None
        if self.plan is not None:
            def shard(name, full):
                spec = self.plan.specs
                for key in name.split("."):
                    spec = spec[key]
                if name.startswith("layers."):
                    spec = spec[1:]  # one layer's slice
                return NamedSharding(self.mesh, prune_spec(
                    self.mesh, spec)).local(full)

            n = self.plan.local_layers
            first = NamedSharding(self.mesh, (self.plan.layers,)).coords(0)[0]
            layers = range(first * n, (first + 1) * n)
        params = init_params(self.cfg, generator, self.device, shard=shard,
                             layers=layers)
        self._grads = zeros_like_tree(params)
        return params, self.optimizer.init(params)

    def token_sharding(self) -> Optional[TokenSharding]:
        """How this rank cuts the global [B, S+1] batch (batch over the
        "batch" rule's axes, sequence over the "seq" rule's), or None
        off-mesh."""
        if self.plan is None:
            return None
        return TokenSharding(self.plan.tokens)

    def state_logical_axes(self) -> Dict[str, Any]:
        """The logical axes of ``{"params", "opt_state", "step"}`` (the
        moments share the parameters' axes; the count and the step are
        replicated), for ``train.checkpoint``'s ``logical_axes=``."""
        axes = param_logical_axes(self.cfg)
        return {"params": axes, "opt_state": AdamState(None, axes, axes),
                "step": None}

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
                                  aux_weight=self.aux_weight, layers=layers,
                                  mesh=self.mesh, rules=self.rules)
            (loss / (1 if self.mesh is None else self.mesh.size())).backward()
        if self.mesh is not None:
            self._sum_replicas(grads)
        return loss.detach(), grads

    def _sum_replicas(self, grads: Params) -> None:
        """All-reduce each gradient over the mesh axes its leaf is
        replicated on (every axis its spec does not split)."""
        def reduce(g, spec):
            split = {a for e in spec for a in entry_axes(e)}
            coll.allreduce_(g, [a for a in AXIS_ORDER if a not in split],
                            mesh=self.mesh)
        tree_map(reduce, grads, self.plan.specs)

    def __call__(self, params: Params, opt_state: AdamState,
                 tokens: torch.Tensor) -> Tuple[Params, AdamState,
                                                torch.Tensor]:
        """One step: returns (params, opt_state, loss). ``params`` and
        ``opt_state`` are updated in place and returned as the same objects
        (JAX's donated buffers). Each step records a ``train_step`` span
        under the thread's active trace (nothing outside one)."""
        t0 = time.time()
        try:
            return self._step(params, opt_state, tokens)
        finally:
            try:
                record_span("train_step", t0, time.time())
            # A lost span only blanks telemetry, never a step.
            except Exception:  # noqa: BLE001
                pass

    @property
    def grads(self) -> Optional[Params]:
        """The gradient buffers: the last step's gradients until the next
        step overwrites them (None before the first)."""
        return self._grads

    def num_params(self, params: Params) -> int:
        return num_params(params)

    def compile_stats(self) -> Dict[str, Any]:
        """The step's compile telemetry (also published as the
        ``ray_tpu_device_jit_*`` series): the token shapes it has run."""
        return {"fn": "train_step", "executables": self._step.cache_size()}

    def memory_snapshot(self) -> Dict[str, Any]:
        """The step's device allocator with the JAX package's keys (live,
        peak and reserved bytes, the limit and the fragmentation ratio;
        ``device_metrics.hbm_snapshot``); {} on the CPU."""
        return device_metrics.hbm_snapshot(self.device)
