"""Predictors (counterpart of ``ray_tpu/train/predictor.py``).

A Predictor restores a model from a Checkpoint and scores numpy batches.
:class:`TorchPredictor` is the counterpart of the JAX package's
``JaxPredictor``: a tree restored onto the card (``device="cpu"`` when
asked) and an apply function. :class:`BatchPredictor` fans a predictor out
over a Dataset through the actor-pool map operator, so the model restores
once per pool member, not per block. Unlike the JAX package's, each member
asks for a card (``{"GPU": 1}``) unless the predictor is built with
``device="cpu"``: a GPU request never runs on the CPU. The predictor class
and its keyword arguments (``apply_fn`` among them) travel to the members
by reference, so they must be module-level. The JAX package's
``GBDTPredictor`` (on ``train/gbdt.py``) waits for that module's port.
"""

from __future__ import annotations

from typing import Any, Callable, Dict, Optional

import numpy as np
import torch

from .._device import DeviceLike, resolve_device
from .checkpoint import Checkpoint


class Predictor:
    @classmethod
    def from_checkpoint(cls, checkpoint: Checkpoint, **kw) -> "Predictor":
        raise NotImplementedError

    def predict(self, batch: Dict[str, np.ndarray]) -> Dict[str, Any]:
        raise NotImplementedError


class TorchPredictor(Predictor):
    """Scores with ``apply_fn(tree, x)`` on a tree restored from a
    checkpoint; ``x`` is the batch's ``input_column`` as a tensor on the
    tree's device."""

    def __init__(self, params, apply_fn: Callable, input_column: str = "x",
                 device: DeviceLike = None):
        self._params = params
        self._apply = apply_fn
        self._col = input_column
        self._device = resolve_device(device)

    @classmethod
    def from_checkpoint(cls, checkpoint: Checkpoint, *,
                        apply_fn: Callable, example_tree: Any = None,
                        input_column: str = "x",
                        device: DeviceLike = None) -> "TorchPredictor":
        """Restore the tree (checked against ``example_tree`` when given)
        onto ``device``: the CUDA card unless ``device="cpu"``."""
        dev = resolve_device(device)
        params = checkpoint.as_pytree(example_tree, device=dev)
        return cls(params, apply_fn, input_column, dev)

    @torch.inference_mode()
    def predict(self, batch: Dict[str, np.ndarray]) -> Dict[str, Any]:
        """``{"predictions": ...}``; an ``apply_fn`` that returns a dict of
        tensors gives one column each instead."""
        x = np.ascontiguousarray(batch[self._col])
        if not x.flags.writeable:  # torch warns on a read-only view
            x = x.copy()
        x = torch.from_numpy(x).to(self._device)
        out = self._apply(self._params, x)
        if isinstance(out, dict):
            return {k: v.cpu().numpy() for k, v in out.items()}
        return {"predictions": out.cpu().numpy()}


class _PredictorWorker:
    """Actor-pool member: one restored predictor per process."""

    def __init__(self, predictor_cls, checkpoint_path: str,
                 from_ckpt_kwargs: Dict[str, Any]):
        from ..util import timeline

        # Under a trace of its own, the restore's span lands in this
        # member's timeline ("ckpt_restore:<name>").
        prev = timeline.enter_span(timeline.new_trace_id(),
                                   timeline.new_span_id())
        try:
            self._predictor = predictor_cls.from_checkpoint(
                Checkpoint(checkpoint_path), **from_ckpt_kwargs)
        finally:
            timeline.exit_span(prev)

    def __call__(self, batch):
        return self._predictor.predict(batch)


class BatchPredictor:
    """Distributed inference over a Dataset (ref: batch_predictor.py)."""

    def __init__(self, checkpoint: Checkpoint, predictor_cls,
                 **from_ckpt_kwargs):
        self._checkpoint = checkpoint
        self._predictor_cls = predictor_cls
        self._kwargs = from_ckpt_kwargs

    def predict(self, dataset, *, concurrency: int = 2,
                batch_size: Optional[int] = None):
        """A lazy Dataset of the predictions, in the input's row order:
        ``concurrency`` pool members, each with a card unless the
        predictor's ``device`` is the CPU."""
        on_cpu = torch.device(self._kwargs.get("device") or "cuda").type \
            == "cpu"
        return dataset.map_batches(
            _PredictorWorker,
            concurrency=concurrency,
            batch_size=batch_size,
            fn_constructor_args=(self._predictor_cls, self._checkpoint.path,
                                 self._kwargs),
            ray_remote_args=None if on_cpu else {"num_gpus": 1},
        )
