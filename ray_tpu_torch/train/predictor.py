"""Predictors (counterpart of ``ray_tpu/train/predictor.py``).

A Predictor restores a model from a Checkpoint and scores numpy batches.
:class:`TorchPredictor` is the counterpart of the JAX package's
``JaxPredictor``: a tree restored onto the card (``device="cpu"`` when
asked) and an apply function. The JAX package's ``GBDTPredictor`` (on
``train/gbdt.py``) and ``BatchPredictor`` (on ``Dataset.map_batches`` and
the actor pool) wait for those modules' port.
"""

from __future__ import annotations

from typing import Any, Callable, Dict

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
        x = torch.from_numpy(np.ascontiguousarray(batch[self._col])).to(
            self._device)
        out = self._apply(self._params, x)
        return {"predictions": out.cpu().numpy()}
