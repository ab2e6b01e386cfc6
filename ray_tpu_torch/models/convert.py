"""Carry a parameter tree and an optimizer state over from numpy.

``params_from_numpy(jax.tree.map(np.asarray, ray_tpu.models.init_params(
cfg, key)), cfg, device)`` gives the port the JAX package's weights, leaf
for leaf: the keys, shapes and layout are the same, so nothing is
transposed. ``adam_state_from_numpy`` does the same for optax's
``ScaleByAdamState`` (count, mu, nu). This module imports no JAX; the
caller does the ``np.asarray``.
"""

from __future__ import annotations

from typing import Any, Dict

import numpy as np
import torch

from .._device import DeviceLike, resolve_device
from ..train.optim import AdamState
from .llama import LlamaConfig, Params, leaf_dtype, param_shapes


def tensor_from_numpy(a: np.ndarray, device: torch.device) -> torch.Tensor:
    """numpy → torch, including the ml_dtypes bfloat16 arrays JAX hands
    out (numpy has no bfloat16 of its own: it is read as its 16 bits)."""
    a = np.ascontiguousarray(a)
    if a.dtype.name == "bfloat16":
        t = torch.from_numpy(a.view(np.uint16).copy()).view(torch.bfloat16)
    else:
        t = torch.from_numpy(a.copy())
    return t.to(device)


def params_from_numpy(tree: Dict[str, Any], cfg: LlamaConfig,
                      device: DeviceLike = None) -> Params:
    """Check every leaf's shape against ``cfg`` and move it to ``device``
    in the port's dtypes (``leaf_dtype``): float32 norms and MoE router,
    ``cfg.dtype`` for the rest."""
    dev = resolve_device(device)
    shapes = param_shapes(cfg)

    def leaf(name, value, shape):
        if tuple(value.shape) != tuple(shape):
            raise ValueError(f"{name}: shape {tuple(value.shape)}, "
                             f"config wants {tuple(shape)}")
        return tensor_from_numpy(np.asarray(value), dev).to(
            leaf_dtype(cfg, name))

    out: Params = {
        k: leaf(k, tree[k], shapes[k]) for k in ("embed", "final_norm",
                                                  "lm_head")
    }
    out["layers"] = {
        k: leaf(f"layers.{k}", tree["layers"][k], s)
        for k, s in shapes["layers"].items()
    }
    return out


def adam_state_from_numpy(count: Any, mu: Dict[str, Any], nu: Dict[str, Any],
                          cfg: LlamaConfig,
                          device: DeviceLike = None) -> AdamState:
    """optax's ``ScaleByAdamState`` (``opt_state[0]`` of ``optax.adamw``),
    its count and moment trees given as numpy, as the port's
    :class:`AdamState`; the moments take the parameters' dtypes, as
    optax's do with ``mu_dtype=None``."""
    return AdamState(int(np.asarray(count)), params_from_numpy(mu, cfg, device),
                     params_from_numpy(nu, cfg, device))
