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


def resnet_variables_from_numpy(variables: Dict[str, Any], model,
                                device: DeviceLike = None) -> Dict[str, Any]:
    """flax's ``{"params", "batch_stats"}`` of ``ray_tpu.models.ResNet``
    (its auto names ``conv_init``, ``bn_init``, ``ResNetBlock_<i>`` with
    ``Conv_0``/``Conv_1``/``BatchNorm_0``/``BatchNorm_1`` and, where the
    block changes the shape, ``conv_proj``/``norm_proj``, and ``Dense_0``),
    given as numpy, as the port's tree for ``model``
    (``models/resnet.py``): HWIO kernels become OIHW, every shape is
    checked against the port's own init, and the leaves stay float32."""
    from .resnet import ResNet

    if not isinstance(model, ResNet):
        raise TypeError(f"want a models.resnet.ResNet, got {type(model)}")
    dev = resolve_device(device)
    params, stats = variables["params"], variables.get("batch_stats", {})
    names = {"conv_init": "conv_init", "bn_init": "bn_init",
             "dense": "Dense_0"}
    inner = {"conv1": "Conv_0", "norm1": "BatchNorm_0", "conv2": "Conv_1",
             "norm2": "BatchNorm_1", "conv_proj": "conv_proj",
             "norm_proj": "norm_proj"}
    for i, (name, _block, _ch) in enumerate(model.blocks()):
        names[name] = f"ResNetBlock_{i}"
    expected = model.init(torch.Generator().manual_seed(0),
                          (1, 32, 32, _in_channels(params)), "cpu")

    def leaf(path, value, want):
        a = np.asarray(value)
        if a.ndim == 4:  # HWIO -> OIHW
            a = a.transpose(3, 2, 0, 1)
        if tuple(a.shape) != tuple(want.shape):
            raise ValueError(f"{path}: shape {tuple(a.shape)}, the model "
                             f"wants {tuple(want.shape)}")
        return tensor_from_numpy(a, dev).to(torch.float32)

    def convert(src, ours, path):
        out = {}
        for key, want in ours.items():
            flax_key = names.get(key) if path == "" else inner.get(key, key)
            if flax_key not in src:
                raise ValueError(f"{path}{flax_key}: missing from the flax "
                                 f"tree")
            out[key] = (convert(src[flax_key], want, f"{path}{flax_key}/")
                        if isinstance(want, dict)
                        else leaf(path + flax_key, src[flax_key], want))
        extra = set(src) - {names.get(k) if path == "" else inner.get(k, k)
                            for k in ours}
        if extra:
            raise ValueError(f"{path}: the flax tree has {sorted(extra)}, "
                             f"which the model does not")
        return out

    return {"params": convert(params, expected["params"], ""),
            "batch_stats": convert(stats, expected["batch_stats"], "")}


def _in_channels(params: Dict[str, Any]) -> int:
    return int(np.asarray(params["conv_init"]["kernel"]).shape[2])
