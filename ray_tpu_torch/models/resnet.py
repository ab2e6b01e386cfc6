"""ResNet for image classification (counterpart of
``ray_tpu/models/resnet.py``: ResNet-18 / CIFAR-10 is the reference
configuration).

NHWC inputs, as the JAX package takes them; inside, on the card, the
tensors are NCHW views of channels-last memory (``x.permute(0, 3, 1, 2)``
of an NHWC tensor is one), which is cuDNN's preferred layout, so nothing
is copied; on the CPU they are plain NCHW. The
convolutions run through ``F.conv2d`` (cuDNN on the card); the JAX package
computes them with XLA convolutions outside any Pallas kernel, so the port
has no kernel of its own here.

Plain functions on parameter trees, as the Llama port is. ``model.init``
gives ``{"params", "batch_stats"}``; ``model.apply(variables, x,
train=True)`` gives the logits and the new ``batch_stats`` (flax's
``mutable=["batch_stats"]``), ``train=False`` the logits from the running
statistics. The trees (``models/convert.py`` maps flax's names onto them):

    params:      conv_init {kernel [O, I, kh, kw]}, bn_init {scale, bias},
                 block<i> {conv1, norm1, conv2, norm2[, conv_proj,
                 norm_proj]}, dense {kernel [C, classes], bias}
    batch_stats: bn_init {mean, var}, block<i> {norm1, norm2[, norm_proj]}

Kept from flax, where a plain PyTorch ResNet would differ:

- Padding is flax's ``"SAME"``: ``ceil(n / stride)`` outputs, the padding
  split with the smaller half before. A 3x3 stride-2 convolution of an even
  size pads 0 before and 1 after (``Conv2d(padding=1)`` would pad 1 on
  both sides and shift every output); the 7x7 stride-2 stem pads 2 and 3
  at 224; the 3x3 stride-2 max-pool pads with -inf the same way.
- BatchNorm (momentum 0.9, epsilon 1e-5) computes in float32 and returns
  float32. Its batch variance is E[x^2] - E[x]^2, clipped at 0, and the
  running variance takes that *biased* variance:
  ``ra = 0.9 ra + 0.1 batch`` (``F.batch_norm`` would update with the
  unbiased one).
- Dtypes: each convolution casts its input and kernel to ``dtype`` (bf16
  by default) and returns ``dtype``; the norms return float32, so the
  activations and residuals between blocks are float32. The head is a
  float32 ``Dense`` on the spatial mean. Parameters are float32.
- The second norm of each block starts with a zero scale; ``conv_proj`` /
  ``norm_proj`` exist only where the block changes the shape.
- ``resnet50`` is four stages of *basic* blocks, as the JAX package's is.
"""

from __future__ import annotations

import dataclasses
from typing import Any, Dict, Optional, Sequence, Tuple

import torch
import torch.nn.functional as F

from .._device import DeviceLike, resolve_device
from ..parallel.sharding import tree_map

Tree = Dict[str, Any]

MOMENTUM = 0.9
EPSILON = 1e-5


def same_padding(size: int, kernel: int, stride: int) -> Tuple[int, int]:
    """(before, after) padding of one spatial dim under "SAME"."""
    out = -(-size // stride)
    total = max((out - 1) * stride + kernel - size, 0)
    return total // 2, total - total // 2


def _pad_same(x: torch.Tensor, kernel: int, stride: int,
              value: float = 0.0) -> Tuple[torch.Tensor, int]:
    """``x`` (NCHW) padded for "SAME", and the symmetric padding left for
    the op itself (F.pad only where the two sides differ)."""
    (ht, hb), (wl, wr) = (same_padding(x.shape[2], kernel, stride),
                          same_padding(x.shape[3], kernel, stride))
    if ht == hb == wl == wr:
        return x, ht
    return F.pad(x, (wl, wr, ht, hb), value=value), 0


def conv(x: torch.Tensor, kernel: torch.Tensor, stride: int,
         dtype: torch.dtype) -> torch.Tensor:
    """flax ``nn.Conv(use_bias=False, padding="SAME", dtype=dtype)`` on NCHW
    ``x`` with an OIHW kernel."""
    x, pad = _pad_same(x.to(dtype), kernel.shape[-1], stride)
    return F.conv2d(x, kernel.to(dtype), stride=stride, padding=pad)


def batch_norm(x: torch.Tensor, p: Tree, stats: Tree,
               train: bool) -> Tuple[torch.Tensor, Optional[Tree]]:
    """flax ``nn.BatchNorm(momentum=0.9, epsilon=1e-5, dtype=float32)`` over
    the channels of NCHW ``x``: (float32 output, new stats or None)."""
    x = x.float()
    if train:
        mean = x.mean((0, 2, 3))
        var = ((x * x).mean((0, 2, 3)) - mean * mean).clamp_min(0.0)
        new = {"mean": MOMENTUM * stats["mean"] + (1 - MOMENTUM) * mean.detach(),
               "var": MOMENTUM * stats["var"] + (1 - MOMENTUM) * var.detach()}
    else:
        mean, var, new = stats["mean"], stats["var"], None
    mul = torch.rsqrt(var + EPSILON) * p["scale"]
    y = (x - mean[:, None, None]) * mul[:, None, None] + p["bias"][:, None,
                                                                      None]
    return y, new


def _conv_init(generator, out_ch, in_ch, k, device) -> Tree:
    """LeCun normal (flax's default kernel init: variance 1 / fan_in)."""
    std = (in_ch * k * k) ** -0.5
    w = torch.randn(out_ch, in_ch, k, k, generator=generator, device=device)
    return {"kernel": w * std}


def _norm_init(ch, device, zero_scale=False) -> Tuple[Tree, Tree]:
    scale = (torch.zeros if zero_scale else torch.ones)(ch, device=device)
    return ({"scale": scale, "bias": torch.zeros(ch, device=device)},
            {"mean": torch.zeros(ch, device=device),
             "var": torch.ones(ch, device=device)})


@dataclasses.dataclass(frozen=True)
class ResNetBlock:
    """The basic block: 3x3 conv, norm, relu, 3x3 conv, norm (zero scale),
    plus the residual (through a 1x1 ``conv_proj`` and ``norm_proj`` where
    the shape changes), relu."""

    filters: int
    strides: Tuple[int, int] = (1, 1)
    dtype: torch.dtype = torch.bfloat16

    def projects(self, in_channels: int) -> bool:
        return self.strides != (1, 1) or in_channels != self.filters

    def init(self, generator: torch.Generator, in_channels: int,
             device: torch.device) -> Tuple[Tree, Tree]:
        f = self.filters
        params, stats = {}, {}
        params["conv1"] = _conv_init(generator, f, in_channels, 3, device)
        params["norm1"], stats["norm1"] = _norm_init(f, device)
        params["conv2"] = _conv_init(generator, f, f, 3, device)
        params["norm2"], stats["norm2"] = _norm_init(f, device,
                                                     zero_scale=True)
        if self.projects(in_channels):
            params["conv_proj"] = _conv_init(generator, f, in_channels, 1,
                                             device)
            params["norm_proj"], stats["norm_proj"] = _norm_init(f, device)
        return params, stats

    def apply(self, params: Tree, stats: Tree, x: torch.Tensor,
              train: bool) -> Tuple[torch.Tensor, Tree]:
        """(output, new stats: {} unless ``train``) for NCHW ``x``."""
        stride = self.strides[0]
        new: Tree = {}
        y = conv(x, params["conv1"]["kernel"], stride, self.dtype)
        y, new["norm1"] = batch_norm(y, params["norm1"], stats["norm1"],
                                     train)
        y = F.relu(y)
        y = conv(y, params["conv2"]["kernel"], 1, self.dtype)
        y, new["norm2"] = batch_norm(y, params["norm2"], stats["norm2"],
                                     train)
        residual = x
        if "conv_proj" in params:
            residual = conv(x, params["conv_proj"]["kernel"], stride,
                            self.dtype)
            residual, new["norm_proj"] = batch_norm(
                residual, params["norm_proj"], stats["norm_proj"], train)
        return F.relu(residual + y), (new if train else {})


@dataclasses.dataclass(frozen=True)
class ResNet:
    stage_sizes: Sequence[int]
    num_classes: int
    num_filters: int = 64
    dtype: torch.dtype = torch.bfloat16
    small_images: bool = True  # CIFAR stem (3x3, no max-pool)

    def blocks(self):
        """(name, block) in order, each with its input's channel count."""
        out, ch = [], self.num_filters
        for i, count in enumerate(self.stage_sizes):
            for j in range(count):
                strides = (2, 2) if i > 0 and j == 0 else (1, 1)
                block = ResNetBlock(self.num_filters * 2 ** i, strides,
                                    self.dtype)
                out.append((f"block{len(out)}", block, ch))
                ch = block.filters
        return out

    def init(self, generator: Optional[torch.Generator] = None,
             input_shape: Sequence[int] = (1, 32, 32, 3),
             device: DeviceLike = None) -> Tree:
        """``{"params", "batch_stats"}`` drawn on ``device`` from
        ``generator`` (a generator on that device; default one seeded with
        0) for NHWC inputs of ``input_shape``."""
        dev = resolve_device(device)
        if generator is None:
            generator = torch.Generator(device=dev).manual_seed(0)
        k = 3 if self.small_images else 7
        params: Tree = {"conv_init": _conv_init(
            generator, self.num_filters, input_shape[-1], k, dev)}
        stats: Tree = {}
        params["bn_init"], stats["bn_init"] = _norm_init(self.num_filters,
                                                         dev)
        for name, block, ch in self.blocks():
            params[name], stats[name] = block.init(generator, ch, dev)
        width = self.num_filters * 2 ** (len(self.stage_sizes) - 1)
        params["dense"] = {
            "kernel": torch.randn(width, self.num_classes,
                                  generator=generator, device=dev)
            * width ** -0.5,
            "bias": torch.zeros(self.num_classes, device=dev)}
        return {"params": params, "batch_stats": stats}

    def apply(self, variables: Tree, x: torch.Tensor, train: bool = True):
        """Logits [N, classes] (float32) for NHWC ``x``; with ``train``,
        (logits, new batch_stats) from the batch's statistics."""
        params, stats = variables["params"], variables["batch_stats"]
        new: Tree = {}
        y = x.permute(0, 3, 1, 2)  # NCHW view of channels-last memory
        if y.device.type == "cpu":
            # The CPU's oneDNN convolution backward on channels-last
            # tensors, run on several threads, aborts the process with a
            # heap corruption (torch 2.13); plain NCHW there.
            y = y.contiguous()
        if self.small_images:
            y = conv(y, params["conv_init"]["kernel"], 1, self.dtype)
        else:
            y = conv(y, params["conv_init"]["kernel"], 2, self.dtype)
        y, new["bn_init"] = batch_norm(y, params["bn_init"],
                                       stats["bn_init"], train)
        y = F.relu(y)
        if not self.small_images:
            y, pad = _pad_same(y, 3, 2, value=float("-inf"))
            y = F.max_pool2d(y, 3, 2, padding=pad)
        for name, block, _ch in self.blocks():
            y, new[name] = block.apply(params[name], stats[name], y, train)
        y = y.mean((2, 3))
        logits = y @ params["dense"]["kernel"] + params["dense"]["bias"]
        return (logits, new) if train else logits


def resnet18(num_classes: int = 10, **kw) -> ResNet:
    return ResNet(stage_sizes=[2, 2, 2, 2], num_classes=num_classes, **kw)


def resnet50(num_classes: int = 1000, **kw) -> ResNet:
    # Basic blocks (not bottleneck), as the JAX package's resnet50.
    return ResNet(stage_sizes=[3, 4, 6, 3], num_classes=num_classes, **kw)


def create_train_state(model: ResNet, generator: Optional[torch.Generator],
                       input_shape: Sequence[int], tx,
                       device: DeviceLike = None) -> Tree:
    """``{"params", "batch_stats", "opt_state", "step"}``; ``tx`` is an
    optimizer with ``init(params)`` (``AdamW(lr, weight_decay=0.0)`` is
    ``optax.adam(lr)``)."""
    variables = model.init(generator, input_shape, device)
    return {"params": variables["params"],
            "batch_stats": variables["batch_stats"],
            "opt_state": tx.init(variables["params"]), "step": 0}


def loss_and_grads(model: ResNet, variables: Tree, x: torch.Tensor,
                   labels: torch.Tensor) -> Tuple[torch.Tensor, Tree, Tree]:
    """(mean softmax cross-entropy, grads of the params, new batch_stats)
    of one training-mode forward on NHWC ``x``."""
    params = tree_map(lambda t: t.detach().requires_grad_(True),
                      variables["params"])
    with torch.enable_grad():
        logits, new_stats = model.apply(
            {"params": params, "batch_stats": variables["batch_stats"]}, x,
            train=True)
        loss = F.cross_entropy(logits, labels.long())
        loss.backward()
    # cuDNN gives a channels-last input's kernel gradients in channels-last
    # strides; the fused AdamW wants them laid out as the kernels are.
    return (loss.detach(), tree_map(lambda t: t.grad.contiguous(), params),
            new_stats)


def train_step(model: ResNet, state: Tree, x: torch.Tensor,
               labels: torch.Tensor, tx) -> torch.Tensor:
    """One step on ``state`` (from :func:`create_train_state`), in place:
    the params and opt_state through ``tx.update``, the batch_stats
    replaced by the batch's, the step counted. Returns the loss."""
    loss, grads, new_stats = loss_and_grads(model, state, x, labels)
    tx.update(state["params"], grads, state["opt_state"])
    state["batch_stats"] = new_stats
    state["step"] += 1
    return loss
