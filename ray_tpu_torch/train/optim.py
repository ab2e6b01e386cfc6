"""AdamW equal to ``optax.adamw(learning_rate)``, updating in place.

optax's defaults: b1 0.9, b2 0.999, eps 1e-8 added to sqrt(nu_hat),
eps_root 0, and weight decay 1e-4 on every leaf (its mask is None),
decoupled and scaled by the learning rate:

    mu = b1 mu + (1 - b1) g          nu = b2 nu + (1 - b2) g^2
    p -= lr * (mu / (1 - b1^t) / (sqrt(nu / (1 - b2^t)) + eps) + wd * p)

The moments are kept in the parameters' dtype, as optax's ``mu_dtype=None``
does (bf16 moments for bf16 weights, float32 for the norms and the MoE
router). torch's AdamW
computes the same update (its weight decay multiplies p by 1 - lr * wd
before the Adam step, which is the same sum); its defaults differ
(weight decay 1e-2), so every argument is passed. The update runs as
torch's fused AdamW: one multi-tensor kernel that reads p, g, mu and nu and
writes p, mu and nu once each, computing in float32 and rounding once per
stored tensor. It is an optimizer, not a TPU kernel: JAX runs it as
XLA-fused elementwise code outside Pallas.
"""

from __future__ import annotations

import dataclasses
from typing import Any, Dict, List

import torch

Params = Dict[str, Any]


def leaves(tree: Params) -> List[torch.Tensor]:
    """The tensors of a parameter tree in a fixed order: a dict's entries
    by sorted key, a list's or tuple's in order (RLlib's trees are dicts of
    lists of ``(W, b)`` tuples)."""
    if isinstance(tree, dict):
        return [x for k in sorted(tree) for x in leaves(tree[k])]
    if isinstance(tree, (list, tuple)):
        return [x for v in tree for x in leaves(v)]
    return [tree]


def zeros_like_tree(tree: Params) -> Params:
    if isinstance(tree, dict):
        return {k: zeros_like_tree(v) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return type(tree)(zeros_like_tree(v) for v in tree)
    return torch.zeros_like(tree)


@dataclasses.dataclass
class AdamState:
    """optax's ``ScaleByAdamState``: the step count and the two moments, in
    the parameters' tree, shapes and dtypes. Updated in place."""
    count: int
    mu: Params
    nu: Params


@dataclasses.dataclass(frozen=True)
class AdamW:
    """``optax.adamw(learning_rate)`` with optax's defaults."""
    learning_rate: float = 1e-3
    b1: float = 0.9
    b2: float = 0.999
    eps: float = 1e-8
    weight_decay: float = 1e-4

    def init(self, params: Params) -> AdamState:
        return AdamState(0, zeros_like_tree(params), zeros_like_tree(params))

    @torch.no_grad()
    def update(self, params: Params, grads: Params,
               state: AdamState) -> None:
        """One step: params, state.mu and state.nu change in place and
        state.count goes up by one."""
        ps = leaves(params)
        opt = torch.optim.AdamW(
            ps, lr=self.learning_rate, betas=(self.b1, self.b2),
            eps=self.eps, weight_decay=self.weight_decay, fused=True)
        for p, g, m, v in zip(ps, leaves(grads), leaves(state.mu),
                              leaves(state.nu)):
            p.grad = g
            opt.state[p] = {
                # A fill on the device: torch.tensor(...) would copy from
                # the host and wait for the stream.
                "step": torch.full((), float(state.count), device=p.device),
                "exp_avg": m, "exp_avg_sq": v}
        try:
            opt.step()
        finally:
            for p in ps:
                p.grad = None
        state.count += 1
