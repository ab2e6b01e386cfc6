"""Mixture-of-experts feed-forward with top-k routing and static capacity.

Counterpart of ``ray_tpu/parallel/moe.py``: Switch/top-k routing where each
expert takes at most ``capacity`` tokens, dispatch and combine as one-hot
products, and the Switch load-balancing loss. The JAX package computes all
of it with ``jnp`` outside any Pallas kernel, so nothing here is a kernel:
the products go to cuBLAS through ``torch.einsum``/``torch.bmm``.

What the port keeps exactly as the reference has it, because outputs depend
on it:
- capacity is ``max(1, int(capacity_factor * k * T / E))`` over all T rows,
  masked or not;
- queue positions count choice-major (every token's first choice, then
  every token's second), so a first choice always beats a second;
- ties in the top-k go to the lower expert index (``jax.lax.top_k``);
  ``torch.topk`` puts the higher index first on the CPU, so the order comes
  from a stable descending sort;
- the router product is float32 (``x`` widened, the router kept float32);
  the expert products, the SiLU and the combine weights are in ``x.dtype``.

Nothing here uses an atomic add: the same inputs route the same way on
every call, which the recompute of a checkpointed layer relies on.

The ``torch.profiler`` ranges ``moe.ffn`` (the whole layer) and
``moe.experts`` (the expert products and activation) let a profile split
the expert products from routing, dispatch and combine.
"""

from __future__ import annotations

from typing import Callable, Optional, Tuple

import torch
import torch.nn.functional as F
from torch.profiler import record_function


def _one_hot(idx: torch.Tensor, n: int) -> torch.Tensor:
    """float32 one-hot of ``idx`` over its last axis (``jax.nn.one_hot``),
    as a comparison: no range check, hence no wait for the device."""
    return (idx.unsqueeze(-1)
            == torch.arange(n, device=idx.device)).to(torch.float32)


def top_k_routing(
    router_logits: torch.Tensor,               # [T, E] float32
    k: int,
    capacity: int,
    token_mask: Optional[torch.Tensor] = None,  # [T], 1 = route, 0 = ignore
) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Dispatch and combine tensors for top-k routing with a capacity per
    expert: (dispatch [T, E, C] of 0/1, combine [T, E, C] gate weights,
    aux_loss scalar). A token whose choice finds its expert full is dropped
    for that choice. Rows with ``token_mask`` 0 claim no capacity and get
    no output (inactive decode slots); they still count in the aux loss's
    means, as in the reference."""
    T, E = router_logits.shape
    probs = torch.softmax(router_logits, dim=-1)
    ordered = probs.sort(dim=-1, descending=True, stable=True)
    gate_vals = ordered.values[:, :k]                          # [T, k]
    onehot = _one_hot(ordered.indices[:, :k].T, E)             # [k, T, E]
    if token_mask is not None:
        onehot = onehot * token_mask.to(torch.float32)[None, :, None]
    flat = onehot.reshape(k * T, E)
    pos = flat.cumsum(dim=0) - flat                            # [k*T, E]
    within_cap = (pos < capacity) * flat
    cap_onehot = _one_hot(pos.clamp(max=capacity - 1).long(), capacity)
    dispatch = (within_cap[..., None] * cap_onehot).reshape(
        k, T, E, capacity).sum(dim=0)                          # [T, E, C]
    gates = (onehot * gate_vals.T[..., None]).reshape(k * T, E)
    combine = ((gates * within_cap)[..., None] * cap_onehot).reshape(
        k, T, E, capacity).sum(dim=0)
    frac = onehot[0].mean(dim=0) if k == 1 else onehot.sum(0).mean(0) / k
    aux_loss = E * torch.sum(frac * probs.mean(dim=0))
    return dispatch, combine, aux_loss


def moe_ffn(
    x: torch.Tensor,            # [B, S, M]
    router_w: torch.Tensor,     # [M, E]
    w_in: torch.Tensor,         # [E, M, F]
    w_out: torch.Tensor,        # [E, F, M]
    *,
    k: int = 2,
    capacity_factor: float = 1.25,
    w_gate: Optional[torch.Tensor] = None,  # [E, M, F]: gated (SwiGLU)
    activation: Callable[[torch.Tensor], torch.Tensor] = F.silu,
    token_mask: Optional[torch.Tensor] = None,  # [B, S], 1 = route
) -> Tuple[torch.Tensor, torch.Tensor]:
    """The MoE feed-forward block, Mixtral-style when ``w_gate`` is given.
    Returns (out [B, S, M] in ``x.dtype``, aux_loss float32 scalar)."""
    B, S, M = x.shape
    E = router_w.shape[1]
    T = B * S
    capacity = max(1, int(capacity_factor * k * T / E))
    xt = x.reshape(T, M)
    with record_function("moe.ffn"):
        router_logits = xt.to(torch.float32) @ router_w.to(torch.float32)
        dispatch, combine, aux = top_k_routing(
            router_logits, k, capacity,
            token_mask=None if token_mask is None else token_mask.reshape(T))
        # Expert sharding over an "ep" mesh axis goes here (the reference's
        # with_logical_constraint), with the parallel/ port.
        expert_in = torch.einsum("tec,tm->ecm", dispatch.to(x.dtype), xt)
        with record_function("moe.experts"):
            h = torch.bmm(expert_in, w_in)                      # [E, C, F]
            if w_gate is not None:
                h = activation(torch.bmm(expert_in, w_gate)) * h
            else:
                h = activation(h)
            expert_out = torch.bmm(h, w_out)                    # [E, C, M]
        out = torch.einsum("tec,ecm->tm", combine.to(x.dtype), expert_out)
    return out.reshape(B, S, M), aux
