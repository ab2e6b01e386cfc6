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

Expert parallelism (``mesh=``): the JAX layer leaves it to GSPMD, which
routes over the global token axis and places the expert buffers by the
sharding constraint ("expert", None, None). The port does it explicitly
on local shards: :func:`route` gathers the router logits over the axes the
tokens split on and routes the global token axis on every rank,
:func:`expert_block` runs a rank's experts on its own tokens' rows, and
:func:`moe_ffn` sums the blocks over the expert and MLP axes. Tokens are
replicated over the expert axes, so no token moves between ranks.

The ``torch.profiler`` ranges ``moe.ffn`` (the whole layer) and
``moe.experts`` (the expert products and activation) let a profile split
the expert products from routing, dispatch and combine.
"""

from __future__ import annotations

from typing import Callable, Optional, Sequence, Tuple

import torch
import torch.nn.functional as F
from torch.profiler import record_function

from . import collectives as coll
from .sharding import (
    DEFAULT_RULES,
    Rule,
    entry_axes,
    logical_to_spec,
    with_logical_constraint,
)

# Logical axes of an expert weight [E, M, F] (``w_gate``, ``w_up``; the
# model stacks them on a leading "layers" axis).
EXPERT_WEIGHT_AXES = ("expert", "embed", "mlp")


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


def token_axes(rules: Sequence[Rule] = DEFAULT_RULES,
               ) -> Tuple[Tuple[str, ...], Tuple[str, ...]]:
    """(the mesh axes the batch splits over, those the sequence splits
    over) under ``rules``."""
    batch, seq = logical_to_spec(("batch", "seq"), rules)
    return entry_axes(batch), entry_axes(seq)


def weight_axes(rules: Sequence[Rule] = DEFAULT_RULES,
                ) -> Tuple[Tuple[str, ...], Tuple[str, ...]]:
    """(the mesh axes the experts split over, those each expert's MLP
    columns split over) under ``rules``. Tokens must be replicated over the
    expert axes: a rule that splits both raises ``ValueError`` (JAX would
    accept it and move the tokens with an all-to-all; the port has none)."""
    spec = logical_to_spec(("layers",) + EXPERT_WEIGHT_AXES, rules)
    expert, mlp = entry_axes(spec[1]), entry_axes(spec[3])
    clash = set(expert) & set(sum(token_axes(rules), ()))
    if clash:
        raise ValueError(f"mesh axes {sorted(clash)} split both the tokens "
                         f"and the experts")
    return expert, mlp


def route(
    x: torch.Tensor,            # [B, S, M]
    router_w: torch.Tensor,     # [M, E]
    *,
    k: int = 2,
    capacity_factor: float = 1.25,
    token_mask: Optional[torch.Tensor] = None,  # [B, S], 1 = route
    mesh=None,
    rules: Sequence[Rule] = DEFAULT_RULES,
) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """The router and :func:`top_k_routing` of ``x``'s tokens: (dispatch
    [B*S, E, C], combine [B*S, E, C], aux_loss).

    Under ``mesh`` ``x`` is this rank's [B/(dp*fsdp), S/sp, M] piece. As
    GSPMD does for the JAX layer, the routing is over the global token
    axis: the float32 logits and the mask are all-gathered over the axes
    the tokens split on and put back together as [B, S, E] (under ``sp`` a
    rank's window is not contiguous in the flat b*S + s order), so the
    capacity comes from the global token count, queue positions are
    counted in the global choice-major order, and the aux loss takes the
    global means. Every rank computes the same decisions and keeps its own
    tokens' rows. The gather's backward sums the logits' gradient over the
    ranks, so the aux loss, which every rank computes, counts once."""
    B, S, M = x.shape
    E = router_w.shape[1]
    logits = x.reshape(B * S, M).to(torch.float32) @ router_w.to(
        torch.float32)
    if mesh is None:
        capacity = max(1, int(capacity_factor * k * B * S / E))
        return top_k_routing(
            logits, k, capacity,
            token_mask=None if token_mask is None else token_mask.reshape(-1))
    batch, seq = token_axes(rules)

    def gather(t):  # [B, S, ...] local -> global
        if seq:
            t = coll.allgather(t, seq, gather_dim=1, mesh=mesh)
        return coll.allgather(t, batch, mesh=mesh) if batch else t

    logits = gather(logits.reshape(B, S, E))
    Bg, Sg = logits.shape[:2]
    capacity = max(1, int(capacity_factor * k * Bg * Sg / E))
    mask = None
    if token_mask is not None:
        mask = gather(token_mask.to(torch.float32)).reshape(-1)
    dispatch, combine, aux = top_k_routing(logits.reshape(Bg * Sg, E), k,
                                           capacity, token_mask=mask)
    b0 = coll.axis_index(batch, mesh=mesh) * B if batch else 0
    s0 = coll.axis_index(seq, mesh=mesh) * S if seq else 0

    def mine(t):  # this rank's tokens' rows
        return t.reshape(Bg, Sg, E, capacity)[b0:b0 + B, s0:s0 + S].reshape(
            B * S, E, capacity)

    return mine(dispatch), mine(combine), aux


def expert_block(
    xt: torch.Tensor,           # [T, M]
    dispatch: torch.Tensor,     # [T, E, C]
    combine: torch.Tensor,      # [T, E, C]
    w_in: torch.Tensor,         # [E_loc, M, F]
    w_out: torch.Tensor,        # [E_loc, F, M]
    w_gate: Optional[torch.Tensor] = None,  # [E_loc, M, F]
    *,
    first_expert: int = 0,
    activation: Callable[[torch.Tensor], torch.Tensor] = F.silu,
    mesh=None,
    rules: Sequence[Rule] = DEFAULT_RULES,
) -> torch.Tensor:
    """Experts ``first_expert .. first_expert + E_loc - 1`` on the routed
    rows: dispatch to [E_loc, C, M] buffers, the (SwiGLU) products, and
    the combine into [T, M], this block's part of the layer's output. A
    buffer slot that no token of ``xt`` fills holds a zero row (and the
    FFN maps it to zero: SiLU(0) * 0 = 0), and the combine gives it weight
    zero, so the blocks of all experts sum to the whole layer, on one card
    or across ranks. Under ``mesh`` the buffers
    are checked against the logical axes ("expert", None, None) of the
    global [E, C, M] (JAX's sharding constraint there)."""
    E_loc, C = w_in.shape[0], dispatch.shape[2]
    mine = slice(first_expert, first_expert + E_loc)
    expert_in = torch.einsum("tec,tm->ecm", dispatch[:, mine].to(xt.dtype),
                             xt)
    check = dict(mesh=mesh, rules=rules,
                 global_shape=(dispatch.shape[1], C, xt.shape[1]))
    with_logical_constraint(expert_in, ("expert", None, None), **check)
    with record_function("moe.experts"):
        h = torch.bmm(expert_in, w_in)                          # [E, C, F]
        if w_gate is not None:
            h = activation(torch.bmm(expert_in, w_gate)) * h
        else:
            h = activation(h)
        expert_out = torch.bmm(h, w_out)                        # [E, C, M]
    with_logical_constraint(expert_out, ("expert", None, None), **check)
    return torch.einsum("tec,ecm->tm", combine[:, mine].to(xt.dtype),
                        expert_out)


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
    mesh=None,
    rules: Sequence[Rule] = DEFAULT_RULES,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """The MoE feed-forward block, Mixtral-style when ``w_gate`` is given.
    Returns (out [B, S, M] in ``x.dtype``, aux_loss float32 scalar).

    Under ``mesh`` (expert parallelism) ``x`` is this rank's [B/(dp*fsdp),
    S/sp, M] piece and the expert weights are its [E/ep, M, F/tp] slices:
    the routing is global (:func:`route`), the rank's experts run on its
    tokens' rows (:func:`expert_block`), and the partial outputs are summed
    over the expert and MLP axes at one reduce point. Tokens are replicated
    over ``ep`` (the batch splits over dp and fsdp), so no token moves:
    each rank multiplies C rows of the global capacity for each of its
    experts, the zero rows of other ranks' tokens included."""
    B, S, M = x.shape
    with record_function("moe.ffn"):
        dispatch, combine, aux = route(
            x, router_w, k=k, capacity_factor=capacity_factor,
            token_mask=token_mask, mesh=mesh, rules=rules)
        first, reduce_axes = 0, ()
        if mesh is not None:
            expert, mlp = weight_axes(rules)
            if expert:
                first = coll.axis_index(expert, mesh=mesh) * w_in.shape[0]
            reduce_axes = expert + mlp
        out = expert_block(x.reshape(B * S, M), dispatch, combine, w_in,
                           w_out, w_gate, first_expert=first,
                           activation=activation, mesh=mesh, rules=rules)
        if reduce_axes:
            out = coll.allreduce(out, reduce_axes, mesh=mesh)
    return out.reshape(B, S, M), aux
