"""Pipeline parallelism: the GPipe schedule over the ``pp`` mesh axis
(counterpart of ``ray_tpu/parallel/pipeline.py``).

Each rank of the ``pp`` axis holds one stage's parameters. The schedule
runs ``n_micro + n_stages - 1`` ticks: at tick t stage 0 takes microbatch
t, every stage runs its stage function on what it holds, and the outputs
move one stage on with ``collectives.ppermute`` over the non-cyclic
permutation [(i, i+1)] (stage 0 receives zeros); the last stage finishes
microbatch t - (n_stages - 1). The ends of the schedule are the bubble,
where stages run on zeros, as in JAX.

JAX writes the schedule as a ``lax.scan`` inside ``shard_map`` and gets
the pipelined backward from ``jax.grad``. The port runs the same ticks as a
Python loop on every rank; autograd records them, and each collective's
backward is JAX's transpose (``collectives.py``), so one backward pass on
every rank gives each stage JAX's gradients: the sequential stack's. As in
the rest of the port, each rank backpropagates its loss divided by the
world size. Stage 0 chooses between its microbatch and the received state
with ``torch.where``, as JAX's ``jnp.where`` does, so every rank's graph
reaches every permutation and every rank joins each backward hop.
"""

from __future__ import annotations

from typing import Any, Callable

import torch
from torch.utils.checkpoint import checkpoint

from . import collectives as coll


def _tree_map(fn: Callable, tree):
    """``fn`` over the tensors of a tree of dicts, lists and tuples."""
    if isinstance(tree, dict):
        return {k: _tree_map(fn, v) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return type(tree)(_tree_map(fn, v) for v in tree)
    return fn(tree)


def pipeline_shard(
    stage_fn: Callable[[Any, torch.Tensor], torch.Tensor],
    stage_params: Any,          # this rank's stage parameters
    x: torch.Tensor,            # [n_micro, mb, ...] microbatches (replicated)
    *,
    axis_name: str = "pp",
    remat: bool = True,
    mesh=None,
) -> torch.Tensor:
    """Run the schedule on this rank (JAX: call inside ``shard_map``).
    Returns this stage's [n_micro, mb, ...] output buffer, which holds the
    pipeline's result only on the last stage (callers select it, as
    :func:`pipeline_apply` does). ``remat`` runs each stage call under
    non-reentrant ``torch.utils.checkpoint`` (JAX's ``jax.checkpoint``)."""
    n_stages = coll.axis_size(axis_name, mesh=mesh)
    first = torch.tensor(coll.axis_index(axis_name, mesh=mesh) == 0,
                         device=x.device)
    n_micro = x.shape[0]
    ticks = n_micro + n_stages - 1
    if remat:
        def body(p, h):
            return checkpoint(stage_fn, p, h, use_reentrant=False)
    else:
        body = stage_fn
    perm = [(i, i + 1) for i in range(n_stages - 1)]
    state = torch.zeros_like(x[0])
    outs = [None] * n_micro
    for t in range(ticks):
        out = body(stage_params, torch.where(first, x[min(t, n_micro - 1)],
                                             state))
        done = t - (n_stages - 1)
        if done >= 0:
            outs[done] = out
        if t < ticks - 1:  # the last tick's hand-over would go unused
            state = coll.ppermute(out, axis_name, perm, mesh=mesh)
    return torch.stack(outs)


def pipeline_apply(
    stage_fn: Callable[[Any, torch.Tensor], torch.Tensor],
    stacked_params: Any,        # this rank's stage slice: leading dim 1
    x: torch.Tensor,            # [batch, ...] global input (replicated)
    mesh,
    *,
    n_microbatches: int,
    axis_name: str = "pp",
    remat: bool = True,
) -> torch.Tensor:
    """The pipeline over the whole batch: splits ``x`` into
    ``n_microbatches``, runs :func:`pipeline_shard` with this rank's stage
    (``stacked_params`` holds its slice of the stage-stacked tree, leading
    dim 1 on every leaf: :func:`pipeline_stage_params_spec`), and returns
    the [batch, ...] outputs, replicated over ``axis_name`` (the last
    stage's buffer, selected by a masked sum over the axis)."""
    B = x.shape[0]
    if B % n_microbatches:
        raise ValueError(f"a batch of {B} does not split into "
                         f"{n_microbatches} microbatches")
    xm = x.reshape(n_microbatches, B // n_microbatches, *x.shape[1:])
    mine = _tree_map(lambda p: p[0], stacked_params)
    outbuf = pipeline_shard(stage_fn, mine, xm, axis_name=axis_name,
                            remat=remat, mesh=mesh)
    last = coll.axis_index(axis_name, mesh=mesh) == coll.axis_size(
        axis_name, mesh=mesh) - 1
    out = coll.allreduce(outbuf * float(last), axis_name, mesh=mesh)
    return out.reshape(B, *out.shape[2:])


def pipeline_stage_params_spec(stacked_params: Any, axis_name: str = "pp"):
    """The spec of every leaf of stage-stacked parameters: the leading
    (stage) dim split over ``axis_name`` (``sharding.py``'s tuple specs)."""
    return _tree_map(lambda _: (axis_name,), stacked_params)
