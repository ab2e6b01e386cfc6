"""Ring and Ulysses attention: sequence-parallel exact attention
(counterpart of ``ray_tpu/parallel/ring_attention.py``).

The sequence is split over the mesh axis ``sp`` in contiguous blocks: rank
``my`` holds positions ``[my*Sl, (my+1)*Sl)`` of Q, K and V [B, Sl, H, D].
The ring takes n steps; between steps each rank passes its KV block one hop
on (to ``my + 1``), so every query block meets every KV block while a rank
holds O(S/n) of the sequence. Under causal masking a KV block strictly
ahead of the query block is skipped, as in JAX (no zigzag or striped
layout: the reference has none).

- On CPU tensors each step is ``attention_block_accumulate`` and the end
  ``attention_finalize`` (``ops/attention.py``), as in JAX; autograd
  differentiates them, and the KV rotations are one autograd Function
  whose backward passes the KV gradients back around the ring.
- On CUDA tensors the ring is one ``torch.autograd.Function``
  (:func:`flash_ring_attention_shard`). Each step is the flash forward
  kernel on the KV block at its global offsets (the kernel masks in global
  coordinates), and the (O, lse) pairs merge by log-sum-exp
  (:func:`merge_block`). The backward runs the flash backward kernels (dQ,
  then dK/dV on the grid the ``dkv_per_head`` rule picks) once per block
  the forward computed, with the merged O and the global lse, so each
  block's P = exp(S - lse) is its part of the global softmax. dK/dV
  accumulate in float32 while they travel the ring with their KV block and
  are cast once at home.

Ulysses attention trades the n KV hops for two all-to-alls: it reshards
[B, S/n, H, D] to [B, S, H/n, D], attends locally over the whole sequence
(``flash_attention``: the kernel on the card, its plain version on the
CPU) and reshards back. It needs H (and Hkv) divisible by n.
"""

from __future__ import annotations

from typing import Optional, Tuple

import torch

from ..ops import flash_attention as fa
from ..ops.attention import attention_block_accumulate, attention_finalize
from .collectives import _mesh, _permute, all_to_all, axis_index, axis_size


def visible(my: int, kv_idx: int, causal: bool) -> bool:
    """Whether query block ``my`` sees any key of KV block ``kv_idx``
    (contiguous layout): every block without causal masking, else the
    blocks at or before it."""
    return not causal or kv_idx <= my


def merge_block(o: Optional[torch.Tensor], lse: Optional[torch.Tensor],
                o_blk: torch.Tensor, lse_blk: torch.Tensor,
                ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Merge one KV block's attention (O [B, Sq, H, D], lse [B*H, Sq]
    float32, as the flash forward returns them) into the running (O float32,
    lse); ``o=None`` starts the run. The weights are exp(lse_i - lse_new);
    a row with no key in either part (lse -inf) keeps weight 0 instead of
    exp(-inf - -inf)."""
    if o is None:
        return o_blk.float(), lse_blk
    B, Sq, H, _ = o_blk.shape
    new = torch.logaddexp(lse, lse_blk)
    safe = torch.where(torch.isfinite(new), new, torch.zeros_like(new))

    def weight(part):  # [B*H, Sq] -> [B, Sq, H, 1]
        w = torch.where(torch.isfinite(part), torch.exp(part - safe),
                        torch.zeros_like(part))
        return w.view(B, H, Sq).transpose(1, 2)[..., None]

    return o * weight(lse) + o_blk.float() * weight(lse_blk), new


def _hop(x: torch.Tensor, group, me: int, n: int, offset: int = 1):
    """Pass ``x`` ``offset`` hops round the ring (no autograd)."""
    return _permute(x, group, me, [(i, (i + offset) % n) for i in range(n)])


class _Rotations(torch.autograd.Function):
    """The KV block after 0, 1, ..., n-1 hops (block ``(my - s) % n`` at
    index s). One Function, so every rank runs its backward (the inverse
    hops, the gradients summed on the way) even where a causal rank uses
    only its own block: a collective every rank must join."""

    @staticmethod
    def forward(ctx, x, group, me, n):
        ctx.args = (group, me, n)
        outs = [x.contiguous()]
        for _ in range(n - 1):
            outs.append(_hop(outs[-1], group, me, n))
        return tuple(outs)

    @staticmethod
    def backward(ctx, *grads):
        group, me, n = ctx.args
        carry = grads[-1].contiguous()
        for g in reversed(grads[:-1]):
            carry = _hop(carry, group, me, n, -1) + g
        return carry, None, None, None


def _plain_ring(q, k, v, mesh, axis_name, causal, scale):
    B, Sl, H, D = q.shape
    Hkv = k.shape[2]
    if Hkv != H:
        k = k.repeat_interleave(H // Hkv, dim=2)
        v = v.repeat_interleave(H // Hkv, dim=2)
    n = axis_size(axis_name, mesh=mesh)
    my = axis_index(axis_name, mesh=mesh)
    group = mesh.get_group(axis_name)
    ks = _Rotations.apply(k, group, my, n)
    vs = _Rotations.apply(v, group, my, n)
    m = torch.full((B, H, Sl), float("-inf"), device=q.device)
    l = torch.zeros((B, H, Sl), device=q.device)
    acc = torch.zeros((B, Sl, H, D), device=q.device)
    q_pos = my * Sl + torch.arange(Sl, device=q.device)
    for s in range(n):
        kv_idx = (my - s) % n
        if not visible(my, kv_idx, causal):
            continue
        mask = None
        if causal:
            k_pos = kv_idx * Sl + torch.arange(Sl, device=q.device)
            mask = k_pos[None, :] <= q_pos[:, None]
        m, l, acc = attention_block_accumulate(q, ks[s], vs[s], m, l, acc,
                                               scale=scale, mask=mask)
    return attention_finalize(l, acc).to(q.dtype)


class _RingFlash(torch.autograd.Function):
    """The ring through the flash kernels, forward and backward."""

    @staticmethod
    def forward(ctx, q, k, v, group, my, n, causal, scale):
        Sl = q.shape[1]
        q = q.contiguous()
        kv = torch.stack([k, v])
        o = lse = None
        for s in range(n):
            kv_idx = (my - s) % n
            if visible(my, kv_idx, causal):
                o_b, lse_b = fa.flash_attention_fwd(
                    q, kv[0], kv[1], causal=causal, scale=scale,
                    q_offset=my * Sl, kv_offset=kv_idx * Sl)
                o, lse = merge_block(o, lse, o_b, lse_b)
            if s < n - 1:
                kv = _hop(kv, group, my, n)
        out = o.to(q.dtype)
        ctx.save_for_backward(q, k, v, out, lse)
        ctx.args = (group, my, n, causal, scale)
        return out

    @staticmethod
    @torch.autograd.function.once_differentiable
    def backward(ctx, dout):
        q, k, v, out, lse = ctx.saved_tensors
        group, my, n, causal, scale = ctx.args
        Sl = q.shape[1]
        dout = dout.contiguous()
        kv = torch.stack([k, v])
        dq = torch.zeros_like(q, dtype=torch.float32)
        dkv = torch.zeros_like(kv, dtype=torch.float32)
        for s in range(n):
            kv_idx = (my - s) % n
            if visible(my, kv_idx, causal):
                dq_b, dk_b, dv_b = fa.flash_attention_bwd(
                    q, kv[0], kv[1], out, lse, dout, causal=causal,
                    scale=scale, q_offset=my * Sl, kv_offset=kv_idx * Sl)
                dq += dq_b
                dkv[0] += dk_b
                dkv[1] += dv_b
            if s < n - 1:
                kv = _hop(kv, group, my, n)
            dkv = _hop(dkv, group, my, n)  # after step n-1: home
        return (dq.to(q.dtype), dkv[0].to(k.dtype), dkv[1].to(v.dtype),
                None, None, None, None, None)


def flash_ring_attention_shard(q, k, v, *, axis_name: str = "sp",
                               causal: bool = False,
                               scale: Optional[float] = None, mesh=None):
    """Ring attention through the flash kernels (the path
    :func:`ring_attention_shard` takes on CUDA tensors); on CPU tensors the
    kernels' plain versions run instead, block for block."""
    mesh = _mesh(mesh)
    scale = scale if scale is not None else q.shape[-1] ** -0.5
    n = axis_size(axis_name, mesh=mesh)
    my = axis_index(axis_name, mesh=mesh)
    return _RingFlash.apply(q, k, v, mesh.get_group(axis_name), my, n,
                            causal, scale)


def ring_attention_shard(
    q: torch.Tensor,  # [B, Sl, H, D] local query block
    k: torch.Tensor,  # [B, Sl, Hkv, D]
    v: torch.Tensor,  # [B, Sl, Hkv, D]
    *,
    axis_name: str = "sp",
    causal: bool = False,
    scale: Optional[float] = None,
    mesh=None,
) -> torch.Tensor:
    """Exact attention of this rank's query block over the whole sequence,
    which lies split over ``axis_name`` (called on every rank of it)."""
    if q.device.type == "cpu":
        scale = scale if scale is not None else q.shape[-1] ** -0.5
        return _plain_ring(q, k, v, _mesh(mesh), axis_name, causal, scale)
    return flash_ring_attention_shard(q, k, v, axis_name=axis_name,
                                      causal=causal, scale=scale, mesh=mesh)


def ulysses_attention_shard(
    q: torch.Tensor,  # [B, Sl, H, D]
    k: torch.Tensor,
    v: torch.Tensor,
    *,
    axis_name: str = "sp",
    causal: bool = False,
    scale: Optional[float] = None,
    mesh=None,
) -> torch.Tensor:
    """DeepSpeed-Ulysses style: all-to-all [B, S/n, H, D] -> [B, S, H/n, D],
    attention over the whole sequence on a head subset, all-to-all back.
    Two all-to-alls instead of n hops; H and Hkv must divide by n."""
    n = axis_size(axis_name, mesh=mesh)
    H, Hkv = q.shape[2], k.shape[2]
    if H % n or Hkv % n:
        raise ValueError(f"ulysses needs heads ({H}) and kv heads ({Hkv}) "
                         f"divisible by {axis_name} ({n})")

    def gather_seq(x):  # split heads, gather the sequence
        return all_to_all(x, axis_name, split_axis=2, concat_axis=1,
                          mesh=mesh)

    out = fa.flash_attention(gather_seq(q), gather_seq(k), gather_seq(v),
                             causal=causal, scale=scale)
    return all_to_all(out, axis_name, split_axis=1, concat_axis=2, mesh=mesh)


def ring_attention(
    q: torch.Tensor,  # [B, Sl, H, D]: this rank's shard
    k: torch.Tensor,
    v: torch.Tensor,
    mesh,
    *,
    causal: bool = False,
    scale: Optional[float] = None,
    impl: str = "ring",
) -> torch.Tensor:
    """The entry the model calls. JAX's takes global arrays and shards them
    under ``shard_map`` (batch over dp+fsdp, sequence over sp, heads over
    tp); here the tensors are already this rank's shards in that layout, so
    it runs the sequence-parallel attention over ``sp`` directly."""
    fns = {"ring": ring_attention_shard, "ulysses": ulysses_attention_shard}
    if impl not in fns:
        raise ValueError(f"impl must be 'ring' or 'ulysses', not {impl!r}")
    return fns[impl](q, k, v, axis_name="sp", causal=causal, scale=scale,
                     mesh=mesh)
