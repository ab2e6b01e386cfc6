"""Paged-attention decode: a hand-written CUDA kernel for Hopper.

Counterpart of ``ray_tpu/ops/paged_attention.py::paged_decode_attention``
(TPU kernel ``_paged_decode_kernel``): one query token per slot attends,
with GQA, over the slot's keys at positions 0..lengths[b], read page by
page from the shared pool through the slot's page table, without writing a
gathered copy to device memory. The kernel is ``csrc/paged_decode.cu``; its
note says what bounds it on the H100 and what its design does about that.

On a CUDA tensor the wrapper launches the kernel or raises. On a CPU tensor
it runs :func:`paged_decode_reference`, the plain PyTorch version (gather
the slot's pages, attend densely), which ``chip_smoke.py`` holds the kernel
against. ``launches`` counts kernel launches and nothing else.

The bf16 kernel splits each slot's page walk across :func:`paged_splits`
blocks and merges them in the same launch through a float32 workspace and
one ticket counter per (slot, KV head); the wrapper keeps both across calls
(:func:`_workspace`), and every launch leaves the counters at 0.

Unlike the TPU kernel this one takes any page size and any head dim up to
256 (the TPU's ``pageable`` rule was a tiling rule of that chip).
"""

from __future__ import annotations

from typing import Optional

import torch

from . import _build
from .flash_attention import H100_SMS, _sm_count, masked_attention_f32

# Kernel launches since import (reset by callers that count a run).
launches = 0

# The split rule's floor on a split's share of the table, in tokens.
MIN_SPLIT_TOKENS = 32


def paged_splits(B: int, Hkv: int, Pmax: int, page: int,
                 sms: int = H100_SMS) -> int:
    """Blocks each (slot, KV head) page walk is split across in the bf16
    kernel: enough for two blocks an SM over the B x Hkv walks, but no more
    than one per ``MIN_SPLIT_TOKENS`` tokens the table can name (Pmax *
    page), so the merge stays small against the walk. Fixed from the shapes
    alone: the lengths live on the card and the host does not read them.
    Each block takes its share of its slot's actual pages, whatever the
    slot's length."""
    want = -(-2 * sms // (B * Hkv))
    most = -(-Pmax * page // MIN_SPLIT_TOKENS)
    return max(1, min(want, most))


# (device, stream) -> (float32 workspace, int32 counters): kept across
# launches, grown when a launch needs more. The counters start at zero and
# every launch leaves them at zero.
_workspaces = {}


def _workspace(device: torch.device, stream: int, floats: int, pairs: int):
    """The split kernel's workspace (at least ``floats`` float32) and its
    ticket counters (at least ``pairs`` int32, zero) for launches on
    ``stream`` of ``device``."""
    key = (device, stream)
    ws, counters = _workspaces.get(key, (None, None))
    if ws is None or ws.numel() < floats:
        ws = torch.empty(max(floats, 1), dtype=torch.float32, device=device)
    if counters is None or counters.numel() < pairs:
        counters = torch.zeros(pairs, dtype=torch.int32, device=device)
    _workspaces[key] = (ws, counters)
    return ws, counters


def paged_decode_reference(
    q: torch.Tensor,           # [B, H, D]
    k_pool: torch.Tensor,      # [Hkv, P, page, D] or [L, Hkv, P, page, D]
    v_pool: torch.Tensor,
    page_table: torch.Tensor,  # [B, Pmax] int32
    lengths: torch.Tensor,     # [B] int32
    *,
    layer: Optional[int] = None,
    scale: Optional[float] = None,
) -> torch.Tensor:
    """The plain version: gather each slot's pages into its logical
    [T = Pmax * page] window and attend to positions <= lengths[b], in
    float32. Page ids are clamped into the pool, as the kernel clamps them;
    the JAX gather path (``jnp.take``) would read NaN for an id outside the
    pool instead."""
    if layer is not None:
        k_pool, v_pool = k_pool[layer], v_pool[layer]
    B, H, D = q.shape
    Hkv, P, page, _ = k_pool.shape
    scale = scale if scale is not None else D ** -0.5
    pt = page_table.long().clamp(0, P - 1)
    T = pt.shape[1] * page
    # [Hkv, B, Pmax, page, D] -> [B, Hkv, T, D]
    kp = k_pool[:, pt].permute(1, 0, 2, 3, 4).reshape(B, Hkv, T, D)
    vp = v_pool[:, pt].permute(1, 0, 2, 3, 4).reshape(B, Hkv, T, D)
    rep = H // Hkv
    qg = q.float().reshape(B, Hkv, rep, D) * scale
    mask = (torch.arange(T, device=q.device)[None, :]
            <= lengths.long()[:, None])[:, None, None, :]   # [B,1,1,T]
    out, _ = masked_attention_f32(qg, kp, vp, mask)
    return out.reshape(B, H, D).to(q.dtype)


def _check(q, k_pool, v_pool, page_table, lengths):
    if q.dim() != 3 or k_pool.dim() != 4 or k_pool.shape != v_pool.shape:
        raise ValueError(
            f"q must be [B, H, D] and the pools [Hkv, P, page, D]; got q "
            f"{tuple(q.shape)}, k_pool {tuple(k_pool.shape)}, v_pool "
            f"{tuple(v_pool.shape)}")
    B, H, D = q.shape
    Hkv = k_pool.shape[0]
    if k_pool.shape[3] != D or H % Hkv:
        raise ValueError(f"q {tuple(q.shape)} does not fit pool "
                         f"{tuple(k_pool.shape)}")
    if page_table.dim() != 2 or page_table.shape[0] != B or \
            lengths.shape != (B,):
        raise ValueError("page_table must be [B, Pmax] and lengths [B]")
    if D > 256:
        raise ValueError(f"head dim {D} > 256 is not supported")
    devices = {t.device for t in (q, k_pool, v_pool, page_table, lengths)}
    if len(devices) != 1:
        raise ValueError(f"all inputs must be on one device, got {devices}")


def launch(lib, q, k_pool, v_pool, page_table, lengths, *, scale, stream):
    """Launch ``csrc/paged_decode.cu`` through ``lib``; returns the output
    allocated here."""
    B, H, D = q.shape
    Hkv, P, page, _ = k_pool.shape
    Pmax = page_table.shape[1]
    splits = paged_splits(B, Hkv, Pmax, page, _sm_count(q.device))
    ws, counters = _workspace(q.device, stream,
                              B * Hkv * splits * (H // Hkv) * (D + 2),
                              B * Hkv)
    out = torch.empty_like(q)
    code = lib.rtt_paged_decode(
        _build.DTYPE_CODES[q.dtype], q.data_ptr(), k_pool.data_ptr(),
        v_pool.data_ptr(), page_table.data_ptr(), lengths.data_ptr(),
        out.data_ptr(), B, H, Hkv, P, page, Pmax, D, float(scale), stream,
        splits, ws.data_ptr(), counters.data_ptr())
    _build.check(lib, code, "paged_decode")
    return out


def paged_decode_attention(
    q: torch.Tensor,           # [B, H, D] one query row per slot
    k_pool: torch.Tensor,      # [Hkv, P, page, D] or [L, Hkv, P, page, D]
    v_pool: torch.Tensor,      # (with ``layer`` naming the L index)
    page_table: torch.Tensor,  # [B, Pmax] int32
    lengths: torch.Tensor,     # [B] int32 — key positions <= lengths[b]
    *,
    layer: Optional[int] = None,
    scale: Optional[float] = None,
) -> torch.Tensor:
    """Returns [B, H, D]. The caller has already written the current
    token's K/V into each slot's page cell, so ``lengths`` is the length
    before the increment and position ``lengths[b]`` holds the new token.
    With ``layer``, the kernel reads that layer's view of the full pool (a
    view: nothing is copied)."""
    global launches
    if layer is not None:
        k_pool, v_pool = k_pool[layer], v_pool[layer]
    _check(q, k_pool, v_pool, page_table, lengths)
    scale = scale if scale is not None else q.shape[-1] ** -0.5
    if q.device.type == "cpu":
        return paged_decode_reference(q, k_pool, v_pool, page_table, lengths,
                                      scale=scale)
    if q.device.type != "cuda":
        raise ValueError(f"paged_decode_attention runs on cuda or cpu, "
                         f"not {q.device}")
    if q.dtype not in _build.DTYPE_CODES or not (
            q.dtype == k_pool.dtype == v_pool.dtype):
        raise ValueError(f"paged_decode_attention takes float32 or bfloat16 "
                         f"q and pools of one dtype, got {q.dtype}, "
                         f"{k_pool.dtype}, {v_pool.dtype}")
    if page_table.dtype != torch.int32 or lengths.dtype != torch.int32:
        raise ValueError("page_table and lengths must be int32")
    if not all(t.is_contiguous()
               for t in (q, k_pool, v_pool, page_table, lengths)):
        raise ValueError("paged_decode_attention needs contiguous inputs")
    lib = _build.library()
    with torch.cuda.device(q.device):
        out = launch(lib, q, k_pool, v_pool, page_table, lengths,
                     scale=scale, stream=_build.current_stream(q))
    launches += 1
    return out
