"""Attention in plain PyTorch (local, single shard).

Counterpart of ``ray_tpu/ops/attention.py::mha_attention``: one einsum
for the scores in float32, masking with ``-inf``, softmax, one einsum for
the output. A fully masked row therefore gives NaN, as in the JAX code.
``attention_block_accumulate`` and ``attention_finalize`` are the online
softmax step against one KV block and its end: the plain block step of
ring attention (``parallel/ring_attention.py``) on CPU tensors.
"""

from __future__ import annotations

from typing import Optional

import torch


def mha_attention(
    q: torch.Tensor,  # [B, Sq, H, D]
    k: torch.Tensor,  # [B, Skv, Hkv, D]
    v: torch.Tensor,  # [B, Skv, Hkv, D]
    *,
    causal: bool = False,
    scale: Optional[float] = None,
    q_offset: int = 0,
    kv_offset: int = 0,
    bias: Optional[torch.Tensor] = None,
) -> torch.Tensor:
    """Multi-head attention with optional GQA (Hkv divides H) and causal
    masking in global coordinates: query i sits at q_offset + i, key j at
    kv_offset + j."""
    B, Sq, H, D = q.shape
    Hkv = k.shape[2]
    scale = scale if scale is not None else D ** -0.5
    if Hkv != H:
        if H % Hkv:
            raise ValueError(f"GQA requires H % Hkv == 0, got H={H} Hkv={Hkv}")
        rep = H // Hkv
        k = k.repeat_interleave(rep, dim=2)
        v = v.repeat_interleave(rep, dim=2)
    scores = torch.einsum("bqhd,bkhd->bhqk", q.float(), k.float()) * scale
    if bias is not None:
        scores = scores + bias
    if causal:
        q_pos = q_offset + torch.arange(Sq, device=q.device)[:, None]
        k_pos = kv_offset + torch.arange(k.shape[1], device=q.device)[None, :]
        scores = scores.masked_fill(~(k_pos <= q_pos), float("-inf"))
    probs = torch.softmax(scores, dim=-1).to(q.dtype)
    return torch.einsum("bhqk,bkhd->bqhd", probs, v)


def attention_block_accumulate(
    q: torch.Tensor,    # [B, Sq, H, D]
    k: torch.Tensor,    # [B, Skv, H, D]
    v: torch.Tensor,    # [B, Skv, H, D]
    m: torch.Tensor,    # [B, H, Sq]    running max (start: -inf)
    l: torch.Tensor,    # [B, H, Sq]    running denominator (start: 0)
    acc: torch.Tensor,  # [B, Sq, H, D] running numerator (start: 0)
    *,
    scale: float,
    mask: Optional[torch.Tensor] = None,  # [Sq, Skv] True = attend
):
    """One online-softmax (flash) accumulation step against a KV block:
    (m, l, acc) updated. Rows masked so far have m = -inf; the guards keep
    them at l = 0, acc = 0 without a NaN (JAX ``attention.py:57-89``)."""
    scores = torch.einsum("bqhd,bkhd->bhqk", q.float(), k.float()) * scale
    if mask is not None:
        scores = scores.masked_fill(~mask, float("-inf"))
    m_new = torch.maximum(m, scores.amax(dim=-1))
    safe_m = torch.where(torch.isfinite(m_new), m_new, torch.zeros_like(m_new))
    correction = torch.where(torch.isfinite(m), torch.exp(m - safe_m),
                             torch.zeros_like(m))
    p = torch.where(torch.isfinite(scores),
                    torch.exp(scores - safe_m[..., None]),
                    torch.zeros_like(scores))  # [B, H, Sq, Skv]
    l_new = l * correction + p.sum(dim=-1)
    acc_new = (acc * correction.transpose(1, 2)[..., None]
               + torch.einsum("bhqk,bkhd->bqhd", p.to(v.dtype), v))
    return m_new, l_new, acc_new


def attention_finalize(l: torch.Tensor, acc: torch.Tensor) -> torch.Tensor:
    """Divide the numerator by the accumulated denominator (clamped at
    1e-37, so a row that saw no key gives 0)."""
    denom = torch.clamp(l, min=1e-37).transpose(1, 2)[..., None]
    return (acc / denom).to(acc.dtype)
