"""Flash attention, forward and backward: hand-written CUDA kernels for Hopper.

Counterpart of ``ray_tpu/ops/flash_attention.py``: GQA, causal masking in
global coordinates, O and the per-row logsumexp, with the score matrix
never written to device memory in either direction.

- Forward (``_flash_fwd_kernel``): ``csrc/flash_fwd.cu``,
  :func:`flash_attention_fwd`.
- Backward (``_flash_bwd_dq_kernel`` and ``_flash_bwd_dkv_kernel`` on its
  KV-head and per-query-head grids): ``csrc/flash_bwd.cu``,
  :func:`flash_attention_bwd`. delta = rowsum(dO * O) is a torch op, as it
  is a ``jnp`` op outside Pallas in JAX.
- :func:`flash_attention` goes through a ``torch.autograd.Function`` (the
  counterpart of the ``custom_vjp``): the forward saves q, k, v, O and lse,
  and the backward runs the backward kernels.

Each kernel's note says what bounds it on the H100 and what its design does
about that. On a CUDA tensor a wrapper launches its kernel or raises. On a
CPU tensor it runs the plain PyTorch version of the same function
(:func:`flash_attention_reference`, :func:`flash_attention_bwd_reference`),
which the tests hold against the JAX kernels and ``chip_smoke.py`` holds the
CUDA kernels against. The counters count kernel launches and nothing else:
``launches`` (forward), ``bwd_dq_launches``, ``bwd_dkv_launches`` (KV-head
grid) and ``bwd_dkv_per_head_launches``.
"""

from __future__ import annotations

import ctypes
import functools
from typing import Optional, Tuple

import torch

from . import _build

NEG_INF = -1e30  # the Pallas kernels' _NEG_INF

# Kernel launches since import (reset by callers that count a run).
launches = 0
bwd_dq_launches = 0
bwd_dkv_launches = 0
bwd_dkv_per_head_launches = 0

# The dK/dV grid: None lets :func:`dkv_per_head`'s rule choose; "kv_head"
# or "per_head" forces one (tests and chip_smoke.py set it to hold each
# grid against the plain version and time both).
DKV_GRID: Optional[str] = None

# What the grid rule weighs (dkv_grid_estimates), on the H100 SXM: its SM
# count, its device-memory rate, and the rate at which one SM runs the dK/dV
# kernel's tile steps (flops of whole tiles per second), with tensor cores
# (the wgmma kernel: 3.2e12, its KV-head grid at B=8, S=2048, H=32, Hkv=8,
# D=128 in chip_smoke.py, PERF.md) or without (the scalar kernel, a rough
# 0.25e12). The rule compares two grids of one kernel, so the rate only
# weighs the per-head grid's float32 round trip against tile steps.
H100_SMS = 132
HBM_BYTES_PER_S = 3.35e12
DKV_SM_FLOPS_PER_S = {True: 3.2e12, False: 0.25e12}


def masked_attention_f32(q, k, v, mask) -> Tuple[torch.Tensor, torch.Tensor]:
    """Softmax attention in float32 with the kernels' masking rules.

    q [..., Sq, D] (already scaled), k/v [..., T, D], mask broadcastable to
    [..., Sq, T] (True = attend). Masked entries contribute nothing; a fully
    masked row gives an output of 0 and a logsumexp of -1e30, as the Pallas
    kernels' ``l == 0`` guard does. Returns (out [..., Sq, D] float32,
    lse [..., Sq] float32)."""
    s = q.float() @ k.float().transpose(-1, -2)
    m = s.masked_fill(~mask, float("-inf")).amax(dim=-1)
    m = torch.where(torch.isfinite(m), m, torch.full_like(m, NEG_INF))
    p = torch.exp(s - m[..., None]).masked_fill(~mask, 0.0)
    l = p.sum(dim=-1)
    l_safe = torch.where(l == 0, torch.ones_like(l), l)
    out = (p @ v.float()) / l_safe[..., None]
    return out, m + torch.log(l_safe)


def flash_attention_reference(
    q: torch.Tensor,  # [B, Sq, H, D]
    k: torch.Tensor,  # [B, Skv, Hkv, D]
    v: torch.Tensor,  # [B, Skv, Hkv, D]
    *,
    causal: bool = False,
    scale: Optional[float] = None,
    q_offset: int = 0,
    kv_offset: int = 0,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """The plain PyTorch version of the kernel: (O [B,Sq,H,D] in q's dtype,
    lse [B*H, Sq] float32). Scores, softmax and the output accumulate in
    float32, as the kernel's float32 path does (its bf16 path rounds the
    probabilities to bf16 before the second product).

    One case differs from the Pallas kernel, and both the CUDA kernel and
    this version follow the rule the Pallas kernel states: a fully masked
    row gives O = 0. The Pallas kernel gives that only when the row's whole
    128-row query block is masked; a fully masked row that shares its block
    with a row that sees some key gets the mean of the block's values."""
    B, Sq, H, D = q.shape
    Skv, Hkv = k.shape[1], k.shape[2]
    scale = scale if scale is not None else D ** -0.5
    rep = H // Hkv
    qh = q.float().transpose(1, 2) * scale                       # [B,H,Sq,D]
    kh = k.repeat_interleave(rep, dim=2).transpose(1, 2)         # [B,H,Skv,D]
    vh = v.repeat_interleave(rep, dim=2).transpose(1, 2)
    if causal:
        q_pos = q_offset + torch.arange(Sq, device=q.device)[:, None]
        k_pos = kv_offset + torch.arange(Skv, device=q.device)[None, :]
        mask = k_pos <= q_pos
    else:
        mask = torch.ones((Sq, Skv), dtype=torch.bool, device=q.device)
    out, lse = masked_attention_f32(qh, kh, vh, mask)
    return out.transpose(1, 2).to(q.dtype), lse.reshape(B * H, Sq)


def _check(q, k, v):
    if q.dim() != 4 or k.dim() != 4 or v.dim() != 4:
        raise ValueError("q, k, v must be [B, S, H, D]")
    B, _, H, D = q.shape
    if k.shape != v.shape or k.shape[0] != B or k.shape[3] != D:
        raise ValueError(f"shape mismatch: q {tuple(q.shape)}, "
                         f"k {tuple(k.shape)}, v {tuple(v.shape)}")
    if H % k.shape[2]:
        raise ValueError(f"H ({H}) must be a multiple of Hkv ({k.shape[2]})")
    if D > 256:
        raise ValueError(f"head dim {D} > 256 is not supported")
    if not (q.device == k.device == v.device):
        raise ValueError("q, k, v must be on one device")


def launch(lib, q, k, v, *, causal, scale, q_offset, kv_offset, stream):
    """Launch ``csrc/flash_fwd.cu`` on contiguous q/k/v through ``lib``;
    returns (O, lse) allocated here."""
    B, Sq, H, D = q.shape
    Skv, Hkv = k.shape[1], k.shape[2]
    out = torch.empty_like(q)
    lse = torch.empty((B * H, Sq), dtype=torch.float32, device=q.device)
    # (batch, seq, head) strides of q, k, v and O, in elements.
    strides = (ctypes.c_int64 * 12)(
        *[s for t in (q, k, v, out) for s in t.stride()[:3]])
    code = lib.rtt_flash_fwd(
        _build.DTYPE_CODES[q.dtype], q.data_ptr(), k.data_ptr(),
        v.data_ptr(), out.data_ptr(), lse.data_ptr(), B, H, Hkv, Sq, Skv, D,
        ctypes.addressof(strides), float(scale), int(bool(causal)),
        int(q_offset), int(kv_offset), stream)
    _build.check(lib, code, "flash_fwd")
    return out, lse


def flash_attention_fwd(
    q: torch.Tensor,  # [B, Sq, H, D]
    k: torch.Tensor,  # [B, Skv, Hkv, D]
    v: torch.Tensor,  # [B, Skv, Hkv, D]
    *,
    causal: bool = False,
    scale: Optional[float] = None,
    q_offset: int = 0,
    kv_offset: int = 0,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """(O [B,Sq,H,D], lse [B*H, Sq] float32). The kernel on CUDA tensors,
    the plain version on CPU tensors; anything else raises."""
    global launches
    _check(q, k, v)
    scale = scale if scale is not None else q.shape[-1] ** -0.5
    if q.device.type == "cpu":
        return flash_attention_reference(
            q, k, v, causal=causal, scale=scale, q_offset=q_offset,
            kv_offset=kv_offset)
    if q.device.type != "cuda":
        raise ValueError(
            f"flash_attention runs on cuda or cpu, not {q.device}")
    if q.dtype not in _build.DTYPE_CODES or not (
            q.dtype == k.dtype == v.dtype):
        raise ValueError(f"flash_attention takes float32 or bfloat16 q/k/v of "
                         f"one dtype, got {q.dtype}, {k.dtype}, {v.dtype}")
    if not (q.is_contiguous() and k.is_contiguous() and v.is_contiguous()):
        raise ValueError("flash_attention needs contiguous q, k, v")
    lib = _build.library()
    with torch.cuda.device(q.device):
        out, lse = launch(lib, q, k, v, causal=causal, scale=scale,
                          q_offset=q_offset, kv_offset=kv_offset,
                          stream=_build.current_stream(q))
    launches += 1
    return out, lse


def flash_attention_bwd_reference(
    q: torch.Tensor,     # [B, Sq, H, D]
    k: torch.Tensor,     # [B, Skv, Hkv, D]
    v: torch.Tensor,     # [B, Skv, Hkv, D]
    o: torch.Tensor,     # [B, Sq, H, D], the forward's output
    lse: torch.Tensor,   # [B*H, Sq] float32, the forward's logsumexp
    do: torch.Tensor,    # [B, Sq, H, D], the gradient of o
    *,
    causal: bool = False,
    scale: Optional[float] = None,
    q_offset: int = 0,
    kv_offset: int = 0,
) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """The plain PyTorch version of the backward kernels, written out in
    float32 with their formulas (not autograd through the forward): P =
    exp(S - lse) with masked entries 0, dV = P^T dO, dP = dO V^T, dS = P (dP
    - delta) with delta = rowsum(dO O), dQ = dS K scale, dK = dS^T Q scale,
    dK/dV summed over each GQA group. Returns (dq, dk, dv) in the inputs'
    dtypes."""
    B, Sq, H, D = q.shape
    Skv, Hkv = k.shape[1], k.shape[2]
    scale = scale if scale is not None else D ** -0.5
    rep = H // Hkv
    qh = q.float().transpose(1, 2)                                   # [B,H,Sq,D]
    kh = k.float().repeat_interleave(rep, dim=2).transpose(1, 2)     # [B,H,Skv,D]
    vh = v.float().repeat_interleave(rep, dim=2).transpose(1, 2)
    doh = do.float().transpose(1, 2)
    delta = (doh * o.float().transpose(1, 2)).sum(-1)                # [B,H,Sq]
    s = (qh @ kh.transpose(-1, -2)) * scale
    if causal:
        q_pos = q_offset + torch.arange(Sq, device=q.device)[:, None]
        k_pos = kv_offset + torch.arange(Skv, device=q.device)[None, :]
        s = s.masked_fill(~(k_pos <= q_pos), float("-inf"))
    p = torch.exp(s - lse.reshape(B, H, Sq, 1))
    dv = p.transpose(-1, -2) @ doh
    ds = p * (doh @ vh.transpose(-1, -2) - delta[..., None])
    dq = (ds @ kh) * scale
    dk = (ds.transpose(-1, -2) @ qh) * scale

    def group_sum(x):  # [B, H, Skv, D] -> [B, Skv, Hkv, D]
        return x.reshape(B, Hkv, rep, Skv, D).sum(2).transpose(1, 2)

    return (dq.transpose(1, 2).to(q.dtype), group_sum(dk).to(k.dtype),
            group_sum(dv).to(v.dtype))


def bwd_tensor_cores(dtype: torch.dtype, D: int) -> bool:
    """Whether the backward runs its wgmma kernels for contiguous inputs
    of ``dtype`` and head dim D (else the scalar kernels)."""
    return dtype == torch.bfloat16 and D % 16 == 0 and 16 <= D <= 128


def bwd_tiles(dtype: torch.dtype, D: int) -> Tuple[int, int]:
    """(rows a block owns, rows a step streams) of the backward kernels:
    keys and queries in dK/dV, queries and keys in dQ. A copy of
    ``csrc/flash_bwd.cu``'s rule (the grid rule needs it on the CPU too,
    where no library is built); ``test_bwd_tile_rows_match_the_kernels`` holds
    it against ``rtt_flash_bwd_tile_rows`` on the card."""
    if bwd_tensor_cores(dtype, D):
        return 128, 64
    rows = 64 if D <= 128 else 32
    return rows, rows


def dkv_blocks_per_sm(dtype: torch.dtype, D: int) -> int:
    """dK/dV blocks resident on one SM (registers and shared memory): a
    copy of what ``rtt_flash_bwd_dkv_blocks_per_sm`` reads from the card,
    held to it by the same card test."""
    if bwd_tensor_cores(dtype, D):
        return 1
    return 2 if D <= 64 else 1


def _first_query_tile(k0: int, Sq: int, rows_q: int, causal: bool,
                      q_offset: int, kv_offset: int) -> int:
    nq = -(-Sq // rows_q)
    d = kv_offset + k0 - q_offset
    return 0 if not causal or d <= 0 else min(nq, d // rows_q)


def dkv_grid_estimates(B: int, H: int, Hkv: int, Sq: int, Skv: int, D: int,
                       *, dtype: torch.dtype = torch.bfloat16,
                       causal: bool = True, q_offset: int = 0,
                       kv_offset: int = 0, sms: int = H100_SMS,
                       ) -> Tuple[float, float]:
    """Estimated seconds of the dK/dV kernel on (the KV-head grid, the
    per-query-head grid). Each grid takes at least its longest block chain
    (tile steps of one block: ``rep`` heads of query tiles for a KV-head
    block, one head's for a per-head block; key tile 0 walks the most under
    causal masking) and at least all steps spread over the resident blocks
    (blocks an SM x ``sms``); both grids do the same steps. The per-head
    grid also writes its float32 [B, Skv, H, D] dK and dV and the wrapper
    reads them back to sum each group."""
    rows_k, rows_q = bwd_tiles(dtype, D)
    nq = -(-Sq // rows_q)
    chains = [nq - _first_query_tile(i * rows_k, Sq, rows_q, causal,
                                     q_offset, kv_offset)
              for i in range(-(-Skv // rows_k))]
    total = B * H * sum(chains)
    slots = dkv_blocks_per_sm(dtype, D) * sms
    spread = -(-total // slots)
    step_s = 8.0 * rows_k * rows_q * D / DKV_SM_FLOPS_PER_S[
        bwd_tensor_cores(dtype, D)]
    rep = H // Hkv
    kv_head = max(rep * max(chains), spread) * step_s
    per_head = (max(max(chains), spread) * step_s
                + 2 * 2 * B * Skv * H * D * 4 / HBM_BYTES_PER_S)
    return kv_head, per_head


def dkv_per_head(B: int, H: int, Hkv: int, Sq: int, Skv: int, D: int,
                 **kw) -> bool:
    """Whether dK/dV takes the per-query-head grid: ``DKV_GRID`` if set,
    else the grid of the smaller :func:`dkv_grid_estimates` (keyword
    arguments go there). MHA (H == Hkv) always takes the KV-head grid,
    which is then the same grid without the float32 round trip."""
    if H == Hkv:
        return False
    if DKV_GRID is not None:
        if DKV_GRID not in ("kv_head", "per_head"):
            raise ValueError(f"DKV_GRID must be None, 'kv_head' or "
                             f"'per_head', not {DKV_GRID!r}")
        return DKV_GRID == "per_head"
    kv_head, per_head = dkv_grid_estimates(B, H, Hkv, Sq, Skv, D, **kw)
    return per_head < kv_head


def _bwd_args(q, k, causal, scale, q_offset, kv_offset):
    """The backward entry points' dtype code, dimensions and flags."""
    B, Sq, H, D = q.shape
    return (_build.DTYPE_CODES[q.dtype], (B, H, k.shape[2], Sq, k.shape[1], D),
            (float(scale), int(bool(causal)), int(q_offset), int(kv_offset)))


def launch_bwd_dq(lib, q, k, v, do, lse, delta, *, causal, scale, q_offset,
                  kv_offset, stream):
    """Launch ``csrc/flash_bwd.cu``'s dQ kernel on contiguous inputs
    through ``lib``; returns dq allocated here."""
    code, dims, flags = _bwd_args(q, k, causal, scale, q_offset, kv_offset)
    dq = torch.empty_like(q)
    strides = (ctypes.c_int64 * 15)(
        *[s for t in (q, k, v, do, dq) for s in t.stride()[:3]])
    _build.check(lib, lib.rtt_flash_bwd_dq(
        code, q.data_ptr(), k.data_ptr(), v.data_ptr(), do.data_ptr(),
        lse.data_ptr(), delta.data_ptr(), dq.data_ptr(), *dims,
        ctypes.addressof(strides), *flags, stream), "flash_bwd_dq")
    return dq


def launch_bwd_dkv(lib, q, k, v, do, lse, delta, *, causal, scale, q_offset,
                   kv_offset, per_head, stream):
    """Launch ``csrc/flash_bwd.cu``'s dK/dV kernel on contiguous inputs
    through ``lib``; returns (dk, dv) allocated here: k's shape and dtype,
    or float32 [B, Skv, H, D] per query head when ``per_head``."""
    code, dims, flags = _bwd_args(q, k, causal, scale, q_offset, kv_offset)
    B, Sq, H, D = q.shape
    if per_head:
        shape, dtype = (B, k.shape[1], H, D), torch.float32
    else:
        shape, dtype = k.shape, k.dtype
    dk = torch.empty(shape, dtype=dtype, device=q.device)
    dv = torch.empty(shape, dtype=dtype, device=q.device)
    strides = (ctypes.c_int64 * 18)(
        *[s for t in (q, k, v, do, dk, dv) for s in t.stride()[:3]])
    _build.check(lib, lib.rtt_flash_bwd_dkv(
        code, q.data_ptr(), k.data_ptr(), v.data_ptr(), do.data_ptr(),
        lse.data_ptr(), delta.data_ptr(), dk.data_ptr(), dv.data_ptr(),
        *dims, ctypes.addressof(strides), *flags, int(per_head), stream),
        "flash_bwd_dkv")
    return dk, dv


def launch_bwd(lib, q, k, v, do, lse, delta, *, per_head, **kw):
    """Both backward kernels through ``lib``: (dq, dk, dv), dk/dv summed
    over each GQA group (outside the kernel in the per-head mode, as in
    JAX)."""
    dq = launch_bwd_dq(lib, q, k, v, do, lse, delta, **kw)
    dk, dv = launch_bwd_dkv(lib, q, k, v, do, lse, delta, per_head=per_head,
                            **kw)
    if per_head:
        dk, dv = group_sum_dkv(dk, dv, k)
    return dq, dk, dv


def group_sum_dkv(dk: torch.Tensor, dv: torch.Tensor, k: torch.Tensor):
    """The per-head grid's float32 [B, Skv, H, D] dK and dV summed over each
    GQA group, in k's shape and dtype."""
    B, Skv, Hkv, D = k.shape
    rep = dk.shape[2] // Hkv
    return (dk.view(B, Skv, Hkv, rep, D).sum(3).to(k.dtype),
            dv.view(B, Skv, Hkv, rep, D).sum(3).to(k.dtype))


def bwd_delta(o: torch.Tensor, do: torch.Tensor) -> torch.Tensor:
    """delta = rowsum(dO * O) in float32, [B*H, Sq] like lse (a torch op,
    as it is a jnp op outside Pallas in JAX)."""
    B, Sq, H, _ = o.shape
    delta = (do.float() * o.float()).sum(-1)
    return delta.transpose(1, 2).reshape(B * H, Sq).contiguous()


@functools.lru_cache(maxsize=None)
def _sm_count(device: torch.device) -> int:
    return torch.cuda.get_device_properties(device).multi_processor_count


def flash_attention_bwd(
    q: torch.Tensor,     # [B, Sq, H, D]
    k: torch.Tensor,     # [B, Skv, Hkv, D]
    v: torch.Tensor,     # [B, Skv, Hkv, D]
    o: torch.Tensor,     # [B, Sq, H, D]
    lse: torch.Tensor,   # [B*H, Sq] float32
    do: torch.Tensor,    # [B, Sq, H, D]
    *,
    causal: bool = False,
    scale: Optional[float] = None,
    q_offset: int = 0,
    kv_offset: int = 0,
) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """(dq, dk, dv) of attention from the forward's O and lse. The kernels
    on CUDA tensors (dQ, then dK/dV on the KV-head or the per-query-head
    grid by :func:`dkv_per_head`), the plain version on CPU tensors;
    anything else raises."""
    global bwd_dq_launches, bwd_dkv_launches, bwd_dkv_per_head_launches
    _check(q, k, v)
    B, Sq, H, D = q.shape
    if o.shape != q.shape or do.shape != q.shape:
        raise ValueError(f"o {tuple(o.shape)} and do {tuple(do.shape)} must "
                         f"have q's shape {tuple(q.shape)}")
    if lse.shape != (B * H, Sq) or lse.dtype != torch.float32:
        raise ValueError(f"lse must be float32 [{B * H}, {Sq}], got "
                         f"{lse.dtype} {tuple(lse.shape)}")
    scale = scale if scale is not None else D ** -0.5
    kw = dict(causal=causal, scale=scale, q_offset=q_offset,
              kv_offset=kv_offset)
    if q.device.type == "cpu":
        return flash_attention_bwd_reference(q, k, v, o, lse, do, **kw)
    if q.device.type != "cuda":
        raise ValueError(
            f"flash_attention runs on cuda or cpu, not {q.device}")
    if q.dtype not in _build.DTYPE_CODES or not (
            q.dtype == k.dtype == v.dtype == do.dtype):
        raise ValueError(f"flash_attention_bwd takes float32 or bfloat16 "
                         f"q/k/v/do of one dtype, got {q.dtype}, {k.dtype}, "
                         f"{v.dtype}, {do.dtype}")
    if not all(t.is_contiguous() for t in (q, k, v, lse)):
        raise ValueError("flash_attention_bwd needs contiguous q, k, v, lse")
    do = do.contiguous()
    per_head = dkv_per_head(
        B, H, k.shape[2], Sq, k.shape[1], D, dtype=q.dtype, causal=causal,
        q_offset=q_offset, kv_offset=kv_offset, sms=_sm_count(q.device))
    lib = _build.library()
    with torch.cuda.device(q.device):
        out = launch_bwd(lib, q, k, v, do, lse, bwd_delta(o, do),
                         per_head=per_head, stream=_build.current_stream(q),
                         **kw)
    bwd_dq_launches += 1
    if per_head:
        bwd_dkv_per_head_launches += 1
    else:
        bwd_dkv_launches += 1
    return out


class _FlashAttention(torch.autograd.Function):
    """The counterpart of JAX's ``custom_vjp`` around the Pallas kernels:
    the forward kernel saves q, k, v, O and lse; the backward kernels
    recompute P from lse."""

    @staticmethod
    def forward(ctx, q, k, v, causal, scale, q_offset, kv_offset):
        out, lse = flash_attention_fwd(q, k, v, causal=causal, scale=scale,
                                       q_offset=q_offset, kv_offset=kv_offset)
        ctx.save_for_backward(q, k, v, out, lse)
        ctx.kw = dict(causal=causal, scale=scale, q_offset=q_offset,
                      kv_offset=kv_offset)
        return out

    @staticmethod
    @torch.autograd.function.once_differentiable
    def backward(ctx, dout):
        q, k, v, out, lse = ctx.saved_tensors
        dq, dk, dv = flash_attention_bwd(q, k, v, out, lse, dout, **ctx.kw)
        return dq, dk, dv, None, None, None, None


def flash_attention(
    q: torch.Tensor,
    k: torch.Tensor,
    v: torch.Tensor,
    *,
    causal: bool = False,
    scale: Optional[float] = None,
    q_offset: int = 0,
    kv_offset: int = 0,
) -> torch.Tensor:
    """Flash attention with GQA and global-coordinate causal masking (the
    JAX signature, without its TPU block sizes): returns [B, Sq, H, D],
    differentiable in q, k and v through the backward kernels."""
    return _FlashAttention.apply(q, k, v, causal, scale, q_offset, kv_offset)
