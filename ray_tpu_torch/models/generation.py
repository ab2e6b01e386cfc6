"""Autoregressive generation with a dense or a paged KV cache.

Counterpart of ``ray_tpu/models/generation.py``. The dense ``KVCache``
serves ``generate`` and the bucketed prefill; the paged ``PagedKVCache``
(a shared, head-major [L, Hkv, P, page, Dh] pool plus a per-slot page
table) serves the continuous-batching engine in ``serve/llm.py``.

Where the JAX code returns a new cache, the port writes the cache in place
(PyTorch has no donation; an in-place write is what donation buys), and
writes only the rows of active slots: JAX scatters inactive slots to index
``n_pages`` with ``mode="drop"`` or reverts them afterwards, and torch
would raise on the out-of-range index. The logits of an inactive slot are
therefore not meaningful (JAX computes them against a cache it discards).

Kernels: a fresh prefill whose bucket is a multiple of 128 goes through the
flash kernel (``S == T and S % 128 == 0 and cfg.use_flash``, as in JAX);
every decode step goes through the paged kernel when ``cfg.use_flash`` is
set. The JAX engine keeps its paged kernel behind ``RAY_TPU_PAGED_KERNEL``
because of a TPU measurement; the port has no such switch, and PERF.md
records the kernel's and the gather path's times on the H100.

MoE models route each step's tokens as JAX does: rows of inactive slots
claim no expert capacity (``token_mask`` from ``active``), while a bucketed
prefill routes its padding too (``active=None``), so a prompt's prefill
logits depend on its bucket, in the port as in the reference.
"""

from __future__ import annotations

from typing import NamedTuple, Optional, Sequence, Union

import torch

from .._device import DeviceLike, index_like_jax, resolve_device
from ..ops.flash_attention import flash_attention
from ..ops.paged_attention import (
    paged_decode_attention,
    paged_decode_reference,
)
from .llama import (
    LlamaConfig,
    Params,
    embed,
    ffn,
    layer_params,
    project_heads,
    project_out,
    rms_norm,
    rope,
)


def check_params_device(params: Params, device: torch.device) -> None:
    if params["embed"].device != device:
        raise ValueError(f"params are on {params['embed'].device}, "
                         f"the caller asked for {device}")


class KVCache(NamedTuple):
    k: torch.Tensor        # [L, B, T, Hkv, Dh]
    v: torch.Tensor        # [L, B, T, Hkv, Dh]
    lengths: torch.Tensor  # [B] int32 — valid tokens per slot

    @staticmethod
    def create(cfg: LlamaConfig, batch: int, max_len: int,
               device: DeviceLike = None) -> "KVCache":
        dev = resolve_device(device)
        shape = (cfg.num_layers, batch, max_len, cfg.num_kv_heads, cfg.dh)
        return KVCache(
            k=torch.zeros(shape, dtype=cfg.dtype, device=dev),
            v=torch.zeros(shape, dtype=cfg.dtype, device=dev),
            lengths=torch.zeros((batch,), dtype=torch.int32, device=dev),
        )


def _attend_cached(q, ck, cv, q_pos, lengths, cfg):
    """q [B,S,H,D] against cache ck/cv [B,T,Hkv,D]; query rows sit at
    q_pos [B,S]; cache rows after a row's position are masked."""
    B, S, H, D = q.shape
    T = ck.shape[1]
    if S == T and S % 128 == 0 and cfg.use_flash:
        # Fresh prefill (S tokens into an S-long cache start at 0): plain
        # causal self-attention through the flash kernel.
        return flash_attention(q, ck, cv, causal=True)
    rep = H // ck.shape[2]
    k = ck.repeat_interleave(rep, dim=2)
    v = cv.repeat_interleave(rep, dim=2)
    scores = torch.einsum("bshd,bthd->bhst", q.float(), k.float()) * D ** -0.5
    t_idx = torch.arange(T, device=q.device)[None, None, :]
    causal = t_idx <= q_pos[:, :, None]                      # [B,S,T]
    scores = scores.masked_fill(~causal[:, None], float("-inf"))
    probs = torch.softmax(scores, dim=-1).to(v.dtype)
    return torch.einsum("bhst,bthd->bshd", probs, v)


def _write_rows(cache, new, start, rows):
    """cache[b, start[b] : start[b] + S] = new[b] for the slots in ``rows``
    (all slots when None). The start is clamped so the rows fit, as
    ``lax.dynamic_update_slice`` clamps it."""
    B, S = new.shape[:2]
    start = start.long().clamp(0, max(cache.shape[1] - S, 0))
    pos = start[:, None] + torch.arange(S, device=new.device)
    b = torch.arange(B, device=new.device)[:, None].expand(B, S)
    if rows is not None:
        b, pos, new = b[rows], pos[rows], new[rows]
    cache[b, pos] = new.to(cache.dtype)


def _layer_cached(cfg, lp, x, cache_k, cache_v, start_pos, q_pos, rows=None,
                  token_mask=None):
    """One block over cached KV, writing the new rows in place. x [B,S,M];
    start_pos [B] write offset; ``rows`` the active slots (None: all);
    ``token_mask`` [B,S] the rows MoE routes (None: all)."""
    S = x.shape[1]
    h = rms_norm(x, lp["attn_norm"], cfg.rms_eps)
    q = rope(project_heads(h, lp["wq"]), q_pos, cfg.rope_theta)
    k = rope(project_heads(h, lp["wk"]), q_pos, cfg.rope_theta)
    v = project_heads(h, lp["wv"])
    _write_rows(cache_k, k, start_pos, rows)
    _write_rows(cache_v, v, start_pos, rows)
    attn = _attend_cached(q, cache_k, cache_v, q_pos, start_pos + S, cfg)
    x = x + project_out(attn.to(x.dtype), lp["wo"])
    out, _aux = ffn(cfg, rms_norm(x, lp["mlp_norm"], cfg.rms_eps), lp,
                    token_mask)
    return x + out


def forward_with_cache(
    params: Params,
    tokens: torch.Tensor,                        # [B, S] appended per slot
    cache: KVCache,
    cfg: LlamaConfig,
    *,
    active: Optional[torch.Tensor] = None,       # [B] bool — rows to update
    last_index: Optional[torch.Tensor] = None,   # [B] logits position
    append_len: Optional[Union[torch.Tensor, int]] = None,  # real length
):
    """Append ``tokens`` to each slot and return (logits [B, V] float32 at
    the last appended position, the cache with new lengths). The cache's
    k/v are written in place (active rows only).

    ``last_index``/``append_len`` serve bucketed prefill: tokens padded to
    a bucket still give logits at the true last position and advance the
    length by the true prompt length (rows past it are never attended).
    MoE routes every row of an active slot, padding included."""
    B, S = tokens.shape
    start = cache.lengths
    q_pos = start.long()[:, None] + torch.arange(S, device=tokens.device)
    x = embed(params, tokens, cfg)
    rows, mask = None, None
    if active is not None:
        rows = active.nonzero().squeeze(1)
        mask = active[:, None].expand(B, S)
    for i in range(cfg.num_layers):
        x = _layer_cached(cfg, layer_params(params, i), x, cache.k[i],
                          cache.v[i], start, q_pos, rows, mask)
    x = rms_norm(x, params["final_norm"], cfg.rms_eps)
    if last_index is None:
        last = x[:, -1]
    else:
        idx = index_like_jax(torch.as_tensor(last_index).long(), S)
        last = x[torch.arange(B, device=x.device), idx.to(x.device)]
    logits = (last @ params["lm_head"]).float()
    advance = append_len if append_len is not None else S
    lengths = cache.lengths + torch.as_tensor(advance, device=start.device)
    if active is not None:
        lengths = torch.where(active, lengths, cache.lengths)
    return logits, KVCache(cache.k, cache.v, lengths.to(torch.int32))


class PagedKVCache(NamedTuple):
    """A shared pool of fixed-size token pages plus a per-slot page table.
    The pool is head-major ([L, Hkv, P, page, Dh]), so one layer's pool
    for one KV head is a contiguous run of pages the paged kernel reads
    without a transpose."""

    k: torch.Tensor           # [L, Hkv, P_total, page, Dh]
    v: torch.Tensor           # [L, Hkv, P_total, page, Dh]
    page_table: torch.Tensor  # [B, P_max] int32 page ids per slot
    lengths: torch.Tensor     # [B] int32 valid tokens per slot

    @property
    def page_size(self) -> int:
        return self.k.shape[3]

    @staticmethod
    def create(cfg: LlamaConfig, batch: int, total_pages: int,
               page_size: int, max_pages_per_seq: int,
               device: DeviceLike = None) -> "PagedKVCache":
        dev = resolve_device(device)
        shape = (cfg.num_layers, cfg.num_kv_heads, total_pages, page_size,
                 cfg.dh)
        return PagedKVCache(
            k=torch.zeros(shape, dtype=cfg.dtype, device=dev),
            v=torch.zeros(shape, dtype=cfg.dtype, device=dev),
            page_table=torch.zeros((batch, max_pages_per_seq),
                                   dtype=torch.int32, device=dev),
            lengths=torch.zeros((batch,), dtype=torch.int32, device=dev),
        )


def _attend_paged_gather(q, ck, cv, page_table, lengths, cfg):
    """The gather path (JAX ``_attend_paged_xla``): gather each slot's
    pages into its [Pmax * page] window and attend densely. q [B,1,H,D];
    ck/cv one layer's pool [Hkv, P, page, D]."""
    out = paged_decode_reference(q[:, 0], ck, cv, page_table, lengths)
    return out[:, None]


def _attend_paged(q, ck, cv, page_table, lengths, cfg):
    """Single-token decode over the paged pool: the paged kernel when
    ``cfg.use_flash`` (its plain version on CPU tensors), else the gather
    path."""
    if cfg.use_flash:
        return paged_decode_attention(q[:, 0], ck, cv, page_table,
                                      lengths)[:, None]
    return _attend_paged_gather(q, ck, cv, page_table, lengths, cfg)


def _layer_paged_decode(cfg, lp, x, ck, cv, page_table, lengths, page_ids,
                        offsets, rows, active):
    """One block, single-token decode against one layer's pool. x [B,1,M];
    ck/cv [Hkv, P, page, Dh] (views into the pool, written in place);
    page_ids/offsets [B] name each slot's write cell for this token; only
    the slots in ``rows`` write, and only the ``active`` [B] rows claim MoE
    capacity."""
    h = rms_norm(x, lp["attn_norm"], cfg.rms_eps)
    q_pos = lengths.long()[:, None]
    q = rope(project_heads(h, lp["wq"]), q_pos, cfg.rope_theta)
    k = rope(project_heads(h, lp["wk"]), q_pos, cfg.rope_theta)
    v = project_heads(h, lp["wv"])
    cell = (page_ids[rows], offsets[rows])
    ck[:, cell[0], cell[1]] = k[rows, 0].transpose(0, 1).to(ck.dtype)
    cv[:, cell[0], cell[1]] = v[rows, 0].transpose(0, 1).to(cv.dtype)
    attn = _attend_paged(q, ck, cv, page_table, lengths, cfg)
    x = x + project_out(attn.to(x.dtype), lp["wo"])
    out, _aux = ffn(cfg, rms_norm(x, lp["mlp_norm"], cfg.rms_eps), lp,
                    active[:, None])
    return x + out


def paged_decode(
    params: Params,
    tokens: torch.Tensor,      # [B] one token per slot
    cache: PagedKVCache,
    cfg: LlamaConfig,
    *,
    active: torch.Tensor,      # [B] bool
):
    """One decode step over the paged pool: write each active slot's token
    into its current page cell, attend over its pages, and return
    (logits [B, V] float32, the cache with new lengths)."""
    B = tokens.shape[0]
    page = cache.page_size
    col = index_like_jax(cache.lengths.long() // page,
                         cache.page_table.shape[1])
    page_ids = cache.page_table[torch.arange(B, device=col.device),
                                col].long()
    offsets = cache.lengths.long() % page
    rows = active.nonzero().squeeze(1)
    x = embed(params, tokens[:, None], cfg)
    for i in range(cfg.num_layers):
        x = _layer_paged_decode(cfg, layer_params(params, i), x, cache.k[i],
                                cache.v[i], cache.page_table, cache.lengths,
                                page_ids, offsets, rows, active)
    x = rms_norm(x, params["final_norm"], cfg.rms_eps)
    logits = (x[:, 0] @ params["lm_head"]).float()
    lengths = torch.where(active, cache.lengths + 1, cache.lengths)
    return logits, PagedKVCache(cache.k, cache.v, cache.page_table,
                                lengths.to(torch.int32))


def paged_prefill(
    params: Params,
    tokens: torch.Tensor,      # [1, S_bucket] padded prompt
    real_len: int,             # true prompt length
    cache: PagedKVCache,
    cfg: LlamaConfig,
    slot: int,
    pages: torch.Tensor,       # [S_bucket // page] page ids for this slot
):
    """Prefill one request through the dense single-row path, then copy
    its rows into the slot's pool pages in place. The bucket must be a
    multiple of the page size. If this raises, the pool may be half
    written: the caller rebuilds it (``LLMEngine._reset_cache``)."""
    S = tokens.shape[1]
    page = cache.page_size
    dev = tokens.device
    small = KVCache.create(cfg, 1, S, device=dev)
    real = torch.tensor([int(real_len)], dtype=torch.int32, device=dev)
    logits, small = forward_with_cache(params, tokens, small, cfg,
                                       last_index=real - 1, append_len=real)
    n = S // page
    L, Hkv, Dh = cfg.num_layers, cfg.num_kv_heads, cfg.dh
    pages = pages.to(device=dev, dtype=torch.long)
    # [L, 1, S, Hkv, Dh] -> [L, Hkv, n, page, Dh], copied to the page ids.
    for pool, rows in ((cache.k, small.k), (cache.v, small.v)):
        pool[:, :, pages] = rows[:, 0].reshape(L, n, page, Hkv, Dh).permute(
            0, 3, 1, 2, 4).to(pool.dtype)
    lengths = cache.lengths.clone()
    lengths[slot] = int(real_len)
    return logits, PagedKVCache(cache.k, cache.v, cache.page_table, lengths)


def sample_logits(logits: torch.Tensor,
                  generator: Optional[torch.Generator] = None, *,
                  temperature: float = 0.0, top_k: int = 0) -> torch.Tensor:
    """Greedy (temperature 0) or temperature/top-k sampling. [B,V] → [B]
    int32. Sampling draws from ``generator`` (on the logits' device); it
    cannot reproduce JAX's threefry stream."""
    if temperature <= 0.0:
        return logits.argmax(dim=-1).to(torch.int32)
    logits = logits.float() / temperature
    if top_k > 0:
        kth = torch.topk(logits, top_k, dim=-1).values[:, -1:]
        logits = logits.masked_fill(logits < kth, float("-inf"))
    probs = torch.softmax(logits, dim=-1)
    return torch.multinomial(probs, 1, generator=generator)[:, 0].to(
        torch.int32)


def generate(
    params: Params,
    prompt: Union[torch.Tensor, Sequence[Sequence[int]]],  # [B, S_prompt]
    cfg: LlamaConfig,
    *,
    max_new_tokens: int,
    max_len: Optional[int] = None,
    temperature: float = 0.0,
    generator: Optional[torch.Generator] = None,
    device: DeviceLike = None,
    eos_token: Optional[int] = None,
) -> torch.Tensor:
    """Batch generation (prefill, then one decode step per token) on
    ``device`` (default: the CUDA card). Returns [B, max_new_tokens].
    ``eos_token`` is accepted and, as in the JAX ``generate``, not used:
    every row runs ``max_new_tokens`` steps (the engine stops a request at
    its eos)."""
    dev = resolve_device(device)
    check_params_device(params, dev)
    prompt = torch.as_tensor(prompt, dtype=torch.int32, device=dev)
    B, S = prompt.shape
    cache = KVCache.create(cfg, B, max_len or (S + max_new_tokens), dev)
    with torch.inference_mode():
        logits, cache = forward_with_cache(params, prompt, cache, cfg)
        tok = sample_logits(logits, generator, temperature=temperature)
        out = [tok]
        for _ in range(max_new_tokens - 1):
            logits, cache = forward_with_cache(params, tok[:, None], cache,
                                               cfg)
            tok = sample_logits(logits, generator, temperature=temperature)
            out.append(tok)
    return torch.stack(out, dim=1)
