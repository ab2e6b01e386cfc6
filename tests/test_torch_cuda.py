"""The port's CUDA kernels against their plain versions, on the card.

Marked ``cuda``: each test skips without a CUDA card (the CPU tests in
test_torch_ops.py and test_torch_flash_bwd.py hold the plain versions
against the JAX kernels). On the H100: ``python -m pytest -m cuda
tests/test_torch_cuda.py``. The cases reach every path of the kernels:
float32 and bf16, the tensor-core and scalar kernels, 16-byte and
element-wise loads (odd D, rows off a 16-byte boundary), ragged tiles,
offsets, fully masked tiles, both dK/dV grids, any page size, and the
``layer=`` form. float32 tolerances are the JAX kernel tests'; bf16
outputs may differ by one bf16 ulp below |O| = 4, and bf16 gradients by
1% of their largest value (the tensor-core backward rounds P and dS to
bf16 as product operands). The last tests drive the training path on the
card: gradients through the kernels, and a small train step against the
CPU.
"""

import dataclasses

import numpy as np
import pytest
import torch

from ray_tpu_torch.ops import flash_attention as fa
from ray_tpu_torch.ops import paged_attention as pa

pytestmark = pytest.mark.cuda

TOL = {torch.float32: 2e-5, torch.bfloat16: 2e-2}


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    torch.backends.cuda.matmul.allow_tf32 = False
    return torch.device("cuda")


def _randn(rng, shape, dtype, device, misalign=False):
    """Seeded normal values; ``misalign`` puts the data one element past a
    16-byte boundary (contiguous all the same)."""
    x = torch.from_numpy(rng.randn(*shape).astype(np.float32)).to(dtype)
    if not misalign:
        return x.to(device)
    buf = torch.empty(x.numel() + 1, dtype=dtype, device=device)
    buf[1:] = x.reshape(-1).to(device)
    return buf[1:].view(shape)


# (B, Sq, Skv, H, Hkv, D, causal, q_offset, kv_offset, misalign q). The
# bf16 backward's wgmma kernels tile 128 rows a block and 64 a step through
# a 2-stage ring: "ragged_rep4" and "offsets_rep4" end in ragged 128-key
# and 64-query tiles, "offsets_rep4" has Sq != Skv, both offsets and fully
# masked query rows, "noncausal_long" chains 20 steps a KV-head block
# (more than the ring's stages), "masked_tile" masks whole tiles. The bf16
# forward's wgmma kernel owns 128 query rows a block and streams 64-key
# tiles through a 4-stage ring: "s129_rep4" and "ragged_rep4" (S = 300)
# end in ragged query and key tiles, "diag_mid_tile_rep1" puts the causal
# diagonal 37 keys into a tile, "kv_longer_rep8" has Skv > Sq with both
# offsets, "masked_block128" masks a whole 128-row query block beside a
# live one, "d48_causal" reads zero-filled columns, "long_rep4" walks 16
# key tiles (four times the ring).
FLASH = {
    "ragged_gqa": (1, 70, 70, 2, 1, 64, True, 0, 0, False),
    "q_offset": (1, 64, 130, 2, 2, 128, True, 66, 0, False),
    "noncausal_odd_d": (2, 65, 65, 4, 2, 100, False, 0, 0, False),
    "masked_tile": (1, 128, 128, 2, 1, 64, True, 0, 64, False),
    "d256": (1, 40, 40, 2, 2, 256, True, 0, 0, False),
    "d48_offsets": (1, 33, 100, 2, 2, 48, False, 5, 3, False),
    "misaligned": (1, 65, 65, 2, 1, 64, True, 0, 0, True),
    "ragged_rep4": (1, 300, 300, 8, 2, 128, True, 0, 0, False),
    "offsets_rep4": (2, 200, 140, 8, 2, 64, True, 10, 70, False),
    "noncausal_long": (1, 260, 260, 4, 1, 128, False, 0, 0, False),
    "s129_rep4": (1, 129, 129, 4, 1, 128, True, 0, 0, False),
    "diag_mid_tile_rep1": (1, 192, 229, 4, 4, 128, True, 37, 0, False),
    "kv_longer_rep8": (2, 100, 260, 8, 1, 64, True, 200, 30, False),
    "masked_block128": (1, 256, 256, 4, 2, 128, True, 0, 128, False),
    "d48_causal": (2, 150, 150, 4, 2, 48, True, 0, 0, False),
    "long_rep4": (1, 1024, 1024, 8, 2, 128, True, 0, 0, False),
}


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16],
                         ids=["f32", "bf16"])
@pytest.mark.parametrize("case", sorted(FLASH))
def test_flash_kernel_matches_plain_version(cuda, case, dtype):
    B, Sq, Skv, H, Hkv, D, causal, qo, ko, mis = FLASH[case]
    rng = np.random.RandomState(len(case))
    q = _randn(rng, (B, Sq, H, D), dtype, cuda, misalign=mis)
    k = _randn(rng, (B, Skv, Hkv, D), dtype, cuda)
    v = _randn(rng, (B, Skv, Hkv, D), dtype, cuda)
    before = fa.launches
    out, lse = fa.flash_attention_fwd(q, k, v, causal=causal, q_offset=qo,
                                      kv_offset=ko)
    ref, ref_lse = fa.flash_attention_reference(q, k, v, causal=causal,
                                                q_offset=qo, kv_offset=ko)
    torch.cuda.synchronize()
    assert fa.launches == before + 1
    tol = TOL[dtype]
    torch.testing.assert_close(out.float(), ref.float(), atol=tol, rtol=tol)
    torch.testing.assert_close(lse, ref_lse, atol=1e-4, rtol=1e-4)
    # Query rows before every key ("masked_tile": a 64-row tile,
    # "masked_block128": a whole 128-row block) are exactly 0.
    masked = max(0, min(Sq, ko - qo)) if causal else 0
    assert (out[:, :masked] == 0).all()
    if case == "masked_tile":
        assert masked == 64


# (B, H, Hkv, D, P, page, Pmax, misalign pools, lengths or None: the
# first slot full, the rest drawn). The bf16 kernel splits each slot's page
# walk over pa.paged_splits blocks: "splits_b8" (5 splits) and "rep8" (20)
# have slots that span every split, lengths on page ends and starts and 0;
# "engine_b4" is the 8B engine's decode (9 splits), "rep1" the same with
# one query head a KV head; "d256" takes the widest rows.
PAGED = {
    "page16_d128": (3, 4, 2, 128, 8, 16, 4, False, None),
    "page5_d40": (2, 8, 2, 40, 9, 5, 6, False, None),
    "page64_mqa": (3, 4, 1, 64, 12, 64, 3, False, None),
    "odd_d": (3, 4, 2, 20, 10, 8, 4, False, None),
    "misaligned": (3, 4, 2, 64, 10, 8, 4, True, None),
    "splits_b8": (8, 32, 8, 128, 256, 16, 32, False,
                  [511, 0, 15, 16, 95, 96, 255, 256]),
    "rep8": (3, 16, 2, 64, 130, 16, 40, False, [639, 0, 320]),
    "engine_b4": (4, 32, 8, 128, 128, 16, 32, False, [300, 200, 130, 100]),
    "rep1": (4, 8, 8, 128, 128, 16, 32, False, [300, 200, 130, 100]),
    "d256": (2, 8, 2, 256, 20, 8, 10, False, None),
}


def _paged_inputs(case, dtype, device):
    B, H, Hkv, D, P, page, Pmax, mis, lengths = PAGED[case]
    rng = np.random.RandomState(len(case))
    q = _randn(rng, (B, H, D), dtype, device)
    k_pool = _randn(rng, (Hkv, P, page, D), dtype, device, misalign=mis)
    v_pool = _randn(rng, (Hkv, P, page, D), dtype, device)
    table = np.stack([rng.permutation(P)[:Pmax] for _ in range(B)])
    table[-1] = 0  # an inactive slot: an all-zero row
    table = torch.tensor(table, dtype=torch.int32, device=device)
    if lengths is None:
        lengths = [Pmax * page - 1] + list(rng.randint(0, Pmax * page, B - 1))
    lengths = torch.tensor(lengths, dtype=torch.int32, device=device)
    return q, k_pool, v_pool, table, lengths


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16],
                         ids=["f32", "bf16"])
@pytest.mark.parametrize("case", sorted(PAGED))
def test_paged_kernel_matches_plain_version(cuda, case, dtype):
    q, k_pool, v_pool, table, lengths = _paged_inputs(case, dtype, cuda)
    before = pa.launches
    out = pa.paged_decode_attention(q, k_pool, v_pool, table, lengths)
    ref = pa.paged_decode_reference(q, k_pool, v_pool, table, lengths)
    torch.cuda.synchronize()
    assert pa.launches == before + 1
    tol = TOL[dtype]
    torch.testing.assert_close(out.float(), ref.float(), atol=tol, rtol=tol)


def test_paged_kernel_is_deterministic_and_resets_its_counters(cuda):
    """The bf16 kernel merges its splits in split order whatever block
    arrives last: two launches on the same inputs give bitwise equal
    outputs. Each launch leaves its ticket counters at 0, so a launch at
    another B (other counters, another split count) and the first shape
    again are still right."""
    big = _paged_inputs("splits_b8", torch.bfloat16, cuda)
    small = _paged_inputs("engine_b4", torch.bfloat16, cuda)
    assert pa.paged_splits(8, 8, 32, 16) != pa.paged_splits(4, 8, 32, 16)
    first = pa.paged_decode_attention(*big)
    second = pa.paged_decode_attention(*big)
    other = pa.paged_decode_attention(*small)
    third = pa.paged_decode_attention(*big)
    torch.cuda.synchronize()
    assert torch.equal(first, second) and torch.equal(first, third)
    for got, inputs in ((first, big), (other, small)):
        ref = pa.paged_decode_reference(*inputs)
        torch.testing.assert_close(got.float(), ref.float(), atol=2e-2,
                                   rtol=2e-2)
    for _ws, counters in pa._workspaces.values():
        assert not counters.any()


@pytest.mark.parametrize("per_head", [False, True], ids=["grouped",
                                                         "per_head"])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16],
                         ids=["f32", "bf16"])
@pytest.mark.parametrize("case", sorted(FLASH))
def test_flash_bwd_kernels_match_plain_version(cuda, monkeypatch, case,
                                               dtype, per_head):
    B, Sq, Skv, H, Hkv, D, causal, qo, ko, mis = FLASH[case]
    monkeypatch.setattr(fa, "DKV_GRID", "per_head" if per_head else "kv_head")
    rng = np.random.RandomState(len(case))
    q = _randn(rng, (B, Sq, H, D), dtype, cuda, misalign=mis)
    k = _randn(rng, (B, Skv, Hkv, D), dtype, cuda)
    v = _randn(rng, (B, Skv, Hkv, D), dtype, cuda)
    do = _randn(rng, (B, Sq, H, D), dtype, cuda, misalign=mis)
    kw = dict(causal=causal, q_offset=qo, kv_offset=ko)
    o, lse = fa.flash_attention_reference(q, k, v, **kw)
    counts = (fa.bwd_dq_launches, fa.bwd_dkv_launches,
              fa.bwd_dkv_per_head_launches)
    got = fa.flash_attention_bwd(q, k, v, o, lse, do, **kw)
    want = fa.flash_attention_bwd_reference(q, k, v, o, lse, do, **kw)
    torch.cuda.synchronize()
    per = H > Hkv and per_head
    assert (fa.bwd_dq_launches, fa.bwd_dkv_launches,
            fa.bwd_dkv_per_head_launches) == (
        counts[0] + 1, counts[1] + (not per), counts[2] + per)
    rel = 2e-5 if dtype == torch.float32 else 1e-2
    for name, g, w in zip(("dq", "dk", "dv"), got, want):
        assert g.dtype == w.dtype and g.shape == w.shape, name
        err = (g.float() - w.float()).abs().max().item()
        assert err <= rel * max(w.float().abs().max().item(), 1e-3), (
            name, err)


def test_bwd_tile_rows_match_the_kernels(cuda):
    """The grid rule's copies of the backward kernels' tiles (rows a block
    owns, rows a step streams) and of the dK/dV blocks an SM agree with the
    library at every head dim and dtype it takes."""
    import ctypes

    from ray_tpu_torch.ops import _build

    lib = _build.library()
    for dtype, code in _build.DTYPE_CODES.items():
        got = [(lib.rtt_flash_bwd_tile_rows(code, d, 0),
                lib.rtt_flash_bwd_tile_rows(code, d, 1))
               for d in range(1, 257)]
        assert got == [fa.bwd_tiles(dtype, d) for d in range(1, 257)], dtype
        for d in (16, 48, 64, 100, 128, 256):
            n = ctypes.c_int(-1)
            _build.check(lib, lib.rtt_flash_bwd_dkv_blocks_per_sm(
                code, d, ctypes.byref(n)), "occupancy")
            assert n.value == fa.dkv_blocks_per_sm(dtype, d), (dtype, d)


@pytest.mark.parametrize("D", [48, 64, 128])
def test_wgmma_operand_forms_match_matmul(cuda, D):
    """The wgmma building blocks in every form the backward kernels use:
    S = A B^T (both operands from swizzled shared memory, K-major, each
    warpgroup on its 64 rows of a 128-row tile) and C = bf16(S) V (S's
    accumulators as the register A operand, V MN-major), against
    torch.matmul in float32. D = 48 reads zero-filled columns."""
    from ray_tpu_torch.ops import _build

    lib = _build.library()
    rng = np.random.RandomState(D)
    a, b, v = (_randn(rng, shape, torch.bfloat16, cuda)
               for shape in ((128, D), (64, D), (64, D)))
    s = torch.full((128, 64), float("nan"), device=cuda)
    c = torch.full((128, D), float("nan"), device=cuda)
    _build.check(lib, lib.rtt_wgmma_probe(
        a.data_ptr(), b.data_ptr(), v.data_ptr(), s.data_ptr(), c.data_ptr(),
        D, _build.current_stream(a)), "wgmma_probe")
    torch.cuda.synchronize()
    want_s = a.float() @ b.float().T
    torch.testing.assert_close(s, want_s, atol=1e-3, rtol=1e-4)
    # From the kernel's own S: a sum-order difference may round an entry
    # of S to the neighbouring bf16.
    want_c = s.to(torch.bfloat16).float() @ v.float()
    torch.testing.assert_close(c, want_c, atol=1e-3, rtol=1e-4)


def test_gradients_flow_through_the_flash_kernels(cuda):
    """The forward kernel's output has a grad_fn on the card: a loss
    through ``flash_attention`` gives q, k and v the plain version's
    gradients, through the forward and both backward kernels."""
    rng = np.random.RandomState(4)
    leaves = [_randn(rng, shape, torch.float32, cuda).requires_grad_()
              for shape in ((2, 96, 4, 64), (2, 96, 2, 64), (2, 96, 2, 64))]
    counts = (fa.launches, fa.bwd_dq_launches,
              fa.bwd_dkv_launches + fa.bwd_dkv_per_head_launches)
    out = fa.flash_attention(*leaves, causal=True)
    assert out.grad_fn is not None
    (out ** 2).sum().backward()
    got = [t.grad for t in leaves]
    plain = [t.detach().clone().requires_grad_() for t in leaves]
    ref, _ = fa.flash_attention_reference(*plain, causal=True)
    (ref ** 2).sum().backward()
    torch.cuda.synchronize()
    assert (fa.launches, fa.bwd_dq_launches,
            fa.bwd_dkv_launches + fa.bwd_dkv_per_head_launches) == tuple(
        c + 1 for c in counts)
    for g, t in zip(got, plain):
        assert g.abs().max() > 0
        torch.testing.assert_close(g, t.grad, atol=3e-5, rtol=3e-5)


def _flat_cpu(tree):
    """{name: CPU copy} of a parameter tree's tensors."""
    out = {k: v.detach().to("cpu", copy=True) for k, v in tree.items()
           if torch.is_tensor(v)}
    out.update({f"layers.{k}": v.detach().to("cpu", copy=True)
                for k, v in tree["layers"].items()})
    return out


def test_train_step_on_the_card_matches_the_cpu(cuda):
    """Three steps of CompiledTrainStep in float32 (TF32 off) on the card
    and on the CPU from the same weights and tokens. Losses within 1e-4;
    step-1 gradients (same weights on both) within 2e-5 of each leaf's
    largest; the card's weights within 1e-6 of AdamW run on the CPU on the
    card's gradients, so they follow from those gradients alone; after
    step 3, all but 0.1% of each leaf's elements within 2e-5 of the CPU's.
    AdamW divides by the root of the second moment, so an element whose
    gradient or first moment is near the level of the devices' rounding
    takes a step of another size on each."""
    from ray_tpu_torch.models import LlamaConfig, init_params
    from ray_tpu_torch.train import AdamW, CompiledTrainStep

    cfg = dataclasses.replace(LlamaConfig.tiny(), loss_chunk=8)
    tokens = torch.tensor(np.random.RandomState(2).randint(0, 256, (2, 33)),
                          dtype=torch.int32)
    runs = {}
    for dev in ("cpu", "cuda"):
        params = init_params(cfg, torch.Generator().manual_seed(3), "cpu")
        params = {k: (v.to(dev) if torch.is_tensor(v) else
                      {n: t.to(dev) for n, t in v.items()})
                  for k, v in params.items()}
        step = CompiledTrainStep(cfg, device=dev)
        state = AdamW().init(params)
        before = fa.bwd_dq_launches
        losses, grads = [], []
        for _ in range(3):
            losses.append(step(params, state, tokens)[2].item())
            grads.append(_flat_cpu(step.grads))
        runs[dev] = (losses, _flat_cpu(params), fa.bwd_dq_launches - before,
                     grads)
    assert runs["cuda"][2] == 3 * cfg.num_layers and runs["cpu"][2] == 0
    np.testing.assert_allclose(runs["cuda"][0], runs["cpu"][0], atol=1e-4,
                               rtol=1e-4)
    for k, want in runs["cpu"][3][0].items():
        d = (runs["cuda"][3][0][k] - want).abs().max().item()
        assert d <= 2e-5 * want.abs().max().item(), (k, d)
    replay = _flat_cpu(init_params(cfg, torch.Generator().manual_seed(3),
                                   "cpu"))
    opt = AdamW()
    state = opt.init(replay)
    for g in runs["cuda"][3]:
        opt.update(replay, g, state)
    for k, want in runs["cpu"][1].items():
        got = runs["cuda"][1][k]
        assert (replay[k] - got).abs().max().item() <= 1e-6, k
        d = (got - want).abs()
        assert (d > 2e-5).float().mean().item() <= 1e-3, (k, d.max())


def _ring_kernel_blocks(q, k, v, do, n):
    """Ring attention over n sequence blocks in one process through the
    calls ring_attention._RingFlash makes on each rank: the flash forward
    per visible block at its global offsets, merge_block, and the flash
    backward per block with the merged O and global lse (dq, dk, dv summed
    in float32, cast once). Returns (O, lse, dq, dk, dv), whole-sequence."""
    from ray_tpu_torch.parallel.ring_attention import merge_block, visible

    Sl = q.shape[1] // n
    qb, kb, vb, dob = ([t[:, i * Sl:(i + 1) * Sl].contiguous()
                        for i in range(n)] for t in (q, k, v, do))
    fwd = []
    for my in range(n):
        o = lse = None
        for j in range(my + 1):  # the causal ring's visible blocks
            assert visible(my, j, True)
            o_b, lse_b = fa.flash_attention_fwd(
                qb[my], kb[j], vb[j], causal=True, q_offset=my * Sl,
                kv_offset=j * Sl)
            o, lse = merge_block(o, lse, o_b, lse_b)
        fwd.append((o.to(q.dtype), lse))
    grads = [[torch.zeros_like(b, dtype=torch.float32) for b in blocks]
             for blocks in (qb, kb, vb)]
    for my in range(n):
        for j in range(my + 1):
            g = fa.flash_attention_bwd(
                qb[my], kb[j], vb[j], *fwd[my], dob[my], causal=True,
                q_offset=my * Sl, kv_offset=j * Sl)
            for acc, i, part in zip(grads, (my, j, j), g):
                acc[i] += part
    return (torch.cat([f[0] for f in fwd], 1), torch.cat([f[1] for f in fwd],
                                                           1),
            *(torch.cat(parts, 1).to(q.dtype) for parts in grads))


def _plain_ring_blocks(q, k, v, do, n):
    """The plain ring over the same blocks in float32 (attention_block_
    accumulate per visible block, attention_finalize), differentiated by
    autograd: (O, dq, dk, dv)."""
    from ray_tpu_torch.ops.attention import (
        attention_block_accumulate, attention_finalize)

    q, k, v = (t.float().requires_grad_() for t in (q, k, v))
    B, S, H, D = q.shape
    rep = H // k.shape[2]
    kr, vr = (t.repeat_interleave(rep, dim=2) for t in (k, v))
    Sl = S // n
    pos = torch.arange(S, device=q.device)
    outs = []
    for my in range(n):
        qb = q[:, my * Sl:(my + 1) * Sl]
        m = torch.full((B, H, Sl), float("-inf"), device=q.device)
        l = torch.zeros((B, H, Sl), device=q.device)
        acc = torch.zeros((B, Sl, H, D), device=q.device)
        for j in range(my + 1):
            mask = (pos[j * Sl:(j + 1) * Sl][None, :]
                    <= pos[my * Sl:(my + 1) * Sl][:, None])
            m, l, acc = attention_block_accumulate(
                qb, kr[:, j * Sl:(j + 1) * Sl], vr[:, j * Sl:(j + 1) * Sl],
                m, l, acc, scale=D ** -0.5, mask=mask)
        outs.append(attention_finalize(l, acc))
    out = torch.cat(outs, 1)
    return (out.detach(), *torch.autograd.grad(out, (q, k, v), do.float()))


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16],
                         ids=["f32", "bf16"])
@pytest.mark.parametrize("n", [2, 3, 4])
def test_ring_block_path_matches_the_plain_ring(cuda, n, dtype):
    """The ring's kernel path (flash forward per block at global offsets,
    the log-sum-exp merge, flash backward per block with the global lse)
    against the plain ring, causal, GQA 4:1, blocks of 100 rows (no tile
    divides them), with exactly n(n+1)/2 launches of each kernel."""
    rng = np.random.RandomState(20 + n)
    B, Sl, H, Hkv, D = 1, 100, 8, 2, 128
    q, do = (_randn(rng, (B, n * Sl, H, D), dtype, cuda) for _ in range(2))
    k, v = (_randn(rng, (B, n * Sl, Hkv, D), dtype, cuda) for _ in range(2))
    before = (fa.launches, fa.bwd_dq_launches,
              fa.bwd_dkv_launches + fa.bwd_dkv_per_head_launches)
    o, lse, *grads = _ring_kernel_blocks(q, k, v, do, n)
    torch.cuda.synchronize()
    ran = tuple(a - b for a, b in zip(
        (fa.launches, fa.bwd_dq_launches,
         fa.bwd_dkv_launches + fa.bwd_dkv_per_head_launches), before))
    assert ran == (n * (n + 1) // 2,) * 3, ran
    o_ref, *g_ref = _plain_ring_blocks(q, k, v, do, n)
    _, lse_ref = fa.flash_attention_fwd(q, k, v, causal=True)
    np.testing.assert_allclose(lse.cpu(), lse_ref.cpu(), atol=1e-3 if
                               dtype == torch.bfloat16 else 2e-5, rtol=0)
    if dtype == torch.float32:
        for got, want in zip([o] + grads, [o_ref] + g_ref):
            np.testing.assert_allclose(got.cpu(), want.cpu(), **dict(
                atol=2e-5, rtol=2e-5))
    else:
        assert (o.float() - o_ref).abs().max().item() <= TOL[dtype]
        for got, want in zip(grads, g_ref):
            err = (got.float() - want).abs().max().item()
            assert err <= 1e-2 * want.abs().max().item(), err


@pytest.mark.parametrize("n_experts", [0, 8], ids=["dense", "moe"])
def test_world_size_one_mesh_step_matches_the_plain_step(cuda, n_experts):
    """CompiledTrainStep through make_mesh() (NCCL, a world of one; every
    collective over a group of one) against the same step without a mesh,
    float32, TF32 off: two steps' losses and gradients within 1e-6; for
    the Mixtral-style model (8 experts, top-2) the routing goes through
    the gathered global logits and the ep/tp reduce."""
    import torch.distributed as dist

    from ray_tpu_torch.models import LlamaConfig
    from ray_tpu_torch.parallel.mesh import make_mesh
    from ray_tpu_torch.train import CompiledTrainStep
    from ray_tpu_torch.train.optim import leaves

    cfg = LlamaConfig(vocab_size=256, hidden_size=512, intermediate_size=1024,
                      num_layers=2, num_heads=4, num_kv_heads=2,
                      rope_theta=10_000.0, dtype=torch.float32, loss_chunk=64,
                      n_experts=n_experts)
    tokens = torch.tensor(np.random.RandomState(4).randint(0, 256, (1, 257)),
                          dtype=torch.int32, device=cuda)
    started = not dist.is_initialized()
    try:
        plain = CompiledTrainStep(cfg)
        meshed = CompiledTrainStep(cfg, mesh=make_mesh())
        assert dist.get_backend() == "nccl" and dist.get_world_size() == 1
        runs = [(s, *s.init(torch.Generator(device=cuda).manual_seed(3)))
                for s in (plain, meshed)]
        for _ in range(2):
            (a, b) = (s(p, o, tokens)[2].item() for s, p, o in runs)
            assert abs(a - b) <= 1e-6, (a, b)
            for x, y in zip(leaves(plain.grads), leaves(meshed.grads)):
                assert (x - y).abs().max().item() <= 1e-6
    finally:
        if started and dist.is_initialized():
            dist.destroy_process_group()


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16],
                         ids=["f32", "bf16"])
def test_ep_blocks_sum_to_the_whole_layer(cuda, dtype):
    """An MoE layer (8 experts, top-2, capacity factor 1.25) routed once
    and run as 4 expert blocks of 2, as the ranks of an ep = 4 world run
    it, sums to the whole layer, with the same dispatch (the router is
    float32 either way)."""
    from ray_tpu_torch.parallel import moe

    rng = np.random.RandomState(11)
    T, M, Fd, E = 256, 256, 512, 8
    x = _randn(rng, (1, T, M), dtype, cuda)
    router = torch.from_numpy(rng.randn(M, E).astype(np.float32) * 0.3).to(
        cuda)
    w_gate, w_up = (_randn(rng, (E, M, Fd), dtype, cuda) * M ** -0.5
                    for _ in range(2))
    w_down = _randn(rng, (E, Fd, M), dtype, cuda) * Fd ** -0.5
    whole, _ = moe.moe_ffn(x, router, w_up, w_down, w_gate=w_gate)
    dispatch, combine, _ = moe.route(x, router)
    logits = x.reshape(T, M).float() @ router
    assert torch.equal(dispatch, moe.top_k_routing(
        logits, 2, int(1.25 * 2 * T / E))[0])
    got = sum(moe.expert_block(x.reshape(T, M), dispatch, combine,
                               w_up[e:e + 2], w_down[e:e + 2],
                               w_gate[e:e + 2], first_expert=e)
              for e in range(0, E, 2))
    ref = whole.reshape(T, M).float()
    err = (got.float() - ref).abs().max().item()
    assert err <= TOL[dtype] * ref.abs().max().item(), err


def test_dryrun_multichip_runs_on_the_cards(cuda):
    """The dry run with no device given runs on the cards, over NCCL, one
    process a card (at one card, the dense step alone)."""
    import torch.distributed as dist

    from ray_tpu_torch.parallel.dryrun import dryrun_multichip

    n = (dist.get_world_size() if dist.is_initialized()
         else torch.cuda.device_count())
    out = dryrun_multichip(n)
    assert all(v is None or np.isfinite(v) for v in out.values()), out
    assert out["dense"] > 0 and ("moe" in out) == (n >= 2), out


def test_paged_kernel_layer_form_and_refusals(cuda):
    rng = np.random.RandomState(9)
    L, Hkv, P, page, D = 3, 2, 6, 16, 128
    q = _randn(rng, (2, 4, D), torch.bfloat16, cuda)
    k_pool = _randn(rng, (L, Hkv, P, page, D), torch.bfloat16, cuda)
    v_pool = _randn(rng, (L, Hkv, P, page, D), torch.bfloat16, cuda)
    table = torch.tensor([[5, 1, 3], [0, 2, 4]], dtype=torch.int32,
                         device=cuda)
    lengths = torch.tensor([40, 7], dtype=torch.int32, device=cuda)
    for layer in range(L):
        out = pa.paged_decode_attention(q, k_pool, v_pool, table, lengths,
                                        layer=layer)
        ref = pa.paged_decode_reference(q, k_pool[layer], v_pool[layer],
                                        table, lengths)
        torch.testing.assert_close(out.float(), ref.float(), atol=2e-2,
                                   rtol=2e-2)
    with pytest.raises(ValueError, match="int32"):
        pa.paged_decode_attention(q, k_pool[0], v_pool[0], table.long(),
                                  lengths)
    with pytest.raises(ValueError, match="float32 or bfloat16"):
        half = q.half()
        fa.flash_attention(half[:, None], half[:, None], half[:, None])
    with pytest.raises(ValueError, match="contiguous"):
        qt = _randn(rng, (1, 8, 4, 64), torch.bfloat16, cuda).transpose(1, 2)
        fa.flash_attention(qt, qt, qt)


def _assert_same_tree(got, want, device):
    from ray_tpu_torch.train import AdamState

    if isinstance(want, AdamState):
        assert isinstance(got, AdamState) and got.count == want.count
        got, want = (got.mu, got.nu), (want.mu, want.nu)
    if isinstance(want, (dict, list, tuple)):
        keys = want if isinstance(want, dict) else range(len(want))
        assert len(got) == len(want)
        for k in keys:
            _assert_same_tree(got[k], want[k], device)
    elif isinstance(want, torch.Tensor):
        assert got.device.type == device and got.dtype == want.dtype
        assert torch.equal(got.cpu(), want.cpu())
    else:
        assert got == want


def test_checkpoint_saved_on_the_card_restores_bitwise(cuda, tmp_path):
    """A tree of card tensors (bf16, float32, int64, a strided view, an
    AdamState) saved from the card comes back bitwise on the card and on
    the CPU."""
    from ray_tpu_torch.train import AdamState, Checkpoint

    g = torch.Generator(device="cuda").manual_seed(0)
    w = torch.randn(64, 33, generator=g, device=cuda)
    tree = {"w": w.to(torch.bfloat16), "b": w[:, 3:5], "i": torch.arange(
        5, device=cuda), "opt": AdamState(2, {"w": w.to(torch.bfloat16)},
                                         {"w": (w * w).to(torch.bfloat16)}),
            "n": [3, 0.5]}
    ck = Checkpoint.from_pytree(tree, str(tmp_path / "ck"), step=1)
    assert ck.is_committed()
    _assert_same_tree(ck.as_pytree(device="cuda"), tree, "cuda")
    _assert_same_tree(ck.as_pytree(device="cpu"), tree, "cpu")


def test_as_pytree_restores_to_the_card_by_default(cuda, tmp_path):
    from ray_tpu_torch.train import Checkpoint, TorchPredictor

    ck = Checkpoint.from_pytree({"w": torch.ones(3, 2)},
                                str(tmp_path / "ck"))
    assert ck.as_pytree()["w"].device.type == "cuda"
    pred = TorchPredictor.from_checkpoint(ck,
                                          apply_fn=lambda p, x: x @ p["w"])
    out = pred.predict({"x": np.ones((4, 3), np.float32)})["predictions"]
    np.testing.assert_array_equal(out, np.full((4, 2), 3.0, np.float32))


@pytest.fixture
def no_tf32():
    """TF32 off for cuDNN and matmuls during the test, restored after."""
    was = (torch.backends.cudnn.allow_tf32,
           torch.backends.cuda.matmul.allow_tf32)
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    yield
    (torch.backends.cudnn.allow_tf32,
     torch.backends.cuda.matmul.allow_tf32) = was


def _on(tree, device):
    """A copy of a tree of dicts, AdamStates and tensors on ``device``."""
    from ray_tpu_torch.train import AdamState

    if isinstance(tree, AdamState):
        return AdamState(tree.count, _on(tree.mu, device),
                         _on(tree.nu, device))
    if isinstance(tree, dict):
        return {k: _on(v, device) for k, v in tree.items()}
    if isinstance(tree, torch.Tensor):
        return tree.to(device, copy=True)
    return tree


def _flat_tensors(tree, prefix=""):
    if isinstance(tree, dict):
        return {k: v for name, sub in tree.items()
                for k, v in _flat_tensors(sub, f"{prefix}{name}.").items()}
    return {prefix[:-1]: tree}


def _assert_close_trees(got, want, tol, what):
    """Every leaf within ``tol`` of its own max|ref|."""
    want = _flat_tensors(want)
    got = _flat_tensors(got)
    assert got.keys() == want.keys()
    for k, w in want.items():
        d = (got[k].detach().cpu() - w).abs().max().item()
        assert d <= tol * w.abs().max().item(), (what, k, d)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_resnet_block_on_the_card_matches_the_cpu(cuda, no_tf32, dtype):
    """A projecting ResNet block (stride 2, 8 -> 16 channels, "SAME"
    padding 0 before and 1 after) in train and eval mode, card against
    CPU from the same weights, TF32 off: 1e-4 (float32) or 2e-2 (bf16
    convolutions) of max|ref|, batch statistics too. On the card the
    input is NCHW over channels-last memory, as the model gives it."""
    from ray_tpu_torch.models.resnet import ResNetBlock

    block = ResNetBlock(16, (2, 2), dtype)
    g = torch.Generator().manual_seed(0)
    params, stats = block.init(g, 8, torch.device("cpu"))
    params["norm2"]["scale"] = 1 + 0.1 * torch.randn(16, generator=g)
    x = torch.randn(4, 8, 10, 10, generator=g)
    x_card = x.to(cuda).contiguous(memory_format=torch.channels_last)

    tol = TOL[dtype] if dtype == torch.bfloat16 else 1e-4
    for train in (True, False):
        want, want_stats = block.apply(params, stats, x, train)
        got, got_stats = block.apply(_on(params, cuda), _on(stats, cuda),
                                     x_card, train)
        assert got.shape == want.shape == (4, 16, 5, 5)
        assert got.dtype == torch.float32
        top = want.abs().max().item()
        assert (got.cpu() - want).abs().max().item() <= tol * top
        _assert_close_trees(got_stats, want_stats, tol, "batch_stats")


class _Recorded:
    """An optimizer that keeps CPU copies of what ``update`` was given."""

    def __init__(self, tx):
        self.tx = tx

    def update(self, params, grads, state):
        self.given = (_on(params, "cpu"), _on(grads, "cpu"),
                      _on(state, "cpu"))
        return self.tx.update(params, grads, state)


def test_resnet_step_on_the_card_matches_the_cpu(cuda, no_tf32):
    """One ``train_step`` of a two-stage float32 ResNet on NHWC input, so
    the card runs cuDNN's channels-last forward and backward: loss and new
    batch statistics within 1e-4 of the CPU's from the same weights, every
    kernel and norm gradient within 1e-3 of its max|ref| (TF32 off); and
    the fused AdamW on the card's gradients gives the params and moments
    that the CPU's AdamW gives on the same gradients and state (and the
    betas rounded to float32, as the card's kernel rounds them), within
    1e-5. bf16 is left to the block test: a bf16 gradient's rounding,
    amplified by the norms' cancellation, is no test of the layout."""
    from ray_tpu_torch.models import resnet
    from ray_tpu_torch.train import AdamW

    model = resnet.ResNet([1, 1], num_classes=10, num_filters=8,
                          dtype=torch.float32)
    adam = AdamW(1e-2, weight_decay=0.0)
    g = torch.Generator().manual_seed(0)
    cpu = resnet.create_train_state(model, g, (4, 16, 16, 3), adam, "cpu")
    for name, block, _ch in model.blocks():
        cpu["params"][name]["norm2"]["scale"] = 1 + 0.1 * torch.randn(
            block.filters, generator=g)
    x = torch.randn(4, 16, 16, 3, generator=g)
    y = torch.randint(0, 10, (4,), generator=g)
    card = _on(cpu, cuda)

    want_loss, want_grads, want_stats = resnet.loss_and_grads(
        model, cpu, x, y)
    rec = _Recorded(adam)
    loss = resnet.train_step(model, card, x.to(cuda), y.to(cuda), rec)
    assert abs(loss.item() - want_loss.item()) <= 1e-4 * abs(
        want_loss.item())
    _assert_close_trees(card["batch_stats"], want_stats, 1e-4,
                        "batch_stats")
    params, grads, opt = rec.given
    _assert_close_trees(grads, want_grads, 1e-3, "grads")
    # The CUDA fused AdamW rounds the betas to float32 (1 - b2 is then off
    # by 1.29e-5 of itself); the CPU's is given the same rounded betas.
    AdamW(1e-2, b1=float(np.float32(0.9)), b2=float(np.float32(0.999)),
          weight_decay=0.0).update(params, grads, opt)
    _assert_close_trees(card["params"], params, 1e-5, "params")
    _assert_close_trees(card["opt_state"].mu, opt.mu, 1e-5, "mu")
    _assert_close_trees(card["opt_state"].nu, opt.nu, 1e-5, "nu")
    assert card["opt_state"].count == opt.count == 1 and card["step"] == 1


def test_ingest_on_the_card_equals_its_source_bitwise(cuda):
    """Batches fed through iter_device_batches while the consumer's stream
    is busy (a sleep kernel, then a kernel reading the batch) as the next
    batch's copy is queued on the side stream: every batch read on the
    card equals its source bitwise, in order, with JAX's dtypes, and
    every tensor of the batch is dropped after use so its memory
    recycles through the allocator."""
    from ray_tpu_torch.data import iter_device_batches

    rs = np.random.RandomState(3)
    src = [{"x": rs.randn(64, 256, 256).astype(np.float32),
            "y": rs.randint(0, 1000, (64,)),
            "z": rs.randn(8, 8)} for _ in range(6)]
    src[-1] = {k: v[:5] for k, v in src[-1].items()}  # a short last batch
    read = []
    for batch in iter_device_batches(iter(src), device=cuda):
        torch.cuda._sleep(20_000_000)  # holds the consumer's stream ~10 ms
        read.append({k: (t * 1).cpu() for k, t in batch.items()})
        del batch
    assert len(read) == len(src)
    for got, want in zip(read, src):
        assert got["x"].dtype == torch.float32
        assert got["y"].dtype == torch.int32
        assert got["z"].dtype == torch.float32
        np.testing.assert_array_equal(got["x"].numpy(), want["x"])
        np.testing.assert_array_equal(got["y"].numpy(),
                                      want["y"].astype(np.int32))
        np.testing.assert_array_equal(got["z"].numpy(),
                                      want["z"].astype(np.float32))


def test_hbm_snapshot_and_sample_read_the_allocator(cuda):
    """hbm_snapshot's byte counts are torch.cuda.memory_stats' at the same
    moment, its limit the card's total; sample() publishes one series per
    gauge for gpu:0."""
    from ray_tpu_torch.util import device_metrics as dm
    from ray_tpu_torch.util import metrics

    keep = torch.empty(64 << 20, dtype=torch.uint8, device=cuda)
    snap = dm.hbm_snapshot(cuda)
    stats = torch.cuda.memory_stats(cuda)
    assert snap["bytes_in_use"] == stats["allocated_bytes.all.current"]
    assert snap["peak_bytes_in_use"] == stats["allocated_bytes.all.peak"]
    assert snap["bytes_reserved"] == stats["reserved_bytes.all.current"]
    assert snap["peak_bytes_reserved"] == stats["reserved_bytes.all.peak"]
    assert snap["bytes_in_use"] >= keep.numel()
    total = torch.cuda.mem_get_info(cuda)[1]
    assert abs(snap["bytes_limit"] - total) <= 0.01 * total
    assert 0.0 <= snap["fragmentation"] <= 1.0
    assert dm.hbm_snapshot() == dm.hbm_snapshot(cuda.index or 0)
    (info,) = dm.sample()
    assert info["device"] == "gpu:0" and info["platform"] == "gpu"
    report = metrics.get_metrics_report()
    for name in ("ray_tpu_device_memory_bytes_in_use",
                 "ray_tpu_device_memory_peak_bytes",
                 "ray_tpu_device_memory_limit_bytes",
                 "ray_tpu_device_memory_fragmentation_ratio"):
        series = report[name]["series"]
        assert list(series) == [(("device", "gpu:0"), ("node", "local"))]
    assert report["ray_tpu_device_memory_bytes_in_use"]["series"][
        (("device", "gpu:0"), ("node", "local"))] == info["bytes_in_use"]
    del keep


def _chip_smoke():
    import importlib.util
    import os

    path = os.path.join(os.path.dirname(os.path.dirname(
        os.path.abspath(__file__))), "chip_smoke.py")
    spec = importlib.util.spec_from_file_location("chip_smoke", path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


@pytest.mark.parametrize("kind", ["ppo", "sac"])
def test_rllib_learner_on_the_card_matches_the_cpu(cuda, no_tf32, kind):
    """Three updates of the PPO and SAC learners (hidden 64, minibatch
    128) on the card and on the CPU from the same weights: chip_smoke
    phase 12a's tolerances, every stat within 1e-5 relative (+1e-6) and
    every weight and target within 1e-4."""
    cs = _chip_smoke()
    batches = [cs.rl_batch(kind, 128, np.random.RandomState(i))
               for i in range(3)]
    runs = {}
    for dev in ("cuda", "cpu"):
        lrn, step = cs.rl_learner(kind, dev)
        assert lrn.device.type == dev
        runs[dev] = ([{k: float(v) for k, v in step(b, i).items()}
                      for i, b in enumerate(batches)], cs.rl_state(lrn))
    (gs, gw), (ws, ww) = runs["cuda"], runs["cpu"]
    for g, w in zip(gs, ws):
        assert g.keys() == w.keys()
        for k in w:
            assert abs(g[k] - w[k]) <= 1e-5 * abs(w[k]) + 1e-6, (k, g, w)
    for k in ww:
        assert np.abs(gw[k] - ww[k]).max() <= 1e-4, k


@pytest.mark.parametrize("kind", _chip_smoke().RL_MORE_KINDS)
def test_rllib_more_learner_on_the_card_matches_the_cpu(cuda, no_tf32,
                                                        kind):
    """Each learner of chip_smoke phase 13 (width 16, 8 sequences or 32
    rows) defaults to the card and takes three updates there and on the
    CPU from the same weights and batches: its discrete choices equal,
    every stat within 1e-5 relative (+1e-6), every weight and target
    within 1e-4 (DT's key biases, whose gradient is zero in exact
    arithmetic, held by their effect on the logits)."""
    cs = _chip_smoke()
    n = 8 if kind in ("r2d2", "recurrent_ppo", "dt") else 32
    batches = [cs.rl_more_batch(kind, n, np.random.RandomState(i), 16)
               for i in range(3)]
    assert cs.rl_more_learner(kind, None, 16)[0].device.type == "cuda"
    runs = {}
    for dev in ("cuda", "cpu"):
        lrn, step = cs.rl_more_learner(kind, dev, 16)
        choices, stats = [], []
        for i, b in enumerate(batches):
            if kind in cs.RL_CHOICE_KINDS:
                choices.append(cs.rl_more_choices(kind, lrn, b))
            stats.append({k: float(v) for k, v in step(b, i).items()})
        runs[dev] = (choices, stats, cs.rl_state(lrn), lrn)
    (gc, gs, gw, glrn), (wc, ws, ww, _) = runs["cuda"], runs["cpu"]
    for g, w in zip(gc, wc):
        np.testing.assert_array_equal(g, w)
    for g, w in zip(gs, ws):
        assert g.keys() == w.keys()
        for k in w:
            assert abs(g[k] - w[k]) <= 1e-5 * abs(w[k]) + 1e-6, (k, g, w)
    if kind == "dt":
        (gw, _), (ww, keys) = (cs.dt_split_key_biases(w, 16)
                               for w in (gw, ww))
        assert cs.dt_key_bias_effect(glrn, keys, batches[0]) <= 1e-5
    for k in ww:
        assert np.abs(gw[k] - ww[k]).max() <= 1e-4, k


def test_iter_torch_batches_lands_on_the_card_with_the_ingest_dtypes(cuda):
    """Dataset.iter_torch_batches puts batches on the card by default,
    through the ingest: float64 as float32 and int64 as int32 (JAX's
    dtypes with x64 off), or the dtype asked for."""
    from ray_tpu_torch import data as rd

    rs = np.random.RandomState(4)
    x, y = rs.randn(40, 8), rs.randint(0, 1000, (40,))
    ds = rd.from_numpy(x, column="x", override_num_blocks=3).zip(
        rd.from_numpy(y, column="y", override_num_blocks=3))
    batches = list(ds.iter_torch_batches(batch_size=16))
    assert [len(b["y"]) for b in batches] == [16, 16, 8]
    for b in batches:
        assert b["x"].is_cuda and b["x"].dtype == torch.float32
        assert b["y"].is_cuda and b["y"].dtype == torch.int32
    np.testing.assert_array_equal(
        torch.cat([b["x"] for b in batches]).cpu().numpy(),
        x.astype(np.float32))
    np.testing.assert_array_equal(
        torch.cat([b["y"] for b in batches]).cpu().numpy(),
        y.astype(np.int32))
    wide = next(ds.iter_torch_batches(batch_size=16,
                                      dtypes={"x": torch.float64}))
    assert wide["x"].dtype == torch.float64 and wide["x"].is_cuda


def predict_small(params, tokens):
    """A BatchPredictor apply_fn: chip_smoke's scores on phase 4's model,
    with this process's flash launch count beside each row."""
    cs = _chip_smoke()
    out = cs.score_rows(params, tokens, cs.small_f32_config())
    out["flash_fwd"] = torch.full((tokens.shape[0],), fa.launches)
    return out


def test_batch_predictor_in_a_gpu_actor_matches_the_driver(cuda, tmp_path):
    """BatchPredictor's pool member asks for a card: it restores the
    checkpoint there and scores through the flash kernel, equal to the
    driver's own forward on the same rows, batch by batch."""
    import ray_tpu_torch as rt
    from ray_tpu_torch import data as rd
    from ray_tpu_torch.models import init_params
    from ray_tpu_torch.train import BatchPredictor, Checkpoint, TorchPredictor

    cs = _chip_smoke()
    cfg = cs.small_f32_config()
    params = init_params(cfg, torch.Generator(device=cuda).manual_seed(0),
                         cuda)
    ck = Checkpoint.from_pytree(params, str(tmp_path / "ck"))
    tokens = np.random.RandomState(0).randint(0, 256, (12, 64)).astype(
        np.int32)
    want = [{k: v.cpu().numpy() for k, v in cs.score_rows(
        params, torch.from_numpy(tokens[i:i + 4]).to(cuda), cfg).items()}
        for i in range(0, 12, 4)]
    rt.init(num_cpus=2)
    try:
        scored = BatchPredictor(ck, TorchPredictor,
                                apply_fn=predict_small).predict(
            rd.from_numpy(tokens, column="x", override_num_blocks=3),
            concurrency=1, batch_size=4)
        assert scored._stages[-1].ray_remote_args == {"num_gpus": 1}
        got = scored.to_numpy()
    finally:
        rt.shutdown()
    np.testing.assert_array_equal(
        got["next_token"], np.concatenate([w["next_token"] for w in want]))
    np.testing.assert_allclose(
        got["logprob"], np.concatenate([w["logprob"] for w in want]),
        rtol=0, atol=1e-4)
    assert got["flash_fwd"][-1] == cfg.num_layers * 3


def test_gpu_replica_serves_the_drivers_tokens(cuda):
    """LLMDeployment as a GPU replica of ray_tpu_torch.serve (its default
    device, the card) draws phase 4's small model from the same seed as
    the driver and gives the driver's engine's greedy tokens through
    handle.remote and the handle's streaming call."""
    import ray_tpu_torch as rt
    from ray_tpu_torch import serve
    from ray_tpu_torch.models import init_params
    from ray_tpu_torch.serve.llm import LLMDeployment, LLMEngine

    cfg = _chip_smoke().small_f32_config()
    params = init_params(cfg, torch.Generator(device=cuda).manual_seed(0),
                         cuda)
    rng = np.random.RandomState(3)
    prompts = [rng.randint(0, cfg.vocab_size, n).tolist() for n in (9, 140)]
    eng = LLMEngine(cfg, params, device=cuda, max_batch=2, max_len=256)
    try:
        want = [eng.generate(p, 8, timeout=300) for p in prompts]
    finally:
        eng.shutdown()
    del params
    rt.init(num_cpus=2)
    try:
        h = serve.run(serve.deployment(LLMDeployment).options(
            name="llm", ray_actor_options={"num_gpus": 1,
                                           "max_concurrency": 4}).bind(
            cfg, seed=0, max_batch=2, max_len=256))
        reqs = [{"prompt": p, "max_new_tokens": 8} for p in prompts]
        got = [f.result(timeout=300)["tokens"]
               for f in [h.remote(r) for r in reqs]]
        streamed = [[i["token"] for i in h.options(method="stream").stream(r)]
                    for r in reqs]
    finally:
        serve.shutdown()
        rt.shutdown()
    assert got == streamed == want


def test_ppo_build_puts_the_learner_on_the_card(cuda):
    """PPOConfig().build() with no device gives the learner the card, its
    runners CPU actors of the port's runtime; one train() runs and the
    runners' weights come back from the card."""
    import ray_tpu_torch as rt
    from ray_tpu_torch.rllib import PPOConfig

    import test_torch_rllib_loops as loops

    rt.init(num_cpus=2)
    try:
        algo = (PPOConfig().environment(loops.Sign)
                .env_runners(num_env_runners=2, rollout_fragment_length=64)
                .training(train_batch_size=128, num_epochs=2)
                .debugging(seed=0).build())
        try:
            assert algo.learner.device.type == "cuda"
            result = algo.train()
        finally:
            algo.stop()
    finally:
        rt.shutdown()
    assert result["num_env_steps_sampled"] == 128
    assert np.isfinite(result["total_loss"])
