"""The port's flash-attention backward against the JAX package's: gradients
through the Pallas kernels (interpret mode, ``jax.grad`` through their
``custom_vjp``) against the port's plain backward and its autograd Function
on the CPU, with the JAX kernel tests' cases and tolerances
(tests/test_flash_attention.py:54-151). The CUDA kernels are held against
the same plain backward on the card (tests/test_torch_cuda.py)."""

import importlib

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ray_tpu_torch.ops import flash_attention as fa

# ray_tpu.ops re-exports a function of the module's name.
jax_fa = importlib.import_module("ray_tpu.ops.flash_attention")

# (B, Sq, Skv, H, Hkv, D, q_offset, squared loss, tolerance): the JAX
# tests' cases, at S = 64 with 32-row blocks so every case still spans
# several tiles and the causal bounds skip some.
CASES = {
    "plain": (1, 64, 64, 2, 2, 32, 0, False, 2e-5),
    "gqa": (1, 64, 64, 4, 2, 32, 0, True, 3e-5),
    "q_offset": (1, 64, 128, 2, 2, 32, 64, False, 2e-5),
    "per_head": (1, 64, 64, 4, 2, 32, 0, True, 3e-5),
}


def _jax_grads(q, k, v, q_offset, squared):
    def loss(q, k, v):
        out = jax_fa.flash_attention(q, k, v, causal=True, q_offset=q_offset,
                                     block_q=32, block_k=32, interpret=True)
        return (out ** 2).sum() if squared else out.sum()

    grads = jax.jit(jax.grad(loss, argnums=(0, 1, 2)))(
        *map(jnp.asarray, (q, k, v)))
    return [np.asarray(g) for g in grads]


@pytest.mark.parametrize("case", sorted(CASES))
def test_backward_matches_pallas_kernels(case, monkeypatch):
    B, Sq, Skv, H, Hkv, D, qo, squared, tol = CASES[case]
    if case == "per_head":
        # Both packages take their per-query-head dK/dV path.
        monkeypatch.setattr(jax_fa, "_DKV_GROUP_VMEM_BUDGET", 0)
        monkeypatch.setattr(fa, "DKV_GRID", "per_head")
    else:  # a grid this small would take the per-head path on the card
        monkeypatch.setattr(fa, "DKV_GRID", "kv_head")
    assert fa.dkv_per_head(B, H, Hkv, Sq, Skv, D, dtype=torch.float32) == (
        case == "per_head")
    rng = np.random.RandomState(len(case))
    q = rng.randn(B, Sq, H, D).astype(np.float32)
    k = rng.randn(B, Skv, Hkv, D).astype(np.float32)
    v = rng.randn(B, Skv, Hkv, D).astype(np.float32)
    want = _jax_grads(q, k, v, qo, squared)

    # The autograd Function (forward and backward through the wrappers).
    tq, tk, tv = (torch.from_numpy(x).requires_grad_() for x in (q, k, v))
    out = fa.flash_attention(tq, tk, tv, causal=True, q_offset=qo)
    ((out ** 2).sum() if squared else out.sum()).backward()
    for got, w in zip((tq.grad, tk.grad, tv.grad), want):
        np.testing.assert_allclose(got.numpy(), w, atol=tol, rtol=tol)

    # The plain backward, formula by formula, from the forward's O and lse.
    tq, tk, tv = map(torch.from_numpy, (q, k, v))
    o, lse = fa.flash_attention_reference(tq, tk, tv, causal=True,
                                          q_offset=qo)
    do = 2 * o if squared else torch.ones_like(o)
    got = fa.flash_attention_bwd_reference(tq, tk, tv, o, lse, do,
                                           causal=True, q_offset=qo)
    for g, w in zip(got, want):
        np.testing.assert_allclose(g.numpy(), w, atol=tol, rtol=tol)


def test_wrapper_on_cpu_is_the_plain_backward_and_counts_nothing():
    rng = np.random.RandomState(0)
    q, o, do = (torch.from_numpy(rng.randn(2, 9, 4, 8).astype(np.float32))
                for _ in range(3))
    k, v = (torch.from_numpy(rng.randn(2, 11, 2, 8).astype(np.float32))
            for _ in range(2))
    lse = torch.from_numpy(rng.randn(8, 9).astype(np.float32))
    kw = dict(causal=True, q_offset=2, kv_offset=0)
    before = (fa.bwd_dq_launches, fa.bwd_dkv_launches,
              fa.bwd_dkv_per_head_launches)
    got = fa.flash_attention_bwd(q, k, v, o, lse, do, **kw)
    want = fa.flash_attention_bwd_reference(q, k, v, o, lse, do, **kw)
    assert all(torch.equal(a, b) for a, b in zip(got, want))
    assert [g.shape for g in got] == [q.shape, k.shape, v.shape]
    assert (fa.bwd_dq_launches, fa.bwd_dkv_launches,
            fa.bwd_dkv_per_head_launches) == before
    with pytest.raises(ValueError, match="lse must be float32"):
        fa.flash_attention_bwd(q, k, v, o, lse[:4], do, **kw)
    meta = [t.to("meta") for t in (q, k, v, o, lse, do)]
    with pytest.raises(ValueError, match="cuda or cpu"):
        fa.flash_attention_bwd(*meta, **kw)


def test_dkv_switch_follows_the_grid_size():
    """The dK/dV grid rule at the 8B shapes (H=32, Hkv=8, D=128, causal,
    bf16), by the longest block chain. A KV-head block of key tile 0 walks
    rep = 4 heads x S/64 query tiles, a per-head block S/64: at B = 1 the
    KV-head grid's 8 x S/128 blocks leave its chain above the steps each of
    the 132 SMs gets, so per-head is faster (S = 512 and 2048); at B = 8
    the steps over the SMs exceed either chain and the per-head grid's
    float32 round trip decides for the KV-head grid. MHA never takes the
    per-head grid; DKV_GRID forces either."""
    bf16 = torch.bfloat16
    assert fa.dkv_per_head(1, 32, 8, 512, 512, 128, dtype=bf16)
    assert fa.dkv_per_head(1, 32, 8, 2048, 2048, 128, dtype=bf16)
    assert not fa.dkv_per_head(8, 32, 8, 2048, 2048, 128, dtype=bf16)
    assert not fa.dkv_per_head(8, 32, 8, 512, 512, 128, dtype=bf16)
    assert not fa.dkv_per_head(1, 8, 8, 2048, 2048, 128, dtype=bf16)
    # The chains behind the B = 1, S = 2048 decision: 128 steps (KV-head)
    # against the larger of 32 (per-head) and ceil(8704 / 132) = 66.
    kv, ph = fa.dkv_grid_estimates(1, 32, 8, 2048, 2048, 128, dtype=bf16)
    step = 8.0 * 128 * 64 * 128 / fa.DKV_SM_FLOPS_PER_S[True]
    assert kv == pytest.approx(128 * step)
    assert ph == pytest.approx(66 * step + 4 * 2048 * 32 * 128 * 4
                               / fa.HBM_BYTES_PER_S)
    # Non-causal: every block chains the same, and a grid that fills the
    # SMs once (B = 1, 128 KV-head blocks) is bound by its chain.
    kv, ph = fa.dkv_grid_estimates(1, 32, 8, 2048, 2048, 128, dtype=bf16,
                                   causal=False)
    assert kv == pytest.approx(128 * step)
    # The scalar kernels' tiles (float32, odd D, and half rows past D 128),
    # then forcing.
    assert fa.bwd_tiles(torch.float32, 128) == (64, 64)
    assert fa.bwd_tiles(bf16, 100) == (64, 64)
    assert fa.bwd_tiles(bf16, 256) == (32, 32)
    assert fa.bwd_tiles(bf16, 128) == (128, 64)
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(fa, "DKV_GRID", "kv_head")
        assert not fa.dkv_per_head(1, 32, 8, 2048, 2048, 128)
        mp.setattr(fa, "DKV_GRID", "per_head")
        assert fa.dkv_per_head(8, 32, 8, 2048, 2048, 128)
        assert not fa.dkv_per_head(8, 8, 8, 2048, 2048, 128)
        mp.setattr(fa, "DKV_GRID", "neither")
        with pytest.raises(ValueError, match="DKV_GRID"):
            fa.dkv_per_head(1, 32, 8, 2048, 2048, 128)
