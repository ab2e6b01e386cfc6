"""The port's mixture-of-experts path against the JAX package's, in float32
on the CPU at the default capacity factor (1.25), so that assignments are
dropped for want of capacity and the drop path is what gets compared.
Routing and ``moe_ffn`` are held to 2e-5, whole-model outputs to 1e-4.
Weights are JAX's (``LlamaConfig.tiny(moe=True)``: 2 layers, 4 experts,
top-2), carried over through numpy.

Where a model path routes, the test counts the port's dropped assignments
through a recorder around ``top_k_routing`` and asserts that some were
dropped."""

import dataclasses
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ray_tpu.models import LlamaConfig as JaxConfig
from ray_tpu.models import causal_lm_loss as jax_loss
from ray_tpu.models import forward as jax_forward_eager
from ray_tpu.models import generation as jg
from ray_tpu.models import init_params as jax_init
from ray_tpu.parallel import moe as jmoe
from ray_tpu.train.compiled_step import CompiledTrainStep as JaxStep
from ray_tpu_torch.models import (
    LlamaConfig,
    causal_lm_loss,
    forward,
    params_from_numpy,
)
from ray_tpu_torch.models import generation as tg
from ray_tpu_torch.models.llama import trainable_leaves
from ray_tpu_torch.parallel import moe as tmoe
from ray_tpu_torch.serve import llm
from ray_tpu_torch.serve.llm import LLMDeployment, LLMEngine
from ray_tpu_torch.train import AdamW, CompiledTrainStep
from ray_tpu_torch.train.optim import zeros_like_tree

ROUTE_TOL = dict(atol=2e-5, rtol=2e-5)
TOL = dict(atol=1e-4, rtol=1e-4)
# Prompts carry runs of one token id: rows that route alike overflow an
# expert, as real prompts' repeated tokens and a bucket's padding do.
TOKENS = np.random.RandomState(0).randint(0, 256, (2, 17)).astype(np.int32)
TOKENS[:, 9:] = 7

jax_forward = jax.jit(jax_forward_eager, static_argnums=(2,))
j_paged_prefill = jax.jit(jg.paged_prefill, static_argnums=(4,))
j_paged_decode = jax.jit(jg.paged_decode, static_argnums=(3,))
# The engine's geometry, shared by the paged tests (one JAX compile each).
SLOTS, PAGE, MAX_LEN = 3, 8, 64
PMAX = MAX_LEN // PAGE


def _np(tree):
    return jax.tree.map(np.asarray, tree)


def _t(a):
    return torch.from_numpy(np.asarray(a))


@functools.lru_cache(maxsize=None)
def _jax_params():  # jitted: the same draw, 3x faster than eager here
    return jax.jit(jax_init, static_argnums=0)(JaxConfig.tiny(moe=True),
                                               jax.random.PRNGKey(0))


@pytest.fixture(scope="module")
def tiny():
    cfg = LlamaConfig.tiny(moe=True)
    return (JaxConfig.tiny(moe=True), _jax_params(), cfg,
            params_from_numpy(_np(_jax_params()), cfg, "cpu"))


@pytest.fixture
def routed(monkeypatch):
    """Every ``top_k_routing`` call the port makes: (dispatch, token_mask,
    k). ``moe_ffn`` looks the function up in its module at each call."""
    calls = []
    inner = tmoe.top_k_routing

    def record(logits, k, capacity, token_mask=None):
        out = inner(logits, k, capacity, token_mask)
        calls.append((out[0], token_mask, k))
        return out

    monkeypatch.setattr(tmoe, "top_k_routing", record)
    return calls


def dropped(calls) -> int:
    """Assignments that found their expert full, over recorded calls."""
    n = 0
    for dispatch, mask, k in calls:
        rows = dispatch.shape[0] if mask is None else int(mask.sum())
        n += k * rows - int(dispatch.sum())
    return n


def _assert_trees_close(got, want, **tol):
    for k, w in want.items():
        if isinstance(w, dict):
            _assert_trees_close(got[k], w, **tol)
        else:
            np.testing.assert_allclose(got[k].detach().numpy(), w,
                                       err_msg=k, **tol)


# Router logits [T=16, E=4] tilted towards expert 0, so it overflows.
def _logits(seed):
    rng = np.random.RandomState(seed)
    return (rng.randn(16, 4) + [2.5, 0, 0, 0]).astype(np.float32)


ROUTING_CASES = {
    "k1": (_logits(1), 1, None),
    "k2": (_logits(2), 2, None),
    "k1_mask": (_logits(3), 1, np.arange(16) % 3 != 1),
    "k2_mask": (_logits(4), 2, np.arange(16) % 3 != 1),
    # Ties: jax.lax.top_k takes the lower expert index first (torch.topk
    # on the CPU the higher); with capacity 1 the order decides who stays.
    "tie": (np.array([[0, 1, 1, 0], [2, 2, 2, 2], [1, 0, 1, 1],
                      [0, 0, 3, 3]] * 4, np.float32), 2, None),
}


@pytest.mark.parametrize("case", sorted(ROUTING_CASES))
def test_top_k_routing_matches_jax(case):
    logits, k, mask = ROUTING_CASES[case]
    T, E = logits.shape
    capacity = 1 if case == "tie" else max(1, int(1.25 * k * T / E))
    jmask = None if mask is None else jnp.asarray(mask.astype(np.float32))
    want = jmoe.top_k_routing(jnp.asarray(logits), k, capacity, jmask)
    got = tmoe.top_k_routing(_t(logits), k, capacity,
                             None if mask is None else _t(mask))
    np.testing.assert_array_equal(got[0].numpy(), np.asarray(want[0]))
    np.testing.assert_allclose(got[1].numpy(), np.asarray(want[1]),
                               **ROUTE_TOL)
    np.testing.assert_allclose(float(got[2]), float(want[2]), **ROUTE_TOL)
    assert dropped([(got[0], None if mask is None else _t(mask), k)]) > 0
    if mask is not None:  # masked rows claim nothing
        assert got[0][_t(~mask)].sum() == 0
    if case == "tie":  # each expert's one slot goes to its first claimant
        first = got[0][:, :, 0].argmax(dim=0).tolist()
        assert first == [1, 0, 3, 3], first


@pytest.mark.parametrize("gated", [True, False], ids=["gated", "plain"])
def test_moe_ffn_matches_jax(gated):
    rng = np.random.RandomState(5)
    B, S, M, E, Fd = 2, 8, 16, 4, 32
    x = rng.randn(B, S, M).astype(np.float32)
    u = rng.randn(M).astype(np.float32)
    x += u  # a direction every row shares, which expert 0's router reads:
    router = (rng.randn(M, E) * 0.3).astype(np.float32)
    router[:, 0] += 3 * u / (u @ u)  # +3 on expert 0's logit: it overflows
    w_in, w_gate = (rng.randn(2, E, M, Fd) * M ** -0.5).astype(np.float32)
    w_out = (rng.randn(E, Fd, M) * Fd ** -0.5).astype(np.float32)
    mask = rng.rand(B, S) > 0.2
    want = jmoe.moe_ffn(
        *map(jnp.asarray, (x, router, w_in, w_out)),
        w_gate=jnp.asarray(w_gate) if gated else None,
        token_mask=jnp.asarray(mask.astype(np.float32)))
    got = tmoe.moe_ffn(*map(_t, (x, router, w_in, w_out)),
                       w_gate=_t(w_gate) if gated else None,
                       token_mask=_t(mask))
    np.testing.assert_allclose(got[0].numpy(), np.asarray(want[0]),
                               **ROUTE_TOL)
    np.testing.assert_allclose(float(got[1]), float(want[1]), **ROUTE_TOL)
    capacity = int(1.25 * 2 * B * S / E)
    logits = torch.from_numpy(x.reshape(-1, M)) @ _t(router)
    dispatch = tmoe.top_k_routing(logits, 2, capacity, _t(mask.reshape(-1)))[0]
    assert dropped([(dispatch, _t(mask.reshape(-1)), 2)]) > 0
    assert not got[0][_t(~mask)].any()  # unrouted rows get no output


def test_forward_logits_and_aux_match_jax(tiny, routed):
    jcfg, jparams, cfg, params = tiny
    want, want_aux = jax_forward(jparams, jnp.asarray(TOKENS[:, :-1]), jcfg)
    got, aux = forward(params, _t(TOKENS[:, :-1]), cfg)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)
    np.testing.assert_allclose(float(aux), float(want_aux), **TOL)
    assert float(aux) > 0 and len(routed) == cfg.num_layers
    assert dropped(routed) > 0


@functools.lru_cache(maxsize=None)
def _jax_value_and_grad(loss_chunk):
    cfg = dataclasses.replace(JaxConfig.tiny(moe=True), loss_chunk=loss_chunk)
    fn = jax.jit(jax.value_and_grad(
        lambda p: jax_loss(p, jnp.asarray(TOKENS), cfg)))
    loss, grads = fn(_jax_params())
    return float(loss), _np(grads)


@pytest.mark.parametrize("loss_chunk,scan_chunk", [(0, 0), (8, 2)],
                         ids=["whole", "chunked"])
def test_loss_and_grads_match_jax(tiny, routed, loss_chunk, scan_chunk):
    """The loss with its aux term, and every gradient (the router's through
    the aux loss and the combine weights), with a checkpoint per layer or
    one around both layers and the loss whole or in chunks."""
    want_loss, want_grads = _jax_value_and_grad(loss_chunk)
    cfg = dataclasses.replace(tiny[2], loss_chunk=loss_chunk,
                              scan_chunk=scan_chunk)
    grads = zeros_like_tree(tiny[3])
    top, layers = trainable_leaves(tiny[3], grads)
    loss = causal_lm_loss(top, _t(TOKENS), cfg, layers=layers)
    loss.backward()
    np.testing.assert_allclose(loss.item(), want_loss, **TOL)
    _assert_trees_close(grads, want_grads, **TOL)
    assert grads["layers"]["router"].dtype == torch.float32
    assert grads["layers"]["router"].abs().sum() > 0
    assert dropped(routed) > 0


def _paged_pair(jcfg, cfg, table):
    jcache = jg.PagedKVCache.create(jcfg, SLOTS, SLOTS * PMAX, PAGE, PMAX)
    tcache = tg.PagedKVCache.create(cfg, SLOTS, SLOTS * PMAX, PAGE, PMAX,
                                    device="cpu")
    return (jcache._replace(page_table=jnp.asarray(table)),
            tcache._replace(page_table=_t(table)))


def _prefill_both(tiny, caches, prompt, bucket, slot, table):
    jcfg, jparams, cfg, params = tiny
    toks = np.zeros((1, bucket), np.int32)
    toks[0, :len(prompt)] = prompt
    pages = table[slot, :bucket // PAGE]
    jl, jc = j_paged_prefill(jparams, jnp.asarray(toks),
                             jnp.asarray(len(prompt), jnp.int32), caches[0],
                             jcfg, jnp.asarray(slot), jnp.asarray(pages))
    tl, tc = tg.paged_prefill(params, _t(toks), len(prompt), caches[1], cfg,
                              slot, _t(pages))
    return np.asarray(jl), tl.numpy(), (jc, tc)


def _table():
    return np.arange(SLOTS * PMAX, dtype=np.int32)[::-1].reshape(
        SLOTS, PMAX).copy()


def test_paged_prefill_depends_on_the_bucket_as_in_jax(tiny, routed):
    """Prefill routes a bucket's padding too, and the padding takes expert
    capacity: one 12-token prompt gives other last-position logits in
    bucket 16 than in bucket 32, in JAX and in the port alike."""
    jcfg, cfg = tiny[0], tiny[2]
    prompt = TOKENS[0, :12]
    logits = {}
    for bucket in (16, 32):
        caches = _paged_pair(jcfg, cfg, _table())
        jl, tl, (jc, tc) = _prefill_both(tiny, caches, prompt, bucket, 1,
                                         _table())
        np.testing.assert_allclose(tl, jl, **TOL)
        np.testing.assert_allclose(tc.k.numpy(), np.asarray(jc.k), **TOL)
        assert tc.lengths.tolist() == [0, 12, 0]
        logits[bucket] = (jl, tl)
    for side in (0, 1):
        assert np.abs(logits[16][side] - logits[32][side]).max() > 1e-2
    assert dropped(routed) > 0


def test_paged_decode_with_an_inactive_slot_matches_jax(tiny, routed):
    """Two live slots around an idle one: 3 rows give each expert a
    capacity of 1, the idle row claims none, and the live rows' logits
    match JAX's step after step."""
    jcfg, jparams, cfg, params = tiny
    table = _table()
    caches = _paged_pair(jcfg, cfg, table)
    last = np.zeros(SLOTS, np.int32)
    for slot, n in ((0, 10), (2, 14)):
        jl, _, caches = _prefill_both(tiny, caches, TOKENS[1, :n], 16, slot,
                                      table)
        last[slot] = int(np.argmax(jl[0]))
    jcache, tcache = caches
    active = np.array([True, False, True])
    routed.clear()
    for _ in range(4):
        jl, jcache = j_paged_decode(jparams, jnp.asarray(last), jcache, jcfg,
                                    active=jnp.asarray(active))
        tl, tcache = tg.paged_decode(params, _t(last), tcache, cfg,
                                     active=_t(active))
        np.testing.assert_allclose(tl.numpy()[active],
                                   np.asarray(jl)[active], **TOL)
        last = np.where(active, np.asarray(jl).argmax(-1), 0).astype(np.int32)
    assert tcache.lengths.tolist() == [14, 0, 18]
    for dispatch, mask, _k in routed:
        assert dispatch.shape[-1] == 1  # capacity 1
        assert mask.reshape(-1).tolist() == active.tolist()
        assert dispatch[1].sum() == 0
    assert dropped(routed) > 0


def test_engine_greedy_matches_jax_paged_path(tiny, routed, monkeypatch):
    """Four requests through three slots of the engine, every prefill and
    decode call recorded with its bucket, slot, page table and active
    slots, then replayed through JAX's paged_prefill/paged_decode from an
    empty pool: each call's logits match at 1e-4 and its greedy tokens are
    the ones the engine emitted."""
    jcfg, jparams, cfg, params = tiny
    calls = []

    def recording(name, fn):
        def run(*args, **kw):
            snap = [a.clone() if torch.is_tensor(a) else a for a in args]
            cache = args[3] if name == "prefill" else args[2]
            kw_snap = {k: v.clone() for k, v in kw.items()}
            logits, out = fn(*args, **kw)
            calls.append((name, snap, kw_snap, cache.page_table.clone(),
                          logits.clone()))
            return logits, out
        return run

    monkeypatch.setattr(llm, "paged_prefill",
                        recording("prefill", llm.paged_prefill))
    monkeypatch.setattr(llm, "paged_decode",
                        recording("decode", llm.paged_decode))
    rng = np.random.RandomState(7)
    prompts = [np.concatenate([rng.randint(0, 256, n - 6), [7] * 6]).tolist()
               for n in (12, 20, 10, 14)]
    eng = LLMEngine(cfg, params, max_batch=SLOTS, max_len=MAX_LEN,
                    page_size=PAGE, device="cpu")
    try:
        reqs = [eng.submit(p, n) for p, n in zip(prompts, (6, 5, 7, 4))]
        outs = [r.result(timeout=120) for r in reqs]
    finally:
        eng.shutdown()
    assert [len(o) for o in outs] == [6, 5, 7, 4]
    assert sum(c[0] == "prefill" for c in calls) == 4

    jcache = jg.PagedKVCache.create(jcfg, SLOTS, SLOTS * PMAX, PAGE, PMAX)
    emitted = []
    for name, args, kw, table, tl in calls:
        jcache = jcache._replace(page_table=jnp.asarray(table.numpy()))
        if name == "prefill":
            _, toks, real, _, _, slot, pages = args
            jl, jcache = j_paged_prefill(
                jparams, jnp.asarray(toks.numpy()),
                jnp.asarray(real, jnp.int32), jcache, jcfg,
                jnp.asarray(slot), jnp.asarray(pages.numpy()))
            rows = np.array([0])
        else:
            active = kw["active"].numpy()
            jl, jcache = j_paged_decode(jparams, jnp.asarray(args[1].numpy()),
                                        jcache, jcfg,
                                        active=jnp.asarray(active))
            rows = np.flatnonzero(active)
        jl = np.asarray(jl)
        np.testing.assert_allclose(tl.numpy()[rows], jl[rows], **TOL)
        emitted.append(jl[rows].argmax(-1).tolist())
        assert emitted[-1] == tl.numpy()[rows].argmax(-1).tolist()
    assert sorted(sum(emitted, [])) == sorted(sum(outs, []))
    assert dropped(routed) > 0
    # The deployment serves the MoE config through the same engine.
    dep = LLMDeployment(cfg, params, max_batch=SLOTS, max_len=MAX_LEN,
                        page_size=PAGE, device="cpu")
    try:
        got = dep({"prompt": prompts[0], "max_new_tokens": 6})["tokens"]
    finally:
        dep.engine.shutdown()
    assert len(got) == 6 and all(0 <= t < cfg.vocab_size for t in got)


def test_three_steps_match_jax_compiled_step(tiny, routed):
    """Three CompiledTrainStep steps (AdamW) against JAX's step with
    optax.adamw from the same weights: losses at 1e-4 and the weights
    after step 3 within 2e-5, as in the dense test, save where a step-1
    gradient is under 1e-6. There AdamW's step, lr * g / (|g| + 1e-8),
    turns a float32 rounding difference in g (~1e-8 here, where the
    largest gradient is ~0.2) into a step of another size; such weights
    must still have moved by no more than three steps can move them. The
    router's moments are float32."""
    jcfg, jparams, cfg, _ = tiny
    jstep = JaxStep(jcfg, donate=False)
    jp, jo = jparams, jstep.tx.init(jparams)
    params = params_from_numpy(_np(jparams), cfg, "cpu")
    step = CompiledTrainStep(cfg, device="cpu")
    state = AdamW().init(params)
    toks = jnp.asarray(TOKENS)
    for i in range(3):
        jp, jo, jl = jstep(jp, jo, toks)
        _, _, loss = step(params, state, _t(TOKENS))
        np.testing.assert_allclose(float(loss), float(jl), **TOL)
        if i == 0:
            g1 = {k: v.clone() for k, v in step.grads["layers"].items()}
    want = _np(jp)
    for k in ("embed", "final_norm", "lm_head"):
        np.testing.assert_allclose(params[k].numpy(), want[k], atol=2e-5,
                                   rtol=0, err_msg=k)
    for k, w in want["layers"].items():
        d = np.abs(params["layers"][k].numpy() - w)
        tiny_g = g1[k].abs().numpy() < 1e-6
        assert d[~tiny_g].max() <= 2e-5, k
        assert d.max() <= 3 * 1e-3 * 1.01 and tiny_g.mean() < 1e-3, k
    _assert_trees_close(state.mu, _np(jo[0].mu), atol=1e-6, rtol=1e-4)
    assert state.mu["layers"]["router"].dtype == torch.float32
    assert dropped(routed) > 0
