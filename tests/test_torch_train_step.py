"""The port's training path against the JAX package's on
``LlamaConfig.tiny()`` (float32, 2 layers): loss and gradients of
``causal_lm_loss`` against ``jax.grad`` of the JAX one, every remat policy
and layer chunking, and ``CompiledTrainStep`` with AdamW against the JAX
step with ``optax.adamw``. Weights are JAX's, carried over through numpy;
the tolerance is the model tests' 1e-4."""

import dataclasses
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from torch.utils._python_dispatch import TorchDispatchMode

from ray_tpu.models import LlamaConfig as JaxConfig
from ray_tpu.models import causal_lm_loss as jax_loss
from ray_tpu.models import init_params as jax_init
from ray_tpu.train.compiled_step import CompiledTrainStep as JaxStep
from ray_tpu_torch.models import (
    LlamaConfig,
    adam_state_from_numpy,
    causal_lm_loss,
    params_from_numpy,
)
from ray_tpu_torch.models.llama import trainable_leaves
from ray_tpu_torch.train import AdamW, CompiledTrainStep
from ray_tpu_torch.train.optim import leaves, zeros_like_tree

TOL = dict(atol=1e-4, rtol=1e-4)
TOKENS = np.random.RandomState(0).randint(0, 256, (2, 17)).astype(np.int32)


def _tree_np(tree):
    return jax.tree.map(np.asarray, tree)


@functools.lru_cache(maxsize=None)
def _jax_params(seed=0):
    return jax_init(JaxConfig.tiny(), jax.random.PRNGKey(seed))


@pytest.fixture(scope="module")
def tiny():
    return _jax_params(), _tree_np(_jax_params())


@functools.lru_cache(maxsize=None)
def _jax_value_and_grad(loss_chunk=512):
    """JAX's loss and gradients at the tiny config. JAX's flash_attention
    takes its XLA path on the CPU, so use_flash gives JAX one program
    either way; it is computed once per loss_chunk."""
    cfg = dataclasses.replace(JaxConfig.tiny(), loss_chunk=loss_chunk)
    fn = jax.jit(jax.value_and_grad(
        lambda p: jax_loss(p, jnp.asarray(TOKENS), cfg)))
    loss, grads = fn(_jax_params())
    return float(loss), _tree_np(grads)


@pytest.fixture(scope="module")
def jax_step():
    return JaxStep(JaxConfig.tiny(), donate=False)


def _port_value_and_grad(tree, **fields):
    cfg = dataclasses.replace(LlamaConfig.tiny(), **fields)
    params = params_from_numpy(tree, cfg, "cpu")
    grads = zeros_like_tree(params)
    top, layers = trainable_leaves(params, grads)
    loss = causal_lm_loss(top, torch.from_numpy(TOKENS), cfg, layers=layers)
    loss.backward()
    return loss.item(), grads


def _assert_trees_close(got, want, **tol):
    for k, w in want.items():
        if isinstance(w, dict):
            _assert_trees_close(got[k], w, **tol)
        else:
            np.testing.assert_allclose(got[k].numpy(), w, err_msg=k, **tol)


@pytest.mark.parametrize("loss_chunk", [0, 8], ids=["whole", "chunked"])
@pytest.mark.parametrize("use_flash", [True, False], ids=["flash", "plain"])
def test_loss_and_grads_match_jax(tiny, loss_chunk, use_flash):
    want_loss, want_grads = _jax_value_and_grad(loss_chunk)
    loss, grads = _port_value_and_grad(tiny[1], loss_chunk=loss_chunk,
                                       use_flash=use_flash)
    np.testing.assert_allclose(loss, want_loss, **TOL)
    _assert_trees_close(grads, want_grads, **TOL)


class _CountMatmuls(TorchDispatchMode):
    def __init__(self):
        super().__init__()
        self.n = 0

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        self.n += func is torch.ops.aten.mm.default
        return func(*args, **(kwargs or {}))


# Forward projections the backward recomputes per layer: "full" 6 of the 7
# (the recompute stops once the last saved input is back, before the
# chunk's last w_down), "mlp" those but up and gate, "dots" and "save_all"
# none.
RECOMPUTED = {"full": 6, "mlp": 4, "dots": 0, "save_all": 0}


@pytest.mark.parametrize("scan_chunk", [0, 1, 2])
@pytest.mark.parametrize("policy", sorted(RECOMPUTED))
def test_remat_policies_and_chunks_keep_loss_and_grads(tiny, policy,
                                                       scan_chunk):
    """Every remat policy and layer chunk gives JAX's loss and gradients;
    what differs is what the backward recomputes, counted as matmuls
    dispatched in the backward."""
    want_loss, want_grads = _jax_value_and_grad(0)
    cfg = dataclasses.replace(LlamaConfig.tiny(), remat_policy=policy,
                              scan_chunk=scan_chunk, loss_chunk=0)
    params = params_from_numpy(tiny[1], cfg, "cpu")
    grads = zeros_like_tree(params)
    top, layers = trainable_leaves(params, grads)
    loss = causal_lm_loss(top, torch.from_numpy(TOKENS), cfg, layers=layers)
    with _CountMatmuls() as count:
        loss.backward()
    np.testing.assert_allclose(loss.item(), want_loss, **TOL)
    _assert_trees_close(grads, want_grads, **TOL)
    # 2 gradient products per forward projection (7 per layer, and the
    # lm_head), plus the recomputed projections; inside a chunk of K
    # layers every layer but the last also recomputes its w_down.
    L, K = cfg.num_layers, max(1, scan_chunk)
    per_layer = RECOMPUTED[policy]
    extra = L - L // K if per_layer else 0
    assert count.n == 2 * (7 * L + 1) + L * per_layer + extra, count.n


def test_grads_land_in_the_stacked_buffers(tiny):
    """Per-layer leaves share the stacked weights' storage, and their
    gradients accumulate in place into one stacked buffer per leaf."""
    _, tree = tiny
    cfg = LlamaConfig.tiny()
    params = params_from_numpy(tree, cfg, "cpu")
    grads = zeros_like_tree(params)
    top, layers = trainable_leaves(params, grads)
    wq = params["layers"]["wq"]
    assert layers[1]["wq"].data_ptr() == wq[1].data_ptr()
    causal_lm_loss(top, torch.from_numpy(TOKENS), cfg,
                   layers=layers).backward()
    assert layers[1]["wq"].grad.data_ptr() == grads["layers"]["wq"][1].data_ptr()
    assert top["embed"].grad.data_ptr() == grads["embed"].data_ptr()
    assert all(g.abs().sum() > 0 for g in grads["layers"]["wq"])


def test_three_steps_match_jax_compiled_step(tiny, jax_step):
    """Three steps of the port's step (AdamW) against JAX's
    (optax.adamw(1e-3), donate=False) from the same weights: losses at
    1e-4; every weight after step 3 within 2e-5 (three AdamW steps move a
    weight by up to 3e-3, so this is ~1% of the largest move)."""
    cfg = LlamaConfig.tiny()
    jstep = jax_step
    jp = tiny[0]
    jo = jstep.tx.init(jp)
    step = CompiledTrainStep(cfg, device="cpu")
    params = params_from_numpy(tiny[1], cfg, "cpu")
    state = AdamW().init(params)
    toks = jnp.asarray(TOKENS)
    for i in range(3):
        jp, jo, jl = jstep(jp, jo, toks)
        out = step(params, state, torch.from_numpy(TOKENS))
        assert out[0] is params and out[1] is state  # updated in place
        np.testing.assert_allclose(float(out[2]), float(jl), **TOL)
    assert state.count == 3 == int(jo[0].count)
    _assert_trees_close(params, _tree_np(jp), atol=2e-5, rtol=0)
    _assert_trees_close(state.mu, _tree_np(jo[0].mu), atol=1e-6, rtol=1e-4)


def test_jax_step_carries_on_in_torch(tiny, jax_step):
    """One JAX step, then its params and optax state carried over
    (adam_state_from_numpy): the port's second step gives JAX's."""
    jparams, _ = tiny
    cfg = LlamaConfig.tiny()
    jstep = jax_step
    jo = jstep.tx.init(jparams)
    toks = jnp.asarray(TOKENS)
    jp, jo, _ = jstep(jparams, jo, toks)
    params = params_from_numpy(_tree_np(jp), cfg, "cpu")
    adam = jo[0]
    state = adam_state_from_numpy(np.asarray(adam.count), _tree_np(adam.mu),
                                  _tree_np(adam.nu), cfg, "cpu")
    assert state.count == 1
    jp, jo, jl = jstep(jp, jo, toks)
    _, _, loss = CompiledTrainStep(cfg, device="cpu")(
        params, state, torch.from_numpy(TOKENS))
    np.testing.assert_allclose(float(loss), float(jl), **TOL)
    _assert_trees_close(params, _tree_np(jp), atol=2e-5, rtol=0)
    assert state.count == 2


def test_adamw_defaults_are_optax():
    opt = AdamW()
    assert (opt.learning_rate, opt.b1, opt.b2, opt.eps, opt.weight_decay) \
        == (1e-3, 0.9, 0.999, 1e-8, 1e-4)
    p = {"w": torch.ones(3), "layers": {"a": torch.ones(2, 2)}}
    state = opt.init(p)
    assert state.count == 0 and len(leaves(state.mu)) == 2


def test_scan_chunk_must_divide_depth(monkeypatch):
    cfg = dataclasses.replace(LlamaConfig.tiny(), scan_chunk=3)
    with pytest.raises(ValueError, match="must divide"):
        CompiledTrainStep(cfg, device="cpu")
    params = params_from_numpy(_tree_np(_jax_params()), LlamaConfig.tiny(),
                               "cpu")
    with pytest.raises(ValueError, match="must divide"):
        causal_lm_loss(params, torch.from_numpy(TOKENS), cfg)
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        CompiledTrainStep(LlamaConfig.tiny())
