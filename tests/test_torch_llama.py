"""The port's Llama model against the JAX package's: the same weights (made
by JAX, carried over through numpy) give the same logits at the tolerance
of tests/test_generation.py."""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ray_tpu.models import LlamaConfig as JaxConfig
from ray_tpu.models import forward as jax_forward_eager
from ray_tpu.models import init_params as jax_init
from ray_tpu.models.llama import rms_norm as jax_rms_norm
from ray_tpu.models.llama import rope as jax_rope
from ray_tpu_torch.models import LlamaConfig, forward, init_params
from ray_tpu_torch.models import params_from_numpy
from ray_tpu_torch.models.llama import param_shapes, rms_norm, rope

TOL = dict(atol=1e-4, rtol=1e-4)
jax_forward = jax.jit(jax_forward_eager, static_argnums=(2,))


@pytest.fixture(scope="module")
def tiny():
    jcfg = JaxConfig.tiny()
    jparams = jax_init(jcfg, jax.random.PRNGKey(0))
    params = params_from_numpy(jax.tree.map(np.asarray, jparams),
                               LlamaConfig.tiny(), "cpu")
    return jcfg, jparams, LlamaConfig.tiny(), params


def test_config_presets_match_jax():
    for name in ("llama3_8b", "llama3_70b", "mixtral_8x7b", "tiny"):
        j = dataclasses.asdict(getattr(JaxConfig, name)())
        t = dataclasses.asdict(getattr(LlamaConfig, name)())
        jdt, tdt = j.pop("dtype"), t.pop("dtype")
        assert j == t, name
        assert jnp.dtype(jdt).name == str(tdt).replace("torch.", ""), name


def test_params_carry_over_leaf_for_leaf(tiny):
    jcfg, jparams, cfg, params = tiny
    flat = jax.tree_util.tree_flatten_with_path(jparams)[0]
    assert len(flat) == 3 + len(params["layers"])
    for path, leaf in flat:
        keys = [p.key for p in path]
        got = params
        for k in keys:
            got = got[k]
        np.testing.assert_array_equal(got.numpy(), np.asarray(leaf))
    assert params["layers"]["wq"].shape == (2, 64, 4, 16)  # [L, M, H, Dh]


def test_bf16_tree_converts_bit_for_bit():
    jcfg = dataclasses.replace(JaxConfig.tiny(), dtype=jnp.bfloat16)
    cfg = dataclasses.replace(LlamaConfig.tiny(), dtype=torch.bfloat16)
    tree = jax.tree.map(np.asarray, jax_init(jcfg, jax.random.PRNGKey(3)))
    params = params_from_numpy(tree, cfg, "cpu")
    assert params["embed"].dtype == torch.bfloat16
    assert params["final_norm"].dtype == torch.float32
    np.testing.assert_array_equal(
        params["layers"]["w_up"].float().numpy(),
        tree["layers"]["w_up"].astype(np.float32))
    bad = dict(tree, embed=tree["embed"][:3])
    with pytest.raises(ValueError, match="embed"):
        params_from_numpy(bad, cfg, "cpu")


def test_init_params_layout_and_seed():
    cfg = LlamaConfig.tiny()
    a = init_params(cfg, torch.Generator().manual_seed(5), "cpu")
    b = init_params(cfg, torch.Generator().manual_seed(5), "cpu")
    shapes = jax.tree.map(lambda x: tuple(x.shape),
                          jax_init(JaxConfig.tiny(), jax.random.PRNGKey(0)))
    assert jax.tree.map(lambda x: tuple(x.shape), a,
                        is_leaf=lambda x: isinstance(x, torch.Tensor)) == \
        shapes == param_shapes(cfg)
    assert torch.equal(a["lm_head"], b["lm_head"])
    assert (a["layers"]["attn_norm"] == 1).all()
    std = a["layers"]["w_down"].std().item()
    assert abs(std - cfg.intermediate_size ** -0.5) < 0.1 * std


def test_rms_norm_and_rope_match_jax():
    rng = np.random.RandomState(0)
    x = rng.randn(2, 5, 3, 8).astype(np.float32)
    w = rng.rand(8).astype(np.float32)
    np.testing.assert_allclose(
        rms_norm(torch.from_numpy(x), torch.from_numpy(w), 1e-5).numpy(),
        np.asarray(jax_rms_norm(jnp.asarray(x), jnp.asarray(w), 1e-5)),
        **TOL)
    pos = np.arange(3, 8)
    want = np.asarray(jax_rope(jnp.asarray(x), jnp.asarray(pos), 1e4))
    np.testing.assert_allclose(
        rope(torch.from_numpy(x), torch.from_numpy(pos), 1e4).numpy(), want,
        **TOL)
    # Per-row positions [B, S] (the JAX decode path's vmap over rows).
    rows = np.stack([pos, pos + 7])
    got = rope(torch.from_numpy(x), torch.from_numpy(rows), 1e4).numpy()
    for b in range(2):
        np.testing.assert_allclose(
            got[b], np.asarray(jax_rope(jnp.asarray(x[b:b + 1]),
                                        jnp.asarray(rows[b]), 1e4))[0],
            **TOL)


@pytest.mark.parametrize("use_flash", [True, False])
def test_forward_logits_match_jax(tiny, use_flash):
    jcfg, jparams, cfg, params = tiny
    cfg = dataclasses.replace(cfg, use_flash=use_flash)
    # Out-of-range ids index as a JAX gather does (wrap, then clamp).
    tokens = np.random.RandomState(0).randint(0, 256, (2, 8)).astype(np.int32)
    tokens[0, :3] = [-1, 256, 300]
    want, _ = jax_forward(jparams, jnp.asarray(tokens), jcfg)
    got, aux = forward(params, torch.from_numpy(tokens), cfg)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)
    assert float(aux) == 0.0


def test_moe_params_carry_over_leaf_for_leaf():
    """The MoE tree (router [L, M, E], experts [L, E, ...]) loads 1:1 from
    JAX's; the router stays float32 in a bf16 model, as JAX keeps it, and
    the port's own init gives the same layout and dtypes."""
    jcfg = dataclasses.replace(JaxConfig.tiny(moe=True), dtype=jnp.bfloat16)
    cfg = dataclasses.replace(LlamaConfig.tiny(moe=True), dtype=torch.bfloat16)
    tree = jax.tree.map(np.asarray, jax_init(jcfg, jax.random.PRNGKey(1)))
    params = params_from_numpy(tree, cfg, "cpu")
    for name, leaf in tree["layers"].items():
        got = params["layers"][name]
        assert got.dtype == (torch.bfloat16 if leaf.dtype.name == "bfloat16"
                             else torch.float32), name
        np.testing.assert_array_equal(got.float().numpy(),
                                      leaf.astype(np.float32), err_msg=name)
    assert tree["layers"]["router"].dtype == np.float32
    assert params["layers"]["w_down"].shape == (2, 4, 128, 64)  # [L,E,F,M]
    own = init_params(cfg, torch.Generator().manual_seed(0), "cpu")
    assert {k: (tuple(v.shape), v.dtype) for k, v in own["layers"].items()} \
        == {k: (tuple(v.shape), v.dtype) for k, v in params["layers"].items()}
    # Drawn in bf16, then widened: every router entry is a bf16 value.
    router = own["layers"]["router"]
    assert torch.equal(router, router.to(torch.bfloat16).float())


def test_a_layer_stack_of_the_wrong_depth_raises():
    """A stack that holds fewer layers than the config names raises
    instead of running some layers twice."""
    from ray_tpu_torch.models.llama import hidden_forward

    cfg = LlamaConfig.tiny()
    params = init_params(cfg, device="cpu", layers=range(cfg.num_layers - 1))
    with pytest.raises(ValueError, match="layers given"):
        hidden_forward(params, torch.zeros(1, 4, dtype=torch.long), cfg)


def test_entry_points_raise_without_a_card(monkeypatch):
    from ray_tpu_torch.models.generation import generate
    from ray_tpu_torch.serve.llm import LLMDeployment, LLMEngine

    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    cfg = LlamaConfig.tiny()
    with pytest.raises(RuntimeError, match="device='cpu'"):
        init_params(cfg)
    params = init_params(cfg, device="cpu")
    with pytest.raises(RuntimeError, match="device='cpu'"):
        generate(params, [[1, 2]], cfg, max_new_tokens=1)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        LLMEngine(cfg, params)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        LLMDeployment(cfg)
