"""The port's expert and pipeline parallelism against the JAX package's, in
one gloo world of 4 processes (``test_torch_parallel.run_world``), float32.

- ``moe_ffn`` under ``dp=2, ep=2`` (k = 1 and 2) and ``sp=2, ep=2``
  against JAX's ``moe_ffn`` sharded the same way on the virtual mesh
  (GSPMD routes over the global token axis): each rank's output rows at
  2e-5, the global dispatch equal to JAX's with assignments dropped, and
  routing each rank's tokens alone (capacity from its own count) shown to
  give another dispatch.
- Two ``CompiledTrainStep`` steps of ``LlamaConfig.tiny(moe=True)`` under
  ``dp=2, ep=2`` and ``fsdp=2, ep=2`` from JAX's weights: losses within
  1e-4 of JAX's single-device step, step-1 gradients within 2e-5 of each
  leaf's largest against the port's single-device step, and the local
  shapes JAX's specs give (experts [L, E/ep, M/fsdp, F]).
- ``pipeline_apply`` with ``pp=4`` and 4 microbatches, remat on and off:
  outputs and each stage's gradients against JAX's at 2e-5.
- The dense tiny model under ``pp=2, dp=2``: each rank's forward logits
  and two step losses against JAX's under the same mesh at 1e-4, and its
  step-1 gradients against the port's single-device step at 2e-5.
- ``dryrun.dryrun_rank`` at n = 4 on the CPU: finite losses, the moe-ep
  and pipeline losses equal to the port's single-device losses on the
  same weights; without ``device="cpu"`` the dry run wants the cards.

The ranks import no JAX: this module imports it only inside fixtures and
tests. The expected slices are cut here with numpy from JAX's specs.
"""

import functools

import numpy as np
import pytest
import torch

from test_torch_parallel import cpu_mesh, ranks, run_world
from test_torch_sharded_llama import _flat, _local, _np_tree, _spec

from ray_tpu_torch.models import LlamaConfig, forward, params_from_numpy
from ray_tpu_torch.models.llama import param_logical_axes
from ray_tpu_torch.parallel import dryrun
from ray_tpu_torch.parallel import moe as tmoe
from ray_tpu_torch.parallel.pipeline import pipeline_apply
from ray_tpu_torch.parallel.sharding import named_sharding, shard_pytree
from ray_tpu_torch.train import CompiledTrainStep

TOL = dict(atol=1e-4, rtol=1e-4)
KERNEL_TOL = dict(atol=2e-5, rtol=2e-5)

# ------------------------------------------------------------- moe_ffn

MOE_B, MOE_S, MOE_M, MOE_E, MOE_F = 4, 8, 16, 4, 32
# name: (mesh sizes, k, with a token mask, the split that holds the tilt,
# the inputs' seed: one whose routing drops assignments)
MOE_CASES = {
    "dp2_ep2_k1": (dict(dp=2, ep=2), 1, False, "batch", 0),
    "dp2_ep2_k2_mask": (dict(dp=2, ep=2), 2, True, "batch", 6),
    "sp2_ep2_k2": (dict(dp=1, ep=2, sp=2), 2, False, "seq", 2),
}


def moe_inputs(name):
    """x [B, S, M], router, w_in, w_gate, w_out, mask [B, S]. The first
    half of the batch (or of the sequence) leans on expert 0, so that
    expert overflows, and a rank routing its own tokens alone would drop
    other assignments than the global routing does."""
    rng = np.random.RandomState(MOE_CASES[name][4])
    B, S, M, E, Fd = MOE_B, MOE_S, MOE_M, MOE_E, MOE_F
    x = rng.randn(B, S, M).astype(np.float32)
    u = rng.randn(M).astype(np.float32)
    if MOE_CASES[name][3] == "batch":
        x[:B // 2] += u
    else:
        x[:, :S // 2] += u
    router = (rng.randn(M, E) * 0.3).astype(np.float32)
    router[:, 0] += 3 * u / (u @ u)
    w_in, w_gate = (rng.randn(2, E, M, Fd) * M ** -0.5).astype(np.float32)
    w_out = (rng.randn(E, Fd, M) * Fd ** -0.5).astype(np.float32)
    mask = rng.rand(B, S) > 0.2
    return x, router, w_in, w_gate, w_out, mask


def task_moe(rank):
    from ray_tpu_torch.parallel.moe import EXPERT_WEIGHT_AXES

    out = {}
    inner = tmoe.top_k_routing
    for name, (sizes, k, masked, *_) in MOE_CASES.items():
        mesh = cpu_mesh(**sizes)
        x, router, w_in, w_gate, w_out, mask = map(torch.from_numpy,
                                                   moe_inputs(name))
        tokens = named_sharding(mesh, ("batch", "seq"))
        xl = named_sharding(mesh, ("batch", "seq", None)).local(x)
        ml = tokens.local(mask) if masked else None
        w = named_sharding(mesh, EXPERT_WEIGHT_AXES)
        w_o = named_sharding(mesh, ("expert", "mlp", "embed"))
        calls = []

        def record(logits, k, capacity, token_mask=None):
            got = inner(logits, k, capacity, token_mask)
            calls.append(got[0])
            return got

        tmoe.top_k_routing = record
        try:
            y, aux = tmoe.moe_ffn(xl, router, w.local(w_in), w_o.local(w_out),
                                  w_gate=w.local(w_gate), k=k, token_mask=ml,
                                  mesh=mesh)
        finally:
            tmoe.top_k_routing = inner
        # The same rank routing its tokens alone, capacity from its count.
        T_loc = xl.shape[0] * xl.shape[1]
        alone = inner(xl.reshape(T_loc, -1) @ router, k,
                      max(1, int(1.25 * k * T_loc / MOE_E)),
                      None if ml is None else ml.reshape(-1).float())[0]
        Bl, Sl = xl.shape[:2]
        (bi, _), (si, _) = tokens.coords(0), tokens.coords(1)
        mine = calls[0].reshape(MOE_B, MOE_S, MOE_E, -1)[
            bi * Bl:(bi + 1) * Bl, si * Sl:(si + 1) * Sl].reshape(T_loc,
                                                                  MOE_E, -1)
        kept = (alone.sum(-1) > 0, mine.sum(-1) > 0)  # [T_loc, E] each
        out[name] = dict(y=y.numpy(), aux=aux.item(),
                         dispatch=calls[0].numpy(),
                         alone_differs=not torch.equal(*kept))
    return out


@functools.lru_cache(maxsize=None)
def _jax_moe(name):
    """JAX's moe_ffn with x and the experts sharded on the case's mesh:
    (output, aux, the global dispatch)."""
    import jax
    import jax.numpy as jnp
    from jax.sharding import NamedSharding, PartitionSpec as P
    from ray_tpu.parallel import moe as jmoe

    from test_torch_parallel import _jax_mesh

    sizes, k, masked, *_ = MOE_CASES[name]
    mesh = _jax_mesh(tuple(sorted(sizes.items())))
    x, router, w_in, w_gate, w_out, mask = map(jnp.asarray, moe_inputs(name))
    jmask = mask.astype(jnp.float32) if masked else None
    xspec = P("dp", "sp") if "sp" in sizes else P("dp")
    with jax.set_mesh(mesh) if hasattr(jax, "set_mesh") else mesh:
        xs = jax.device_put(x, NamedSharding(mesh, xspec))
        ws = [jax.device_put(a, NamedSharding(mesh, P("ep")))
              for a in (w_in, w_gate, w_out)]

        @jax.jit
        def f(x, rw, wi, wg, wo):
            return jmoe.moe_ffn(x, rw, wi, wo, w_gate=wg, k=k,
                                token_mask=jmask)

        y, aux = f(xs, router, *ws)
    T = MOE_B * MOE_S
    dispatch = jmoe.top_k_routing(
        x.reshape(T, MOE_M) @ router, k, int(1.25 * k * T / MOE_E),
        None if jmask is None else jmask.reshape(T))[0]
    return np.asarray(y), float(aux), np.asarray(dispatch)


@pytest.mark.parametrize("name", sorted(MOE_CASES))
def test_moe_ffn_under_ep_matches_jax(world, name):
    sizes, k, masked, *_ = MOE_CASES[name]
    y, aux, dispatch = _jax_moe(name)
    spec = _spec(sizes, ("batch", "seq", None))
    dropped = k * (int(moe_inputs(name)[5].sum()) if masked
                   else MOE_B * MOE_S) - int(dispatch.sum())
    assert dropped > 0
    for r, got in enumerate(ranks(world, "moe")):
        rec = got[name]
        np.testing.assert_array_equal(rec["dispatch"], dispatch)
        np.testing.assert_allclose(rec["y"], _local(y, spec, sizes, r),
                                   **KERNEL_TOL)
        np.testing.assert_allclose(rec["aux"], aux, **KERNEL_TOL)
    assert any(got[name]["alone_differs"] for got in ranks(world, "moe"))


# ------------------------------------------------------ MoE train step

MOE_TOKENS = np.random.RandomState(0).randint(0, 256, (4, 17)).astype(
    np.int32)
MOE_TOKENS[:2, 5:] = 7   # runs of one token id: an expert overflows
TRAIN_MESHES = {"dp2_ep2": dict(dp=2, ep=2), "fsdp2_ep2": dict(dp=1, fsdp=2,
                                                              ep=2)}


def task_moe_train(rank, tree):
    cfg = LlamaConfig.tiny(moe=True)
    out = {}
    for key, sizes in TRAIN_MESHES.items():
        step = CompiledTrainStep(cfg, mesh=cpu_mesh(**sizes))
        params = shard_pytree(params_from_numpy(tree, cfg, "cpu"), step.mesh,
                              param_logical_axes(cfg))
        state = step.optimizer.init(params)
        toks = step.token_sharding().cut(torch.from_numpy(MOE_TOKENS))
        losses, grads = [], None
        for i in range(2):
            losses.append(step(params, state, toks)[2].item())
            if i == 0:
                grads = _np_tree(step.grads)
        init = step.init(torch.Generator().manual_seed(0))
        out[key] = dict(losses=losses, grads=grads, shapes=[
            {k: tuple(v.shape) for k, v in _flat(tree).items()}
            for tree in (params, state.mu, state.nu, init[0], init[1].mu)])
    return out


@pytest.fixture(scope="module")
def moe_tree():
    import jax

    from ray_tpu.models import LlamaConfig as JaxConfig
    from ray_tpu.models import init_params as jax_init

    return jax.tree.map(np.asarray, jax.jit(jax_init, static_argnums=0)(
        JaxConfig.tiny(moe=True), jax.random.PRNGKey(0)))


@pytest.fixture(scope="module")
def moe_jax_losses(moe_tree):
    import jax
    import jax.numpy as jnp

    from ray_tpu.models import LlamaConfig as JaxConfig
    from ray_tpu.train.compiled_step import CompiledTrainStep as JaxStep

    step = JaxStep(JaxConfig.tiny(moe=True), donate=False)
    params = jax.tree.map(jnp.asarray, moe_tree)
    opt = step.tx.init(params)
    losses = []
    for _ in range(2):
        params, opt, loss = step(params, opt, jnp.asarray(MOE_TOKENS))
        losses.append(float(loss))
    return losses


@pytest.fixture(scope="module")
def moe_single_grads(moe_tree):
    cfg = LlamaConfig.tiny(moe=True)
    step = CompiledTrainStep(cfg, device="cpu")
    params = params_from_numpy(moe_tree, cfg, "cpu")
    step(params, step.optimizer.init(params), torch.from_numpy(MOE_TOKENS))
    return _flat(_np_tree(step.grads))


def _moe_specs(sizes):
    axes = _flat(param_logical_axes(LlamaConfig.tiny(moe=True)))
    return {k: _spec(sizes, v) for k, v in axes.items()}


@pytest.mark.parametrize("mesh", sorted(TRAIN_MESHES))
def test_moe_train_losses_match_jax_single_device(world, moe_jax_losses,
                                                  mesh):
    for got in ranks(world, "moe_train"):
        np.testing.assert_allclose(got[mesh]["losses"], moe_jax_losses,
                                   **TOL)


@pytest.mark.parametrize("mesh", sorted(TRAIN_MESHES))
def test_moe_step1_gradients_match_single_device(world, moe_single_grads,
                                                 mesh):
    """Each rank's slice of every gradient, the router's (through the
    gathered logits and the aux loss every rank computes) included."""
    sizes = TRAIN_MESHES[mesh]
    specs = _moe_specs(sizes)
    for r, got in enumerate(ranks(world, "moe_train")):
        grads = _flat(got[mesh]["grads"])
        for k, g in moe_single_grads.items():
            want = _local(g, specs[k], sizes, r)
            err = np.abs(grads[k] - want).max()
            assert err <= 2e-5 * np.abs(g).max(), (r, k, err)


@pytest.mark.parametrize("mesh", sorted(TRAIN_MESHES))
def test_moe_local_expert_shapes(world, moe_single_grads, mesh):
    """shard_pytree's shards, the AdamW moments and the step's own init
    all take the local shapes of JAX's specs."""
    sizes = TRAIN_MESHES[mesh]
    specs = _moe_specs(sizes)
    cfg = LlamaConfig.tiny(moe=True)
    L, E, M, Fd = (cfg.num_layers, cfg.n_experts, cfg.hidden_size,
                   cfg.intermediate_size)
    want_up = (L, E // 2, M // sizes.get("fsdp", 1), Fd)
    for r, got in enumerate(ranks(world, "moe_train")):
        shapes = got[mesh]["shapes"][0]
        assert got[mesh]["shapes"] == [shapes] * 5
        assert shapes["layers.w_up"] == shapes["layers.w_gate"] == want_up
        for k, g in moe_single_grads.items():
            assert shapes[k] == _local(g, specs[k], sizes, r).shape, k


# ------------------------------------------------------------ pipeline

PIPE_STAGES, PIPE_B, PIPE_D = 4, 8, 16


def pipe_inputs():
    rng = np.random.RandomState(7)
    f = np.float32
    return ((rng.randn(PIPE_STAGES, PIPE_D, PIPE_D) * 0.3).astype(f),
            (rng.randn(PIPE_STAGES, PIPE_D) * 0.1).astype(f),
            rng.randn(PIPE_B, PIPE_D).astype(f))


def _stage(p, h):
    return torch.tanh(h @ p["W"] + p["b"])


def task_pipeline(rank):
    mesh = cpu_mesh(dp=1, pp=PIPE_STAGES)
    Ws, bs, x = map(torch.from_numpy, pipe_inputs())
    out = {}
    for remat in (True, False):
        p = {"W": Ws[rank:rank + 1].clone().requires_grad_(),
             "b": bs[rank:rank + 1].clone().requires_grad_()}
        y = pipeline_apply(_stage, p, x, mesh, n_microbatches=4, remat=remat)
        ((y ** 2).mean() / mesh.size()).backward()
        out[remat] = (y.detach().numpy(), p["W"].grad.numpy(),
                      p["b"].grad.numpy())
    return out


@functools.lru_cache(maxsize=None)
def _jax_pipeline(remat):
    import jax
    import jax.numpy as jnp
    from ray_tpu.parallel.pipeline import pipeline_apply as jax_pipeline

    from test_torch_parallel import _jax_mesh

    mesh = _jax_mesh((("dp", 1), ("pp", PIPE_STAGES)))
    Ws, bs, x = map(jnp.asarray, pipe_inputs())

    def run(params):
        return jax_pipeline(lambda p, h: jnp.tanh(h @ p[0] + p[1]), params, x,
                            mesh, n_microbatches=4, remat=remat)

    y = jax.jit(run)((Ws, bs))
    gW, gb = jax.jit(jax.grad(lambda p: (run(p) ** 2).mean()))((Ws, bs))
    return np.asarray(y), np.asarray(gW), np.asarray(gb)


@pytest.mark.parametrize("remat", [True, False], ids=["remat", "no_remat"])
def test_pipeline_apply_matches_jax(world, remat):
    y, gW, gb = _jax_pipeline(remat)
    # JAX's pipeline is the sequential stack's.
    Ws, bs, x = pipe_inputs()
    seq = x
    for i in range(PIPE_STAGES):
        seq = np.tanh(seq @ Ws[i] + bs[i])
    np.testing.assert_allclose(y, seq, **KERNEL_TOL)
    for r, got in enumerate(ranks(world, "pipeline")):
        out, grad_W, grad_b = got[remat]
        np.testing.assert_allclose(out, y, **KERNEL_TOL)
        np.testing.assert_allclose(grad_W, gW[r:r + 1], **KERNEL_TOL)
        np.testing.assert_allclose(grad_b, gb[r:r + 1], **KERNEL_TOL)


# ------------------------------------------------- dense model under pp

PP_SIZES = dict(dp=2, pp=2)
PP_TOKENS = np.random.RandomState(1).randint(0, 256, (4, 17)).astype(
    np.int32)


def task_dense_pp(rank, tree):
    cfg = LlamaConfig.tiny()
    step = CompiledTrainStep(cfg, mesh=cpu_mesh(**PP_SIZES))
    params = shard_pytree(params_from_numpy(tree, cfg, "cpu"), step.mesh,
                          param_logical_axes(cfg))
    toks = step.token_sharding().cut(torch.from_numpy(PP_TOKENS))
    with torch.no_grad():
        logits = forward(params, toks[:, :-1], cfg, mesh=step.mesh)[0]
    state = step.optimizer.init(params)
    losses, grads = [], None
    for i in range(2):
        losses.append(step(params, state, toks)[2].item())
        if i == 0:
            grads = _np_tree(step.grads)
    init = step.init(torch.Generator().manual_seed(0))[0]
    return dict(logits=logits.numpy(), losses=losses, grads=grads,
                wq=tuple(params["layers"]["wq"].shape),
                init_wq=init["layers"]["wq"].numpy().copy())


@pytest.fixture(scope="module")
def dense_tree():
    import jax

    from ray_tpu.models import LlamaConfig as JaxConfig
    from ray_tpu.models import init_params as jax_init

    return jax.tree.map(np.asarray, jax.jit(jax_init, static_argnums=0)(
        JaxConfig.tiny(), jax.random.PRNGKey(0)))


@pytest.fixture(scope="module")
def jax_pp(dense_tree):
    """JAX's forward logits and two step losses under the same pp mesh."""
    import jax
    import jax.numpy as jnp

    from ray_tpu.models import LlamaConfig as JaxConfig
    from ray_tpu.models import forward as jax_forward
    from ray_tpu.models.llama import param_logical_axes as jax_axes
    from ray_tpu.parallel.sharding import shard_pytree as jax_shard
    from ray_tpu.train.compiled_step import CompiledTrainStep as JaxStep

    from test_torch_parallel import _jax_mesh

    cfg = JaxConfig.tiny()
    mesh = _jax_mesh(tuple(sorted(PP_SIZES.items())))
    params = jax_shard(jax.tree.map(jnp.asarray, dense_tree), mesh,
                       jax_axes(cfg))
    logits = jax.jit(lambda p, t: jax_forward(p, t, cfg, mesh)[0])(
        params, jnp.asarray(PP_TOKENS[:, :-1]))
    step = JaxStep(cfg, mesh=mesh, donate=False)
    opt = step.tx.init(params)
    toks = jax.device_put(jnp.asarray(PP_TOKENS), step.token_sharding())
    losses = []
    for _ in range(2):
        params, opt, loss = step(params, opt, toks)
        losses.append(float(loss))
    return np.asarray(logits), losses


def test_dense_model_under_pp_matches_jax(world, jax_pp):
    """Each rank holds L/pp layers; its logits and the step losses are
    JAX's under the same mesh, and its init the slice of the
    single-device init's layers."""
    logits, losses = jax_pp
    spec = _spec(PP_SIZES, ("batch", "seq", "vocab"))
    cfg = LlamaConfig.tiny()
    full = CompiledTrainStep(cfg, device="cpu").init(
        torch.Generator().manual_seed(0))[0]["layers"]["wq"].numpy()
    for r, got in enumerate(ranks(world, "dense_pp")):
        np.testing.assert_allclose(got["logits"],
                                   _local(logits, spec, PP_SIZES, r), **TOL)
        np.testing.assert_allclose(got["losses"], losses, **TOL)
        assert got["wq"][0] == cfg.num_layers // 2
        np.testing.assert_array_equal(
            got["init_wq"], _local(full, _spec(PP_SIZES, ("layers",)),
                                   PP_SIZES, r))


def test_dense_pp_step1_gradients_match_single_device(world, dense_tree):
    """Each rank's step-1 gradients of its L/pp layers (summed onto it by
    the broadcast's backward) and of the replicated leaves, within 2e-5 of
    each leaf's largest, against the port's single-device step. (Step 2's
    loss alone would not show a gradient off by a factor: AdamW's first
    step is nearly lr * sign(g).)"""
    cfg = LlamaConfig.tiny()
    step = CompiledTrainStep(cfg, device="cpu")
    params = params_from_numpy(dense_tree, cfg, "cpu")
    step(params, step.optimizer.init(params), torch.from_numpy(PP_TOKENS))
    single = _flat(_np_tree(step.grads))
    axes = _flat(param_logical_axes(cfg))
    for r, got in enumerate(ranks(world, "dense_pp")):
        grads = _flat(got["grads"])
        for k, g in single.items():
            want = _local(g, _spec(PP_SIZES, axes[k]), PP_SIZES, r)
            err = np.abs(grads[k] - want).max()
            assert err <= 2e-5 * np.abs(g).max(), (r, k, err)


# --------------------------------------------------------------- dryrun

def task_dryrun(rank):
    return dryrun.dryrun_rank(4, device="cpu")


def test_dryrun_bodies_give_the_single_device_losses(world):
    """The dry run's per-rank bodies at n = 4 (dense under sp=2, tp=2;
    moe under dp=2, ep=2; the pipeline under pp=2 on ranks 0 and 1):
    finite losses, and the moe and pipeline losses are the single-device
    port's on the same weights and data."""
    cfg = dryrun.moe_config()
    step = CompiledTrainStep(cfg, device="cpu")
    params = step.init(torch.Generator().manual_seed(2))[0]
    moe_loss = step.value_and_grad(
        params, dryrun.moe_tokens(2, cfg.vocab_size))[0].item()
    Ws, bs, x = dryrun.pipeline_inputs(2)
    h = x
    for i in range(2):
        h = dryrun.pipeline_stage((Ws[i], bs[i]), h)
    pipe_loss = (h ** 2).mean().item()
    for r, got in enumerate(ranks(world, "dryrun")):
        assert np.isfinite(got["dense"]) and got["dense"] > 0
        np.testing.assert_allclose(got["moe"], moe_loss, rtol=1e-5)
        if r < 2:
            np.testing.assert_allclose(got["pipeline"], pipe_loss, rtol=1e-5)
        else:
            assert got["pipeline"] is None


def test_dryrun_runs_on_the_cards_unless_asked_for_the_cpu(monkeypatch):
    """With no device given the dry run wants one card a rank: asked for
    more ranks than there are cards it raises instead of falling back to
    the CPU."""
    monkeypatch.setattr(torch.distributed, "is_initialized", lambda: False)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        dryrun.dryrun_multichip(torch.cuda.device_count() + 1)


# ------------------------------------------------------------ the world

RANK_TASKS = {"moe": task_moe, "moe_train": task_moe_train,
              "pipeline": task_pipeline, "dense_pp": task_dense_pp,
              "dryrun": task_dryrun}


@pytest.fixture(scope="module")
def world(tmp_path_factory, moe_tree, dense_tree):
    return run_world(tmp_path_factory.mktemp("world"), __name__,
                     [("moe", ()), ("moe_train", (moe_tree,)),
                      ("pipeline", ()), ("dense_pp", (dense_tree,)),
                      ("dryrun", ())])
