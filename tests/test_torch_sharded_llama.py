"""The port's Llama under a device mesh against the JAX package's, in one
gloo world of 4 processes (``test_torch_parallel.run_world``) on
``LlamaConfig.tiny()`` (float32, 2 layers, 4 heads, 2 KV heads).

- The forward under ``sp=2, tp=2`` (the ring over the sequence, heads, MLP
  and vocabulary over ``tp``) against JAX's forward on the same weights,
  sharded on ``MeshConfig(dp=1, sp=2, tp=2)`` and on one device: each
  rank's [B, S/2, V/2] logits, within 1e-4.
- Two ``CompiledTrainStep`` steps under ``dp=2, fsdp=2``, ``fsdp=2, tp=2``
  and ``sp=2, tp=2`` from JAX's weights: losses within 1e-4 of JAX's
  single-device step, step-1 gradients within 2e-5 of each leaf's largest
  against the port's single-device step, local shard and moment shapes,
  and the mesh init against the slice of the single-device init.

The expected slices are cut here with numpy from JAX's specs, not with the
port's sharding code.
"""

import dataclasses

import numpy as np
import pytest
import torch

from test_torch_parallel import cpu_mesh, ranks, run_world

from ray_tpu_torch.models import LlamaConfig, forward, params_from_numpy
from ray_tpu_torch.models.llama import param_logical_axes
from ray_tpu_torch.parallel.mesh import AXIS_ORDER
from ray_tpu_torch.parallel.sharding import shard_pytree
from ray_tpu_torch.train import CompiledTrainStep

TOL = dict(atol=1e-4, rtol=1e-4)
TOKENS = np.random.RandomState(0).randint(0, 256, (4, 17)).astype(np.int32)
FWD_SIZES = dict(dp=1, sp=2, tp=2)
TRAIN_MESHES = {"dp2_fsdp2": dict(dp=2, fsdp=2),
                "fsdp2_tp2": dict(dp=1, fsdp=2, tp=2),
                "sp2_tp2": dict(dp=1, sp=2, tp=2)}


def _np_tree(tree):
    return {k: (_np_tree(v) if isinstance(v, dict)
                else v.detach().numpy().copy()) for k, v in tree.items()}


def _flat(tree, prefix=""):
    out = {}
    for k, v in tree.items():
        if isinstance(v, dict):
            out.update(_flat(v, f"{prefix}{k}."))
        else:
            out[prefix + k] = v
    return out


# -------------------------------------------------------- rank tasks

def task_forward(rank, tree):
    cfg = LlamaConfig.tiny()
    mesh = cpu_mesh(**FWD_SIZES)
    params = shard_pytree(params_from_numpy(tree, cfg, "cpu"), mesh,
                          param_logical_axes(cfg))
    step = CompiledTrainStep(cfg, mesh=mesh)
    toks = step.token_sharding().cut(torch.from_numpy(TOKENS))[:, :-1]
    with torch.no_grad():
        return forward(params, toks, cfg, mesh=mesh)[0].numpy()


def task_train(rank, tree):
    cfg = LlamaConfig.tiny()
    out = {}
    for key, sizes in TRAIN_MESHES.items():
        step = CompiledTrainStep(cfg, mesh=cpu_mesh(**sizes))
        params = shard_pytree(params_from_numpy(tree, cfg, "cpu"), step.mesh,
                              param_logical_axes(cfg))
        state = step.optimizer.init(params)
        toks = step.token_sharding().cut(torch.from_numpy(TOKENS))
        losses, grads = [], None
        for i in range(2):
            losses.append(step(params, state, toks)[2].item())
            if i == 0:
                grads = _np_tree(step.grads)
        init = step.init(torch.Generator().manual_seed(0))
        out[key] = dict(
            losses=losses, grads=grads, tokens=toks.numpy(),
            shapes={k: tuple(v.shape) for k, v in _flat(params).items()},
            moment_shapes=[{k: tuple(v.shape) for k, v in _flat(m).items()}
                           for m in (state.mu, state.nu)],
            init=_np_tree(init[0]))
    return out


RANK_TASKS = {"forward": task_forward, "train": task_train}


@pytest.fixture(scope="module")
def jax_tree():
    import jax

    from ray_tpu.models import LlamaConfig as JaxConfig
    from ray_tpu.models import init_params as jax_init

    return jax.tree.map(np.asarray, jax_init(JaxConfig.tiny(),
                                             jax.random.PRNGKey(0)))


@pytest.fixture(scope="module")
def world(tmp_path_factory, jax_tree):
    return run_world(tmp_path_factory.mktemp("world"), __name__,
                     [("forward", (jax_tree,)), ("train", (jax_tree,))])


# ---------------------------------------------------- expected slices

def _coords(sizes, rank):
    shape = [sizes.get(a, 1) for a in AXIS_ORDER]
    idx = np.unravel_index(rank, shape)
    return dict(zip(AXIS_ORDER, (int(i) for i in idx))), dict(zip(AXIS_ORDER,
                                                                  shape))


def _spec(sizes, logical):
    """JAX's pruned spec of ``logical`` on a mesh of ``sizes``."""
    from ray_tpu.parallel.sharding import logical_to_spec, prune_spec

    from test_torch_parallel import _jax_mesh

    mesh = _jax_mesh(tuple(sorted(sizes.items())))
    return tuple(prune_spec(mesh, logical_to_spec(logical)))


def _local(a, spec, sizes, rank):
    """Rank ``rank``'s block of the global array ``a`` under ``spec``."""
    coord, size = _coords(sizes, rank)
    for dim, entry in enumerate(spec):
        axes = () if entry is None else (
            (entry,) if isinstance(entry, str) else entry)
        index, count = 0, 1
        for ax in axes:
            index, count = index * size[ax] + coord[ax], count * size[ax]
        n = a.shape[dim] // count
        a = np.take(a, range(index * n, (index + 1) * n), axis=dim)
    return a


def _leaf_specs(sizes):
    axes = _flat(param_logical_axes(LlamaConfig.tiny()))
    return {k: _spec(sizes, v) for k, v in axes.items()}


# ------------------------------------------------------------- forward

@pytest.fixture(scope="module")
def jax_logits(jax_tree):
    import jax
    import jax.numpy as jnp

    from ray_tpu.models import LlamaConfig as JaxConfig
    from ray_tpu.models import forward as jax_forward
    from ray_tpu.models.llama import param_logical_axes as jax_axes
    from ray_tpu.parallel.sharding import shard_pytree as jax_shard

    from test_torch_parallel import _jax_mesh

    cfg = JaxConfig.tiny()
    toks = jnp.asarray(TOKENS[:, :-1])
    mesh = _jax_mesh(tuple(sorted(FWD_SIZES.items())))
    params = jax.tree.map(jnp.asarray, jax_tree)
    sharded = jax.jit(lambda p, t: jax_forward(p, t, cfg, mesh)[0])(
        jax_shard(params, mesh, jax_axes(cfg)), toks)
    single = jax.jit(lambda p, t: jax_forward(p, t, cfg)[0])(params, toks)
    return {"sharded": np.asarray(sharded), "single": np.asarray(single)}


@pytest.mark.parametrize("against", ["sharded", "single"])
def test_forward_under_sp_and_tp_matches_jax(world, jax_logits, against):
    spec = _spec(FWD_SIZES, ("batch", "seq", "vocab"))
    for r, got in enumerate(ranks(world, "forward")):
        want = _local(jax_logits[against], spec, FWD_SIZES, r)
        assert got.shape == (4, 8, 128)
        np.testing.assert_allclose(got, want, **TOL)


# --------------------------------------------------------------- train

@pytest.fixture(scope="module")
def jax_losses(jax_tree):
    import jax
    import jax.numpy as jnp

    from ray_tpu.models import LlamaConfig as JaxConfig
    from ray_tpu.train.compiled_step import CompiledTrainStep as JaxStep

    step = JaxStep(JaxConfig.tiny(), donate=False)
    params = jax.tree.map(jnp.asarray, jax_tree)
    opt = step.tx.init(params)
    losses = []
    for _ in range(2):
        params, opt, loss = step(params, opt, jnp.asarray(TOKENS))
        losses.append(float(loss))
    return losses


@pytest.fixture(scope="module")
def single_device(jax_tree):
    """The port's single-device step from the same weights: step-1
    gradients; and its own init from seed 0."""
    cfg = LlamaConfig.tiny()
    step = CompiledTrainStep(cfg, device="cpu")
    params = params_from_numpy(jax_tree, cfg, "cpu")
    state = step.optimizer.init(params)
    step(params, state, torch.from_numpy(TOKENS))
    grads = _flat(_np_tree(step.grads))
    init = _flat(_np_tree(step.init(torch.Generator().manual_seed(0))[0]))
    return grads, init


@pytest.mark.parametrize("mesh", sorted(TRAIN_MESHES))
def test_train_losses_match_jax_single_device(world, jax_losses, mesh):
    for r, got in enumerate(ranks(world, "train")):
        np.testing.assert_allclose(got[mesh]["losses"], jax_losses, **TOL)


@pytest.mark.parametrize("mesh", sorted(TRAIN_MESHES))
def test_step1_gradients_match_single_device(world, single_device, mesh):
    sizes = TRAIN_MESHES[mesh]
    specs = _leaf_specs(sizes)
    for r, got in enumerate(ranks(world, "train")):
        grads = _flat(got[mesh]["grads"])
        for k, g in single_device[0].items():
            want = _local(g, specs[k], sizes, r)
            err = np.abs(grads[k] - want).max()
            assert err <= 2e-5 * np.abs(g).max(), (r, k, err)


@pytest.mark.parametrize("mesh", sorted(TRAIN_MESHES))
def test_local_shards_and_moments(world, mesh):
    """Each leaf's local shape is the global one over the pieces its spec
    cuts it into; the AdamW moments are sharded like the parameters; the
    token window is the rank's slice of the global shift."""
    sizes = TRAIN_MESHES[mesh]
    specs = _leaf_specs(sizes)
    shapes = _flat(param_logical_axes(LlamaConfig.tiny()))
    full = {k: v.shape for k, v in _flat(params_from_numpy(
        _zeros_tree(), LlamaConfig.tiny(), "cpu")).items()}
    tok_spec = _spec(sizes, ("batch", "seq"))
    for r, got in enumerate(ranks(world, "train")):
        rec = got[mesh]
        for k in shapes:
            want = _local(np.zeros(full[k]), specs[k], sizes, r).shape
            assert rec["shapes"][k] == want, (k, rec["shapes"][k], want)
        assert rec["moment_shapes"] == [rec["shapes"]] * 2
        inputs = _local(TOKENS[:, :-1], tok_spec, sizes, r)
        targets = _local(TOKENS[:, 1:], tok_spec, sizes, r)
        np.testing.assert_array_equal(rec["tokens"][:, :-1], inputs)
        np.testing.assert_array_equal(rec["tokens"][:, 1:], targets)


def _zeros_tree():
    from ray_tpu_torch.models.llama import param_shapes

    def zeros(t):
        return {k: zeros(v) if isinstance(v, dict) else np.zeros(
            v, np.float32) for k, v in t.items()}
    return zeros(param_shapes(LlamaConfig.tiny()))


@pytest.mark.parametrize("mesh", sorted(TRAIN_MESHES))
def test_mesh_init_is_the_slice_of_the_single_device_init(world,
                                                         single_device, mesh):
    sizes = TRAIN_MESHES[mesh]
    specs = _leaf_specs(sizes)
    for r, got in enumerate(ranks(world, "train")):
        init = _flat(got[mesh]["init"])
        for k, full in single_device[1].items():
            np.testing.assert_array_equal(init[k], _local(full, specs[k],
                                                          sizes, r))


def test_world_size_one_mesh_step_is_the_single_device_step():
    """The mesh path at world size 1 (collectives over groups of one) gives
    the mesh=None step's losses and gradients, bit for bit (float32)."""
    import torch.distributed as dist

    from ray_tpu_torch.train.optim import leaves

    cfg = dataclasses.replace(LlamaConfig.tiny(), loss_chunk=8)
    toks = torch.from_numpy(TOKENS)
    plain = CompiledTrainStep(cfg, device="cpu")
    p0, s0 = plain.init(torch.Generator().manual_seed(1))
    started = not dist.is_initialized()
    try:
        meshed = CompiledTrainStep(cfg, mesh=cpu_mesh(dp=1))
        p1, s1 = meshed.init(torch.Generator().manual_seed(1))
        for _ in range(2):
            a = plain(p0, s0, toks)[2].item()
            b = meshed(p1, s1, meshed.token_sharding().cut(toks))[2].item()
            assert a == b
            for x, y in zip(leaves(plain.grads), leaves(meshed.grads)):
                assert torch.equal(x, y)
    finally:
        if started and dist.is_initialized():
            dist.destroy_process_group()
