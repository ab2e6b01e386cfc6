"""The port's parallel layer against the JAX package's: mesh rules,
logical-axis specs, collectives, and ring and Ulysses attention.

The pure functions (``MeshConfig.resolve``, ``logical_to_spec``,
``prune_spec``, ``param_logical_axes``) run in this process against JAX's.
Everything that communicates runs in one gloo world of 4 processes, spawned
once for the file (:func:`run_world`): every rank runs the same list of
tasks and sends its results back, and the tests compare them, here, with
numpy and with the JAX functions on 4 devices of the virtual CPU mesh
(``shard_map`` with ``check_vma=False``, whose gradients are the
collectives' transposes, as the port's are). The ranks import no JAX: this
module imports it only inside the tests. The world fails its tests if it
does not finish within ``WORLD_TIMEOUT_S`` (gloo collectives time out after
``COLLECTIVE_TIMEOUT_S``). Tolerance: 2e-5 (float32).
"""

import datetime
import functools
import multiprocessing
import queue
import time
import traceback
import types

import numpy as np
import pytest
import torch
import torch.distributed as dist

from ray_tpu_torch.models.llama import LlamaConfig, param_logical_axes
from ray_tpu_torch.parallel import collectives as C
from ray_tpu_torch.parallel import ring_attention as R
from ray_tpu_torch.parallel.mesh import AXIS_ORDER, MeshConfig, make_mesh
from ray_tpu_torch.parallel.sharding import (
    DEFAULT_RULES,
    logical_to_spec,
    named_sharding,
    prune_spec,
    shard_pytree,
    with_logical_constraint,
)

WORLD = 4
WORLD_TIMEOUT_S = 150
COLLECTIVE_TIMEOUT_S = 60
TOL = dict(atol=2e-5, rtol=2e-5)


# ------------------------------------------------------------ the world

def _rank_main(rank, tasks_module, store, tasks, results):
    import importlib

    torch.set_num_threads(1)
    registry = importlib.import_module(tasks_module).RANK_TASKS
    dist.init_process_group(
        "gloo", init_method=f"file://{store}", rank=rank, world_size=WORLD,
        timeout=datetime.timedelta(seconds=COLLECTIVE_TIMEOUT_S))
    try:
        for name, args in tasks:
            try:
                results.put((rank, name, True, registry[name](rank, *args)))
            except Exception:  # reported to the parent, which fails the test
                results.put((rank, name, False, traceback.format_exc()))
    finally:
        dist.destroy_process_group()
        results.put((rank, None, True, None))


def run_world(tmp_path, tasks_module, tasks):
    """Run ``tasks`` [(name, args)] on every rank of a gloo world of
    ``WORLD`` processes; ``tasks_module.RANK_TASKS[name](rank, *args)``
    computes a rank's result. Returns {name: [(ok, result) per rank]}.
    Raises if the world does not finish within ``WORLD_TIMEOUT_S``."""
    ctx = multiprocessing.get_context("spawn")
    results = ctx.Queue()
    store = str(tmp_path / "store")
    procs = [ctx.Process(target=_rank_main, daemon=True,
                         args=(r, tasks_module, store, tasks, results))
             for r in range(WORLD)]
    for p in procs:
        p.start()
    out, finished = {}, set()
    deadline = time.monotonic() + WORLD_TIMEOUT_S
    try:
        while len(finished) < WORLD:
            try:
                rank, name, ok, res = results.get(timeout=1)
            except queue.Empty:
                lost = [r for r, p in enumerate(procs)
                        if p.exitcode is not None and r not in finished]
                if lost or time.monotonic() > deadline:
                    raise TimeoutError(
                        f"the gloo world did not finish (ranks {lost} exited "
                        f"early; limit {WORLD_TIMEOUT_S} s); results so far: "
                        f"{sorted(out)}") from None
                continue
            if name is None:
                finished.add(rank)
            else:
                out.setdefault(name, [None] * WORLD)[rank] = (ok, res)
    finally:
        for p in procs:
            p.join(timeout=10)
            if p.is_alive():
                p.kill()
                p.join(timeout=10)
    return out


def ranks(world, name):
    """The task's result on each rank; a rank's exception fails the test."""
    got = world[name]
    for r, (ok, res) in enumerate(got):
        if not ok:
            pytest.fail(f"rank {r}, task {name}:\n{res}")
    return [res for _, res in got]


def cpu_mesh(**sizes):
    return make_mesh(MeshConfig(**sizes), device="cpu")


# ------------------------------------------------------- inputs (numpy)

X_SHAPE = (2, 8)  # each rank's block in the collective cases

# name -> (the collective's mesh axis or axes, differentiable)
COLL = {
    "allreduce_sum": ("sp", True),
    "allreduce_mean": ("sp", True),
    "allreduce_max": ("sp", False),
    "allreduce_min": ("sp", False),
    "allgather_dim1": ("sp", True),
    "allgather_stacked": ("sp", True),
    "reducescatter_dim1": ("sp", True),
    "broadcast_root2": ("sp", True),
    "ppermute_partial": ("sp", True),
    "shift_back": ("sp", True),
    "all_to_all": ("sp", True),
    "allreduce_dp_sp": (("dp", "sp"), True),
    "allgather_dp_sp": (("dp", "sp"), True),
    "reducescatter_dp_sp": (("dp", "sp"), True),
    "two_axis_broadcast": (("dp", "sp"), True),
}
PERM = ((0, 2), (2, 0), (1, 3))


def _port_coll(name, x, mesh):
    a = COLL[name][0]
    return {
        "allreduce_sum": lambda: C.allreduce(x, a, mesh=mesh),
        "allreduce_mean": lambda: C.allreduce(x, a, "mean", mesh=mesh),
        "allreduce_max": lambda: C.allreduce(x, a, "max", mesh=mesh),
        "allreduce_min": lambda: C.allreduce(x, a, "min", mesh=mesh),
        "allgather_dim1": lambda: C.allgather(x, a, gather_dim=1, mesh=mesh),
        "allgather_stacked": lambda: C.allgather(x, a, tiled=False,
                                                 mesh=mesh),
        "reducescatter_dim1": lambda: C.reducescatter(x, a, scatter_dim=1,
                                                      mesh=mesh),
        "broadcast_root2": lambda: C.broadcast(x, a, root=2, mesh=mesh),
        "ppermute_partial": lambda: C.ppermute(x, a, PERM, mesh=mesh),
        "shift_back": lambda: C.shift(x, a, -1, mesh=mesh),
        "all_to_all": lambda: C.all_to_all(x, a, split_axis=1, concat_axis=0,
                                           mesh=mesh),
        "allreduce_dp_sp": lambda: C.allreduce(x, a, mesh=mesh),
        "allgather_dp_sp": lambda: C.allgather(x, a, gather_dim=1,
                                               mesh=mesh),
        "reducescatter_dp_sp": lambda: C.reducescatter(x, a, scatter_dim=1,
                                                       mesh=mesh),
        "two_axis_broadcast": lambda: C.broadcast(x, a, root=2, mesh=mesh),
    }[name]()


def coll_inputs(name):
    """(X [WORLD * 2, 8]: rank r's block is rows 2r..2r+1, cotangent
    seed). The cotangent's shape is the output's, known after a forward."""
    rng = np.random.RandomState(sorted(COLL).index(name))
    return rng.randn(WORLD * X_SHAPE[0], X_SHAPE[1]).astype(np.float32)


def coll_cotangent(name, out_shape):
    rng = np.random.RandomState(100 + sorted(COLL).index(name))
    return rng.randn(*out_shape).astype(np.float32)


ATTN = {
    # name: (impl, causal, B, S, H, Hkv, D)
    "ring_causal_gqa": ("ring", True, 2, 32, 4, 2, 8),
    "ring_full_mha": ("ring", False, 1, 32, 2, 2, 8),
    "flash_ring_causal_gqa": ("flash_ring", True, 2, 32, 4, 2, 8),
    "flash_ring_full_gqa": ("flash_ring", False, 1, 24, 4, 1, 8),
    "ulysses_causal_gqa": ("ulysses", True, 2, 32, 8, 4, 8),
    "ulysses_full_mha": ("ulysses", False, 1, 32, 4, 4, 8),
}


def attn_inputs(name):
    """Global q, k, v and the output cotangent, [B, S, H(kv), D]."""
    _, _, B, S, H, Hkv, D = ATTN[name]
    rng = np.random.RandomState(200 + sorted(ATTN).index(name))
    f = np.float32
    return (rng.randn(B, S, H, D).astype(f), rng.randn(B, S, Hkv, D).astype(f),
            rng.randn(B, S, Hkv, D).astype(f), rng.randn(B, S, H, D).astype(f))


def seq_block(a, r, n=WORLD):
    s = a.shape[1] // n
    return a[:, r * s:(r + 1) * s]


# -------------------------------------------------------- rank tasks

def task_collectives(rank):
    meshes = {"sp": cpu_mesh(dp=1, sp=WORLD),
              ("dp", "sp"): cpu_mesh(dp=2, sp=2)}
    out = {}
    for name, (axis, differentiable) in COLL.items():
        mesh = meshes[axis]
        X = coll_inputs(name)
        x = torch.from_numpy(X[rank * 2:rank * 2 + 2]).requires_grad_()
        y = _port_coll(name, x, mesh)
        rec = {"y": y.detach().numpy()}
        if differentiable:
            rec["shape"] = tuple(y.shape)
            # The cotangent is the rank's rows of a global array whose
            # rows are the ranks' outputs in order.
            W = coll_cotangent(name, (WORLD * y.shape[0],)
                               + tuple(y.shape[1:]))
            w = torch.from_numpy(W[rank * y.shape[0]:(rank + 1) * y.shape[0]])
            (y * w).sum().backward()
            rec["grad"] = (np.zeros_like(X[:2]) if x.grad is None
                           else x.grad.numpy())
        else:
            try:
                y.sum().backward()
                rec["raised"] = None
            except NotImplementedError as e:
                rec["raised"] = str(e)
        out[name] = rec
    with C.use_mesh(meshes["sp"]):
        out["use_mesh"] = (C.axis_index("sp"), C.axis_size("sp"),
                           C.allreduce(torch.ones(1), "sp").item())
    m2 = meshes[("dp", "sp")]
    out["axis_index_dp_sp"] = (C.axis_index(("dp", "sp"), mesh=m2),
                               C.axis_size(("dp", "sp"), mesh=m2))
    return out


def task_attention(rank):
    mesh = cpu_mesh(dp=1, sp=WORLD)
    fns = {"ring": R.ring_attention_shard,
           "flash_ring": R.flash_ring_attention_shard,
           "ulysses": R.ulysses_attention_shard}
    out = {}
    for name, (impl, causal, *_) in ATTN.items():
        q, k, v, w = (torch.from_numpy(seq_block(a, rank)).requires_grad_()
                      for a in attn_inputs(name))
        y = fns[impl](q, k, v, causal=causal, mesh=mesh)
        (y * w).sum().backward()
        out[name] = [t.detach().numpy() for t in (y, q.grad, k.grad, v.grad)]
    # The model's entry takes the same path.
    q, k, v, _ = (torch.from_numpy(seq_block(a, rank))
                  for a in attn_inputs("ring_causal_gqa"))
    out["entry_ring"] = R.ring_attention(q, k, v, mesh, causal=True).numpy()
    return out


def task_sharding(rank):
    """Specs pruned on the world's meshes, and the local shapes of the
    tiny model's parameters under each."""
    cfg = LlamaConfig.tiny()
    axes = param_logical_axes(cfg)
    out = {}
    for key, sizes in MESHES.items():
        mesh = cpu_mesh(**sizes)
        out[key] = {
            "pruned": {str(a): prune_spec(mesh, logical_to_spec(a))
                       for a in SPEC_CASES},
            "embed_local": tuple(shard_pytree(
                {"e": torch.zeros(cfg.vocab_size, cfg.hidden_size)}, mesh,
                {"e": axes["embed"]})["e"].shape),
        }
        x = torch.zeros(named_sharding(mesh, ("batch", "seq")).shard_shape(
            (8, 16)))
        with_logical_constraint(x, ("batch", "seq"), mesh=mesh,
                                global_shape=(8, 16))
        try:
            with_logical_constraint(torch.zeros(8, 16), ("batch", "seq"),
                                    mesh=mesh, global_shape=(8, 16))
            out[key]["wrong_shape_raised"] = False
        except ValueError:
            out[key]["wrong_shape_raised"] = True
    return out


def task_data_axis_on_experts(rank):
    """A rule that splits the experts over an axis the tokens split over
    raises ValueError, in the model and in ``moe_ffn``; the meshes that
    the port once refused (MoE under an axis > 1, pp > 1) now build."""
    from ray_tpu_torch.parallel.moe import moe_ffn
    from ray_tpu_torch.train import CompiledTrainStep

    rules = tuple((a, "dp") if a == "expert" else (a, m)
                  for a, m in DEFAULT_RULES)
    mesh = cpu_mesh(dp=WORLD)
    x = torch.zeros(1, 2, 8)
    raised = []
    for build in (
            lambda: CompiledTrainStep(LlamaConfig.tiny(moe=True), mesh=mesh,
                                      rules=rules),
            lambda: moe_ffn(x, torch.zeros(8, 4), torch.zeros(1, 8, 4),
                            torch.zeros(1, 4, 8), mesh=mesh, rules=rules)):
        try:
            build()
            raised.append(None)
        except ValueError as e:
            raised.append(str(e))
    for moe, sizes in ((True, {"dp": WORLD}), (True, {"dp": 1, "fsdp": 2,
                                                       "tp": 2}),
                       (False, {"dp": 1, "pp": 2, "tp": 2})):
        CompiledTrainStep(LlamaConfig.tiny(moe=moe), mesh=cpu_mesh(**sizes))
    return raised


def task_flat_broadcast(rank):
    """``broadcast_flat`` of tensors of two dtypes and odd byte counts
    over (dp, sp) from root 2, all packed ("flat") and with the 40- and
    64-byte tensors over the packing limit ("split": one alone with
    padding, one alone uncopied), beside ``broadcast`` of each: outputs
    and gradients."""
    mesh = cpu_mesh(dp=2, sp=2)
    rng = np.random.RandomState(300 + rank)
    xs = [torch.from_numpy(rng.randn(*shape).astype(dtype))
          for shape, dtype in (((2, 3), np.float32), ((5,), np.float64),
                               ((3,), np.float32), ((8,), np.float64))]
    ws = [torch.from_numpy(np.random.RandomState(400 + rank).randn(
        *x.shape).astype(x.numpy().dtype)) for x in xs]

    def flat(v, limit):
        default, C.PACK_BYTES = C.PACK_BYTES, limit
        try:
            return C.broadcast_flat(v, ("dp", "sp"), root=2, mesh=mesh)
        finally:
            C.PACK_BYTES = default

    out = {}
    for name, fn in (
            ("flat", lambda v: flat(v, C.PACK_BYTES)),
            ("split", lambda v: flat(v, 32)),
            ("each", lambda v: [C.broadcast(t, ("dp", "sp"), root=2,
                                            mesh=mesh) for t in v])):
        v = [x.clone().requires_grad_() for x in xs]
        ys = fn(v)
        sum((y * w).sum() for y, w in zip(ys, ws)).backward()
        out[name] = ([y.detach().numpy() for y in ys],
                     [np.zeros_like(t.detach().numpy()) if t.grad is None
                      else t.grad.numpy() for t in v])
    return out


def task_collective_group(rank):
    g = C.init_collective_group(WORLD, rank, "test")
    g.barrier(timeout_s=30)
    got = g.broadcast_obj({"from": rank, "x": [1, 2]} if rank == 1 else None,
                          root=1, timeout_s=30)
    g.barrier(timeout_s=30)
    return got


RANK_TASKS = {
    "collectives": task_collectives,
    "attention": task_attention,
    "sharding": task_sharding,
    "expert_rules": task_data_axis_on_experts,
    "collective_group": task_collective_group,
    "flat_broadcast": task_flat_broadcast,
}

MESHES = {"dp2_fsdp2": dict(dp=2, fsdp=2), "sp2_tp2": dict(dp=1, sp=2, tp=2),
          "fsdp2_tp2": dict(dp=1, fsdp=2, tp=2)}
SPEC_CASES = (("batch", "seq", "embed"), ("layers", "embed", "heads",
              "head_dim"), ("vocab", "embed"), ("embed", "vocab"),
              ("batch", "seq", "mlp"), ("layers", "norm"), ("heads", "mlp"))


@pytest.fixture(scope="module")
def world(tmp_path_factory):
    return run_world(tmp_path_factory.mktemp("world"), __name__,
                     [(name, ()) for name in RANK_TASKS])


# ---------------------------------------------------------- JAX side

@functools.lru_cache(maxsize=None)
def _jax_mesh(sizes):
    from ray_tpu.parallel.mesh import MeshConfig as JaxMeshConfig
    from ray_tpu.parallel.mesh import make_mesh as jax_make_mesh

    return jax_make_mesh(JaxMeshConfig(**dict(sizes)))


def _jax_coll(name):
    """(JAX's output, its gradient of sum(output * cotangent) or None)."""
    import jax
    import jax.numpy as jnp
    from jax.sharding import PartitionSpec as P
    from ray_tpu.parallel import collectives as J

    axis, differentiable = COLL[name]
    sizes = (("dp", 2), ("sp", 2)) if isinstance(axis, tuple) else (
        ("dp", 1), ("sp", WORLD))
    mesh = _jax_mesh(sizes)
    fn = {
        "allreduce_sum": lambda x: J.allreduce(x, axis),
        "allreduce_mean": lambda x: J.allreduce(x, axis, "mean"),
        "allreduce_max": lambda x: J.allreduce(x, axis, "max"),
        "allreduce_min": lambda x: J.allreduce(x, axis, "min"),
        "allgather_dim1": lambda x: J.allgather(x, axis, gather_dim=1),
        "allgather_stacked": lambda x: J.allgather(x, axis, tiled=False),
        "reducescatter_dim1": lambda x: J.reducescatter(x, axis,
                                                        scatter_dim=1),
        "broadcast_root2": lambda x: J.broadcast(x, axis, root=2),
        "ppermute_partial": lambda x: J.ppermute(x, axis, PERM),
        "shift_back": lambda x: J.shift(x, axis, -1),
        "all_to_all": lambda x: J.all_to_all(x, axis, split_axis=1,
                                             concat_axis=0),
        "allreduce_dp_sp": lambda x: J.allreduce(x, axis),
        "allgather_dp_sp": lambda x: J.allgather(x, axis, gather_dim=1),
        "reducescatter_dp_sp": lambda x: J.reducescatter(x, axis,
                                                         scatter_dim=1),
        "two_axis_broadcast": lambda x: J.broadcast(x, axis, root=2),
    }[name]
    f = jax.shard_map(fn, mesh=mesh, in_specs=P(axis), out_specs=P(axis),
                      check_vma=False)
    X = jnp.asarray(coll_inputs(name))
    y = np.asarray(jax.jit(f)(X))
    if not differentiable:
        return y, None
    W = jnp.asarray(coll_cotangent(name, y.shape))
    g = jax.jit(jax.grad(lambda x: (f(x) * W).sum()))(X)
    return y, np.asarray(g)


@pytest.mark.parametrize("name", sorted(COLL))
def test_collective_matches_jax(world, name):
    """Each rank's output and gradient against JAX's block for that
    device; non-differentiable ops raise in the backward, as JAX's do."""
    got = [r[name] for r in ranks(world, "collectives")]
    y, g = _jax_coll(name)
    rows = y.shape[0] // WORLD
    for r, rec in enumerate(got):
        np.testing.assert_allclose(rec["y"], y[r * rows:(r + 1) * rows],
                                   **TOL)
        if g is None:
            assert rec["raised"] and "not differentiable" in rec["raised"]
        else:
            np.testing.assert_allclose(rec["grad"], g[r * 2:r * 2 + 2], **TOL)


def test_collectives_match_numpy(world):
    got = [r for r in ranks(world, "collectives")]
    blocks = {n: coll_inputs(n).reshape(WORLD, *X_SHAPE) for n in COLL}
    for r, rec in enumerate(got):
        np.testing.assert_allclose(rec["allreduce_sum"]["y"],
                                   blocks["allreduce_sum"].sum(0), **TOL)
        np.testing.assert_allclose(rec["allreduce_max"]["y"],
                                   blocks["allreduce_max"].max(0), **TOL)
        np.testing.assert_allclose(
            rec["allgather_dim1"]["y"],
            np.concatenate(list(blocks["allgather_dim1"]), axis=1), **TOL)
        np.testing.assert_allclose(rec["shift_back"]["y"],
                                   blocks["shift_back"][(r + 1) % WORLD])
        src = {d: s for s, d in PERM}
        want = (blocks["ppermute_partial"][src[r]] if r in src
                else np.zeros(X_SHAPE))
        np.testing.assert_allclose(rec["ppermute_partial"]["y"], want)
        assert rec["use_mesh"] == (r, WORLD, float(WORLD))
        # dp=2, sp=2: rank r = 2 * dp + sp, its combined index dp-major.
        assert rec["axis_index_dp_sp"] == (r, WORLD)


@functools.lru_cache(maxsize=None)
def _jax_attention(name):
    """JAX's sequence-parallel attention on 4 devices and one whole-sequence
    mha_attention: (output, dq, dk, dv) of each."""
    import jax
    import jax.numpy as jnp
    from jax.sharding import PartitionSpec as P
    from ray_tpu.ops.attention import mha_attention
    from ray_tpu.parallel.ring_attention import (
        ring_attention_shard, ulysses_attention_shard)

    impl, causal = ATTN[name][:2]
    q, k, v, w = (jnp.asarray(a) for a in attn_inputs(name))
    shard = ulysses_attention_shard if impl == "ulysses" else (
        ring_attention_shard)
    spec = P(None, "sp")
    f = jax.shard_map(functools.partial(shard, causal=causal, axis_name="sp"),
                      mesh=_jax_mesh((("dp", 1), ("sp", WORLD))),
                      in_specs=(spec,) * 3, out_specs=spec, check_vma=False)
    whole = functools.partial(mha_attention, causal=causal)
    out = {}
    for key, fn in (("sharded", f), ("whole", whole)):
        y, vjp = jax.vjp(jax.jit(fn), q, k, v)
        out[key] = [np.asarray(t) for t in (y,) + vjp(w)]
    return out


@pytest.mark.parametrize("name", sorted(ATTN))
@pytest.mark.parametrize("against", ["sharded", "whole"])
def test_sequence_parallel_attention_matches_jax(world, name, against):
    """Output and dq, dk, dv of each rank's sequence block against JAX's
    ring/Ulysses on a 4-device mesh and against one whole-sequence
    attention. The flash ring (the card's path) runs here through the
    kernels' plain versions."""
    want = _jax_attention(name)[against]
    for r, got in enumerate(ranks(world, "attention")):
        for g, w in zip(got[name], want):
            np.testing.assert_allclose(g, seq_block(w, r), **TOL)


def test_ring_attention_entry_takes_the_ring(world):
    want = _jax_attention("ring_causal_gqa")["whole"][0]
    for r, got in enumerate(ranks(world, "attention")):
        np.testing.assert_allclose(got["entry_ring"], seq_block(want, r),
                                   **TOL)


def test_sharding_on_the_world_matches_jax(world):
    """prune_spec on the gloo world's meshes against JAX's on the same axis
    sizes; local shapes are global / pieces; with_logical_constraint
    refuses a global tensor where a local one belongs."""
    from ray_tpu.parallel.sharding import logical_to_spec as jax_to_spec
    from ray_tpu.parallel.sharding import prune_spec as jax_prune

    cfg = LlamaConfig.tiny()
    for key, sizes in MESHES.items():
        jmesh = _jax_mesh(tuple(sorted(sizes.items())))
        pieces = {"dp2_fsdp2": (1, 2), "sp2_tp2": (2, 1),
                  "fsdp2_tp2": (2, 2)}[key]
        for rec in ranks(world, "sharding"):
            got = rec[key]
            for a in SPEC_CASES:
                assert got["pruned"][str(a)] == tuple(
                    jax_prune(jmesh, jax_to_spec(a))), (key, a)
            assert got["embed_local"] == (cfg.vocab_size // pieces[0],
                                          cfg.hidden_size // pieces[1])
            assert got["wrong_shape_raised"]


def test_moe_and_pipeline_under_a_mesh_raise(world):
    """The one raise left of MoE and pipelines under a mesh: a rule that
    puts a data axis on the experts raises ValueError (a deliberate
    difference: JAX would move the tokens with an all-to-all), in the
    model and in moe_ffn. MoE under any axis > 1 and pp > 1 build."""
    for raised in ranks(world, "expert_rules"):
        for r in raised:
            assert r and "['dp']" in r and "experts" in r, raised


def test_flat_broadcast_matches_one_broadcast_each(world):
    """Packed calls carry every tensor as its own broadcast does, and the
    backward reduces each gradient (per dtype) onto the root."""
    for r, got in enumerate(ranks(world, "flat_broadcast")):
        for name in ("flat", "split"):
            for a, b in zip(got[name][0] + got[name][1],
                            got["each"][0] + got["each"][1]):
                assert a.dtype == b.dtype
                np.testing.assert_array_equal(a, b, err_msg=f"{name} {r}")


def test_collective_group_barrier_and_broadcast(world):
    for got in ranks(world, "collective_group"):
        assert got == {"from": 1, "x": [1, 2]}


# ---------------------------------------------- pure functions (no world)

class _Mesh:
    """The two things prune_spec reads of a DeviceMesh."""

    def __init__(self, sizes):
        self.mesh_dim_names = AXIS_ORDER
        self._sizes = [sizes.get(a, 1) for a in AXIS_ORDER]

    def size(self, i):
        return self._sizes[i]


@pytest.mark.parametrize("n,cfg", [
    (8, {}), (8, dict(tp=2)), (8, dict(dp=2, sp=2, tp=2)),
    (8, dict(dp=1, fsdp=2)), (6, dict(tp=4)), (4, dict(dp=-1, fsdp=-1)),
    (2, dict(dp=2, tp=2)), (1, dict(dp=1)), (8, dict(dp=-1, sp=2, tp=2)),
])
def test_mesh_config_resolve_matches_jax(n, cfg):
    from ray_tpu.parallel.mesh import MeshConfig as JaxMeshConfig

    def run(cls):
        try:
            return cls(**cfg).resolve(n).sizes()
        except ValueError as e:
            return ("ValueError", str(e))

    assert run(MeshConfig) == run(JaxMeshConfig)


RULE_SETS = {
    "default": DEFAULT_RULES,
    "sequence_over_tp_too": (("batch", "dp"), ("seq", ("sp", "tp")),
                             ("heads", "tp"), ("embed", ("fsdp", "sp"))),
    "none": (),
}


@pytest.mark.parametrize("rules", sorted(RULE_SETS))
@pytest.mark.parametrize("axes", SPEC_CASES + (
    ("batch", None, "kv_seq"), ("expert", "embed", "mlp"), (None, None)))
def test_logical_to_spec_and_prune_match_jax(rules, axes):
    from ray_tpu.parallel.sharding import logical_to_spec as jax_to_spec
    from ray_tpu.parallel.sharding import prune_spec as jax_prune

    spec = logical_to_spec(axes, RULE_SETS[rules])
    want = jax_to_spec(axes, RULE_SETS[rules])
    assert spec == tuple(want)
    for sizes in ((("dp", 2), ("sp", 2), ("tp", 2)),
                  (("dp", 1), ("fsdp", 4)), (("dp", 1),)):
        got = prune_spec(_Mesh(dict(sizes)), spec)
        assert got == tuple(jax_prune(_jax_mesh(sizes), want)), sizes


@pytest.mark.parametrize("moe", [False, True])
def test_param_logical_axes_match_jax(moe):
    from ray_tpu.models import LlamaConfig as JaxConfig
    from ray_tpu.models.llama import param_logical_axes as jax_axes

    assert param_logical_axes(LlamaConfig.tiny(moe=moe)) == jax_axes(
        JaxConfig.tiny(moe=moe))


def test_cuda_mesh_needs_a_card_and_nccl(monkeypatch):
    """A mesh on the card never runs on gloo or on the CPU: without a card
    it raises; in a gloo world it raises."""
    with pytest.raises(RuntimeError, match="CUDA"):
        make_mesh(dp=1)
    fake = types.SimpleNamespace(type="cuda")
    monkeypatch.setattr("ray_tpu_torch.parallel.mesh.resolve_device",
                        lambda device: fake)
    monkeypatch.setattr(dist, "is_initialized", lambda: True)
    monkeypatch.setattr(dist, "get_backend", lambda: "gloo")
    with pytest.raises(RuntimeError, match="needs a nccl process group"):
        make_mesh(dp=1)
