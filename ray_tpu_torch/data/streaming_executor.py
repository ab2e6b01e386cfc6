"""Multi-operator streaming execution (counterpart of
``ray_tpu/data/streaming_executor.py``).

Ref analogue: python/ray/data/_internal/execution/streaming_executor.py
(:242 scheduling loop) + operators/map_operator.py +
operators/actor_pool_map_operator.py. The plan is a list of STAGES:

- ``TaskStage``: a fused chain of per-block ops, one remote task per block
  (the reference's fused MapOperator). The first TaskStage fuses with the
  read: source + ops run inside one task.
- ``ActorStage``: a pool of stateful actors each holding one instance of a
  user callable class (the reference's ActorPoolMapOperator — the operator
  for model-loading transforms where per-task construction would
  dominate). Its ``ray_remote_args`` (``num_gpus`` among them) are the
  pool actors' options, so a GPU pool's members are GPU-typed workers.

Execution is a chain of pull-based generators, one per stage, each with its
own bounded in-flight window — per-operator backpressure: a slow stage
stops pulling, which stops its upstream from submitting. Blocks stream
between stages as ObjectRefs (never gathered on the driver).

Under the port's runtime everything a task or an actor receives travels
by reference (``pickle``): sources, ops and user functions must be
importable at module level in the workers. A plan holding a lambda or a
local function is refused with the runtime's ``TypeError``, naming it,
when it first runs; without a runtime the plan runs in this process and
nothing is pickled.
"""

from __future__ import annotations

import time
from typing import Any, Dict, Iterator, List, Optional, Sequence

from ..core import api as _api
from ..core import runtime_context
from ..core.reference import ObjectRef
from .block import BlockAccessor, from_numpy_dict
from .context import DataContext


class TaskStage:
    def __init__(self, ops: Optional[List[Any]] = None):
        self.ops = list(ops or [])

    def with_op(self, op) -> "TaskStage":
        return TaskStage(self.ops + [op])


class ActorStage:
    """Stateful map_batches through a pool of actors."""

    def __init__(self, fn_cls: type, fn_constructor_args: tuple,
                 fn_constructor_kwargs: dict, pool_size: int,
                 batch_format: str, batch_size: Optional[int],
                 ray_remote_args: Optional[dict] = None):
        self.fn_cls = fn_cls
        self.fn_constructor_args = fn_constructor_args
        self.fn_constructor_kwargs = fn_constructor_kwargs
        self.pool_size = pool_size
        self.batch_format = batch_format
        self.batch_size = batch_size
        self.ray_remote_args = ray_remote_args or {}


# ---- sources -------------------------------------------------------------
#
# A source is a picklable zero-argument callable returning one block: a
# read (read_api.py), a block held in the plan, or a block in the store.


class _BlockSource:
    def __init__(self, block):
        self.block = block

    def __call__(self):
        return self.block


class _RefSource:
    """A block already in the store (a shuffle's or a materialize's
    output): pulled where the task runs, never through the driver."""

    def __init__(self, ref: ObjectRef):
        self.ref = ref

    def __call__(self):
        return _api.get(self.ref)


# ---- plan DAG nodes (non-linear inputs) ----------------------------------
#
# A Dataset's ``sources`` is either a flat list of sources (the leaf case)
# or one of these nodes — making the physical plan an operator DAG rather
# than a chain (ref analogue: the operator graph in
# _internal/execution/streaming_executor_state.py, where zip/union are
# physical operators with multiple input edges).


class UnionSource:
    """Concatenation of several upstream datasets' block streams, in
    order (ref: Dataset.union)."""

    def __init__(self, datasets: List[Any]):
        self.datasets = list(datasets)


class ZipSource:
    """Pairwise block zip of two upstream datasets (ref: Dataset.zip —
    both sides must have the same number of blocks and row counts per
    block; a mismatch raises inside the zip task)."""

    def __init__(self, left: Any, right: Any):
        self.left = left
        self.right = right


def _zip_blocks(left, right):
    """Column-merge two row-aligned blocks; right-side name collisions
    get the first free ``_<n>`` suffix (the reference's zip semantics)."""
    ln = BlockAccessor(left).num_rows()
    rn = BlockAccessor(right).num_rows()
    if ln != rn:
        raise ValueError(
            f"zip requires row-aligned blocks; got {ln} vs {rn} rows "
            "(repartition both datasets identically first)"
        )
    out = dict(left)
    for k, v in right.items():
        name = k
        suffix = 1
        while name in out:  # first free suffix: never clobber a column
            name = f"{k}_{suffix}"
            suffix += 1
        out[name] = v
    return from_numpy_dict(out)


# ---- backpressure policies (ref: backpressure_policy/) -------------------


class BackpressurePolicy:
    """Submission gate consulted by every stage before launching a new
    block task. ``can_submit`` may return False only while the stage has
    work in flight (progress is always possible)."""

    def can_submit(self, num_inflight: int) -> bool:
        raise NotImplementedError


class ConcurrencyCapPolicy(BackpressurePolicy):
    """Bound concurrent block tasks per stage (ref:
    concurrency_cap_backpressure_policy.py)."""

    def __init__(self, cap: int):
        self.cap = max(1, cap)

    def can_submit(self, num_inflight: int) -> bool:
        return num_inflight < self.cap


class StoreUsagePolicy(BackpressurePolicy):
    """Resource-aware: stop submitting while the objects the driver holds
    fill more than ``cap_fraction`` of ``init(object_store_memory=)``
    (``capacity``, read once when the plan starts: it is fixed at
    ``init``), so a slow consumer bounds producer memory (ref: the
    reference's output-size/resource backpressure). Always allows the
    first in-flight task."""

    def __init__(self, cap_fraction: float, capacity: int):
        self.cap_fraction = cap_fraction
        self.capacity = capacity

    def can_submit(self, num_inflight: int) -> bool:
        if num_inflight == 0:
            return True  # progress guarantee
        used, _ = runtime_context.current_runtime().store_usage()
        return used / self.capacity < self.cap_fraction


def _default_policies(ctx) -> List[BackpressurePolicy]:
    """The concurrency cap, and the store-usage policy where ``init`` set a
    capacity (without one it never holds back, so it is left out and its
    reads of the driver's count, a round trip from a worker, are saved)."""
    out: List[BackpressurePolicy] = [
        ConcurrencyCapPolicy(ctx.max_in_flight_tasks)
    ]
    if ctx.store_usage_cap_fraction > 0:
        _, capacity = runtime_context.current_runtime().store_usage()
        if capacity > 0:
            out.append(StoreUsagePolicy(ctx.store_usage_cap_fraction,
                                        capacity))
    return out


# ---- execution stats (per-operator; ref: data/_internal/stats.py) --------


class ExecStats:
    """Per-stage / per-operator accounting for ONE execution: each fused
    task measures its ops' wall time and its output block's rows/bytes
    in the worker, returning them as a second (tiny) task output; the
    driver aggregates lazily when Dataset.stats() is called."""

    def __init__(self):
        self.stage_names: List[str] = []
        self.stats_refs: List[List[Any]] = []   # per stage: refs/dicts
        self.blocks: List[int] = []
        self.wall_s: float = 0.0

    def add_stage(self, name: str) -> int:
        self.stage_names.append(name)
        self.stats_refs.append([])
        self.blocks.append(0)
        return len(self.stage_names) - 1

    def summary(self) -> str:
        lines = []
        for i, name in enumerate(self.stage_names):
            resolved = []
            for item in self.stats_refs[i]:
                if isinstance(item, dict):
                    resolved.append(item)
                elif runtime_context.is_initialized():
                    resolved.append(_api.get(item, timeout=60))
            rows = sum(st.get("rows", 0) for st in resolved)
            nbytes = sum(st.get("bytes", 0) for st in resolved)
            per_op: Dict[str, float] = {}
            for st in resolved:
                for op_name, dur in st.get("ops", []):
                    per_op[op_name] = per_op.get(op_name, 0.0) + dur
            lines.append(
                f"Stage {i} {name}: {self.blocks[i]} blocks, "
                f"{rows} rows, {nbytes} bytes"
            )
            for op_name, dur in per_op.items():
                lines.append(f"  * {op_name}: {dur * 1e3:.1f}ms")
        lines.append(f"Total wall: {self.wall_s * 1e3:.1f}ms")
        return "\n".join(lines)


def _block_stats(block, per_op):
    acc = BlockAccessor(block)
    return {"ops": per_op, "rows": acc.num_rows(), "bytes": acc.size_bytes()}


def _op_name(op) -> str:
    return type(op).__name__.lstrip("_")


# ---- task bodies (module level: they travel by reference) ----------------


def _run_chain_from_source(src, ops: List[Any]):
    block = src()
    for op in ops:
        block = op.apply(block)
    return block


def _run_chain_on_block(block, ops: List[Any]):
    for op in ops:
        block = op.apply(block)
    return block


def _run_chain_from_source_stats(src, ops: List[Any]):
    t0 = time.perf_counter()
    block = src()
    per_op = [("read", time.perf_counter() - t0)]
    block, more = _timed_chain(block, ops)
    return block, _block_stats(block, per_op + more)


def _run_chain_on_block_stats(block, ops: List[Any]):
    block, per_op = _timed_chain(block, ops)
    return block, _block_stats(block, per_op)


def _timed_chain(block, ops):
    per_op = []
    for op in ops:
        t0 = time.perf_counter()
        block = op.apply(block)
        per_op.append((_op_name(op), time.perf_counter() - t0))
    return block, per_op


class _ActorMapWorker:
    """Pool member: holds one instance of the user's callable class (the
    class and its arguments arrive by reference)."""

    def __init__(self, fn_cls, args: tuple, kwargs: dict, batch_format: str,
                 batch_size: Optional[int]):
        self._fn = fn_cls(*args, **kwargs)
        self._batch_format = batch_format
        self._batch_size = batch_size

    def apply(self, block):
        from .dataset import _MapBatches

        op = _MapBatches(self._fn, self._batch_format, self._batch_size)
        return op.apply(block)


# ---- local (no-runtime) execution ---------------------------------------


def _execute_local(sources: Sequence[Any], stages: Sequence[Any],
                   stats: Optional[ExecStats] = None) -> Iterator[Any]:
    from .dataset import _MapBatches

    sidx = -1
    if stats is not None:
        sidx = stats.add_stage("LocalPipeline")
    # Instantiate each actor stage's callable once (pool of one).
    insts = {}
    for i, st in enumerate(stages):
        if isinstance(st, ActorStage):
            insts[i] = st.fn_cls(*st.fn_constructor_args,
                                 **st.fn_constructor_kwargs)
    for src in sources:
        t0 = time.perf_counter()
        block = src()
        per_op = [("read", time.perf_counter() - t0)]
        for i, st in enumerate(stages):
            if isinstance(st, TaskStage):
                block, more = _timed_chain(block, st.ops)
                per_op += more
            else:
                op = _MapBatches(insts[i], st.batch_format, st.batch_size)
                t0 = time.perf_counter()
                block = op.apply(block)
                per_op.append(("MapBatches", time.perf_counter() - t0))
        if stats is not None:
            stats.blocks[sidx] += 1
            stats.stats_refs[sidx].append(_block_stats(block, per_op))
        yield block


# ---- distributed execution ----------------------------------------------


def _task_stage_gen(upstream: Iterator[Any], stage: TaskStage,
                    policies: List[BackpressurePolicy], first: bool,
                    stats: Optional[ExecStats] = None,
                    stage_idx: int = -1) -> Iterator[Any]:
    """Submit one fused task per upstream item; yield result refs in
    order, gating every submission on the backpressure policies
    (concurrency cap + store usage). With ``stats``, the task returns a
    second tiny output carrying per-op wall + block rows/bytes."""
    if stats is not None:
        fn = _api.remote(num_returns=2)(
            _run_chain_from_source_stats if first
            else _run_chain_on_block_stats
        )
    else:
        fn = _api.remote(
            _run_chain_from_source if first else _run_chain_on_block
        )
    inflight: List[Any] = []
    up = iter(upstream)
    done = False
    while inflight or not done:
        while not done and all(
            p.can_submit(len(inflight)) for p in policies
        ):
            item = next(up, None)
            if item is None:
                done = True
                break
            if stats is not None:
                block_ref, stats_ref = fn.remote(item, stage.ops)
                stats.stats_refs[stage_idx].append(stats_ref)
                stats.blocks[stage_idx] += 1
                inflight.append(block_ref)
            else:
                inflight.append(fn.remote(item, stage.ops))
        if inflight:
            yield inflight.pop(0)


def _actor_stage_gen(upstream: Iterator[Any],
                     stage: ActorStage,
                     stats: Optional[ExecStats] = None,
                     stage_idx: int = -1) -> Iterator[Any]:
    """Round-robin blocks over the actor pool; yield in submission order
    (per-actor queueing keeps each member busy without head-of-line
    blocking the whole pool)."""
    opts = dict(stage.ray_remote_args)
    actor_cls = (_api.remote(**opts)(_ActorMapWorker) if opts
                 else _api.remote(_ActorMapWorker))
    pool = [
        actor_cls.remote(stage.fn_cls, tuple(stage.fn_constructor_args),
                         dict(stage.fn_constructor_kwargs),
                         stage.batch_format, stage.batch_size)
        for _ in range(stage.pool_size)
    ]
    try:
        window = stage.pool_size * 2
        inflight: List[Any] = []
        up = iter(upstream)
        done = False
        i = 0
        while inflight or not done:
            while not done and len(inflight) < window:
                item = next(up, None)
                if item is None:
                    done = True
                    break
                member = pool[i % len(pool)]
                i += 1
                inflight.append(member.apply.remote(item))
            if inflight:
                ref = inflight.pop(0)
                # Seal before yielding: the pool is killed when this
                # generator closes, and a killed actor can't seal a result
                # that downstream hasn't consumed yet.
                _api.wait([ref], num_returns=1, timeout=None)
                if stats is not None:
                    stats.blocks[stage_idx] += 1
                yield ref
    finally:
        if runtime_context.is_initialized():  # else the pool died with it
            for a in pool:
                _api.kill(a)


def execute(sources: Any, stages: Sequence[Any],
            stats: Optional[ExecStats] = None) -> Iterator[Any]:
    """Run the stage pipeline; yields materialized blocks on the driver.
    (Use :func:`execute_refs` to keep results remote.)"""
    for item in execute_refs(sources, stages, stats):
        yield _api.get(item) if _is_ref(item) else item


def _is_ref(x) -> bool:
    return isinstance(x, ObjectRef)


def _node_ref_stream(node, stats: Optional[ExecStats]) -> Iterator[Any]:
    """Ref stream for a DAG input node: recursively executes upstream
    plans and combines their block streams (union = ordered concat, zip
    = pairwise zip tasks). Upstream datasets run their OWN stage chains
    — the combined stream then feeds this dataset's stages with
    first=False (blocks arrive as refs, not sources)."""
    if isinstance(node, UnionSource):
        idx = -1
        if stats is not None:
            idx = stats.add_stage(f"Union(x{len(node.datasets)})")
        for ds in node.datasets:
            for ref in execute_refs(ds._sources, ds._stages, None):
                if stats is not None:
                    stats.blocks[idx] += 1
                yield ref if _is_ref(ref) else _api.put(ref)
        return
    if isinstance(node, ZipSource):
        idx = -1
        if stats is not None:
            idx = stats.add_stage("Zip")
        zipper = _api.remote(_zip_blocks)
        left = execute_refs(node.left._sources, node.left._stages, None)
        right = execute_refs(node.right._sources, node.right._stages, None)
        while True:
            lref = next(left, None)
            rref = next(right, None)
            if lref is None and rref is None:
                return
            if lref is None or rref is None:
                raise ValueError(
                    "zip requires datasets with the same number of "
                    "blocks (repartition them identically first)"
                )
            if stats is not None:
                stats.blocks[idx] += 1
            yield zipper.remote(lref, rref)
    raise TypeError(f"unknown plan node {type(node).__name__}")


def _node_local_blocks(node):
    """Local (no-runtime) evaluation of a DAG input node."""
    if isinstance(node, UnionSource):
        for ds in node.datasets:
            yield from execute(ds._sources, ds._stages, None)
        return
    if isinstance(node, ZipSource):
        left = list(execute(node.left._sources, node.left._stages, None))
        right = list(execute(node.right._sources, node.right._stages, None))
        if len(left) != len(right):
            raise ValueError(
                "zip requires datasets with the same number of blocks"
            )
        for lb, rb in zip(left, right):
            yield _zip_blocks(lb, rb)
        return
    raise TypeError(f"unknown plan node {type(node).__name__}")


def use_remote() -> bool:
    """Whether plans run as tasks: a runtime is up (in this process, or
    this is one of its workers) and ``DataContext.use_remote_tasks``."""
    return (DataContext.get_current().use_remote_tasks
            and runtime_context.is_initialized())


def execute_refs(sources: Any, stages: Sequence[Any],
                 stats: Optional[ExecStats] = None) -> Iterator[Any]:
    """Yield per-block results as ObjectRefs (driver never holds data),
    or, without a runtime, the blocks themselves from local inline
    execution. Pass an ``ExecStats`` to collect per-stage / per-operator
    accounting. ``sources`` is either a list of sources or a plan DAG
    node (UnionSource/ZipSource) whose upstream datasets execute as their
    own streaming chains."""
    t_start = time.perf_counter()
    is_node = isinstance(sources, (UnionSource, ZipSource))
    if not use_remote():
        if is_node:
            # Local mode: upstream blocks materialize inline, then this
            # plan's stages run over them like pulled blocks.
            srcs = (_BlockSource(b) for b in _node_local_blocks(sources))
            yield from _execute_local(srcs, stages, stats)
        else:
            yield from _execute_local(sources, stages, stats)
        if stats is not None:
            stats.wall_s = time.perf_counter() - t_start
        return

    policies = _default_policies(DataContext.get_current())
    stages = list(stages) or [TaskStage([])]
    if is_node:
        gen: Iterator[Any] = _node_ref_stream(sources, stats)
        first = False  # upstream yields block refs, not sources
    else:
        gen = iter(sources)
        first = True
    for st in stages:
        if isinstance(st, TaskStage):
            if not st.ops and not first:
                continue  # identity over an already-ref stream: no hop
            idx = -1
            if stats is not None:
                names = [_op_name(o) for o in st.ops]
                label = "Read->" if first else ""
                idx = stats.add_stage(
                    f"TaskStage({label}{'->'.join(names) or 'identity'})"
                )
            gen = _task_stage_gen(gen, st, policies, first, stats, idx)
        else:
            if first:
                idx = -1
                if stats is not None:
                    idx = stats.add_stage("TaskStage(Read)")
                gen = _task_stage_gen(
                    gen, TaskStage([]), policies, True, stats, idx,
                )
            aidx = -1
            if stats is not None:
                aidx = stats.add_stage(
                    f"ActorStage({st.fn_cls.__name__} x{st.pool_size})"
                )
            gen = _actor_stage_gen(gen, st, stats, aidx)
        first = False
    yield from gen
    if stats is not None:
        stats.wall_s = time.perf_counter() - t_start
