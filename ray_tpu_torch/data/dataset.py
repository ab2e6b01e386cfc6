"""Dataset: lazy, streaming, distributed data over blocks (counterpart of
``ray_tpu/data/dataset.py``).

Ref analogue: python/ray/data/dataset.py Dataset (:158) with the logical
plan + streaming execution model of _internal/execution/: transforms build
a lazy STAGE pipeline (streaming_executor.py) — fused per-block task
chains plus actor-pool stages for stateful transforms — executed with
per-stage bounded in-flight windows (backpressure). Global ops
(shuffle/sort/repartition) run as distributed two-stage shuffles
(shuffle.py) whose intermediate partitions never touch the driver.

Blocks are numpy column dicts (block.py). Under the port's runtime the
plan travels by reference: the functions given to ``map_batches``,
``map``, ``filter`` and the rest must be module-level (a lambda is refused
by name when the plan first runs); without a runtime anything callable
works. ``iter_torch_batches`` puts batches on the CUDA card through
``ingest.iter_device_batches`` unless ``device="cpu"`` is given (the JAX
package's defaults to host tensors).
"""

from __future__ import annotations

import collections
import inspect
import itertools
from typing import Any, Dict, Iterator, List, Optional

import numpy as np

from .block import (
    Block,
    BlockAccessor,
    batch_to_format,
    concat_blocks,
    from_numpy_dict,
    from_rows,
    normalize_to_block,
)
from .streaming_executor import (
    ActorStage,
    ExecStats,
    TaskStage,
    UnionSource,
    ZipSource,
    _BlockSource,
    _RefSource,
    execute,
    execute_refs,
    use_remote,
)


# ----------------------------------------------------------- logical plan


class _Op:
    """A per-block transform (fusable)."""

    def apply(self, block: Block) -> Block:
        raise NotImplementedError


class _MapBatches(_Op):
    def __init__(self, fn, batch_format: str, batch_size: Optional[int]):
        self.fn = fn
        self.batch_format = batch_format
        self.batch_size = batch_size

    def apply(self, block: Block) -> Block:
        acc = BlockAccessor(block)
        n = acc.num_rows()
        bs = self.batch_size or max(n, 1)
        out = []
        for start in range(0, max(n, 1), bs):
            sub = acc.slice(start, min(start + bs, n)) if n else block
            res = self.fn(batch_to_format(sub, self.batch_format))
            out.append(normalize_to_block(res))
            if n == 0:
                break
        return concat_blocks(out) if out else block


class _MapRows(_Op):
    def __init__(self, fn):
        self.fn = fn

    def apply(self, block: Block) -> Block:
        return from_rows(
            [self.fn(dict(r)) for r in BlockAccessor(block).iter_rows()])


class _FlatMapRows(_Op):
    def __init__(self, fn):
        self.fn = fn

    def apply(self, block: Block) -> Block:
        rows = []
        for r in BlockAccessor(block).iter_rows():
            rows.extend(self.fn(dict(r)))
        return from_rows(rows)


class _FilterRows(_Op):
    def __init__(self, fn):
        self.fn = fn

    def apply(self, block: Block) -> Block:
        acc = BlockAccessor(block)
        keep = np.asarray(
            [bool(self.fn(dict(r))) for r in acc.iter_rows()], dtype=bool
        )
        return acc.take(np.nonzero(keep)[0])


# The column transforms the JAX package writes as closures, as picklable
# callables: each runs as a map_batches function.


class _AddColumn:
    def __init__(self, name: str, fn):
        self.name = name
        self.fn = fn

    def __call__(self, batch):
        batch[self.name] = np.asarray(self.fn(batch))
        return batch


class _SelectColumns:
    def __init__(self, cols: List[str], keep: bool):
        self.cols = list(cols)
        self.keep = keep

    def __call__(self, batch):
        return {k: v for k, v in batch.items()
                if (k in self.cols) == self.keep}


class _RenameColumns:
    def __init__(self, mapping: Dict[str, str]):
        self.mapping = dict(mapping)

    def __call__(self, batch):
        return {self.mapping.get(k, k): v for k, v in batch.items()}


class _RandomSample:
    def __init__(self, fraction: float, seed: Optional[int]):
        self.fraction = fraction
        self.seed = seed

    def __call__(self, batch):
        import zlib

        n = len(next(iter(batch.values()), []))
        if self.seed is not None:
            # Derive a per-batch stream by mixing the seed with the batch
            # CONTENT — the same sampler runs in every block's worker, so
            # reusing `seed` directly would draw the same mask offsets in
            # every block (position-correlated, not i.i.d.).
            first = np.ascontiguousarray(next(iter(batch.values())))
            salt = zlib.crc32(first.tobytes())
            rng = np.random.default_rng((self.seed, salt))
        else:
            rng = np.random.default_rng()
        mask = rng.random(n) < self.fraction
        return {k: np.asarray(v)[mask] for k, v in batch.items()}


# -------------------------------------------------------------- the API


class Dataset:
    def __init__(self, sources: Any, ops: Optional[List[Any]] = None, *,
                 _pin: Any = None):
        # sources: picklable zero-arg callables producing the input blocks
        # (reads, held blocks, store refs) or a plan DAG node; ops: stage
        # pipeline — a flat op list is wrapped into one fused TaskStage.
        # _pin keeps upstream shuffle partitions alive while this
        # dataset's refs are consumed.
        self._sources = sources
        if ops and not isinstance(ops[0], (TaskStage, ActorStage)):
            ops = [TaskStage(ops)]
        self._stages: List[Any] = list(ops) if ops else [TaskStage([])]
        self._pin = _pin

    @property
    def _ops(self) -> List[_Op]:
        """Flat fused op chain (only valid for single-task-stage plans)."""
        assert len(self._stages) == 1 and isinstance(
            self._stages[0], TaskStage
        ), "plan has actor stages; use _stages"
        return self._stages[0].ops

    # ---- construction helpers (used by read_api) ----

    @classmethod
    def from_blocks(cls, blocks: List[Block], *, _pin: Any = None
                    ) -> "Dataset":
        return cls([_BlockSource(b) for b in blocks], _pin=_pin)

    @classmethod
    def _from_refs(cls, refs: List[Any], *, _pin: Any = None) -> "Dataset":
        """Blocks already in the store (e.g. shuffle output): each source
        pulls its ref where it executes — never via the driver."""
        return cls([_RefSource(r) for r in refs], _pin=(_pin, refs))

    # ---- lazy transforms (per-block: fused) ----

    def _with_op(self, op: _Op) -> "Dataset":
        last = self._stages[-1]
        if isinstance(last, TaskStage):
            stages = self._stages[:-1] + [last.with_op(op)]
        else:
            stages = self._stages + [TaskStage([op])]
        return Dataset(self._sources, stages, _pin=self._pin)

    def map_batches(self, fn, *, batch_format: str = "numpy",
                    batch_size: Optional[int] = None,
                    concurrency: Optional[int] = None,
                    fn_constructor_args: tuple = (),
                    fn_constructor_kwargs: Optional[dict] = None,
                    ray_remote_args: Optional[dict] = None) -> "Dataset":
        """Per-batch transform. A CLASS argument becomes a stateful
        actor-pool stage of ``concurrency`` members, each constructing the
        class once (ref: actor_pool_map_operator.py — the operator for
        model-loading transforms); ``ray_remote_args`` are its actors'
        options (``{"num_gpus": 1}`` puts each member on a card)."""
        if inspect.isclass(fn):
            stage = ActorStage(
                fn, fn_constructor_args, fn_constructor_kwargs or {},
                concurrency or 2, batch_format, batch_size,
                ray_remote_args,
            )
            return Dataset(
                self._sources, self._stages + [stage], _pin=self._pin
            )
        return self._with_op(_MapBatches(fn, batch_format, batch_size))

    def map(self, fn) -> "Dataset":
        return self._with_op(_MapRows(fn))

    def flat_map(self, fn) -> "Dataset":
        return self._with_op(_FlatMapRows(fn))

    def filter(self, fn) -> "Dataset":
        return self._with_op(_FilterRows(fn))

    def add_column(self, name: str, fn) -> "Dataset":
        return self.map_batches(_AddColumn(name, fn))

    def drop_columns(self, cols: List[str]) -> "Dataset":
        return self.map_batches(_SelectColumns(cols, keep=False))

    def select_columns(self, cols: List[str]) -> "Dataset":
        return self.map_batches(_SelectColumns(cols, keep=True))

    # ---- global ops (distributed two-stage shuffles) ----

    def _use_remote(self) -> bool:
        return use_remote()

    def _shuffle_plan(self, *, materialize: bool = False):
        """(sources, fusable ops, hold) for a shuffle's map stage: the
        fused op chain when the plan is one task stage, else the
        pre-executed block refs (actor stages must run before
        partitioning; sort also materializes so boundary sampling doesn't
        execute the chain twice). ``hold`` must stay pinned until the
        shuffle output is consumed — it keeps the intermediate refs alive
        past this driver frame."""
        single_task = (
            not self._is_node_plan()
            and len(self._stages) == 1
            and isinstance(self._stages[0], TaskStage)
        )
        if single_task and not materialize:
            return self._sources, self._stages[0].ops, None
        refs = list(execute_refs(self._sources, self._stages))
        return [_RefSource(r) for r in refs], [], refs

    def _shuffled(self, num: int, assigner: str, arg=None,
                  postprocess=None) -> "Dataset":
        from . import shuffle as _shuffle

        srcs, ops, hold = self._shuffle_plan()
        reduce_refs, pin = _shuffle.shuffle(
            srcs, ops, num, assigner, arg, postprocess
        )
        return Dataset._from_refs(
            reduce_refs, _pin=(self._pin, pin, hold)
        )

    def repartition(self, num_blocks: int) -> "Dataset":
        if self._use_remote():
            return self._shuffled(num_blocks, "contiguous")
        full = BlockAccessor(self._materialize_table())
        n = full.num_rows()
        sizes = [n // num_blocks + (1 if i < n % num_blocks else 0)
                 for i in range(num_blocks)]
        blocks, start = [], 0
        for s in sizes:
            blocks.append(full.slice(start, start + s))
            start += s
        return Dataset.from_blocks(blocks)

    def random_shuffle(self, *, seed: Optional[int] = None) -> "Dataset":
        if self._use_remote():
            import random as _random

            num = max(1, self.num_blocks())
            return self._shuffled(
                num, "random",
                seed if seed is not None else _random.randrange(2 ** 31),
            )
        full = BlockAccessor(self._materialize_table())
        idx = np.random.RandomState(seed).permutation(full.num_rows())
        num = max(1, self.num_blocks())
        return Dataset.from_blocks([full.take(idx)]).repartition(num)

    def sort(self, key: str, *, descending: bool = False) -> "Dataset":
        if self._use_remote():
            from . import shuffle as _shuffle

            # Materialize once: boundary sampling + shuffle both read the
            # stored blocks instead of re-running the upstream chain.
            srcs, ops, hold = self._shuffle_plan(materialize=True)
            num = max(1, len(srcs))
            bounds = _shuffle.sample_sort_boundaries(srcs, ops, key, num)
            reduce_refs, pin = _shuffle.shuffle(
                srcs, ops, num, "range", (key, bounds, descending),
                _shuffle._SortBlock(key, descending),
            )
            return Dataset._from_refs(
                reduce_refs, _pin=(self._pin, pin, hold)
            )
        full = BlockAccessor(self._materialize_table())
        idx = np.argsort(full.block[key], kind="stable")
        if descending:
            idx = idx[::-1]
        return Dataset.from_blocks([full.take(idx)])

    def union(self, *others: "Dataset") -> "Dataset":
        """Streaming concatenation: upstream datasets execute their own
        chains and their block streams concatenate in order — an
        operator-DAG fan-in, nothing materializes on the driver (ref:
        Dataset.union over the executor's operator graph)."""
        inputs = [self, *others]
        return Dataset(UnionSource(inputs),
                       _pin=tuple(d._pin for d in inputs))

    def zip(self, other: "Dataset") -> "Dataset":
        """Pairwise block zip: block i of ``self`` merges columns with
        block i of ``other`` (right-side name collisions get a ``_1``
        suffix). Both datasets must be identically blocked — same block
        count and per-block row counts (ref: Dataset.zip)."""
        return Dataset(ZipSource(self, other),
                       _pin=(self._pin, other._pin))

    def _is_node_plan(self) -> bool:
        return isinstance(self._sources, (UnionSource, ZipSource))

    def _ensure_flat(self) -> "Dataset":
        """A dataset whose sources are a flat list — node-sourced plans
        (union/zip) materialize their blocks first (needed by the
        source-indexed paths: split, streaming_split, shuffles)."""
        return self.materialize() if self._is_node_plan() else self

    def limit(self, n: int) -> "Dataset":
        out, taken = [], 0
        for block in self._iter_blocks():
            if taken >= n:
                break
            acc = BlockAccessor(block)
            take = min(n - taken, acc.num_rows())
            out.append(acc.slice(0, take))
            taken += take
        return Dataset.from_blocks(out or [from_numpy_dict({})])

    def groupby(self, key: str):
        from .grouped_data import GroupedData

        return GroupedData(self, key)

    # ---- execution ----

    def _iter_blocks(self) -> Iterator[Block]:
        """Streaming execution through the stage pipeline (per-stage
        bounded windows = per-operator backpressure; see
        streaming_executor.py)."""
        self._last_stats = ExecStats()
        yield from execute(self._sources, self._stages, self._last_stats)

    def iter_batches(
        self,
        *,
        batch_size: Optional[int] = 256,
        batch_format: str = "numpy",
        drop_last: bool = False,
    ) -> Iterator[Any]:
        """NOTE: numpy batches are READ-ONLY views over the blocks; copy
        before mutating in place (``batch["x"] = batch["x"] * s``, not
        ``*=``)."""
        leftover: Optional[Block] = None
        for block in self._iter_blocks():
            if leftover is not None and BlockAccessor(leftover).num_rows():
                block = concat_blocks([leftover, block])
                leftover = None
            if batch_size is None:
                yield batch_to_format(block, batch_format)
                continue
            acc = BlockAccessor(block)
            n = acc.num_rows()
            start = 0
            while n - start >= batch_size:
                yield batch_to_format(
                    acc.slice(start, start + batch_size), batch_format
                )
                start += batch_size
            if start < n:
                leftover = acc.slice(start, n)
        if leftover is not None and BlockAccessor(leftover).num_rows() \
                and not drop_last:
            yield batch_to_format(leftover, batch_format)

    def iter_blocks_refs(self) -> Iterator[Any]:
        """Streaming execution yielding per-block ObjectRefs (the blocks
        stay in the store; nothing materializes on the driver) — the
        consumption surface backpressure acts through."""
        self._last_stats = ExecStats()
        yield from execute_refs(self._sources, self._stages,
                                self._last_stats)

    def iter_rows(self) -> Iterator[Dict[str, Any]]:
        for block in self._iter_blocks():
            yield from BlockAccessor(block).iter_rows()

    def iter_torch_batches(self, *, batch_size: int = 256, dtypes=None,
                           device=None, drop_last: bool = False
                           ) -> Iterator[Dict[str, Any]]:
        """Batches as ``{column: torch.Tensor}`` on ``device`` (default:
        the CUDA card, which raises without one; ``"cpu"`` when asked),
        the next one already on its way (``ingest.iter_device_batches``:
        pinned staging and side-stream copies on the card, the ingest's
        dtypes — float64 as float32, int64 as int32 — unless ``dtypes``
        says otherwise). Object columns (strings, bytes) pass through as
        lists, as in the JAX package."""
        from .ingest import iter_device_batches

        objects: collections.deque = collections.deque()

        def arrays():
            for batch in self.iter_batches(batch_size=batch_size,
                                           drop_last=drop_last):
                objects.append((list(batch), {
                    k: list(v) for k, v in batch.items()
                    if v.dtype == object}))
                yield {k: v for k, v in batch.items() if v.dtype != object}

        for out in iter_device_batches(arrays(), device=device,
                                       dtypes=dtypes):
            order, lists = objects.popleft()
            out.update(lists)
            yield {k: out[k] for k in order}

    # ---- consumption ----

    def _materialize_table(self) -> Block:
        return concat_blocks(list(self._iter_blocks()))

    def materialize(self) -> "Dataset":
        if self._use_remote():
            self._last_stats = ExecStats()
            refs = list(execute_refs(self._sources, self._stages,
                                     self._last_stats))
            out = Dataset._from_refs(refs, _pin=self._pin)
            out._last_stats = self._last_stats
            return out
        return Dataset.from_blocks(list(self._iter_blocks()))

    def take(self, n: int = 20) -> List[Dict[str, Any]]:
        return list(itertools.islice(self.iter_rows(), n))

    def take_all(self) -> List[Dict[str, Any]]:
        return list(self.iter_rows())

    def count(self) -> int:
        return sum(BlockAccessor(b).num_rows() for b in self._iter_blocks())

    def schema(self):
        """The first block's :class:`~.block.Schema` (names, dtypes and
        per-row shapes), None for a dataset without blocks."""
        for block in self._iter_blocks():
            return BlockAccessor(block).schema()
        return None

    def columns(self) -> List[str]:
        s = self.schema()
        return list(s.names) if s else []

    def num_blocks(self) -> int:
        if isinstance(self._sources, UnionSource):
            return sum(d.num_blocks() for d in self._sources.datasets)
        if isinstance(self._sources, ZipSource):
            return self._sources.left.num_blocks()
        return len(self._sources)

    def show(self, n: int = 20):
        for row in self.take(n):
            print(row)

    def to_numpy(self) -> Dict[str, np.ndarray]:
        return BlockAccessor(self._materialize_table()).to_numpy()

    def stats(self) -> str:
        """Per-stage / per-operator execution stats of the LAST executed
        pipeline on this dataset (wall per op, rows, bytes, blocks — ref
        analogue: data/_internal/stats.py ds.stats()); the static plan
        description before any execution."""
        last = getattr(self, "_last_stats", None)
        if last is not None and last.stage_names:
            return last.summary()
        nops = sum(
            len(s.ops) if isinstance(s, TaskStage) else 1
            for s in self._stages
        )
        return (f"Dataset(blocks={self.num_blocks()}, "
                f"stages={len(self._stages)}, ops={nops})")

    # ---- write sinks (distributed per-block writes) ----

    def write_numpy(self, path: str, *, column: str = "data") -> List[str]:
        """One ``.npy`` file of ``column`` per block, written by remote
        tasks under a runtime."""
        from .datasink import write_blocks

        return write_blocks(self.select_columns([column]), path, "npy")

    # ---- splitting for train ingest ----

    def streaming_split(self, n: int, *, equal: bool = True
                        ) -> List["DataIterator"]:  # noqa: F821
        """Per-worker shard iterators (ref: dataset.py:1269
        streaming_split). Shard i consumes source blocks i, i+n, ...; a
        union or zip plan under a runtime streams through one shared
        coordinator actor instead (``max_concurrency=n + 1``: each
        shard's call waits for its next block while the others are
        served)."""
        from .iterator import DataIterator

        if self._is_node_plan() and self._use_remote():
            # DAG plans stream through ONE shared coordinator actor
            # (executes the plan once, deals blocks round-robin with
            # bounded buffers) — splitting must not materialize the
            # upstream (ref: OutputSplitter behind streaming_split).
            from ..core import api as _api
            from .iterator import _SplitCoordinator

            coord = _api.remote(max_concurrency=n + 1)(
                _SplitCoordinator
            ).remote(self, n)
            return [DataIterator(self, shard_index=i, num_shards=n,
                                 coordinator=coord)
                    for i in range(n)]
        flat = self._ensure_flat()
        return [DataIterator(flat, shard_index=i, num_shards=n)
                for i in range(n)]

    def split(self, n: int) -> List["Dataset"]:
        flat = self._ensure_flat()
        return [
            Dataset(flat._sources[i::n], list(flat._stages),
                    _pin=flat._pin)
            for i in range(n)
        ]

    def split_at_indices(self, indices: List[int]) -> List["Dataset"]:
        """Split at global row offsets (ref: dataset.split_at_indices);
        materializes block boundaries."""
        bounds = list(indices) + [None]
        out: List[List[Block]] = [[] for _ in bounds]
        row = 0
        part = 0
        for block in self._iter_blocks():
            acc = BlockAccessor(block)
            nrows = acc.num_rows()
            off = 0
            while off < nrows:
                end = bounds[part]
                if end is None:
                    out[part].append(acc.slice(off, nrows))
                    off = nrows
                    continue
                take = min(nrows - off, end - row)
                if take > 0:
                    out[part].append(acc.slice(off, off + take))
                    off += take
                    row += take
                if row >= end:
                    part += 1
            # blocks exhausted; advance parts with zero-length bounds
            while bounds[part] is not None and row >= bounds[part]:
                part += 1
        return [
            Dataset.from_blocks(blocks or [from_numpy_dict({})],
                                _pin=self._pin)
            for blocks in out
        ]

    def split_proportionately(self, proportions: List[float]
                              ) -> List["Dataset"]:
        """Split by fractions; the remainder forms the final split
        (ref: dataset.split_proportionately)."""
        if not proportions or sum(proportions) >= 1.0 or \
                any(p <= 0 for p in proportions):
            raise ValueError(
                "proportions must be positive and sum to < 1"
            )
        n = self.count()
        indices, acc = [], 0
        for p in proportions:
            acc += int(n * p)
            indices.append(acc)
        return self.split_at_indices(indices)

    def train_test_split(self, test_size: float, *,
                         shuffle: bool = False,
                         seed: Optional[int] = None
                         ) -> List["Dataset"]:
        """(train, test) split (ref: dataset.train_test_split)."""
        if not 0 < test_size < 1:
            raise ValueError("test_size must be in (0, 1)")
        ds = self.random_shuffle(seed=seed) if shuffle else self
        train, test = ds.split_proportionately([1.0 - test_size])
        return [train, test]

    def random_sample(self, fraction: float, *,
                      seed: Optional[int] = None) -> "Dataset":
        """Bernoulli row sample (ref: dataset.random_sample); lazy."""
        if not 0 <= fraction <= 1:
            raise ValueError("fraction must be in [0, 1]")
        return self.map_batches(_RandomSample(fraction, seed),
                                batch_format="numpy")

    def unique(self, column: str) -> List[Any]:
        """Distinct values of one column (ref: dataset.unique)."""
        seen = {}
        for batch in self.select_columns([column]).iter_batches(
            batch_format="numpy"
        ):
            for v in batch[column]:
                key = v.item() if hasattr(v, "item") else v
                seen.setdefault(key, None)
        return list(seen)

    def rename_columns(self, mapping: Dict[str, str]) -> "Dataset":
        """Rename columns lazily (ref: dataset.rename_columns)."""
        return self.map_batches(_RenameColumns(mapping),
                                batch_format="numpy")

    # -- column aggregates (ref: dataset.sum/min/max/mean/std) --

    def _agg_column(self, on: str):
        parts = [
            np.asarray(b[on])
            for b in self.select_columns([on]).iter_batches(
                batch_format="numpy"
            )
            if len(b[on])
        ]
        return np.concatenate(parts) if parts else np.asarray([])

    def sum(self, on: str):
        vals = self._agg_column(on)
        return vals.sum().item() if vals.size else None

    def min(self, on: str):
        vals = self._agg_column(on)
        return vals.min().item() if vals.size else None

    def max(self, on: str):
        vals = self._agg_column(on)
        return vals.max().item() if vals.size else None

    def mean(self, on: str):
        vals = self._agg_column(on)
        return vals.mean().item() if vals.size else None

    def std(self, on: str, ddof: int = 1):
        vals = self._agg_column(on)
        return (vals.std(ddof=ddof).item()
                if vals.size > ddof else None)

    def __repr__(self):
        return self.stats()

