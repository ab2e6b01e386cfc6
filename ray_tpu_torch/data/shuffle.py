"""Distributed two-stage shuffle (counterpart of ``ray_tpu/data/shuffle.py``).

Ref analogue: python/ray/data/_internal/push_based_shuffle.py +
planner/exchange/ (ShuffleTaskSpec, sort/repartition/random-shuffle task
schedulers). Map tasks partition each input block into one return slot
per reducer (so partitions live in the store, never on the driver);
reduce tasks take their partition refs as arguments and assemble the
output block. The driver only moves ObjectRefs.

The partition assignment is a module-level function + args, one of:
- random:   seeded per-block permutation → round-robin split (shuffle)
- contiguous: row ranges (repartition)
- range:    searchsorted against sampled boundaries (sort)
- hash:     stable hash of key column mod R (groupby)

The seeds, samples and splits are the JAX package's, so the same plan
gives the same rows in the same order.
"""

from __future__ import annotations

import math
import zlib
from typing import Any, List, Optional, Sequence, Tuple

import numpy as np

from ..core import api as _api
from .block import BlockAccessor, concat_blocks
from .context import DataContext

# ---- partition assigners (return list of index arrays, one per reducer) --


def _assign_random(block, num: int, seed) -> List[np.ndarray]:
    n = BlockAccessor(block).num_rows()
    idx = np.random.RandomState(seed).permutation(n)
    return [idx[r::num] for r in range(num)]


def _assign_contiguous(block, num: int, _arg) -> List[np.ndarray]:
    n = BlockAccessor(block).num_rows()
    bounds = np.linspace(0, n, num + 1).astype(np.int64)
    all_idx = np.arange(n)
    return [all_idx[bounds[r]:bounds[r + 1]] for r in range(num)]


def _assign_range(block, num: int, arg) -> List[np.ndarray]:
    key, boundaries, descending = arg
    col = block[key]
    part = np.searchsorted(np.asarray(boundaries), col, side="right")
    if descending:
        part = (num - 1) - part
    return [np.nonzero(part == r)[0] for r in range(num)]


def _assign_hash(block, num: int, key) -> List[np.ndarray]:
    col = block[key]
    if col.dtype.kind in "OUS":  # strings/objects: stable per-value hash
        part = np.asarray(
            [zlib.crc32(str(v).encode()) % num for v in col],
            dtype=np.int64,
        )
    else:
        part = np.asarray(col).astype(np.int64) % num
    return [np.nonzero(part == r)[0] for r in range(num)]


_ASSIGNERS = {
    "random": _assign_random,
    "contiguous": _assign_contiguous,
    "range": _assign_range,
    "hash": _assign_hash,
}


# ---- task bodies ---------------------------------------------------------


def _shuffle_map(src, ops: List[Any], assigner: str, num_reducers: int,
                 arg) -> Any:
    """Run the fused upstream chain on one source block and split it into
    ``num_reducers`` partitions, one per RETURN SLOT (``num_returns=R``,
    the reference's shuffle_map signature — shuffle_op.py): return-slot
    objects are held by the submitting driver, so partitions stay alive
    in the store until every reducer consumed them."""
    block = src()
    for op in ops:
        block = op.apply(block)
    acc = BlockAccessor(block)
    parts = _ASSIGNERS[assigner](block, num_reducers, arg)
    out = tuple(acc.take(idx) for idx in parts)
    return out if num_reducers > 1 else out[0]


def _shuffle_reduce(postprocess, *blocks) -> Any:
    """Assemble one reducer's output from its partitions (passed as
    top-level ref args: the runtime hands their values to the task)."""
    block = concat_blocks(list(blocks))
    if postprocess is not None:
        block = postprocess(block)
    return block


def _shuffle_merge(width: int, *round_parts) -> Any:
    """Push-based shuffle's MERGE stage (ref:
    data/_internal/push_based_shuffle.py): combine one round's map
    partials for a SLICE of ``width`` reducers into one merged block per
    reducer. ``round_parts`` arrives flattened as width-sized groups,
    one group per map task in the round."""
    merged = []
    for r in range(width):
        merged.append(concat_blocks(
            [round_parts[m * width + r]
             for m in range(len(round_parts) // width)]
        ))
    out = tuple(merged)
    return out if width > 1 else out[0]


def _sample_block(src, ops: List[Any], key: str,
                  max_samples: int) -> np.ndarray:
    block = src()
    for op in ops:
        block = op.apply(block)
    col = block[key]
    if len(col) > max_samples:
        sel = np.random.RandomState(0).choice(
            len(col), max_samples, replace=False
        )
        col = col[sel]
    return np.asarray(col)


class _SortBlock:
    def __init__(self, key: str, descending: bool):
        self.key = key
        self.descending = descending

    def __call__(self, block):
        acc = BlockAccessor(block)
        idx = np.argsort(block[self.key], kind="stable")
        if self.descending:
            idx = idx[::-1]
        return acc.take(idx)


# ---- driver-side orchestration ------------------------------------------


def shuffle(sources: Sequence[Any], ops: List[Any], num_reducers: int,
            assigner: str, arg=None, postprocess=None,
            push_based: Optional[bool] = None
            ) -> Tuple[List[Any], List[Any]]:
    """Distributed shuffle. Returns (reduce_refs, pin) — ``pin`` holds
    the intermediate refs and must stay referenced until the reduce
    outputs are consumed.

    Two execution plans (ref: simple_shuffle vs the reference's
    push_based_shuffle.py / Exoshuffle):

    - SIMPLE (small M): M map tasks x R return slots feed R reduce
      tasks directly; every reducer fans in M refs and all M x R
      partials stay live until the last reducer ran.
    - PUSH-BASED (default at M >= 16, or DataContext.push_based_shuffle
      / the ``push_based`` arg): maps run in rounds of ~sqrt(M); each
      round's partials MERGE immediately into per-reducer blocks (merge
      tasks sliced over the reducer range, pipelining with the next
      round's maps), so reducer fan-in drops from M to the round count
      and a round's M x R map partials can be collected as soon as its
      merges finish instead of living for the whole shuffle.
    """
    M = len(sources)
    if push_based is None:
        ctx_flag = DataContext.get_current().push_based_shuffle
        push_based = (M >= 16) if ctx_flag is None else ctx_flag

    map_task = _api.remote(_shuffle_map).options(num_returns=num_reducers)
    reduce_task = _api.remote(_shuffle_reduce)

    def run_maps(i, src):
        refs = map_task.remote(
            src, ops, assigner, num_reducers,
            (arg ^ i if assigner == "random" else arg),
        )
        return refs if isinstance(refs, list) else [refs]

    if not push_based or M < 2:
        part_lists = [run_maps(i, src) for i, src in enumerate(sources)]
        reduce_refs = [
            reduce_task.remote(postprocess, *[pl[r] for pl in part_lists])
            for r in range(num_reducers)
        ]
        return reduce_refs, part_lists

    R = num_reducers
    round_size = max(2, int(math.ceil(math.sqrt(M))))
    # Slice reducers among merge tasks so one merge's fan-in stays at
    # round_size x slice_width refs.
    slice_width = min(R, 8)
    slices = [(lo, min(lo + slice_width, R))
              for lo in range(0, R, slice_width)]
    # merged[round][r] = merged block ref for reducer r in that round.
    merged_rounds: List[List[Any]] = []
    pin: List[Any] = []
    for lo_m in range(0, M, round_size):
        if len(merged_rounds) >= 2:
            # THROTTLE: at most two rounds in flight (one merging while
            # the next maps — the pipeline overlap) before submitting
            # more, so peak live map partials stay ~2 rounds' worth
            # instead of all M x R.
            prev = merged_rounds[-2]
            _api.wait(prev, num_returns=len(prev), timeout=None)
        round_parts = [
            run_maps(i, sources[i])
            for i in range(lo_m, min(lo_m + round_size, M))
        ]
        round_merged: List[Any] = [None] * R
        for lo, hi in slices:
            width = hi - lo
            merge = _api.remote(_shuffle_merge).options(num_returns=width)
            flat = [pl[r] for pl in round_parts for r in range(lo, hi)]
            out = merge.remote(width, *flat)
            out = out if isinstance(out, list) else [out]
            for k, r in enumerate(range(lo, hi)):
                round_merged[r] = out[k]
        # The map partials are consumed by the merges; dropping our refs
        # here lets each round's M x R partials be freed as soon as its
        # merges finish (the merge tasks hold them until then).
        merged_rounds.append(round_merged)
        pin.extend(round_merged)
    reduce_refs = [
        reduce_task.remote(
            postprocess, *[rnd[r] for rnd in merged_rounds]
        )
        for r in range(R)
    ]
    return reduce_refs, pin


def sample_sort_boundaries(sources: Sequence[Any], ops: List[Any], key: str,
                           num: int, max_samples_per_block: int = 128
                           ) -> np.ndarray:
    """Stage 0 of distributed sort: sample each block's key column and cut
    the sampled distribution into ``num`` quantile ranges (ref:
    planner/exchange/sort_task_spec.py SortTaskSpec.sample_boundaries)."""
    sampler = _api.remote(_sample_block)
    samples = _api.get([
        sampler.remote(src, ops, key, max_samples_per_block)
        for src in sources
    ])
    allv = np.sort(np.concatenate([s for s in samples if len(s)]))
    if len(allv) == 0:
        return np.asarray([])
    cuts = [
        allv[int(len(allv) * (r + 1) / num) - 1] for r in range(num - 1)
    ]
    return np.asarray(cuts)
