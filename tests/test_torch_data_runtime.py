"""The port's Ray Data layer under the port's runtime against the JAX
package's under its own: the programs of ``tests/test_torch_data.py``
(remote block tasks, the actor pool, shuffles and sort, the push-based
shuffle, groupby's combiners, the split APIs, per-operator stats) run
through both runtimes, one of each for the module, and give the same rows
in the same order; the stats agree in stage names, blocks and rows (not
bytes: the blocks' formats differ). Then: ``streaming_split`` over a union
through the coordinator actor, consumed by two threads; the store-usage
policy bounding a slow consumer's producer; a lambda refused by name; an
actor's ``max_concurrency``; ``init(object_store_memory=)``'s count;
``BatchPredictor`` in a CPU actor pool against the JAX package's; and
``TorchTrainer(num_workers=2, use_gpu=False, datasets=)`` against
``JaxTrainer``: each rank reads the same rows.

The JAX package's workers get this module's and ``test_torch_data``'s
functions by value (``cloudpickle``); the port's workers import them by
name, so neither module imports anything heavy at the top.
"""

import functools
import json
import os
import sys
import threading
import time

import numpy as np
import pytest

import test_torch_data as progs

STORE_BYTES = 256 * 1024 * 1024
TEST_LIMIT_S = 150
_HUNG = []  # the test in which a runtime stopped answering


def bounded(test):
    """Run the test in a thread for at most TEST_LIMIT_S: a runtime that
    stops answering fails the test, and every later test of the module at
    once, instead of holding the session until its time limit."""

    @functools.wraps(test)
    def run(*args, **kwargs):
        if _HUNG:
            pytest.fail(f"a runtime stopped answering in {_HUNG[0]}")
        box = {}

        def body():
            try:
                test(*args, **kwargs)
            except BaseException as e:  # noqa: BLE001 — raised below
                box["error"] = e

        t = threading.Thread(target=body, daemon=True)
        t.start()
        t.join(TEST_LIMIT_S)
        if t.is_alive():
            _HUNG.append(test.__name__)
            pytest.fail(f"{test.__name__} did not finish in {TEST_LIMIT_S} s")
        if "error" in box:
            raise box["error"]

    return run


def _shutdown(pkg):
    t = threading.Thread(target=pkg.shutdown, daemon=True)
    t.start()
    t.join(60)


@pytest.fixture(scope="module")
def jax_rt():
    import cloudpickle

    import ray_tpu

    modules = [sys.modules[__name__], progs]
    for m in modules:
        cloudpickle.register_pickle_by_value(m)
    ray_tpu.init(num_cpus=4, object_store_memory=STORE_BYTES,
                 system_config={"num_prestart_workers": 2,
                                "refcount_flush_interval_s": 0.1,
                                "gc_grace_period_s": 0.5})
    yield ray_tpu
    _shutdown(ray_tpu)
    for m in modules:
        cloudpickle.unregister_pickle_by_value(m)


@pytest.fixture(scope="module")
def port_rt():
    import ray_tpu_torch

    ray_tpu_torch.init(num_cpus=4, num_gpus=0,
                       object_store_memory=STORE_BYTES)
    yield ray_tpu_torch
    _shutdown(ray_tpu_torch)


@pytest.fixture
def both(jax_rt, port_rt):
    return progs.packages()


def p_push_based_shuffle(rd):
    """tests/test_data.py:687: the push-based plan gives the simple
    plan's rows."""
    ctx = rd.DataContext.get_current()
    base = rd.from_items([{"k": i % 7, "v": float(i)} for i in range(120)],
                         override_num_blocks=12)
    out = {}
    old = ctx.push_based_shuffle
    try:
        for flag in (False, True):
            ctx.push_based_shuffle = flag
            out[flag] = (progs.rows(base.random_shuffle(seed=7)),
                         progs.rows(base.sort("v")),
                         progs.rows(base.repartition(5)))
        groups = progs.rows(base.groupby("k").map_groups(progs.group_sum))
    finally:
        ctx.push_based_shuffle = old
    assert out[True] == out[False]
    return out[True], groups


PROGRAMS = dict(progs.PROGRAMS, push_based_shuffle=p_push_based_shuffle)


@pytest.mark.parametrize("name", sorted(PROGRAMS))
@bounded
def test_runtime_program_matches_jax(name, both):
    out = {pkg: progs.plain(PROGRAMS[name](rd)) for pkg, rd in both.items()}
    assert out["port"] == out["jax"]


def consume_split(shards):
    """Each shard's ids, read by a thread of its own."""
    got = [[] for _ in shards]

    def consume(i):
        for row in shards[i].iter_rows():
            got[i].append(int(row["id"]))

    threads = [threading.Thread(target=consume, args=(i,))
               for i in range(len(shards))]
    for t in threads:
        t.start()
    for t in threads:
        t.join(timeout=120)
    assert not any(t.is_alive() for t in threads)
    return got


@bounded
def test_streaming_split_over_a_union_goes_through_the_coordinator(both):
    out = {}
    for pkg, rd in both.items():
        a = rd.range(8, override_num_blocks=4)
        b = rd.range(8, override_num_blocks=4).map(progs.plus_100)
        shards = a.union(b).streaming_split(2)
        assert shards[0]._coordinator is not None
        out[pkg] = consume_split(shards)
    assert out["port"] == out["jax"]
    assert out["port"][0] and out["port"][1]
    assert sorted(sum(out["port"], [])) == list(range(8)) + list(
        range(100, 108))


BLOCK_BYTES = 2 * 1024 * 1024


def gen_block(batch):
    return {"data": np.zeros(BLOCK_BYTES // 8, dtype=np.float64)}


def store_used(pkg):
    if pkg == "jax":
        from ray_tpu.core.runtime_context import current_runtime

        d = current_runtime()._nm.directory
        return d.used_bytes, d.capacity_bytes
    from ray_tpu_torch.core.runtime_context import current_runtime

    return current_runtime().store_usage()


def consume_slowly(pkg, rd, nblocks, fraction, window, hold=None):
    """Read ``nblocks`` blocks of BLOCK_BYTES one at a time, slowly, with
    the store-usage policy at ``fraction`` (0: off) and ``window`` tasks
    in flight at most; returns (blocks seen, the peak of the store's
    used bytes). With ``hold`` = (bytes, seconds) the consumer, holding
    its first block, waits until the store holds that many bytes or the
    seconds have passed, so what the executor submitted has landed."""
    ctx = rd.DataContext.get_current()
    old = ctx.store_usage_cap_fraction, ctx.max_in_flight_tasks
    ctx.store_usage_cap_fraction, ctx.max_in_flight_tasks = fraction, window
    try:
        ds = rd.range(nblocks, override_num_blocks=nblocks).map_batches(
            gen_block, batch_size=None)
        peak = seen = 0
        for ref in ds.iter_blocks_refs():
            if hold is not None and seen == 0:
                until = time.monotonic() + hold[1]
                while (store_used(pkg)[0] < hold[0]
                       and time.monotonic() < until):
                    time.sleep(0.01)
            peak = max(peak, store_used(pkg)[0])
            seen += 1
            time.sleep(0.02)  # slow consumer
            del ref
    finally:
        ctx.store_usage_cap_fraction, ctx.max_in_flight_tasks = old
    return seen, peak


@bounded
def test_store_backpressure_bounds_the_producer(both):
    """tests/test_data_dag.py:122. The JAX package is held to that test's
    bound: with the policy at a quarter of the capacity, a slow consumer's
    producer holds at most that plus the in-flight window. The port frees
    a block as soon as its last ref goes, so the concurrency cap alone
    keeps its producer within the window, and that bound cannot fail
    there. So the port's store is first filled past the policy's fraction
    by a ``put``, and the consumer holds its first block until 8 more are
    in the store (2 s at most with the policy on, 60 s with it off). The
    executor submits only while the consumer asks for a block: with the
    policy, one task at a time (at most 3 blocks above the fill); without
    it, the whole window of 16 (at least 8 blocks above the fill)."""
    nblocks, window = 40, 16
    seen, peak = consume_slowly("jax", both["jax"], nblocks, 0.25, window)
    _, cap = store_used("jax")
    assert cap > 0
    assert seen == nblocks
    assert peak <= cap * 0.25 + window * BLOCK_BYTES, (peak, cap)

    import ray_tpu_torch

    _, cap = store_used("port")
    assert cap == STORE_BYTES
    fraction = 0.05
    fill = ray_tpu_torch.put(
        np.zeros(int(cap * fraction) + BLOCK_BYTES, dtype=np.uint8))
    base, _ = store_used("port")
    assert base > cap * fraction
    ahead = base + 8 * BLOCK_BYTES
    try:
        seen_on, peak_on = consume_slowly("port", both["port"], nblocks,
                                          fraction, window, (ahead, 2.0))
        seen_off, peak_off = consume_slowly("port", both["port"], nblocks,
                                            0.0, window, (ahead, 60.0))
    finally:
        del fill
    assert seen_on == seen_off == nblocks
    assert peak_on - base <= 3 * BLOCK_BYTES, (peak_on, base)
    assert peak_off >= ahead, (peak_off, base)


@bounded
def test_a_lambda_is_refused_by_name_under_the_runtime(port_rt):
    from ray_tpu_torch import data as rd

    ds = rd.range(8).map_batches(lambda b: b)
    with pytest.raises(TypeError, match="<lambda> cannot run in a worker"):
        ds.take_all()
    local = rd.DataContext.get_current()
    local.use_remote_tasks = False
    try:  # without remote tasks nothing is pickled
        assert len(ds.take_all()) == 8
    finally:
        local.use_remote_tasks = True


def ship_a_lambda(kind):
    """Hand the runtime a value with a lambda inside it somewhere other
    than a map stage's ops."""
    import ray_tpu_torch
    from ray_tpu_torch import data as rd

    if kind == "split_coordinator":  # the Dataset pickled into the actor
        rd.range(8).map(lambda r: r).union(rd.range(8)).streaming_split(2)
    elif kind == "sort":  # the sort's sampling tasks
        rd.range(32).filter(lambda r: True).sort("id").take_all()
    elif kind == "task_argument":
        ray_tpu_torch.remote(progs.plain).remote({"f": lambda: 1})
    else:
        ray_tpu_torch.put([lambda: 1])


@pytest.mark.parametrize("kind", ["split_coordinator", "sort",
                                  "task_argument", "put"])
@bounded
def test_a_lambda_anywhere_in_a_shipped_value_is_refused_by_name(kind,
                                                                   port_rt):
    with pytest.raises(TypeError, match="<lambda> cannot run in a worker"):
        ship_a_lambda(kind)


class Rendezvous:
    """Each call waits for the other: only concurrent calls return."""

    def __init__(self):
        self.barrier = threading.Barrier(2, timeout=20)

    def meet(self, i):
        self.barrier.wait()
        return i


@bounded
def test_max_concurrency_runs_blocking_calls_at_once(both):
    for pkg in ("jax", "port"):
        r = sys.modules["ray_tpu" if pkg == "jax" else "ray_tpu_torch"]
        actor = r.remote(max_concurrency=2)(Rendezvous).remote()
        refs = [actor.meet.remote(i) for i in range(2)]
        assert r.get(refs, timeout=60) == [0, 1], pkg
        r.kill(actor)


def slow_value(x, seconds):
    time.sleep(seconds)
    return x


def add_one(x):
    return x + 1


class Echo:
    def echo(self, x):
        return x


@bounded
def test_calls_and_tasks_wait_for_arguments_that_land_later(both):
    """An actor-pool stage's shape: a call to a live actor whose argument
    is a task still running, and a task whose argument is that call's
    result. Each runs once its argument lands."""
    for pkg in ("jax", "port"):
        r = sys.modules["ray_tpu" if pkg == "jax" else "ray_tpu_torch"]
        actor = r.remote(Echo).remote()
        assert r.get(actor.echo.remote(0), timeout=60) == 0
        call = actor.echo.remote(r.remote(slow_value).remote(41, 0.5))
        assert r.get(r.remote(add_one).remote(call), timeout=60) == 42, pkg
        r.kill(actor)


@bounded
def test_object_store_memory_counts_the_objects_held(port_rt):
    """The driver counts the objects it holds against the capacity, and
    frees them with their last ref."""
    used0, cap = store_used("port")
    ref = port_rt.put(np.zeros(1 << 20, dtype=np.uint8))
    used1, _ = store_used("port")
    del ref
    used2, _ = store_used("port")
    assert cap == STORE_BYTES
    assert used1 - used0 >= 1 << 20
    assert used2 == used0


@bounded
def test_batch_predictor_in_a_cpu_actor_matches_jax(port_rt, tmp_path):
    """The pool member restores the port's checkpoint and scores; JAX's
    scores come from the same weights in this process (its own
    checkpoint round trip is test_torch_data.py's)."""
    from ray_tpu_torch import data as rd
    from ray_tpu_torch.train import BatchPredictor, TorchPredictor

    want = np.asarray(progs.jax_score(progs.tiny_weights(),
                                      progs.tiny_tokens()))
    ds = rd.from_numpy(progs.tiny_tokens(), column="x",
                       override_num_blocks=3)
    scored = BatchPredictor(progs.port_tiny_checkpoint(tmp_path),
                            TorchPredictor, apply_fn=progs.port_score,
                            device="cpu").predict(ds, concurrency=1,
                                                  batch_size=4)
    assert scored._stages[-1].ray_remote_args == {}  # no card asked
    progs.check_predictions(scored.to_numpy(), want)
    assert "ActorStage(_PredictorWorker x1)" in scored.stats()


def jax_shard_loop(config):
    from ray_tpu import train

    _write_shard(config, train.get_world_rank(),
                 train.get_dataset_shard("train"))
    train.report({"rank": train.get_world_rank()})


def port_shard_loop(config):
    from ray_tpu_torch import train

    _write_shard(config, train.get_world_rank(),
                 train.get_dataset_shard("train"))
    train.report({"rank": train.get_world_rank()})


def _write_shard(config, rank, shard):
    ids = [int(x) for b in shard.iter_batches(batch_size=10)
           for x in b["id"]]
    with open(os.path.join(config["out"], f"rank{rank}.json"), "w") as f:
        json.dump(ids, f)


@bounded
def test_trainer_ranks_read_the_jax_trainers_rows(both, tmp_path):
    """tests/test_data.py:136 through both trainers: a dataset passed in
    ``datasets=`` reaches each rank as its streaming_split shard."""
    from concurrent.futures import ThreadPoolExecutor

    def run(pkg):
        rd = both[pkg]
        out = tmp_path / f"{pkg}-shards"
        out.mkdir()
        if pkg == "jax":
            from ray_tpu.train import (JaxTrainer as Trainer, RunConfig,
                                       ScalingConfig)
            scaling, loop = ScalingConfig(num_workers=2), jax_shard_loop
        else:
            from ray_tpu_torch.train import (RunConfig, ScalingConfig,
                                             TorchTrainer as Trainer)
            scaling = ScalingConfig(num_workers=2, use_gpu=False)
            loop = port_shard_loop
        result = Trainer(
            loop, train_loop_config={"out": str(out)},
            scaling_config=scaling,
            run_config=RunConfig(storage_path=str(tmp_path / pkg)),
            datasets={"train": rd.range(40, override_num_blocks=8)
                      .map_batches(progs.keep_id_batch)},
        ).fit()
        assert result.error is None, result.error
        return [json.loads((out / f"rank{r}.json").read_text())
                for r in range(2)]

    with ThreadPoolExecutor(2) as pool:
        jax_out = pool.submit(run, "jax")
        port_out = run("port")
        jax_out = jax_out.result()
    assert port_out == jax_out
    assert sorted(port_out[0] + port_out[1]) == list(range(40))
    assert len(port_out[0]) == len(port_out[1]) == 20
