"""The port's single-node runtime (``ray_tpu_torch.core``) against the JAX
package's (``ray_tpu.core``): the same driver programs run through both,
one runtime of each package for the module (``num_cpus=4``), and the
results compare equal. The programs are those of
``tests/test_core_basic.py``, ``test_core_actors.py`` and
``test_spmd.py:183-232``: tasks with ref arguments, chains and multiple
returns; error propagation; ``wait`` and ``get``'s timeout; actor call
order, ``kill`` (with and without restart) and ``ActorDiedError``;
resource accounting; placement groups; the KV from the driver and from a
worker; ``SpmdActorGroup``.

The GPU path is held without a card: under ``init(num_gpus=1)`` a GPU task
sees the driver's card index in ``CUDA_VISIBLE_DEVICES`` and a CPU task
sees ``""``; a second GPU task waits for the first; under
``init(num_gpus=0)`` a GPU request fails as a JAX ``"TPU"`` request does
on a node without one; ``init`` refuses more cards than the driver's
``CUDA_VISIBLE_DEVICES`` lists, and GPUs are whole cards. Port-only
cases: refs passed through workers are freed, and the worker cap stops
an idle worker or makes the task wait. After ``shutdown()`` no worker
process is alive.

The programs are module-level functions and classes. The port's workers
import this module by name (the runtime pickles by reference and passes
the driver's ``sys.path`` on), so it imports nothing heavy at the top; the
JAX package's workers get them by value (``cloudpickle``).
"""

import importlib
import os
import sys
import time

import pytest

DRIVER_CARD = "3"  # the driver's CUDA_VISIBLE_DEVICES for the GPU tests


def add(x, y):
    return x + y


def three(x):
    return x, 2 * x, 3 * x


def raise_value(msg):
    raise ValueError(msg)


def sleep_for(seconds):
    time.sleep(seconds)
    return seconds


def visible_cards():
    return os.environ.get("CUDA_VISIBLE_DEVICES")


def hold_card(seconds):
    time.sleep(seconds)
    return os.environ.get("CUDA_VISIBLE_DEVICES")


def kv_from_worker(pkg, key):
    rt = importlib.import_module(
        pkg + ".core.runtime_context").current_runtime()
    first = rt.kv_put(key, b"worker", overwrite=False)
    again = rt.kv_put(key, b"again", overwrite=False)
    return first, again, rt.kv_get(key), sorted(rt.kv_keys(key[:3]))


def worker_pid():
    return os.getpid()


def nested(pkg, x):
    """A task that submits tasks, puts and gets from inside its worker."""
    r = importlib.import_module(pkg)
    f = r.remote(add)
    inner = f.remote(x, f.remote(1, 1))
    box = r.put({"x": x})
    (boxed,) = r.get(f.remote([box], []))  # a ref inside a value
    return r.get(inner), r.get(boxed), r.get(f.remote(x, x))


def die(code):
    os._exit(code)


def refs_in_result(pkg, i):
    """A worker's put and a worker's task, their refs returned inside the
    result."""
    r = importlib.import_module(pkg)
    return [r.put(i), r.remote(add).remote(i, 1)]


def read_and_return(pkg, box):
    """Reads the ref inside ``box`` and returns it inside the result."""
    r = importlib.import_module(pkg)
    return r.get(box[0]), [box[0]]


class Counter:
    def __init__(self, start=0):
        self.n = start
        self.seen = []

    def inc(self, k=1):
        self.n += k
        self.seen.append(k)
        return self.n

    def history(self):
        return list(self.seen)


class Holder:
    """Keeps a ref it was handed across calls."""

    def __init__(self, pkg):
        self.r = importlib.import_module(pkg)
        self.box = None

    def keep(self, box):
        self.box = box
        return True

    def read(self):
        return self.r.get(self.box[0])


def produce(n, delay, fail_at=-1):
    """Yields (i, the time it was made) n times, raising at ``fail_at``."""
    for i in range(n):
        if i == fail_at:
            raise ValueError(f"producer failed at {i}")
        time.sleep(delay)
        yield i, time.time()


def ambient_deadline(pkg):
    return importlib.import_module(
        pkg + ".util.overload").ambient_deadline()


class Streamer:
    def __init__(self):
        self.active = 0
        self.peak = 0

    def items(self, n, delay):
        self.active += 1
        self.peak = max(self.peak, self.active)
        try:
            for i in range(n):
                time.sleep(delay)
                yield {"i": i}
        finally:
            self.active -= 1

    def peak_active(self):
        return self.peak


class RankProbe:
    def __init__(self, rank):
        self.rank = rank

    def whoami(self):
        return {"rank": self.rank}

    def echo(self, x):
        return x


def _poll(fn, want, timeout=10.0):
    deadline = time.time() + timeout
    got = fn()
    while got != want and time.time() < deadline:
        time.sleep(0.05)
        got = fn()
    return got


def _alive(pids):
    out = []
    for pid in pids:
        try:
            with open(f"/proc/{pid}/stat") as f:
                if f.read().rsplit(")", 1)[1].split()[0] != "Z":
                    out.append(pid)
        except OSError:
            pass
    return out


@pytest.fixture(scope="module")
def jax_rt():
    import cloudpickle

    import ray_tpu

    module = sys.modules[__name__]
    cloudpickle.register_pickle_by_value(module)
    ray_tpu.init(num_cpus=4, system_config={
        "num_prestart_workers": 2, "refcount_flush_interval_s": 0.1,
        "gc_grace_period_s": 1.0})
    yield ray_tpu
    ray_tpu.shutdown()
    cloudpickle.unregister_pickle_by_value(module)


@pytest.fixture(scope="module")
def port_rt():
    import ray_tpu_torch

    old = os.environ.get("CUDA_VISIBLE_DEVICES")
    os.environ["CUDA_VISIBLE_DEVICES"] = DRIVER_CARD
    try:
        ray_tpu_torch.init(num_cpus=4, num_gpus=1)
    finally:
        if old is None:
            del os.environ["CUDA_VISIBLE_DEVICES"]
        else:
            os.environ["CUDA_VISIBLE_DEVICES"] = old
    yield ray_tpu_torch
    ray_tpu_torch.shutdown()


@pytest.fixture
def both(jax_rt, port_rt):
    return {"jax": jax_rt, "port": port_rt}


def _each(both, program):
    return {name: program(pkg) for name, pkg in both.items()}


def test_tasks_with_ref_args_chains_and_multiple_returns(both):
    def program(r):
        f = r.remote(add)
        x = f.remote(1, 2)
        y = f.remote(x, 10)
        z = f.remote(y, f.remote(x, x))
        parts = r.remote(three).options(num_returns=3).remote(y)
        put = r.put([1, 2, 3])
        return (r.get(z), r.get(parts), r.get(f.remote(put, [4])),
                r.get([x, y]))

    out = _each(both, program)
    assert out["port"] == out["jax"] == (19, [13, 26, 39], [1, 2, 3, 4],
                                         [3, 13])


def test_nested_tasks_from_a_worker(both):
    def program(r):
        return r.get([r.remote(nested).remote(r.__name__, x)
                      for x in (3, 5)])

    out = _each(both, program)
    assert out["port"] == out["jax"] == [(5, {"x": 3}, 6), (7, {"x": 5},
                                                             10)]


def test_errors_propagate_with_class_and_message(both):
    def program(r):
        bad = r.remote(raise_value).remote("the task exploded")
        seen = []
        for ref in (bad, r.remote(add).remote(bad, 1)):
            with pytest.raises(Exception) as e:
                r.get(ref)
            seen.append((type(e.value).__name__, str(e.value),
                         type(e.value.__cause__).__name__))
        return seen

    out = _each(both, program)
    assert out["port"] == out["jax"]
    assert out["port"][0][:2] == ("ValueError", "the task exploded")


def test_wait_splits_ready_from_pending_and_get_times_out(both):
    def program(r):
        s = r.remote(sleep_for)
        fast, slow = s.remote(0.0), s.remote(1.5)
        ready, pending = r.wait([slow, fast], num_returns=1, timeout=10)
        both_ready = r.wait([slow, fast], num_returns=2, timeout=0.2)
        with pytest.raises(Exception) as e:
            r.get(slow, timeout=0.1)
        late = r.get(slow, timeout=30)
        return (ready == [fast], pending == [slow],
                [len(x) for x in both_ready], type(e.value).__name__, late)

    out = _each(both, program)
    assert out["port"] == out["jax"] == (True, True, [1, 1],
                                         "GetTimeoutError", 1.5)


def test_actor_calls_in_order_then_kill_and_actor_died(both):
    def program(r):
        c = r.remote(Counter).remote(100)
        refs = [c.inc.remote(k) for k in range(10)]
        values = r.get(refs)
        history = r.get(c.history.remote())
        r.kill(c)
        with pytest.raises(Exception) as e:
            r.get(c.inc.remote(), timeout=30)
        return values, history, type(e.value).__name__

    out = _each(both, program)
    assert out["port"] == out["jax"]
    assert out["port"][0][-1] == 145 and out["port"][2] == "ActorDiedError"


def test_kill_with_restart_brings_the_actor_back(both):
    def program(r):
        c = r.remote(Counter).options(max_restarts=1).remote(10)
        first = r.get(c.inc.remote())
        r.kill(c, no_restart=False)
        deadline = time.time() + 60
        while True:  # a call made while the actor restarts may fail
            try:
                again = r.get(c.inc.remote(), timeout=30)
                break
            except Exception:
                if time.time() > deadline:
                    raise
                time.sleep(0.1)
        r.kill(c)
        with pytest.raises(Exception) as e:
            r.get(c.inc.remote(), timeout=30)
        return first, again, type(e.value).__name__

    out = _each(both, program)
    assert out["port"] == out["jax"] == (11, 11, "ActorDiedError")


def test_resources_while_an_actor_holds_a_cpu(both):
    def program(r):
        def cpus():
            return r.available_resources().get("CPU", 0.0)

        before = _poll(cpus, 4.0)
        a = r.remote(Counter).options(num_cpus=1).remote()
        r.get(a.inc.remote())
        held = _poll(cpus, 3.0)
        r.kill(a)
        back = _poll(cpus, 4.0)
        return before, held, back, r.cluster_resources()["CPU"]

    out = _each(both, program)
    assert out["port"] == out["jax"] == (4.0, 3.0, 4.0, 4.0)


def test_placement_group_bundles_and_strategy(both):
    def program(r):
        pgm = importlib.import_module(r.__name__ + ".core.placement_group")
        pg = pgm.placement_group([{"CPU": 1}, {"CPU": 2}], strategy="PACK")
        ok = pg.wait(30)
        held = _poll(lambda: r.available_resources().get("CPU", 0.0), 1.0)
        strategy = pgm.PlacementGroupSchedulingStrategy(
            pg, placement_group_bundle_index=1)
        res = r.get(r.remote(add).options(
            scheduling_strategy=strategy, num_cpus=2).remote(20, 22))
        big = pgm.placement_group([{"CPU": 64}])
        never = big.wait(0.5)
        pgm.remove_placement_group(big)
        pgm.remove_placement_group(pg)
        back = _poll(lambda: r.available_resources().get("CPU", 0.0), 4.0)
        return (ok, pg.bundle_count, pg.bundle_specs, held, res, never,
                back)

    out = _each(both, program)
    assert out["port"] == out["jax"] == (
        True, 2, [{"CPU": 1}, {"CPU": 2}], 1.0, 42, False, 4.0)


def test_kv_from_the_driver_and_from_a_worker(both):
    def program(r):
        rt = importlib.import_module(
            r.__name__ + ".core.runtime_context").current_runtime()
        driver = (r.kv_put("kv/a", b"1"), r.kv_put("kv/a", b"2",
                                                   overwrite=False),
                  r.kv_get("kv/a"), r.kv_put("kv/a", b"3"), r.kv_get("kv/a"))
        worker = r.get(r.remote(kv_from_worker).remote(r.__name__, "kv/w"))
        seen = (r.kv_get("kv/w"), sorted(rt.kv_keys("kv/")),
                rt.kv_del("kv/a"), rt.kv_get("kv/a"), rt.kv_del("kv/a"))
        return driver, worker, seen

    out = _each(both, program)
    assert out["port"] == out["jax"]
    assert out["port"][1] == (True, False, b"worker", ["kv/a", "kv/w"])


def _spmd(r):
    return importlib.import_module(r.__name__ + ".core.spmd")


def test_spmd_group_gang_and_lockstep(both):
    def program(r):
        spmd = _spmd(r)
        group = spmd.SpmdActorGroup(
            RankProbe, num_workers=2, resources_per_worker={"CPU": 1},
            per_worker_args=lambda rank: ((rank,), {}))
        group.wait_ready(timeout=60)
        out = (group.healthy(), sorted(o["rank"] for o in
                                       group.run("whoami", timeout=30)),
               group.run("echo", 42, timeout=30), len(group))
        group.shutdown()
        return out + (group.broken,)

    out = _each(both, program)
    assert out["port"] == out["jax"] == (True, [0, 1], [42, 42], 2, True)


def test_spmd_group_infeasible_gang_fails_fast(both):
    def program(r):
        spmd = _spmd(r)
        with pytest.raises(spmd.SpmdGroupError) as e:
            spmd.SpmdActorGroup(RankProbe, num_workers=2,
                                resources_per_worker={"CPU": 64},
                                ready_timeout=1.0)
        return type(e.value).__name__, "not satisfiable" in str(e.value)

    out = _each(both, program)
    assert out["port"] == out["jax"] == ("SpmdGroupError", True)


def test_spmd_group_member_death_breaks_and_restarts(both):
    def program(r):
        spmd = _spmd(r)
        group = spmd.SpmdActorGroup(
            RankProbe, num_workers=2, resources_per_worker={"CPU": 1},
            per_worker_args=lambda rank: ((rank,), {}))
        group.wait_ready(timeout=60)
        r.kill(group.actors[1])
        with pytest.raises(spmd.SpmdGroupError):
            group.run("whoami", timeout=30)
        broken = group.broken
        with pytest.raises(spmd.SpmdGroupError):
            group.submit("whoami")
        group.restart()
        ranks = sorted(o["rank"] for o in group.run("whoami", timeout=30))
        group.shutdown()
        return broken, ranks

    out = _each(both, program)
    assert out["port"] == out["jax"] == (True, [0, 1])


def test_concurrent_submitters_lose_no_result_or_resource(port_rt):
    """8 driver threads (more than this box's cores) submit chains of
    tasks and actor calls at once under a short switch interval: every
    result is right, every CPU comes back, and the driver's object table
    holds nothing the dropped refs pinned."""
    import threading

    from ray_tpu_torch.core.runtime_context import current_runtime

    r = port_rt
    f = r.remote(add)
    counter = r.remote(Counter).remote()
    errors, results = [], []

    def submitter(i):
        try:
            for j in range(25):
                ref = f.remote(f.remote(i, j), 1)
                counter.inc.remote(1)
                results.append((i, j, r.get(ref, timeout=60)))
        except Exception as e:  # noqa: BLE001 — reported below
            errors.append(e)

    old = sys.getswitchinterval()
    sys.setswitchinterval(1e-5)
    try:
        threads = [threading.Thread(target=submitter, args=(i,))
                   for i in range(8)]
        for t in threads:
            t.start()
        for t in threads:
            t.join(timeout=120)
    finally:
        sys.setswitchinterval(old)
    assert not any(t.is_alive() for t in threads)
    assert errors == []
    assert sorted(results) == sorted((i, j, i + j + 1) for i in range(8)
                                     for j in range(25))
    assert r.get(counter.inc.remote(0), timeout=60) == 200
    r.kill(counter)
    assert _poll(lambda: r.available_resources()["CPU"], 4.0) == 4.0
    rt = current_runtime()
    with rt._lock:
        unpinned = [o for o, obj in rt._objects.items() if not obj.pinned]
    assert unpinned == []


def test_streaming_returns_match_jax(both):
    """num_returns="streaming" on a task and an actor method: the items in
    order, then the completion's count; a producer's error after the items
    yielded before it."""
    def program(r):
        gen = r.remote(produce).options(num_returns="streaming").remote(
            4, 0.01)
        items = [r.get(ref)[0] for ref in gen]
        failing = r.remote(produce).options(num_returns="streaming").remote(
            5, 0.01, 2)
        got = []
        with pytest.raises(ValueError, match="producer failed at 2"):
            for ref in failing:
                got.append(r.get(ref)[0])
        a = r.remote(Streamer).options(max_concurrency=2).remote()
        agen = a.items.options(num_returns="streaming").remote(3, 0.0)
        return items, r.get(gen.completed), got, [r.get(x) for x in agen]

    got = _each(both, program)
    assert got["jax"] == got["port"] == (
        [0, 1, 2, 3], 4, [0, 1], [{"i": 0}, {"i": 1}, {"i": 2}])


def test_stream_items_arrive_while_the_producer_runs(port_rt):
    """The first item is read before the producer makes its second, a
    0.5 s gap later: items do not wait for the call to end."""
    r = port_rt
    gen = r.remote(produce).options(num_returns="streaming").remote(4, 0.5)
    read, made = [], []
    for ref in gen:
        made.append(r.get(ref)[1])
        read.append(time.time())
    assert len(read) == 4 and read[0] < made[1], (read, made)


def test_dropped_stream_frees_its_items(port_rt):
    """A consumer that takes one item and drops the generator leaves no
    item behind in the driver, taken or not, produced before or after the
    drop."""
    import gc

    from ray_tpu_torch.core.runtime_context import current_runtime

    r, rt = port_rt, current_runtime()
    with rt._lock:
        before = len(rt._objects)
    gen = r.remote(produce).options(num_returns="streaming").remote(8, 0.05)
    first = next(gen)
    assert r.get(first)[0] == 0
    time.sleep(0.15)  # a few more made, never taken
    del gen, first
    gc.collect()
    time.sleep(0.6)  # the rest are made after the drop
    with rt._lock:
        assert rt._streams == {}
        after = len(rt._objects)
    assert _poll(lambda: len(rt._objects), before) == before, (before, after)


def test_streams_run_at_once_on_a_concurrent_actor(port_rt):
    """Two streaming calls on an actor with max_concurrency=2 produce at
    the same time, each consumer reading its own items in order."""
    r = port_rt
    a = r.remote(Streamer).options(max_concurrency=2).remote()
    gens = [a.items.options(num_returns="streaming").remote(5, 0.1)
            for _ in range(2)]
    outs = [[r.get(ref)["i"] for ref in g] for g in gens]
    assert outs == [list(range(5))] * 2
    assert r.get(a.peak_active.remote()) == 2  # not one after the other
    r.kill(a)


def test_deadline_is_carried_into_tasks_and_refuses_expired_ones(both):
    """A task submitted under an expired ambient deadline never runs
    (DeadlineExceededError); a live one is installed in the task
    (tests/test_overload.py's deadline propagation)."""
    def program(r):
        ov = importlib.import_module(r.__name__ + ".util.overload")
        f = r.remote(ambient_deadline)
        with ov.deadline_scope(time.time() - 0.5):
            expired = f.remote(r.__name__)
        with pytest.raises(TimeoutError) as ei:
            r.get(expired, timeout=30)
        dl = time.time() + 30.0
        with ov.deadline_scope(dl):
            seen = r.get(f.remote(r.__name__), timeout=30)
        return type(ei.value).__name__, abs(seen - dl) < 1e-6, \
            r.get(f.remote(r.__name__))

    got = _each(both, program)
    assert got["jax"] == got["port"] == ("DeadlineExceededError", True, 0.0)


def test_refs_that_pass_through_workers_are_freed(port_rt):
    """Refs nested in arguments and results, a worker's puts and the
    results of a worker's tasks are counted, not pinned: after 30 rounds
    and the driver's refs dropped, the driver's object table is back where
    it started. A ref an actor keeps holds its object until the actor
    dies."""
    import gc

    from ray_tpu_torch.core.runtime_context import current_runtime

    r = port_rt
    rt = current_runtime()
    gc.collect()
    base = _poll(lambda: len(rt._objects), 0)
    for i in range(30):
        made = r.get(r.remote(refs_in_result).remote(r.__name__, i))
        assert r.get(made) == [i, i + 1]
        value, (back,) = r.get(r.remote(read_and_return).remote(
            r.__name__, [r.put(i)]))
        assert value == r.get(back) == i
    del made, back
    gc.collect()
    assert _poll(lambda: len(rt._objects), base) == base

    holder = r.remote(Holder).remote(r.__name__)
    assert r.get(holder.keep.remote([r.put(42)]))
    gc.collect()
    time.sleep(0.5)
    assert r.get(holder.read.remote()) == 42
    assert len(rt._objects) > base
    r.kill(holder)
    gc.collect()
    assert _poll(lambda: len(rt._objects), base) == base


def test_worker_death_fails_the_task_and_frees_its_cpu(port_rt):
    """A task whose worker dies (os._exit) fails with WorkerCrashedError
    once its retries are spent, and its CPU comes back."""
    r = port_rt
    with pytest.raises(r.WorkerCrashedError) as e:
        r.get(r.remote(die).options(max_retries=1).remote(1))
    assert "exited with code 1" in str(e.value)
    assert _poll(lambda: r.available_resources()["CPU"], 4.0) == 4.0


def test_gpu_tasks_see_the_drivers_card_and_queue_for_it(port_rt):
    r = port_rt
    assert r.cluster_resources() == {"CPU": 4.0, "GPU": 1.0}
    cards = r.remote(visible_cards)
    assert r.get(cards.options(num_gpus=1).remote()) == DRIVER_CARD
    assert r.get(cards.remote()) == ""
    holder = r.remote(hold_card).options(num_gpus=1).remote(1.0)
    second = cards.options(num_gpus=1).remote()
    ready, _ = r.wait([second], timeout=0.5)
    assert ready == []
    assert r.get(holder) == DRIVER_CARD
    assert r.get(second, timeout=30) == DRIVER_CARD
    actor = r.remote(Counter).options(num_gpus=1).remote()
    r.get(actor.inc.remote())
    assert r.available_resources().get("GPU", 0.0) == 0.0
    r.kill(actor)
    assert _poll(lambda: r.available_resources().get("GPU"), 1.0) == 1.0


def test_gpu_requests_are_whole_cards(port_rt):
    r = port_rt
    pgm = importlib.import_module("ray_tpu_torch.core.placement_group")
    with pytest.raises(ValueError, match="whole number of cards"):
        r.remote(visible_cards).options(num_gpus=0.5).remote()
    with pytest.raises(ValueError, match="whole number of cards"):
        r.remote(Counter).options(resources={"GPU": 1.5}).remote()
    with pytest.raises(ValueError, match="whole number of cards"):
        pgm.placement_group([{"CPU": 1, "GPU": 0.25}])


def test_functions_a_worker_cannot_import_are_refused(port_rt):
    r = port_rt
    with pytest.raises(TypeError, match="module level"):
        r.remote(lambda: 1).remote()

    def local():
        return 1

    with pytest.raises(TypeError, match="module level"):
        r.remote(local).remote()


def test_shutdown_leaves_no_worker_and_gpu_request_fails_without_gpus(
        jax_rt, port_rt):
    """Runs last: after shutdown() no worker pid of the module's runtime
    is alive; under init(num_gpus=0) a GPU task fails as JAX's TPU task
    does on a node without a TPU (the same exception class, an infeasible
    request), and that runtime's workers end with it too."""
    from ray_tpu_torch.core.runtime_context import current_runtime

    pids = port_rt.get(
        [port_rt.remote(worker_pid).remote() for _ in range(4)])
    pids = sorted(set(pids) | set(current_runtime().worker_pids()))
    port_rt.shutdown()
    assert _alive(pids) == []

    port_rt.init(num_cpus=2, num_gpus=0)
    try:
        assert "GPU" not in port_rt.cluster_resources()
        with pytest.raises(Exception) as got:
            port_rt.get(port_rt.remote(visible_cards).options(
                num_gpus=1).remote(), timeout=30)
        pids = current_runtime().worker_pids()
    finally:
        port_rt.shutdown()
    assert _alive(pids) == []
    with pytest.raises(Exception) as want:
        jax_rt.get(jax_rt.remote(visible_cards).options(
            num_tpus=1).remote(), timeout=30)
    assert type(got.value).__name__ == type(want.value).__name__ == \
        "TaskError"
    assert "infeasible" in str(got.value) and "infeasible" in str(want.value)


def test_init_gives_workers_only_the_drivers_cards(monkeypatch):
    """With CUDA_VISIBLE_DEVICES set, init cannot make more cards than it
    lists; unset, the node's cards are 0..n-1."""
    import ray_tpu_torch

    monkeypatch.setenv("CUDA_VISIBLE_DEVICES", DRIVER_CARD)
    with pytest.raises(ValueError, match="more cards than the driver"):
        ray_tpu_torch.init(num_cpus=1, num_gpus=2)
    assert not ray_tpu_torch.is_initialized()
    monkeypatch.delenv("CUDA_VISIBLE_DEVICES")
    ray_tpu_torch.init(num_cpus=1, num_gpus=2,
                       system_config={"num_prestart_workers": 0})
    try:
        cards = ray_tpu_torch.remote(visible_cards)
        assert ray_tpu_torch.get([cards.options(num_gpus=2).remote(),
                                  cards.options(num_gpus=1).remote()]) == \
            ["0,1", "0"]
    finally:
        ray_tpu_torch.shutdown()


def test_worker_cap_stops_idle_workers_or_waits(monkeypatch):
    """At the worker cap an idle worker of another type is stopped to make
    room; with none idle the task waits until a worker is free."""
    import ray_tpu_torch
    from ray_tpu_torch.core import runtime
    from ray_tpu_torch.core.runtime_context import current_runtime

    r = ray_tpu_torch
    monkeypatch.setattr(runtime, "MAX_WORKERS", 2)
    monkeypatch.delenv("CUDA_VISIBLE_DEVICES", raising=False)
    r.init(num_cpus=2, num_gpus=1, system_config={"num_prestart_workers": 0})
    try:
        rt = current_runtime()
        cards = r.remote(visible_cards)
        first = r.remote(Counter).remote()
        assert r.get(first.inc.remote()) == 1
        assert r.get(cards.remote()) == ""
        cpu_worker = rt.worker_pids()
        assert r.get(cards.options(num_gpus=1).remote()) == "0"
        assert len(rt.worker_pids()) == 2
        second = r.remote(Counter).remote()
        assert r.get(second.inc.remote()) == 1
        assert len(rt.worker_pids()) == 2
        waiting = cards.remote()
        assert r.wait([waiting], timeout=1.0)[0] == []
        r.kill(second)
        assert r.get(waiting, timeout=30) == ""
        assert len(rt.worker_pids()) <= 2
        pids = rt.worker_pids()
    finally:
        r.shutdown()
    assert _alive(cpu_worker + pids) == []
