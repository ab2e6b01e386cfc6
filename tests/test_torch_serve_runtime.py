"""The port's serve control plane under the port's runtime against the JAX
package's under its own, one runtime of each for the module: each program
runs through both (at once, in two threads) and gives the same responses,
errors, statuses and describe output. The programs mirror
``tests/test_serve.py:18-312`` and ``tests/test_serve_graph.py:15-63``:
function and class deployments, several replicas that all serve, scale
up and down, ``@serve.batch``, HTTP JSON and a raising deployment's
status, error propagation, a rolling redeploy with no failed request,
replica crash recovery, multiplexing, the nested-bind graph and its cycle
check, describe and delete.

The deployments are module-level classes and functions of this module:
the port's workers import them by name (so this module imports nothing
heavy at the top), the JAX package's get them by value (``cloudpickle``).
``tests/test_torch_serve_stream.py`` imports this module for its
fixtures and helpers.
"""

import functools
import json
import os
import signal
import sys
import threading
import time
import urllib.error
import urllib.request
from importlib import import_module
from types import SimpleNamespace

import pytest

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


def _namespace(pkg):
    return SimpleNamespace(
        name=pkg, rt=import_module(pkg), serve=import_module(pkg + ".serve"),
        handle=import_module(pkg + ".serve.handle"),
        http=import_module(pkg + ".serve.http_proxy"),
        config=import_module(pkg + ".core.config"),
        overload=import_module(pkg + ".util.overload"),
        exc=import_module(pkg + ".core.exceptions"))


def jax_fixture(modules):
    import cloudpickle

    import ray_tpu

    for m in modules:
        cloudpickle.register_pickle_by_value(m)
    ray_tpu.init(num_cpus=4, system_config={
        "num_prestart_workers": 2, "refcount_flush_interval_s": 0.1,
        "gc_grace_period_s": 0.5})
    yield _namespace("ray_tpu")
    _shutdown(ray_tpu)
    for m in modules:
        cloudpickle.unregister_pickle_by_value(m)


def port_fixture():
    import ray_tpu_torch

    ray_tpu_torch.init(num_cpus=4, num_gpus=0)
    yield _namespace("ray_tpu_torch")
    _shutdown(ray_tpu_torch)


@pytest.fixture(scope="module")
def jax_rt():
    yield from jax_fixture([sys.modules[__name__]])


@pytest.fixture(scope="module")
def port_rt():
    yield from port_fixture()


@pytest.fixture
def both(jax_rt, port_rt):
    return {"jax": jax_rt, "port": port_rt}


def _wait_controller_gone(ns, timeout=30.0):
    """Serve's shutdown kills the controller; the JAX runtime frees its
    name asynchronously, and the next program must not find it."""
    deadline = time.monotonic() + timeout
    while time.monotonic() < deadline:
        try:
            ns.rt.get_actor("__serve_controller__")
        except ValueError:
            return
        time.sleep(0.05)
    raise AssertionError(f"{ns.name}: the serve controller outlived "
                         "serve.shutdown()")


def each(both, program):
    """Run ``program(ns)`` for both packages at once, each in a thread of
    its own that shuts its serve down after; returns {name: result} or
    raises the first failure."""
    out, errors = {}, {}

    def one(name, ns):
        try:
            out[name] = program(ns)
        except BaseException as e:  # noqa: BLE001 — raised below
            errors[name] = e
        finally:
            ns.serve.shutdown()
            _wait_controller_gone(ns)

    threads = [threading.Thread(target=one, args=item, daemon=True)
               for item in both.items()]
    for t in threads:
        t.start()
    for t in threads:
        t.join(TEST_LIMIT_S)
        assert not t.is_alive()
    for name, e in errors.items():
        raise AssertionError(f"{name} program failed: {e!r}") from e
    return out


def post(port, path, payload, headers=None, timeout=30):
    """(status, body as JSON, headers) of one POST to the proxy."""
    req = urllib.request.Request(
        f"http://127.0.0.1:{port}/{path}", data=json.dumps(payload).encode(),
        headers={"Content-Type": "application/json", **(headers or {})})
    try:
        with urllib.request.urlopen(req, timeout=timeout) as r:
            return r.status, json.loads(r.read()), dict(r.headers)
    except urllib.error.HTTPError as e:
        return e.code, json.loads(e.read() or b"null"), dict(e.headers)


# ---------------------------------------------------------- deployments


def echo(x):
    return {"echo": x}


def double(x):
    return x * 2


def ident(x):
    return x


def fail(x):
    raise ValueError("replica failed")


def batched(items):
    # One call sees many items (the batch), returns per-item results.
    return [{"n": len(items), "v": x * 2} for x in items]


class Model:
    def __init__(self, scale):
        self.scale = scale

    def __call__(self, x):
        return x * self.scale


class WhoAmI:
    def __call__(self, _):
        return os.getpid()


class Versioned:
    def __init__(self, version):
        self.version = version

    def __call__(self, x):
        return {"version": self.version, "x": x}


class Victim:
    def pid(self, _=None):
        return os.getpid()

    def __call__(self, x):
        return x + 1


class MultiModel:
    def __init__(self, pkg):
        self.serve = import_module(pkg + ".serve")
        self.loads = 0
        self.load = self.serve.multiplexed(max_num_models_per_replica=2)(
            self._load)

    def _load(self, model_id):
        self.loads += 1
        return {"model": model_id, "scale": len(model_id)}

    def __call__(self, x):
        model_id = self.serve.get_multiplexed_model_id()
        model = self.load(model_id)
        return {"pid": os.getpid(), "model": model["model"],
                "y": x * model["scale"], "loads": self.loads}


class Doubler:
    def __call__(self, x):
        return 2 * x


class Combiner:
    def __init__(self, doubler, offset):
        self.doubler = doubler
        self.offset = offset

    def __call__(self, x):
        return self.doubler.remote(x).result(timeout=30) + self.offset


class Cyclic:
    def __init__(self, other=None):
        pass


# ------------------------------------------------------------- programs


@bounded
def test_function_and_class_deployments(both):
    def program(p):
        h = p.serve.run(p.serve.deployment(echo).bind())
        m = p.serve.run(p.serve.deployment(Model).bind(10))
        return (h.remote("hi").result(timeout=30), m.remote(4).result(
            timeout=30), h.num_replicas(), sorted(p.serve.status().items()))

    got = each(both, program)
    assert got["jax"] == got["port"] == (
        {"echo": "hi"}, 40, 1, [("Model", 1), ("echo", 1)])


@bounded
def test_several_replicas_all_serve(both):
    def program(p):
        h = p.serve.run(p.serve.deployment(WhoAmI).options(
            num_replicas=3).bind())
        pids = {f.result(timeout=30) for f in [h.remote(None)
                                               for _ in range(30)]}
        return len(pids) >= 2, h.num_replicas()  # p2c spread them

    got = each(both, program)
    assert got["jax"] == got["port"] == (True, 3)


@bounded
def test_scale_up_and_down(both):
    def program(p):
        p.serve.run(p.serve.deployment(ident).bind(), name="scaled")
        seen = [p.serve.status()["scaled"]]
        h = p.serve.scale("scaled", 3)
        seen.append(p.serve.status()["scaled"])
        seen.append(h.remote(1).result(timeout=30))
        p.serve.scale("scaled", 1)
        seen.append(p.serve.status()["scaled"])
        d = p.serve.details()["scaled"]
        seen.append((d["num_replicas"], d["target_replicas"],
                     len(d["replica_versions"])))
        return seen

    got = each(both, program)
    assert got["jax"] == got["port"] == [1, 3, 1, 1, (1, 1, 1)]


@bounded
def test_dynamic_batching(both):
    def program(p):
        fn = p.serve.batch(max_batch_size=8, batch_wait_timeout_s=0.2)(
            batched)
        h = p.serve.run(p.serve.deployment(fn).bind())
        out = [f.result(timeout=30) for f in [h.remote(i) for i in range(8)]]
        # At least one flush coalesced several requests.
        return [r["v"] for r in out], max(r["n"] for r in out) > 1

    got = each(both, program)
    assert got["jax"] == got["port"] == ([i * 2 for i in range(8)], True)


@bounded
def test_http_json_and_status_of_a_raising_deployment(both):
    def program(p):
        h = p.serve.run(p.serve.deployment(double).bind(),
                        route_prefix="double")
        p.serve.run(p.serve.deployment(fail).bind(), name="fails")
        ok = post(h.http_port, "double", 21)
        bad = post(h.http_port, "fails", 1)
        unknown = post(h.http_port, "nope", 1)
        with urllib.request.urlopen(
                f"http://127.0.0.1:{h.http_port}/-/routes", timeout=30) as r:
            routes = json.loads(r.read())
        return (ok[:2], bad[:2], unknown[0], routes,
                "traceparent" in ok[2])

    got = each(both, program)
    assert got["jax"] == got["port"]
    assert got["port"] == ((200, {"result": 42}),
                           (500, {"error": "replica failed"}), 404,
                           ["double", "fails"], True)


@bounded
def test_deployment_error_propagates(both):
    def program(p):
        h = p.serve.run(p.serve.deployment(fail).bind())
        with pytest.raises(ValueError, match="replica failed") as ei:
            h.remote(1).result(timeout=30)
        return type(ei.value).__name__, str(ei.value)

    got = each(both, program)
    assert got["jax"] == got["port"] == ("ValueError", "replica failed")


@bounded
def test_rolling_redeploy_has_no_failed_request(both):
    def program(p):
        dep = p.serve.deployment(Versioned).options(num_replicas=2)
        handle = p.serve.run(dep.bind("v1"), name="roll")
        first = handle.remote(0).result(timeout=30)["version"]
        results, errors = [], []
        stop = threading.Event()

        def spam():
            while not stop.is_set():
                try:
                    results.append(handle.remote(1).result(timeout=30))
                except Exception as e:  # noqa: BLE001
                    errors.append(e)
                time.sleep(0.02)

        t = threading.Thread(target=spam)
        t.start()
        time.sleep(0.3)
        handle2 = p.serve.run(dep.bind("v2"), name="roll")
        deadline = time.monotonic() + 30
        while time.monotonic() < deadline:
            if results and results[-1]["version"] == "v2":
                break
            time.sleep(0.1)
        time.sleep(0.3)
        stop.set()
        t.join(timeout=30)
        d = p.serve.details()["roll"]
        return (first, errors, "v2" in {r["version"] for r in results},
                d["replica_versions"] == [d["version"]] * 2,
                handle2.remote(5).result(timeout=30))

    got = each(both, program)
    assert got["jax"] == got["port"] == (
        "v1", [], True, True, {"version": "v2", "x": 5})


@bounded
def test_replica_crash_is_recovered(both):
    def program(p):
        handle = p.serve.run(p.serve.deployment(Victim).options(
            num_replicas=2).bind(), name="crashy")
        pid_handle = handle.options(method="pid")
        pids = {pid_handle.remote().result(timeout=30) for _ in range(20)}
        # Kill one replica process out from under the router.
        os.kill(min(pids), signal.SIGKILL)
        time.sleep(0.5)
        served = []  # traffic keeps flowing throughout recovery
        for i in range(20):
            served.append(handle.remote(i).result(timeout=30) == i + 1)
            time.sleep(0.05)
        deadline = time.monotonic() + 20
        while time.monotonic() < deadline:
            if p.serve.status()["crashy"] == 2:
                break
            time.sleep(0.2)
        new = {pid_handle.remote().result(timeout=30) for _ in range(20)}
        return (len(pids), all(served), p.serve.status()["crashy"],
                len(new), len(new - pids))

    got = each(both, program)
    assert got["jax"] == got["port"] == (2, True, 2, 2, 1)


@bounded
def test_model_multiplexing(both):
    def program(p):
        handle = p.serve.run(p.serve.deployment(MultiModel).options(
            num_replicas=2).bind(p.name), name="mux")
        ma = handle.options(multiplexed_model_id="modelA")
        out = [ma.remote(2).result(timeout=30) for _ in range(6)]
        mb = handle.options(multiplexed_model_id="bb")
        return ([(o["model"], o["y"]) for o in out],
                len({o["pid"] for o in out}), out[-1]["loads"],
                mb.remote(3).result(timeout=30)["y"])

    got = each(both, program)
    assert got["jax"] == got["port"] == ([("modelA", 12)] * 6, 1, 1, 6)


@bounded
def test_nested_bind_graph_and_its_cycle_check(both):
    def program(p):
        d = p.serve.deployment
        handle = p.serve.run(d(Combiner).bind(d(Doubler).bind(), 5))
        out = [handle.remote(10).result(timeout=60), sorted(p.serve.status()),
               p.serve.get_deployment_handle("Doubler").remote(3).result(
                   timeout=30)]
        a = d(Cyclic).bind()
        a._init_args = (a,)  # self-cycle
        with pytest.raises(ValueError, match="cycle") as ei:
            p.serve.run(a)
        return out + [str(ei.value)]

    got = each(both, program)
    assert got["jax"] == got["port"] == [
        25, ["Combiner", "Doubler"], 6,
        "deployment graph cycle through 'Cyclic'"]


@bounded
def test_describe_and_delete(both):
    def program(p):
        p.serve.run(p.serve.deployment(ident).options(num_replicas=2).bind(),
                    name="described")
        d = dict(p.serve.details()["described"])
        d.pop("slo", None)  # the JAX package's SLO spec (None here)
        versions = d.pop("replica_versions")
        version = d.pop("version")
        p.serve.delete("described")
        return (d, versions == [version] * 2, len(version),
                p.serve.status())

    got = each(both, program)
    assert got["jax"] == got["port"]
    assert got["port"][0] == {"num_replicas": 2, "target_replicas": 2,
                              "autoscaling": None, "route_version": 1}
