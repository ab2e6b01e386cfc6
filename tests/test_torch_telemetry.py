"""The port's telemetry against the JAX package's, on the CPU: metrics and
their exposition, the fragmentation ratio, the allocator snapshot's keys,
compile counts of the engine and the train step, the decode tap ring,
collective op names and bytes, spans, and the usage report.

Both packages' registries and span buffers are process-wide, so the tests
compare what changes over the calls they make. Tolerances: the
fragmentation ratio 1e-12; everything else is counted or rendered text,
held equal.
"""

import dataclasses
import functools
import importlib
import inspect
import os
import re
import time
import types

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ray_tpu.util import device_metrics as jdm
from ray_tpu.util import metrics as jm
from ray_tpu.util import prometheus as jprom
from ray_tpu_torch.models import LlamaConfig, params_from_numpy
from ray_tpu_torch.parallel import collectives as C
from ray_tpu_torch.util import device_metrics as dm
from ray_tpu_torch.util import metrics as tm
from ray_tpu_torch.util import prometheus as tprom
from ray_tpu_torch.util import timeline as tl
from ray_tpu_torch.util import usage_stats

TOKENS = np.random.RandomState(0).randint(0, 256, (2, 17)).astype(np.int32)
SHORT = np.random.RandomState(1).randint(0, 256, (1, 9)).astype(np.int32)


def _series(local_snapshot, name):
    item = local_snapshot().get(name)
    return dict(item[1]) if item else {}


def _by_tag(local_snapshot, name, tag):
    """{tag value: value} of one metric's series."""
    return {dict(k)[tag]: v for k, v in _series(local_snapshot, name).items()}


def _delta(after, before):
    return {k: v - before.get(k, 0.0) for k, v in after.items()
            if v != before.get(k, 0.0)}


# ------------------------------------------------------ metrics and text

def _jax_fragmentation_cases():
    """The JAX package's own cases (tests/test_train_step.py) and a table
    of seeded random dicts over every key the ratio reads."""
    cases = [
        {"peak_bytes_in_use": 60, "peak_bytes_reserved": 100,
         "bytes_in_use": 10, "bytes_reserved": 10},
        {"bytes_in_use": 75, "bytes_reserved": 100},
        {"bytes_in_use": 40, "bytes_limit": 100,
         "largest_free_block_bytes": 30},
        {},
    ]
    keys = ["peak_bytes_in_use", "peak_bytes_reserved", "bytes_in_use",
            "bytes_reserved", "bytes_limit", "bytes_reservable_limit",
            "largest_free_block_bytes"]
    rs = np.random.RandomState(7)
    for _ in range(200):
        d = {k: int(rs.choice([0, rs.randint(1, 1 << 40)]))
             for k in keys if rs.rand() < 0.6}
        cases.append(d)
    return cases


def test_fragmentation_from_stats_matches_jax():
    for case in _jax_fragmentation_cases():
        want = jdm.fragmentation_from_stats(case)
        got = dm.fragmentation_from_stats(case)
        assert (got is None) == (want is None), case
        if want is not None:
            assert abs(got - want) <= 1e-12, case


def _record_sequence(mod, prefix):
    """One sequence of records through a package's metric classes."""
    c = mod.Counter(f"{prefix}_requests_total", "Requests\nserved.",
                    tag_keys=("route",))
    g = mod.Gauge(f"{prefix}_queue_depth", 'Queue "depth" \\ now.',
                  tag_keys=("replica",)).set_default_tags({"replica": "r0"})
    h = mod.Histogram(f"{prefix}_latency_seconds", "Latency.",
                      boundaries=[0.5, 0.05, 5.0], tag_keys=("route",))
    plain = mod.Counter(f"{prefix}_untagged", "")
    c.inc()
    c.inc(2.5, tags={"route": 'a"b\nc\\d'})
    bound = c.with_tags(route="/x")
    for _ in range(3):
        bound.inc()
    g.set(7)
    g.set(4, tags={"replica": "r1"})
    g.with_tags(replica="r2").set(1.5)
    for v in (0.01, 0.3, 0.3, 4.0, 50.0):
        h.observe(v, tags={"route": "/x"})
    h.observe(0.2, tags={"route": "/y"}, exemplar="trace-1")
    h.with_tags(route="/y").observe(9.0, exemplar="trace-2")
    plain.inc(3)


def _report(mod, prefix):
    out = {}
    mod.merge_snapshot(out, {k: v for k, v in mod.local_snapshot().items()
                             if k.startswith(prefix)})
    return out


@pytest.fixture
def parity_metrics(monkeypatch):
    """Both registries with the exemplar clock fixed; the "parity_" series
    a test records are taken out of both afterwards, so no later test of
    the process (or its runtime's metric flush) sees them. The clock is
    the time module with ``time()`` fixed, so that the JAX registry's
    flusher thread, which sleeps on the same module, keeps running."""
    clock = types.SimpleNamespace(**{k: getattr(time, k) for k in dir(time)
                                     if not k.startswith("_")})
    clock.time = lambda: 1234.5
    for mod in (jm, tm):
        monkeypatch.setattr(mod, "time", clock)
    yield
    for reg in (jm._registry, tm._registry):
        with reg.lock:
            for table in (reg.metrics, reg.meta, reg.kind_conflicts):
                for name in [n for n in table if n.startswith("parity_")]:
                    del table[name]
            reg._warned_kinds.difference_update(
                [n for n in reg._warned_kinds if n.startswith("parity_")])


def test_user_lines_give_identical_text(parity_metrics):
    _record_sequence(jm, "parity_user_lines")
    _record_sequence(tm, "parity_user_lines")
    want = jprom._user_lines(_report(jm, "parity_user_lines"))
    got = tprom._user_lines(_report(tm, "parity_user_lines"))
    assert got == want
    assert any("trace-2" in line for line in got)
    # The port's own report (this process's registry) renders the same.
    local = {k: v for k, v in tm.get_metrics_report().items()
             if k.startswith("parity_user_lines")}
    assert tprom._user_lines(local) == want
    assert "\n".join(want) in tprom.render()


def test_kind_conflicts_and_histogram_merge_match_jax(parity_metrics):
    for mod in (jm, tm):
        mod.Counter("parity_conflict_total", "")
        with pytest.warns(UserWarning, match="already registered"):
            mod.Gauge("parity_conflict_total", "")
    assert tm.declaration_conflicts()["parity_conflict_total"] == \
        jm.declaration_conflicts()["parity_conflict_total"]
    a = {"count": 3, "sum": 2.0, "bounds": [0.1, 1.0],
         "buckets": [1, 1, 1], "exemplars": {1.0: {"trace_id": "t", "ts": 2}}}
    b = {"count": 2, "sum": 9.0, "bounds": [0.5, 1.0, 5.0],
         "buckets": [0, 1, 0, 1]}
    for x, y in ((a, b), (a, a), (b, a)):
        assert tm._merge_histogram(x, y) == jm._merge_histogram(x, y)


def test_port_metrics_pass_the_metric_name_lint():
    path = os.path.join(os.path.dirname(__file__), os.pardir, "tools",
                        "check_metric_names.py")
    spec = importlib.util.spec_from_file_location(
        "check_metric_names", os.path.abspath(path))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    declared = {k: v for k, v in tm.declared_metrics().items()
                if k.startswith("ray_tpu_")}
    assert mod.validate(declared, {}) == []
    # The same names, kinds, help texts as the JAX package's series. The
    # trainer's and serve's series are declared when their telemetry
    # modules load, in each package: load JAX's, whatever this worker
    # imported before.
    importlib.import_module("ray_tpu.train._telemetry")
    importlib.import_module("ray_tpu.serve._telemetry")
    jax_declared = jm.declared_metrics()
    for name, meta in declared.items():
        assert jax_declared[name] == meta, name


# ------------------------------------------------------------- memory

class _FakePjrtDevice:
    """A JAX device whose allocator reports every key PJRT can give."""

    def memory_stats(self):
        return {"bytes_in_use": 10, "peak_bytes_in_use": 40,
                "bytes_reserved": 50, "peak_bytes_reserved": 64,
                "bytes_limit": 1000, "bytes_reservable_limit": 990,
                "largest_free_block_bytes": 500, "largest_alloc_size": 30,
                "num_allocs": 7}


def test_hbm_snapshot_has_jax_keys(monkeypatch):
    """The card's snapshot from torch.cuda.memory_stats, faked: JAX's keys
    less the three PyTorch cannot give, each read from its counterpart."""
    stats = {"allocated_bytes.all.current": 10,
             "allocated_bytes.all.peak": 40,
             "reserved_bytes.all.current": 50,
             "reserved_bytes.all.peak": 64, "allocation.all.allocated": 7}
    monkeypatch.setattr(torch.cuda, "memory_stats", lambda i: stats)
    monkeypatch.setattr(
        torch.cuda, "get_device_properties",
        lambda i: type("P", (), {"total_memory": 2000})())
    monkeypatch.setattr(torch.cuda, "get_per_process_memory_fraction",
                        lambda i: 0.5)
    got = dm.hbm_snapshot("cuda:0")
    want = jdm.hbm_snapshot(_FakePjrtDevice())
    assert set(got) == set(want) - {"largest_free_block_bytes",
                                    "largest_alloc_size",
                                    "bytes_reservable_limit"}
    for key in ("bytes_in_use", "peak_bytes_in_use", "bytes_reserved",
                "peak_bytes_reserved", "bytes_limit", "num_allocs",
                "fragmentation"):
        assert got[key] == want[key], key
    # A device that has not allocated yet has no allocator keys: zeros.
    monkeypatch.setattr(torch.cuda, "memory_stats", lambda i: {})
    empty = dm.hbm_snapshot("cuda:0")
    assert empty["bytes_in_use"] == 0 and "fragmentation" not in empty


def test_sample_never_starts_cuda():
    assert dm.hbm_snapshot("cpu") == {} and dm.hbm_snapshot() == {}
    assert dm.sample() == []
    assert not torch.cuda.is_initialized()


@pytest.mark.parametrize("reserved_on_0", [0, 64])
def test_sample_publishes_only_this_processs_devices(monkeypatch,
                                                     reserved_on_0):
    """Two visible cards, this process on card 1 (a rank of a world of one
    process a card). Card 0's allocator here has reserved nothing, so only
    gpu:1 is published; once it has reserved memory, card 0 is this
    process's too and is published beside it."""
    stats = {0: {"reserved_bytes.all.peak": reserved_on_0},
             1: {"allocated_bytes.all.current": 10,
                 "allocated_bytes.all.peak": 40,
                 "reserved_bytes.all.current": 50,
                 "reserved_bytes.all.peak": 64}}
    monkeypatch.setattr(torch.cuda, "is_initialized", lambda: True)
    monkeypatch.setattr(torch.cuda, "device_count", lambda: 2)
    monkeypatch.setattr(torch.cuda, "current_device", lambda: 1)
    monkeypatch.setattr(torch.cuda, "memory_stats", lambda i: stats[i])
    monkeypatch.setattr(
        torch.cuda, "get_device_properties",
        lambda i: type("P", (), {"total_memory": 2000})())
    monkeypatch.setattr(torch.cuda, "get_per_process_memory_fraction",
                        lambda i: 1.0)
    names = ("ray_tpu_device_memory_bytes_in_use",
             "ray_tpu_device_memory_peak_bytes",
             "ray_tpu_device_memory_limit_bytes")
    touched = names + ("ray_tpu_device_memory_fragmentation_ratio",
                       "ray_tpu_device_count")
    before = {n: _series(tm.local_snapshot, n) for n in touched}
    try:
        got = dm.sample()
        want = ["gpu:0", "gpu:1"] if reserved_on_0 else ["gpu:1"]
        assert [d["device"] for d in got] == want
        assert got[-1]["bytes_in_use"] == 10
        for name in names:
            new = set(_series(tm.local_snapshot, name)) - set(before[name])
            assert {dict(k)["device"] for k in new} <= set(want)
            assert {dict(k)["device"] for k in _series(
                tm.local_snapshot, name)} >= set(want)
        assert _series(tm.local_snapshot, "ray_tpu_device_count")[
            (("node", "local"), ("platform", "gpu"))] == len(want)
    finally:  # the faked cards' series leave the process's registry
        with tm._registry.lock:
            for name in touched:
                series = tm._registry.metrics.get(name, (None, {}))[1]
                for key in [k for k in series if k not in before[name]]:
                    del series[key]


# ------------------------------------------------------- compile counts

@functools.lru_cache(maxsize=None)
def _tiny():
    """The tiny config cut to one layer in both packages (a compile count
    does not depend on depth) and its weights in JAX's layout, drawn with
    numpy at the shapes of JAX's init (its eager init costs seconds)."""
    from ray_tpu.models import LlamaConfig as JaxConfig
    from ray_tpu.models import init_params as jax_init

    jcfg = dataclasses.replace(JaxConfig.tiny(), num_layers=1)
    shapes = jax.eval_shape(functools.partial(jax_init, jcfg),
                            jax.random.PRNGKey(0))
    rs = np.random.RandomState(0)
    weights = jax.tree.map(
        lambda s: (0.05 * rs.standard_normal(s.shape)).astype(s.dtype),
        shapes)
    cfg = dataclasses.replace(LlamaConfig.tiny(), num_layers=1)
    return jcfg, jax.tree.map(jnp.asarray, weights), cfg, weights


# Three prompts in buckets 16, 16 and 64 (page size 16).
PROMPTS = [[1, 2, 3], list(range(5, 17)), list(range(40))]


def _serve(engine):
    for p in PROMPTS:
        engine.generate(p, 3, timeout=120)
    engine.stats()
    engine.shutdown()


def _compiles():
    return (_by_tag(jm.local_snapshot, "ray_tpu_device_jit_compiles_total",
                    "fn"),
            _by_tag(tm.local_snapshot, "ray_tpu_device_jit_compiles_total",
                    "fn"))


def test_engine_compile_counts_match_jax():
    from ray_tpu.serve.llm import LLMEngine as JaxEngine
    from ray_tpu_torch.serve.llm import LLMEngine

    jcfg, jparams, cfg, weights = _tiny()
    params = params_from_numpy(weights, cfg, "cpu")
    j0, t0 = _compiles()
    _serve(JaxEngine(jcfg, jparams, max_batch=2, max_len=128))
    _serve(LLMEngine(cfg, params, max_batch=2, max_len=128, device="cpu"))
    j1, t1 = _compiles()
    want = _delta(j1, j0)
    assert want == {"decode_step": 1.0, "prefill": 2.0}
    assert _delta(t1, t0) == want


@pytest.fixture(scope="module")
def train_steps():
    """The same three steps (token shapes A, A, B) through both packages'
    CompiledTrainStep, under an active span in each package; returns the
    steps, the compile-count changes and the spans recorded."""
    jtl = importlib.import_module("ray_tpu.core.timeline")
    from ray_tpu.train.compiled_step import CompiledTrainStep as JaxStep
    from ray_tpu_torch.train import CompiledTrainStep

    jcfg, jparams, cfg, weights = _tiny()
    j0, t0 = _compiles()
    jstep = JaxStep(jcfg, donate=False)
    jp, jo = jparams, jax.jit(jstep.tx.init)(jparams)
    step = CompiledTrainStep(cfg, device="cpu")
    p = params_from_numpy(weights, cfg, "cpu")
    o = step.optimizer.init(p)
    jtrace, ttrace = jtl.new_trace_id(), tl.new_trace_id()
    jprev = jtl.enter_span(jtrace, jtl.new_span_id())
    tprev = tl.enter_span(ttrace, tl.new_span_id())
    try:
        for toks in (TOKENS, TOKENS, SHORT):
            jp, jo, _ = jstep(jp, jo, jnp.asarray(toks))
            step(p, o, torch.from_numpy(toks))
    finally:
        jtl.exit_span(jprev)
        tl.exit_span(tprev)
    j1, t1 = _compiles()
    jspans = [e["name"] for e in list(jtl.get_buffer()._events)
              if e["trace_id"] == jtrace]
    tspans = [e["name"] for e in tl.timeline()
              if e["args"]["trace_id"] == ttrace]
    return dict(jstep=jstep, step=step, jax=_delta(j1, j0),
                port=_delta(t1, t0), jspans=jspans, tspans=tspans)


def test_train_step_compile_counts_and_stats_match_jax(train_steps):
    assert train_steps["jax"] == {"train_step": 2.0}
    assert train_steps["port"] == train_steps["jax"]
    assert train_steps["step"].compile_stats() == \
        train_steps["jstep"].compile_stats()


def test_memory_snapshot_on_the_cpu_is_empty_in_both(train_steps):
    assert train_steps["jstep"].memory_snapshot() == {}
    assert train_steps["step"].memory_snapshot() == {}


def test_tap_ring_publishes_like_jax():
    """A stride-4 ring in both packages over the same call sequence: no
    compile is published before the 4th call or a flush, then the count
    of new signatures (JAX: new shapes, each one compile)."""
    def double(x):
        return x * 2

    jw = jdm.instrumented_jit(double, tap_stride=4)
    tw = dm.instrumented_step(double, tap_stride=4)
    n0 = {"jax": 0.0, "port": 0.0}

    def published():
        j, t = _compiles()
        return {"jax": j.get("double", 0.0) - n0["jax"],
                "port": t.get("double", 0.0) - n0["port"]}

    n0.update(published())
    seen = []
    for n in (2, 2, 3, 4, 5, 5, 6):
        jw(jnp.zeros(n))
        tw(torch.zeros(n))
        seen.append(published())
    jw.flush_taps()
    tw.flush_taps()
    seen.append(published())
    assert [s["port"] for s in seen] == [s["jax"] for s in seen]
    assert [s["port"] for s in seen] == [0, 0, 0, 3, 3, 3, 3, 5]
    assert tw.cache_size() == 5 and tw.__wrapped_fn__ is double


# --------------------------------------------------------- collectives

JAX_OPS = set(re.findall(
    r'_count\("(\w+)"',
    inspect.getsource(importlib.import_module(
        "ray_tpu.parallel.collectives"))))


def _coll_counts():
    calls = _by_tag(tm.local_snapshot,
                    "ray_tpu_device_collective_calls_total", "op")
    nbytes = _by_tag(tm.local_snapshot,
                     "ray_tpu_device_collective_bytes_total", "op")
    return calls, nbytes


@pytest.fixture(scope="module")
def world_of_one():
    """A gloo world of this one process (no process is started)."""
    import torch.distributed as dist

    from ray_tpu_torch.parallel.mesh import make_mesh

    started = not dist.is_initialized()
    mesh = make_mesh(dp=1, device="cpu")
    yield mesh
    if started and dist.is_initialized():
        dist.destroy_process_group()


def test_each_collective_counts_once_under_jax_names(world_of_one):
    mesh = world_of_one
    x = torch.arange(24, dtype=torch.float32).reshape(4, 6)
    n = x.numel() * 4
    calls0, bytes0 = _coll_counts()
    C.allreduce(x, ("dp", "fsdp", "tp"), mesh=mesh)  # one call, 3 axes
    C.allreduce(x, "dp", "max", mesh=mesh)
    C.allreduce_(x.clone(), ("dp", "sp"), mesh=mesh)
    C.allgather(x, ("dp", "fsdp"), gather_dim=1, mesh=mesh)
    C.reducescatter(x, "fsdp", mesh=mesh)
    C.broadcast(x, ("pp", "dp"), mesh=mesh)
    C.broadcast_flat([x, x[:1].to(torch.bfloat16)], "pp", mesh=mesh)
    C.ppermute(x, "sp", [(0, 0)], mesh=mesh)
    C.shift(x, "sp", mesh=mesh)
    C.all_to_all(x, "tp", split_axis=0, concat_axis=1, mesh=mesh)
    group = C.init_collective_group(1, 0, "telemetry")
    group.barrier(timeout_s=10)
    assert group.broadcast_obj({"x": 1}) == {"x": 1}
    calls1, bytes1 = _coll_counts()
    calls, nbytes = _delta(calls1, calls0), _delta(bytes1, bytes0)
    assert calls == {"allreduce": 3, "allgather": 1, "reducescatter": 1,
                     "broadcast": 2, "ppermute": 2, "all_to_all": 1,
                     "host_barrier": 1, "host_broadcast": 1}
    assert set(calls) <= JAX_OPS
    blob = len(__import__("pickle").dumps({"x": 1}))
    assert nbytes == {"allreduce": 3 * n, "allgather": n,
                      "reducescatter": n, "broadcast": 2 * n + 12,
                      "ppermute": 2 * n, "all_to_all": n,
                      "host_broadcast": blob}


PUBLIC = {"allreduce": "allreduce", "allreduce_": "allreduce",
          "allgather": "allgather", "reducescatter": "reducescatter",
          "broadcast_flat": "broadcast", "ppermute": "ppermute",
          "all_to_all": "all_to_all"}


def test_mesh_step_counts_each_call_of_the_model(world_of_one,
                                                 monkeypatch):
    """One train step through the world-size-1 mesh: the counters grow by
    exactly the Python-level collective calls that the model and the step
    make (recorded by wrappers around the module's functions), with the
    bytes of the tensors each call is given."""
    from ray_tpu_torch.train import CompiledTrainStep

    made = {}

    def recorder(name, fn):
        def call(*args, **kwargs):
            xs = args[0] if name == "broadcast_flat" else [args[0]]
            op = PUBLIC[name]
            c, b = made.get(op, (0, 0))
            made[op] = (c + 1, b + sum(t.numel() * t.element_size()
                                       for t in xs))
            return fn(*args, **kwargs)
        return call

    for name in PUBLIC:
        monkeypatch.setattr(C, name, recorder(name, getattr(C, name)))
    step = CompiledTrainStep(LlamaConfig.tiny(), mesh=world_of_one)
    params, opt = step.init(torch.Generator().manual_seed(0))
    calls0, bytes0 = _coll_counts()
    step(params, opt, step.token_sharding().cut(torch.from_numpy(TOKENS)))
    calls1, bytes1 = _coll_counts()
    assert made and set(made) <= JAX_OPS
    assert _delta(calls1, calls0) == {k: v[0] for k, v in made.items()}
    assert _delta(bytes1, bytes0) == {k: v[1] for k, v in made.items()}


# --------------------------------------------------------------- spans

def test_record_span_needs_an_active_span():
    before = len(tl.timeline())
    assert tl.record_span("outside", 1.0, 2.0) is None
    tl.span_event("outside")
    assert len(tl.timeline()) == before
    trace, parent = tl.new_trace_id(), tl.new_span_id()
    prev = tl.enter_span(trace, parent)
    try:
        sid = tl.record_span("inside", 1.0, 1.5)
    finally:
        tl.exit_span(prev)
    (ev,) = [e for e in tl.timeline() if e["args"]["trace_id"] == trace]
    assert ev["name"] == "inside" and ev["ph"] == "X"
    assert ev["ts"] == 1e6 and ev["dur"] == 0.5e6
    assert ev["args"]["span_id"] == sid and ev["args"]["parent_id"] == parent
    assert ev["pid"] == "node:local"
    assert tl.current_span() is None


def test_train_step_spans_match_jax(train_steps):
    assert train_steps["jspans"] == ["train_step"] * 3
    assert train_steps["tspans"] == train_steps["jspans"]


def test_checkpoint_spans_carry_jax_names(tmp_path):
    """One committed save and one restore under a span give one
    ``ckpt_save:<basename>`` and one ``ckpt_restore:<basename>`` span, the
    names the JAX package records (its save and restore record them in
    the same places)."""
    from ray_tpu.train.checkpoint import Checkpoint as JaxCheckpoint
    from ray_tpu_torch.train import Checkpoint

    for fn in (JaxCheckpoint.from_pytree, JaxCheckpoint.as_pytree):
        assert 'record_span' in inspect.getsource(fn)
    jsrc = inspect.getsource(JaxCheckpoint)
    trace = tl.new_trace_id()
    prev = tl.enter_span(trace, tl.new_span_id())
    try:
        ck = Checkpoint.from_pytree({"w": torch.ones(3)}, tmp_path / "ck")
        ck.as_pytree(device="cpu")
    finally:
        tl.exit_span(prev)
    names = [e["name"] for e in tl.timeline()
             if e["args"]["trace_id"] == trace]
    assert names == ["ckpt_save:ck", "ckpt_restore:ck"]
    assert 'f"ckpt_save:{os.path.basename(path)}"' in jsrc
    assert 'f"ckpt_restore:{os.path.basename(self.path)}"' in jsrc
    path = tmp_path / "trace.json"
    events = tl.timeline(str(path))
    import json

    with open(path) as f:
        assert json.load(f) == events


# --------------------------------------------------------------- usage

def test_usage_report_keys_match_jax():
    from ray_tpu.util import usage_stats as jus

    import ray_tpu_torch.data  # noqa: F401 — records "data"
    import ray_tpu_torch.serve  # noqa: F401
    import ray_tpu_torch.train  # noqa: F401

    # num_nodes and total_resources come only from a live runtime.
    want = set(jus.build_report()) - {"num_nodes", "total_resources"}
    got = usage_stats.build_report()
    assert set(got) == (want - {"jax_version"}) | {"torch_version",
                                                    "cuda_version"}
    assert got["torch_version"] == torch.__version__
    assert {"data", "serve", "train"} <= set(got["libraries_used"])
