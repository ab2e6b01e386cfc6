"""The port's serve building blocks against the JAX package's, without a
runtime: ``util/overload`` step for step (the same injected clock and the
same outcomes give the same AIMD limits, gate sheds, breaker states and
retry-budget decisions; the scripts follow ``tests/test_overload.py:
29-146``), ``util/backoff``'s delays from the same seed, the
``serve_replica`` fault point's scoping, the deployment objects
(``options``, ``bind``, ``AutoscalingConfig``, ``multiplexed``'s LRU),
the by-reference deployment target, and ``LLMDeployment`` given the JAX
package's weights as numpy."""

import importlib
import time

import numpy as np
import pytest

from ray_tpu.core import exceptions as jexc
from ray_tpu.util import backoff as jbackoff
from ray_tpu.util import faults as jfaults
from ray_tpu.util import overload as joverload
from ray_tpu_torch.core import exceptions as pexc
from ray_tpu_torch.util import backoff as pbackoff
from ray_tpu_torch.util import faults as pfaults
from ray_tpu_torch.util import overload as poverload

BOTH = [(joverload, jexc), (poverload, pexc)]
# ``serve/__init__`` re-exports functions named like these modules.
jdeployment, pdeployment, jmultiplex, pmultiplex = (
    importlib.import_module(f"{pkg}.serve.{mod}")
    for mod in ("deployment", "multiplex")
    for pkg in ("ray_tpu", "ray_tpu_torch"))


def served_model(x):
    """A module-level deployment target (loaded by reference)."""
    return x


@pdeployment.deployment
def decorated_model(x):
    """Under @serve.deployment its module-level name holds the Deployment."""
    return x


def _aimd_trace(ov):
    """tests/test_overload.py:29's script, every limit recorded."""
    t = [0.0]
    lim = ov.AIMDLimiter(initial=4, min_limit=1, max_limit=8,
                         latency_target_s=0.5, decrease_interval_s=0.0,
                         clock=lambda: t[0])
    out = [lim.limit]
    for latency, n, step in ((1.0, 20, 0.1), (5.0, 6, 0.1), (1.0, 200, 0.0),
                             (0.2, 30, 0.3), (9.0, 4, 0.05)):
        for _ in range(n):
            if lim.try_acquire():
                t[0] += step
                lim.release(latency)
            out.append((lim.limit, lim.inflight,
                        round(lim.ewma_latency_s, 12)))
    lim.on_reject()
    out.append(lim.limit)
    lim.release(None, overloaded=True)
    out.append(lim.limit)
    held = [lim.try_acquire() for _ in range(lim.limit + 2)]
    out.append((held, lim.sheds))
    return out


def test_aimd_limiter_steps_as_jax_does():
    jt, pt = (_aimd_trace(ov) for ov, _ in BOTH)
    assert jt == pt
    assert pt[0] == 4 and min(x[0] for x in pt[1:-3]) < 4  # it moved


def _gate_trace(ov, exc):
    out = []
    gate = ov.AdmissionGate(ov.AIMDLimiter(initial=1, max_limit=1),
                            max_queue=0)
    gate.acquire()
    with pytest.raises(exc.OverloadedError) as ei:
        gate.acquire()
    out.append((str(ei.value), ei.value.retry_after_s, gate.shed_full))
    gate.release(0.01)
    gate2 = ov.AdmissionGate(ov.AIMDLimiter(initial=1, max_limit=1),
                             max_queue=1)
    gate2.acquire()
    t0 = time.monotonic()
    with pytest.raises(exc.OverloadedError) as ei:
        gate2.acquire(deadline_ts=time.time() + 0.15)
    waited = time.monotonic() - t0
    out.append((str(ei.value), gate2.shed_expired, 0.1 <= waited < 2.0))
    gate2.release(3.0, overloaded=True)
    out.append((gate2.limiter.limit, gate2.retry_after_s(), gate2.queued))
    return out


def test_admission_gate_sheds_and_evicts_as_jax_does():
    assert _gate_trace(*BOTH[0]) == _gate_trace(*BOTH[1])


def _breaker_trace(ov):
    t = [0.0]
    transitions = []
    br = ov.CircuitBreaker(error_threshold=0.5, min_volume=4,
                           open_base_s=1.0, clock=lambda: t[0], seed=7,
                           on_transition=transitions.append)
    out = []
    script = ([("rec", False)] * 4 + [("probe?",), ("tick", 2.0),
              ("probe?",), ("begin",), ("probe?",), ("rec", False),
              ("tick", 4.0), ("probe?",), ("begin",), ("rec", True)]
              + [("rec", True), ("rec", False)] * 4
              + [("tick", 20.0), ("rec", False), ("rec", False),
                 ("rec", False), ("tick", 1.3), ("probe?",),
                 ("tick", 20.0), ("probe?",), ("begin",), ("tick", 16.0),
                 ("probe?",)])
    for op in script:
        if op[0] == "rec":
            br.record(op[1])
        elif op[0] == "tick":
            t[0] += op[1]
        elif op[0] == "begin":
            br.begin_probe()
        else:
            out.append(br.probe_due())
        out.append((br.state, br.allow(), br.opens))
    return out, transitions


def test_circuit_breaker_cycles_as_jax_does():
    jt, pt = (_breaker_trace(ov) for ov, _ in BOTH)
    assert jt == pt
    assert pt[1][0] == "open" and "closed" in pt[1]


def _budget_trace(ov):
    b = ov.RetryBudget(ratio=0.5, reserve=1.0, cap=10.0)
    out = [b.try_spend(), b.try_spend()]
    for _ in range(3):
        b.record_request()
    out += [b.try_spend(), b.try_spend(), b.tokens]
    for _ in range(40):
        b.record_request()
    out += [b.tokens, [b.try_spend() for _ in range(12)]]
    return out


def test_retry_budget_decides_as_jax_does():
    assert _budget_trace(joverload) == _budget_trace(poverload)


@pytest.mark.parametrize("ov,exc", BOTH, ids=["jax", "port"])
def test_deadline_scope_and_check(ov, exc):
    assert ov.ambient_deadline() == 0.0
    with ov.deadline_scope(time.time() + 5.0):
        assert ov.remaining() > 4.0
        ov.check_deadline("fine")
        with ov.deadline_scope(time.time() - 1.0):
            with pytest.raises(exc.DeadlineExceededError,
                               match="deadline exceeded in expired"):
                ov.check_deadline("expired")
        assert ov.remaining() > 4.0  # restored
    assert ov.ambient_deadline() == 0.0
    assert ov.remaining(42.0) == 42.0  # default when none


def test_exceptions_keep_jax_bases_and_pickle():
    import pickle

    for name in ("DeadlineExceededError", "OverloadedError"):
        j, p = getattr(jexc, name), getattr(pexc, name)
        assert [b.__name__ for b in j.__mro__] == \
            [b.__name__ for b in p.__mro__]
    e = pickle.loads(pickle.dumps(pexc.OverloadedError("full", 2.5)))
    assert (str(e), e.retry_after_s) == ("full", 2.5)
    assert issubclass(pexc.DeadlineExceededError, TimeoutError)


@pytest.mark.parametrize("kw", [
    dict(seed=3),
    dict(base=0.02, factor=2.0, max_delay=0.5, jitter=0.5, seed=11),
    dict(base=1.0, factor=3.0, max_delay=30.0, jitter=0.0, seed=None),
])
def test_backoff_delays_match_jax_from_the_same_seed(kw):
    jb, pb = jbackoff.Backoff(**kw), pbackoff.Backoff(**kw)
    jd = [jb.next_delay() for _ in range(12)]
    pd = [pb.next_delay() for _ in range(12)]
    assert jd == pd and jb.attempt == pb.attempt == 12
    jb.reset()
    pb.reset()
    assert jb.next_delay() == pb.next_delay()
    short = pbackoff.Backoff(base=1.0, deadline_s=0.05)
    time.sleep(0.06)
    assert short.expired and short.sleep() is False


@pytest.mark.parametrize("faults", [jfaults, pfaults], ids=["jax", "port"])
def test_serve_replica_fault_scopes_to_one_replica(faults):
    assert faults.SERVE_REPLICA == "serve_replica"
    faults.apply_plan([{
        "point": "serve_replica", "mode": "always", "action": "error",
        "match": {"replica": "node1:11"},
    }])
    try:
        assert faults.fire("serve_replica", replica="node2:99") == 0.0
        with pytest.raises(faults.InjectedFault):
            faults.fire("serve_replica", replica="node1:11")
    finally:
        faults.clear()


def test_deployment_options_bind_and_autoscaling_as_jax():
    out = []
    for mod in (jdeployment, pdeployment):
        d = mod.deployment(served_model)
        e = d.options(name="m2", num_replicas=3,
                      autoscaling_config=mod.AutoscalingConfig(
                          max_replicas=5)).bind(1, k=2)
        out.append((d.name, d.num_replicas, d.max_concurrent_queries,
                    e.name, e.num_replicas, e._init_args, e._init_kwargs,
                    vars(e.autoscaling_config), vars(mod.AutoscalingConfig())))
        with pytest.raises(TypeError, match="unknown deployment options"):
            d.options(bogus=1)
    assert out[0] == out[1]
    with pytest.raises(NotImplementedError, match="SLO engine"):
        pdeployment.deployment(served_model, slo={"p99_ms": 10})


def test_multiplexed_lru_as_jax():
    out = []
    for mod in (jmultiplex, pmultiplex):
        loads = []
        load = mod.multiplexed(max_num_models_per_replica=2)(
            lambda mid: loads.append(mid) or {"m": mid})
        for mid in ["a", "b", "a", "c", "b", "a"]:
            load(mid)
        out.append(loads)
    assert out[0] == out[1] == ["a", "b", "c", "b", "a"]


def test_deployment_targets_travel_by_reference():
    from ray_tpu_torch.serve.replica import load_target, target_blob

    blob = target_blob(served_model)
    assert b"served_model" in blob and load_target(blob) is served_model
    inner = decorated_model.func_or_class
    assert load_target(target_blob(inner)) is inner
    with pytest.raises(TypeError, match="module level"):
        target_blob(lambda x: x)


def test_llm_deployment_takes_numpy_weights():
    """The numpy tree goes through models/convert.params_from_numpy."""
    import jax
    import torch

    from ray_tpu.models import LlamaConfig as JaxConfig
    from ray_tpu.models import init_params as jax_init
    from ray_tpu_torch.models import LlamaConfig, params_from_numpy
    from ray_tpu_torch.serve.llm import LLMDeployment

    tree = jax.tree.map(np.asarray,
                        jax_init(JaxConfig.tiny(), jax.random.PRNGKey(1)))
    dep = LLMDeployment(LlamaConfig.tiny(), tree, device="cpu", max_len=64)
    try:
        want = params_from_numpy(tree, LlamaConfig.tiny(), "cpu")
        got = dep.engine.params
        assert set(got) == set(want)
        for k in ("embed", "final_norm", "lm_head"):
            assert torch.equal(got[k], want[k])
        for k in want["layers"]:
            assert torch.equal(got["layers"][k], want["layers"][k])
    finally:
        dep.engine.shutdown()
