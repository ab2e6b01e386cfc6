"""Streaming and overload control of the port's serve under the port's
runtime against the JAX package's under its own (one runtime of each for
the module, programs run through both at once as in
``tests/test_torch_serve_runtime.py``): a deployment's generator through
the handle's streaming call and through the proxy's SSE, the per-item
timeout guard against a wedged generator (``tests/test_serve_rolling.py:
114``), a request whose deadline expires while it queues refused before
it runs, a stream cancelled at an item seam by its deadline, a replica
shedding past its adaptive limit, the proxy's 503 + Retry-After shed and
the deadline's 504 (``tests/test_overload.py:265-380``). Then the tiny
LLM served by ``LLMDeployment(device="cpu")`` in a CPU replica of the
port's runtime: its greedy tokens through ``handle.remote``, the handle's
streaming call and SSE equal the JAX package's ``generate`` with the same
numpy weights (exactly: the tokens are discrete).
"""

import functools
import json
import os
import sys
import threading
import time
import urllib.error
import urllib.request

import numpy as np
import pytest

import test_torch_serve_runtime as base
from test_torch_serve_runtime import bounded, each, port_rt  # noqa: F401


@pytest.fixture(scope="module")
def jax_rt():
    yield from base.jax_fixture([sys.modules[__name__], base])


@pytest.fixture
def both(jax_rt, port_rt):  # noqa: F811
    return {"jax": jax_rt, "port": port_rt}


def sse(port, path, payload, timeout=60):
    """The data frames of one SSE response, JSON-decoded, with its
    Content-Type; the end frame's null comes last."""
    req = urllib.request.Request(
        f"http://127.0.0.1:{port}/{path}", data=json.dumps(payload).encode(),
        headers={"Content-Type": "application/json"})
    frames = []
    with urllib.request.urlopen(req, timeout=timeout) as r:
        kind = r.headers.get("Content-Type")
        for raw in r:
            line = raw.decode().strip()
            if line.startswith("data:"):
                frames.append(json.loads(line[5:].strip()))
    return kind, frames


# ---------------------------------------------------------- deployments


class Tokens:
    def stream(self, n):
        for i in range(n):
            time.sleep(0.01)
            yield {"token": i * 3}

    def __call__(self, n):
        return [i * 3 for i in range(n)]


class Wedge:
    def stream(self, _):
        yield {"i": 0}
        time.sleep(3600)  # never yields again
        yield {"i": 1}


class Marked:
    """Writes a line to a marker file for each request it runs."""

    def __init__(self, marker):
        self.marker = marker

    def __call__(self, req):
        with open(self.marker, "a") as f:
            f.write(f"{req['id']}\n")
        time.sleep(req.get("sleep", 0))
        return req["id"]

    def gen(self, _):
        for i in range(50):
            with open(self.marker, "a") as f:
                f.write(f"{i}\n")
            time.sleep(0.1)
            yield i


class Sleepy:
    def __init__(self, seconds):
        self.seconds = seconds

    def __call__(self, _):
        time.sleep(self.seconds)
        return "ok"


# ------------------------------------------------------------- programs


@bounded
def test_streaming_through_the_handle_and_sse(both):
    def program(p):
        h = p.serve.run(p.serve.deployment(Tokens).bind(), name="tok")
        items = list(h.options(method="stream").stream(5))
        kind, frames = sse(h.http_port, "tok/stream", 4)
        whole = h.remote(3).result(timeout=30)
        return items, kind, frames, whole

    got = each(both, program)
    assert got["jax"] == got["port"] == (
        [{"token": i * 3} for i in range(5)], "text/event-stream",
        [{"token": i * 3} for i in range(4)] + [None], [0, 3, 6])


@bounded
def test_stream_item_timeout_guards_the_consumer(both):
    def program(p):
        h = p.serve.run(p.serve.deployment(Wedge).bind(),
                        name="wedge").options(method="stream")
        old = p.handle.STREAM_ITEM_TIMEOUT_S
        p.handle.STREAM_ITEM_TIMEOUT_S = 2.0
        try:
            it = h.stream(None)
            first = next(it)
            t0 = time.time()
            with pytest.raises(TimeoutError) as ei:
                next(it)
            return first, time.time() - t0 < 30, type(ei.value).__name__
        finally:
            p.handle.STREAM_ITEM_TIMEOUT_S = old

    got = each(both, program)
    assert got["jax"] == got["port"] == ({"i": 0}, True, "GetTimeoutError")


@bounded
def test_expired_request_never_runs_and_stream_stops_at_its_deadline(
        both, tmp_path):
    def program(p):
        marker = str(tmp_path / f"{p.name}.txt")
        h = p.serve.run(p.serve.deployment(Marked).bind(marker),
                        name="marked")
        # Occupy the single replica, then queue a request whose budget
        # dies while it waits.
        f1 = h.remote({"id": "blocker", "sleep": 1.0})
        time.sleep(0.15)
        with p.overload.deadline_scope(time.time() + 0.3):
            f2 = h.remote({"id": "expired", "sleep": 0})
        out = [f1.result(timeout=30)]
        with pytest.raises(p.exc.DeadlineExceededError):
            f2.result(timeout=30)
        time.sleep(0.3)
        out.append(open(marker).read().split())
        os.unlink(marker)
        got = []
        with p.overload.deadline_scope(time.time() + 0.45):
            with pytest.raises(Exception) as ei:
                for item in h.options(method="gen").stream(None):
                    got.append(item)
        time.sleep(0.5)  # the generator must be stopped, not producing
        n_before = len(open(marker).read().split())
        time.sleep(0.5)
        n_after = len(open(marker).read().split())
        out += [1 <= len(got) < 50, n_after == n_before < 50,
                isinstance(ei.value, TimeoutError)]
        return out

    got = each(both, program)
    assert got["jax"] == got["port"] == [
        "blocker", ["blocker"], True, True, True]


@bounded
def test_replica_sheds_past_its_adaptive_limit(both):
    def program(p):
        h = p.serve.run(p.serve.deployment(Sleepy).options(
            max_concurrent_queries=1,
            ray_actor_options={"max_concurrency": 8}).bind(0.4),
            name="one-at-a-time")
        results, errors = [], []
        for f in [h.remote(None) for _ in range(6)]:
            try:
                results.append(f.result(timeout=30))
            except p.exc.OverloadedError as e:
                errors.append(e)
        return (bool(results), bool(errors),
                all(e.retry_after_s > 0 for e in errors))

    got = each(both, program)
    assert got["jax"] == got["port"] == (True, True, True)


@bounded
def test_proxy_sheds_with_503_and_a_spent_deadline_is_504(both):
    def program(p):
        cfg = p.config.get_config()
        old = (cfg.serve_proxy_concurrency, cfg.serve_shed_queue_len)
        cfg.serve_proxy_concurrency, cfg.serve_shed_queue_len = 2, 0
        p.http._gates.clear()  # rebuild gates under the test knobs
        try:
            h = p.serve.run(p.serve.deployment(Sleepy).options(
                ray_actor_options={"max_concurrency": 8}).bind(0.6),
                name="slowdep")
            codes, retry_afters = [], []
            lock = threading.Lock()

            def hit():
                code, _, headers = base.post(h.http_port, "slowdep", None)
                with lock:
                    codes.append(code)
                    if code == 503:
                        retry_afters.append(headers.get("Retry-After"))

            threads = [threading.Thread(target=hit) for _ in range(8)]
            for t in threads:
                t.start()
            for t in threads:
                t.join(timeout=60)
            late = base.post(h.http_port, "slowdep", None,
                             headers={"X-Request-Timeout-S": "0.2"})
            return (codes.count(200) >= 1, codes.count(503) >= 1,
                    all(ra is not None and int(ra) >= 1
                        for ra in retry_afters), late[:2])
        finally:
            cfg.serve_proxy_concurrency, cfg.serve_shed_queue_len = old
            p.http._gates.clear()

    got = each(both, program)
    assert got["jax"] == got["port"] == (
        True, True, True, (504, {"error": "serve request timed out"}))


# ----------------------------------------------------- the LLM through serve


@functools.lru_cache(maxsize=None)
def tiny_llm():
    """The JAX package's tiny weights as numpy, and JAX's greedy tokens
    for two seeded prompts."""
    import jax
    import jax.numpy as jnp

    from ray_tpu.models import LlamaConfig
    from ray_tpu.models import init_params
    from ray_tpu.models.generation import generate

    cfg = LlamaConfig.tiny()
    params = init_params(cfg, jax.random.PRNGKey(0))
    rng = np.random.RandomState(5)
    # One prompt length: one JAX compile.
    prompts = [rng.randint(0, 256, 9).tolist() for _ in range(2)]
    gen = jax.jit(generate, static_argnums=(2,),
                  static_argnames=("max_new_tokens",))
    want = [np.asarray(gen(params, jnp.asarray([p], jnp.int32), cfg,
                           max_new_tokens=6))[0].tolist() for p in prompts]
    return jax.tree.map(np.asarray, params), prompts, want


@bounded
def test_tiny_llm_through_serve_equals_jax_generate(port_rt):  # noqa: F811
    from ray_tpu_torch import serve
    from ray_tpu_torch.models import LlamaConfig
    from ray_tpu_torch.serve.llm import LLMDeployment

    params, prompts, want = tiny_llm()
    try:
        h = serve.run(serve.deployment(LLMDeployment).options(
            name="llm", ray_actor_options={"max_concurrency": 8}).bind(
                LlamaConfig.tiny(), params, device="cpu", max_batch=2,
                max_len=64))
        reqs = [{"prompt": p, "max_new_tokens": 6} for p in prompts]
        whole = [f.result(timeout=120)["tokens"]
                 for f in [h.remote(r) for r in reqs]]
        streamed = [[i["token"] for i in h.options(method="stream").stream(r)]
                    for r in reqs]
        frames = [base_sse_tokens(h.http_port, r) for r in reqs]
        assert whole == streamed == frames == want
    finally:
        serve.shutdown()


def base_sse_tokens(port, request):
    kind, frames = sse(port, "llm/stream", request, timeout=120)
    assert kind == "text/event-stream" and frames[-1] is None
    return [f["token"] for f in frames[:-1]]
