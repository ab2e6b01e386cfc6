"""The port's continuous-batching engine on the CPU: greedy outputs equal
the JAX package's ``generate`` with the same weights, and the engine's page
accounting, admission, streaming and failure recovery behave as the JAX
engine's do."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ray_tpu.models import LlamaConfig as JaxConfig
from ray_tpu.models import init_params as jax_init
from ray_tpu.models.generation import generate as jax_generate_eager
from ray_tpu_torch.models import LlamaConfig, params_from_numpy
from ray_tpu_torch.models.generation import generate
from ray_tpu_torch.serve import llm
from ray_tpu_torch.serve.llm import LLMDeployment, LLMEngine

jax_generate = jax.jit(jax_generate_eager, static_argnums=(2,),
                       static_argnames=("max_new_tokens",))

@pytest.fixture(scope="module")
def tiny():
    jcfg = JaxConfig.tiny()
    jparams = jax_init(jcfg, jax.random.PRNGKey(0))
    params = params_from_numpy(jax.tree.map(np.asarray, jparams),
                               LlamaConfig.tiny(), "cpu")
    return jcfg, jparams, LlamaConfig.tiny(), params


@pytest.fixture
def engine(tiny, request):
    kw = getattr(request, "param", {})
    eng = LLMEngine(tiny[2], tiny[3], device="cpu", **kw)
    yield eng
    eng.shutdown()
    assert not eng._thread.is_alive()


@pytest.mark.parametrize("n", [6, 70])
def test_engine_greedy_matches_jax_generate(tiny, engine, n):
    """Prompt 70 lands in bucket 128, so prefill takes the flash route.
    The port's own ``generate`` (dense cache) gives the same tokens."""
    jcfg, jparams, cfg, params = tiny
    prompt = np.random.RandomState(n).randint(0, 256, (1, n)).astype(np.int32)
    want = np.asarray(jax_generate(jparams, jnp.asarray(prompt), jcfg,
                                   max_new_tokens=6))[0].tolist()
    assert engine._bucket(n) == (16 if n == 6 else 128)
    assert engine.generate(prompt[0].tolist(), 6, timeout=120) == want
    got = generate(params, prompt, cfg, max_new_tokens=6, device="cpu")
    assert got[0].tolist() == want


@pytest.mark.parametrize(
    "engine", [dict(max_batch=2, max_len=32, page_size=8, total_pages=6)],
    indirect=True)
def test_more_requests_than_slots_and_page_reuse(tiny, engine):
    """Five requests through two slots and a six-page pool: requests wait
    for slots and pages, every page returns, and each output equals the
    request run alone."""
    cfg, params = tiny[2], tiny[3]
    rng = np.random.RandomState(4)
    prompts = [rng.randint(0, 256, n).tolist() for n in (5, 12, 3, 9, 7)]
    reqs = [engine.submit(p, 6) for p in prompts]
    outs = [r.result(timeout=120) for r in reqs]
    for p, out in zip(prompts, outs):
        alone = generate(params, [p], cfg, max_new_tokens=6, device="cpu")
        assert out == alone[0].tolist()
    st = engine.stats()
    assert st["free_pages"] == st["total_pages"] == 6
    assert st["free_slots"] == 2 and st["active_slots"] == 0
    assert st["decode_steps"] >= 5 * 5 // 2
    assert set(st) == {"active_slots", "free_slots", "decode_steps",
                       "free_pages", "total_pages", "page_size"}
    with pytest.raises(ValueError, match="max_len"):
        engine.submit(list(range(30)), 5)
    small = LLMEngine(cfg, params, max_batch=1, max_len=32, page_size=8,
                      total_pages=3, device="cpu")
    try:
        with pytest.raises(ValueError, match="pages"):
            small.submit(list(range(20)), 10)  # needs 4 of 3 pages
    finally:
        small.shutdown()


def test_streaming_and_deployment(tiny):
    cfg, params = tiny[2], tiny[3]
    dep = LLMDeployment(cfg, params, max_batch=2, device="cpu")
    try:
        req = dep.engine.submit([1, 2, 3], 5)
        streamed = list(req.tokens(timeout=60))
        assert streamed == req.result() and len(streamed) == 5
        assert dep({"prompt": [1, 2, 3], "max_new_tokens": 5}) == {
            "tokens": streamed}
        assert [t["token"] for t in dep.stream(
            {"prompt": [1, 2, 3], "max_new_tokens": 5})] == streamed
        assert dep.stats()["free_slots"] == 2
    finally:
        dep.engine.shutdown()
    with pytest.raises(FileNotFoundError):
        LLMDeployment(cfg, checkpoint_path="/nonexistent", device="cpu")


@pytest.mark.parametrize("step", ["paged_decode", "paged_prefill"])
def test_failed_step_resets_cache_and_engine_serves_on(tiny, engine,
                                                       monkeypatch, step):
    """A prefill or decode step that raises fails the requests in flight
    (the pool may be half written), rebuilds the pool, and the engine keeps
    serving. Every step runs under inference_mode, entered in the loop
    thread."""
    real = getattr(llm, step)
    seen = []
    fail_at = 2 if step == "paged_decode" else 1

    def flaky(*args, **kwargs):
        seen.append(torch.is_inference_mode_enabled())
        if len(seen) == fail_at:
            raise RuntimeError("injected step failure")
        return real(*args, **kwargs)

    monkeypatch.setattr(llm, step, flaky)
    old_pool = engine.cache.k
    req = engine.submit([4, 5, 6], 8)
    with pytest.raises(RuntimeError, match="injected step failure"):
        req.result(timeout=60)
    assert engine.cache.k is not old_pool
    assert len(engine.generate([4, 5, 6], 4, timeout=60)) == 4
    st = engine.stats()
    assert st["free_pages"] == st["total_pages"]
    assert seen and all(seen)
    assert not torch.is_inference_mode_enabled()


def test_generate_takes_eos_token_as_jax_does(tiny):
    """JAX's generate accepts eos_token and does not use it: both run every
    row for max_new_tokens steps ([[21, 80]] here, 2 being a sampled token
    neither stops at)."""
    jcfg, jparams, cfg, params = tiny
    want = np.asarray(jax_generate(jparams, jnp.asarray([[1, 2, 3]]), jcfg,
                                   max_new_tokens=2, eos_token=2))
    got = generate(params, [[1, 2, 3]], cfg, max_new_tokens=2, eos_token=2,
                   device="cpu")
    np.testing.assert_array_equal(got.numpy(), want)
    assert want.tolist() == [[21, 80]]


def test_deployment_given_params_serves_them_beside_a_checkpoint_path(tiny):
    """Given params, the deployment serves them and leaves the path alone
    (ray_tpu/serve/llm.py:377 reads it only without params); the JAX
    deployment on the same weights answers the same tokens."""
    from ray_tpu.serve.llm import LLMDeployment as JaxDeployment

    jcfg, jparams, cfg, params = tiny
    request = {"prompt": [1, 2, 3], "max_new_tokens": 4}
    jdep = JaxDeployment(jcfg, jparams, checkpoint_path="/nonexistent",
                         max_batch=2)
    dep = LLMDeployment(cfg, params, checkpoint_path="/nonexistent",
                        max_batch=2, device="cpu")
    try:
        assert dep(request) == jdep(request)
    finally:
        dep.engine.shutdown()
        jdep.engine.shutdown()


def test_deployment_serves_from_a_checkpoint_as_jax_does(tiny, tmp_path):
    """Both packages' deployments load their own checkpoint of the same
    weights (JAX: orbax; the port: its torch.save payload, given the
    weights through params_from_numpy) and answer the same greedy
    tokens."""
    from ray_tpu.serve.llm import LLMDeployment as JaxDeployment
    from ray_tpu.train.checkpoint import Checkpoint as JaxCheckpoint
    from ray_tpu_torch.train import Checkpoint

    jcfg, jparams, cfg, params = tiny
    JaxCheckpoint.from_pytree(jparams, str(tmp_path / "jax"))
    Checkpoint.from_pytree(params, str(tmp_path / "port"))
    request = {"prompt": [7, 1, 9, 4], "max_new_tokens": 6}
    jdep = JaxDeployment(jcfg, checkpoint_path=str(tmp_path / "jax"),
                         max_batch=2)
    dep = LLMDeployment(cfg, checkpoint_path=str(tmp_path / "port"),
                        max_batch=2, device="cpu")
    try:
        for k, v in dep.engine.params["layers"].items():
            assert torch.equal(v, params["layers"][k]), k
        assert dep(request) == jdep(request)
    finally:
        dep.engine.shutdown()
        jdep.engine.shutdown()
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="no CUDA device"):
            LLMDeployment(cfg, checkpoint_path=str(tmp_path / "port"))
