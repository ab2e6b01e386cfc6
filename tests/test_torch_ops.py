"""The port's attention ops against the JAX package's: the plain versions of
the CUDA kernels against the Pallas kernels run in interpret mode, and
``mha_attention`` against its JAX original. Inputs are made with numpy from
a seed; float32 tolerances are those of the JAX kernel tests."""

import os
import subprocess
import sys

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ray_tpu.models.generation import _attend_paged_xla
from ray_tpu.models.llama import LlamaConfig as JaxConfig
from ray_tpu.ops.attention import mha_attention as jax_mha
from ray_tpu.ops.flash_attention import _flash_fwd, _to_heads3
from ray_tpu.ops.paged_attention import paged_decode_attention as jax_paged
from ray_tpu_torch.models.generation import _attend_paged_gather
from ray_tpu_torch.models.llama import LlamaConfig
from ray_tpu_torch.ops import flash_attention as fa
from ray_tpu_torch.ops import paged_attention as pa
from ray_tpu_torch.ops.attention import mha_attention

TOL = dict(atol=2e-5, rtol=2e-5)
REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _randn(rng, *shape):
    return rng.randn(*shape).astype(np.float32)


# (B, Sq, Skv, H, Hkv, D, causal, q_offset, kv_offset, block)
FLASH_CASES = {
    "noncausal": (1, 16, 16, 2, 2, 16, False, 0, 0, 8),
    "causal_gqa": (2, 16, 16, 4, 2, 16, True, 0, 0, 8),
    "q_offset": (1, 8, 24, 2, 1, 16, True, 16, 0, 8),
    "kv_offset": (1, 16, 24, 2, 2, 16, True, 8, 4, 8),
    # Query block 0 sits before every key: fully masked, O = 0.
    "masked_block": (1, 16, 16, 2, 1, 16, True, 0, 8, 8),
}


@pytest.mark.parametrize("case", sorted(FLASH_CASES))
def test_flash_reference_matches_pallas_kernel(case):
    B, Sq, Skv, H, Hkv, D, causal, qo, ko, blk = FLASH_CASES[case]
    rng = np.random.RandomState(len(case))
    q, k, v = (_randn(rng, B, Sq, H, D), _randn(rng, B, Skv, Hkv, D),
               _randn(rng, B, Skv, Hkv, D))
    o3, lse = _flash_fwd(
        _to_heads3(jnp.asarray(q)), _to_heads3(jnp.asarray(k)),
        _to_heads3(jnp.asarray(v)), heads=H, kv_heads=Hkv, scale=D ** -0.5,
        causal=causal, q_offset=qo, kv_offset=ko, block_q=blk, block_k=blk,
        interpret=True)
    want_o = np.asarray(o3).reshape(B, H, Sq, D).transpose(0, 2, 1, 3)
    want_lse = np.asarray(lse).reshape(B * H, Sq)
    got_o, got_lse = fa.flash_attention_reference(
        torch.from_numpy(q), torch.from_numpy(k), torch.from_numpy(v),
        causal=causal, q_offset=qo, kv_offset=ko)
    np.testing.assert_allclose(got_o.numpy(), want_o, **TOL)
    np.testing.assert_allclose(got_lse.numpy(), want_lse, **TOL)
    if case == "masked_block":
        assert (got_o[:, :blk] == 0).all()
        assert (got_lse.reshape(B, H, Sq)[:, :, :blk] == fa.NEG_INF).all()


def test_flash_wrapper_on_cpu_uses_plain_version():
    rng = np.random.RandomState(0)
    q, k, v = (torch.from_numpy(_randn(rng, 1, 10, 4, 8)) for _ in range(3))
    before = fa.launches
    out, lse = fa.flash_attention_fwd(q, k, v, causal=True)
    ref, ref_lse = fa.flash_attention_reference(q, k, v, causal=True)
    assert torch.equal(out, ref) and torch.equal(lse, ref_lse)
    assert fa.flash_attention(q, k, v, causal=True).shape == (1, 10, 4, 8)
    assert fa.launches == before  # counts kernel launches only


@pytest.mark.parametrize("form", ["per_layer", "layer_arg"])
def test_paged_gather_matches_pallas_kernel(form):
    """tests/test_generation.py's layout: random page tables, lengths at a
    page's first cell, mid-page and last cell, GQA groups."""
    B, H, Hkv, D = 3, 4, 2, 128
    L, P, page, Pmax = 2, 8, 16, 4
    rng = np.random.RandomState(0)
    q = _randn(rng, B, 1, H, D)
    ck = _randn(rng, L, Hkv, P, page, D)
    cv = _randn(rng, L, Hkv, P, page, D)
    table = np.asarray([[3, 1, 6, 0], [2, 5, 7, 4], [0, 6, 1, 3]], np.int32)
    lengths = np.asarray([0, 17, 63], np.int32)
    t = {n: torch.from_numpy(a) for n, a in
         dict(q=q, ck=ck, cv=cv, table=table, lengths=lengths).items()}
    cfg = LlamaConfig.tiny()
    for layer in range(L):
        if form == "per_layer":
            want = jax_paged(jnp.asarray(q[:, 0]), jnp.asarray(ck[layer]),
                             jnp.asarray(cv[layer]), jnp.asarray(table),
                             jnp.asarray(lengths), interpret=True)
            got = _attend_paged_gather(t["q"], t["ck"][layer], t["cv"][layer],
                                       t["table"], t["lengths"], cfg)[:, 0]
        else:
            want = jax_paged(jnp.asarray(q[:, 0]), jnp.asarray(ck),
                             jnp.asarray(cv), jnp.asarray(table),
                             jnp.asarray(lengths), layer=layer,
                             interpret=True)
            got = pa.paged_decode_attention(t["q"][:, 0], t["ck"], t["cv"],
                                            t["table"], t["lengths"],
                                            layer=layer)
        np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)
    assert pa.launches == 0


def test_paged_gather_matches_jax_gather_path():
    """The same function as the JAX engine's default decode attention."""
    B, H, Hkv, D, P, page, Pmax = 2, 4, 2, 16, 6, 4, 3
    rng = np.random.RandomState(1)
    q = _randn(rng, B, 1, H, D)
    ck, cv = _randn(rng, Hkv, P, page, D), _randn(rng, Hkv, P, page, D)
    table = np.asarray([[5, 0, 2], [1, 4, 3]], np.int32)
    lengths = np.asarray([6, 11], np.int32)
    want = _attend_paged_xla(*map(jnp.asarray, (q, ck, cv, table, lengths)),
                             JaxConfig.tiny())
    got = _attend_paged_gather(*map(torch.from_numpy,
                                    (q, ck, cv, table, lengths)),
                               LlamaConfig.tiny())
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)


def test_paged_reference_clamps_out_of_pool_page_ids():
    """Page ids outside the pool are clamped into it, as the kernel clamps
    them (torch would raise; the JAX gather path would read NaN): a bad id
    in a column past the slot's length changes nothing."""
    rng = np.random.RandomState(3)
    q = torch.from_numpy(_randn(rng, 2, 4, 16))
    pool_k = torch.from_numpy(_randn(rng, 2, 5, 4, 16))
    pool_v = torch.from_numpy(_randn(rng, 2, 5, 4, 16))
    lengths = torch.tensor([5, 2], dtype=torch.int32)
    good = torch.tensor([[3, 1, 0], [4, 0, 0]], dtype=torch.int32)
    bad = torch.tensor([[3, 1, 99], [4, -7, 12]], dtype=torch.int32)
    want = pa.paged_decode_reference(q, pool_k, pool_v, good, lengths)
    got = pa.paged_decode_attention(q, pool_k, pool_v, bad, lengths)
    assert torch.equal(got, want)


def test_paged_split_rule():
    """The bf16 kernel's split count: two blocks an SM over the B x Hkv
    walks, at most one split per 32 tokens the table can name, at least
    one. The 8B engine's decode (B=4, Hkv=8, Pmax 32, page 16) and the
    B=8 bench on the H100's 132 SMs get two blocks an SM or more."""
    rule = pa.paged_splits
    assert rule(4, 8, 32, 16, 132) == 9 and 4 * 8 * 9 >= 2 * 132
    assert rule(8, 8, 32, 16, 132) == 5 and 8 * 8 * 5 >= 2 * 132
    assert rule(1, 8, 32, 16, 132) == 16  # capped by 512 tokens / 32
    assert rule(4, 8, 30, 16, 132) == 9   # Pmax not a multiple of it
    assert rule(3, 2, 40, 16, 132) == 20
    assert rule(64, 8, 32, 16, 132) == 1  # 512 walks fill the card
    assert rule(1, 1, 1, 1, 132) == 1
    assert rule(4, 8, 32, 16) == rule(4, 8, 32, 16, pa.H100_SMS)


MHA_CASES = {
    "plain": dict(causal=False),
    "causal_gqa": dict(causal=True, Hkv=2),
    "offsets": dict(causal=True, q_offset=5, kv_offset=2),
    "bias": dict(causal=False, bias=True),
    # Every query sits before every key: -inf rows give NaN in both.
    "nan_rows": dict(causal=True, q_offset=0, kv_offset=20),
}


@pytest.mark.parametrize("case", sorted(MHA_CASES))
def test_mha_attention_matches_jax(case):
    kw = dict(MHA_CASES[case])
    Hkv = kw.pop("Hkv", 4)
    use_bias = kw.pop("bias", False)
    rng = np.random.RandomState(2)
    B, Sq, Skv, H, D = 2, 6, 9, 4, 8
    q, k, v = (_randn(rng, B, Sq, H, D), _randn(rng, B, Skv, Hkv, D),
               _randn(rng, B, Skv, Hkv, D))
    bias = _randn(rng, B, H, Sq, Skv) if use_bias else None
    want = np.asarray(jax_mha(
        jnp.asarray(q), jnp.asarray(k), jnp.asarray(v),
        bias=None if bias is None else jnp.asarray(bias), **kw))
    got = mha_attention(
        torch.from_numpy(q), torch.from_numpy(k), torch.from_numpy(v),
        bias=None if bias is None else torch.from_numpy(bias), **kw).numpy()
    np.testing.assert_allclose(got, want, equal_nan=True, **TOL)
    if case == "nan_rows":
        assert np.isnan(got).all() and np.isnan(want).all()


def test_wrappers_never_fall_back_off_cpu():
    """A tensor that is neither on the CPU nor on a card is refused, not
    quietly computed by the plain version."""
    q = torch.empty(1, 4, 2, 8, device="meta")
    with pytest.raises(ValueError, match="cuda or cpu"):
        fa.flash_attention(q, q, q, causal=True)
    qd = torch.empty(2, 2, 8, device="meta")
    pool = torch.empty(1, 3, 4, 8, device="meta")
    table = torch.zeros(2, 2, dtype=torch.int32, device="meta")
    lengths = torch.zeros(2, dtype=torch.int32, device="meta")
    with pytest.raises(ValueError, match="cuda or cpu"):
        pa.paged_decode_attention(qd, pool, pool, table, lengths)
    with pytest.raises(ValueError, match="head dim"):
        wide = torch.zeros(1, 2, 1, 300)
        fa.flash_attention(wide, wide, wide)


@pytest.fixture(scope="module")
def fresh_import(tmp_path_factory):
    """One fresh interpreter with no nvcc anywhere imports the port, runs a
    kernel module's plain version, tries to build the kernel library, and
    reports what it found."""
    code = (
        "import sys, torch\n"
        "import ray_tpu_torch, ray_tpu_torch.serve.llm\n"
        "import ray_tpu_torch.models.convert, ray_tpu_torch.train\n"
        "import ray_tpu_torch.parallel.mesh, ray_tpu_torch.parallel.sharding\n"
        "import ray_tpu_torch.parallel.collectives\n"
        "import ray_tpu_torch.parallel.ring_attention\n"
        "import ray_tpu_torch.parallel.pipeline\n"
        "import ray_tpu_torch.parallel.dryrun\n"
        "import ray_tpu_torch.train.checkpoint, ray_tpu_torch.train.predictor\n"
        "import ray_tpu_torch.models.resnet, ray_tpu_torch.util.faults\n"
        "import ray_tpu_torch.util.metrics, ray_tpu_torch.util.prometheus\n"
        "import ray_tpu_torch.util.timeline, ray_tpu_torch.util.usage_stats\n"
        "import ray_tpu_torch.data, ray_tpu_torch.data.ingest\n"
        "import ray_tpu_torch.rllib\n"
        "from ray_tpu_torch.rllib import a2c, algorithm, core, ddpg, dqn\n"
        "from ray_tpu_torch.rllib import env_runner, impala, pg, policy\n"
        "from ray_tpu_torch.rllib import ppo, replay_buffers, sac\n"
        "from ray_tpu_torch.rllib import sample_batch, td3\n"
        "from ray_tpu_torch.rllib import alpha_zero, bc, cql, crr, dt\n"
        "from ray_tpu_torch.rllib import maddpg, marwil, qmix, r2d2\n"
        "from ray_tpu_torch.rllib import recurrent_ppo, slateq\n"
        "from ray_tpu_torch.rllib import a3c, ddppo\n"
        "from ray_tpu_torch.util import device_metrics\n"
        "from ray_tpu_torch.ops import _build, flash_attention as fa\n"
        "from ray_tpu_torch.ops import paged_attention as pa\n"
        "import ray_tpu_torch.core, ray_tpu_torch.core.worker_main\n"
        "import ray_tpu_torch.train.trainer, ray_tpu_torch.train.torch\n"
        "import ray_tpu_torch.util.events\n"
        "import ray_tpu_torch.serve, ray_tpu_torch.serve.api\n"
        "from ray_tpu_torch.serve import controller, handle, http_proxy\n"
        "from ray_tpu_torch.serve import replica, _telemetry\n"
        "from ray_tpu_torch.util import backoff, overload\n"
        "import ray_tpu_torch.core.streaming\n"
        "FOREIGN = ('jax', 'jaxlib', 'flax', 'optax', 'orbax', 'ray_tpu', "
        "'cloudpickle', 'grpc')\n"
        "bad = [m for m in sys.modules if m.split('.')[0] in FOREIGN]\n"
        "print('foreign', bad)\n"
        "print('sample', device_metrics.sample(), torch.cuda.is_initialized())\n"
        "q = torch.zeros(1, 4, 2, 8)\n"
        "fa.flash_attention(q, q, q, causal=True)\n"
        "print('plain', _build._lib is None and fa.launches == 0)\n"
        "try:\n"
        "    _build.library()\n"
        "except RuntimeError as e:\n"
        "    print('build', 'nvcc' in str(e))\n"
        "sys.path.insert(0, PROBE_DIR)\n"
        "import guard_probe\n"
        "ray_tpu_torch.init(num_cpus=1, num_gpus=0)\n"
        "roots = ray_tpu_torch.get(\n"
        "    ray_tpu_torch.remote(guard_probe.roots).remote())\n"
        "ray_tpu_torch.shutdown()\n"
        "print('worker', sorted(set(roots) & set(FOREIGN)),\n"
        "      'ray_tpu_torch.train' in roots)\n"
    )
    probe = tmp_path_factory.mktemp("guard_probe")
    (probe / "guard_probe.py").write_text(
        "import sys\n\n\n"
        "def roots():\n"
        "    import ray_tpu_torch.core\n"
        "    import ray_tpu_torch.train.trainer  # what a train rank loads\n"
        "    import ray_tpu_torch.serve.replica  # what a replica loads\n"
        "    return sorted({m.split('.')[0] for m in sys.modules}\n"
        "                  | {'ray_tpu_torch.train'} & set(sys.modules))\n")
    code = f"PROBE_DIR = {str(probe)!r}\n" + code
    bare = str(tmp_path_factory.mktemp("no_cuda"))
    env = dict(os.environ, PATH=bare, CUDA_HOME=bare)
    env.pop("PYTHONPATH", None)
    res = subprocess.run([sys.executable, "-c", code], cwd=REPO, env=env,
                         capture_output=True, text=True, timeout=120)
    assert res.returncode == 0, res.stderr
    return res.stdout.splitlines()


def test_import_leaves_jax_and_ray_tpu_out(fresh_import):
    """Neither the driver, after importing every port module (serve's
    included), nor a worker process of the port's runtime, after a task
    that loads the runtime, the trainer and a serve replica's module,
    holds JAX, the JAX package, cloudpickle or grpc."""
    assert "foreign []" in fresh_import
    assert "worker [] True" in fresh_import


def test_device_sampling_does_not_start_cuda(fresh_import):
    """In a process that never touched CUDA, sampling the device gauges
    publishes nothing and leaves CUDA uninitialised."""
    assert "sample [] False" in fresh_import


def test_kernel_modules_import_without_nvcc(fresh_import):
    """The kernel modules import and run their plain versions on CPU
    tensors with no nvcc anywhere; building the library then raises with a
    message that names nvcc instead of falling back."""
    assert "plain True" in fresh_import
    assert "build True" in fresh_import
