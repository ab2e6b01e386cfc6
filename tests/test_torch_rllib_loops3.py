"""RLlib's multi-agent, slate and worker-learner loops on the port's
runtime against the JAX package's on its own, on the CPU: QMIX, MADDPG,
SlateQ, DD-PPO (two workers: every gradient and loss the driver gets
within the stat tolerance, the workers' weights in lockstep within 1e-6)
and A3C with one worker, held as ``tests/test_torch_rllib_loops.py``
holds PPO. Then the asynchronous loops with two runners, whose order is
not fixed: A3C's ``num_grads_applied`` and IMPALA's
``num_batches_consumed`` with finite stats.
"""

import sys

import numpy as np
import pytest

import test_torch_rllib_loops as base
from test_torch_rllib_loops import (  # noqa: F401
    Coop,
    CoopPush,
    RecSys,
    Sign,
    bounded,
    port_rt,
    small,
)


@pytest.fixture(scope="module")
def jax_rt():
    yield from base.jax_fixture([sys.modules[__name__], base])


@pytest.fixture
def both(jax_rt, port_rt):  # noqa: F811
    return {"jax": jax_rt, "port": port_rt}


REPLAY = dict(minibatch_size=16, num_updates_per_iteration=4,
              num_steps_sampled_before_learning_starts=32)


def ddppo(rl):
    config = small(rl.DDPPOConfig(), Sign, lr=5e-3)
    config.sgd_rounds_per_iteration = 2
    return config


def a3c(rl, runners=1):
    config = small(rl.A3CConfig(), Sign, lr=5e-3).env_runners(
        num_env_runners=runners)
    config.grads_per_iteration = 2
    return config


CONFIGS = {
    "qmix": lambda rl: small(
        rl.QMIXConfig(), Coop, lr=3e-3, num_actions=2,
        target_network_update_freq=64, epsilon_timesteps=128, **REPLAY),
    "maddpg": lambda rl: small(
        rl.MADDPGConfig(), CoopPush, lr=3e-3, act_dim=1,
        exploration_noise=0.3, **REPLAY),
    "slateq": lambda rl: small(
        rl.SlateQConfig(), RecSys, lr=3e-3, target_network_update_freq=64,
        epsilon_timesteps=128, **REPLAY),
}


@pytest.mark.parametrize("name", sorted(CONFIGS))
@bounded
def test_loop_matches_jax(name, both):
    jres, pres = base.assert_parity(base.run_both(both, CONFIGS[name]),
                                    name)
    assert all(r["num_learner_updates"] == 4 for r in pres), pres


def lockstep(algo):
    """Every DD-PPO worker holds the same weights (within 1e-6)."""
    import ray_tpu_torch as rt

    w = rt.get([wk.get_weights.remote() for wk in algo.workers])
    for other in w[1:]:
        for k, v in base.flat(w[0]).items():
            np.testing.assert_allclose(base.flat(other)[k], v, atol=1e-6,
                                       rtol=0, err_msg=k)


@pytest.mark.parametrize("name", ["a3c_one_worker", "ddppo"])
@bounded
def test_worker_learner_loop_matches_jax(name, both):
    make = ddppo if name == "ddppo" else a3c
    out = base.run_both(both, make,
                        inspect=lockstep if name == "ddppo" else None)
    jres, pres = base.assert_parity(out, name, later="all")
    if name == "ddppo":
        assert pres[1]["num_env_steps_sampled"] == 2 * 2 * 2 * 32
    else:
        assert [r["num_grads_applied"] for r in pres] == [2, 2]


@pytest.mark.parametrize("name", ["a3c", "impala"])
@bounded
def test_asynchronous_loops_with_two_runners(name, both):
    from ray_tpu_torch import rllib as rl

    if name == "a3c":
        config = a3c(rl, runners=2)
    else:
        config = small(rl.IMPALAConfig(), Sign, lr=5e-3)
    algo = config.build(device="cpu")
    try:
        results = [algo.train() for _ in range(3)]
    finally:
        algo.stop()
    for r in results:
        assert all(np.isfinite(v) for v in r.values()
                   if isinstance(v, float)), r
        if name == "a3c":
            assert r["num_grads_applied"] == 2, r
        else:
            assert 1 <= r["num_batches_consumed"] <= 2, r
