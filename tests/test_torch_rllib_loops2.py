"""RLlib's replay and recurrent loops on the port's runtime against the JAX
package's on its own, on the CPU: DQN (prioritized with dueling heads and
3-step returns, and plain), DDPG, TD3, SAC, R2D2 and recurrent PPO, held
as ``tests/test_torch_rllib_loops.py`` holds PPO (its envs, helpers and
tolerances). Each loop learns from iteration 1: the warm-up is one
iteration's steps.
"""

import sys

import pytest

import test_torch_rllib_loops as base
from test_torch_rllib_loops import (  # noqa: F401
    GoToZero,
    Memory,
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

CONFIGS = {
    "dqn_prioritized_dueling_nstep": lambda rl: small(
        rl.DQNConfig(), Sign, lr=3e-3, target_network_update_freq=64,
        epsilon_timesteps=128, prioritized_replay=True, dueling=True,
        n_step=3, **REPLAY),
    "dqn_plain": lambda rl: small(
        rl.DQNConfig(), Sign, lr=3e-3, target_network_update_freq=64,
        epsilon_timesteps=128, **REPLAY),
    "ddpg": lambda rl: small(rl.DDPGConfig(), GoToZero, lr=3e-3,
                             exploration_noise=0.2, **REPLAY),
    "td3": lambda rl: small(rl.TD3Config(), GoToZero, lr=3e-3,
                            exploration_noise=0.2, **REPLAY),
    "sac": lambda rl: small(rl.SACConfig(), GoToZero, **REPLAY),
    "r2d2": lambda rl: small(
        rl.R2D2Config(), Memory, lr=3e-3, seq_len=8, lstm_size=16,
        target_network_update_freq=64, epsilon_timesteps=128,
        **dict(REPLAY, minibatch_size=8)),
    "recurrent_ppo": lambda rl: small(
        rl.RecurrentPPOConfig(), Memory, lr=3e-3, seq_len=8, lstm_size=16,
        minibatch_size=32, num_epochs=2),
}


@pytest.mark.parametrize("name", sorted(CONFIGS))
@bounded
def test_loop_matches_jax(name, both):
    jres, pres = base.assert_parity(base.run_both(both, CONFIGS[name]),
                                    name)
    if "num_learner_updates" in pres[0]:
        assert all(r["num_learner_updates"] == 4 for r in pres), pres
