"""ray_tpu_torch.rllib: reinforcement learning on the port's runtime (the
counterpart of ``ray_tpu.rllib``): CPU EnvRunner actors and a PyTorch
learner on the card.

``*Config().environment(...)....build()`` returns the algorithm; each
``train()`` samples the runner actors, updates the learner (on the card
in the driver unless ``build(device="cpu")``) and broadcasts its weights.
The online algorithms are PPO, A2C, PG, IMPALA, DQN, DDPG, TD3, SAC,
R2D2, recurrent PPO, QMIX, MADDPG, SlateQ, AlphaZero, DD-PPO and A3C;
the offline ones (BC, MARWIL, CQL, CRR, DT) train from any dataset object
with ``iter_batches``. ``LearnerGroup(remote=True)`` runs a learner in an
actor. Envs, learner factories and games travel to the actors by
reference: define them at module level in a module the workers can
import.

Importing this package imports no torch: the numpy rollout plane
(``EnvRunner``, the policies, the replay buffers) loads at once, and the
torch-backed names load on first use, so a runner actor's worker starts
without torch.
"""

import importlib

from ..util import usage_stats as _usage
from .algorithm import Algorithm, AlgorithmConfig  # noqa: F401
from .env_runner import EnvRunner, TransitionEnvRunner  # noqa: F401
from .policy import MLPPolicy  # noqa: F401
from .replay_buffers import (  # noqa: F401
    PrioritizedReplayBuffer,
    ReplayBuffer,
)
from .sample_batch import SampleBatch, compute_gae  # noqa: F401

_LAZY = {
    **dict.fromkeys(("A2C", "A2CConfig", "A2CLearner"), "a2c"),
    **dict.fromkeys(("A3C", "A3CConfig"), "a3c"),
    **dict.fromkeys(("AlphaZero", "AlphaZeroConfig", "AlphaZeroLearner",
                     "MCTS", "TicTacToe"), "alpha_zero"),
    **dict.fromkeys(("BC", "BCConfig"), "bc"),
    **dict.fromkeys(("ActorCriticModule", "DeterministicActorModule",
                     "Learner", "LearnerGroup", "QModule", "RLModule",
                     "TwinCriticLearner"), "core"),
    **dict.fromkeys(("CQL", "CQLConfig", "CQLLearner"), "cql"),
    **dict.fromkeys(("CRR", "CRRConfig", "CRRLearner"), "crr"),
    **dict.fromkeys(("DDPG", "DDPGConfig", "DDPGLearner"), "ddpg"),
    **dict.fromkeys(("DDPPO", "DDPPOConfig"), "ddppo"),
    **dict.fromkeys(("DQN", "DQNConfig", "DQNLearner"), "dqn"),
    **dict.fromkeys(("DT", "DTConfig", "DTLearner"), "dt"),
    **dict.fromkeys(("IMPALA", "IMPALAConfig", "IMPALALearner"), "impala"),
    **dict.fromkeys(("MADDPG", "MADDPGConfig", "MADDPGLearner"), "maddpg"),
    **dict.fromkeys(("MARWIL", "MARWILConfig", "MARWILLearner"), "marwil"),
    **dict.fromkeys(("PG", "PGConfig", "PGLearner"), "pg"),
    **dict.fromkeys(("PPO", "PPOConfig", "PPOLearner"), "ppo"),
    **dict.fromkeys(("QMIX", "QMIXConfig", "QMIXLearner"), "qmix"),
    **dict.fromkeys(("R2D2", "R2D2Config", "R2D2Learner"), "r2d2"),
    **dict.fromkeys(("RecurrentPPO", "RecurrentPPOConfig",
                     "RecurrentPPOLearner"), "recurrent_ppo"),
    **dict.fromkeys(("SAC", "SACConfig", "SACLearner"), "sac"),
    **dict.fromkeys(("SlateQ", "SlateQConfig", "SlateQLearner"), "slateq"),
    **dict.fromkeys(("TD3", "TD3Config", "TD3Learner"), "td3"),
}


def __getattr__(name):
    module = _LAZY.get(name)
    if module is None:
        raise AttributeError(f"module {__name__!r} has no attribute {name!r}")
    return getattr(importlib.import_module(f".{module}", __name__), name)


def __dir__():
    return sorted(list(globals()) + list(_LAZY))


_usage.record_library_usage("rllib")
