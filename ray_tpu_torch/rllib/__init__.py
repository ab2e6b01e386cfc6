"""ray_tpu_torch.rllib: RLlib's learner layer on the card (the
counterpart of ``ray_tpu.rllib``'s learners).

The learners (PPO, A2C, PG, IMPALA, DQN, DDPG, TD3, SAC) take numpy
batches and numpy weights and run their updates with PyTorch on the CUDA
card (``device="cpu"`` to run on the CPU). The rollout plane
(``EnvRunner``, the numpy policies, the replay buffers) is the JAX
package's, copied. The algorithms' sampling loops stand on the actor
runtime, which is not ported: ``*Config.build()`` and
``LearnerGroup(remote=True)`` raise.
"""

from ..util import usage_stats as _usage
from .a2c import A2CConfig, A2CLearner  # noqa: F401
from .algorithm import AlgorithmConfig  # noqa: F401
from .core import (  # noqa: F401
    ActorCriticModule,
    DeterministicActorModule,
    Learner,
    LearnerGroup,
    QModule,
    RLModule,
    TwinCriticLearner,
)
from .ddpg import DDPGConfig, DDPGLearner  # noqa: F401
from .dqn import DQNConfig, DQNLearner  # noqa: F401
from .env_runner import EnvRunner, TransitionEnvRunner  # noqa: F401
from .impala import IMPALAConfig, IMPALALearner  # noqa: F401
from .pg import PGConfig, PGLearner  # noqa: F401
from .policy import MLPPolicy  # noqa: F401
from .ppo import PPOConfig, PPOLearner  # noqa: F401
from .replay_buffers import (  # noqa: F401
    PrioritizedReplayBuffer,
    ReplayBuffer,
)
from .sac import SACConfig, SACLearner  # noqa: F401
from .sample_batch import SampleBatch, compute_gae  # noqa: F401
from .td3 import TD3Config, TD3Learner  # noqa: F401

_usage.record_library_usage("rllib")
