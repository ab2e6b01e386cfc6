"""ray_tpu_torch.rllib: RLlib's learner layer on the card (the
counterpart of ``ray_tpu.rllib``'s learners).

The learners (PPO, A2C, PG, IMPALA, DQN, DDPG, TD3, SAC, R2D2, recurrent
PPO, MARWIL, CQL, CRR, DT, QMIX, MADDPG, SlateQ, BC's and AlphaZero's
updates) take numpy batches and numpy weights and run their updates with
PyTorch on the CUDA card (``device="cpu"`` to run on the CPU). The rollout
plane (``EnvRunner``, the recurrent, multi-agent and slate runners, the
numpy policies, the replay buffers, the MCTS self-play) is the JAX
package's, copied. The offline algorithms (BC, MARWIL, CQL, CRR, DT) train
from any dataset object with ``iter_batches``: their ``*Config.build()``
returns the algorithm. The online algorithms' sampling loops stand on the
actor runtime; the port's runtime (``core``) does not carry them yet, so
their ``*Config.build()`` and ``LearnerGroup(remote=True)`` raise.
"""

from ..util import usage_stats as _usage
from .a2c import A2CConfig, A2CLearner  # noqa: F401
from .algorithm import AlgorithmConfig  # noqa: F401
from .alpha_zero import (  # noqa: F401
    MCTS,
    AlphaZeroConfig,
    AlphaZeroLearner,
    TicTacToe,
)
from .bc import BC, BCConfig  # noqa: F401
from .core import (  # noqa: F401
    ActorCriticModule,
    DeterministicActorModule,
    Learner,
    LearnerGroup,
    QModule,
    RLModule,
    TwinCriticLearner,
)
from .cql import CQL, CQLConfig, CQLLearner  # noqa: F401
from .crr import CRR, CRRConfig, CRRLearner  # noqa: F401
from .ddpg import DDPGConfig, DDPGLearner  # noqa: F401
from .dqn import DQNConfig, DQNLearner  # noqa: F401
from .dt import DT, DTConfig, DTLearner  # noqa: F401
from .env_runner import EnvRunner, TransitionEnvRunner  # noqa: F401
from .impala import IMPALAConfig, IMPALALearner  # noqa: F401
from .maddpg import MADDPGConfig, MADDPGLearner  # noqa: F401
from .marwil import MARWIL, MARWILConfig, MARWILLearner  # noqa: F401
from .pg import PGConfig, PGLearner  # noqa: F401
from .policy import MLPPolicy  # noqa: F401
from .ppo import PPOConfig, PPOLearner  # noqa: F401
from .qmix import QMIXConfig, QMIXLearner  # noqa: F401
from .r2d2 import R2D2Config, R2D2Learner  # noqa: F401
from .recurrent_ppo import (  # noqa: F401
    RecurrentPPOConfig,
    RecurrentPPOLearner,
)
from .replay_buffers import (  # noqa: F401
    PrioritizedReplayBuffer,
    ReplayBuffer,
)
from .sac import SACConfig, SACLearner  # noqa: F401
from .sample_batch import SampleBatch, compute_gae  # noqa: F401
from .slateq import SlateQConfig, SlateQLearner  # noqa: F401
from .td3 import TD3Config, TD3Learner  # noqa: F401

_usage.record_library_usage("rllib")
