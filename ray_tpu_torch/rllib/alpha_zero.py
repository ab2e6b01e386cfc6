"""AlphaZero's net: MCTS self-play with a learned policy/value network
(counterpart of ``ray_tpu/rllib/alpha_zero.py``'s ``TicTacToe``,
``_forward``, ``MCTS``, ``_SelfPlayActor`` and ``AlphaZeroConfig``, and of
the update ``AlphaZero._build_learner`` builds).

Ref analogue: rllib/algorithms/alpha_zero (Silver 2017). Self-play actors
run PUCT tree search at every move (priors and leaf values from the
current network, Dirichlet noise at the root) and emit (state, visit-count
policy, final outcome) triples; the learner fits the network to the
search policies (cross-entropy) and the outcomes (value MSE). The game,
the search and the self-play actor are the JAX package's numpy, copied.
The JAX package builds its update inside ``AlphaZero``, whose constructor
starts remote self-play actors; here the update is ``AlphaZeroLearner``,
on the card, and ``AlphaZeroConfig.build()`` raises until the port has the
actor runtime. A caller drives ``_SelfPlayActor`` and the learner in its
own process.
"""

from __future__ import annotations

import math
import pickle
from typing import Dict, List, Optional, Tuple

import numpy as np
import torch
import torch.nn.functional as F

from .._device import DeviceLike, resolve_device
from ..train.optim import AdamW
from .algorithm import AlgorithmConfig
from .core import (
    RLModule,
    to_device,
    to_floats,
    tree_to_device,
    tree_to_numpy,
    value_and_grad,
)
from .policy import init_mlp_params


class TicTacToe:
    """Canonical two-player game: board from the CURRENT player's view
    (+1 own, -1 opponent); terminal value from the current player's
    view."""

    NUM_ACTIONS = 9
    OBS_DIM = 9

    def initial_state(self) -> np.ndarray:
        return np.zeros(9, np.float32)

    def legal_actions(self, s: np.ndarray) -> np.ndarray:
        return np.flatnonzero(s == 0)

    def next_state(self, s: np.ndarray, a: int) -> np.ndarray:
        out = -s.copy()          # flip perspective to the next player
        out[a] = -1.0            # the move just made is the opponent's
        return out

    _LINES = [(0, 1, 2), (3, 4, 5), (6, 7, 8), (0, 3, 6), (1, 4, 7),
              (2, 5, 8), (0, 4, 8), (2, 4, 6)]

    def terminal_value(self, s: np.ndarray) -> Optional[float]:
        """None if non-terminal; else value for the player TO MOVE."""
        for i, j, k in self._LINES:
            tot = s[i] + s[j] + s[k]
            if tot == 3.0:
                return 1.0       # current player already won (cannot
            if tot == -3.0:      # happen by alternation) / lost
                return -1.0
        if not (s == 0).any():
            return 0.0
        return None


def _forward(weights, s: np.ndarray) -> Tuple[np.ndarray, float]:
    h = s
    for W, b in weights["trunk"]:
        h = np.tanh(h @ W + b)
    (Wp, bp), = weights["pi"]
    (Wv, bv), = weights["vf"]
    logits = h @ Wp + bp
    return logits, float(np.tanh(h @ Wv + bv)[0])


class MCTS:
    """PUCT search (ref: rllib/algorithms/alpha_zero/mcts.py)."""

    def __init__(self, game, weights, *, num_simulations: int = 48,
                 c_puct: float = 1.5, dirichlet_alpha: float = 0.6,
                 noise_eps: float = 0.25,
                 rng: Optional[np.random.RandomState] = None):
        self.game = game
        self.weights = weights
        self.n_sim = num_simulations
        self.c = c_puct
        self.alpha = dirichlet_alpha
        self.eps = noise_eps
        self.rng = rng or np.random.RandomState(0)

    def search(self, root: np.ndarray,
               add_noise: bool = True) -> np.ndarray:
        """Visit-count policy over actions after n_sim simulations."""
        g = self.game
        # Tree keyed by state bytes: stats per node.
        P: Dict[bytes, np.ndarray] = {}
        N: Dict[bytes, np.ndarray] = {}
        W: Dict[bytes, np.ndarray] = {}

        def expand(s) -> float:
            """Add leaf; returns value for the player to move at s."""
            key = s.tobytes()
            term = g.terminal_value(s)
            if term is not None:
                return term
            logits, v = _forward(self.weights, s)
            legal = g.legal_actions(s)
            p = np.zeros(g.NUM_ACTIONS)
            ex = np.exp(logits[legal] - logits[legal].max())
            p[legal] = ex / ex.sum()
            P[key] = p
            N[key] = np.zeros(g.NUM_ACTIONS)
            W[key] = np.zeros(g.NUM_ACTIONS)
            return v

        def simulate(s) -> float:
            key = s.tobytes()
            term = g.terminal_value(s)
            if term is not None:
                return term
            if key not in P:
                return expand(s)
            legal = g.legal_actions(s)
            n, w, p = N[key], W[key], P[key]
            q = np.where(n > 0, w / np.maximum(n, 1), 0.0)
            u = self.c * p * math.sqrt(n.sum() + 1) / (1 + n)
            scores = np.full(g.NUM_ACTIONS, -np.inf)
            scores[legal] = q[legal] + u[legal]
            a = int(np.argmax(scores))
            # Child value is from the OPPONENT's view -> negate.
            v = -simulate(g.next_state(s, a))
            n[a] += 1
            w[a] += v
            return v

        expand(root)
        key = root.tobytes()
        if add_noise and key in P:
            legal = g.legal_actions(root)
            noise = self.rng.dirichlet(
                [self.alpha] * len(legal)
            )
            P[key][legal] = (1 - self.eps) * P[key][legal] \
                + self.eps * noise
        for _ in range(self.n_sim):
            simulate(root)
        visits = N[key]
        total = visits.sum()
        if total == 0:
            legal = self.game.legal_actions(root)
            pi = np.zeros(self.game.NUM_ACTIONS)
            pi[legal] = 1.0 / len(legal)
            return pi
        return visits / total


class _SelfPlayActor:
    def __init__(self, game_blob: bytes, num_simulations: int,
                 seed: int):
        # The game class pickled by reference (pickle or cloudpickle, for
        # a class a module defines).
        self.game = pickle.loads(game_blob)()
        self.n_sim = num_simulations
        self.rng = np.random.RandomState(seed)
        self.weights = None

    def set_weights(self, w):
        self.weights = w

    def play_games(self, n: int, temperature_moves: int = 4):
        """n self-play games -> (states, pis, zs) arrays."""
        states, pis = [], []
        zs: List[float] = []
        for _ in range(n):
            s = self.game.initial_state()
            mcts = MCTS(self.game, self.weights,
                        num_simulations=self.n_sim, rng=self.rng)
            traj_start = len(states)
            move = 0
            while True:
                term = self.game.terminal_value(s)
                if term is not None:
                    # negamax back-fill: v(s) = -v(next_state), so a
                    # state k moves before terminal scores
                    # term * (-1)^k from ITS mover's view.
                    d = len(states) - traj_start
                    for j in range(d):
                        zs.append(term * ((-1.0) ** (d - j)))
                    break
                pi = mcts.search(s)
                states.append(s.copy())
                pis.append(pi)
                if move < temperature_moves:
                    a = int(self.rng.choice(len(pi), p=pi))
                else:
                    a = int(np.argmax(pi))
                s = self.game.next_state(s, a)
                move += 1
        return (np.stack(states), np.stack(pis),
                np.asarray(zs, np.float32))


class AlphaZeroConfig(AlgorithmConfig):
    def __init__(self):
        super().__init__()
        self.lr = 3e-3
        self.game = TicTacToe
        self.num_simulations: int = 48
        self.games_per_iteration: int = 12
        self.replay_window: int = 4_000     # positions
        self.train_batches_per_iteration: int = 16
        self.hidden_size = 64


def init_weights(config: AlphaZeroConfig):
    """The network's numpy weights, drawn from the config's seed as
    ``AlphaZero.__init__`` draws them in the JAX package."""
    game = config.game()
    rng = np.random.RandomState(config.seed)
    return {
        "trunk": init_mlp_params(
            rng, [game.OBS_DIM, config.hidden_size, config.hidden_size]
        ),
        "pi": init_mlp_params(rng, [config.hidden_size,
                                    game.NUM_ACTIONS]),
        "vf": init_mlp_params(rng, [config.hidden_size, 1]),
    }


class AlphaZeroLearner:
    """The network's update on the card: a tanh trunk, the policy's
    cross-entropy against the search's visit distribution, and the tanh
    value's MSE against the outcome."""

    def __init__(self, config: AlphaZeroConfig,
                 device: DeviceLike = None):
        self.device = resolve_device(device)
        self._params = tree_to_device(init_weights(config), self.device)
        self._opt = AdamW(config.lr, weight_decay=0.0)  # optax.adam(lr)
        self._opt_state = self._opt.init(self._params)

    @staticmethod
    def _loss(p, s, pi, z):
        h = RLModule.mlp(p["trunk"], s)
        (Wp, bp), = p["pi"]
        (Wv, bv), = p["vf"]
        logp = F.log_softmax(h @ Wp + bp, dim=-1)
        v = torch.tanh(h @ Wv + bv)[:, 0]
        pi_loss = -(pi * logp).sum(-1).mean()
        v_loss = ((v - z) ** 2).mean()
        return pi_loss + v_loss, {"policy_loss": pi_loss.detach(),
                                  "value_loss": v_loss.detach()}

    def update_device(self, s, pi, z) -> Dict[str, torch.Tensor]:
        """One step on (states, visit policies, outcomes); the stats stay
        on the device."""
        dev = self.device
        (loss, stats), grads = value_and_grad(
            self._loss, self._params, to_device(s, dev),
            to_device(pi, dev), to_device(z, dev))
        self._opt.update(self._params, grads, self._opt_state)
        return {"total_loss": loss, **stats}

    def update(self, s, pi, z) -> Dict[str, float]:
        return to_floats(self.update_device(s, pi, z))

    def get_weights(self):
        return tree_to_numpy(self._params)

    def set_weights(self, weights):
        self._params = tree_to_device(weights, self.device)
