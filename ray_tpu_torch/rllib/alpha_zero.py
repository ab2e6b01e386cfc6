"""AlphaZero: MCTS self-play with a learned policy/value network
(counterpart of ``ray_tpu/rllib/alpha_zero.py``).

Ref analogue: rllib/algorithms/alpha_zero (Silver 2017). Self-play actors
run PUCT tree search at every move (priors and leaf values from the
current network, Dirichlet noise at the root) and emit (state, visit-count
policy, final outcome) triples; the learner fits the network to the
search policies (cross-entropy) and the outcomes (value MSE); fresh
weights broadcast back. The game, the search and the self-play actor are
the JAX package's numpy, copied. The JAX package builds its update inside
``AlphaZero``; here it is ``AlphaZeroLearner``, on the card, which
``AlphaZero`` drives. The game class travels to the actors by reference:
it must be importable at module level.
"""

from __future__ import annotations

import math
import pickle
from typing import Any, Dict, List, Optional, Tuple

import numpy as np
import torch
import torch.nn.functional as F

from .._device import DeviceLike, resolve_device
from ..core.reference import dumps_with_refs
from ..train.optim import AdamW
from .algorithm import AlgorithmConfig, stop_actors
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

    def build(self, device: DeviceLike = None) -> "AlphaZero":
        return AlphaZero(self.copy(), device)


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


class AlphaZero:
    def __init__(self, config: AlphaZeroConfig, device: DeviceLike = None):
        import ray_tpu_torch as rt

        self.config = config
        self.iteration = 0
        c = config
        game = c.game()
        self._obs_dim = game.OBS_DIM
        self._num_actions = game.NUM_ACTIONS
        self.weights = init_weights(c)
        # By reference; a game class a worker could not import raises
        # TypeError naming it here.
        blob, _ = dumps_with_refs(c.game)
        actor_cls = rt.remote(_SelfPlayActor)
        self.actors = [
            actor_cls.remote(blob, c.num_simulations, c.seed + i)
            for i in range(c.num_env_runners)
        ]
        self._replay: List[Tuple[np.ndarray, np.ndarray, np.ndarray]] \
            = []
        self.learner = AlphaZeroLearner(c, device)
        self.device = self.learner.device
        self._rng = np.random.RandomState(c.seed + 17)

    def train(self) -> Dict[str, Any]:
        import ray_tpu_torch as rt

        self.iteration += 1
        c = self.config
        rt.get([a.set_weights.remote(self.weights) for a in self.actors])
        per = max(1, c.games_per_iteration // len(self.actors))
        results = rt.get([a.play_games.remote(per) for a in self.actors])
        new_positions = 0
        for s, pi, z in results:
            self._replay.append((s, pi, z))
            new_positions += len(s)
        # Bound the replay window by positions.
        while sum(len(r[0]) for r in self._replay) > c.replay_window \
                and len(self._replay) > 1:
            self._replay.pop(0)

        S = np.concatenate([r[0] for r in self._replay])
        PI = np.concatenate([r[1] for r in self._replay])
        Z = np.concatenate([r[2] for r in self._replay])
        stats = {"total_loss": float("nan"), "policy_loss": float("nan"),
                 "value_loss": float("nan")}
        for _ in range(c.train_batches_per_iteration):
            idx = self._rng.randint(0, len(S),
                                    min(c.minibatch_size, len(S)))
            stats = self.learner.update(S[idx], PI[idx], Z[idx])
        self.weights = self.learner.get_weights()
        return {
            "training_iteration": self.iteration,
            "num_positions": len(S),
            "new_positions": new_positions,
            "total_loss": stats["total_loss"],
            "policy_loss": stats["policy_loss"],
            "value_loss": stats["value_loss"],
        }

    def get_weights(self):
        return self.weights

    def compute_action(self, state: np.ndarray, *,
                       use_mcts: bool = True,
                       num_simulations: Optional[int] = None) -> int:
        """Greedy play with the current net (optionally MCTS-backed)."""
        game = self.config.game()
        if use_mcts:
            mcts = MCTS(
                game, self.weights,
                num_simulations=(num_simulations
                                 or self.config.num_simulations),
                rng=self._rng,
            )
            return int(np.argmax(mcts.search(state, add_noise=False)))
        logits, _ = _forward(self.weights, state)
        legal = game.legal_actions(state)
        scores = np.full(game.NUM_ACTIONS, -np.inf)
        scores[legal] = logits[legal]
        return int(np.argmax(scores))

    def stop(self):
        stop_actors(self.actors)
