"""The port's remaining RLlib learners (``ray_tpu_torch/rllib``: R2D2,
recurrent PPO, BC, MARWIL, CQL, CRR, DT, QMIX, MADDPG, SlateQ and
AlphaZero's net) against the JAX package's (``ray_tpu/rllib``), on the CPU.

Both packages get the same seeded numpy batches (``chip_smoke``'s
``rl_more_batch``, at width 16 and 8 to 32 rows here) and start from the
same numpy weights, bitwise, in float32. Each learner's stats must agree
within 1e-5 relative (plus 1e-6 absolute) on each of three updates, and
its weights and targets within 1e-4 after the third; the discrete choices
an update turns on (R2D2's double-Q pick, QMIX's greedy target actions,
SlateQ's next slate, CRR's binary weights) must be equal before its values
are compared. DT's key biases (the middle third of each qkv bias) are
the one exception to the weight bound: their gradient is zero in exact
arithmetic (softmax ignores a shift shared by a row's logits), so each
package's Adam moves them by its own rounding noise, and they are held by
their effect on the logits instead. The copied numpy code (the LSTM cell, the runners, MCTS,
TicTacToe, self-play) must agree bitwise; the offline algorithms (BC, MARWIL,
CQL, CRR, DT) must give the same ``train()`` results iteration for
iteration on one in-process dataset. The JAX learners run as their own
tests run them, without a runtime; AlphaZero's update is reached on a bare
``AlphaZero.__new__`` instance with ``config`` and ``weights`` set.
"""

import importlib.util
import os
import pickle

import cloudpickle
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import ray_tpu.rllib
from ray_tpu.rllib import alpha_zero as j_az
from ray_tpu.rllib import bc as j_bc
from ray_tpu.rllib import core as j_core
from ray_tpu.rllib import cql as j_cql
from ray_tpu.rllib import crr as j_crr
from ray_tpu.rllib import dt as j_dt
from ray_tpu.rllib import maddpg as j_maddpg
from ray_tpu.rllib import marwil as j_marwil
from ray_tpu.rllib import policy as j_policy
from ray_tpu.rllib import qmix as j_qmix
from ray_tpu.rllib import r2d2 as j_r2d2
from ray_tpu.rllib import recurrent_ppo as j_rppo
from ray_tpu.rllib import slateq as j_slateq
from ray_tpu_torch import rllib as trl
from ray_tpu_torch.rllib import alpha_zero as t_az
from ray_tpu_torch.rllib import core as t_core
from ray_tpu_torch.rllib import policy as t_policy
from ray_tpu_torch.rllib import qmix as t_qmix
from ray_tpu_torch.rllib import r2d2 as t_r2d2
from ray_tpu_torch.rllib import maddpg as t_maddpg
from ray_tpu_torch.rllib import recurrent_ppo as t_rppo
from ray_tpu_torch.rllib import slateq as t_slateq

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
_spec = importlib.util.spec_from_file_location(
    "chip_smoke", os.path.join(REPO, "chip_smoke.py"))
chip_smoke = importlib.util.module_from_spec(_spec)
_spec.loader.exec_module(chip_smoke)
NumpyDataset = chip_smoke.NumpyDataset

H = 16
STAT_RTOL, STAT_ATOL, W_TOL = 1e-5, 1e-6, 1e-4
KINDS = chip_smoke.RL_MORE_KINDS
SEQ_KINDS = ("r2d2", "recurrent_ppo", "dt")


def _flat(tree, prefix=""):
    """{path: numpy array} of a tree of dicts, lists and tuples."""
    if isinstance(tree, dict):
        return {k: v for key in sorted(tree)
                for k, v in _flat(tree[key], f"{prefix}{key}.").items()}
    if isinstance(tree, (list, tuple)):
        return {k: v for i, sub in enumerate(tree)
                for k, v in _flat(sub, f"{prefix}{i}.").items()}
    if isinstance(tree, torch.Tensor):
        tree = tree.detach().numpy()
    return {prefix[:-1]: np.asarray(tree)}


def _floats(stats):
    return {k: float(v) for k, v in stats.items()}


def _assert_stats_close(got, want, what):
    assert got.keys() == want.keys(), (what, got.keys(), want.keys())
    for k, w in want.items():
        assert abs(got[k] - w) <= STAT_RTOL * abs(w) + STAT_ATOL, (
            what, k, got[k], w)


def _assert_trees_close(got, want, tol, what):
    got, want = _flat(got), _flat(want)
    assert got.keys() == want.keys(), (what, got.keys(), want.keys())
    for k, w in want.items():
        assert got[k].shape == w.shape, (what, k)
        if tol == 0:
            np.testing.assert_array_equal(got[k], w, err_msg=f"{what} {k}")
        else:
            d = float(np.abs(got[k] - w).max()) if w.size else 0.0
            assert d <= tol, (what, k, d)


# ------------------------------------------------------------ numpy modules

class Memory:
    """A numpy memory task: the cue (+-1) shows at the first step only;
    the action must match its sign. Episodes end by termination after 5
    steps when the cue is -1, else by truncation after 7."""

    def reset(self, seed=None):
        if seed is not None or not hasattr(self, "rng"):
            self.rng = np.random.RandomState(seed)
        self.t, self.cue = 0, float(self.rng.choice([-1.0, 1.0]))
        return np.float32([self.cue, 1.0]), {}

    def step(self, action):
        r = 1.0 if int(action) == (self.cue > 0) else -1.0
        self.t += 1
        return (np.float32([0.0, 0.0]), r, self.cue < 0 and self.t >= 5,
                self.t >= 7, {})


class Coop:
    """Two agents each see a signal; the team earns one per agent whose
    discrete action matches its signal's sign (a Box action within 0.5 of
    the signal when ``box``), one more when both do; 9 steps."""

    def __init__(self, box=False):
        self.box = box

    def _obs(self):
        self.sig = self.rng.uniform(-1, 1, 2)
        return {f"a{i}": np.float32([self.sig[i], 0.5]) for i in range(2)}

    def reset(self, seed=None):
        if seed is not None or not hasattr(self, "rng"):
            self.rng = np.random.RandomState(seed)
        self.t = 0
        return self._obs(), {}

    def step(self, actions):
        if self.box:
            ok = [abs(float(actions[f"a{i}"][0]) - self.sig[i]) < 0.5
                  for i in range(2)]
        else:
            ok = [int(actions[f"a{i}"]) == (self.sig[i] > 0)
                  for i in range(2)]
        team = sum(ok) + float(all(ok))
        self.t += 1
        return (self._obs(), {f"a{i}": team / 2 for i in range(2)},
                {"__all__": self.t >= 9}, {"__all__": False}, {})


class RecSys:
    """A numpy recsys: 12 items of 4 features, slates of 3, clicks by a
    conditional logit with a no-click option, truncated at 10 steps."""
    num_items, slate_size = 12, 3
    item_features = chip_smoke.RL_SLATE_ITEMS

    def _user(self):
        u = self.rng.randn(4)
        self.taste = (u / np.linalg.norm(u)).astype(np.float32)
        return self.taste

    def reset(self, seed=None):
        if seed is not None or not hasattr(self, "rng"):
            self.rng = np.random.RandomState(seed)
        self.t = 0
        return self._user(), {}

    def step(self, slate):
        al = self.item_features[np.asarray(slate)] @ self.taste
        ex = np.exp(al - al.max())
        p = ex / (ex.sum() + np.exp(-al.max()))
        j = int(np.searchsorted(np.cumsum(p), self.rng.rand(), "right"))
        clicked, r = (int(slate[j]), float(al[j])) if j < 3 else (-1, 0.0)
        self.t += 1
        return self._user(), r, False, self.t >= 10, {"clicked": clicked}


def test_lstm_step_np_is_bitwise_equal():
    rng = np.random.RandomState(0)
    w = j_r2d2._init_params(3, 2, 8, 0)
    for shape in ((8,), (5, 8)):
        x = rng.randn(*shape[:-1], 3).astype(np.float32)
        h, c = (rng.randn(*shape).astype(np.float32) for _ in range(2))
        _assert_trees_close(t_r2d2._lstm_step_np(w, x, h, c),
                            j_r2d2._lstm_step_np(w, x, h, c), 0, shape)
    _assert_trees_close(t_r2d2._init_params(3, 2, 8, 0), w, 0, "r2d2 init")
    _assert_trees_close(t_rppo._init_params(3, 2, 8, 0),
                        j_rppo._init_params(3, 2, 8, 0), 0, "rppo init")


def _runner(pkg, kind):
    t = pkg == "torch"
    if kind == "r2d2":
        mod = t_r2d2 if t else j_r2d2

        def pol():
            p = mod._R2D2Policy(2, 2, 8, 0)
            p.set_epsilon(0.3)
            return p
        return mod._R2D2EnvRunner(Memory, pol, seed=3,
                                  rollout_fragment_length=40, seq_len=6)
    if kind == "recurrent":
        mod = t_rppo if t else j_rppo
        return mod._RecurrentEnvRunner(
            Memory, lambda: mod._LSTMAcPolicy(2, 2, 8, 0), seed=3,
            rollout_fragment_length=40, seq_len=6)
    if kind == "qmix":
        mod, pmod = (t_qmix, t_policy) if t else (j_qmix, j_policy)

        def pol():
            p = pmod.QPolicy(2, 2, 8, 0)
            p.set_epsilon(0.3)
            return p
        return mod._QMIXEnvRunner(Coop, pol, ["a0", "a1"], seed=3,
                                  rollout_fragment_length=30)
    if kind == "maddpg":
        mod = t_maddpg if t else j_maddpg
        return mod._MADDPGEnvRunner(
            lambda: Coop(box=True), ["a0", "a1"], 2, 1, [-1.0], [1.0], 8,
            0.2, seed=3, rollout_fragment_length=30)
    mod = t_slateq if t else j_slateq

    def pol():
        p = mod._SlatePolicy(4, 4, 12, 3, 8, 0)
        p.set_epsilon(0.3)
        return p
    return mod._SlateEnvRunner(RecSys, pol, seed=3,
                               rollout_fragment_length=30)


@pytest.mark.parametrize("kind", ["r2d2", "recurrent", "qmix", "maddpg",
                                  "slate"])
def test_runners_sample_equal_batches(kind):
    """Each copied runner against its JAX twin, same env, policy and
    seed: three fragments (weights changed between the second and third),
    equal column for column, and equal episode stats."""
    out = {}
    for pkg in ("jax", "torch"):
        r = _runner(pkg, kind)
        frags = [dict(r.sample()) for _ in range(2)]
        if kind == "maddpg":
            r.set_weights([{k: [(W * 1.5, b + 0.1) for W, b in v]
                            for k, v in w.items()} for w in r.weights])
        else:
            w = r.policy.weights
            r.set_weights({k: v * 1.5 if isinstance(v, np.ndarray) else
                           [(W * 1.5, b + 0.1) for W, b in v]
                           for k, v in w.items()})
        frags.append(dict(r.sample()))
        out[pkg] = (frags, r.episode_stats())
    _assert_trees_close(out["torch"][0], out["jax"][0], 0, kind)
    assert out["torch"][1] == out["jax"][1]
    assert out["jax"][1]["episodes_total"] > 0


def test_tictactoe_and_mcts_are_bitwise_equal():
    """TicTacToe's moves and terminal values over random games, MCTS's
    visit policies (with and without root noise) and two self-play games
    of each package's _SelfPlayActor (its game pickled by reference)."""
    rng = np.random.RandomState(0)
    tg, jg = t_az.TicTacToe(), j_az.TicTacToe()
    for _ in range(20):
        ts, js = tg.initial_state(), jg.initial_state()
        while True:
            assert tg.terminal_value(ts) == jg.terminal_value(js)
            if jg.terminal_value(js) is not None:
                break
            legal = jg.legal_actions(js)
            np.testing.assert_array_equal(tg.legal_actions(ts), legal)
            a = int(rng.choice(legal))
            ts, js = tg.next_state(ts, a), jg.next_state(js, a)
            np.testing.assert_array_equal(ts, js)
    cfg = trl.AlphaZeroConfig()
    cfg.hidden_size = H
    w = t_az.init_weights(cfg)
    s = jg.next_state(jg.next_state(jg.initial_state(), 4), 0)
    for noise in (True, False):
        got = t_az.MCTS(tg, w, num_simulations=24,
                        rng=np.random.RandomState(1)).search(s, noise)
        want = j_az.MCTS(jg, w, num_simulations=24,
                         rng=np.random.RandomState(1)).search(s, noise)
        np.testing.assert_array_equal(got, want)
    tp = t_az._SelfPlayActor(pickle.dumps(t_az.TicTacToe), 8, 5)
    jp = j_az._SelfPlayActor(cloudpickle.dumps(j_az.TicTacToe), 8, 5)
    tp.set_weights(w)
    jp.set_weights(w)
    _assert_trees_close(tp.play_games(2), jp.play_games(2), 0, "self-play")


# ------------------------------------------------------------------ learners

def _sizes(kind):
    """(rows, width): 8 sequences for the sequence learners, 32 rows for
    the rest, width 16."""
    return (8 if kind in SEQ_KINDS else 32), H


def _batch(kind, i):
    n, hidden = _sizes(kind)
    return chip_smoke.rl_more_batch(kind, n, np.random.RandomState(10 + i),
                                    hidden)


def _jax_learner(kind):
    """(learner, step(batch, i) -> {stat: float}, state() -> tree) of the
    JAX package, run the way its algorithm runs it and as chip_smoke's
    rl_more_learner runs the port's."""
    if kind == "r2d2":
        c = j_r2d2.R2D2Config()
        lrn = j_r2d2.R2D2Learner(4, 2, H, c.lr, c.gamma, c.seed)

        def step(b, i):
            out = {"loss": lrn.learn_on_batch(b)}
            if i == 0:
                lrn.sync_target()
            return out
        return lrn, step, lambda: {"params": lrn._params,
                                   "target": lrn._target}
    if kind == "recurrent_ppo":
        c = j_rppo.RecurrentPPOConfig()
        c.lstm_size = H
        lrn = j_rppo.RecurrentPPOLearner(4, 2, c)
        return (lrn, lambda b, i: {"loss": lrn.learn_on_batch(b)},
                lambda: {"params": lrn._params, "target": {}})
    if kind in ("bc", "bc_continuous"):
        c = j_bc.BCConfig()
        c.hidden_size = H
        if kind == "bc":
            c.num_actions = 2
            probe = {"obs": np.zeros((1, 4), np.float32),
                     "act": np.zeros(1, np.int64)}
        else:
            c.action_space = "continuous"
            probe = {"obs": np.zeros((1, 3), np.float32),
                     "act": np.zeros((1, 1), np.float32)}
        c.offline_data(NumpyDataset(probe), action_column="act")
        lrn = c.build()

        def step(b, i):
            lrn._params, lrn._opt_state, loss = lrn._update(
                lrn._params, lrn._opt_state, jnp.asarray(b["obs"]),
                jnp.asarray(b["act"]))
            return {"loss": float(loss)}
        return lrn, step, lambda: {"params": lrn._params, "target": {}}
    if kind == "marwil":
        c = j_marwil.MARWILConfig()
        lrn = j_marwil.MARWILLearner(
            j_core.ActorCriticModule(4, 2, H, c.seed).init_params(),
            lr=c.lr, beta=c.beta, vf_coeff=c.vf_coeff)
        return lrn, lambda b, i: lrn.update(b), lambda: {
            "params": lrn._params, "target": lrn._target}
    if kind in ("cql", "crr", "crr_binary"):
        c = j_cql.CQLConfig() if kind == "cql" else j_crr.CRRConfig()
        c.hidden_size = H
        if kind == "crr_binary":
            c.weight_type = "binary"
        lrn = (j_cql.CQLLearner if kind == "cql" else j_crr.CRRLearner)(
            c, 3, 1)
        return (lrn, lambda b, i: _floats(lrn.learn_on_batch(b)),
                lambda: {"params": lrn._params, "target": lrn._target})
    if kind == "dt":
        c = j_dt.DTConfig()
        c.num_actions, c.embed_dim = 2, H
        lrn = j_dt.DTLearner(c, 3)
        return (lrn, lambda b, i: {"loss": lrn.train_batch(b)},
                lambda: {"params": lrn._params, "target": {}})
    if kind == "qmix":
        c = j_qmix.QMIXConfig()
        lrn = j_qmix.QMIXLearner(
            j_policy.QPolicy(3, 2, H, c.seed).get_weights(), n_agents=2,
            obs_dim=3, num_actions=2, state_dim=6,
            embed=c.mixing_embed_dim, lr=c.lr, gamma=c.gamma, seed=c.seed)

        def step(b, i):
            out = _floats(lrn.update_qmix(b))
            if i == 0:
                lrn.sync_target()
            return out
        return lrn, step, lambda: {"params": lrn._params,
                                   "target": lrn._target_full}
    if kind == "maddpg":
        c = j_maddpg.MADDPGConfig()
        lrn = j_maddpg.MADDPGLearner(2, 3, 1, H, c.lr, c.tau, c.gamma,
                                     c.seed)
        return (lrn, lambda b, i: _floats(lrn.learn_on_batch(b)),
                lambda: {"params": lrn._params, "target": lrn._target})
    if kind == "slateq":
        c = j_slateq.SlateQConfig()
        lrn = j_slateq.SlateQLearner(
            j_slateq._SlatePolicy(4, 4, 12, 3, H, c.seed),
            chip_smoke.RL_SLATE_ITEMS, 3, c.lr, c.gamma)

        def step(b, i):
            out = {"loss": lrn.learn_on_batch(b)}
            if i == 0:
                lrn.sync_target()
            return out
        return lrn, step, lambda: {"params": lrn._params,
                                   "target": lrn._target}
    c = j_az.AlphaZeroConfig()
    c.hidden_size = H
    lrn = j_az.AlphaZero.__new__(j_az.AlphaZero)
    lrn.config, lrn.weights = c, _jax_alpha_zero_weights(c)
    lrn._build_learner()

    def step(b, i):
        lrn._params, lrn._opt_state, lo, (pl, vl) = lrn._update(
            lrn._params, lrn._opt_state, jnp.asarray(b["s"]),
            jnp.asarray(b["pi"]), jnp.asarray(b["z"]))
        return {"total_loss": float(lo), "policy_loss": float(pl),
                "value_loss": float(vl)}
    return lrn, step, lambda: {"params": lrn._params, "target": {}}


def _jax_alpha_zero_weights(c):
    """The draws of ``AlphaZero.__init__`` (which starts remote actors)."""
    game = c.game()
    rng = np.random.RandomState(c.seed)
    return {
        "trunk": j_policy.init_mlp_params(
            rng, [game.OBS_DIM, c.hidden_size, c.hidden_size]),
        "pi": j_policy.init_mlp_params(rng, [c.hidden_size,
                                             game.NUM_ACTIONS]),
        "vf": j_policy.init_mlp_params(rng, [c.hidden_size, 1]),
    }


def _jax_lstm_hs(w, obs, h0, c0):
    """r2d2.py's unroll, which the JAX learner keeps in a closure."""
    Hd = h0.shape[-1]

    def cell(carry, x):
        h, c = carry
        z = x @ w["wx"] + h @ w["wh"] + w["b"]
        i = jax.nn.sigmoid(z[..., :Hd])
        f = jax.nn.sigmoid(z[..., Hd:2 * Hd])
        g = jnp.tanh(z[..., 2 * Hd:3 * Hd])
        o = jax.nn.sigmoid(z[..., 3 * Hd:])
        c2 = f * c + i * g
        h2 = o * jnp.tanh(c2)
        return (h2, c2), h2

    _, hs = jax.lax.scan(cell, (h0, c0), jnp.swapaxes(obs, 0, 1))
    return jnp.swapaxes(hs, 0, 1)


@jax.jit
def _jax_r2d2_q(w, obs, h0, c0):
    (Wq, bq), = w["q"]
    return _jax_lstm_hs(w, obs, h0, c0) @ Wq + bq


@jax.jit
def _jax_next_slates(p, users):
    """slateq.py's target slate: top 3 of v * Q over the catalog."""
    items = jnp.asarray(chip_smoke.RL_SLATE_ITEMS)
    B, N = users.shape[0], items.shape[0]
    x = jnp.concatenate([jnp.repeat(users[:, None, :], N, 1),
                         jnp.repeat(items[None], B, 0)], -1
                        ).reshape(B * N, -1)
    for W, b in p["trunk"]:
        x = jnp.tanh(x @ W + b)
    (Wq, bq), = p["q"]
    (Wc, bc), = p["choice"]
    v = (users @ Wc + bc) @ items.T
    return jax.lax.top_k(v * (x @ Wq + bq).reshape(B, N), 3)[1]


@jax.jit
def _jax_crr_binary(p, obs, act):
    """crr.py's binary weights: Q1(s, a) - Q1(s, pi(s)) > 0."""
    pi = j_core.DeterministicActorModule.forward(p["actor"], obs)
    return (j_core.QModule.forward(p["q1"], obs, act)
            - j_core.QModule.forward(p["q1"], obs, pi)) > 0


def _jax_choices(kind, jl, b):
    if kind == "r2d2":
        q = _jax_r2d2_q(jl._params, b["obs"], b["h0"], b["c0"])
        return np.asarray(jnp.argmax(q[:, 1:], -1))
    if kind == "qmix":
        return np.asarray(jax.jit(j_qmix.QMIXLearner.agent_q)(
            jl._target_full["agent"], b["next_obs"]).argmax(-1))
    if kind == "slateq":
        return np.asarray(_jax_next_slates(jl._target, b["next_user"]))
    return np.asarray(_jax_crr_binary(jl._params, b["obs"], b["act"]))


@pytest.mark.parametrize("kind", KINDS)
def test_learner_matches_jax_update_for_update(kind):
    (jl, jstep, jstate) = _jax_learner(kind)
    tl, tstep = chip_smoke.rl_more_learner(kind, "cpu", H)
    assert tl.device == torch.device("cpu")
    # Same seed, same numpy draws: identical starting weights and targets.
    tstate = {"params": tl._params,
              "target": getattr(tl, "_target_full",
                                getattr(tl, "_target", {}))}
    _assert_trees_close(tstate, jstate(), 0, f"{kind} init")
    for i in range(3):
        b = _batch(kind, i)
        if kind in chip_smoke.RL_CHOICE_KINDS:
            got = chip_smoke.rl_more_choices(kind, tl, b)
            want = _jax_choices(kind, jl, b)
            np.testing.assert_array_equal(got, want, err_msg=kind)
            # Both values of a binary weight occur: the test sees both.
            assert kind != "crr_binary" or 0 < want.mean() < 1
        _assert_stats_close(_floats(tstep(b, i)), jstep(b, i),
                            f"{kind} update {i}")
    tstate = {"params": tl._params,
              "target": getattr(tl, "_target_full",
                                getattr(tl, "_target", {}))}
    if kind != "dt":
        _assert_trees_close(tstate, jstate(), W_TOL, kind)
        return
    # DT's key biases have a zero gradient in exact arithmetic, so each
    # package's Adam steps them by its own rounding noise (up to lr a
    # step): held by their effect, the port's logits with JAX's key biases.
    (got, _), (want, keys) = (chip_smoke.dt_split_key_biases(_flat(t), H)
                              for t in (tstate, jstate()))
    _assert_trees_close(got, want, W_TOL, kind)
    assert chip_smoke.dt_key_bias_effect(tl, keys, b) <= 1e-5


def test_slate_top_k_breaks_ties_as_jax():
    """The slate's top k: largest first, ties toward the lower index, as
    ``jax.lax.top_k`` gives them (``torch.topk`` leaves the order of ties
    unspecified), on rows with ties among and across the top k."""
    x = np.float32([[1, 3, 3, 2, 3, 0], [0, 0, 0, 0, 0, 0],
                    [5, 1, 5, 1, 1, 1], [-1, -2, -1, -3, -2, -1]])
    want = np.asarray(jax.lax.top_k(jnp.asarray(x), 3)[1])
    got = t_slateq.top_k(torch.from_numpy(x), 3).numpy()
    np.testing.assert_array_equal(got, want)
    np.testing.assert_array_equal(want[0], [1, 2, 4])


def test_click_positions_are_numpy_copies():
    rng = np.random.RandomState(3)
    b = chip_smoke.rl_more_batch("slateq", 40, rng, H)
    pos = t_slateq.click_positions(b["slate"], b["clicked"])
    for r in range(40):
        hit = np.flatnonzero(b["slate"][r] == b["clicked"][r])
        assert pos[r] == (hit[0] if hit.size else 3)


@pytest.mark.parametrize("family", ["r2d2", "dt", "maddpg"])
def test_weights_cross_between_the_packages(family):
    """A JAX learner's weights load into the port's learner and the
    port's into JAX's (JAX's R2D2 and DT learners keep them in
    ``_params``, with no ``set_weights``): each then computes the other's
    forward."""
    jl, jstep, _ = _jax_learner(family)
    tl, tstep = chip_smoke.rl_more_learner(family, "cpu", H)
    jstep(_batch(family, 0), 1)                 # JAX moves away from init
    tstep(_batch(family, 1), 1)                 # the port elsewhere
    b = _batch(family, 2)

    def jax_set(lrn, w):
        if family == "maddpg":
            lrn.set_weights(w)
        else:
            lrn._params = jax.tree.map(jnp.asarray, w)

    def fwd_t(lrn):
        x = {k: torch.from_numpy(np.ascontiguousarray(v))
             for k, v in b.items()}
        with torch.no_grad():
            if family == "r2d2":
                return lrn.q_unroll(lrn._params, x["obs"], x["h0"], x["c0"])
            if family == "dt":
                return lrn.forward(lrn._params, x["rtg"], x["obs"],
                                   x["act_in"], x["timesteps"])
            a = t_core.DeterministicActorModule.forward(
                lrn._params["actor_0"], x["obs"][:, 0])
            return a, t_core.QModule.forward(
                lrn._params["q_1"], x["obs"].reshape(len(a), -1),
                x["actions"].reshape(len(a), -1))

    def fwd_j(lrn):
        if family == "r2d2":
            return _jax_r2d2_q(lrn._params, b["obs"], b["h0"], b["c0"])
        if family == "dt":
            return lrn.predict_logits(b["rtg"], b["obs"], b["act_in"],
                                      b["timesteps"])
        a = j_core.DeterministicActorModule.forward(
            lrn._params["actor_0"], b["obs"][:, 0])
        return a, j_core.QModule.forward(
            lrn._params["q_1"], b["obs"].reshape(len(a), -1),
            b["actions"].reshape(len(a), -1))

    jw = jax.tree.map(np.asarray, jl._params)
    tw = tl.get_weights()
    j_own = jax.tree.map(np.asarray, fwd_j(jl))
    t_own = fwd_t(tl)
    tl.set_weights(jw)
    jax_set(jl, tw)
    _assert_trees_close(tl.get_weights(), jw, 0, "JAX -> port")
    _assert_trees_close(jax.tree.map(np.asarray, jl._params), tw, 0,
                        "port -> JAX")
    _assert_trees_close(fwd_t(tl), j_own, 1e-5, "forward JAX -> port")
    _assert_trees_close(jax.tree.map(np.asarray, fwd_j(jl)), t_own, 1e-5,
                        "forward port -> JAX")


ONLINE = ("R2D2Config", "RecurrentPPOConfig", "QMIXConfig", "MADDPGConfig",
          "SlateQConfig", "AlphaZeroConfig")
OFFLINE = ("BCConfig", "MARWILConfig", "CQLConfig", "CRRConfig", "DTConfig")


def test_configs_match_and_online_builds_raise():
    """Every config's fields equal the JAX config's (AlphaZero's game, a
    class of each package, by name); the six online configs build their
    algorithms on the port's runtime and stop (the name is from when
    build() raised); the offline ones raise without data."""
    import test_torch_rllib_loops as loops

    for name in OFFLINE:
        got, want = vars(getattr(trl, name)()), vars(
            getattr(ray_tpu.rllib, name)())
        assert got == want, name
        with pytest.raises(ValueError, match="offline_data"):
            getattr(trl, name)().build()
    memory = (loops.Memory, {})
    loops.build_and_stop(
        [getattr(trl, name)() for name in ONLINE],
        {"R2D2Config": memory, "RecurrentPPOConfig": memory,
         "QMIXConfig": (loops.Coop, {"num_actions": 2}),
         "MADDPGConfig": (loops.CoopPush, {"act_dim": 1}),
         "SlateQConfig": (loops.RecSys, {}),
         "AlphaZeroConfig": (None, {})})


def _offline_data(algo):
    rng = np.random.RandomState(4)
    if algo == "dt":
        rows = {"episode_id": np.repeat(np.arange(16), 5),
                "t": np.tile(np.arange(5), 16),
                "obs": rng.randn(80, 3).astype(np.float32),
                "action": rng.randint(0, 2, 80),
                "reward": rng.randn(80).astype(np.float32)}
        return NumpyDataset(rows)
    n = 96
    cols = {"obs": rng.randn(n, 3).astype(np.float32)}
    if algo in ("bc", "marwil"):
        cols["action"] = (cols["obs"][:, 0] > 0).astype(np.int64)
        cols["return"] = rng.randn(n).astype(np.float32) * 2
    else:
        cols.update(action=rng.uniform(-1, 1, (n, 1)).astype(np.float32),
                    reward=rng.randn(n).astype(np.float32),
                    next_obs=rng.randn(n, 3).astype(np.float32),
                    done=(rng.rand(n) < 0.1).astype(np.float32))
    return NumpyDataset(cols)


def _offline_config(pkg, algo, ds):
    m = ray_tpu.rllib if pkg == "jax" else trl
    name = {"bc": "BCConfig", "marwil": "MARWILConfig", "cql": "CQLConfig",
            "crr": "CRRConfig", "dt": "DTConfig"}[algo]
    c = getattr(m, name)().offline_data(ds).debugging(seed=1)
    c.training(minibatch_size=32, hidden_size=H, lr=3e-3)
    if algo in ("bc", "marwil", "dt"):
        c.num_actions = 2
    if algo == "dt":
        c.training(minibatch_size=8, context_length=4, embed_dim=H,
                   batches_per_iteration=3)
    return c


@pytest.mark.parametrize("algo", ["bc", "marwil", "cql", "crr", "dt"])
def test_offline_algorithms_train_as_jax(algo):
    """The offline algorithms' train() in both packages on one in-process
    dataset: three iterations' results equal (counts exactly, stats
    within 1e-5), and the final weights within 1e-4."""
    ds = _offline_data(algo)
    jalgo = _offline_config("jax", algo, ds).build()
    talgo = _offline_config("torch", algo, ds).build(device="cpu")
    for it in range(3):
        _assert_stats_close(talgo.train(), jalgo.train(),
                            f"{algo} iteration {it}")
    if algo != "dt":
        _assert_trees_close(talgo.get_weights(), jalgo.get_weights(), W_TOL,
                            algo)
    else:  # the key biases held by their effect, as in the update test
        (got, _), (want, keys) = (
            chip_smoke.dt_split_key_biases(_flat(w), H)
            for w in (talgo.get_weights(), jalgo.get_weights()))
        _assert_trees_close(got, want, W_TOL, algo)
        b = talgo._sample_batch()
        assert chip_smoke.dt_key_bias_effect(talgo.learner, keys, b) <= 1e-5
        hist = {"obs": [np.float32([0.5, -1, 0])] * 5, "actions": [1, 0, 1,
                1], "rewards": [1.0, -1.0, 0.5, 0.0]}
        assert talgo.compute_action(hist, 3.0) == \
            jalgo.compute_action(hist, 3.0)
