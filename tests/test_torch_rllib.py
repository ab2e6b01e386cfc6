"""The port's RLlib learner layer (``ray_tpu_torch/rllib``) against the JAX
package's (``ray_tpu/rllib``), on the CPU.

Both packages get the same seeded numpy batches and start from the same
numpy weights (each draws them from the same ``RandomState``), in
float32 at small widths: hidden 16, minibatches of 32, a 40-step IMPALA
fragment. The numpy modules (GAE, SampleBatch, n-step returns, the
runners, the replay buffers) must agree bitwise. Each learner's stats
must agree within 1e-5 relative (plus 1e-6 absolute, for a stat near 0)
on each of three updates, and its weights and targets within 1e-4 after
the third; DQN's double-Q choices must be equal before its values are
compared. The JAX learners run as ``tests/test_rllib.py`` runs them,
without a runtime. The last test runs two PPO iterations in each package
with its own EnvRunners on ``chip_smoke.CartPole``, the numpy CartPole-v1
that the card phase uses (held against gymnasium's here).
"""

import copy
import importlib.util
import os
import types

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

import ray_tpu.rllib  # noqa: F401  (the JAX package's rllib, whole)
from ray_tpu.rllib import a2c as j_a2c
from ray_tpu.rllib import core as j_core
from ray_tpu.rllib import ddpg as j_ddpg
from ray_tpu.rllib import dqn as j_dqn
from ray_tpu.rllib import env_runner as j_env_runner
from ray_tpu.rllib import impala as j_impala
from ray_tpu.rllib import pg as j_pg
from ray_tpu.rllib import policy as j_policy
from ray_tpu.rllib import ppo as j_ppo
from ray_tpu.rllib import replay_buffers as j_replay
from ray_tpu.rllib import sac as j_sac
from ray_tpu.rllib import sample_batch as j_sb
from ray_tpu.rllib import td3 as j_td3
from ray_tpu_torch import rllib as trl
from ray_tpu_torch.rllib import a2c as t_a2c
from ray_tpu_torch.rllib import core as t_core
from ray_tpu_torch.rllib import ddpg as t_ddpg
from ray_tpu_torch.rllib import dqn as t_dqn
from ray_tpu_torch.rllib import env_runner as t_env_runner
from ray_tpu_torch.rllib import impala as t_impala
from ray_tpu_torch.rllib import pg as t_pg
from ray_tpu_torch.rllib import policy as t_policy
from ray_tpu_torch.rllib import ppo as t_ppo
from ray_tpu_torch.rllib import replay_buffers as t_replay
from ray_tpu_torch.rllib import sac as t_sac
from ray_tpu_torch.rllib import sample_batch as t_sb
from ray_tpu_torch.rllib import td3 as t_td3

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
_spec = importlib.util.spec_from_file_location(
    "chip_smoke", os.path.join(REPO, "chip_smoke.py"))
chip_smoke = importlib.util.module_from_spec(_spec)
_spec.loader.exec_module(chip_smoke)
CartPole = chip_smoke.CartPole

H, MB, T_FRAG = 16, 32, 40
STAT_RTOL, STAT_ATOL, W_TOL = 1e-5, 1e-6, 1e-4
LOW, HIGH = np.float32([-2.0]), np.float32([2.0])
PKG = {
    "jax": types.SimpleNamespace(
        a2c=j_a2c, core=j_core, ddpg=j_ddpg, dqn=j_dqn, impala=j_impala,
        pg=j_pg, policy=j_policy, ppo=j_ppo, sac=j_sac, td3=j_td3,
        env_runner=j_env_runner, replay=j_replay, sb=j_sb, kw={}),
    "torch": types.SimpleNamespace(
        a2c=t_a2c, core=t_core, ddpg=t_ddpg, dqn=t_dqn, impala=t_impala,
        pg=t_pg, policy=t_policy, ppo=t_ppo, sac=t_sac, td3=t_td3,
        env_runner=t_env_runner, replay=t_replay, sb=t_sb,
        kw={"device": "cpu"}),
}


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
    assert got.keys() == want.keys(), what
    for k, w in want.items():
        assert got[k].shape == w.shape, (what, k)
        if tol == 0:
            np.testing.assert_array_equal(got[k], w, err_msg=f"{what} {k}")
        else:
            d = float(np.abs(got[k] - w).max()) if w.size else 0.0
            assert d <= tol, (what, k, d)


# ------------------------------------------------------------ numpy modules

def test_compute_gae_is_bitwise_equal():
    rng = np.random.RandomState(0)
    for T in (1, 7, 64):
        args = (rng.randn(T).astype(np.float32),
                rng.randn(T).astype(np.float32), rng.rand(T) < 0.2,
                float(rng.randn()))
        got = t_sb.compute_gae(*args, gamma=0.99, lam=0.95)
        want = j_sb.compute_gae(*args, gamma=0.99, lam=0.95)
        _assert_trees_close(got, want, 0, f"gae T={T}")


def test_sample_batch_ops_are_bitwise_equal():
    rng = np.random.RandomState(1)
    cols = {"obs": rng.randn(10, 3).astype(np.float32),
            "actions": rng.randint(0, 2, 10),
            "bootstrap_obs": rng.randn(3).astype(np.float32)}
    tb, jb = t_sb.SampleBatch(cols), j_sb.SampleBatch(cols)
    assert tb.count == jb.count == 10
    _assert_trees_close(dict(t_sb.SampleBatch.concat([tb, tb])),
                        dict(j_sb.SampleBatch.concat([jb, jb])), 0, "concat")
    _assert_trees_close(dict(tb.shuffle(np.random.RandomState(5))),
                        dict(jb.shuffle(np.random.RandomState(5))), 0,
                        "shuffle")
    got = [dict(m) for m in tb.minibatches(4)]
    want = [dict(m) for m in jb.minibatches(4)]
    assert len(got) == len(want) == 2
    _assert_trees_close(got, want, 0, "minibatches")


@pytest.mark.parametrize("n", [1, 3])
def test_nstep_returns_are_bitwise_equal(n):
    rng = np.random.RandomState(2)
    T = 30
    cols = {"obs": rng.randn(T, 2).astype(np.float32),
            "actions": rng.randint(0, 2, T),
            "rewards": rng.randn(T).astype(np.float32),
            "dones": rng.rand(T) < 0.1, "boundary": rng.rand(T) < 0.2,
            "next_obs": rng.randn(T, 2).astype(np.float32)}
    got = t_dqn.nstep_returns(t_sb.SampleBatch(cols), n, 0.9)
    want = j_dqn.nstep_returns(j_sb.SampleBatch(cols), n, 0.9)
    _assert_trees_close(dict(got), dict(want), 0, f"n={n}")


class Swing:
    """A small numpy continuous-control env: 3 observations, 1 action in
    [-2, 2], terminated past |theta| 2.5, truncated at 30 steps."""

    def __init__(self):
        self.rng = np.random.RandomState(0)

    def _obs(self):
        return np.float32([np.cos(self.th), np.sin(self.th), self.thd])

    def reset(self, seed=None):
        if seed is not None:
            self.rng = np.random.RandomState(seed)
        self.th, self.thd, self.t = self.rng.uniform(-1, 1), 0.0, 0
        return self._obs(), {}

    def step(self, action):
        a = float(np.clip(np.asarray(action).reshape(-1)[0], -2, 2))
        self.thd += 0.05 * (a - np.sin(self.th)) * 20
        self.th += 0.05 * self.thd
        self.t += 1
        r = -(self.th ** 2 + 0.1 * self.thd ** 2 + 0.001 * a * a)
        return self._obs(), r, abs(self.th) > 2.5, self.t >= 30, {}


def _policy(pkg, kind):
    pol = PKG[pkg].policy
    if kind == "mlp":
        return pol.MLPPolicy(4, 2, H, 0)
    if kind == "q":
        p = pol.QPolicy(4, 2, H, 0)
        p.set_epsilon(0.3)
        return p
    if kind == "dueling":
        p = pol.DuelingQPolicy(4, 2, H, 0)
        p.set_epsilon(0.3)
        return p
    if kind == "deterministic":
        return pol.DeterministicPolicy(3, 1, LOW, HIGH, H, 0)
    return pol.SquashedGaussianPolicy(3, 1, LOW, HIGH, H, 0)


@pytest.mark.parametrize("kind", ["mlp", "q", "dueling", "deterministic",
                                  "squashed"])
def test_env_runners_sample_equal_batches(kind):
    """EnvRunner (GAE fragments, on CartPole) and TransitionEnvRunner
    (transitions) of both packages, same env, policy and seed: three
    fragments, equal column for column, and equal episode stats."""
    env = CartPole if kind in ("mlp", "q", "dueling") else Swing
    out = {}
    for pkg in ("jax", "torch"):
        er = PKG[pkg].env_runner
        cls = er.EnvRunner if kind == "mlp" else er.TransitionEnvRunner
        r = cls(env, lambda: _policy(pkg, kind), seed=3,
                rollout_fragment_length=50)
        out[pkg] = ([dict(r.sample()) for _ in range(3)],
                    r.episode_stats())
    _assert_trees_close(out["torch"][0], out["jax"][0], 0, kind)
    assert out["torch"][1] == out["jax"][1]


def test_replay_buffers_sample_equally():
    rng = np.random.RandomState(4)
    rows = [{"obs": rng.randn(10, 2).astype(np.float32),
             "r": rng.randn(10).astype(np.float32)} for _ in range(12)]
    got, want = [], []
    for pkg, out in (("torch", got), ("jax", want)):
        rp = PKG[pkg].replay
        buf = rp.ReplayBuffer(capacity=100, seed=0)
        pbuf = rp.PrioritizedReplayBuffer(capacity=64, alpha=0.6,
                                          beta=0.4, seed=0)
        for cols in rows:
            buf.add(PKG[pkg].sb.SampleBatch(cols))
            pbuf.add(PKG[pkg].sb.SampleBatch(cols))
        out.append(dict(buf.sample(16)))
        mb = pbuf.sample(16)
        out.append(dict(mb))
        pbuf.update_priorities(mb["batch_indexes"], mb["r"] * 3)
        out.append(dict(pbuf.sample(16)))
    _assert_trees_close(got, want, 0, "replay")


# ------------------------------------------------------------------ learners

KINDS = ("ppo", "ppo_is_clip", "a2c", "pg", "impala", "dqn_double",
         "dqn_target_argmax", "dqn_dueling", "ddpg", "td3", "sac")


def _batch(kind, i):
    """Update ``i``'s seeded batch, in the layout ``chip_smoke.rl_batch``
    gives the card phase, at this file's sizes."""
    n = T_FRAG if kind == "impala" else MB
    return chip_smoke.rl_batch("dqn" if kind == "dqn_target_argmax"
                               else kind, n, np.random.RandomState(10 + i))


def _learner(kind, pkg):
    """(learner, step(batch, i) -> {stat: float}) in ``pkg``, run the way
    its algorithm runs it."""
    m = PKG[pkg]
    kw = m.kw
    mlp = m.policy.MLPPolicy(4, 2, H, 0)
    if kind.startswith("ppo"):
        c = m.ppo.PPOConfig()
        lrn = m.ppo.PPOLearner(mlp, c.lr, c.clip_param, c.vf_loss_coeff,
                               c.entropy_coeff,
                               2.0 if kind == "ppo_is_clip" else None, **kw)
        return lrn, lambda b, i: _floats(lrn.update_device(b))
    if kind in ("a2c", "pg"):
        if kind == "a2c":
            c = m.a2c.A2CConfig()
            lrn = m.a2c.A2CLearner(mlp, c.lr, c.vf_loss_coeff,
                                   c.entropy_coeff, **kw)
        else:
            lrn = m.pg.PGLearner(mlp, m.pg.PGConfig().lr, **kw)
        if pkg == "torch":
            return lrn, lambda b, i: _floats(lrn.update_minibatch(b))
        algo = j_a2c.A2C if kind == "a2c" else j_pg.PG
        ns = types.SimpleNamespace(learner=lrn)
        return lrn, lambda b, i: _floats(algo.update_minibatch(ns, b))
    if kind == "impala":
        c = m.impala.IMPALAConfig()
        lrn = m.impala.IMPALALearner(mlp, c.lr, c.gamma, c.rho_clip,
                                     c.c_clip, c.vf_loss_coeff,
                                     c.entropy_coeff, **kw)
        return lrn, lambda b, i: lrn.update(b)
    if kind.startswith("dqn"):
        pol = (m.policy.DuelingQPolicy if kind == "dqn_dueling"
               else m.policy.QPolicy)(4, 2, H, 0)
        lrn = m.dqn.DQNLearner(pol, m.dqn.DQNConfig().lr,
                               kind != "dqn_target_argmax", **kw)

        def step(b, i):
            out = lrn.update(b)
            if i == 0:
                lrn.sync_target()
            return {"loss": out["loss"],
                    **{f"td{j}": float(t) for j, t in
                       enumerate(out["td_error"])}}
        return lrn, step
    if kind == "sac":
        c = m.sac.SACConfig()
        c.hidden_size = H
        pol = m.policy.SquashedGaussianPolicy(3, 1, LOW, HIGH, H, 0)
        lrn = m.sac.SACLearner(pol, c, 3, 1, LOW, HIGH, **kw)
        return lrn, lambda b, i: lrn.update(b)
    mod = m.ddpg if kind == "ddpg" else m.td3
    c = m.ddpg.DDPGConfig() if kind == "ddpg" else m.td3.TD3Config()
    c.hidden_size = H
    pol = m.policy.DeterministicPolicy(3, 1, LOW, HIGH, H, 0)
    cls = mod.DDPGLearner if kind == "ddpg" else mod.TD3Learner
    lrn = cls(pol, c, 3, 1, LOW, HIGH, **kw)
    if kind == "ddpg":
        return lrn, lambda b, i: _floats(lrn.learn_on_batch(b))
    return lrn, lambda b, i: _floats(
        lrn.learn_on_batch(b, do_actor=i % c.policy_delay == 0))


def _state(lrn):
    """Every tensor the learner keeps (params and targets)."""
    return {"params": lrn._params, "target": getattr(lrn, "_target", {})}


@jax.jit
def _jax_q(params, obs):
    """dqn.py's q_forward, which the JAX learner keeps in a closure."""
    h = obs
    for W, b in params["trunk"]:
        h = jnp.tanh(h @ W + b)
    if "q" in params:
        (Wq, bq), = params["q"]
        return h @ Wq + bq
    (Wv, bv), = params["v"]
    (Wa, ba), = params["a"]
    a = h @ Wa + ba
    return h @ Wv + bv + a - a.mean(axis=-1, keepdims=True)


def _dqn_choices(kind, jl, tl, batch):
    """The next-state actions each package's backup evaluates."""
    chooser = jl._params if kind != "dqn_target_argmax" else jl._target
    want = np.asarray(jnp.argmax(_jax_q(chooser, batch["next_obs"]), 1))
    got, _ = tl.best_next_actions(
        tl._params, tl._target, torch.from_numpy(batch["next_obs"]))
    return got.numpy(), want


@pytest.mark.parametrize("kind", KINDS)
def test_learner_matches_jax_update_for_update(kind):
    (jl, jstep), (tl, tstep) = _learner(kind, "jax"), _learner(kind, "torch")
    assert tl.device == torch.device("cpu")
    # Same seed, same numpy draws: identical starting weights and targets.
    _assert_trees_close(_state(tl), _state(jl), 0, f"{kind} init")
    for i in range(3):
        b = _batch(kind, i)
        if kind.startswith("dqn"):
            got, want = _dqn_choices(kind, jl, tl, b)
            np.testing.assert_array_equal(got, want)
        _assert_stats_close(tstep(b, i), jstep(b, i), f"{kind} update {i}")
    _assert_trees_close(_state(tl), _state(jl), W_TOL, kind)
    _assert_trees_close(tl.get_weights(), jl.get_weights(), W_TOL, kind)


def test_learner_layer_unit():
    """The shared Learner with ``grad_clip`` (which no family uses):
    polyak targets move toward params, grad steps reduce a quadratic
    loss, weights round-trip, ``get_weights`` is a copy. Against JAX: the
    first update's stats within 1e-5, and the state within 1e-4 after 51
    updates at lr 0.1 that run with the clip engaged (norm 8 against 1)
    and, near the optimum, not. Stats are held only at the first update:
    optax rounds Adam's bias correction in float32 (a first step of
    0.0999993 where torch's fused Adam takes 0.1), which at this lr moves
    the weights apart by ~7e-7 a step, and the distance to the optimum
    shrinks to where that is more than 1e-5 of it."""
    class Quad(trl.Learner):
        def compute_loss(self, params, target, batch):
            loss = ((params["w"][0][0] - batch["target_w"]) ** 2).sum()
            return loss, {"dist": loss}

    class JQuad(j_core.Learner):
        def compute_loss(self, params, target, batch):
            loss = ((params["w"][0][0] - batch["target_w"]) ** 2).sum()
            return loss, {"dist": loss}

    w0 = {"w": [(np.ones((2, 2), np.float32), np.zeros(2, np.float32))]}
    kw = dict(lr=0.1, target_keys=("w",), tau=0.5, grad_clip=1.0)
    lrn, jl = Quad(w0, device="cpu", **kw), JQuad(w0, **kw)
    tgt = {"target_w": np.full((2, 2), 3.0, np.float32)}
    first = lrn.update(tgt)
    _assert_stats_close(first, jl.update(tgt), "update 0")
    for _ in range(50):
        last = lrn.update(tgt)
        jl.update(tgt)
    assert last["dist"] < first["dist"] * 0.01
    got = lrn.get_weights()
    np.testing.assert_allclose(got["w"][0][0], 3.0, atol=0.2)
    _assert_trees_close(lrn.get_state(), jl.get_state(), W_TOL, "state")
    tw = lrn.get_state()["target"]["w"][0][0]
    np.testing.assert_allclose(tw, got["w"][0][0], atol=0.3)
    # The round trip changes nothing: the next update equals that of a
    # copy that skipped it (and get_weights' arrays are no views).
    before, ref = copy.deepcopy(got), copy.deepcopy(lrn)
    lrn.set_weights(lrn.get_weights())
    assert lrn.update(tgt) == ref.update(tgt)
    _assert_trees_close(lrn.get_state(), ref.get_state(), 0, "round trip")
    _assert_trees_close(got, before, 0, "get_weights aliases the params")


@pytest.mark.parametrize("above", [False, True])
def test_clip_by_global_norm_is_optax(above):
    rng = np.random.RandomState(6)
    tree = {"a": [(rng.randn(3, 4).astype(np.float32),
                   rng.randn(4).astype(np.float32))],
            "b": rng.randn(5).astype(np.float32)}
    norm = float(np.sqrt(sum((x.astype(np.float64) ** 2).sum()
                             for x in _flat(tree).values())))
    limit = norm / 2 if above else norm * 2
    want, _ = optax.clip_by_global_norm(limit).update(
        jax.tree.map(jnp.asarray, tree), optax.EmptyState())
    got = t_core.tree_to_device(tree, torch.device("cpu"))
    t_core.clip_by_global_norm_(got, limit)
    _assert_trees_close(got, jax.tree.map(np.asarray, want), 1e-7, "clip")
    if not above:
        _assert_trees_close(got, tree, 0, "clip below the limit")


def test_twin_critic_learner_roundtrip():
    """TwinCriticLearner (shared by TD3/DDPG): set_weights(get_weights())
    must NOT drop the critics, the critic step leaves the actor and its
    target alone, and get_state snapshots the full tree."""
    class L(trl.TwinCriticLearner):
        def compute_loss(self, params, target, batch):
            q = trl.QModule.forward(params["q1"], batch["obs"],
                                    batch["act"])
            return (q ** 2).mean(), {"q": q.mean()}

    lrn = L(trl.DeterministicActorModule(3, 2, 16, 0).init_params(),
            obs_dim=3, act_dim=2, hidden=16, lr=1e-3, tau=0.1, seed=0,
            device="cpu")
    rng = np.random.RandomState(7)
    batch = {"obs": rng.randn(4, 3).astype(np.float32),
             "act": rng.randn(4, 2).astype(np.float32)}
    st0 = lrn.get_state()
    lrn.update(batch)
    st1 = lrn.get_state()
    for part in ("params", "target"):
        _assert_trees_close(st1[part]["actor"], st0[part]["actor"], 0,
                            f"actor {part} in a critic step")
    assert not np.array_equal(st1["params"]["q1"]["q"][0][0],
                              st0["params"]["q1"]["q"][0][0])
    w = lrn.get_weights()           # actor-only view for rollouts
    assert "mu" in w and "q1" not in w
    lrn.set_weights(w)              # must merge, not replace
    lrn.update(batch)               # would KeyError if critics dropped
    lrn.actor_update(batch)
    st = lrn.get_state()
    assert set(st["params"]) == {"actor", "q1", "q2"}
    assert set(st["target"]) == {"actor", "q1", "q2"}
    assert not np.array_equal(st["target"]["actor"]["mu"][0][0],
                              st0["target"]["actor"]["mu"][0][0])
    lrn.set_weights(st["params"])   # a full tree replaces the whole
    _assert_trees_close(lrn.get_state()["params"], st["params"], 0, "full")


def test_learner_group_local_is_the_bare_learner():
    def make():
        return t_ppo.PPOLearner(t_policy.MLPPolicy(4, 2, H, 0), 3e-4, 0.2,
                                0.5, 0.01, device="cpu")

    group, bare = trl.LearnerGroup(make), make()
    assert not group.is_remote
    for i in range(2):
        b = _batch("ppo", i)
        assert group.update(b) == bare.update(b)
    assert group.update_async(b) == bare.update(b)
    _assert_trees_close(group.get_weights(), bare.get_weights(), 0, "group")
    group.shutdown()
    # The remote mode runs the learner in an actor of the port's runtime
    # (tests/test_torch_rllib_loops.py), which this process has not
    # started.
    from ray_tpu_torch.core.exceptions import RuntimeNotInitializedError

    with pytest.raises(RuntimeNotInitializedError):
        trl.LearnerGroup(make, remote=True)


@pytest.mark.parametrize("family", ["ppo", "td3"])
def test_weights_cross_between_the_packages(family):
    """A JAX learner's get_weights() loads into the port's learner and
    the port's into JAX's: each then computes the other's forward."""
    kind = "ppo" if family == "ppo" else "td3"
    (jl, jstep), (tl, tstep) = _learner(kind, "jax"), _learner(kind, "torch")
    jstep(_batch(kind, 0), 0)                 # JAX moves away from init
    tstep(_batch(kind, 1), 0)                 # the port elsewhere
    obs = np.random.RandomState(8).randn(16, 4 if kind == "ppo" else 3
                                         ).astype(np.float32)
    tmod = trl.ActorCriticModule if kind == "ppo" else \
        trl.DeterministicActorModule
    jmod = j_core.ActorCriticModule if kind == "ppo" else \
        j_core.DeterministicActorModule

    def fwd_t(lrn):
        p = lrn._params if kind == "ppo" else lrn._params["actor"]
        return _flat(tmod.forward(p, torch.from_numpy(obs)))

    def fwd_j(lrn):
        p = lrn._params if kind == "ppo" else lrn._params["actor"]
        return _flat(jax.tree.map(np.asarray, jmod.forward(p, obs)))

    jw, tw = jl.get_weights(), tl.get_weights()
    tl.set_weights(jw)
    jl.set_weights(tw)
    _assert_trees_close(tl.get_weights(), jw, 0, "JAX -> port")
    _assert_trees_close(jl.get_weights(), tw, 0, "port -> JAX")
    jl2, _ = _learner(kind, "jax")
    jl2.set_weights(jw)
    _assert_trees_close(fwd_t(tl), fwd_j(jl2), 1e-6, "forward JAX -> port")
    tl2, _ = _learner(kind, "torch")
    tl2.set_weights(tw)
    _assert_trees_close(fwd_j(jl), fwd_t(tl2), 1e-6, "forward port -> JAX")


def test_configs_build_raises_naming_the_runtime():
    """The eight learners' configs build their algorithms on the port's
    runtime (the name is from when build() raised, naming it)."""
    import test_torch_rllib_loops as loops

    box = (loops.GoToZero, {})
    loops.build_and_stop(
        (trl.PPOConfig(), trl.A2CConfig(), trl.PGConfig(),
         trl.IMPALAConfig(), trl.DQNConfig(), trl.DDPGConfig(),
         trl.TD3Config(), trl.SACConfig()),
        {"DDPGConfig": box, "TD3Config": box, "SACConfig": box})


def test_learners_run_on_the_card_by_default():
    """With no device given every learner takes the card, those of
    chip_smoke phase 13 too; without one it raises (no quiet CPU
    fallback)."""
    makers = [lambda k=k: chip_smoke.rl_learner(k, None)
              for k in chip_smoke.RL_KINDS]
    makers += [lambda k=k: chip_smoke.rl_more_learner(k, None, 16)
               for k in chip_smoke.RL_MORE_KINDS]
    for make in makers:
        if torch.cuda.is_available():
            lrn, _ = make()
            assert lrn.device.type == "cuda", lrn
        else:
            with pytest.raises(RuntimeError, match="no CUDA device"):
                make()


# ------------------------------------------------------------- the slice

def test_chip_smoke_cartpole_is_gymnasiums():
    """chip_smoke's numpy CartPole-v1 steps as gymnasium's does: the same
    observations, rewards, terminations and the 500-step truncation."""
    gym = pytest.importorskip("gymnasium")
    ours, ref = CartPole(), gym.make("CartPole-v1")
    rng = np.random.RandomState(9)
    for episode in range(4):
        seed = 11 if episode == 0 else None
        o1, _ = ours.reset(seed=seed)
        o2, _ = ref.reset(seed=seed)
        np.testing.assert_array_equal(o1, o2)
        steps = 0
        while True:
            # Episode 1 balances (a PD rule) to reach the truncation.
            a = (int(o1[2] + 0.3 * o1[3] + 0.01 * o1[1] > 0) if episode == 1
                 else int(rng.randint(2)))
            s1, s2 = ours.step(a), ref.step(a)
            np.testing.assert_array_equal(s1[0], s2[0])
            assert s1[1:4] == tuple(s2[1:4]), (episode, steps, s1, s2)
            o1, steps = s1[0], steps + 1
            if s1[2] or s1[3]:
                break
        if episode == 1:
            assert steps == 500 and s1[3] and not s1[2]


def _ppo_iterations(pkg, iters=2):
    """``iters`` PPO iterations in ``pkg``: two of its EnvRunners on
    CartPole (seeds 0 and 1, fragments of 64), its learner on the
    concatenated 128 rows (2 epochs of minibatches of 32, lr 3e-3), the
    weights handed back to the runners."""
    m = PKG[pkg]
    c = m.ppo.PPOConfig()

    def policy():
        return m.policy.MLPPolicy(4, 2, H, 0)

    runners = [m.env_runner.EnvRunner(CartPole, policy, seed=i,
                                      rollout_fragment_length=64,
                                      gamma=c.gamma, lam=c.lambda_)
               for i in range(2)]
    lrn = m.ppo.PPOLearner(policy(), 3e-3, c.clip_param, c.vf_loss_coeff,
                           c.entropy_coeff, **m.kw)
    rng = np.random.RandomState(0)
    actions, stats = [], []
    for _ in range(iters):
        batch = m.sb.SampleBatch.concat([r.sample() for r in runners])
        actions.append(batch["actions"])
        stats.append(lrn.update_epochs(batch, epochs=2, minibatch_size=32,
                                       rng=rng))
        for r in runners:
            r.set_weights(lrn.get_weights())
    return actions, stats, lrn.get_weights()


def test_two_ppo_iterations_match_jax():
    """The slice end to end on the CPU: each package samples with its own
    EnvRunners and updates its own learner; the sampled actions are equal
    in both iterations and the final weights within 1e-4."""
    (ta, ts, tw), (ja, js, jw) = _ppo_iterations("torch"), \
        _ppo_iterations("jax")
    for it, (got, want) in enumerate(zip(ta, ja)):
        np.testing.assert_array_equal(got, want, err_msg=f"iteration {it}")
    for got, want in zip(ts, js):
        _assert_stats_close(got, want, "update_epochs")
    _assert_trees_close(tw, jw, W_TOL, "weights after two iterations")
