"""RLlib's online loops on the port's runtime against the JAX package's on
its own, on the CPU: PPO, A2C, PG, IMPALA and AlphaZero here, the replay
and recurrent loops in ``test_torch_rllib_loops2.py``, the multi-agent,
slate and worker-learner loops in ``test_torch_rllib_loops3.py``.

Each loop runs two iterations from the same config in both packages: the
port's ``build(device="cpu")`` (learner in the driver, runners as CPU
actors of ``ray_tpu_torch``) against the JAX package's ``build()`` under
``ray_tpu``. What the driver's ``get`` returns in iteration 1 (the
runners' fragments and episode stats) must be bitwise equal: the runners
are the same numpy with the same seeds and weights. In iteration 2 the
sampled actions (AlphaZero: its self-play states) must be equal
(discrete) or within 1e-4 (continuous),
every number of each ``train()`` result within 1e-5 relative + 1e-6, and
the final weights within 1e-4. IMPALA runs with one runner, which makes
its asynchronous order deterministic. Then ``LearnerGroup(remote=True)``
in a CPU actor against a local learner (exact), the refusals of what a
worker cannot import, ``stop()``, the runtime's listener under a burst
of connects and the lazy import.

One runtime of each package serves the module. The envs are module-level
classes: the JAX package's workers get this module by value
(``cloudpickle``), the port's import it by name, so it imports nothing
heavy at the top. Every test is bounded by ``TEST_LIMIT_S``.
"""

import functools
import importlib
import os
import subprocess
import sys
import threading
import time

import numpy as np
import pytest

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
TEST_LIMIT_S = 90
RTOL, ATOL = 1e-5, 1e-6  # the RL stat tolerance (PERF.md §2)
WEIGHT_TOL = 1e-4
ACTION_KEYS = ("actions", "slate")
LEARNER_KEYS = ("grads", "loss")  # worker-learner outputs: by tolerance
_HUNG = []  # the test in which a runtime stopped answering


def bounded(test):
    """Run the test in a thread for at most TEST_LIMIT_S: a runtime that
    stops answering fails the test, and every later test of the module at
    once, instead of holding the session until its time limit."""

    @functools.wraps(test)
    def run(*args, **kwargs):
        if _HUNG:
            pytest.fail(f"a runtime stopped answering in {_HUNG[0]}")
        box = {}

        def body():
            try:
                test(*args, **kwargs)
            except BaseException as e:  # noqa: BLE001 — raised below
                box["error"] = e

        t = threading.Thread(target=body, daemon=True)
        t.start()
        t.join(TEST_LIMIT_S)
        if t.is_alive():
            _HUNG.append(test.__name__)
            pytest.fail(f"{test.__name__} did not finish in {TEST_LIMIT_S} s")
        if "error" in box:
            raise box["error"]

    return run


def _shutdown(pkg):
    t = threading.Thread(target=pkg.shutdown, daemon=True)
    t.start()
    t.join(60)


def jax_fixture(modules):
    import cloudpickle

    import ray_tpu

    for m in modules:
        cloudpickle.register_pickle_by_value(m)
    ray_tpu.init(num_cpus=4, system_config={
        "num_prestart_workers": 2, "refcount_flush_interval_s": 0.1,
        "gc_grace_period_s": 0.5})
    yield ray_tpu
    _shutdown(ray_tpu)
    for m in modules:
        cloudpickle.unregister_pickle_by_value(m)


def port_fixture():
    import ray_tpu_torch

    ray_tpu_torch.init(num_cpus=4, num_gpus=0)
    yield ray_tpu_torch
    _shutdown(ray_tpu_torch)


@pytest.fixture(scope="module")
def jax_rt():
    yield from jax_fixture([sys.modules[__name__]])


@pytest.fixture(scope="module")
def port_rt():
    yield from port_fixture()


@pytest.fixture
def both(jax_rt, port_rt):
    return {"jax": jax_rt, "port": port_rt}


# ------------------------------------------------------------------- envs
# The JAX tests' toy envs (tests/test_rllib_families*.py), at module level.

class Box:
    def __init__(self, low, high, shape):
        self.low = np.full(shape, low, dtype=np.float32)
        self.high = np.full(shape, high, dtype=np.float32)
        self.shape = shape


class Discrete:
    def __init__(self, n):
        self.n = n
        self.shape = ()


class Sign:
    """Discrete toy: obs=[signal in {-1,+1}]; the action must match the
    sign (+1 reward, else -1); 30-step episodes."""

    def __init__(self):
        self.observation_space = Box(-1.0, 1.0, (1,))
        self.action_space = Discrete(2)
        self._rng = np.random.RandomState(0)
        self._t = 0

    def _obs(self):
        self._sig = float(self._rng.choice([-1.0, 1.0]))
        return np.asarray([self._sig], "float32")

    def reset(self, seed=None):
        if seed is not None:
            self._rng = np.random.RandomState(seed)
        self._t = 0
        return self._obs(), {}

    def step(self, action):
        want = 1 if self._sig > 0 else 0
        r = 1.0 if int(action) == want else -1.0
        self._t += 1
        return self._obs(), r, False, self._t >= 30, {}


class GoToZero:
    """1-D continuous toy: reward -|x + a|; the optimum is a = -x."""

    def __init__(self):
        self.observation_space = Box(-1.0, 1.0, (1,))
        self.action_space = Box(-1.0, 1.0, (1,))
        self._rng = np.random.RandomState(0)
        self._t = 0

    def reset(self, seed=None):
        if seed is not None:
            self._rng = np.random.RandomState(seed)
        self._t = 0
        self._x = self._rng.uniform(-1, 1, (1,)).astype("float32")
        return self._x, {}

    def step(self, action):
        r = -float(abs(self._x[0] + float(action[0])))
        self._t += 1
        self._x = self._rng.uniform(-1, 1, (1,)).astype("float32")
        return self._x, r, False, self._t >= 50, {}


class Memory:
    """POMDP: the cue is visible only at t=0; every later step rewards the
    action matching the remembered cue; 8-step episodes."""

    def __init__(self):
        self.observation_space = Box(-1.0, 1.0, (1,))
        self.action_space = Discrete(2)
        self._rng = np.random.RandomState(0)
        self._t = 0

    def reset(self, seed=None):
        if seed is not None:
            self._rng = np.random.RandomState(seed)
        self._t = 0
        self._cue = float(self._rng.choice([-1.0, 1.0]))
        return np.asarray([self._cue], "float32"), {}

    def step(self, action):
        want = 1 if self._cue > 0 else 0
        r = 1.0 if int(action) == want else -1.0
        self._t += 1
        return np.asarray([0.0], "float32"), r, False, self._t >= 8, {}


class Coop:
    """2-agent cooperative sign task with a joint bonus (QMIX's)."""

    def __init__(self):
        self._rng = np.random.RandomState(0)
        self._t = 0

    def _obs(self):
        self._sig = self._rng.choice([-1.0, 1.0], size=2)
        return {f"a{i}": np.asarray([self._sig[i]], "float32")
                for i in range(2)}

    def reset(self, seed=None):
        if seed is not None:
            self._rng = np.random.RandomState(seed)
        self._t = 0
        return self._obs(), {}

    def step(self, actions):
        correct = [int(actions[f"a{i}"]) == (1 if self._sig[i] > 0 else 0)
                   for i in range(2)]
        team = float(sum(correct)) + (1.0 if all(correct) else 0.0)
        rew = {f"a{i}": team / 2.0 for i in range(2)}
        self._t += 1
        done = self._t >= 25
        return (self._obs(), rew, {"__all__": done}, {"__all__": False}, {})


class CoopPush:
    """2-agent continuous cooperation (MADDPG's): each agent outputs an
    action close to its own target; the reward is shared."""

    action_low = -np.ones(1, np.float32)
    action_high = np.ones(1, np.float32)

    def __init__(self):
        self._rng = np.random.RandomState(0)
        self._t = 0

    def _obs(self):
        self._targets = self._rng.uniform(-0.8, 0.8, 2)
        return {f"a{i}": np.asarray([self._targets[i]], "float32")
                for i in range(2)}

    def reset(self, seed=None):
        if seed is not None:
            self._rng = np.random.RandomState(seed)
        self._t = 0
        return self._obs(), {}

    def step(self, actions):
        errs = [abs(float(actions[f"a{i}"][0]) - self._targets[i])
                for i in range(2)]
        team = -(errs[0] + errs[1])
        rew = {f"a{i}": team / 2.0 for i in range(2)}
        self._t += 1
        done = self._t >= 25
        return (self._obs(), rew, {"__all__": done}, {"__all__": False}, {})


class RecSys:
    """Toy recsys (SlateQ's): clicks follow a logit over the slate's
    alignment with a hidden taste; reward = the clicked item's
    alignment."""

    num_items = 12
    slate_size = 3

    def __init__(self):
        rng = np.random.RandomState(7)
        self.item_features = rng.randn(self.num_items, 4).astype("float32")
        self._rng = np.random.RandomState(0)
        self._t = 0

    def _user(self):
        taste = self._rng.randn(4)
        self._taste = (taste / np.linalg.norm(taste)).astype("float32")
        return self._taste

    def reset(self, seed=None):
        if seed is not None:
            self._rng = np.random.RandomState(seed)
        self._t = 0
        return self._user(), {}

    def step(self, slate):
        aligns = np.asarray([float(self.item_features[i] @ self._taste)
                             for i in slate])
        ex = np.exp(aligns - aligns.max())
        probs = ex / (ex.sum() + np.exp(-aligns.max()))
        u = self._rng.rand()
        acc = 0.0
        clicked, reward = -1, 0.0
        for j, p in enumerate(probs):
            acc += p
            if u < acc:
                clicked = int(slate[j])
                reward = float(aligns[j])
                break
        self._t += 1
        return self._user(), reward, False, self._t >= 20, \
            {"clicked": clicked}


def make_sign_learner(device="cpu"):
    """A PPO learner on the sign task's shapes (a module-level factory a
    worker can import)."""
    from ray_tpu_torch.rllib import MLPPolicy, PPOLearner

    return PPOLearner(MLPPolicy(1, 2, 16, 0), 3e-3, 0.2, 0.5, 0.01,
                      device=device)


# ------------------------------------------------------------ the runs

def packages(both):
    """{"jax": (runtime, rllib), "port": (runtime, rllib)}."""
    return {k: (rt, importlib.import_module(rt.__name__ + ".rllib"))
            for k, rt in both.items()}


def run_loop(rt, rl, make_config, *, port: bool, iters: int = 2,
             inspect=None):
    """``iters`` train() calls of the config ``make_config(rl)`` builds,
    with every value the driver's ``get`` returns recorded per iteration;
    ``inspect(algo)``, if given, runs before the algorithm is stopped.
    Returns (results, gets, weights, runner worker pids or None)."""
    config = make_config(rl)
    gets = []
    real = rt.get

    def spy(refs, *args, **kwargs):
        out = real(refs, *args, **kwargs)
        if gets:
            gets[-1].append(out)
        return out

    before = set(worker_pids()) if port else set()
    algo = config.build(device="cpu") if port else config.build()
    results = []
    rt.get = spy
    try:
        for _ in range(iters):
            gets.append([])
            results.append(algo.train())
        rt.get = real
        weights = algo.get_weights()
        if inspect is not None:
            inspect(algo)
    finally:
        rt.get = real
        pids = sorted(set(worker_pids()) - before) if port else None
        algo.stop()
    return results, gets, weights, pids


def worker_pids():
    from ray_tpu_torch.core.runtime_context import current_runtime

    return current_runtime().worker_pids()


def alive(pids):
    """The pids of ``pids`` still running (zombies count dead)."""
    out = []
    for pid in pids:
        try:
            with open(f"/proc/{pid}/stat") as f:
                if f.read().rsplit(")", 1)[1].split()[0] != "Z":
                    out.append(pid)
        except OSError:
            pass
    return out


def assert_gone(pids, timeout=10.0):
    """Every pid of ``pids`` has left the runtime's workers and exited."""
    deadline = time.monotonic() + timeout
    while True:
        left = [p for p in pids if p in worker_pids()] + alive(pids)
        if not left or time.monotonic() > deadline:
            break
        time.sleep(0.05)
    assert not left, left


def run_both(both, make_config, iters=2, inspect=None):
    """``run_loop`` in each package at once, each in a thread of its own;
    ``inspect`` runs on the port's. Raises the first failure."""
    out, errors = {}, {}

    def one(pkg, rt, rl):
        port = pkg == "port"
        try:
            out[pkg] = run_loop(rt, rl, make_config, port=port,
                                iters=iters,
                                inspect=inspect if port else None)
        except BaseException as e:  # noqa: BLE001 — raised below
            errors[pkg] = e

    threads = [threading.Thread(target=one, args=(pkg, *pair), daemon=True)
               for pkg, pair in packages(both).items()]
    for t in threads:
        t.start()
    for t in threads:
        t.join()
    for pkg in ("jax", "port"):
        if pkg in errors:
            raise errors[pkg]
    return out


def build_and_stop(configs, envs):
    """Each config's fields equal the JAX config's; on a port runtime of
    its own, ``build(device="cpu")`` (one runner, the env ``envs`` names
    or the sign task) returns the algorithm of JAX's class name, and
    ``stop()`` ends every runner's worker."""
    import ray_tpu.rllib
    import ray_tpu_torch as rt
    from ray_tpu_torch import rllib as trl

    rt.init(num_cpus=2, num_gpus=0)
    try:
        before = set(worker_pids())
        algos = []
        for cfg in configs:
            name = type(cfg).__name__
            ref = getattr(ray_tpu.rllib, name)()
            got, want = vars(cfg), vars(ref)
            if name == "AlphaZeroConfig":  # a class of each package
                assert got["game"].__name__ == want["game"].__name__
                got, want = ({k: v for k, v in d.items() if k != "game"}
                             for d in (got, want))
            assert got == want, name
            env, training = envs.get(name, (Sign, {}))
            if env is not None:
                cfg.environment(env)
            cfg.env_runners(num_env_runners=1).training(**training)
            algo = cfg.build(device="cpu")
            assert type(algo) is getattr(trl, name[:-len("Config")])
            assert type(algo).__name__ == getattr(
                ray_tpu.rllib, name[:-len("Config")]).__name__
            algos.append(algo)
        pids = sorted(set(worker_pids()) - before)
        assert len(pids) == len(configs), pids
        for algo in algos:
            algo.stop()
        assert_gone(pids)
    finally:
        rt.shutdown()


def plain(x):
    if isinstance(x, dict):
        return {k: plain(v) for k, v in x.items()}
    if isinstance(x, (list, tuple)):
        return type(x)(plain(v) for v in x)
    return x


def assert_same(j, p, path="", exact=True):
    """``p`` equal to ``j`` leaf for leaf: bitwise, except under a key of
    LEARNER_KEYS (a worker-learner's gradient or loss), within the stat
    tolerance taken against the largest entry of the leaf's tensor."""
    if isinstance(j, dict):
        assert isinstance(p, dict) and p.keys() == j.keys(), (path, p, j)
        for k in j:
            assert_same(j[k], p[k], f"{path}/{k}",
                        exact and k not in LEARNER_KEYS)
    elif isinstance(j, (list, tuple)):
        assert len(p) == len(j), path
        for i, (a, b) in enumerate(zip(j, p)):
            assert_same(a, b, f"{path}[{i}]", exact)
    elif isinstance(j, (np.ndarray, np.generic, float, int, bool)):
        a, b = np.asarray(j), np.asarray(p)
        assert a.shape == b.shape, path
        if exact:
            assert a.dtype == b.dtype, (path, a.dtype, b.dtype)
            np.testing.assert_array_equal(b, a, err_msg=path)
        else:  # a gradient tensor against its own scale
            scale = float(np.abs(a).max()) if a.size else 0.0
            np.testing.assert_allclose(b, a, rtol=0,
                                       atol=ATOL + RTOL * scale,
                                       err_msg=path)
    else:
        assert p == j, (path, p, j)


def actions_of(x):
    """The sampled actions inside one recorded ``get`` value: a fragment's
    action column (or slate), a self-play result's states."""
    if isinstance(x, dict):
        return [x[k] for k in ACTION_KEYS if k in x]
    if isinstance(x, tuple) and len(x) == 3 and all(
            isinstance(v, np.ndarray) for v in x):
        return [x[0]]
    if isinstance(x, (list, tuple)):
        return [a for v in x for a in actions_of(v)]
    return []


def flat(tree, prefix=""):
    if isinstance(tree, dict):
        out = {}
        for k, v in tree.items():
            out.update(flat(v, f"{prefix}/{k}"))
        return out
    if isinstance(tree, (list, tuple)):
        out = {}
        for i, v in enumerate(tree):
            out.update(flat(v, f"{prefix}[{i}]"))
        return out
    return {prefix: np.asarray(tree)}


def assert_results_close(j, p, what):
    assert p.keys() == j.keys(), (what, sorted(p), sorted(j))
    for k, w in j.items():
        g = p[k]
        if isinstance(w, (bool, int, np.integer)) and not isinstance(
                w, float):
            assert g == w, (what, k, g, w)
        else:
            np.testing.assert_allclose(
                float(g), float(w), rtol=RTOL, atol=ATOL,
                err_msg=f"{what}: {k}")


def assert_parity(out, what, later="actions"):
    """The loop's two runs agree as the module docstring states. With
    ``later="all"`` (the worker-learner loops, whose fragments never reach
    the driver) every later ``get`` value is held as iteration 1's are."""
    (jres, jgets, jw, _), (pres, pgets, pw, pids) = out["jax"], out["port"]
    assert_same(plain(jgets[0]), plain(pgets[0]), f"{what} iteration 1")
    for it in range(1, len(jgets)):
        if later == "all":
            assert_same(plain(jgets[it]), plain(pgets[it]),
                        f"{what} iteration {it + 1}")
            continue
        ja, pa = actions_of(plain(jgets[it])), actions_of(plain(pgets[it]))
        assert len(ja) == len(pa) and ja, (what, it)
        for a, b in zip(ja, pa):
            if np.issubdtype(a.dtype, np.floating):
                np.testing.assert_allclose(b, a, atol=1e-4, rtol=0)
            else:
                np.testing.assert_array_equal(b, a, err_msg=f"{what} {it}")
    for it, (j, p) in enumerate(zip(jres, pres)):
        assert_results_close(j, p, f"{what} iteration {it + 1}")
    fj, fp = flat(jw), flat(pw)
    assert fj.keys() == fp.keys(), what
    for k in fj:
        d = float(np.abs(fp[k] - fj[k]).max()) if fj[k].size else 0.0
        assert d <= WEIGHT_TOL, (what, k, d)
    assert pids, what
    assert_gone(pids)
    return jres, pres


def small(config, env, **training):
    """The loops' small settings: hidden 16, two runners of 32 steps, the
    seed 0, and ``training``."""
    return (config.environment(env)
            .env_runners(num_env_runners=2, rollout_fragment_length=32)
            .training(hidden_size=16, **training)
            .debugging(seed=0))


def alpha_zero(rl):
    config = (rl.AlphaZeroConfig().env_runners(num_env_runners=2)
              .training(lr=3e-3, minibatch_size=32, hidden_size=16)
              .debugging(seed=0))
    config.num_simulations = 8
    config.games_per_iteration = 2
    config.train_batches_per_iteration = 2
    return config


CONFIGS = {
    "alpha_zero": alpha_zero,
    "ppo": lambda rl: small(rl.PPOConfig(), Sign, lr=5e-3,
                            train_batch_size=64, minibatch_size=32,
                            num_epochs=2),
    "a2c": lambda rl: small(rl.A2CConfig(), Sign, lr=5e-3,
                            train_batch_size=64, minibatch_size=32),
    "pg": lambda rl: small(rl.PGConfig(), Sign, lr=5e-3,
                           train_batch_size=64, minibatch_size=32),
    "impala_one_runner": lambda rl: small(
        rl.IMPALAConfig(), Sign, lr=5e-3).env_runners(num_env_runners=1),
}


@pytest.mark.parametrize("name", sorted(CONFIGS))
@bounded
def test_loop_matches_jax(name, both):
    jres, pres = assert_parity(run_both(both, CONFIGS[name]), name)
    if name.startswith("impala"):
        assert [r["num_batches_consumed"] for r in pres] == [1, 1]
    if name == "alpha_zero":
        assert pres[1]["num_positions"] > pres[0]["new_positions"]


@bounded
def test_remote_learner_group_matches_a_local_learner(both):
    """LearnerGroup(remote=True) in a CPU actor gives the local learner's
    stats and weights exactly; update_async's ref resolves to the same
    stats; shutdown() ends the actor's worker."""
    import ray_tpu_torch as rt
    from ray_tpu_torch.rllib import LearnerGroup

    rng = np.random.RandomState(3)
    batches = [{"obs": rng.choice([-1.0, 1.0], (32, 1)).astype(np.float32),
                "actions": rng.randint(0, 2, 32).astype(np.int32),
                "old_logp": np.log(np.full(32, 0.5, np.float32)),
                "adv": rng.randn(32).astype(np.float32),
                "returns": rng.randn(32).astype(np.float32)}
               for _ in range(2)]
    before = set(worker_pids())
    group = LearnerGroup(functools.partial(make_sign_learner, "cpu"),
                         remote=True)
    assert group.is_remote
    local = LearnerGroup(functools.partial(make_sign_learner, "cpu"))
    assert not local.is_remote
    try:
        assert group.update(batches[0]) == local.update(batches[0])
        ref = group.update_async(batches[1])
        assert isinstance(ref, rt.ObjectRef)
        assert rt.get(ref) == local.update(batches[1])
        assert_same(plain(local.get_weights()), plain(group.get_weights()))
    finally:
        pids = sorted(set(worker_pids()) - before)
        group.shutdown()
    assert len(pids) == 1, pids
    assert_gone(pids)


def _lambda_env():
    return Sign()


@bounded
def test_what_a_worker_cannot_import_is_refused_by_name(both):
    """A lambda env, a local env class and a lambda learner factory raise
    TypeError naming them when the port starts its actors, before any
    worker runs."""
    from ray_tpu_torch.rllib import LearnerGroup, PPOConfig

    class LocalEnv(Sign):
        pass

    before = set(worker_pids())
    for env, name in ((lambda: Sign(), "<lambda>"),
                      (LocalEnv, "LocalEnv")):
        config = small(PPOConfig(), env, train_batch_size=64)
        with pytest.raises(TypeError, match=name):
            config.build(device="cpu")
    with pytest.raises(TypeError, match="<lambda>"):
        LearnerGroup(lambda: make_sign_learner(), remote=True)
    assert set(worker_pids()) <= before


@bounded
def test_stop_leaves_no_runner_worker(both):
    from ray_tpu_torch.rllib import A2CConfig

    before = set(worker_pids())
    algo = small(A2CConfig(), Sign, train_batch_size=64).build(device="cpu")
    assert type(algo).__name__ == "A2C" and algo.device.type == "cpu"
    algo.train()
    pids = sorted(set(worker_pids()) - before)
    assert len(pids) == 2, pids
    algo.stop()
    assert_gone(pids)


@bounded
def test_the_listener_queues_a_burst_of_worker_connects(both):
    """32 connects at once to the runtime's listener all complete at the
    kernel while its accept loop is busy with the first: a burst of
    starting workers (17d starts 26) is queued, not dropped. With a
    backlog of one the kernel dropped the rest, each retried after 1, 3,
    7, ... s, and one runner of 26 had not connected after 120 s."""
    import socket

    from ray_tpu_torch.core.runtime_context import current_runtime

    host, port = current_runtime()._address.rsplit(":", 1)
    socks = []
    try:
        for _ in range(32):
            s = socket.socket()
            s.settimeout(2.0)
            try:
                s.connect((host, int(port)))
                socks.append(s)
            except OSError:
                s.close()
        connected = len(socks)
    finally:
        for s in socks:
            s.close()
    assert connected == 32, connected


def test_importing_rllib_loads_no_torch():
    """``import ray_tpu_torch.rllib`` and its rollout modules (what a
    runner's worker loads) import no torch, JAX or JAX package; the
    torch-backed names resolve on first use."""
    code = (
        "import sys\n"
        "import ray_tpu_torch.rllib as rl\n"
        "from ray_tpu_torch.rllib import algorithm, env_runner, policy\n"
        "from ray_tpu_torch.rllib import replay_buffers, sample_batch\n"
        "heavy = ('torch', 'jax', 'ray_tpu', 'cloudpickle')\n"
        "print(sorted(m for m in heavy if m in sys.modules))\n"
        "print(rl.DDPPO.__module__, rl.A3C.__name__, 'torch' in sys.modules)\n"
    )
    out = subprocess.run([sys.executable, "-c", code], cwd=REPO, check=True,
                         capture_output=True, text=True, timeout=120)
    assert out.stdout.splitlines() == [
        "[]", "ray_tpu_torch.rllib.ddppo A3C True"], out.stdout
