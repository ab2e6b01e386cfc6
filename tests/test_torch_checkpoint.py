"""The port's checkpoints (``ray_tpu_torch/train/checkpoint.py``) and
fault points (``ray_tpu_torch/util/faults.py``) against the JAX package's,
on the CPU.

- Protocol: the scenarios of ``tests/test_train_elastic.py`` (an atomic
  commit, a save failed by ``checkpoint_io`` that leaves nothing, the
  fallback past a torn, an uncommitted and a ``.tmp-`` directory, the
  manager's retention at ties and with a missing score) run against both
  packages, which must make the same decisions.
- Faults: the same plans fire the same way in both packages.
- Round trip: a tree comes back bitwise, dtypes included (bf16, ints,
  numpy, Python scalars, ``AdamState``); a ``target`` that does not match
  raises.
- Resume: tiny Llama in float32, 1 step, save, restore, 2 steps, against
  3 steps straight: losses and weights exactly equal.
- Mesh: one gloo world of 4 processes saves the training state under
  ``fsdp=2, tp=2`` and the tiny MoE's under ``ep=2, pp=2``, restores each
  under another mesh, and has a fault on one rank fail the save on every
  rank. The parent restores each at world size 1; every rank's saved and
  restored slices must be that global tree's blocks, bitwise, cut with
  numpy from JAX's specs.
"""

import os

import numpy as np
import pytest
import torch

from test_torch_parallel import WORLD, cpu_mesh, ranks, run_world

from ray_tpu_torch.models import LlamaConfig
from ray_tpu_torch.models.llama import param_logical_axes
from ray_tpu_torch.train import AdamState, CompiledTrainStep
from ray_tpu_torch.train import checkpoint as port_ckpt
from ray_tpu_torch.util import faults as port_faults

TOKENS = np.random.RandomState(0).randint(0, 256, (3, 4, 17)).astype(
    np.int32)
SAVE_MESHES = {"dense": (False, dict(dp=1, fsdp=2, tp=2)),
               "moe": (True, dict(dp=1, ep=2, pp=2))}
RESTORE_MESHES = {"dense": dict(dp=1, fsdp=4),
                  "moe": dict(dp=1, fsdp=2, tp=2)}


# ------------------------------------------------------------ protocol

@pytest.fixture(autouse=True)
def _no_jax_chaos_events(monkeypatch):
    """JAX's ``fire`` records a CHAOS event and a flight-recorder entry per
    firing in this process, where later test files of the same worker
    would find them; the port records none (ROADMAP Queue 3), and the
    tests compare decisions, not events."""
    from ray_tpu.util import faults

    monkeypatch.setattr(faults, "_emit_chaos_event", lambda *a: None)


class _Pkg:
    """One package's checkpoint module, faults and tree type."""

    def __init__(self, name):
        self.name = name
        if name == "jax":
            import jax.numpy as jnp

            from ray_tpu.train import checkpoint
            from ray_tpu.util import faults

            self.array = lambda a: jnp.asarray(a)
        else:
            checkpoint, faults = port_ckpt, port_faults
            self.array = torch.as_tensor
        self.ck, self.faults = checkpoint, faults

    def make(self, path, step, value=1.0):
        return self.ck.Checkpoint.from_pytree(
            {"w": self.array(np.asarray([value], np.float32)),
             "step": self.array(np.asarray(step, np.int32))},
            str(path), metadata={"step": step}, step=step, world_size=1)

    def restore(self, ckpt):
        if self.name == "jax":
            tree = ckpt.as_pytree()
        else:
            tree = ckpt.as_pytree(device="cpu")
        return float(np.asarray(tree["w"])[0]), int(np.asarray(tree["step"]))


def _listing(root):
    return sorted(os.listdir(root))


def scenario_atomic(pkg, root):
    ck = pkg.make(root / "ck", step=7, value=3.0)
    manifest = ck.manifest()
    assert manifest["files"]
    return dict(committed=ck.is_committed(), step=manifest["step"],
                world_size=manifest["world_size"], ck_step=ck.step,
                manifest_has_marker=os.path.exists(
                    os.path.join(ck.path, pkg.ck.COMMIT_MANIFEST)),
                metadata=ck.metadata(), listing=_listing(root),
                restored=pkg.restore(ck))


def scenario_failed_save(pkg, root):
    out = {}
    for op in ("save", "restore"):
        pkg.faults.apply_plan([{"point": "checkpoint_io", "mode": "always",
                                "match": {"op": op}}])
        try:
            if op == "save":
                with pytest.raises(pkg.faults.InjectedFault):
                    pkg.make(root / "ck", step=1)
            else:
                good = pkg.make(root / "good", step=2)
                with pytest.raises(pkg.faults.InjectedFault):
                    pkg.restore(good)
        finally:
            pkg.faults.clear()
        out[op] = _listing(root)
    latest = pkg.ck.latest_committed(str(root))
    return dict(listings=out, latest=os.path.basename(latest.path),
                restored=pkg.restore(latest))


def scenario_fallback(pkg, root):
    pkg.make(root / "checkpoint_000001", step=1, value=1.0)
    pkg.make(root / "checkpoint_000002", step=2, value=2.0)
    corrupt = pkg.make(root / "checkpoint_000003", step=3)
    uncommitted = pkg.make(root / "checkpoint_000004", step=4)
    # A torn payload file (the first the manifest lists under pytree/),
    # a missing commit marker, and a stale staging directory.
    rel = next(r for r in sorted(corrupt.manifest()["files"])
               if r.startswith("pytree/"))
    with open(os.path.join(corrupt.path, rel), "w") as f:
        f.write("")
    os.remove(os.path.join(uncommitted.path, pkg.ck.COMMIT_MANIFEST))
    os.makedirs(root / ".tmp-checkpoint_000005-dead")
    found = pkg.ck.latest_committed(str(root))
    return dict(found=os.path.basename(found.path),
                committed=[pkg.ck.Checkpoint(str(root / n)).is_committed()
                           for n in _listing(root)],
                restored=pkg.restore(found), listing=_listing(root))


def scenario_retention(pkg, root):
    M = pkg.ck.CheckpointManager
    out = {}
    # Score ties at num_to_keep=2: the best (first maximal) and the newest
    # committed survive; the middle goes.
    m = M(str(root / "a"), num_to_keep=2, score_attribute="acc",
          score_order="max")
    for i in range(3):
        m.register(pkg.make(root / "a" / f"ck{i}", step=i), {"acc": 0.5},
                   step=i)
    out["ties"] = (_listing(root / "a"), os.path.basename(m.best.path))
    # A missing score attribute falls back to recency.
    m = M(str(root / "b"), num_to_keep=1, score_attribute="absent",
          score_order="max")
    m.register(pkg.make(root / "b" / "ck0", step=0), {"loss": 1.0}, step=0)
    m.register(pkg.make(root / "b" / "ck1", step=1), {"loss": 0.5}, step=1)
    out["missing"] = (_listing(root / "b"), os.path.basename(m.latest.path))
    # A worse-scored newcomer at num_to_keep=1: both survive.
    m = M(str(root / "c"), num_to_keep=1, score_attribute="acc",
          score_order="max")
    m.register(pkg.make(root / "c" / "ck0", step=0), {"acc": 0.9}, step=0)
    m.register(pkg.make(root / "c" / "ck1", step=1), {"acc": 0.1}, step=1)
    out["worse"] = (_listing(root / "c"), os.path.basename(m.best.path),
                    os.path.basename(m.latest_committed.path))
    # Uncommitted newer entries never justify deleting the only committed.
    m = M(str(root / "d"), num_to_keep=1)
    m.register(pkg.make(root / "d" / "ck0", step=0), {}, step=0)
    for i in (1, 2):
        p = root / "d" / f"ck{i}"
        os.makedirs(p)
        (p / "payload").write_text("not committed")
        m.register(pkg.ck.Checkpoint(str(p)), {}, step=i)
    out["only_committed"] = (_listing(root / "d"),
                             os.path.basename(m.latest.path))
    return out


SCENARIOS = {"atomic": scenario_atomic, "failed_save": scenario_failed_save,
             "fallback": scenario_fallback, "retention": scenario_retention}


@pytest.mark.parametrize("name", sorted(SCENARIOS))
def test_protocol_decisions_match_jax(tmp_path, name):
    got = {}
    for pkg in ("jax", "port"):
        root = tmp_path / pkg
        root.mkdir()
        got[pkg] = SCENARIOS[name](_Pkg(pkg), root)
    assert got["port"] == got["jax"]


def test_protocol_decisions_are_the_expected_ones(tmp_path):
    """The decisions both packages agree on are the contract's."""
    pkg = _Pkg("port")
    for name in SCENARIOS:
        (tmp_path / name).mkdir()
    atomic = scenario_atomic(pkg, tmp_path / "atomic")
    assert atomic["committed"] and atomic["step"] == 7
    assert atomic["world_size"] == 1 and atomic["metadata"] == {"step": 7}
    assert atomic["listing"] == ["ck"] and atomic["restored"] == (3.0, 7)
    failed = scenario_failed_save(pkg, tmp_path / "failed_save")
    assert failed["listings"] == {"save": [], "restore": ["good"]}
    fallback = scenario_fallback(pkg, tmp_path / "fallback")
    assert fallback["found"] == "checkpoint_000002"
    assert fallback["restored"] == (2.0, 2)
    retention = scenario_retention(pkg, tmp_path / "retention")
    assert retention["ties"] == (["ck0", "ck2"], "ck0")
    assert retention["missing"] == (["ck1"], "ck1")
    assert retention["worse"] == (["ck0", "ck1"], "ck0", "ck1")
    assert retention["only_committed"] == (["ck0", "ck1", "ck2"], "ck0")


PLANS = {
    "once": [{"point": "checkpoint_io", "mode": "once", "n": 3}],
    "every": [{"point": "checkpoint_io", "mode": "every", "n": 2,
               "max_fires": 3}],
    "prob": [{"point": "checkpoint_io", "mode": "prob", "p": 0.4,
              "seed": 7}],
    "latency_save_only": [{"point": "checkpoint_io", "action": "latency",
                           "delay_s": 0.25, "match": {"op": "save"}}],
}


@pytest.mark.parametrize("plan", sorted(PLANS))
def test_fault_schedules_match_jax(plan):
    got = {}
    for name in ("jax", "port"):
        faults = _Pkg(name).faults
        faults.apply_plan(PLANS[plan])
        seq = []
        try:
            for i in range(12):
                try:
                    seq.append(faults.fire("checkpoint_io",
                                           op="save" if i % 3 else
                                           "restore"))
                except faults.InjectedFault:
                    seq.append("fault")
            seq.append(faults.fired_counts())
        finally:
            faults.clear()
        assert not faults.armed() and faults.fire("checkpoint_io") == 0.0
        got[name] = seq
    assert got["port"] == got["jax"]
    assert "fault" in got["port"] or 0.25 in got["port"]


def test_fault_plan_that_does_not_validate_raises():
    with pytest.raises(ValueError, match="injection point"):
        port_faults.apply_plan([{"point": "heartbeat"}])
    with pytest.raises(ValueError, match="delay_s"):
        port_faults.apply_plan([{"point": "checkpoint_io",
                                 "action": "latency"}])
    assert not port_faults.armed()


# ----------------------------------------------------------- round trip

def _tree():
    rng = np.random.RandomState(1)
    f32 = torch.from_numpy(rng.randn(3, 5).astype(np.float32))
    return {
        "bf16": f32.to(torch.bfloat16),
        "f32": f32,
        "i64": torch.arange(7),
        "i32": torch.from_numpy(rng.randint(-9, 9, (2, 2)).astype(np.int32)),
        "flags": torch.tensor([True, False]),
        "np": rng.randn(4).astype(np.float16),
        "np_scalar": np.int64(5),
        "nested": [1, 2.5, None, "name", (True, torch.ones(2, 1))],
        "opt": AdamState(3, {"w": f32.to(torch.bfloat16)},
                         {"w": (f32 * f32).to(torch.bfloat16)}),
        "view": torch.arange(12.0).reshape(3, 4)[1:, ::2],
    }


def _assert_same(got, want):
    assert type(got) is type(want) or (
        isinstance(want, np.generic) and isinstance(got, np.ndarray))
    if isinstance(want, dict):
        assert list(got) == list(want)
        for k in want:
            _assert_same(got[k], want[k])
    elif isinstance(want, (list, tuple)):
        assert len(got) == len(want)
        for g, w in zip(got, want):
            _assert_same(g, w)
    elif isinstance(want, AdamState):
        for f in ("count", "mu", "nu"):
            _assert_same(getattr(got, f), getattr(want, f))
    elif isinstance(want, torch.Tensor):
        assert got.dtype == want.dtype and got.shape == want.shape
        assert torch.equal(got, want)
    elif isinstance(want, (np.ndarray, np.generic)):
        assert got.dtype == want.dtype and got.shape == np.shape(want)
        np.testing.assert_array_equal(got, want)
    else:
        assert got == want


def test_round_trip_is_bitwise(tmp_path):
    tree = _tree()
    ck = port_ckpt.Checkpoint.from_pytree(tree, str(tmp_path / "ck"),
                                          step=3)
    assert ck.is_committed() and ck.step == 3
    payload = [r for r in ck.manifest()["files"] if r.endswith(".pt")]
    assert len(payload) == 11  # one torch.save file per array leaf
    _assert_same(ck.as_pytree(device="cpu"), tree)
    _assert_same(ck.as_pytree(tree, device="cpu"), tree)
    # The view's file holds its 4 elements, not its base's 12.
    assert ck.as_pytree(device="cpu")["view"].untyped_storage().nbytes() \
        == 4 * 4


def test_round_trip_keeps_ml_dtypes_bfloat16(tmp_path):
    import ml_dtypes

    a = np.arange(6, dtype=np.float32).reshape(2, 3).astype(
        ml_dtypes.bfloat16)
    ck = port_ckpt.Checkpoint.from_pytree({"a": a}, str(tmp_path / "ck"))
    got = ck.as_pytree(device="cpu")["a"]
    assert got.dtype == a.dtype
    np.testing.assert_array_equal(got.view(np.uint16), a.view(np.uint16))


@pytest.mark.parametrize("change", ["shape", "dtype", "keys", "kind",
                                    "adam"])
def test_target_that_does_not_match_raises(tmp_path, change):
    tree = _tree()
    ck = port_ckpt.Checkpoint.from_pytree(tree, str(tmp_path / "ck"))
    target = dict(tree)
    if change == "shape":
        target["f32"] = torch.zeros(5, 3)
    elif change == "dtype":
        target["bf16"] = tree["f32"]
    elif change == "keys":
        del target["i64"]
    elif change == "kind":
        target["np"] = torch.from_numpy(tree["np"])
    else:
        target["opt"] = {"count": 3, "mu": tree["opt"].mu,
                         "nu": tree["opt"].nu}
    with pytest.raises(ValueError, match="checkpoint holds"):
        ck.as_pytree(target, device="cpu")


def test_restore_without_a_card_raises(tmp_path):
    if torch.cuda.is_available():
        pytest.skip("a card is present: the default restores onto it")
    ck = port_ckpt.Checkpoint.from_pytree({"w": torch.ones(2)},
                                          str(tmp_path / "ck"))
    with pytest.raises(RuntimeError, match="no CUDA device"):
        ck.as_pytree()


def test_torn_slice_fails_the_restore_too(tmp_path):
    """is_committed is what restore paths consult; a payload file that is
    missing altogether also fails the read itself."""
    ck = port_ckpt.Checkpoint.from_pytree({"w": torch.ones(2)},
                                          str(tmp_path / "ck"))
    rel = next(r for r in ck.manifest()["files"] if r.endswith(".pt"))
    os.remove(os.path.join(ck.path, rel))
    assert not ck.is_committed()
    with pytest.raises(FileNotFoundError):
        ck.as_pytree(device="cpu")


# --------------------------------------------------------------- resume

def test_resume_from_a_checkpoint_is_exact(tmp_path):
    cfg = LlamaConfig.tiny()
    toks = torch.from_numpy(TOKENS)
    straight = CompiledTrainStep(cfg, device="cpu")
    p, o = straight.init(torch.Generator().manual_seed(0))
    want = [straight(p, o, toks[i])[2].item() for i in range(3)]

    first = CompiledTrainStep(cfg, device="cpu")
    p1, o1 = first.init(torch.Generator().manual_seed(0))
    got = [first(p1, o1, toks[0])[2].item()]
    port_ckpt.Checkpoint.from_pytree(
        {"params": p1, "opt_state": o1, "step": 1}, str(tmp_path / "ck"),
        step=1)
    state = port_ckpt.Checkpoint(str(tmp_path / "ck")).as_pytree(
        device="cpu")
    assert isinstance(state["opt_state"], AdamState) and state["step"] == 1
    resumed = CompiledTrainStep(cfg, device="cpu")
    got += [resumed(state["params"], state["opt_state"], toks[i])[2].item()
            for i in (1, 2)]
    assert got == want
    _assert_same(state["params"], p)
    _assert_same(state["opt_state"], o)


# ----------------------------------------------------------------- mesh

def _flat(tree, prefix=""):
    if isinstance(tree, AdamState):
        tree = {"count": tree.count, "mu": tree.mu, "nu": tree.nu}
    if isinstance(tree, dict):
        out = {}
        for k, v in tree.items():
            out.update(_flat(v, f"{prefix}{k}."))
        return out
    if isinstance(tree, torch.Tensor):
        tree = tree.detach().float().numpy().copy()
    return {prefix[:-1]: tree}


def task_mesh(rank, root):
    out = {}
    for key, (moe, sizes) in SAVE_MESHES.items():
        cfg = LlamaConfig.tiny(moe=moe)
        step = CompiledTrainStep(cfg, mesh=cpu_mesh(**sizes))
        params, opt = step.init(torch.Generator().manual_seed(0))
        step(params, opt, step.token_sharding().cut(
            torch.from_numpy(TOKENS[0])))
        state = {"params": params, "opt_state": opt, "step": 1}
        path = os.path.join(root, key)
        port_ckpt.Checkpoint.from_pytree(
            state, path, step=1, mesh=step.mesh,
            logical_axes=step.state_logical_axes())
        other = CompiledTrainStep(cfg, mesh=cpu_mesh(**RESTORE_MESHES[key]))
        got = port_ckpt.Checkpoint(path).as_pytree(
            mesh=other.mesh, logical_axes=other.state_logical_axes())
        out[key] = dict(saved=_flat(state), restored=_flat(got))
    # A fault on rank 1 alone: every rank raises and nothing commits.
    if rank == 1:
        port_faults.apply_plan([{"point": "checkpoint_io",
                                 "match": {"op": "save"}}])
    try:
        port_ckpt.Checkpoint.from_pytree(
            state, os.path.join(root, "faulted"), mesh=step.mesh,
            logical_axes=step.state_logical_axes())
        out["fault"] = "committed"
    except Exception as e:  # noqa: BLE001 — the error is the result
        out["fault"] = f"{type(e).__name__}: {e}"
    finally:
        port_faults.clear()
    # Axes that leave the moments out: the save and the restore raise.
    params_only = {"params": step.state_logical_axes()["params"]}
    for what, call in (
            ("no_axes_save", lambda: port_ckpt.Checkpoint.from_pytree(
                state, os.path.join(root, "no_axes"), mesh=step.mesh,
                logical_axes=params_only)),
            ("no_axes_restore", lambda: port_ckpt.Checkpoint(
                os.path.join(root, "moe")).as_pytree(
                    mesh=step.mesh, logical_axes=params_only))):
        try:
            call()
            out[what] = "passed"
        except Exception as e:  # noqa: BLE001 — the error is the result
            out[what] = f"{type(e).__name__}: {e}"
    return out


RANK_TASKS = {"mesh": task_mesh}


@pytest.fixture(scope="module")
def mesh_world(tmp_path_factory):
    root = tmp_path_factory.mktemp("ckpt_world")
    world = run_world(root, __name__, [("mesh", (str(root / "ckpts"),))])
    return root / "ckpts", ranks(world, "mesh")


def _state_specs(cfg, sizes):
    """JAX's pruned spec of every flat leaf of the training state."""
    from test_torch_sharded_llama import _spec

    out = {"opt_state.count": None, "step": None}
    for k, v in _flat(param_logical_axes(cfg)).items():
        for prefix in ("params.", "opt_state.mu.", "opt_state.nu."):
            out[prefix + k] = _spec(sizes, v)
    return out


@pytest.mark.parametrize("key", sorted(SAVE_MESHES))
def test_mesh_save_restores_bitwise_at_world_size_1(mesh_world, key):
    from test_torch_sharded_llama import _local

    root, results = mesh_world
    moe, sizes = SAVE_MESHES[key]
    ck = port_ckpt.Checkpoint(str(root / key))
    manifest = ck.manifest()
    assert ck.is_committed()
    assert (manifest["step"], manifest["world_size"]) == (1, WORLD)
    whole = _flat(ck.as_pytree(device="cpu"))
    cfg = LlamaConfig.tiny(moe=moe)
    specs = _state_specs(cfg, sizes)
    assert set(whole) == set(specs)
    for name, spec in specs.items():
        for rank, res in enumerate(results):
            saved = res[key]["saved"][name]
            if spec is None:
                assert saved == whole[name]
                continue
            np.testing.assert_array_equal(
                _local(whole[name], spec, sizes, rank), saved,
                err_msg=f"{key} {name} rank {rank}")


@pytest.mark.parametrize("key", sorted(SAVE_MESHES))
def test_mesh_save_restores_bitwise_under_another_mesh(mesh_world, key):
    from test_torch_sharded_llama import _local

    root, results = mesh_world
    moe, _ = SAVE_MESHES[key]
    sizes = RESTORE_MESHES[key]
    whole = _flat(port_ckpt.Checkpoint(str(root / key)).as_pytree(
        device="cpu"))
    specs = _state_specs(LlamaConfig.tiny(moe=moe), sizes)
    for rank, res in enumerate(results):
        got = res[key]["restored"]
        assert set(got) == set(specs)
        for name, spec in specs.items():
            if spec is None:
                assert got[name] == whole[name]
                continue
            want = _local(whole[name], spec, sizes, rank)
            assert got[name].shape == want.shape
            np.testing.assert_array_equal(got[name], want,
                                          err_msg=f"{key} {name} rank {rank}")


def test_fault_on_one_rank_fails_the_save_on_every_rank(mesh_world):
    root, results = mesh_world
    assert results[1]["fault"].startswith("InjectedFault")
    for rank in (0, 2, 3):
        assert results[rank]["fault"].startswith("RuntimeError"), rank
        assert "failed on another rank" in results[rank]["fault"]
    assert sorted(os.listdir(root)) == ["dense", "moe"]


def test_a_tensor_without_axes_under_a_mesh_raises(mesh_world):
    """Axes that leave the moments out raise on every rank, in the save
    (which leaves nothing) and in the restore: a leaf they miss could be
    sharded, and would be taken as replicated."""
    root, results = mesh_world
    for rank, res in enumerate(results):
        for what in ("no_axes_save", "no_axes_restore"):
            assert res[what].startswith("ValueError"), (rank, res[what])
            assert "has no logical axes under a mesh" in res[what]
    assert sorted(os.listdir(root)) == ["dense", "moe"]
