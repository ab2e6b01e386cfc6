"""The port's trainer (``ray_tpu_torch.train.TorchTrainer``) on a Llama,
under DDP and through its gang supervisor:

- A 2-layer, width-64 Llama (``LlamaConfig.tiny()``) trained 4 steps by
  the port's trainer at world size 1, crashing at step 2 with
  ``max_failures=1``: the losses equal the port's straight
  ``CompiledTrainStep`` run exactly, and JAX's ``CompiledTrainStep`` at
  1e-4, from JAX's weights carried by ``params_from_numpy``.
- At world size 2 over gloo, one DDP step through ``prepare_model``
  leaves both ranks' weights within 1e-6 of one process stepping on the
  whole batch.
- The gang supervisor's dead-rank verdict
  (``tests/test_train_elastic.py:240``'s case) and the ``train_worker``
  fault point that ``session.report`` fires.

The JAX-against-port cases of ``tests/test_train.py`` are in
``test_torch_trainer.py``. The loops are module-level functions that the
port's workers import by name, so this module imports nothing heavy at the
top.
"""

import os
import time

import numpy as np
import pytest

TOKENS = np.random.RandomState(0).randint(0, 256, (2, 17)).astype(np.int32)
LLAMA_STEPS = 4


def port_llama(config):
    """4 steps of the tiny Llama from JAX's weights; a committed
    checkpoint every step; the first attempt dies at step 2."""
    import torch

    from ray_tpu_torch import train
    from ray_tpu_torch.models import LlamaConfig, params_from_numpy
    from ray_tpu_torch.train import Checkpoint, CompiledTrainStep

    sess = train.get_session()
    step = CompiledTrainStep(LlamaConfig.tiny(), device="cpu")
    start = sess.get_checkpoint()
    if start is not None:
        state = start.as_pytree(device="cpu")
        params, opt, first = state["params"], state["opt_state"], \
            state["step"] + 1
    else:
        params = params_from_numpy(config["params"], step.cfg, "cpu")
        opt, first = step.optimizer.init(params), 0
    tokens = torch.from_numpy(TOKENS)
    for i in range(first, LLAMA_STEPS):
        if i == 2 and not os.path.exists(config["marker"]):
            open(config["marker"], "w").close()
            os._exit(1)
        params, opt, loss = step(params, opt, tokens)
        ckpt = Checkpoint.from_pytree(
            {"params": params, "opt_state": opt, "step": i},
            sess.checkpoint_dir(i), step=i)
        train.report({"step": i, "loss": loss.item()}, checkpoint=ckpt)


def ddp_model(weights):
    import torch

    model = torch.nn.Linear(4, 3)
    with torch.no_grad():
        model.weight.copy_(torch.from_numpy(weights["w"]))
        model.bias.copy_(torch.from_numpy(weights["b"]))
    return model


def ddp_step(model, x, y):
    import torch

    opt = torch.optim.SGD(model.parameters(), lr=0.1)
    loss = torch.nn.functional.mse_loss(model(x), y)
    loss.backward()
    opt.step()


def port_ddp(config):
    """One DDP step on this rank's half of the batch; each rank saves its
    weights."""
    import torch

    from ray_tpu_torch import train

    rank = train.get_world_rank()
    model = train.prepare_model(ddp_model(config))
    half = slice(4 * rank, 4 * rank + 4)
    ddp_step(model, torch.from_numpy(config["x"][half]),
             torch.from_numpy(config["y"][half]))
    net = model.module
    np.savez(os.path.join(train.get_session().storage_dir,
                          f"rank{rank}.npz"),
             w=net.weight.detach().numpy(), b=net.bias.detach().numpy())
    train.report({"rank": rank, "world": train.get_world_size(),
                  "wrapped": type(model).__name__})


def port_elastic(config):
    """The elastic loop of tests/test_train_elastic.py: w += 1 a step, a
    committed checkpoint every step (rank 0), optional crash."""
    import torch

    from ray_tpu_torch import train

    sess = train.get_session()
    start = sess.get_checkpoint()
    if start is not None:
        state = start.as_pytree(device="cpu")
        w, first = float(state["w"][0]), int(state["step"]) + 1
    else:
        w, first = 0.0, 0
    for step in range(first, config.get("steps", 4)):
        if sess.preemption_requested():
            break
        marker = config.get("crash_marker")
        if (marker and step == config.get("crash_step")
                and sess.world_rank == config.get("crash_rank", 0)
                and not os.path.exists(marker)):
            open(marker, "w").close()
            os._exit(1)
        w += 1.0
        ckpt = None
        if sess.world_rank == 0:
            ckpt = train.Checkpoint.from_pytree(
                {"w": torch.tensor([w]), "step": torch.tensor(step)},
                sess.checkpoint_dir(step), step=step,
                metadata={"step": step})
        train.report({"step": step, "w": w}, checkpoint=ckpt)


@pytest.fixture(scope="module")
def port_rt():
    import ray_tpu_torch

    ray_tpu_torch.init(num_cpus=4, num_gpus=0)
    yield ray_tpu_torch
    ray_tpu_torch.shutdown()


def _fit(loop, path, config=None, workers=1, failures=0):
    from ray_tpu_torch.train import (FailureConfig, RunConfig, ScalingConfig,
                                     TorchTrainer)

    return TorchTrainer(
        loop, train_loop_config=config,
        scaling_config=ScalingConfig(num_workers=workers, use_gpu=False),
        run_config=RunConfig(
            storage_path=str(path),
            failure_config=FailureConfig(max_failures=failures)),
    ).fit()


# ------------------------------------------------------------- Llama


@pytest.fixture(scope="module")
def llama_weights():
    import jax

    from ray_tpu.models import LlamaConfig as JaxConfig
    from ray_tpu.models import init_params

    return jax.tree.map(np.asarray, init_params(JaxConfig.tiny(),
                                                jax.random.PRNGKey(0)))


def test_llama_trainer_with_restart_matches_straight_and_jax(
        port_rt, llama_weights, tmp_path):
    import jax.numpy as jnp
    import torch

    from ray_tpu.models import LlamaConfig as JaxConfig
    from ray_tpu.models import init_params
    from ray_tpu.train.compiled_step import CompiledTrainStep as JaxStep
    from ray_tpu_torch.models import LlamaConfig, params_from_numpy
    from ray_tpu_torch.train import CompiledTrainStep

    result = _fit(port_llama, tmp_path / "run",
                  {"params": llama_weights,
                   "marker": str(tmp_path / "crashed")}, failures=1)
    assert result.error is None, result.error
    assert [m["step"] for m in result.metrics_history] == [0, 1, 2, 3]
    losses = [m["loss"] for m in result.metrics_history]

    step = CompiledTrainStep(LlamaConfig.tiny(), device="cpu")
    params = params_from_numpy(llama_weights, step.cfg, "cpu")
    opt = step.optimizer.init(params)
    straight = [step(params, opt, torch.from_numpy(TOKENS))[2].item()
                for _ in range(LLAMA_STEPS)]
    assert losses == straight

    import jax

    jstep = JaxStep(JaxConfig.tiny(), donate=False)
    jp = init_params(JaxConfig.tiny(), jax.random.PRNGKey(0))
    jo = jstep.tx.init(jp)
    jax_losses = []
    for _ in range(LLAMA_STEPS):
        jp, jo, loss = jstep(jp, jo, jnp.asarray(TOKENS))
        jax_losses.append(float(loss))
    np.testing.assert_allclose(losses, jax_losses, atol=1e-4, rtol=1e-4)
    final = result.checkpoint.as_pytree(device="cpu")
    assert final["step"] == LLAMA_STEPS - 1
    for name, leaf in final["params"]["layers"].items():
        assert torch.equal(leaf, params["layers"][name]), name


def test_ddp_step_at_world_size_two_matches_one_process(port_rt, tmp_path):
    import torch

    rs = np.random.RandomState(3)
    config = {"w": rs.randn(3, 4).astype(np.float32),
              "b": rs.randn(3).astype(np.float32),
              "x": rs.randn(8, 4).astype(np.float32),
              "y": rs.randn(8, 3).astype(np.float32)}
    result = _fit(port_ddp, tmp_path, config, workers=2)
    assert result.error is None, result.error
    assert result.metrics == {"rank": 0, "world": 2,
                              "wrapped": "DistributedDataParallel"}
    model = ddp_model(config)
    ddp_step(model, torch.from_numpy(config["x"]),
             torch.from_numpy(config["y"]))
    for rank in (0, 1):
        got = np.load(tmp_path / f"rank{rank}.npz")
        np.testing.assert_allclose(got["w"], model.weight.detach().numpy(),
                                   atol=1e-6, rtol=0)
        np.testing.assert_allclose(got["b"], model.bias.detach().numpy(),
                                   atol=1e-6, rtol=0)


# ----------------------------------------------------- the supervisor


def _train_events(after):
    from ray_tpu_torch.util import events

    return [e["message"] for e in events.list_events(source="TRAIN")
            if e["ts"] >= after]


def test_gang_restart_on_dead_rank(port_rt, tmp_path):
    """Rank 0 of a gang of 2 dies hard (os._exit) mid-run: the supervisor
    aborts the whole gang, restarts from the last committed checkpoint,
    and the run completes with the exact resumed state."""
    t0 = time.time()
    marker = str(tmp_path / "crashed")
    result = _fit(port_elastic, tmp_path / "run",
                  {"steps": 4, "crash_marker": marker, "crash_step": 2,
                   "crash_rank": 0}, workers=2, failures=1)
    assert result.error is None, result.error
    assert os.path.exists(marker)
    assert result.metrics["step"] == 3
    assert result.metrics["w"] == 4.0  # resumed, not recomputed
    assert result.checkpoint is not None and result.checkpoint.is_committed()
    seen = _train_events(t0)
    assert any("aborted" in m for m in seen), seen
    assert any("restarting after failure" in m for m in seen), seen
    assert any("recovered" in m for m in seen), seen


def test_train_worker_fault_in_report_restarts_the_gang(port_rt, tmp_path):
    """An armed train_worker spec fires in session.report (the rank's
    third report raises an injected ConnectionError); the supervisor
    restarts the gang from the last committed checkpoint and the run ends
    as an uninterrupted one would."""
    from ray_tpu_torch.util import faults, metrics

    def restarts():
        series = metrics.get_metrics_report().get(
            "ray_tpu_train_restarts_total", {}).get("series", {})
        return series.get((("reason", "error"),), 0.0)

    before = restarts()
    faults.apply_plan([{"point": "train_worker", "mode": "once", "n": 3,
                        "match": {"rank": "0"}}])
    try:
        result = _fit(port_elastic, tmp_path, {"steps": 4},
                      failures=1)
    finally:
        faults.clear()
    assert result.error is None, result.error
    assert restarts() == before + 1
    assert [m["step"] for m in result.metrics_history] == [0, 1, 2, 3]
    assert result.metrics["w"] == 4.0
    assert any("injected error at train_worker" in m
               for m in _train_events(0)), _train_events(0)


def test_trainer_defaults_to_the_card(port_rt, tmp_path):
    """ScalingConfig() gives each rank a card; fit on a node without GPUs
    raises rather than train on the CPU, and get_device() outside a
    session is the card, raising without one."""
    import torch

    from ray_tpu_torch import train
    from ray_tpu_torch.train import RunConfig, ScalingConfig, TorchTrainer

    assert ScalingConfig().use_gpu
    assert ScalingConfig().worker_resources() == {"GPU": 1}
    assert ScalingConfig(use_gpu=False).worker_resources() == {"CPU": 1}
    trainer = TorchTrainer(port_elastic, train_loop_config={"steps": 1},
                           run_config=RunConfig(storage_path=str(tmp_path)))
    with pytest.raises(RuntimeError, match="has no GPU"):
        trainer.fit()
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="no CUDA device"):
            train.get_device()
