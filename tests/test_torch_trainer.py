"""The port's trainer (``ray_tpu_torch.train.TorchTrainer`` on the port's
runtime) against the JAX package's ``JaxTrainer``:
``tests/test_train.py:21-117``'s cases through both trainers, each
package with its own loop body: a basic report, two ranks, a checkpoint
round trip, a restart from the checkpoint after ``os._exit(1)``, an error
that surfaces. The Results agree: metrics, history length and the
restored checkpoint's values. ``test_torch_trainer_gang.py`` holds the
trainer's Llama, DDP and supervisor cases (the two files split the work
to stay within a minute each).

The loops are module-level functions: the port's workers import this
module by name, so it imports nothing heavy at the top; the JAX package's
workers get its loops by value (``cloudpickle``).
"""

import os
import sys
from concurrent.futures import ThreadPoolExecutor

import numpy as np
import pytest


# ----------------------------------------------------------- JAX loops


def jax_basic(config):
    from ray_tpu import train

    for step in range(3):
        train.report({"step": step, "loss": 1.0 / (step + 1)})


def jax_ranks():
    from ray_tpu import train

    train.report({"rank": train.get_world_rank(),
                  "world": train.get_world_size()})


def jax_checkpoint(config):
    import jax.numpy as jnp

    from ray_tpu import train

    sess = train.get_session()
    ckpt = train.Checkpoint.from_pytree(
        {"w": jnp.asarray([1.0, 2.0, 3.0]), "step": jnp.asarray(7)},
        sess.checkpoint_dir(0))
    train.report({"step": 0, "loss": 0.5}, checkpoint=ckpt)


def jax_restart(config):
    import jax.numpy as jnp

    from ray_tpu import train

    sess = train.get_session()
    start = sess.get_checkpoint()
    first = int(start.as_pytree()["step"]) + 1 if start else 0
    for step in range(first, 4):
        if step == 2 and not os.path.exists(config["marker"]):
            open(config["marker"], "w").close()
            os._exit(1)
        ckpt = train.Checkpoint.from_pytree({"step": jnp.asarray(step)},
                                            sess.checkpoint_dir(step))
        train.report({"step": step}, checkpoint=ckpt)


def jax_explodes():
    raise ValueError("train loop exploded")


# ---------------------------------------------------------- port loops


def port_basic(config):
    from ray_tpu_torch import train

    for step in range(3):
        train.report({"step": step, "loss": 1.0 / (step + 1)})


def port_ranks():
    from ray_tpu_torch import train

    train.report({"rank": train.get_world_rank(),
                  "world": train.get_world_size()})


def port_checkpoint(config):
    import torch

    from ray_tpu_torch import train

    sess = train.get_session()
    ckpt = train.Checkpoint.from_pytree(
        {"w": torch.tensor([1.0, 2.0, 3.0]), "step": torch.tensor(7)},
        sess.checkpoint_dir(0))
    train.report({"step": 0, "loss": 0.5}, checkpoint=ckpt)


def port_restart(config):
    import torch

    from ray_tpu_torch import train

    sess = train.get_session()
    start = sess.get_checkpoint()
    first = int(start.as_pytree(device="cpu")["step"]) + 1 if start else 0
    for step in range(first, 4):
        if step == 2 and not os.path.exists(config["marker"]):
            open(config["marker"], "w").close()
            os._exit(1)
        ckpt = train.Checkpoint.from_pytree({"step": torch.tensor(step)},
                                            sess.checkpoint_dir(step))
        train.report({"step": step}, checkpoint=ckpt)


def port_explodes():
    raise ValueError("train loop exploded")


# ------------------------------------------------------------ fixtures


@pytest.fixture(scope="module")
def jax_rt():
    import cloudpickle

    import ray_tpu

    module = sys.modules[__name__]
    cloudpickle.register_pickle_by_value(module)
    ray_tpu.init(num_cpus=4, system_config={
        "num_prestart_workers": 2, "refcount_flush_interval_s": 0.1,
        "gc_grace_period_s": 1.0})
    yield ray_tpu
    ray_tpu.shutdown()
    cloudpickle.unregister_pickle_by_value(module)


@pytest.fixture(scope="module")
def port_rt():
    import ray_tpu_torch

    ray_tpu_torch.init(num_cpus=4, num_gpus=0)
    yield ray_tpu_torch
    ray_tpu_torch.shutdown()


def _fit(pkg, loop, path, config=None, workers=1, failures=0):
    if pkg == "jax":
        from ray_tpu.train import (FailureConfig, JaxTrainer as Trainer,
                                   RunConfig, ScalingConfig)
        scaling = ScalingConfig(num_workers=workers)
    else:
        from ray_tpu_torch.train import (FailureConfig, RunConfig,
                                         ScalingConfig, TorchTrainer as
                                         Trainer)
        scaling = ScalingConfig(num_workers=workers, use_gpu=False)
    return Trainer(
        loop, train_loop_config=config,
        scaling_config=scaling,
        run_config=RunConfig(
            storage_path=str(path),
            failure_config=FailureConfig(max_failures=failures)),
    ).fit()


def _restored(result):
    tree = result.checkpoint.as_pytree(**(
        {"device": "cpu"} if "ray_tpu_torch" in type(
            result.checkpoint).__module__ else {}))
    return {k: np.asarray(v).tolist() for k, v in tree.items()}


CASES = {
    "basic_report": dict(jax=jax_basic, port=port_basic, config={}),
    "two_workers_ranks": dict(jax=jax_ranks, port=port_ranks, workers=2),
    "checkpoint_roundtrip": dict(jax=jax_checkpoint, port=port_checkpoint,
                                 config={}),
    "failure_restart_from_checkpoint": dict(
        jax=jax_restart, port=port_restart, failures=1, marker=True),
    "error_surfaces": dict(jax=jax_explodes, port=port_explodes),
}


@pytest.mark.parametrize("case", list(CASES))
def test_trainer_results_match_jax(case, jax_rt, port_rt, tmp_path):
    """Both fits run at once, one thread each (two runtimes, no shared
    state), so the case takes the slower one's time."""
    spec = CASES[case]

    def run(pkg):
        config = spec.get("config")
        if spec.get("marker"):
            config = {"marker": str(tmp_path / f"{pkg}-crashed")}
        result = _fit(pkg, spec[pkg], tmp_path / pkg, config,
                      spec.get("workers", 1), spec.get("failures", 0))
        if spec.get("marker"):
            assert os.path.exists(config["marker"])
        return (
            type(result.error).__name__ if result.error else None,
            "exploded" in str(result.error),
            result.metrics, len(result.metrics_history or []),
            _restored(result) if result.checkpoint is not None else None)

    with ThreadPoolExecutor(2) as pool:
        jax_out = pool.submit(run, "jax")
        port_out = run("port")
        jax_out = jax_out.result()
    assert port_out == jax_out
    if case == "error_surfaces":
        assert port_out[:2] == ("TrainWorkerGroupError", True)
    else:
        assert port_out[0] is None
