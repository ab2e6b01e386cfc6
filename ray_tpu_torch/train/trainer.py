"""TorchTrainer: data-parallel training over an SPMD actor gang
(counterpart of ``ray_tpu/train/trainer.py``'s ``JaxTrainer``, whose
supervisor it copies).

The worker gang is a :class:`ray_tpu_torch.core.SpmdActorGroup` on a
SPREAD placement group sized by ``ScalingConfig`` (one actor a bundle;
``use_gpu`` bundles, the default, ask for ``{"GPU": 1}``, so each rank is a
GPU-typed worker process that sees its card; ``fit`` raises on a node
without GPUs rather than train on the CPU). At world size 1 there is no process
group, as in the JAX package. Above it, rank 0 reserves a rendezvous port
and publishes it under ``__train__/<run>/coordinator`` in the runtime's
KV, and every rank joins a ``torch.distributed`` group there (NCCL with
``use_gpu``, gloo otherwise) where the JAX package calls
``jax.distributed.initialize``. The train loop travels by reference
(``pickle``): it must be importable at module level in the worker.

Failure handling is the JAX package's — whole-group restart from the last
COMMITTED checkpoint, bounded by ``FailureConfig.max_failures`` — driven
by a **gang supervisor** in the fit loop:

- every rank publishes a heartbeat + step counter through the KV
  (``__train__/<run>/<rank>/hb``, TrainSession.start_heartbeats);
- the supervisor declares a rank DEAD when its heartbeat goes stale past
  ``train_rank_timeout_s``, and HUNG when the gang's step counters
  diverge (another rank moved on) while the lagging rank's counter has
  not advanced within the same window;
- either verdict aborts the WHOLE gang promptly — surviving ranks stuck
  in a collective are killed rather than waiting out the collective
  timeout — emitting WARNING TRAIN events and the
  ``ray_tpu_train_{gang_aborts,restarts}_total`` /
  ``ray_tpu_train_recovery_seconds`` metrics;
- a preempted gang (TrainSession.preemption) checkpoints at the next step
  boundary and exits cleanly; the supervisor restarts it WITHOUT
  consuming a max_failures slot.

The ``train_worker`` fault specs armed in the driver when an attempt
starts are armed in each of its ranks (``util/faults.py``).
"""

from __future__ import annotations

import pickle
import time
import uuid
from typing import TYPE_CHECKING, Any, Dict, List, Optional

from ._telemetry import (
    TRAIN_GANG_ABORTS,
    TRAIN_GANG_SIZE,
    TRAIN_PREEMPTIONS,
    TRAIN_RECOVERY_SECONDS,
    TRAIN_RESTARTS,
)
from .config import FailureConfig, Result, RunConfig, ScalingConfig
from .session import TrainSession, set_session

if TYPE_CHECKING:
    from .checkpoint import Checkpoint, CheckpointManager


class TrainWorkerGroupError(RuntimeError):
    pass


class GangPreempted(Exception):
    """Internal: the attempt ended because the gang cooperatively
    surrendered a draining node (not a failure)."""


def _train_worker_entry(
    fn_blob: bytes,
    config: Optional[Dict[str, Any]],
    run_id: str,
    rank: int,
    world_size: int,
    storage_dir: str,
    start_checkpoint_path: Optional[str],
    dataset_shards: Dict[str, Any],
    coordinator: Optional[str],
    backend: Optional[str],
    heartbeat_interval_s: float = 2.0,
    use_gpu: bool = False,
    fault_specs: Optional[List[Dict[str, Any]]] = None,
):
    """Runs inside a worker actor process. ``backend`` selects the
    ``torch.distributed`` rendezvous: "nccl" (GPU ranks), "gloo", or None
    = no process group (world size 1)."""
    from ..core.runtime_context import current_runtime
    from ..util import faults

    if fault_specs:
        faults.apply_plan(fault_specs)
    start_ckpt = None
    if start_checkpoint_path:
        from .checkpoint import Checkpoint  # torch: only when resuming

        start_ckpt = Checkpoint(start_checkpoint_path)
    session = TrainSession(
        run_id=run_id,
        world_rank=rank,
        world_size=world_size,
        storage_dir=storage_dir,
        start_checkpoint=start_ckpt,
        dataset_shards=dataset_shards,
        use_gpu=use_gpu,
    )
    set_session(session)
    # Heartbeats start BEFORE the rendezvous: a hung
    # init_process_group (dead peer) is a live process, and the
    # supervisor needs the beat flowing to tell "slow rendezvous" from
    # "dead rank".
    session.start_heartbeats(heartbeat_interval_s)
    torch_group = False
    try:
        if coordinator is not None and world_size > 1:
            import torch
            import torch.distributed as dist

            if backend == "nccl":
                torch.cuda.set_device(0)  # the one card this rank sees
            dist.init_process_group(
                backend,
                init_method=f"tcp://{coordinator}",
                rank=rank,
                world_size=world_size,
            )
            torch_group = True
        fn = pickle.loads(fn_blob)
        if config is not None:
            fn(config)
        else:
            fn()
    except BaseException as e:  # noqa: BLE001 — surfaced via KV + re-raise
        try:
            current_runtime().kv_put(
                f"__train__/{run_id}/{rank}/error",
                pickle.dumps({"rank": rank, "error": repr(e)}),
            )
        except Exception as kv_err:
            # The task error itself re-raises below; what is lost here
            # is only the PROMPT surfacing through the KV error key —
            # the driver then learns of the failure at join time.
            import sys

            print(
                f"[ray_tpu_torch.train] WARNING: rank {rank} could not "
                f"publish its error key ({kv_err!r}); failure will "
                f"surface at gang join instead",
                file=sys.stderr,
            )
        raise
    finally:
        session.stop_heartbeats()
        set_session(None)
        if torch_group:
            import torch.distributed as dist

            # Teardown of a rendezvous that may already be half-dead
            # (peer ranks crashed): the run's outcome is decided by now;
            # a destroy failure changes nothing for the caller.
            try:
                dist.destroy_process_group()
            except Exception:  # rtlint: disable=swallowed-failure
                pass
    return "done"


class _RemoteTrainWorker:
    """Actor wrapper so the worker body runs in a dedicated process."""

    def reserve_coordinator(self) -> str:
        """Bind a free port on this worker's host and return host:port —
        the torch.distributed rendezvous address (the runtime is one node,
        so the host is localhost)."""
        import socket

        s = socket.socket(socket.AF_INET, socket.SOCK_STREAM)
        s.bind(("127.0.0.1", 0))
        port = s.getsockname()[1]
        s.close()
        return f"127.0.0.1:{port}"

    def run(self, *args):
        return _train_worker_entry(*args)


class _RankState:
    """Supervisor-side liveness record for one rank."""

    __slots__ = ("last_beat", "last_blob", "step", "step_changed")

    def __init__(self, now: float):
        self.last_beat = now
        self.last_blob: Optional[bytes] = None
        self.step = -1
        self.step_changed = now


class TorchTrainer:
    """Data-parallel trainer (counterpart of ``JaxTrainer``)."""

    def __init__(
        self,
        train_loop_per_worker,
        *,
        train_loop_config: Optional[Dict[str, Any]] = None,
        scaling_config: Optional[ScalingConfig] = None,
        run_config: Optional[RunConfig] = None,
        datasets: Optional[Dict[str, Any]] = None,
        resume_from_checkpoint: Optional[Checkpoint] = None,
    ):
        self._fn = train_loop_per_worker
        self._config = train_loop_config
        self.scaling_config = scaling_config or ScalingConfig()
        self.run_config = run_config or RunConfig()
        self._datasets = datasets or {}
        self._resume = resume_from_checkpoint

    # ------------------------------------------------------------------ fit

    def fit(self) -> Result:
        from ..core import api
        from ..util import events
        from .checkpoint import CheckpointManager, default_storage_path

        if self.scaling_config.use_gpu and \
                not api.cluster_resources().get("GPU"):
            raise RuntimeError(
                "ScalingConfig(use_gpu=True) trains on the card, and the "
                "runtime's node has no GPU; pass "
                "ScalingConfig(use_gpu=False) to train on the CPU")

        storage = self.run_config.storage_path or default_storage_path(
            self.run_config.name
        )
        ckpt_cfg = self.run_config.checkpoint_config
        manager = CheckpointManager(
            storage,
            num_to_keep=ckpt_cfg.num_to_keep,
            score_attribute=ckpt_cfg.checkpoint_score_attribute,
            score_order=ckpt_cfg.checkpoint_score_order,
        )
        failures_left = self.run_config.failure_config.max_failures
        start_ckpt = self._resume
        history: List[Dict[str, Any]] = []
        recovery_started: Optional[float] = None
        try:
            while True:
                try:
                    metrics = self._run_attempt(
                        manager, start_ckpt, history, recovery_started
                    )
                    return Result(
                        metrics=metrics,
                        checkpoint=manager.best,
                        metrics_history=history,
                    )
                except GangPreempted:
                    # Cooperative drain surrender: restart on surviving/
                    # replacement nodes from the last committed
                    # checkpoint. NOT a failure — no budget consumed.
                    TRAIN_PREEMPTIONS.inc()
                    TRAIN_RESTARTS.inc(tags={"reason": "preempt"})
                    recovery_started = time.monotonic()
                    start_ckpt = self._restart_checkpoint(
                        manager, storage, start_ckpt
                    )
                    events.emit(
                        events.WARNING, events.TRAIN,
                        "train gang preempted by node drain; restarting "
                        "from "
                        + (start_ckpt.path if start_ckpt else "scratch"),
                        custom_fields={"restart_from": getattr(
                            start_ckpt, "path", None)},
                    )
                except TrainWorkerGroupError as e:
                    if failures_left == 0:
                        return Result(
                            metrics=history[-1] if history else {},
                            checkpoint=manager.best,
                            error=e,
                            metrics_history=history,
                        )
                    failures_left -= 1
                    TRAIN_RESTARTS.inc(tags={"reason": "error"})
                    recovery_started = time.monotonic()
                    start_ckpt = self._restart_checkpoint(
                        manager, storage, start_ckpt
                    )
                    events.emit(
                        events.WARNING, events.TRAIN,
                        f"train gang restarting after failure ({e}); "
                        f"{failures_left} restart(s) left, resuming from "
                        + (start_ckpt.path if start_ckpt else "scratch"),
                        custom_fields={
                            "failures_left": failures_left,
                            "restart_from": getattr(start_ckpt, "path",
                                                    None),
                        },
                    )
        finally:
            TRAIN_GANG_SIZE.set(0)

    @staticmethod
    def _restart_checkpoint(manager: "CheckpointManager", storage: str,
                            fallback: Optional["Checkpoint"]
                            ) -> Optional["Checkpoint"]:
        """The restart source of truth: the newest COMMITTED checkpoint
        — from the manager's registry, else a storage-dir scan (covers
        checkpoints a crashed save never registered past), else the
        original resume point. An uncommitted/corrupt 'latest' is never
        restarted from."""
        from .checkpoint import latest_committed

        ckpt = manager.latest_committed
        if ckpt is None:
            ckpt = latest_committed(storage)
        return ckpt or fallback

    def _shard_datasets(self, world_size: int) -> List[Dict[str, Any]]:
        """Per-worker dataset shards; datasets with streaming_split use
        streaming_split, other values pass through whole."""
        shards: List[Dict[str, Any]] = [dict() for _ in range(world_size)]
        for name, ds in self._datasets.items():
            split = None
            if hasattr(ds, "streaming_split"):
                split = ds.streaming_split(world_size)
            for rank in range(world_size):
                shards[rank][name] = split[rank] if split else ds
        return shards

    def _make_worker_group(self):
        """Gang-schedule the workers: a SPREAD placement group sized by
        ScalingConfig (the JAX package's TPU-slice branch has no
        counterpart on one node)."""
        from ..core.spmd import SpmdActorGroup

        sc = self.scaling_config
        return SpmdActorGroup(
            _RemoteTrainWorker,
            num_workers=sc.num_workers,
            resources_per_worker=sc.worker_resources(),
            strategy="SPREAD",
            name="torch-train",
        )

    # ------------------------------------------------------------ attempt

    def _run_attempt(
        self,
        manager: "CheckpointManager",
        start_ckpt: Optional["Checkpoint"],
        history: List[Dict[str, Any]],
        recovery_started: Optional[float] = None,
    ) -> Dict[str, Any]:
        from ..core import api
        from ..core.config import get_config
        from ..core.runtime import dump_callable
        from ..util import events, faults

        sc = self.scaling_config
        world = sc.num_workers
        run_id = uuid.uuid4().hex[:12]
        cfg = get_config()
        rank_timeout = float(cfg.train_rank_timeout_s)
        hb_interval = float(cfg.train_heartbeat_interval_s)

        fn_blob = dump_callable(self._fn)
        fault_specs = faults.armed_specs(faults.TRAIN_WORKER)
        storage = manager.storage_dir
        shards = self._shard_datasets(world)

        group = self._make_worker_group()
        attempt = _AttemptState(run_id, world, rank_timeout,
                                recovery_started, manager, history)
        TRAIN_GANG_SIZE.set(world)
        try:
            group.wait_ready(timeout=120.0)
            coordinator = None
            backend = None
            if world > 1:
                # Rank 0 reserves the rendezvous port on its own host; the
                # address is published through the KV (docstring
                # contract; also consumed by state tooling).
                backend = "nccl" if sc.use_gpu else "gloo"
                coordinator = api.get(
                    group.actors[0].reserve_coordinator.remote()
                )
                attempt.rt.kv_put(
                    f"__train__/{run_id}/coordinator",
                    coordinator.encode(),
                )

            def rank_args(rank: int):
                return (
                    (
                        fn_blob,
                        self._config,
                        run_id,
                        rank,
                        world,
                        storage,
                        start_ckpt.path if start_ckpt else None,
                        shards[rank],
                        coordinator,
                        backend,
                        hb_interval,
                        sc.use_gpu,
                        fault_specs,
                    ),
                    {},
                )

            refs = group.submit("run", per_rank_args=rank_args)
            attempt.mark_submitted()

            rank_of = {ref: rank for rank, ref in enumerate(refs)}
            pending = list(refs)
            while pending:
                ready, pending = api.wait(
                    pending, num_returns=len(pending), timeout=0.25
                )
                # Eager join: a rank whose actor died errors its ref
                # long before the final join — surface it NOW so the
                # survivors (possibly blocked in a collective) are
                # killed promptly. A clean return just retires the rank
                # from the liveness sweep (it stopped heartbeating).
                for ref in ready:
                    rank = rank_of[ref]
                    try:
                        api.get(ref)
                    except Exception as e:  # noqa: BLE001
                        attempt.drain_reports()
                        raise _GangAbort(
                            "dead",
                            f"rank {rank} worker failed: {e}",
                        ) from e
                    attempt.mark_rank_done(rank)
                attempt.drain_reports()
                attempt.check_liveness()
            attempt.drain_reports()
            if attempt.preempted:
                raise GangPreempted()
            if attempt.error:
                raise TrainWorkerGroupError(str(attempt.error))
            return attempt.last_metrics
        except (TrainWorkerGroupError, GangPreempted):
            raise
        except _GangAbort as e:
            # Prompt whole-gang abort: kill every rank NOW — survivors
            # blocked in a collective would otherwise sit out the
            # collective timeout — then surface as a restartable failure.
            TRAIN_GANG_ABORTS.inc(tags={"reason": e.reason})
            events.emit(
                events.WARNING, events.TRAIN,
                f"train gang {run_id} aborted: {e} — killing all "
                f"{world} rank(s)",
                custom_fields={"run_id": run_id, "reason": e.reason},
            )
            if attempt.preempted:
                raise GangPreempted() from e
            raise TrainWorkerGroupError(str(e)) from e
        except Exception as e:
            if attempt.preempted:
                # The drain beat the supervisor to the node: worker
                # death during a signalled preemption is the preemption,
                # not a budgeted failure.
                raise GangPreempted() from e
            raise TrainWorkerGroupError(f"train worker failed: {e}") from e
        finally:
            group.shutdown()


class _GangAbort(RuntimeError):
    """Supervisor verdict: a rank is dead or hung; the gang cannot
    continue and must be killed promptly."""

    def __init__(self, reason: str, message: str):
        super().__init__(message)
        self.reason = reason


class _AttemptState:
    """Driver-side supervisor state for one gang attempt: KV report
    draining, per-rank heartbeat/step tracking, preemption flag."""

    def __init__(self, run_id: str, world: int, rank_timeout: float,
                 recovery_started: Optional[float],
                 manager: "CheckpointManager",
                 history: List[Dict[str, Any]]):
        from ..core.runtime_context import current_runtime

        self.rt = current_runtime()
        self.run_id = run_id
        self.world = world
        self.rank_timeout = rank_timeout
        self.recovery_started = recovery_started
        self.manager = manager
        self.history = history
        self.next_seq = [0] * world
        self.last_metrics: Dict[str, Any] = {}
        self.error: Optional[str] = None
        self.preempted = False
        self.done: set = set()
        now = time.monotonic()
        # Grace until the first beat: actor entry starts beating almost
        # immediately after submit, but a loaded box deserves slack.
        self.ranks = [_RankState(now + 10.0) for _ in range(world)]
        # Gang step cadence, for the adaptive hang threshold: a step
        # that legitimately includes slow rank-local work (rank 0's
        # checkpoint save of a big model) must not read as a hang.
        self.gang_step = -1
        self.gang_step_changed = now
        self.step_interval = 0.0

    def mark_submitted(self):
        now = time.monotonic()
        for r in self.ranks:
            r.last_beat = now + 10.0
            r.step_changed = now

    def mark_rank_done(self, rank: int):
        self.done.add(rank)

    # -------------------------------------------------------- KV draining

    def drain_reports(self):
        from .checkpoint import Checkpoint

        rt = self.rt
        for rank in range(self.world):
            blob = rt.kv_get(f"__train__/{self.run_id}/{rank}/error")
            if blob is not None and self.error is None:
                payload = pickle.loads(blob)
                self.error = f"rank {payload['rank']}: {payload['error']}"
            while True:
                key = f"__train__/{self.run_id}/{rank}/{self.next_seq[rank]}"
                blob = rt.kv_get(key)
                if blob is None:
                    break
                self.next_seq[rank] += 1
                payload = pickle.loads(blob)
                if rank == 0:
                    metrics = payload["metrics"]
                    self.history.append(metrics)
                    self.last_metrics = metrics
                    self._note_recovered()
                    if payload.get("checkpoint_path"):
                        ckpt = Checkpoint(payload["checkpoint_path"])
                        self.manager.register(
                            ckpt, metrics,
                            metrics.get("step", len(self.history))
                        )
        # Non-latching: an aborted drain retracts the gang flag
        # (session.preemption deletes the key), and the supervisor must
        # follow — otherwise the rolled-back drain still costs a
        # whole-gang restart.
        self.preempted = rt.kv_get(
            f"__train__/{self.run_id}/preempt") is not None
        if self.error is not None and not self.preempted:
            raise _GangAbort("error", self.error)

    def _note_recovered(self):
        if self.recovery_started is None:
            return
        elapsed = time.monotonic() - self.recovery_started
        self.recovery_started = None
        TRAIN_RECOVERY_SECONDS.observe(elapsed)
        from ..util import events

        events.emit(
            events.INFO, events.TRAIN,
            f"train gang {self.run_id} recovered: first report "
            f"{elapsed:.2f}s after failure detection",
            custom_fields={"run_id": self.run_id,
                           "recovery_seconds": elapsed},
        )

    # ---------------------------------------------------------- liveness

    def check_liveness(self):
        """Heartbeat sweep: a rank with no beat inside
        ``train_rank_timeout_s`` is DEAD; a rank whose step counter
        froze while another rank moved past it is HUNG (lock-step SPMD:
        healthy gangs advance together — divergence means someone is
        stuck between collectives). Either verdict aborts the gang.

        Staleness is measured by when the heartbeat BLOB last changed,
        in the driver's own monotonic frame — worker wall clocks never
        enter the comparison, so cross-host clock offset cannot fake
        (or mask) a dead rank. The hang threshold adapts to the gang's
        own step cadence (4× the slowest observed inter-step gap, floor
        ``train_rank_timeout_s``): a step that legitimately spends
        minutes in rank-local work — rank 0's checkpoint save — already
        stretched the cadence in earlier steps, so it does not read as
        a hang."""
        rt = self.rt
        now = time.monotonic()
        max_step = -1
        for rank in range(self.world):
            state = self.ranks[rank]
            blob = rt.kv_get(f"__train__/{self.run_id}/{rank}/hb")
            if blob is not None and blob != state.last_blob:
                state.last_blob = blob
                state.last_beat = now
                try:
                    hb = pickle.loads(blob)
                # An unreadable beat still proves the process lives;
                # the step counter just doesn't advance from it.
                except Exception:  # rtlint: disable=swallowed-failure
                    hb = None
                if hb:
                    step = int(hb.get("step", -1))
                    if step != state.step:
                        state.step = step
                        state.step_changed = now
            # Gang progress floor: drained report count also witnesses
            # progress (covers a rank whose final beat was lost).
            max_step = max(max_step, state.step, self.next_seq[rank] - 1)
        if max_step > self.gang_step:
            if self.gang_step >= 0:
                self.step_interval = max(
                    self.step_interval, now - self.gang_step_changed)
            self.gang_step = max_step
            self.gang_step_changed = now
        if self.preempted:
            return  # winding down cooperatively; drain timeout bounds us
        hang_timeout = max(self.rank_timeout, 4.0 * self.step_interval)
        for rank in range(self.world):
            if rank in self.done:
                continue  # returned cleanly; it stopped beating by design
            state = self.ranks[rank]
            if now - state.last_beat > self.rank_timeout:
                raise _GangAbort(
                    "dead",
                    f"rank {rank} heartbeat stale for "
                    f"{now - state.last_beat:.1f}s "
                    f"(> train_rank_timeout_s={self.rank_timeout}) — "
                    f"declaring it dead",
                )
            if (state.step < max_step
                    and now - state.step_changed > hang_timeout):
                raise _GangAbort(
                    "hang",
                    f"rank {rank} stuck at step {state.step} while the "
                    f"gang reached {max_step} "
                    f"(no progress for {now - state.step_changed:.1f}s > "
                    f"{hang_timeout:.1f}s = max(train_rank_timeout_s, "
                    f"4x gang step cadence)) — declaring it hung",
                )
