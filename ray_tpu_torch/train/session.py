"""In-worker training session (counterpart of ``ray_tpu/train/session.py``).

``report(metrics, checkpoint)``, ``get_checkpoint``, ``checkpoint_dir``,
the rank accessors, heartbeats and preemption, as in the JAX package.
Reports stream to the driver through the runtime's KV (sequence-numbered
keys ``__train__/<run>/<rank>/<seq>``) so the trainer can poll while the
rank's actor method is still running; the payloads are pickled with the
standard library's ``pickle``.

- Every rank publishes a heartbeat and step counter to the KV
  (``__train__/<run>/<rank>/hb``) from a background thread; the driver's
  gang supervisor declares a rank dead or hung when its heartbeat goes
  stale past ``train_rank_timeout_s`` and aborts the whole gang.
- :func:`preemption_requested` / ``TrainSession.preemption`` surface a
  :class:`PreemptionSignal` when the gang must checkpoint and surrender a
  draining node (``core/preemption.py``); the first rank to see it raises
  a gang-wide KV flag so every rank winds down at the same step boundary.
- ``report`` fires the ``train_worker`` fault point (``util/faults.py``).
"""

from __future__ import annotations

import dataclasses
import os
import pickle
import threading
import time
from typing import TYPE_CHECKING, Any, Dict, Optional

if TYPE_CHECKING:
    from .checkpoint import Checkpoint

_session: Optional["TrainSession"] = None


@dataclasses.dataclass
class PreemptionSignal:
    """The gang is being preempted: checkpoint at the next step boundary
    and return from the train loop — the supervisor restarts the run
    from the last committed checkpoint on surviving/replacement nodes
    WITHOUT consuming a FailureConfig.max_failures budget slot."""

    node_id: str          # the draining node (hex; "?" when unknown)
    since: float          # when the drain was first observed
    rank: int             # rank that first raised the gang-wide flag


class TrainSession:
    def __init__(
        self,
        run_id: str,
        world_rank: int,
        world_size: int,
        storage_dir: str,
        start_checkpoint: Optional[Checkpoint],
        dataset_shards: Optional[Dict[str, Any]] = None,
        trial_info: Optional[Dict[str, Any]] = None,
        use_gpu: bool = False,
    ):
        self.run_id = run_id
        self.world_rank = world_rank
        self.world_size = world_size
        self.storage_dir = storage_dir
        self.start_checkpoint = start_checkpoint
        self.dataset_shards = dataset_shards or {}
        self.trial_info = trial_info or {}
        self.use_gpu = use_gpu
        self._seq = 0
        # Step counter the heartbeat thread ships: report() advances it
        # (preferring an explicit metrics["step"]), so the supervisor
        # sees both liveness AND progress per rank.
        self.step = 0
        self._preempt: Optional[PreemptionSignal] = None
        self._preempt_local = False  # this rank raised the gang flag
        self._preempt_checked = 0.0
        self._hb_stop = threading.Event()
        self._hb_thread: Optional[threading.Thread] = None

    def _kv(self):
        from ..core.runtime_context import current_runtime

        return current_runtime()

    # ------------------------------------------------------------- report

    def report(self, metrics: Dict[str, Any],
               checkpoint: Optional[Checkpoint] = None):
        from ..util import faults

        # Chaos: a rank "killed mid-step" — the injected ConnectionError
        # escapes the train loop exactly like a real crash, the error
        # key publishes, and the supervisor aborts + restarts the gang.
        delay = faults.fire(faults.TRAIN_WORKER, rank=str(self.world_rank),
                            run=self.run_id)
        if delay:
            time.sleep(delay)
        payload = {
            "metrics": dict(metrics),
            "checkpoint_path": checkpoint.path if checkpoint else None,
            "rank": self.world_rank,
            "seq": self._seq,
        }
        self._kv().kv_put(
            f"__train__/{self.run_id}/{self.world_rank}/{self._seq}",
            pickle.dumps(payload),
        )
        self._seq += 1
        step = metrics.get("step")
        self.step = int(step) if isinstance(step, (int, float)) \
            else self.step + 1

    # --------------------------------------------------------- heartbeats

    def heartbeat_key(self) -> str:
        return f"__train__/{self.run_id}/{self.world_rank}/hb"

    def publish_heartbeat(self) -> None:
        self._kv().kv_put(
            self.heartbeat_key(),
            pickle.dumps({"ts": time.time(), "step": self.step,
                               "rank": self.world_rank}),
        )

    def start_heartbeats(self, interval_s: float) -> None:
        """Background per-rank heartbeat through the KV. The worker's
        connection to the driver is thread-safe, so this rides the same
        socket as report()."""
        if self._hb_thread is not None:
            return

        def loop():
            warned = False
            while not self._hb_stop.wait(interval_s):
                try:
                    self.publish_heartbeat()
                    warned = False
                except Exception as e:  # noqa: BLE001
                    # Keep beating through transient failures: a
                    # permanently-exited heartbeat thread would get a
                    # HEALTHY rank declared dead train_rank_timeout_s
                    # later. If the failure persists that long, the
                    # rank really is unreachable and the supervisor's
                    # verdict is correct.
                    if not warned:
                        warned = True
                        import sys

                        print(
                            f"[ray_tpu_torch.train] rank {self.world_rank}: "
                            f"heartbeat publish failed ({e!r}); "
                            f"retrying every {interval_s}s",
                            file=sys.stderr,
                        )

        try:
            self.publish_heartbeat()
        except Exception:
            pass  # first beat best-effort; the thread keeps trying
        self._hb_thread = threading.Thread(
            target=loop, name="ray_tpu_torch-train-hb", daemon=True
        )
        self._hb_thread.start()

    def stop_heartbeats(self) -> None:
        self._hb_stop.set()
        if self._hb_thread is not None:
            self._hb_thread.join(timeout=2.0)
            self._hb_thread = None
        # Final beat with the FINAL step counter: a rank that finishes
        # faster than one heartbeat interval would otherwise leave a
        # step-0 beat behind, hiding the gang's real progress from the
        # supervisor's divergence (hung-rank) detector.
        try:
            self.publish_heartbeat()
        except Exception:
            pass  # socket already down; the rank is done either way

    # --------------------------------------------------------- preemption

    def _preempt_flag_key(self) -> str:
        return f"__train__/{self.run_id}/preempt"

    @property
    def preemption(self) -> Optional[PreemptionSignal]:
        """The gang-wide preemption signal, or None. Poll at step
        boundaries: when set, save a checkpoint, report it, and return
        from the train loop. Sources, in order: (1) this worker's node
        began draining (core/preemption.py) — the first rank to see it
        raises the gang-wide KV flag; (2) the KV flag raised by another
        rank (or the supervisor). An aborted drain RETRACTS the signal:
        the local flag clears, the raising rank deletes the gang flag,
        and every rank's next poll sees the retraction."""
        from ..core import preemption as _local

        local = _local.local_drain()
        if local is not None:
            if not self._preempt_local:
                sig = PreemptionSignal(node_id=local["node_id"],
                                       since=local["since"],
                                       rank=self.world_rank)
                try:
                    self._kv().kv_put(
                        self._preempt_flag_key(),
                        pickle.dumps(dataclasses.asdict(sig)),
                        overwrite=False,
                    )
                except Exception:
                    pass  # advisory; the drain timeout still bounds us
                self._preempt = sig
                self._preempt_local = True
            return self._preempt
        if self._preempt_local:
            # We raised the gang flag for a drain that has since been
            # aborted (node_undrain): retract it for the whole gang.
            try:
                self._kv().kv_del(self._preempt_flag_key())
            except Exception:
                pass  # stale flag worst-case costs one gang restart
            self._preempt = None
            self._preempt_local = False
        # Gang-wide flag: throttled KV poll (discovery AND
        # retraction-tracking) so a tight step loop doesn't hammer the
        # control plane.
        now = time.monotonic()
        if now - self._preempt_checked < 0.2:
            return self._preempt
        self._preempt_checked = now
        try:
            blob = self._kv().kv_get(self._preempt_flag_key())
        except Exception:
            return self._preempt
        if blob is None:
            self._preempt = None
        elif self._preempt is None:
            try:
                self._preempt = PreemptionSignal(**pickle.loads(blob))
            except Exception:
                self._preempt = PreemptionSignal(
                    node_id="?", since=time.time(), rank=-1)
        return self._preempt

    def preemption_requested(self) -> bool:
        return self.preemption is not None

    # ------------------------------------------------------------- misc

    def get_checkpoint(self) -> Optional[Checkpoint]:
        return self.start_checkpoint

    def get_dataset_shard(self, name: str = "train"):
        return self.dataset_shards.get(name)

    def checkpoint_dir(self, step: int) -> str:
        return os.path.join(
            self.storage_dir, f"checkpoint_{step:06d}_rank{self.world_rank}"
        )


# ---- public session API (module functions, like ray.train.*) ----

def get_session() -> TrainSession:
    if _session is None:
        raise RuntimeError(
            "No training session active; these APIs only work inside "
            "train_loop_per_worker."
        )
    return _session


def set_session(session: Optional[TrainSession]):
    global _session
    _session = session


def report(metrics: Dict[str, Any], checkpoint: Optional[Checkpoint] = None):
    get_session().report(metrics, checkpoint)


def get_checkpoint() -> Optional[Checkpoint]:
    return get_session().get_checkpoint()


def get_dataset_shard(name: str = "train"):
    return get_session().get_dataset_shard(name)


def get_world_rank() -> int:
    return get_session().world_rank


def get_world_size() -> int:
    return get_session().world_size


def preemption_requested() -> bool:
    """True when the gang must checkpoint and surrender its node(s) —
    check at step boundaries; see TrainSession.preemption."""
    return get_session().preemption_requested()


def get_trial_name() -> str:
    return get_session().trial_info.get("name", get_session().run_id)
