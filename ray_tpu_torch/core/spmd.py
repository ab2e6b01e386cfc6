"""SPMD actor groups: gang-scheduled, lock-step, restart-as-a-unit (a copy
of ``ray_tpu/core/spmd.py`` on the port's runtime).

An :class:`SpmdActorGroup` is N identical actors, one per bundle of a
placement group (an all-or-nothing reservation is gang scheduling), whose
methods are invoked in lock-step on every member. Any member death poisons
the whole group; recovery is a whole-group restart (a partial restart
would deadlock the survivors' collectives). The trainer's gang is one.
A bundle that asks for ``"GPU"`` gives its member a GPU-typed worker that
sees its card.
"""

from __future__ import annotations

from typing import Any, Callable, Dict, List, Optional, Tuple

from .placement_group import (
    PlacementGroup,
    placement_group as _create_placement_group,
    remove_placement_group,
)
from .scheduling_strategies import PlacementGroupSchedulingStrategy


class SpmdGroupError(RuntimeError):
    """A member died or a lock-step call failed; the group must restart."""


class SpmdActorGroup:
    """Gang of identical actors, one per placement-group bundle.

    Parameters
    ----------
    actor_cls:
        An ``@ray_tpu.remote`` class (ActorClass) or a plain class (wrapped
        automatically).
    num_workers:
        Group size. Ignored when ``placement_group`` is given (the bundle
        count rules).
    resources_per_worker:
        Per-bundle resource demand when the group creates its own placement
        group (default ``{"CPU": 1}``).
    placement_group:
        Pre-reserved group; bundle *i* hosts rank *i*.
    per_worker_args:
        ``rank -> (args, kwargs)`` for the actor constructor; defaults to
        no-arg construction.
    """

    def __init__(
        self,
        actor_cls,
        *,
        num_workers: Optional[int] = None,
        resources_per_worker: Optional[Dict[str, float]] = None,
        placement_group: Optional[PlacementGroup] = None,
        strategy: str = "SPREAD",
        per_worker_args: Optional[
            Callable[[int], Tuple[tuple, dict]]
        ] = None,
        name: str = "",
        ready_timeout: float = 60.0,
        owns_placement_group: Optional[bool] = None,
    ):
        from .actor import ActorClass
        from .api import remote

        if not isinstance(actor_cls, ActorClass):
            actor_cls = remote(actor_cls)
        self._actor_cls = actor_cls
        self._per_worker_args = per_worker_args
        self.name = name
        self._ready_timeout = ready_timeout
        self._owns_pg = (
            owns_placement_group
            if owns_placement_group is not None
            else placement_group is None
        )
        self._resources_per_worker = resources_per_worker
        if placement_group is None:
            if not num_workers or num_workers < 1:
                raise ValueError("num_workers >= 1 required without a "
                                 "placement group")
            bundles = [
                dict(resources_per_worker or {"CPU": 1})
                for _ in range(num_workers)
            ]
            placement_group = _create_placement_group(
                bundles, strategy=strategy, name=name or "spmd-group"
            )
            if not placement_group.wait(ready_timeout):
                remove_placement_group(placement_group)
                raise SpmdGroupError(
                    f"gang placement of {num_workers} bundles "
                    f"({resources_per_worker or {'CPU': 1}}) not satisfiable "
                    f"within {ready_timeout}s"
                )
        self.pg = placement_group
        self.world_size = placement_group.bundle_count
        self._actors: List[Any] = []
        self._broken = False
        self._start_actors()

    # ---------------------------------------------------------------- spawn

    def _rank_resources(self, rank: int) -> Dict[str, float]:
        """The resources each member actor requests. Bundle resources rule
        when the gang rides a pre-reserved placement group (so a GPU bundle
        yields a GPU-typed worker process that sees its card); otherwise
        resources_per_worker."""
        specs = self.pg.bundle_specs
        if rank < len(specs) and specs[rank]:
            return dict(specs[rank])
        return dict(self._resources_per_worker or {"CPU": 1})

    def _start_actors(self):
        self._actors = []
        for rank in range(self.world_size):
            args, kwargs = ((), {})
            if self._per_worker_args is not None:
                args, kwargs = self._per_worker_args(rank)
            res = self._rank_resources(rank)
            handle = self._actor_cls.options(
                scheduling_strategy=PlacementGroupSchedulingStrategy(
                    self.pg, placement_group_bundle_index=rank
                ),
                num_cpus=res.pop("CPU", 0),
                resources=res,
                max_restarts=0,  # the *group* is the restart unit
                name="",
            ).remote(*args, **kwargs)
            self._actors.append(handle)
        self._broken = False

    # ------------------------------------------------------------ lock-step

    @property
    def actors(self) -> List[Any]:
        return list(self._actors)

    def submit(self, method: str, *args, per_rank_args=None, **kwargs):
        """Invoke ``method`` on every member; returns one ObjectRef per
        rank (lock-step submission, caller chooses how to wait).

        ``per_rank_args``: optional ``rank -> (args, kwargs)`` overriding
        the shared arguments for that rank."""
        if self._broken:
            raise SpmdGroupError("group is broken; call restart() first")
        refs = []
        for rank, actor in enumerate(self._actors):
            a, kw = (args, kwargs)
            if per_rank_args is not None:
                a, kw = per_rank_args(rank)
            refs.append(getattr(actor, method).remote(*a, **kw))
        return refs

    def run(self, method: str, *args, timeout: Optional[float] = None,
            per_rank_args=None, **kwargs) -> List[Any]:
        """Lock-step call: submit to every member and wait for all results.
        Any member failure marks the group broken and raises
        :class:`SpmdGroupError` (the gang semantics: one dead rank means
        the collective program cannot continue)."""
        from .api import get
        from .exceptions import GetTimeoutError

        refs = self.submit(
            method, *args, per_rank_args=per_rank_args, **kwargs
        )
        try:
            return get(refs, timeout=timeout)
        except GetTimeoutError:
            # Slow is not dead: a member busy with a long step must not
            # brick the gang (restart() would kill live work).
            raise
        except Exception as e:
            self._broken = True
            raise SpmdGroupError(
                f"lock-step call {method!r} failed: {e}"
            ) from e

    def wait_ready(self, timeout: Optional[float] = None) -> None:
        """Block until every member's constructor finished (gang barrier)."""
        self.run("__rtpu_ping__", timeout=timeout or self._ready_timeout)

    def healthy(self, timeout: float = 10.0) -> bool:
        from .exceptions import GetTimeoutError

        try:
            self.run("__rtpu_ping__", timeout=timeout)
            return True
        except (SpmdGroupError, GetTimeoutError):
            return False

    # -------------------------------------------------------------- restart

    @property
    def broken(self) -> bool:
        return self._broken

    def restart(self, ready_timeout: Optional[float] = None) -> None:
        """Whole-group restart: kill every member (dead or alive) and spawn
        a fresh gang on the same placement group."""
        from .api import kill

        for actor in self._actors:
            try:
                kill(actor)
            except Exception:
                pass
        if not self.pg.wait(ready_timeout or self._ready_timeout):
            raise SpmdGroupError(
                "placement group could not be re-reserved after restart"
            )
        self._start_actors()
        self.wait_ready(ready_timeout)

    def shutdown(self) -> None:
        from .api import kill

        for actor in self._actors:
            try:
                kill(actor)
            except Exception:
                pass
        self._actors = []
        self._broken = True
        if self._owns_pg:
            try:
                remove_placement_group(self.pg)
            except Exception:
                pass

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.shutdown()

    def __len__(self):
        return self.world_size

    def __repr__(self):
        state = "broken" if self._broken else "ok"
        return (
            f"SpmdActorGroup(world_size={self.world_size}, pg={self.pg.id[:8]}, "
            f"{state})"
        )
