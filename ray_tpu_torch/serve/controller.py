"""Serve controller + deployment state machine (counterpart of
``ray_tpu/serve/controller.py``).

Ref analogue: serve/_private/controller.py ServeController (:88) owning
ApplicationState/DeploymentState (deployment_state.py:1193 — replica state
machine, scaling, rolling updates), autoscaling_policy.py (queue-depth
driven replica count), long_poll.py (push of route changes to handles).

The controller is a named actor created with max_concurrency so that
long-poll calls from many handles block their own threads without stalling
deploy/scale. A daemon reconcile thread drives autoscaling from metrics
pushed by handles (ref analogue: handle-side autoscaling metrics,
serve/_private/router.py metrics pusher).

Rolling updates (ref: deployment_state.py _check_and_update_replicas):
deploying a NEW VERSION over a live deployment starts one new-version
replica at a time, waits for readiness, then retires one old-version
replica — the route set never drops below the target count, so in-flight
traffic always has somewhere to go (zero-downtime).

Not ported: the SLO engine's inputs (publishing a deployment's SLO spec,
reading ``__slo_status__`` to scale on burn rate), since the port has no
SLO engine; ``deployment(slo=...)`` raises ``NotImplementedError``.
Replicas are keyed by their actor id (a string in the port).
"""

from __future__ import annotations

import hashlib
import threading
import time
from typing import Any, Dict, List, Optional

from .. import core as rt
from ..util import events as cluster_events

CONTROLLER_NAME = "__serve_controller__"
CONTROLLER_MAX_CONCURRENCY = 16

RECONCILE_INTERVAL_S = 0.2
# Handle metric reports older than this are dropped (handle died / idle).
METRIC_STALENESS_S = 2.0
HEALTH_CHECK_PERIOD_S = 1.0
HEALTH_CHECK_TIMEOUT_S = 2.0


class _DeploymentState:
    """Target + actual state for one deployment."""

    def __init__(self):
        self.name: str = ""  # deployment name (metric/trace tag)
        self.blob: bytes = b""
        self.init_args = ()
        self.init_kwargs: Dict[str, Any] = {}
        self.target_replicas: int = 1
        self.ray_actor_options: Dict[str, Any] = {}
        self.batch_config: Optional[Dict[str, Any]] = None
        self.autoscaling: Optional[Dict[str, float]] = None
        self.version: str = ""
        # Ceiling for each replica's adaptive concurrency limiter.
        self.max_concurrent_queries: int = 8
        # replica actor id -> {"since": ts, "last": ts, "state": str}
        # from handle routers reporting non-closed circuit breakers; a
        # replica continuously OPEN past serve_breaker_eject_s is
        # ejected through the drain machinery.
        self.breaker_reports: Dict[str, Dict[str, Any]] = {}
        # Live replica handles, each tagged with the version it was
        # started under: list of (handle, version).
        self.replicas: List[Any] = []
        self.replica_versions: List[str] = []
        # Bumped whenever the routable replica set changes; handles
        # long-poll on this (ref: long_poll.py snapshot ids).
        self.route_version: int = 0
        # Autoscaler smoothing state.
        self.upscale_since: Optional[float] = None
        self.downscale_since: Optional[float] = None
        # handle_id -> (total_outstanding, timestamp)
        self.handle_metrics: Dict[str, Any] = {}


class ServeControllerActor:
    """Runs as a named actor; reconciles replica sets toward target state."""

    def __init__(self):
        self._deployments: Dict[str, _DeploymentState] = {}
        self._lock = threading.RLock()
        self._route_cond = threading.Condition(self._lock)
        self._stopped = False
        # Runtime override of serve_breaker_eject_s (ops/test hook; the
        # config knob seeds this process's default when None).
        self._breaker_eject_override: Optional[float] = None
        self._reconciler = threading.Thread(
            target=self._reconcile_loop, daemon=True
        )
        self._reconciler.start()

    # ---- replica lifecycle helpers ----------------------------------------

    def _start_replicas(self, st: _DeploymentState, n: int,
                        version: str) -> List[Any]:
        from .replica import Replica

        opts = dict(st.ray_actor_options)
        actor_cls = rt.remote(**opts)(Replica) if opts else \
            rt.remote(Replica)
        new = [
            actor_cls.remote(st.blob, st.init_args, st.init_kwargs,
                             version, st.name, st.max_concurrent_queries)
            for _ in range(n)
        ]
        # Block until every replica's constructor finished (readiness gate;
        # ref: deployment_state.py waiting for replicas to be RUNNING).
        rt.get([r.ping.remote() for r in new])
        return new

    def _kill_replica(self, handle) -> None:
        try:
            rt.kill(handle)
        except Exception as e:
            # A replica we failed to kill may keep serving a retired
            # version (or leak a worker) — say so instead of hiding it.
            cluster_events.emit(
                cluster_events.WARNING, cluster_events.SERVE,
                f"replica kill failed ({type(e).__name__}: {e}); the "
                f"worker may be leaked",
            )

    def _bump_route(self, st: _DeploymentState) -> None:
        st.route_version += 1
        self._route_cond.notify_all()

    # ---- public control API ------------------------------------------------

    def deploy(self, name: str, blob: bytes, init_args, init_kwargs,
               num_replicas: int, ray_actor_options: Dict[str, Any],
               batch_config: Optional[Dict[str, Any]],
               autoscaling: Optional[Dict[str, float]] = None,
               version: Optional[str] = None,
               max_concurrent_queries: int = 8) -> List[Any]:
        if version is None:
            version = hashlib.sha1(
                blob + repr((init_args, init_kwargs)).encode()
            ).hexdigest()[:12]

        with self._lock:
            st = self._deployments.get(name)
            fresh = st is None
            if fresh:
                st = _DeploymentState()
                self._deployments[name] = st
            st.name = name
            old_version = st.version
            st.blob = blob
            st.init_args = init_args
            st.init_kwargs = dict(init_kwargs)
            st.ray_actor_options = dict(ray_actor_options)
            st.batch_config = batch_config
            st.autoscaling = dict(autoscaling) if autoscaling else None
            st.version = version
            st.max_concurrent_queries = max(1, int(max_concurrent_queries))
            if st.autoscaling:
                lo = int(st.autoscaling.get("min_replicas", 1))
                hi = int(st.autoscaling.get("max_replicas", num_replicas))
                num_replicas = min(max(num_replicas, lo), hi)
            st.target_replicas = num_replicas

        cluster_events.emit(
            cluster_events.INFO, cluster_events.SERVE,
            f"deployment '{name}' deploy: version={version} "
            f"target={num_replicas}"
            + ("" if fresh else f" (was {old_version or 'unversioned'})"),
            custom_fields={"deployment": name, "version": version,
                           "target_replicas": num_replicas,
                           "fresh": fresh},
        )
        if fresh or not st.replicas:
            new = self._start_replicas(st, num_replicas, version)
            with self._lock:
                st.replicas = new
                st.replica_versions = [version] * len(new)
                self._bump_route(st)
            cluster_events.emit(
                cluster_events.INFO, cluster_events.SERVE,
                f"deployment '{name}': {len(new)} replica(s) running "
                f"(version {version})",
                custom_fields={"deployment": name,
                               "num_replicas": len(new)},
            )
            return list(st.replicas)

        if old_version == version:
            # Same code + args: just converge the replica count.
            self._converge_count(name)
            with self._lock:
                return list(st.replicas)

        self._rolling_update(name, version)
        with self._lock:
            return list(st.replicas)

    def _rolling_update(self, name: str, version: str) -> None:
        """Replace old-version replicas one at a time, new-first."""
        while True:
            with self._lock:
                st = self._deployments.get(name)
                if st is None or st.version != version:
                    return  # deleted or superseded by a newer deploy
                stale = [
                    i for i, v in enumerate(st.replica_versions)
                    if v != version
                ]
                if not stale and len(st.replicas) >= st.target_replicas:
                    return
            # Surge: start the replacement before retiring the old one so
            # capacity never dips (ref: max_surge semantics).
            new = self._start_replicas(st, 1, version)
            with self._lock:
                if st.version != version:
                    break  # superseded mid-update; new replica is orphaned
                st.replicas.extend(new)
                st.replica_versions.extend([version] * len(new))
                stale = [
                    i for i, v in enumerate(st.replica_versions)
                    if v != version
                ]
                victim = None
                if stale and len(st.replicas) > st.target_replicas:
                    i = stale[0]
                    victim = st.replicas.pop(i)
                    st.replica_versions.pop(i)
                self._bump_route(st)
            if victim is not None:
                # Retired from the route set first; grace period lets
                # in-flight calls drain before the actor dies.
                cluster_events.emit(
                    cluster_events.INFO, cluster_events.SERVE,
                    f"deployment '{name}' rolling update: replaced one "
                    f"replica with version {version}",
                    custom_fields={"deployment": name,
                                   "version": version},
                )
                self._drain_and_kill(victim)
        # Superseded: clean up the orphan we just made.
        for h in new:
            self._kill_replica(h)

    def _drain_and_kill(self, handle) -> None:
        try:
            rt.get(handle.prepare_shutdown.remote(), timeout=30.0)
        except Exception as e:
            # The replica is killed regardless, but a shutdown hook that
            # failed (or timed out with requests in flight) must leave a
            # trace — those are the requests that died with it.
            cluster_events.emit(
                cluster_events.WARNING, cluster_events.SERVE,
                f"replica prepare_shutdown failed before kill: {e!r}",
                custom_fields={"error_type": type(e).__name__},
            )
        self._kill_replica(handle)

    def _converge_count(self, name: str) -> None:
        """Bring the live replica count to target_replicas."""
        with self._lock:
            st = self._deployments.get(name)
            if st is None:
                return
            cur = len(st.replicas)
            target = st.target_replicas
            version = st.version
            victims = []
            if cur > target:
                victims = st.replicas[target:]
                del st.replicas[target:]
                del st.replica_versions[target:]
                self._bump_route(st)
        if cur < target:
            new = self._start_replicas(st, target - cur, version)
            with self._lock:
                if self._deployments.get(name) is st:
                    st.replicas.extend(new)
                    st.replica_versions.extend([version] * len(new))
                    self._bump_route(st)
                else:
                    victims = new
        for h in victims:
            self._drain_and_kill(h)

    def drain_replicas(self, actor_ids: List[str]) -> Dict[str, int]:
        """Surge-replace every replica whose actor id is in ``actor_ids``
        (ref analogue: deployment_state.py's drain-based replica
        migration), bump the route set so handles stop picking the
        victims, then gracefully drain and kill them. The route set
        never drops below target, so in-flight traffic always has
        somewhere to go — the same zero-downtime discipline as a
        rolling update. The breaker ejection below is its caller."""
        wanted = set(actor_ids)
        moved: Dict[str, int] = {}
        for name in list(self._deployments):
            with self._lock:
                st = self._deployments.get(name)
                if st is None:
                    continue
                victims = [r for r in st.replicas if r.actor_id in wanted]
                version = st.version
            if not victims:
                continue
            # Surge first: replacements come up before any victim leaves
            # the route set.
            new = self._start_replicas(st, len(victims), version)
            victim_ids = {id(r) for r in victims}
            with self._lock:
                if self._deployments.get(name) is not st \
                        or st.version != version:
                    orphans = new  # superseded mid-drain
                else:
                    keep = [
                        (r, v) for r, v in zip(st.replicas,
                                               st.replica_versions)
                        if id(r) not in victim_ids
                    ]
                    st.replicas = [r for r, _ in keep] + new
                    st.replica_versions = (
                        [v for _, v in keep] + [version] * len(new)
                    )
                    self._bump_route(st)
                    orphans = []
            if orphans:
                for h in orphans:
                    self._kill_replica(h)
                continue
            cluster_events.emit(
                cluster_events.INFO, cluster_events.SERVE,
                f"deployment '{name}' drain: replacing "
                f"{len(victims)} replica(s)",
                custom_fields={"deployment": name,
                               "migrated": len(victims)},
            )
            for h in victims:
                self._drain_and_kill(h)
            moved[name] = len(victims)
        return moved

    def scale(self, name: str, num_replicas: int) -> List[Any]:
        with self._lock:
            st = self._deployments[name]
            st.target_replicas = num_replicas
        self._converge_count(name)
        with self._lock:
            return list(st.replicas)

    # ---- autoscaling -------------------------------------------------------

    def record_handle_metrics(self, name: str, handle_id: str,
                              outstanding: int) -> None:
        """Handles push their outstanding-request totals here (ref:
        handle-side autoscaling metrics push, serve/_private/router.py)."""
        with self._lock:
            st = self._deployments.get(name)
            if st is not None:
                st.handle_metrics[handle_id] = (outstanding, time.monotonic())

    # Report gaps longer than this end a breaker-open episode (the
    # handle's breaker closed, or the handle died).
    BREAKER_REPORT_STALE_S = 5.0

    def report_breakers(self, name: str, handle_id: str,
                        open_map: Dict[str, str]) -> None:
        """Handle routers report replicas whose circuit breakers are not
        closed ({replica actor id: state}). The reconcile loop ejects
        replicas continuously OPEN past ``serve_breaker_eject_s``
        through the drain machinery (ref analogue: deployment_state.py
        health-based replica replacement, envoy outlier ejection)."""
        now = time.monotonic()
        with self._lock:
            st = self._deployments.get(name)
            if st is None:
                return
            for replica_hex, state_name in open_map.items():
                rec = st.breaker_reports.get(replica_hex)
                if rec is None or \
                        now - rec["last"] > self.BREAKER_REPORT_STALE_S:
                    st.breaker_reports[replica_hex] = {
                        "since": now, "last": now, "state": state_name,
                    }
                else:
                    rec["last"] = now
                    rec["state"] = state_name

    def set_breaker_eject_s(self, seconds: float) -> str:
        """Override the breaker-ejection threshold at runtime (ops/test
        hook; serve_breaker_eject_s seeds the default)."""
        self._breaker_eject_override = float(seconds)
        return "ok"

    def _eject_broken_once(self, name: str) -> None:
        """Replace replicas whose breakers have been reported OPEN
        continuously for serve_breaker_eject_s, via the drain machinery
        (surge-replace, route-set swap, graceful drain+kill)."""
        from ..core.config import get_config

        eject_s = (self._breaker_eject_override
                   if self._breaker_eject_override is not None
                   else get_config().serve_breaker_eject_s)
        if eject_s <= 0:
            return
        now = time.monotonic()
        with self._lock:
            st = self._deployments.get(name)
            if st is None or not st.replicas:
                return
            live = {r.actor_id for r in st.replicas}
            # Age out reports for gone replicas / healed breakers.
            for hex_id in list(st.breaker_reports):
                rec = st.breaker_reports[hex_id]
                if hex_id not in live or \
                        now - rec["last"] > 6 * self.BREAKER_REPORT_STALE_S:
                    del st.breaker_reports[hex_id]
            victims = [
                hex_id for hex_id, rec in st.breaker_reports.items()
                if rec["state"] == "open"
                and now - rec["since"] >= eject_s
                and now - rec["last"] <= self.BREAKER_REPORT_STALE_S
            ]
            # Never eject below one live replica per surge step; the
            # drain path surges first, so all victims are safe to hand
            # over at once.
            if not victims:
                return
            for hex_id in victims:
                del st.breaker_reports[hex_id]
        cluster_events.emit(
            cluster_events.WARNING, cluster_events.SERVE,
            f"deployment '{name}': ejecting {len(victims)} "
            f"persistently-unhealthy replica(s) (circuit breaker open "
            f"> {eject_s:.0f}s); surge-replacing via drain",
            custom_fields={"deployment": name, "ejected": len(victims)},
        )
        self.drain_replicas(victims)

    def _autoscale_once(self, name: str) -> None:
        import math

        with self._lock:
            st = self._deployments.get(name)
            if st is None or not st.autoscaling or not st.replicas:
                return
            cfg = st.autoscaling
            now = time.monotonic()
            total = sum(
                v for v, ts in st.handle_metrics.values()
                if now - ts < METRIC_STALENESS_S
            )
            cur = st.target_replicas
            target_ongoing = float(cfg.get("target_ongoing_requests", 2.0))
            desired = math.ceil(total / max(target_ongoing, 1e-9))
            desired = min(
                max(desired, int(cfg.get("min_replicas", 1))),
                int(cfg.get("max_replicas", cur)),
            )
            if desired > cur:
                st.downscale_since = None
                if st.upscale_since is None:
                    st.upscale_since = now
                if now - st.upscale_since < float(
                        cfg.get("upscale_delay_s", 2.0)):
                    return
            elif desired < cur:
                st.upscale_since = None
                if st.downscale_since is None:
                    st.downscale_since = now
                if now - st.downscale_since < float(
                        cfg.get("downscale_delay_s", 10.0)):
                    return
            else:
                st.upscale_since = None
                st.downscale_since = None
                return
            st.upscale_since = None
            st.downscale_since = None
            st.target_replicas = desired
        cluster_events.emit(
            cluster_events.INFO, cluster_events.SERVE,
            f"deployment '{name}' autoscale: {cur} -> {desired} "
            f"replica(s) (outstanding={total})",
            custom_fields={"deployment": name, "from": cur,
                           "to": desired, "outstanding": total},
        )
        self._converge_count(name)

    def _health_check_once(self, name: str) -> None:
        """Remove replicas whose actor died (worker crash, node loss) from
        the route set and start replacements (ref: deployment_state.py
        health checking + replica recovery). A ping that merely times out
        is 'busy', not dead — only actor-death errors evict."""
        from ..core.exceptions import (
            ActorDiedError,
            WorkerCrashedError,
        )

        with self._lock:
            st = self._deployments.get(name)
            if st is None or not st.replicas:
                return
            reps = list(st.replicas)
        pings = [(r, r.ping.remote()) for r in reps]
        dead = []
        for r, ref in pings:
            try:
                rt.get(ref, timeout=HEALTH_CHECK_TIMEOUT_S)
            except (ActorDiedError, WorkerCrashedError):
                dead.append(r)
            # Health-probe timeout on a live actor: slow/busy is not
            # dead, and eviction on slowness is the breaker's job
            # (serve_breaker_*), not the health checker's.
            except Exception:
                pass
        if not dead:
            return
        cluster_events.emit(
            cluster_events.ERROR, cluster_events.SERVE,
            f"deployment '{name}': {len(dead)} replica(s) died; evicting "
            f"from the route set and starting replacements",
            custom_fields={"deployment": name, "dead": len(dead)},
        )
        dead_ids = {id(r) for r in dead}
        with self._lock:
            st = self._deployments.get(name)
            if st is None:
                return
            keep = [
                (r, v) for r, v in zip(st.replicas, st.replica_versions)
                if id(r) not in dead_ids
            ]
            st.replicas = [r for r, _ in keep]
            st.replica_versions = [v for _, v in keep]
            self._bump_route(st)
        self._converge_count(name)

    def _reconcile_loop(self) -> None:
        # Wait for the worker runtime to finish wiring this actor up before
        # issuing nested remote calls from a background thread.
        time.sleep(RECONCILE_INTERVAL_S)
        last_health = 0.0
        while not self._stopped:
            try:
                check_health = (
                    time.monotonic() - last_health > HEALTH_CHECK_PERIOD_S
                )
                if check_health:
                    last_health = time.monotonic()
                for name in list(self._deployments):
                    self._autoscale_once(name)
                    if check_health:
                        self._health_check_once(name)
                        self._eject_broken_once(name)
            except Exception as e:
                # A reconcile crash must not silently freeze autoscaling
                # and health checks: surface every iteration's failure as
                # a cluster event, then keep reconciling.
                cluster_events.emit(
                    cluster_events.WARNING, cluster_events.SERVE,
                    f"serve controller reconcile iteration failed: {e!r}",
                    custom_fields={"error_type": type(e).__name__},
                )
            time.sleep(RECONCILE_INTERVAL_S)

    # ---- handle-facing query API -------------------------------------------

    def get_routing(self, name: str) -> Dict[str, Any]:
        with self._lock:
            st = self._deployments[name]
            return {
                "version": st.route_version,
                "replicas": list(st.replicas),
                "batch_config": st.batch_config,
            }

    def listen_for_route_change(self, name: str, known_version: int,
                                timeout_s: float = 10.0) -> Dict[str, Any]:
        """Long-poll: returns as soon as the route set changes, or after
        timeout with the current snapshot (ref: long_poll.py
        LongPollClient/Host)."""
        deadline = time.monotonic() + timeout_s
        with self._lock:
            while True:
                st = self._deployments.get(name)
                if st is None:
                    return {"version": -1, "replicas": [],
                            "batch_config": None}
                if st.route_version != known_version:
                    break
                remaining = deadline - time.monotonic()
                if remaining <= 0:
                    break
                self._route_cond.wait(remaining)
            return {
                "version": st.route_version,
                "replicas": list(st.replicas),
                "batch_config": st.batch_config,
            }

    def get_replicas(self, name: str) -> List[Any]:
        with self._lock:
            return list(self._deployments[name].replicas)

    def get_batch_config(self, name: str):
        with self._lock:
            return self._deployments[name].batch_config

    def list_deployments(self) -> Dict[str, int]:
        with self._lock:
            return {
                k: len(v.replicas) for k, v in self._deployments.items()
            }

    def describe(self) -> Dict[str, Dict[str, Any]]:
        """Rich status (ref: serve.status() ApplicationDetails)."""
        with self._lock:
            return {
                name: {
                    "num_replicas": len(st.replicas),
                    "target_replicas": st.target_replicas,
                    "version": st.version,
                    "replica_versions": list(st.replica_versions),
                    "autoscaling": st.autoscaling,
                    "route_version": st.route_version,
                }
                for name, st in self._deployments.items()
            }

    def delete(self, name: str):
        with self._lock:
            st = self._deployments.pop(name, None)
            if st is not None:
                victims = list(st.replicas)
                st.replicas = []
                st.replica_versions = []
                self._bump_route(st)
        if st is not None:
            cluster_events.emit(
                cluster_events.INFO, cluster_events.SERVE,
                f"deployment '{name}' deleted "
                f"({len(victims)} replica(s) retired)",
                custom_fields={"deployment": name,
                               "replicas": len(victims)},
            )
            for h in victims:
                self._kill_replica(h)

    def shutdown(self):
        self._stopped = True
        for name in list(self._deployments):
            self.delete(name)
        return "ok"
