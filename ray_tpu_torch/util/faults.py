"""Deterministic fault injection for the checkpoint, train and serve paths
(counterpart of the parts of ``ray_tpu/util/faults.py`` that they fire).

A plan is a list of specs (:func:`validate_spec`); :func:`apply_plan` arms
it in THIS process and :func:`fire` is the hook a call site runs where a
real fault would surface. Disarmed, :func:`fire` is one truth test.

- Points: :data:`CHECKPOINT_IO` (``train/checkpoint.py`` fires it at the
  top of save and of restore, with ``op="save"`` or ``op="restore"``) and
  :data:`TRAIN_WORKER` (``train/session.py``'s ``report`` fires it with
  ``rank`` and ``run``: a rank killed mid-step, which the gang supervisor
  answers with a whole-gang restart), and :data:`SERVE_REPLICA`
  (``serve/replica.py`` fires it inside each request's measured window,
  with ``deployment``, ``replica`` and ``method``: a slow or faulty
  replica, scoped to one with ``match={"replica": <id>}``).
- Modes: ``always``, ``once`` (the Nth eligible hit), ``every`` (every
  Nth hit), ``prob`` (seeded RNG); per-process counters, so a seeded run
  replays identically. ``max_fires`` caps the firings (0: no cap).
- Actions: ``error`` raises :class:`InjectedFault` (a ``ConnectionError``,
  so the caller's failure handling runs as for a real I/O fault);
  ``latency`` returns a delay that the call site sleeps.
- ``match`` ({context key: value prefix}) scopes a spec to the firings
  whose context matches every entry, e.g. ``{"op": "save"}``.

The JAX package arms a plan across the cluster through its GCS and
publishes a CHAOS event per firing. The port's runtime is one node with
no such plane: a plan is armed process by process and firings are counted
locally (:func:`fired_counts`). A train rank runs in a worker process, so
``train/trainer.py`` hands the driver's armed ``train_worker`` specs to
each rank it starts (:func:`armed_specs`), and the rank arms them in its
own process before its loop; a spec scoped to one ``run`` fires in that
attempt only, since a restarted gang gets a new run id. The ``partition``
action and ``node`` scoping belong to a cluster plane too.
"""

from __future__ import annotations

import random
import threading
from typing import Any, Dict, List, Tuple

SERVE_REPLICA = "serve_replica"
CHECKPOINT_IO = "checkpoint_io"
TRAIN_WORKER = "train_worker"

FAULT_POINTS: Dict[str, str] = {
    SERVE_REPLICA: "serve replica request execution "
                   "(degradation: handle retries another replica under "
                   "the retry budget, the sick replica's circuit "
                   "breaker opens, proxies shed under sustained "
                   "latency; scope to one replica via "
                   "match={'replica': ...})",
    TRAIN_WORKER: "train worker step boundary (session.report) "
                  "(degradation: the rank dies mid-step, the gang "
                  "supervisor aborts the whole gang and restarts it "
                  "from the last committed checkpoint, bounded by "
                  "FailureConfig.max_failures; scope to one rank via "
                  "match={'rank': ...})",
    CHECKPOINT_IO: "checkpoint save/restore I/O "
                   "(degradation: the half-written .tmp- directory "
                   "never becomes a committed checkpoint; restore "
                   "falls back to the previous committed entry; "
                   "scope via match={'op': 'save'|'restore'})",
}

MODES = ("always", "once", "every", "prob")
ACTIONS = ("error", "latency")


class InjectedFault(ConnectionError):
    """Raised at an armed injection point. A ``ConnectionError`` so the
    surrounding failure handling treats it exactly like a real transport
    or I/O fault."""


class _ArmedSpec:
    """Per-process state of one armed spec (hit/fire counters + RNG)."""

    __slots__ = ("point", "mode", "action", "n", "p", "delay_s",
                 "max_fires", "match", "hits", "fires", "rng")

    def __init__(self, spec: Dict[str, Any]):
        self.point = spec["point"]
        self.mode = spec["mode"]
        self.action = spec["action"]
        self.n = spec["n"]
        self.p = spec["p"]
        self.delay_s = spec["delay_s"]
        self.max_fires = spec["max_fires"]
        self.match = spec["match"]
        self.hits = 0
        self.fires = 0
        self.rng = random.Random(spec["seed"])


def validate_spec(spec: Dict[str, Any]) -> Dict[str, Any]:
    """Normalize one spec; raises ``ValueError`` on a point, mode or action
    this module does not declare. Fields: ``point`` (required), ``mode``
    (default ``always``), ``action`` (default ``error``), ``n``
    (once/every), ``p`` + ``seed`` (prob), ``delay_s`` (latency),
    ``max_fires`` (0 = unbounded), ``match``."""
    if not isinstance(spec, dict):
        raise ValueError(f"fault spec must be a dict, got {type(spec)}")
    point = spec.get("point")
    if point not in FAULT_POINTS:
        raise ValueError(f"unknown injection point {point!r} "
                         f"(one of {sorted(FAULT_POINTS)})")
    mode = spec.get("mode", "always")
    if mode not in MODES:
        raise ValueError(f"unknown fault mode {mode!r} (one of {MODES})")
    action = spec.get("action", "error")
    if action not in ACTIONS:
        raise ValueError(f"unknown fault action {action!r} (one of "
                         f"{ACTIONS})")
    out = {
        "point": point,
        "mode": mode,
        "action": action,
        "n": max(1, int(spec.get("n", 1))),
        "p": min(1.0, max(0.0, float(spec.get("p", 1.0)))),
        "seed": spec.get("seed"),
        "delay_s": max(0.0, float(spec.get("delay_s", 0.0))),
        "max_fires": max(0, int(spec.get("max_fires", 0))),
        "match": {str(k): str(v)
                  for k, v in (spec.get("match") or {}).items()},
    }
    if action == "latency" and out["delay_s"] <= 0:
        raise ValueError("latency action needs delay_s > 0")
    return out


_lock = threading.Lock()
# The validated specs of the armed plan, for handing on to train ranks.
_specs: Tuple[Dict[str, Any], ...] = ()
# () when disarmed: fire()'s whole cost is this truth test.
_armed: Tuple[_ArmedSpec, ...] = ()


def apply_plan(specs: List[Dict[str, Any]]) -> None:
    """Install ``specs`` as this process's armed plan, replacing any
    previous one; every spec starts from zero, so re-applying a seeded
    plan replays identically. A spec that does not validate raises."""
    global _armed, _specs
    valid = tuple(validate_spec(s) for s in specs or [])
    states = tuple(_ArmedSpec(s) for s in valid)
    with _lock:
        _armed = states
        _specs = valid


def armed_specs(point: str) -> List[Dict[str, Any]]:
    """The armed plan's specs for ``point``, as validated."""
    with _lock:
        return [dict(s) for s in _specs if s["point"] == point]


def clear() -> None:
    """Disarm every injection point in this process."""
    apply_plan([])


def armed() -> bool:
    return bool(_armed)


def fired_counts() -> Dict[str, int]:
    """Per-point firing counts in this process."""
    with _lock:
        out: Dict[str, int] = {}
        for a in _armed:
            out[a.point] = out.get(a.point, 0) + a.fires
        return out


def fire(point: str, **ctx: Any) -> float:
    """The injection point hook: returns a delay in seconds for the call
    site to sleep (0.0 almost always), or raises :class:`InjectedFault`
    for an ``error`` spec that fires."""
    if not _armed:
        return 0.0
    fired: List[_ArmedSpec] = []
    with _lock:
        for a in _armed:
            if a.point != point:
                continue
            if a.match and not all(str(ctx.get(k, "")).startswith(v)
                                   for k, v in a.match.items()):
                continue
            a.hits += 1
            if a.max_fires and a.fires >= a.max_fires:
                continue
            if a.mode == "always":
                hit = True
            elif a.mode == "once":
                hit = a.fires == 0 and a.hits >= a.n
            elif a.mode == "every":
                hit = a.hits % a.n == 0
            else:  # prob
                hit = a.rng.random() < a.p
            if hit:
                a.fires += 1
                fired.append(a)
    delay = 0.0
    for a in fired:
        if a.action == "error":
            raise InjectedFault(f"injected error at {point} "
                                f"(mode={a.mode}, fire #{a.fires})")
        delay = max(delay, a.delay_s)
    return delay
