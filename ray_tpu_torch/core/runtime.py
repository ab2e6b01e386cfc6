"""The driver side of the single-node runtime (counterpart of
``ray_tpu/core/runtime.py``'s ``DriverRuntime`` together with the
single-node part of ``ray_tpu/core/node_manager.py``).

The driver holds everything: the scheduler over the node's resources and
its placement-group bundles, the worker pool, the object table and the KV.
Workers are separate processes started with ``subprocess.Popen([python,
"-m", "ray_tpu_torch.core.worker_main"])`` (never forked: the driver may
hold a CUDA context), which connect back over a localhost socket with an
auth key and speak pickled tuples (``multiprocessing.connection``).

- **Worker types.** A task or actor asking for ``"GPU"`` runs in a
  ``gpu``-typed worker whose ``CUDA_VISIBLE_DEVICES`` is the driver's
  visible card at the assigned index (the driver's own entry, not a
  literal index); every other one runs in a ``cpu``-typed worker with
  ``CUDA_VISIBLE_DEVICES=""``. A request that the node can never hold
  fails after ``infeasible_grace_s`` with a ``TaskError``; it never runs
  elsewhere.
- **Serialization** is the standard library's ``pickle``: functions and
  classes travel by reference, so a remote function, an actor class or a
  train loop must be importable at module level in the worker. The driver
  passes its ``sys.path`` to the workers through ``PYTHONPATH``.
- **Objects** live in the driver as pickled bytes, counted against
  ``init(object_store_memory=)`` (:meth:`DriverRuntime.store_usage`, which
  the data plane's backpressure reads; nothing is refused or spilled at
  the capacity). A task's top-level
  ``ObjectRef`` arguments are resolved by the driver before it dispatches
  the task; refs nested deeper travel as refs and the worker ``get``\\ s
  them. Workers forward ``get``, ``put``, ``wait``, the KV and nested
  submissions to the driver.
- **Streaming returns.** A task or actor call submitted with
  ``num_returns="streaming"`` has one return, its completion (the item
  count, or its error), and a stream record keyed by that object's id.
  The worker sends each value the generator yields over its connection as
  it is produced (``("item", ...)``), before the call's ``done``, so the
  driver stores every item ahead of the completion; the consumer's
  :class:`~.streaming.ObjectRefGenerator` takes them in order with
  :meth:`DriverRuntime.stream_next`. The stream holds each item until the
  consumer takes it; dropping the generator frees the items never taken,
  and items that arrive after that are not stored. A streaming task is
  never retried (it would yield its items again).
- **Deadlines.** A submission made under an ambient deadline
  (``util/overload``) carries it to the worker, which installs it around
  the call, refuses the call if it has expired already, and checks it
  between a stream's items.
- **Object lifetimes.** The driver counts, for each object, its own live
  refs, the stored values and queued tasks that hold a ref to it, and the
  workers it handed a ref to. A worker borrows an object from the moment
  the driver sends it a ref (in a task's arguments, a ``get`` reply, the
  result ids of its submission or ``put``) until it reports that it
  dropped every ref it was handed; a worker that exits returns them all.
- **Failures.** A worker that dies fails its task with
  ``WorkerCrashedError`` once its retries are spent, or its actor's calls,
  in flight and queued, with ``ActorDiedError`` (an actor with restarts
  left is created again in a new worker and keeps its queue). The dead
  worker's resources, card and bundle share go back.
"""

from __future__ import annotations

import os
import pickle
import secrets
import socket
import subprocess
import sys
import tempfile
import threading
import time
import uuid
from collections import deque
from multiprocessing.connection import Listener
from typing import Any, Dict, List, Optional, Tuple

from .config import get_config
from .exceptions import (
    ActorDiedError,
    GetTimeoutError,
    TaskError,
    WorkerCrashedError,
)
from .reference import ObjectRef, dumps_with_refs, refuse_unimportable
from .resources import GPU, NodeResources, ResourceSet

WORKER_MODULE = "ray_tpu_torch.core.worker_main"
PING = "__rtpu_ping__"
STREAMING = "streaming"  # the num_returns of a streaming call
# A started worker that has not connected by then is killed.
WORKER_START_TIMEOUT_S = 120.0
# Worker processes the node runs at once; at the cap an idle worker of
# another type is stopped to make room, else the task waits.
MAX_WORKERS = 64


def new_id() -> str:
    return uuid.uuid4().hex[:24]


def dumps(value) -> bytes:
    return pickle.dumps(value, protocol=pickle.HIGHEST_PROTOCOL)


def dump_callable(fn) -> bytes:
    """Pickle a function or class by reference, refusing what a worker
    could not import (``__main__``, a local or lambda)."""
    refuse_unimportable(fn)
    return dumps(fn)


class _Arg:
    """Placeholder for a top-level ObjectRef argument."""

    __slots__ = ("index",)

    def __init__(self, index: int):
        self.index = index

    def __reduce__(self):
        return (_Arg, (self.index,))


def pack_args(args, kwargs) -> Tuple[bytes, List[str], List[str]]:
    """Pickle call arguments with each top-level ObjectRef replaced by a
    placeholder; returns (blob, the top-level refs' object ids, the ids of
    the refs nested in the blob)."""
    deps: List[str] = []

    def conv(v):
        if isinstance(v, ObjectRef):
            deps.append(v.hex())
            return _Arg(len(deps) - 1)
        return v

    blob, nested = dumps_with_refs((tuple(conv(a) for a in args),
                                    {k: conv(v) for k, v in kwargs.items()}))
    return blob, deps, nested


def unpack_args(blob: bytes, values: list):
    args, kwargs = pickle.loads(blob)

    def sub(v):
        return values[v.index] if isinstance(v, _Arg) else v

    return tuple(sub(a) for a in args), {k: sub(v) for k, v in kwargs.items()}


def worker_pythonpath() -> str:
    """The driver's ``sys.path`` (cwd for ''), the package root first."""
    root = os.path.dirname(os.path.dirname(os.path.dirname(
        os.path.abspath(__file__))))
    out: List[str] = []
    for p in [root] + sys.path + os.environ.get(
            "PYTHONPATH", "").split(os.pathsep):
        p = os.path.abspath(p or os.getcwd())
        if p not in out:
            out.append(p)
    return os.pathsep.join(out)


# ------------------------------------------------------------ records


class _Object:
    __slots__ = ("blob", "error", "ready", "pinned", "nested")

    def __init__(self):
        self.blob: Optional[bytes] = None
        self.error: Optional[bytes] = None  # a pickled TaskError
        self.ready = False
        self.pinned = False  # a ref to it was pickled outside the runtime
        self.nested: List[str] = []  # the refs inside ``blob``, held

    def nbytes(self) -> int:
        return len(self.blob or self.error or b"")


class _Stream:
    """The items a streaming call has produced and its consumer has not
    taken yet (``None`` once taken); the stream holds a ref to each."""

    __slots__ = ("items",)

    def __init__(self):
        self.items: List[Optional[str]] = []


class _Task:
    """A normal task, an actor creation or an actor call."""

    def __init__(self, spec: Dict[str, Any], args_blob: bytes,
                 deps: List[str], nested: List[str], keep: list,
                 returns: List[str]):
        self.kind = spec["kind"]
        self.tid = new_id()
        self.name = spec["name"]
        self.fn = spec.get("fn")
        self.method = spec.get("method")
        self.num_returns = spec.get("num_returns", 1)
        self.resources: ResourceSet = spec.get("resources") or ResourceSet()
        self.strategy = spec.get("strategy")
        # The completion object's id of a streaming call, its stream's key.
        self.stream: Optional[str] = None
        self.retries_left = 0 if self.num_returns == STREAMING else \
            int(spec.get("max_retries", 0))
        self.deadline = float(spec.get("deadline") or 0.0)
        self.args_blob = args_blob
        self.deps = deps
        self.nested = nested
        self.keep = keep  # refs to deps and nested, alive until done
        self.returns = returns
        self.actor: Optional["_Actor"] = None
        self.max_concurrency = int(spec.get("max_concurrency", 1))
        self.gpus: List[int] = []  # the node's card indices it holds
        self.bundle: Optional["_Bundle"] = None
        self.infeasible_since: Optional[float] = None


class _Worker:
    def __init__(self, wid: str, kind: str, visible: str, proc, log_path):
        self.wid = wid
        self.kind = kind
        self.visible = visible
        self.proc = proc
        self.log_path = log_path
        self.conn = None
        self.send_lock = threading.Lock()
        self.state = "starting"  # starting | idle | busy | actor | dead
        self.task: Optional[_Task] = None
        self.actor: Optional["_Actor"] = None
        self.started = time.monotonic()
        self.killed = ""  # why the runtime killed it, if it did
        self.borrows: Dict[str, int] = {}  # object id: refs handed over


class _Actor:
    def __init__(self, aid: str, create: _Task, max_restarts: int,
                 name: str, class_name: str):
        self.aid = aid
        self.create = create
        self.restarts_left = max_restarts
        self.name = name
        self.class_name = class_name
        self.state = "pending"  # pending | alive | dead
        self.worker: Optional[_Worker] = None
        self.queue: deque = deque()
        self.inflight: Dict[str, _Task] = {}
        self.death_cause = ""
        self.killed = False


class _Bundle:
    def __init__(self, pg: "_PG", index: int, spec: Dict[str, float]):
        self.pg = pg
        self.index = index
        self.res = NodeResources(ResourceSet(spec))
        self.gpu_free: List[int] = []  # its cards no task holds


class _PG:
    def __init__(self, pid: str, bundles, strategy: str, name: str):
        self.pid = pid
        self.specs = bundles
        self.strategy = strategy
        self.name = name
        self.state = "pending"  # pending | created | removed
        self.bundles = [_Bundle(self, i, b) for i, b in enumerate(bundles)]


def _take_gpus(free: List[int], amount: float) -> Optional[List[int]]:
    """Take ``amount`` whole cards, the lowest indices first, out of
    ``free``; None when they do not fit now."""
    n = int(amount)
    if n > len(free):
        return None
    free.sort()
    taken = free[:n]
    del free[:n]
    return taken


# ------------------------------------------------------------- driver


class DriverRuntime:
    """The runtime of the process that called ``init``."""

    def __init__(self, resources: Dict[str, float], gpu_entries: List[str],
                 session_dir: str):
        self.config = get_config()
        self.node_id = new_id()
        self.worker_id = "driver"
        self.session_dir = session_dir
        self._lock = threading.RLock()
        self._cv = threading.Condition(self._lock)
        self._node = NodeResources(ResourceSet(resources))
        self._gpu_entries = list(gpu_entries)
        self._gpu_free = list(range(int(self._node.total.get(GPU))))
        self._objects: Dict[str, _Object] = {}
        self._store_used = 0  # bytes of the ready objects held
        self._store_capacity = int(self.config.object_store_memory)
        self._refs: Dict[str, int] = {}
        self._kv: Dict[str, bytes] = {}
        self._workers: Dict[str, _Worker] = {}
        self._queue: List[_Task] = []
        self._actors: Dict[str, _Actor] = {}
        self._names: Dict[str, str] = {}
        self._pgs: Dict[str, _PG] = {}
        self._pending_pgs: List[_PG] = []
        self._running: Dict[str, _Task] = {}
        self._streams: Dict[str, _Stream] = {}
        self._fn_cache: Dict[int, Tuple[Any, bytes]] = {}
        self._closing = False
        self._authkey = secrets.token_bytes(16)
        # A backlog for every worker the node may start at once: with the
        # default of 1, a burst of starting workers overflows it and the
        # kernel drops their connects, which retry after 1, 3, 7, ... s
        # (one of 26 at once had not connected after 120 s).
        self._listener = Listener(("127.0.0.1", 0), authkey=self._authkey,
                                  backlog=MAX_WORKERS)
        self._address = "%s:%d" % self._listener.address
        self._pythonpath = worker_pythonpath()
        self._threads = [
            threading.Thread(target=self._accept_loop, daemon=True,
                             name="ray_tpu_torch-accept"),
            threading.Thread(target=self._reap_loop, daemon=True,
                             name="ray_tpu_torch-reap"),
        ]
        for t in self._threads:
            t.start()
        with self._lock:
            for _ in range(self.config.num_prestart_workers):
                self._spawn("cpu", "")

    # ------------------------------------------------------ refs/objects

    def add_ref(self, oid: str) -> None:
        with self._lock:
            self._refs[oid] = self._refs.get(oid, 0) + 1

    def release_ref(self, oid: str) -> None:
        with self._lock:
            n = self._refs.get(oid, 0) - 1
            if n > 0:
                self._refs[oid] = n
                return
            self._refs.pop(oid, None)
            obj = self._objects.get(oid)
            if obj is not None and obj.ready and not obj.pinned:
                self._free(oid)

    def _free(self, oid: str) -> None:
        obj = self._objects.pop(oid)
        self._store_used -= obj.nbytes()
        for n in obj.nested:
            self.release_ref(n)

    def escape(self, oid: str) -> None:
        """A ref was pickled outside the runtime's own paths: nothing can
        count it, so its object stays for the runtime's life."""
        with self._lock:
            obj = self._objects.get(oid)
            if obj is not None:
                obj.pinned = True

    def _borrow(self, w: _Worker, oids: List[str]) -> None:
        """``w`` is sent one ref to each of ``oids`` (lock held)."""
        for oid in oids:
            n = w.borrows.get(oid, 0)
            if n == 0:
                self.add_ref(oid)
            w.borrows[oid] = n + 1

    def _unborrow(self, w: _Worker, oid: str, handed: int) -> None:
        """``w`` dropped its refs to ``oid`` after ``handed`` were made."""
        n = w.borrows.get(oid)
        if n is None:
            return
        if n > handed:  # more refs are on their way to it
            w.borrows[oid] = n - handed
            return
        del w.borrows[oid]
        self.release_ref(oid)

    def _return_borrows(self, w: _Worker) -> None:
        borrows, w.borrows = w.borrows, {}
        for oid in borrows:
            self.release_ref(oid)

    def _new_object(self) -> str:
        oid = new_id()
        self._objects[oid] = _Object()
        return oid

    def _store(self, oid: str, blob: Optional[bytes] = None,
               error: Optional[bytes] = None, nested=()) -> None:
        obj = self._objects.get(oid)
        if obj is None:
            return
        obj.blob, obj.error, obj.ready = blob, error, True
        # Nobody holds a ref (a queued task holds its arguments' refs in
        # ``keep``): the value is not needed.
        if not obj.pinned and self._refs.get(oid, 0) <= 0:
            del self._objects[oid]
        else:
            self._store_used += obj.nbytes()
            obj.nested = list(nested)
            for n in obj.nested:
                self.add_ref(n)
        self._cv.notify_all()

    def _fail(self, task: _Task, error: TaskError) -> None:
        blob = dumps(error)
        for oid in task.returns:
            self._store(oid, error=blob)

    def _wait_ready(self, oids: List[str], num: int,
                    timeout: Optional[float]) -> List[str]:
        deadline = None if timeout is None else time.monotonic() + timeout
        with self._cv:
            while True:
                ready = [o for o in oids
                         if o not in self._objects or self._objects[o].ready]
                if len(ready) >= num:
                    return ready
                left = None if deadline is None else \
                    deadline - time.monotonic()
                if left is not None and left <= 0:
                    return ready
                self._cv.wait(left if left is None else min(left, 1.0))

    def _read(self, oids: List[str], borrower: Optional[_Worker] = None
              ) -> List[Tuple[str, bytes]]:
        out = []
        with self._lock:
            objs = [self._objects.get(oid) for oid in oids]
            for oid, obj in zip(oids, objs):
                if obj is None:
                    raise GetTimeoutError(f"object {oid} unavailable")
            for obj in objs:
                if borrower is not None:
                    self._borrow(borrower, obj.nested)
                out.append(("e", obj.error) if obj.error is not None
                           else ("v", obj.blob))
        return out

    def get_blobs(self, oids: List[str], timeout: Optional[float],
                  borrower: Optional[_Worker] = None):
        ready = self._wait_ready(oids, len(oids), timeout)
        if len(ready) < len(oids):
            raise GetTimeoutError(
                f"get() timed out after {timeout}s waiting for "
                f"{len(oids) - len(ready)} objects")
        return self._read(oids, borrower)

    def get(self, refs, timeout: Optional[float] = None):
        single = isinstance(refs, ObjectRef)
        ref_list = [refs] if single else list(refs)
        values = []
        for kind, blob in self.get_blobs([r.hex() for r in ref_list],
                                         timeout):
            value = pickle.loads(blob)
            if kind == "e":
                raise value.as_raisable()
            values.append(value)
        return values[0] if single else values

    def wait_ids(self, oids: List[str], num_returns: int,
                 timeout: Optional[float]) -> List[str]:
        if num_returns > len(oids):
            raise ValueError("num_returns exceeds number of refs")
        return self._wait_ready(oids, num_returns, timeout)

    def wait(self, refs, num_returns: int = 1,
             timeout: Optional[float] = None):
        refs = list(refs)
        ready_ids = set(self.wait_ids([r.hex() for r in refs], num_returns,
                                      timeout))
        ready, not_ready = [], []
        for r in refs:
            (ready if r.hex() in ready_ids and len(ready) < num_returns
             else not_ready).append(r)
        return ready, not_ready

    def put_blob(self, blob: bytes, nested: List[str],
                 borrower: _Worker) -> str:
        with self._lock:
            oid = self._new_object()
            self._borrow(borrower, [oid])
            self._store(oid, blob=blob, nested=nested)
            return oid

    def put(self, value) -> ObjectRef:
        blob, nested = dumps_with_refs(value)
        with self._lock:
            oid = self._new_object()
            ref = ObjectRef(oid)
            self._store(oid, blob=blob, nested=nested)
            return ref

    def store_usage(self) -> Tuple[int, int]:
        """(bytes of the objects the driver holds, ``object_store_memory``;
        0 when ``init`` set no capacity)."""
        with self._lock:
            return self._store_used, self._store_capacity

    # ----------------------------------------------------------- streams

    def _stream_item(self, tid: str, blob: bytes, nested: List[str]) -> None:
        """A streaming call yielded a value (lock held)."""
        task = self._running.get(tid)
        st = self._streams.get(task.stream) if task is not None and \
            task.stream else None
        if st is None:
            return  # the consumer dropped the stream: nobody will read it
        oid = self._new_object()
        self.add_ref(oid)  # the stream's hold, until the consumer takes it
        st.items.append(oid)
        self._store(oid, blob=blob, nested=nested)

    def stream_next(self, sid: str, index: int, timeout: Optional[float],
                    borrower: Optional[_Worker] = None):
        """Item ``index`` of stream ``sid`` once it is produced:
        ``("item", ref)`` (for a worker: the object id, lent to it),
        ``("end", None)`` after the last item, ``("error", blob)`` when the
        call failed after the items before it. Raises
        :class:`GetTimeoutError` when nothing came within ``timeout``."""
        deadline = None if timeout is None else time.monotonic() + timeout
        with self._cv:
            while True:
                st = self._streams.get(sid)
                if st is None:
                    raise ValueError(f"stream {sid} was dropped")
                if index < len(st.items):
                    oid, st.items[index] = st.items[index], None
                    if borrower is None:
                        out = ObjectRef(oid)
                    else:
                        self._borrow(borrower, [oid])
                        out = oid
                    self.release_ref(oid)  # the stream's hold
                    return "item", out
                done = self._objects.get(sid)
                if done is not None and done.ready:
                    del self._streams[sid]
                    if done.error is not None:
                        return "error", done.error
                    return "end", None
                left = None if deadline is None else \
                    deadline - time.monotonic()
                if left is not None and left <= 0:
                    raise GetTimeoutError(
                        f"stream item {index} not produced within "
                        f"{timeout}s")
                self._cv.wait(1.0 if left is None else min(left, 1.0))

    def stream_drop(self, sid: str) -> None:
        """The consumer dropped the stream: free the items it never
        took."""
        with self._lock:
            st = self._streams.pop(sid, None)
            if st is not None:
                for oid in st.items:
                    if oid is not None:
                        self.release_ref(oid)

    # ---------------------------------------------------------------- KV

    def kv_put(self, key: str, value: bytes, overwrite: bool = True) -> bool:
        with self._lock:
            if not overwrite and key in self._kv:
                return False
            self._kv[key] = value
            return True

    def kv_get(self, key: str) -> Optional[bytes]:
        with self._lock:
            return self._kv.get(key)

    def kv_del(self, key: str) -> bool:
        with self._lock:
            return self._kv.pop(key, None) is not None

    def kv_keys(self, prefix: str = "") -> List[str]:
        with self._lock:
            return [k for k in self._kv if k.startswith(prefix)]

    # ---------------------------------------------------------- resources

    def cluster_resources(self) -> Dict[str, float]:
        return self._node.total.to_dict()

    def available_resources(self) -> Dict[str, float]:
        with self._lock:
            return self._node.available.to_dict()

    def nodes(self) -> List[Dict[str, Any]]:
        return [{"NodeID": self.node_id, "Alive": True,
                 "Resources": self.cluster_resources()}]

    def worker_pids(self) -> List[int]:
        with self._lock:
            return [w.proc.pid for w in self._workers.values()]

    # --------------------------------------------------------- submission

    def ensure_function(self, fn) -> bytes:
        hit = self._fn_cache.get(id(fn))
        if hit is not None and hit[0] is fn:
            return hit[1]
        blob = dump_callable(fn)
        self._fn_cache[id(fn)] = (fn, blob)
        return blob

    def submit(self, spec: Dict[str, Any], args, kwargs) -> list:
        """Queue a task, actor creation or actor call; returns its result
        refs (an actor creation: the actor id)."""
        blob, deps, nested = pack_args(args, kwargs)
        return self.submit_packed(spec, blob, deps, nested)

    def submit_packed(self, spec, blob, deps, nested,
                      borrower: Optional[_Worker] = None) -> list:
        """Queue a packed submission. The driver's own gets its result
        refs, made before a result can land and find nobody holding it; a
        worker's (``borrower``) gets the result ids, lent to it."""
        with self._lock:
            if self._closing:
                raise RuntimeError("the runtime is shutting down")
            kind = spec["kind"]
            n = spec.get("num_returns", 1)
            n = 0 if kind == "create" else 1 if n == STREAMING else n
            returns = [self._new_object() for _ in range(n)]
            if borrower is None:
                refs = [ObjectRef(o) for o in returns]
            else:
                self._borrow(borrower, returns)
                refs = returns
            keep = [ObjectRef(o) for o in deps + nested]
            task = _Task(spec, blob, deps, nested, keep, returns)
            if task.num_returns == STREAMING:
                task.stream = returns[0]
                self._streams[task.stream] = _Stream()
            if kind == "create":
                aid = new_id()
                actor = _Actor(aid, task, int(spec.get("max_restarts", 0)),
                               spec.get("name", ""), spec["class_name"])
                if actor.name:
                    if actor.name in self._names:
                        raise ValueError(
                            f"actor name {actor.name!r} is already taken")
                    self._names[actor.name] = aid
                task.actor = actor
                self._actors[aid] = actor
                self._queue.append(task)
                self._schedule()
                return [aid]
            if kind == "call":
                actor = self._actors.get(spec["actor"])
                if actor is None or actor.state == "dead":
                    cause = actor.death_cause if actor else "unknown actor"
                    self._fail(task, ActorDiedError(task.name, cause))
                    return refs
                task.actor = actor
                actor.queue.append(task)
                self._pump(actor)
                return refs
            self._queue.append(task)
            self._schedule()
            return refs

    def get_named_actor(self, name: str):
        with self._lock:
            aid = self._names.get(name)
            actor = self._actors.get(aid) if aid else None
            if actor is None or actor.state == "dead":
                return None
            return aid, actor.class_name

    def kill_actor(self, aid: str, no_restart: bool = True) -> None:
        """Kill the actor's worker; with ``no_restart`` False an actor with
        restarts left comes back as after a crash (a pending one stays
        pending)."""
        with self._lock:
            actor = self._actors.get(aid)
            if actor is None or actor.state == "dead":
                return
            worker = actor.worker
            if worker is None and not no_restart:
                return
            actor.killed = no_restart
            if worker is None:  # not placed yet
                if actor.create in self._queue:
                    self._queue.remove(actor.create)
                self._actor_dead(actor, "killed by kill()")
                self._schedule()
                return
        self._kill_worker(worker, "the actor was killed by kill()")

    # ------------------------------------------------- placement groups

    def pg_create(self, pid: str, bundles, strategy: str, name: str):
        with self._lock:
            pg = _PG(pid, bundles, strategy, name)
            self._pgs[pid] = pg
            self._pending_pgs.append(pg)
            self._schedule()

    def pg_wait(self, pid: str, timeout: float) -> bool:
        deadline = time.monotonic() + timeout
        with self._cv:
            while True:
                pg = self._pgs.get(pid)
                if pg is None or pg.state == "removed":
                    return False
                if pg.state == "created":
                    return True
                left = deadline - time.monotonic()
                if left <= 0:
                    return False
                self._cv.wait(min(left, 1.0))

    def pg_remove(self, pid: str) -> None:
        with self._lock:
            pg = self._pgs.get(pid)
            if pg is None or pg.state == "removed":
                return
            victims = [a.worker for a in self._actors.values()
                       if a.create.bundle is not None
                       and a.create.bundle.pg is pg
                       and a.worker is not None and a.state != "dead"]
            for a in self._actors.values():
                if a.state == "pending" and a.create.bundle is None and \
                        getattr(a.create.strategy, "pg_id", None) == pid:
                    a.killed = True
        for w in victims:
            if w.actor is not None:
                w.actor.killed = True
            self._kill_worker(w, "its placement group was removed")
        with self._lock:
            if pg in self._pending_pgs:
                self._pending_pgs.remove(pg)
            if pg.state == "created":
                for b in pg.bundles:
                    self._node.release(b.res.available)
                    self._gpu_free += b.gpu_free
            pg.state = "removed"
            self._schedule()

    def _try_place_pg(self, pg: _PG) -> bool:
        if pg.strategy == "STRICT_SPREAD" and len(pg.bundles) > 1:
            return False  # one node cannot hold a bundle a node
        total = ResourceSet()
        for b in pg.bundles:
            total = total + b.res.total
        if not self._node.can_fit(total):
            return False
        # The node's GPU count is its card count: the cards fit too.
        self._node.acquire(total)
        for b in pg.bundles:
            b.gpu_free = _take_gpus(self._gpu_free, b.res.total.get(GPU))
        pg.state = "created"
        self._cv.notify_all()
        return True

    # --------------------------------------------------------- scheduler

    def _schedule(self) -> None:
        """Place what can run now (lock held): pending placement groups
        first, then queued tasks and actor creations in FIFO order."""
        if self._closing:
            return
        for pg in list(self._pending_pgs):
            if self._try_place_pg(pg):
                self._pending_pgs.remove(pg)
        for task in list(self._queue):
            if task not in self._queue:
                continue
            blocked = False
            for d in task.deps:
                obj = self._objects.get(d)
                if obj is not None and not obj.ready:
                    blocked = True
                elif obj is not None and obj.error is not None:
                    self._queue.remove(task)
                    self._dep_failed(task, obj.error)
                    blocked = True
                    break
            if blocked:
                continue
            if self._try_place(task):
                self._queue.remove(task)

    def _dep_failed(self, task: _Task, error: bytes) -> None:
        for oid in task.returns:
            self._store(oid, error=error)
        if task.kind == "create":
            self._actor_dead(task.actor, "its constructor's argument failed")

    def _infeasible(self, task: _Task, where: str) -> bool:
        """Fail an infeasible task once its grace is spent; True if so."""
        grace = float(self.config.infeasible_grace_s)
        now = time.monotonic()
        if task.infeasible_since is None:
            task.infeasible_since = now
        if grace > 0 and now - task.infeasible_since < grace:
            return False
        req = task.resources.to_dict()
        if task.kind == "create":
            err = TaskError(None, task.name or task.actor.class_name,
                            f"infeasible actor resources {req}")
            self._fail(task, err)
            self._actor_dead(task.actor, "infeasible actor resources")
        else:
            self._fail(task, TaskError(
                None, task.name,
                f"infeasible resource request {req} on {where}"))
        return True

    def _try_place(self, task: _Task) -> bool:
        """Reserve resources, a card and a worker for ``task`` and start
        it; True when it left the queue (started or failed)."""
        req = task.resources
        gpus = req.get(GPU)
        pg_id = getattr(task.strategy, "pg_id", None)
        if pg_id is not None:
            pg = self._pgs.get(pg_id)
            if pg is None or pg.state == "removed":
                self._fail(task, TaskError(
                    None, task.name, f"placement group {pg_id[:8]} was "
                    "removed"))
                if task.kind == "create":
                    self._actor_dead(task.actor, "placement group removed")
                return True
            if pg.state != "created":
                return False
            index = task.strategy.placement_group_bundle_index
            bundles = pg.bundles if index < 0 else pg.bundles[index:index + 1]
            if not bundles:
                self._fail(task, TaskError(
                    None, task.name, f"bundle index {index} out of range"))
                return True
            if not any(b.res.is_feasible(req) for b in bundles):
                return self._infeasible(
                    task, f"placement group bundles {pg.specs}")
            for b in bundles:
                if not b.res.can_fit(req):
                    continue
                taken = _take_gpus(b.gpu_free, gpus)
                if taken is None:
                    continue
                if not self._start(task, taken):
                    b.gpu_free += taken
                    return False
                b.res.acquire(req)
                task.bundle = b
                return True
            return False
        if not self._node.is_feasible(req):
            return self._infeasible(
                task, f"node with {self._node.total.to_dict()}")
        if not self._node.can_fit(req):
            return False
        taken = _take_gpus(self._gpu_free, gpus)
        if taken is None:
            return False
        if not self._start(task, taken):
            self._gpu_free += taken
            return False
        self._node.acquire(req)
        return True

    def _release(self, task: _Task) -> None:
        bundle, task.bundle = task.bundle, None
        if bundle is not None and bundle.pg.state != "removed":
            bundle.res.release(task.resources)
            bundle.gpu_free += task.gpus
        else:
            self._node.release(task.resources)
            self._gpu_free += task.gpus
        task.gpus = []

    def _start(self, task: _Task, taken) -> bool:
        """Bind ``task`` to a worker of its type; False if none can be had
        now (the worker cap is reached)."""
        kind = "gpu" if taken else "cpu"
        visible = ",".join(self._gpu_entries[i] for i in taken)
        worker = None
        if task.kind == "task":
            for w in self._workers.values():
                if w.kind == kind and w.visible == visible and \
                        w.task is None and w.actor is None and \
                        w.state in ("idle", "starting"):
                    worker = w
                    if w.state == "idle":
                        break
        if worker is None:
            if len(self._workers) >= MAX_WORKERS:
                idle = [w for w in self._workers.values()
                        if w.state == "idle"]
                if not idle:
                    return False
                self._retire(idle[0])
            worker = self._spawn(kind, visible)
        task.gpus = taken
        if task.kind == "create":
            worker.actor = task.actor
            task.actor.worker = worker
        else:
            worker.task = task
        if worker.state == "idle":
            self._dispatch(worker)
        return True

    def _dispatch(self, w: _Worker) -> None:
        """Send the worker its task or its actor's constructor (lock held,
        the worker connected)."""
        if w.actor is not None:
            task = w.actor.create
            w.state = "actor"
            msg = ("create", task.tid, task.name, task.fn, task.args_blob,
                   self._hand_args(w, task), task.max_concurrency)
        else:
            task = w.task
            w.state = "busy"
            msg = ("task", task.tid, task.name, task.fn, task.args_blob,
                   self._hand_args(w, task), task.num_returns, task.deadline)
        self._running[task.tid] = task
        self._send(w, msg)

    def _hand_args(self, w: _Worker, task: _Task) -> List[bytes]:
        """The blobs of ``task``'s top-level ref arguments, lending ``w``
        the refs inside them and inside its argument blob."""
        objs = [self._objects[d] for d in task.deps]
        self._borrow(w, task.nested)
        for obj in objs:
            self._borrow(w, obj.nested)
        return [obj.blob for obj in objs]

    def _pump(self, actor: _Actor) -> None:
        """Send an alive actor its queued calls whose arguments are ready,
        in submission order (lock held)."""
        while actor.state == "alive" and actor.queue:
            call = actor.queue[0]
            objs = [self._objects.get(d) for d in call.deps]
            if any(o is not None and not o.ready for o in objs):
                return
            actor.queue.popleft()
            bad = next((o for o in objs if o is not None and
                        o.error is not None), None)
            if bad is not None:
                for oid in call.returns:
                    self._store(oid, error=bad.error)
                continue
            actor.inflight[call.tid] = call
            self._running[call.tid] = call
            self._send(actor.worker, (
                "call", call.tid, call.name, call.method, call.args_blob,
                self._hand_args(actor.worker, call), call.num_returns,
                call.deadline))

    def _send(self, w: _Worker, msg) -> None:
        if w.conn is None or w.state == "dead":
            return
        try:
            with w.send_lock:
                w.conn.send_bytes(dumps(msg))
        except OSError:
            pass  # the reader sees the death and fails the work

    # ----------------------------------------------------------- workers

    def _spawn(self, kind: str, visible: str) -> _Worker:
        wid = new_id()
        env = dict(os.environ)
        env.update({
            "RAY_TPU_TORCH_ADDRESS": self._address,
            "RAY_TPU_TORCH_AUTHKEY": self._authkey.hex(),
            "RAY_TPU_TORCH_WORKER_ID": wid,
            "RAY_TPU_TORCH_WORKER_TYPE": kind,
            "RAY_TPU_TORCH_NODE_ID": self.node_id,
            "CUDA_VISIBLE_DEVICES": visible,
            "PYTHONPATH": self._pythonpath,
        })
        log_path = os.path.join(self.session_dir, f"worker-{wid}.log")
        with open(log_path, "ab") as log:
            proc = subprocess.Popen(
                [sys.executable, "-m", WORKER_MODULE], env=env,
                stdin=subprocess.DEVNULL, stdout=log,
                stderr=subprocess.STDOUT, start_new_session=True)
        w = _Worker(wid, kind, visible, proc, log_path)
        self._workers[wid] = w
        return w

    def _retire(self, w: _Worker) -> None:
        """Stop an idle worker to make room (lock held)."""
        self._send(w, ("exit",))
        w.state = "dead"
        self._workers.pop(w.wid, None)
        self._return_borrows(w)
        threading.Thread(target=_reap, args=(w.proc,), daemon=True).start()

    def _accept_loop(self) -> None:
        while not self._closing:
            try:
                conn = self._listener.accept()
            except Exception:  # a failed handshake, or the listener closed
                continue
            if self._closing:
                conn.close()
                return
            try:
                hello = pickle.loads(conn.recv_bytes())
            except Exception:
                conn.close()
                continue
            with self._lock:
                w = self._workers.get(hello[1])
                if w is None or w.state != "starting":
                    conn.close()
                    continue
                w.conn = conn
                threading.Thread(target=self._read_loop, args=(w,),
                                 daemon=True,
                                 name=f"ray_tpu_torch-worker-{w.wid[:8]}"
                                 ).start()
                if w.actor is not None or w.task is not None:
                    self._dispatch(w)
                else:
                    w.state = "idle"
                    self._schedule()

    def _read_loop(self, w: _Worker) -> None:
        while True:
            try:
                msg = pickle.loads(w.conn.recv_bytes())
            except (EOFError, OSError):
                break
            if msg[0] == "done":
                with self._lock:
                    self._done(w, *msg[1:])
            elif msg[0] == "item":
                with self._lock:
                    self._stream_item(*msg[1:])
            elif msg[0] == "refs":
                with self._lock:
                    for item in msg[1]:
                        if item[0] == "pin":
                            self.escape(item[1])
                        elif item[0] == "drop":
                            self.stream_drop(item[1])
                        else:
                            self._unborrow(w, item[1], item[2])
            elif msg[0] == "req":
                _, rid, op, args = msg
                if op in ("get", "wait_ids", "pg_wait", "stream_next"):
                    threading.Thread(target=self._serve, daemon=True,
                                     args=(w, rid, op, args)).start()
                else:
                    self._serve(w, rid, op, args)
        with self._lock:
            self._worker_died(w)

    def _serve(self, w: _Worker, rid: int, op: str, args) -> None:
        """Answer a worker's request for ``op`` on its behalf."""
        try:
            if op == "submit":
                result = (True, self.submit_packed(*args, borrower=w))
            elif op == "put":
                result = (True, self.put_blob(*args, borrower=w))
            elif op == "get":
                result = (True, self.get_blobs(*args, borrower=w))
            elif op == "stream_next":
                result = (True, self.stream_next(*args, borrower=w))
            else:
                result = (True, getattr(self, op)(*args))
        except Exception as e:  # noqa: BLE001 — raised again in the worker
            result = (False, e)
        try:
            blob = dumps(("reply", rid, *result))
        except Exception as e:  # noqa: BLE001
            blob = dumps(("reply", rid, False, RuntimeError(repr(e))))
        try:
            with w.send_lock:
                w.conn.send_bytes(blob)
        except OSError:
            pass

    def _done(self, w: _Worker, tid: str, ok: bool, payload) -> None:
        task = self._running.pop(tid, None)
        if task is None:
            return
        if task.kind == "create":
            actor = task.actor
            if ok:
                actor.state = "alive"
                self._pump(actor)
            else:
                actor.killed = True
                self._actor_dead(actor, "the constructor failed: "
                                 + pickle.loads(payload).traceback_str)
                w.killed = "its actor's constructor failed"
                self._kill_worker_locked(w)
            return
        if ok:
            for oid, (blob, nested) in zip(task.returns, payload):
                self._store(oid, blob=blob, nested=nested)
        else:
            for oid in task.returns:
                self._store(oid, error=payload)
        task.keep = []
        if task.kind == "call":
            task.actor.inflight.pop(tid, None)
        else:
            self._release(task)
            w.task = None
            if w.state == "busy":
                w.state = "idle"
        self._wake()

    def _wake(self) -> None:
        """Results landed (lock held): send the actors' queued calls whose
        arguments are now ready, and start the queued tasks that can."""
        for actor in list(self._actors.values()):
            if actor.state == "alive" and actor.queue:
                self._pump(actor)
        self._schedule()

    def _log_tail(self, w: _Worker, lines: int = 20) -> str:
        try:
            with open(w.log_path, "rb") as f:
                text = f.read()[-4000:].decode(errors="replace")
            return "\n".join(text.splitlines()[-lines:])
        except OSError:
            return ""

    def _worker_died(self, w: _Worker) -> None:
        """Fail or retry the dead worker's work, free its share (lock
        held)."""
        if w.state == "dead" and w.wid not in self._workers:
            return
        w.state = "dead"
        self._workers.pop(w.wid, None)
        self._return_borrows(w)
        rc = w.proc.poll()
        if rc is None:
            try:
                rc = w.proc.wait(timeout=2.0)
            except subprocess.TimeoutExpired:
                w.proc.kill()
                rc = w.proc.wait()
        if w.conn is not None:
            w.conn.close()
        detail = f"worker pid {w.proc.pid} exited with code {rc}"
        if w.killed:
            detail += f" ({w.killed})"
        else:
            tail = self._log_tail(w)
            if tail:
                detail += f"; its log ends:\n{tail}"
        actor = w.actor
        if actor is not None:
            self._running.pop(actor.create.tid, None)
            if actor.worker is w:
                actor.worker = None
                self._release(actor.create)
                for tid, call in list(actor.inflight.items()):
                    self._running.pop(tid, None)
                    self._fail(call, ActorDiedError(call.name, detail))
                actor.inflight.clear()
                if actor.restarts_left > 0 and not actor.killed:
                    actor.restarts_left -= 1
                    actor.state = "pending"
                    self._queue.insert(0, actor.create)
                elif actor.state != "dead":
                    self._actor_dead(actor, detail)
        elif w.task is not None:
            task, w.task = w.task, None
            self._running.pop(task.tid, None)
            self._release(task)
            if task.retries_left > 0 and not self._closing:
                task.retries_left -= 1
                self._queue.insert(0, task)
            else:
                self._fail(task, WorkerCrashedError(task.name, detail))
        self._wake()
        self._cv.notify_all()

    def _actor_dead(self, actor: _Actor, cause: str) -> None:
        actor.state = "dead"
        actor.death_cause = cause
        actor.create.keep = []
        if self._names.get(actor.name) == actor.aid:
            del self._names[actor.name]
        while actor.queue:
            call = actor.queue.popleft()
            self._fail(call, ActorDiedError(call.name, cause))

    def _kill_worker(self, w: _Worker, why: str) -> None:
        """SIGKILL ``w`` and account for its death before returning."""
        with self._lock:
            w.killed = why
            self._kill_worker_locked(w)

    def _kill_worker_locked(self, w: _Worker) -> None:
        if w.proc.poll() is None:
            w.proc.kill()
        self._worker_died(w)

    def _reap_loop(self) -> None:
        """Catch workers that die before connecting or never connect, and
        let an infeasible task's grace run out without another event."""
        while not self._closing:
            time.sleep(0.1)
            with self._lock:
                if self._closing:
                    return
                now = time.monotonic()
                timeout = WORKER_START_TIMEOUT_S
                for w in list(self._workers.values()):
                    if w.state != "starting":
                        continue
                    if w.proc.poll() is not None:
                        self._worker_died(w)
                    elif now - w.started > timeout:
                        w.killed = f"it did not connect within {timeout} s"
                        self._kill_worker_locked(w)
                if any(t.infeasible_since is not None for t in self._queue):
                    self._schedule()

    # ---------------------------------------------------------- shutdown

    def shutdown(self) -> None:
        with self._lock:
            if self._closing:
                return
            self._closing = True
            workers = list(self._workers.values())
            for w in workers:
                w.killed = "the runtime shut down"
                self._send(w, ("exit",))
        deadline = time.monotonic() + 2.0
        for w in workers:
            try:
                w.proc.wait(timeout=max(0.0, deadline - time.monotonic()))
            except subprocess.TimeoutExpired:
                w.proc.kill()
                w.proc.wait()
        try:  # wake the accept loop so it sees _closing
            socket.create_connection(self._listener.address, 1.0).close()
        except OSError:
            pass
        self._listener.close()
        with self._lock:
            for w in workers:
                if w.conn is not None:
                    w.conn.close()
            self._workers.clear()
            self._cv.notify_all()


def _reap(proc) -> None:
    try:
        proc.wait(timeout=5.0)
    except subprocess.TimeoutExpired:
        proc.kill()
        proc.wait()


def make_session_dir() -> str:
    path = os.path.join(tempfile.gettempdir(), "ray_tpu_torch",
                        f"session-{int(time.time())}-{uuid.uuid4().hex[:8]}")
    os.makedirs(path, exist_ok=True)
    return path

