"""A worker process of the single-node runtime (counterpart of
``ray_tpu/core/worker_main.py``).

Started by the driver as ``python -m ray_tpu_torch.core.worker_main`` with
its address, auth key, worker id and type in the environment. It connects
back, then runs what the driver sends in order, one at a time, on its main
thread: tasks, or the constructor and the method calls of its one actor
(an actor created with ``max_concurrency`` n above 1 runs its calls on a
pool of n threads instead, so up to n of them run at once). A
reader thread takes the driver's messages and the replies to this
process's requests, so a task's background threads (a train rank's
heartbeat) can use the KV while the task runs. :class:`WorkerRuntime`
forwards ``get``, ``put``, ``wait``, the KV and nested submissions to the
driver, and counts the process's refs: when the last ref to an object
goes, it tells the driver how many it was handed, so the driver can free
the object. When the driver goes away the worker exits.

A call submitted under a deadline runs with it installed as the thread's
ambient deadline (``util/overload``) and is refused before it starts if
the deadline has passed. A streaming call (``num_returns="streaming"``)
sends each value its generator yields to the driver as it comes, checking
the deadline between items, and then its item count as its result.
"""

from __future__ import annotations

import inspect
import itertools
import os
import pickle
import queue
import sys
import threading
from collections import deque
from concurrent.futures import ThreadPoolExecutor
from multiprocessing.connection import Client
from typing import Any, Dict, List, Optional

from ..util import overload
from . import runtime_context
from .exceptions import TaskError
from .reference import ObjectRef, dumps_with_refs
from .runtime import (
    PING,
    STREAMING,
    dump_callable,
    dumps,
    pack_args,
    unpack_args,
)


class WorkerRuntime:
    """The runtime seen by code running in a worker process."""

    def __init__(self, conn, worker_id: str, worker_type: str,
                 node_id: str):
        self.conn = conn
        self.worker_id = worker_id
        self.worker_type = worker_type
        self.node_id = node_id
        self._task = threading.local()  # the running call, per thread
        self.current_actor_id: Optional[str] = None
        self._send_lock = threading.Lock()
        self._ids = itertools.count()
        self._replies: Dict[int, list] = {}
        self._fn_cache: Dict[int, Any] = {}
        self._ref_lock = threading.RLock()
        self._live: Dict[str, int] = {}  # object id: live refs here
        self._made: Dict[str, int] = {}  # object id: refs made since
        # ("release", id, made) and ("pin", id) for the driver, in order.
        # A ref's __del__ may run inside ``send``, so it only appends here
        # and the flusher thread sends.
        self._outbox: deque = deque()
        self._outbox_ready = threading.Event()

    @property
    def current_task_id(self) -> Optional[str]:
        return getattr(self._task, "tid", None)

    @current_task_id.setter
    def current_task_id(self, tid: Optional[str]) -> None:
        self._task.tid = tid

    # --------------------------------------------------------- transport

    def send(self, msg) -> None:
        blob = dumps(msg)
        with self._send_lock:
            self.conn.send_bytes(blob)

    def request(self, op: str, *args):
        """Ask the driver to run ``op``; block for its answer."""
        rid = next(self._ids)
        slot = [threading.Event(), None]
        self._replies[rid] = slot
        self.send(("req", rid, op, args))
        slot[0].wait()
        ok, value = slot[1]
        if not ok:
            raise value
        return value

    def deliver(self, rid: int, ok: bool, value) -> None:
        slot = self._replies.pop(rid, None)
        if slot is not None:
            slot[1] = (ok, value)
            slot[0].set()

    def flush_loop(self) -> None:
        while True:
            self._outbox_ready.wait()
            self._outbox_ready.clear()
            batch = []
            while self._outbox:
                batch.append(self._outbox.popleft())
            if batch:
                self.send(("refs", batch))

    # --------------------------------------------------------------- refs

    def add_ref(self, oid: str) -> None:
        with self._ref_lock:
            self._live[oid] = self._live.get(oid, 0) + 1
            self._made[oid] = self._made.get(oid, 0) + 1

    def release_ref(self, oid: str) -> None:
        with self._ref_lock:
            n = self._live.get(oid, 0) - 1
            if n > 0:
                self._live[oid] = n
                return
            self._live.pop(oid, None)
            made = self._made.pop(oid, 0)
        self._outbox.append(("release", oid, made))
        self._outbox_ready.set()

    def escape(self, oid: str) -> None:
        self._outbox.append(("pin", oid))
        self._outbox_ready.set()

    def stream_drop(self, sid: str) -> None:
        # Runs in a generator's __del__: queued like a release.
        self._outbox.append(("drop", sid))
        self._outbox_ready.set()

    # ------------------------------------------------------------ the API

    def ensure_function(self, fn) -> bytes:
        blob = self._fn_cache.get(id(fn))
        if blob is None:
            blob = self._fn_cache[id(fn)] = dump_callable(fn)
        return blob

    def submit(self, spec: Dict[str, Any], args, kwargs) -> list:
        blob, deps, nested = pack_args(args, kwargs)
        ids = self.request("submit", spec, blob, deps, nested)
        if spec["kind"] == "create":
            return ids
        return [ObjectRef(i) for i in ids]

    def get(self, refs, timeout: Optional[float] = None):
        single = isinstance(refs, ObjectRef)
        ref_list = [refs] if single else list(refs)
        # Load every blob before raising: each makes the refs it was lent.
        loaded = [(kind, pickle.loads(blob)) for kind, blob in self.request(
            "get", [r.hex() for r in ref_list], timeout)]
        for kind, value in loaded:
            if kind == "e":
                raise value.as_raisable()
        values = [value for _, value in loaded]
        return values[0] if single else values

    def wait(self, refs, num_returns: int = 1,
             timeout: Optional[float] = None):
        refs = list(refs)
        ready_ids = set(self.request("wait_ids", [r.hex() for r in refs],
                                     num_returns, timeout))
        ready, not_ready = [], []
        for r in refs:
            (ready if r.hex() in ready_ids and len(ready) < num_returns
             else not_ready).append(r)
        return ready, not_ready

    def put(self, value) -> ObjectRef:
        return ObjectRef(self.request("put", *dumps_with_refs(value)))

    def kv_put(self, key: str, value: bytes, overwrite: bool = True) -> bool:
        return self.request("kv_put", key, value, overwrite)

    def kv_get(self, key: str) -> Optional[bytes]:
        return self.request("kv_get", key)

    def kv_del(self, key: str) -> bool:
        return self.request("kv_del", key)

    def kv_keys(self, prefix: str = "") -> List[str]:
        return self.request("kv_keys", prefix)

    def store_usage(self):
        return self.request("store_usage")

    def stream_next(self, sid: str, index: int, timeout: Optional[float]):
        kind, value = self.request("stream_next", sid, index, timeout)
        return kind, (ObjectRef(value) if kind == "item" else value)

    def kill_actor(self, aid: str, no_restart: bool = True) -> None:
        self.request("kill_actor", aid, no_restart)

    def get_named_actor(self, name: str):
        return self.request("get_named_actor", name)

    def cluster_resources(self) -> Dict[str, float]:
        return self.request("cluster_resources")

    def available_resources(self) -> Dict[str, float]:
        return self.request("available_resources")

    def nodes(self):
        return self.request("nodes")

    def pg_create(self, pid, bundles, strategy, name):
        return self.request("pg_create", pid, bundles, strategy, name)

    def pg_wait(self, pid: str, timeout: float) -> bool:
        return self.request("pg_wait", pid, timeout)

    def pg_remove(self, pid: str) -> None:
        return self.request("pg_remove", pid)

    def shutdown(self) -> None:
        raise RuntimeError("shutdown() is the driver's; a worker cannot "
                           "stop the runtime")


class _Executor:
    """Runs the driver's tasks, or its one actor, on the main thread; a
    concurrent actor's calls on ``pool``."""

    def __init__(self, rt: WorkerRuntime):
        self.rt = rt
        self.instance = None
        self.pool: Optional[ThreadPoolExecutor] = None

    def take(self, msg) -> None:
        if msg[0] == "call" and self.pool is not None:
            self.pool.submit(self.run, msg)
        else:
            self.run(msg)

    def run(self, msg) -> None:
        kind, tid, name = msg[0], msg[1], msg[2]
        rt = self.rt
        rt.current_task_id = tid
        deadline = msg[7] if kind != "create" else 0.0
        prev_deadline = overload.set_ambient_deadline(deadline)
        try:
            if deadline:  # an expired call never runs
                overload.check_deadline(name)
            if kind == "call":
                method, blob, deps, num_returns = msg[3:7]
                args, kwargs = unpack_args(blob, _values(deps))
                if method == PING:
                    result = "ok"
                else:
                    result = getattr(self.instance, method)(*args, **kwargs)
            else:
                args, kwargs = unpack_args(msg[4], _values(msg[5]))
                fn = pickle.loads(msg[3])
                if kind == "create":
                    rt.current_actor_id = tid
                    self.instance = fn(*args, **kwargs)
                    if msg[6] > 1:
                        self.pool = ThreadPoolExecutor(
                            msg[6], thread_name_prefix="ray_tpu_torch-call")
                    rt.send(("done", tid, True, []))
                    return
                num_returns = msg[6]
                result = fn(*args, **kwargs)
            if num_returns == STREAMING:
                result = _stream(rt, tid, name, result, deadline)
                num_returns = 1
            if num_returns == 1:
                blobs = [dumps_with_refs(result)]
            else:
                result = list(result)
                if len(result) != num_returns:
                    raise ValueError(
                        f"task returned {len(result)} values, "
                        f"num_returns={num_returns}")
                blobs = [dumps_with_refs(r) for r in result]
            reply = ("done", tid, True, blobs)
        except KeyboardInterrupt:
            raise
        except BaseException as e:  # noqa: BLE001 — shipped to the caller
            reply = ("done", tid, False,
                     dumps(TaskError.from_exception(e, name)))
        finally:
            rt.current_task_id = None
            overload.set_ambient_deadline(prev_deadline)
        rt.send(reply)


def _stream(rt: WorkerRuntime, tid: str, name: str, value,
            deadline: float) -> int:
    """Send each item of a streaming call's result to the driver as it is
    produced; returns the count. Item seams are the call's cancellation
    points: a stream that outlives its deadline stops there."""
    if not (inspect.isgenerator(value) or hasattr(value, "__next__")):
        value = () if value is None else (value,)
    count = 0
    for item in value:
        if deadline:
            overload.check_deadline(name)
        rt.send(("item", tid, *dumps_with_refs(item)))
        count += 1
    return count


def _values(blobs: List[bytes]) -> list:
    return [pickle.loads(b) for b in blobs]


def main() -> None:
    host, port = os.environ["RAY_TPU_TORCH_ADDRESS"].rsplit(":", 1)
    conn = Client((host, int(port)),
                  authkey=bytes.fromhex(os.environ["RAY_TPU_TORCH_AUTHKEY"]))
    wid = os.environ["RAY_TPU_TORCH_WORKER_ID"]
    rt = WorkerRuntime(conn, wid, os.environ["RAY_TPU_TORCH_WORKER_TYPE"],
                       os.environ.get("RAY_TPU_TORCH_NODE_ID", ""))
    runtime_context.set_runtime(rt)
    work: "queue.Queue" = queue.Queue()

    def read():
        while True:
            try:
                msg = pickle.loads(conn.recv_bytes())
            except (EOFError, OSError):
                os._exit(0)  # the driver is gone
            if msg[0] == "reply":
                rt.deliver(*msg[1:])
            elif msg[0] == "exit":
                sys.stdout.flush()
                sys.stderr.flush()
                os._exit(0)
            else:
                work.put(msg)

    rt.send(("hello", wid, os.getpid()))
    threading.Thread(target=read, daemon=True,
                     name="ray_tpu_torch-reader").start()
    threading.Thread(target=rt.flush_loop, daemon=True,
                     name="ray_tpu_torch-refs").start()
    executor = _Executor(rt)
    while True:
        executor.take(work.get())


if __name__ == "__main__":
    main()
