"""Exception types surfaced by the public API (counterpart of
``ray_tpu/core/exceptions.py``, with its names and messages).

A task's exception travels to the caller pickled with the standard
library's ``pickle``; an exception that does not pickle keeps only its
traceback text.
"""

from __future__ import annotations

import pickle
import traceback as _tb


class RayTpuError(Exception):
    """Base class for all framework errors."""


class TaskError(RayTpuError):
    """Wraps an exception raised inside a task or actor method. Stored as
    the task's result object and re-raised on ``get``; any task consuming
    this object fails too."""

    def __init__(self, cause: BaseException | None, task_name: str,
                 tb_str: str = ""):
        self.cause = cause
        self.task_name = task_name
        self.traceback_str = tb_str
        super().__init__(f"Task '{task_name}' failed:\n{tb_str}")

    @classmethod
    def from_exception(cls, exc: BaseException,
                       task_name: str) -> "TaskError":
        tb_str = "".join(_tb.format_exception(type(exc), exc,
                                              exc.__traceback__))
        try:
            pickle.loads(pickle.dumps(exc))
            cause = exc
        except Exception:
            cause = None  # unpicklable user exception: keep only the text
        return cls(cause, task_name, tb_str)

    def as_raisable(self) -> BaseException:
        if self.cause is not None:
            # Chain so the user sees both the remote traceback and local get.
            self.cause.__cause__ = TaskError(None, self.task_name,
                                             self.traceback_str)
            return self.cause
        return self

    def __reduce__(self):
        return (
            _reconstruct_task_error,
            (type(self), self.cause, self.task_name, self.traceback_str),
        )


def _reconstruct_task_error(cls, cause, task_name, tb_str):
    err = cls.__new__(cls)
    TaskError.__init__(err, cause, task_name, tb_str)
    return err


class WorkerCrashedError(TaskError):
    """The worker process executing the task died."""

    def __init__(self, task_name: str, detail: str = ""):
        TaskError.__init__(self, None, task_name, f"worker crashed: {detail}")


class ActorDiedError(TaskError):
    """The actor owning this method call died."""

    def __init__(self, task_name: str = "", detail: str = ""):
        TaskError.__init__(self, None, task_name, f"actor died: {detail}")


class GetTimeoutError(RayTpuError, TimeoutError):
    pass


class DeadlineExceededError(RayTpuError, TimeoutError):
    """The request's end-to-end deadline budget expired. Raised on the
    worker BEFORE execution when an expired task arrives (the request
    never occupies the card) and cooperatively DURING execution at
    cancellation points (``util/overload.check_deadline``, streamed-item
    seams). A ``TimeoutError`` so generic timeout handling applies."""


class OverloadedError(RayTpuError):
    """The request was shed by overload control before executing: the
    proxy's admission gate, a replica's adaptive concurrency limit, or
    a router with every replica breaker open. ``retry_after_s`` is the
    backpressure hint ingresses surface as ``Retry-After``."""

    def __init__(self, message: str = "overloaded",
                 retry_after_s: float = 1.0):
        self.retry_after_s = float(retry_after_s)
        super().__init__(message)

    def __reduce__(self):
        # Default Exception reduce replays __init__(*args) and would
        # drop retry_after_s; rebuild explicitly (sheds cross process
        # boundaries: replica -> handle -> ingress).
        return (OverloadedError, (str(self), self.retry_after_s))


class RuntimeNotInitializedError(RayTpuError):
    def __init__(self):
        super().__init__(
            "ray_tpu has not been initialized; call ray_tpu.init() first."
        )
