"""ObjectRef: a future for a task's result or a ``put`` value (counterpart
of ``ray_tpu/core/reference.py``).

Every process counts its live refs. In the driver they hold the object in
the driver's object table. A worker tells the driver when it drops its
last ref to an object, with the number of refs to it that it was handed,
and the driver frees the object once no process and no stored value holds
it. A ref that the runtime pickles (inside an argument, a result or a
``put`` value) is counted where it lands: :func:`dumps_with_refs` lists
the refs inside a blob, and the blob holds them while it is stored. A ref
pickled by other code (into the KV, say) pins its object for the
runtime's life.
"""

from __future__ import annotations

import io
import pickle
import threading
import types
from typing import List, Tuple

from . import runtime_context

_collect = threading.local()


def refuse_unimportable(fn) -> None:
    """Raise ``TypeError`` naming a function or class that a worker could
    not import (``__main__``, a local or lambda)."""
    module = getattr(fn, "__module__", None)
    qualname = getattr(fn, "__qualname__", "")
    if module == "__main__" or "<" in qualname:
        raise TypeError(
            f"{module}.{qualname} cannot run in a worker process: remote "
            "functions, actor classes and train loops travel by reference "
            "(pickle), so define them at module level in a module the "
            "workers can import (not in __main__ or inside a function)"
        )


class _ByReference(pickle.Pickler):
    """Pickles functions and classes by reference, as pickle does, and
    refuses by name the first one a worker could not import."""

    def reducer_override(self, obj):
        if isinstance(obj, (types.FunctionType, type)):
            refuse_unimportable(obj)
        return NotImplemented


def dumps_with_refs(value) -> Tuple[bytes, List[str]]:
    """Pickle ``value``; returns the blob and the ids of the refs in it,
    one for each ref that loading the blob makes. A function or class
    inside ``value`` that a worker could not import raises
    :func:`refuse_unimportable`'s ``TypeError``."""
    outer = getattr(_collect, "ids", None)
    _collect.ids = ids = []
    buf = io.BytesIO()
    try:
        _ByReference(buf, pickle.HIGHEST_PROTOCOL).dump(value)
    finally:
        _collect.ids = outer
    return buf.getvalue(), ids


class ObjectRef:
    __slots__ = ("_id", "_rt", "__weakref__")

    def __init__(self, object_id: str):
        self._id = object_id
        self._rt = rt = runtime_context.current_runtime_or_none()
        if rt is not None:
            rt.add_ref(object_id)

    def id(self) -> str:
        """The object's id: hashable, and equal for refs to one object."""
        return self._id

    def hex(self) -> str:
        return self._id

    def __hash__(self):
        return hash(self._id)

    def __eq__(self, other):
        return isinstance(other, ObjectRef) and other._id == self._id

    def __repr__(self):
        return f"ObjectRef({self._id})"

    def __del__(self):
        rt = self._rt
        if rt is not None:
            try:
                rt.release_ref(self._id)
            except Exception:  # interpreter shutdown: nothing left to free
                pass

    def __reduce__(self):
        ids = getattr(_collect, "ids", None)
        if ids is not None:
            ids.append(self._id)
        else:
            rt = runtime_context.current_runtime_or_none()
            if rt is not None:
                rt.escape(self._id)
        return (ObjectRef, (self._id,))
