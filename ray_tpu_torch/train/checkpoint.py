"""Checkpoints: directory-based and crash-safe, with a payload of
``torch.save`` files (counterpart of ``ray_tpu/train/checkpoint.py``).

Commit protocol (the crash-safety contract every consumer relies on; the
JAX package's, step for step):

1. ``from_pytree`` writes EVERYTHING — the payload, ``metadata.json``, and
   a ``COMMITTED`` manifest (step, world size, ts, per-file sizes) — into
   a ``.tmp-`` sibling directory, fsyncs it, then atomically renames it
   into place and fsyncs the parent. A crash at ANY point leaves either
   the previous state or a ``.tmp-`` orphan that no restore path will ever
   pick up; it can never poison "latest".
2. ``is_committed`` verifies the manifest and every listed file's size,
   so a torn directory (partial copy, truncated payload file) reads as
   uncommitted — corrupt and uncommitted are the same thing to restore.
3. ``latest_committed(storage_dir)`` scans newest-first and falls back
   past corrupt/uncommitted entries; :class:`CheckpointManager` prune
   never deletes the only committed entry and never deletes a checkpoint
   until a NEWER one has committed (a concurrently-resuming worker may
   still be restoring from it).

The ``checkpoint_io`` fault point (``util/faults.py``) fires at the top of
both save and restore so the whole protocol is testable under injected
I/O failures.

The payload (JAX: orbax) sits under ``pytree/``:

- ``tree.json``: the tree's structure (nested dicts with string keys,
  lists, tuples, ``AdamState``, None), Python ints, floats, bools and
  strings inline, and for every array leaf its global shape and dtype,
  and whether it is a tensor or a numpy array;
- one ``torch.save`` file per array leaf, or under a mesh per saved slice
  of it, read back with ``torch.load(weights_only=True, mmap=True)``;
  so the manifest's size check notices a torn file, and a restore reads
  only the slices it needs;
- ``shards-<rank>.json``: the files each rank wrote, with each slice's
  global offsets and shape.

Leaves keep their dtypes (bf16 stays bf16, numpy's ml_dtypes bfloat16
included). ``as_pytree`` puts the tensors on the card unless it is given
``device="cpu"``; numpy leaves stay numpy.

Under a mesh (``mesh=``, ``logical_axes=``, ``rules=``; the layouts of
``parallel/sharding.py``) each rank holds the local slices of its leaves.
``from_pytree`` has each rank write its own slices, with their global
offsets from ``NamedSharding.coords``; a slice replicated over a mesh axis
is written once, by the rank at coordinate 0 on that axis. The commit is
shared: rank 0 picks the staging name and every rank takes it, every rank
writes its slices, the ranks all-reduce a success flag (so a fault on any
rank makes every rank raise and nothing commits), rank 0 writes the
manifest and renames, and a last all-reduce of rank 0's outcome is the
barrier. The ranks need one filesystem. ``as_pytree`` under a mesh, which
may differ from the saving one, gives each rank its local slices and reads
only the saved slices that overlap them; without a mesh it gives the whole
tree.
"""

from __future__ import annotations

import json
import os
import shutil
import tempfile
import time
import uuid
from typing import Any, Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch
import torch.distributed as dist

from .._device import DeviceLike, resolve_device
from ..parallel.mesh import AXIS_ORDER
from ..parallel.sharding import (
    DEFAULT_RULES,
    NamedSharding,
    Rule,
    entry_axes,
    is_logical_axes,
    named_sharding,
)
from ..util import faults
from ..util.timeline import record_span
from .optim import AdamState

# Commit marker + manifest, written last inside the staging directory so
# the atomic rename is the single commit point.
COMMIT_MANIFEST = "COMMITTED"
_TMP_PREFIX = ".tmp-"
_PAYLOAD = "pytree"
_TREE = "tree.json"


def _fsync_file(path: str) -> None:
    fd = os.open(path, os.O_RDONLY)
    try:
        os.fsync(fd)
    finally:
        os.close(fd)


def _fsync_dir(path: str) -> None:
    try:
        fd = os.open(path, os.O_RDONLY)
    except OSError:
        return  # platform without O_RDONLY dir opens — best effort
    try:
        os.fsync(fd)
    finally:
        os.close(fd)


def _walk_files(root: str) -> List[Tuple[str, int]]:
    """(relpath, size) for every regular file under ``root``."""
    out: List[Tuple[str, int]] = []
    for dirpath, _dirs, files in os.walk(root):
        for fname in files:
            full = os.path.join(dirpath, fname)
            out.append((
                os.path.relpath(full, root).replace(os.sep, "/"),
                os.path.getsize(full),
            ))
    return sorted(out)


# ------------------------------------------------------------ the layout

class _Layout:
    """Which slice of each leaf this rank holds: all of it without a mesh,
    else the slice ``logical_axes`` give it under ``rules``."""

    def __init__(self, mesh=None, rules: Sequence[Rule] = DEFAULT_RULES):
        self.mesh = mesh
        self.rules = rules
        self.rank = 0 if mesh is None else mesh.get_rank()

    def sharding(self, axes) -> Optional[NamedSharding]:
        if self.mesh is None:
            return None
        return named_sharding(self.mesh, axes or (), self.rules)

    def box(self, sharding: Optional[NamedSharding],
            global_shape: Sequence[int]) -> Tuple[List[int], List[int]]:
        """(offsets, shape) of this rank's slice of a global tensor."""
        if sharding is None:
            return [0] * len(global_shape), list(global_shape)
        shape = list(sharding.shard_shape(global_shape))
        return ([sharding.coords(d)[0] * n for d, n in enumerate(shape)],
                shape)

    def tensor_axes(self, axes, ndim: int):
        """``axes`` checked against a tensor leaf of ``ndim`` dims. Under a
        mesh a leaf of one dim or more must name its axes (``(None,) *
        ndim`` when it is replicated): a leaf that a prefix of the axes
        tree leaves out could be sharded, and would be saved as rank 0's
        slice under a global shape that is that slice's."""
        if axes is None:
            if self.mesh is not None and ndim > 0:
                raise ValueError(
                    f"a tensor leaf of {ndim} dims has no logical axes under "
                    f"a mesh; give (None,) * {ndim} for a replicated one")
            return None
        if not is_logical_axes(axes) or len(axes) != ndim:
            raise ValueError(f"logical axes {axes!r} do not match a tensor "
                             f"of {ndim} dims")
        return axes

    def writes(self, sharding: Optional[NamedSharding]) -> bool:
        """True where this rank writes its slice: it is at coordinate 0 on
        every mesh axis the slice is replicated over."""
        if sharding is None:
            return True
        split = {a for e in sharding.spec for a in entry_axes(e)}
        names = self.mesh.mesh_dim_names or ()
        return all(self.mesh.get_local_rank(a) == 0
                   for a in names if a not in split)

    def all_ok(self, ok: bool) -> bool:
        """``ok`` and-ed over every rank of the mesh (True off-mesh)."""
        if self.mesh is None:
            return ok
        flag = torch.tensor([int(ok)], device=self._flag_device())
        for axis in AXIS_ORDER:
            dist.all_reduce(flag, op=dist.ReduceOp.MIN,
                            group=self.mesh.get_group(axis))
        return bool(flag.item())

    def from_rank0(self, value: int) -> int:
        """Rank 0's ``value`` (a non-negative int) on every rank."""
        if self.mesh is None:
            return value
        x = torch.tensor([value if self.rank == 0 else 0],
                         dtype=torch.int64, device=self._flag_device())
        for axis in AXIS_ORDER:
            dist.all_reduce(x, op=dist.ReduceOp.MAX,
                            group=self.mesh.get_group(axis))
        return int(x.item())

    def _flag_device(self) -> torch.device:
        return resolve_device(self.mesh.device_type)


def _axes_child(axes, key):
    """The logical-axes subtree for ``key`` of a container (None for a
    missing entry: the leaves below are whole, which under a mesh only a
    0-d tensor or a numpy or Python leaf may be)."""
    if axes is None:
        return None
    if isinstance(axes, dict):
        return axes.get(key)
    if isinstance(axes, AdamState):
        return getattr(axes, key)
    if isinstance(axes, (list, tuple)) and not is_logical_axes(axes):
        return axes[key]
    raise ValueError(f"logical axes {axes!r} do not match a container")


def _dtype_name(dtype: torch.dtype) -> str:
    return str(dtype).split(".", 1)[1]


def _torch_dtype(name: str) -> torch.dtype:
    dtype = getattr(torch, name, None)
    if not isinstance(dtype, torch.dtype):
        raise ValueError(f"unknown dtype {name!r} in checkpoint")
    return dtype


def _numpy_to_tensor(a: np.ndarray) -> torch.Tensor:
    a = np.array(a, order="C")  # a copy; 0-d stays 0-d
    if a.dtype.name == "bfloat16":  # ml_dtypes: read as its 16 bits
        return torch.from_numpy(a.view(np.uint16)).view(torch.bfloat16)
    return torch.from_numpy(a)


def _tensor_to_numpy(t: torch.Tensor, name: str) -> np.ndarray:
    if name == "bfloat16":
        import ml_dtypes

        return t.view(torch.uint16).numpy().view(ml_dtypes.bfloat16)
    return t.numpy()


def _host_copy(t: torch.Tensor) -> torch.Tensor:
    """A CPU tensor holding exactly ``t``'s elements (torch.save writes a
    view's whole storage)."""
    t = t.detach()
    if t.device.type != "cpu":
        return t.to("cpu").contiguous()
    return t.contiguous().clone()


# ----------------------------------------------------------------- saving

class _Writer:
    """Walks a tree, writing this rank's array slices under ``root`` and
    returning the structure node of every subtree."""

    def __init__(self, root: str, layout: _Layout):
        self.root = root
        self.layout = layout
        self.next_id = 0
        self.files: List[str] = []
        self.shards: Dict[str, List[Dict[str, Any]]] = {}

    def node(self, x, axes) -> Any:
        if isinstance(x, AdamState):
            return {"adam": {f: self.node(getattr(x, f), _axes_child(axes, f))
                             for f in ("count", "mu", "nu")}}
        if isinstance(x, dict):
            for k in x:
                if not isinstance(k, str):
                    raise TypeError(f"checkpoint dict keys must be str, not "
                                    f"{k!r}")
            return {"dict": {k: self.node(v, _axes_child(axes, k))
                             for k, v in x.items()}}
        if isinstance(x, (list, tuple)):
            kind = "list" if isinstance(x, list) else "tuple"
            return {kind: [self.node(v, _axes_child(axes, i))
                           for i, v in enumerate(x)]}
        if x is None or isinstance(x, (bool, int, float, str)):
            return {"value": x}
        if isinstance(x, np.generic):
            x = np.asarray(x)
        if isinstance(x, np.ndarray):
            return self.array(_numpy_to_tensor(x), x.dtype.name, axes)
        if isinstance(x, torch.Tensor):
            return self.array(x, None, axes)
        raise TypeError(f"cannot checkpoint a leaf of type {type(x)}")

    def array(self, t: torch.Tensor, numpy_dtype: Optional[str], axes):
        leaf = f"leaf{self.next_id:05d}"
        self.next_id += 1
        # numpy leaves are whole on every rank
        axes = None if numpy_dtype is not None else (
            self.layout.tensor_axes(axes, t.dim()))
        sharding = self.layout.sharding(axes)
        # Under a mesh ``t`` is this rank's slice; its global shape is the
        # slice's times the pieces of each dim.
        shape = [n * (sharding.coords(d)[1] if sharding is not None else 1)
                 for d, n in enumerate(t.shape)]
        if self.layout.writes(sharding):
            offsets, local = self.layout.box(sharding, shape)
            fname = leaf + "".join(f"_{o}" for o in offsets) + ".pt"
            with open(os.path.join(self.root, fname), "wb") as f:
                torch.save(_host_copy(t), f)
            self.files.append(fname)
            self.shards.setdefault(leaf, []).append(
                {"file": fname, "offsets": offsets, "shape": local})
        node = {"array": leaf, "shape": shape, "dtype": _dtype_name(t.dtype)}
        if numpy_dtype is not None:
            node["numpy"] = numpy_dtype
        return node


def _write_payload(tree, root: str, layout: _Layout, axes) -> None:
    """This rank's files of the payload under ``root``: its array slices,
    its ``shards-<rank>.json``, and on rank 0 ``tree.json``. Under a mesh
    each rank fsyncs its own files (the commit fsyncs them all again)."""
    os.makedirs(root, exist_ok=True)
    writer = _Writer(root, layout)
    structure = writer.node(tree, axes)
    writer.files.append(f"shards-{layout.rank}.json")
    with open(os.path.join(root, writer.files[-1]), "w") as f:
        json.dump(writer.shards, f)
    if layout.rank == 0:
        writer.files.append(_TREE)
        with open(os.path.join(root, _TREE), "w") as f:
            json.dump({"format": 1, "tree": structure}, f)
    if layout.mesh is not None:
        for fname in writer.files:
            _fsync_file(os.path.join(root, fname))


def _commit(tmp: str, path: str, parent: str, step, world_size) -> None:
    """The manifest, the fsyncs and the rename: the JAX package's commit,
    step for step (``ray_tpu/train/checkpoint.py:129-165``)."""
    manifest = {
        "step": int(step) if step is not None else None,
        "world_size": int(world_size) if world_size else None,
        "ts": time.time(),
        "files": {rel: size for rel, size in _walk_files(tmp)},
    }
    with open(os.path.join(tmp, COMMIT_MANIFEST), "w") as f:
        json.dump(manifest, f)
        f.flush()
        os.fsync(f.fileno())
    for rel, _size in _walk_files(tmp):
        if rel != COMMIT_MANIFEST:
            _fsync_file(os.path.join(tmp, rel))
    for dirpath, _dirs, _files in os.walk(tmp):
        _fsync_dir(dirpath)
    # Re-saving over an existing checkpoint keeps the old one until the
    # replacement is fully staged. The aside name does NOT carry the .tmp-
    # prefix on purpose: the moved directory is still a complete COMMITTED
    # checkpoint, and a crash between the two renames must leave it
    # DISCOVERABLE by latest_committed (same manifest step, slightly odd
    # name) — never lost. Success deletes it below.
    replaced = None
    if os.path.exists(path):
        replaced = f"{path}.replaced-{uuid.uuid4().hex[:8]}"
        os.rename(path, replaced)
    try:
        os.rename(tmp, path)  # THE commit point
    except BaseException:
        if replaced:
            os.rename(replaced, path)  # restore the original
        raise
    _fsync_dir(parent)
    if replaced:
        shutil.rmtree(replaced, ignore_errors=True)


# --------------------------------------------------------------- restoring

class _Reader:
    """Rebuilds a tree from its structure, reading each array's slices."""

    def __init__(self, root: str, layout: _Layout, device: torch.device):
        self.root = root
        self.layout = layout
        self.device = device
        self.shards: Dict[str, List[Dict[str, Any]]] = {}
        for fname in sorted(os.listdir(root)):
            if fname.startswith("shards-") and fname.endswith(".json"):
                with open(os.path.join(root, fname)) as f:
                    for leaf, pieces in json.load(f).items():
                        self.shards.setdefault(leaf, []).extend(pieces)

    def node(self, n, axes, target) -> Any:
        if "array" in n:
            return self.array(n, axes, target)
        kind, body = next(iter(n.items()))
        if kind == "adam":
            _check(target is None or isinstance(target, AdamState),
                   "an AdamState", target)
            return AdamState(**{
                f: self.node(body[f], _axes_child(axes, f),
                             None if target is None else getattr(target, f))
                for f in ("count", "mu", "nu")})
        if kind == "dict":
            if target is not None:
                _check(isinstance(target, dict) and set(target) == set(body),
                       f"a dict with keys {sorted(body)}", target)
            return {k: self.node(v, _axes_child(axes, k),
                                 None if target is None else target[k])
                    for k, v in body.items()}
        if kind in ("list", "tuple"):
            if target is not None:
                _check(isinstance(target, (list, tuple))
                       and len(target) == len(body),
                       f"a {kind} of {len(body)}", target)
            out = [self.node(v, _axes_child(axes, i),
                             None if target is None else target[i])
                   for i, v in enumerate(body)]
            return out if kind == "list" else tuple(out)
        if kind == "value":
            if target is not None:
                _check(not isinstance(target, (dict, list, tuple, AdamState,
                                               torch.Tensor, np.ndarray)),
                       f"a scalar {body!r}", target)
            return body
        raise ValueError(f"unreadable checkpoint node {n!r}")

    def array(self, n, axes, target):
        numpy_dtype = n.get("numpy")
        # numpy leaves are whole on every rank
        axes = None if numpy_dtype is not None else (
            self.layout.tensor_axes(axes, len(n["shape"])))
        offsets, shape = self.layout.box(self.layout.sharding(axes),
                                         n["shape"])
        dtype = _torch_dtype(n["dtype"])
        if target is not None:
            have = numpy_dtype or n["dtype"]
            if isinstance(target, (np.ndarray, np.generic)):
                want = target.dtype.name if numpy_dtype else None
            elif isinstance(target, torch.Tensor):
                want = None if numpy_dtype else _dtype_name(target.dtype)
            else:
                want = None
            _check(want == have and tuple(target.shape) == tuple(shape),
                   f"shape {tuple(shape)} and dtype {have} "
                   f"({'numpy' if numpy_dtype else 'tensor'})", target)
        device = torch.device("cpu") if numpy_dtype is not None else (
            self.device)
        out = torch.empty(shape, dtype=dtype, device=device)
        covered = 0
        for piece in self.shards.get(n["array"], ()):
            box = []
            for lo, size, so, ss in zip(offsets, shape, piece["offsets"],
                                        piece["shape"]):
                a, b = max(lo, so), min(lo + size, so + ss)
                if a >= b:
                    break
                box.append((a, b - a, so, lo))
            else:
                src = torch.load(os.path.join(self.root, piece["file"]),
                                 map_location="cpu", weights_only=True,
                                 mmap=True)
                dst = out
                for d, (a, k, so, lo) in enumerate(box):
                    src = src.narrow(d, a - so, k)
                    dst = dst.narrow(d, a - lo, k)
                dst.copy_(src)
                covered += src.numel()
        if covered != out.numel():
            raise ValueError(f"checkpoint {self.root}: the saved slices of "
                             f"{n['array']} cover {covered} of the "
                             f"{out.numel()} elements asked for")
        if numpy_dtype is not None:
            return _tensor_to_numpy(out, numpy_dtype)
        return out


def _check(ok: bool, want: str, target) -> None:
    if not ok:
        desc = (f"shape {tuple(target.shape)} and dtype {target.dtype}"
                if hasattr(target, "shape") else repr(type(target)))
        raise ValueError(f"checkpoint holds {want} where the target holds "
                         f"{desc}")


# ------------------------------------------------------------- Checkpoint

class Checkpoint:
    """An immutable directory of checkpoint data."""

    def __init__(self, path: str):
        self.path = os.path.abspath(path)

    @classmethod
    def from_directory(cls, path: str) -> "Checkpoint":
        return cls(path)

    @classmethod
    def from_pytree(cls, tree: Any, path: str, *,
                    metadata: Optional[Dict] = None,
                    step: Optional[int] = None,
                    world_size: Optional[int] = None,
                    mesh=None, logical_axes: Any = None,
                    rules: Sequence[Rule] = DEFAULT_RULES) -> "Checkpoint":
        """Save a tree (tensors, numpy arrays and Python scalars in dicts,
        lists, tuples and ``AdamState``s) atomically: payload + metadata +
        COMMITTED manifest are staged in a ``.tmp-`` sibling and renamed
        into place in one step. A crash mid-save leaves no visible (and
        no half-committed) checkpoint at ``path``.

        With ``mesh``, every rank of the mesh calls this with its local
        slices: ``logical_axes`` is a tree matching ``tree`` whose leaves
        are logical-axis tuples (all None for a replicated tensor; None
        only for a 0-d tensor or a numpy or Python leaf, which are saved
        whole), and a tensor without axes raises ``ValueError``.
        ``world_size`` then defaults to the mesh's size. A failure on any
        rank raises on every rank and nothing commits."""
        save_t0 = time.time()
        path = os.path.abspath(path)
        parent = os.path.dirname(path) or "."
        layout = _Layout(mesh, rules)
        if not world_size and mesh is not None:
            world_size = mesh.size()
        # Rank 0 names the staging sibling; without a mesh, rank 0 is all.
        tag = layout.from_rank0(uuid.uuid4().int & 0xFFFFFFFF)
        tmp = os.path.join(
            parent, f"{_TMP_PREFIX}{os.path.basename(path)}-{tag:08x}")
        try:
            error: Optional[BaseException] = None
            try:
                # An injected checkpoint_io failure surfaces exactly like a
                # real storage fault at the start of the write window: the
                # staging dir is cleaned up and nothing commits.
                os.makedirs(parent, exist_ok=True)
                delay = faults.fire(faults.CHECKPOINT_IO, op="save",
                                    path=path, rank=layout.rank)
                if delay:
                    time.sleep(delay)
                _write_payload(tree, os.path.join(tmp, _PAYLOAD), layout,
                               logical_axes)
                # Metadata rides INSIDE the atomic commit.
                if metadata and layout.rank == 0:
                    with open(os.path.join(tmp, "metadata.json"), "w") as f:
                        json.dump(metadata, f)
            except Exception as e:  # every rank must reach the vote below
                error = e
            if not layout.all_ok(error is None):
                raise error or RuntimeError(
                    f"checkpoint save of {path} failed on another rank")
            if layout.rank == 0:
                try:
                    _commit(tmp, path, parent, step, world_size)
                except Exception as e:
                    error = e
            if not layout.all_ok(error is None):
                raise error or RuntimeError(
                    f"checkpoint commit of {path} failed on rank 0")
        except BaseException:
            if layout.rank == 0:  # after the commit there is no tmp left
                shutil.rmtree(tmp, ignore_errors=True)
            raise
        # The save's window in the rank's timeline, after a commit only.
        try:
            record_span(f"ckpt_save:{os.path.basename(path)}", save_t0,
                        time.time())
        # A lost span only blanks telemetry, never a commit.
        except Exception:  # noqa: BLE001
            pass
        return cls(path)

    def as_pytree(self, target: Optional[Any] = None, *,
                  device: DeviceLike = None, mesh=None,
                  logical_axes: Any = None,
                  rules: Sequence[Rule] = DEFAULT_RULES) -> Any:
        """Restore the tree: tensors on ``device`` (default: the CUDA
        card, which raises without one; ``"cpu"`` when asked), numpy
        arrays as numpy, ``AdamState`` as ``AdamState``.

        ``target`` (a tree as the caller will hold it) is checked against
        the checkpoint: its structure, and each array's shape and dtype
        (the whole leaf's without a mesh, the local slice's under one);
        a mismatch raises ``ValueError``. With ``mesh`` (``device``
        defaults to its device type) each rank gets the slices that
        ``logical_axes`` give it, whatever mesh saved them, reading only
        the saved slices that overlap them; as in ``from_pytree``, every
        tensor of one dim or more needs its axes there."""
        t0 = time.time()
        try:
            delay = faults.fire(faults.CHECKPOINT_IO, op="restore",
                                path=self.path)
            if delay:
                time.sleep(delay)
            if mesh is not None and device is None:
                device = mesh.device_type
            root = os.path.join(self.path, _PAYLOAD)
            with open(os.path.join(root, _TREE)) as f:
                structure = json.load(f)["tree"]
            reader = _Reader(root, _Layout(mesh, rules),
                             resolve_device(device))
            return reader.node(structure, logical_axes, target)
        finally:
            # The restore's window in the rank's timeline, failed or not.
            try:
                record_span(f"ckpt_restore:{os.path.basename(self.path)}",
                            t0, time.time())
            # A lost span only blanks telemetry, never a restore.
            except Exception:  # noqa: BLE001
                pass

    def metadata(self) -> Dict:
        p = os.path.join(self.path, "metadata.json")
        if os.path.exists(p):
            with open(p) as f:
                return json.load(f)
        return {}

    def manifest(self) -> Dict:
        """The COMMITTED manifest ({} when uncommitted/unreadable)."""
        p = os.path.join(self.path, COMMIT_MANIFEST)
        try:
            with open(p) as f:
                return json.load(f)
        except (OSError, ValueError):
            return {}

    def is_committed(self) -> bool:
        """True when the COMMITTED manifest exists AND every file it lists
        is present with the recorded size — a torn directory (truncated
        payload file, partial copy) reads as uncommitted, so restore falls
        back past it."""
        manifest = self.manifest()
        if not manifest:
            return False
        for rel, size in (manifest.get("files") or {}).items():
            if rel == COMMIT_MANIFEST:
                continue
            full = os.path.join(self.path, rel)
            try:
                if os.path.getsize(full) != int(size):
                    return False
            except OSError:
                return False
        return True

    @property
    def step(self) -> Optional[int]:
        return self.manifest().get("step")

    def to_directory(self, dest: str) -> str:
        shutil.copytree(self.path, dest, dirs_exist_ok=True)
        return dest

    def __repr__(self):
        return f"Checkpoint({self.path})"


def latest_committed(storage_dir: str) -> Optional[Checkpoint]:
    """Newest COMMITTED checkpoint under ``storage_dir`` (by manifest
    step, then mtime), scanning newest-first and falling back past
    corrupt, uncommitted, and ``.tmp-`` staging directories. The restart
    path's source of truth: a crash can strand torn state on disk, but
    never make this return it."""
    try:
        names = os.listdir(storage_dir)
    except OSError:
        return None
    candidates = []
    for name in names:
        if name.startswith(_TMP_PREFIX):
            continue  # an interrupted save's staging orphan
        path = os.path.join(storage_dir, name)
        if not os.path.isdir(path):
            continue
        ckpt = Checkpoint(path)
        manifest = ckpt.manifest()
        step = manifest.get("step")
        try:
            mtime = os.path.getmtime(path)
        except OSError:
            mtime = 0.0
        candidates.append((
            step if isinstance(step, int) else -1, mtime, ckpt
        ))
    candidates.sort(key=lambda c: (c[0], c[1]), reverse=True)
    for _step, _mtime, ckpt in candidates:
        if ckpt.is_committed():
            return ckpt
    return None


class CheckpointManager:
    """Tracks reported checkpoints, retains top-k by score under the
    commit-protocol safety rules: the only committed entry is never
    pruned, and no entry is deleted until a NEWER checkpoint has
    committed."""

    def __init__(self, storage_dir: str, num_to_keep: Optional[int] = None,
                 score_attribute: Optional[str] = None,
                 score_order: str = "max"):
        self.storage_dir = storage_dir
        self.num_to_keep = num_to_keep
        self.score_attribute = score_attribute
        self.score_order = score_order
        self._entries = []  # (score, step, Checkpoint)
        os.makedirs(storage_dir, exist_ok=True)

    def register(self, checkpoint: Checkpoint, metrics: Dict,
                 step: int) -> Checkpoint:
        score = None
        if self.score_attribute and self.score_attribute in metrics:
            score = float(metrics[self.score_attribute])
        self._entries.append((score, step, checkpoint))
        self._prune()
        return checkpoint

    def _prune(self):
        if self.num_to_keep is None or len(self._entries) <= self.num_to_keep:
            return
        committed = [e for e in self._entries if e[2].is_committed()]
        committed_steps = [e[1] for e in committed]
        newest_committed = (max(committed, key=lambda e: e[1])
                            if committed else None)
        best = None
        scored = [e for e in self._entries if e[0] is not None]
        if scored:
            pick = max if self.score_order == "max" else min
            best = pick(scored, key=lambda e: e[0])

        def deletable(entry) -> bool:
            # Safety over budget, in order: (1) the newest committed entry
            # is what a concurrently-resuming worker restores from —
            # deletable only once an even newer checkpoint has COMMITTED
            # (an uncommitted "newer" save never justifies deleting the
            # committed fallback beneath it); (2) the best-scored entry is
            # the Result's checkpoint; (3) any other entry needs a newer
            # committed successor before its directory can go. num_to_keep
            # may be overshot while these protections hold — the next
            # commit rebalances.
            if entry is newest_committed or entry is best:
                return False
            return any(cs > entry[1] for cs in committed_steps)

        def sort_key(e):
            score, step, _ = e
            if score is None:
                return (step, step)  # fall back to recency
            ordered = score if self.score_order == "max" else -score
            # Ties (and score-free runs) evict oldest-step first.
            return (ordered, step)

        evictable = [e for e in sorted(self._entries, key=sort_key)
                     if deletable(e)]
        for entry in evictable:
            if len(self._entries) <= self.num_to_keep:
                break
            self._entries.remove(entry)
            shutil.rmtree(entry[2].path, ignore_errors=True)

    @property
    def latest(self) -> Optional[Checkpoint]:
        """Newest usable checkpoint: committed entries win; an uncommitted
        newest (its save failed or is still in flight) never shadows the
        committed one beneath it."""
        return self.latest_committed or self._newest_any

    @property
    def _newest_any(self) -> Optional[Checkpoint]:
        if not self._entries:
            return None
        return max(self._entries, key=lambda e: e[1])[2]

    @property
    def latest_committed(self) -> Optional[Checkpoint]:
        committed = [e for e in self._entries if e[2].is_committed()]
        if not committed:
            return None
        return max(committed, key=lambda e: e[1])[2]

    @property
    def best(self) -> Optional[Checkpoint]:
        if not self._entries:
            return None
        scored = [e for e in self._entries if e[0] is not None]
        if not scored:
            return self.latest
        pick = max if self.score_order == "max" else min
        return pick(scored, key=lambda e: e[0])[2]


def default_storage_path(name: Optional[str]) -> str:
    base = os.environ.get(
        "RAY_TPU_STORAGE_PATH",
        os.path.join(tempfile.gettempdir(), "ray_tpu_results"),
    )
    run = name or f"run-{int(time.time())}"
    return os.path.join(base, run)
