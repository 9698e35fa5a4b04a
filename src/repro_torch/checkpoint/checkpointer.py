"""Atomic, asynchronous checkpointing of trees of tensors.

Layout (the JAX package's)::

    <dir>/step_<N>/
        manifest.json      {step, leaves: name, file, shape, dtype, crc32}
        <leaf-escaped>.npy one file a leaf

Guarantees the fault-tolerance layer uses:
  * **atomic**: written to ``step_<N>.tmp-<pid>`` then ``os.rename``d, so
    a crash mid-save never corrupts the latest checkpoint;
  * **async**: ``save()`` snapshots to host memory synchronously and
    writes on a background thread (training continues); ``wait()``;
  * **self-describing**: ``restore()`` matches leaves by name against the
    manifest and verifies shapes, so no pickled structure is stored;
  * **integrity**: each leaf carries a crc32 of its bytes; a partial or
    bit-rotted restore fails loudly.

A tree is nested dicts, NamedTuples, lists and tuples of tensors (the
trainer's ``TrainState``: parameters and AdamW state keyed by name); a
leaf's name joins its keys, field names and indices with ``/``. bf16
leaves are stored as a ``uint16`` view with logical dtype ``"bfloat16"``,
as the reference stores ``ml_dtypes`` leaves, and read back through a
torch view.
"""

from __future__ import annotations

import json
import os
import shutil
import threading
import zlib
from typing import Any, List, Optional, Tuple

import numpy as np
import torch

# logical dtypes numpy cannot hold: (name, stored unsigned view, the
# signed view torch reads it through)
_VIEWED = {torch.bfloat16: ("bfloat16", np.uint16, np.int16, torch.int16)}
_BY_NAME = {name: (torch_dt, np_signed) for torch_dt, (name, _, np_signed, _)
            in _VIEWED.items()}


def _escape(path_str: str) -> str:
    return path_str.replace("/", "__")


def _is_namedtuple(x) -> bool:
    return isinstance(x, tuple) and hasattr(x, "_fields")


def _children(node) -> Optional[List[Tuple[str, Any]]]:
    """(key, child) pairs of a container node, None for a leaf."""
    if isinstance(node, dict):
        return [(str(k), v) for k, v in node.items()]
    if _is_namedtuple(node):
        return list(zip(node._fields, node))
    if isinstance(node, (list, tuple)):
        return [(str(i), v) for i, v in enumerate(node)]
    return None


def _leaf_paths(tree, prefix: str = "") -> List[Tuple[str, Any]]:
    """(name, leaf) of every leaf, in the tree's order."""
    kids = _children(tree)
    if kids is None:
        return [(prefix, tree)]
    out = []
    for key, child in kids:
        out += _leaf_paths(child, f"{prefix}/{key}" if prefix else key)
    return out


def _rebuild(like, leaves):
    """``like``'s structure with its leaves taken, in order, from the
    iterator ``leaves``."""
    kids = _children(like)
    if kids is None:
        return next(leaves)
    vals = [_rebuild(child, leaves) for _, child in kids]
    if isinstance(like, dict):
        return dict(zip(like.keys(), vals))
    if _is_namedtuple(like):
        return type(like)(*vals)
    return type(like)(vals)


def _host(leaf) -> Tuple[np.ndarray, str]:
    """A host copy of ``leaf`` (never a view of live memory) and its
    logical dtype name."""
    if isinstance(leaf, torch.Tensor):
        t = leaf.detach().to("cpu", copy=True)
        if t.dtype in _VIEWED:
            name, np_view, _, t_view = _VIEWED[t.dtype]
            return t.view(t_view).numpy().view(np_view), name
        arr = t.numpy()
        return arr, str(arr.dtype)
    arr = np.array(leaf)
    return arr, str(arr.dtype)


class Checkpointer:
    def __init__(self, directory: str, *, keep: int = 3):
        self.dir = directory
        self.keep = keep
        self._thread: Optional[threading.Thread] = None
        os.makedirs(directory, exist_ok=True)

    # ---- save --------------------------------------------------------------
    def save(self, step: int, tree: Any, *, blocking: bool = False) -> None:
        """Snapshot ``tree`` to host memory now (a consistent view, a
        device sync), then write it, on a thread unless ``blocking``."""
        host = [(name,) + _host(leaf) for name, leaf in _leaf_paths(tree)]
        self.wait()
        if blocking:
            self._write(step, host)
        else:
            self._thread = threading.Thread(
                target=self._write, args=(step, host), daemon=True,
                name="checkpoint-write")
            self._thread.start()

    def wait(self) -> None:
        if self._thread is not None:
            self._thread.join()
            self._thread = None

    def _write(self, step: int, host) -> None:
        final = os.path.join(self.dir, f"step_{step:08d}")
        tmp = final + f".tmp-{os.getpid()}"
        os.makedirs(tmp, exist_ok=True)
        manifest = {"step": step, "leaves": []}
        for name, arr, logical_dtype in host:
            fn = _escape(name) + ".npy"
            np.save(os.path.join(tmp, fn), arr)
            manifest["leaves"].append({
                "name": name, "file": fn, "shape": list(arr.shape),
                "dtype": logical_dtype,
                "crc32": zlib.crc32(np.ascontiguousarray(arr).tobytes()),
            })
        with open(os.path.join(tmp, "manifest.json"), "w") as f:
            json.dump(manifest, f)
        if os.path.exists(final):
            shutil.rmtree(final)
        os.rename(tmp, final)
        self._gc()

    def _gc(self) -> None:
        for s in self.all_steps()[:-self.keep]:
            shutil.rmtree(os.path.join(self.dir, f"step_{s:08d}"),
                          ignore_errors=True)

    # ---- restore -----------------------------------------------------------
    def all_steps(self) -> List[int]:
        """Completed checkpoints' steps, ascending (``.tmp-`` directories
        of an interrupted save are not checkpoints)."""
        steps = []
        for d in os.listdir(self.dir):
            if d.startswith("step_") and ".tmp-" not in d:
                try:
                    steps.append(int(d.split("_")[1]))
                except (IndexError, ValueError):
                    continue
        return sorted(steps)

    def latest_step(self) -> Optional[int]:
        steps = self.all_steps()
        return steps[-1] if steps else None

    def restore(self, step: int, like: Any) -> Any:
        """Restore step ``step`` into the structure of ``like``.

        Every leaf is read by name, its crc32 verified (``IOError``) and
        its shape checked against ``like``'s (``ValueError``) before any
        is written. A tensor leaf of ``like`` is then filled IN PLACE
        (cast to its dtype, on its device), so a restore lands in a
        module's own parameters and optimizer state; any other leaf comes
        back as a CPU tensor. Returns the rebuilt tree.
        """
        d = os.path.join(self.dir, f"step_{step:08d}")
        with open(os.path.join(d, "manifest.json")) as f:
            manifest = json.load(f)
        by_name = {leaf["name"]: leaf for leaf in manifest["leaves"]}
        loaded = []
        for name, leaf in _leaf_paths(like):
            meta = by_name[name]
            arr = np.load(os.path.join(d, meta["file"]))
            if zlib.crc32(np.ascontiguousarray(arr).tobytes()) != \
                    meta["crc32"]:
                raise IOError(f"checkpoint leaf {name} failed crc check")
            want_shape = tuple(getattr(leaf, "shape", np.shape(leaf)))
            if tuple(arr.shape) != want_shape:
                raise ValueError(
                    f"{name}: checkpoint shape {arr.shape} != {want_shape}")
            arr = np.ascontiguousarray(arr).reshape(arr.shape)   # keeps 0-d
            if meta["dtype"] in _BY_NAME:
                torch_dt, np_signed = _BY_NAME[meta["dtype"]]
                t = torch.from_numpy(arr.view(np_signed)).view(torch_dt)
            else:
                t = torch.from_numpy(arr)
            loaded.append((leaf, t))
        out = []
        with torch.no_grad():
            for leaf, t in loaded:
                if isinstance(leaf, torch.Tensor):
                    leaf.copy_(t)
                    out.append(leaf)
                else:
                    out.append(t)
        return _rebuild(like, iter(out))

    def restore_latest(self, like: Any):
        step = self.latest_step()
        if step is None:
            return None, None
        return step, self.restore(step, like)
