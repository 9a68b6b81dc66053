"""Checkpointing for the port: atomic and async, in the on-disk format of
``repro.ckpt.checkpoint``, so each package restores the other's checkpoints.

* **Atomic**: write to ``<dir>/.tmp.<step>...`` then ``os.replace`` into
  ``step_<step>`` — a crash mid-write never corrupts the latest checkpoint.
* **Async**: ``save_async`` copies every tensor to host memory before it
  returns (the trainer then updates the tensors in place on the card) and
  writes in a background thread, overlapping I/O with the next steps.

Format: ``arrays.npz`` (one array per leaf, keyed by its ``/``-joined path)
plus ``manifest.json`` with the step and, under ``dtypes``, the true dtype
of each leaf that npz cannot hold: bf16 is stored as its ``uint16`` bits,
as JAX's ``_encode`` writes it, and read back through ``int16`` into
``torch.bfloat16`` (no ``ml_dtypes``).

* **Elastic**: ``restore(..., shardings=)`` places each leaf as a DTensor
  on a ``DeviceMesh``, which may differ from the mesh that saved it (every
  rank reads the file and keeps its own shard).  A DTensor leaf is saved
  whole (``full_tensor``, a collective every rank joins), and only rank 0
  of a process group writes.
"""

from __future__ import annotations

import json
import os
import shutil
import threading
import time

import numpy as np
import torch
import torch.distributed as dist

_SEP = "/"


def _host(leaf) -> tuple[np.ndarray, str | None]:
    """A copy of one leaf on the host, as npz stores it, and the dtype name
    the manifest records for it (None for a dtype npz holds)."""
    if hasattr(leaf, "full_tensor"):            # a DTensor: gather it
        leaf = leaf.full_tensor()
    if isinstance(leaf, torch.Tensor):
        t = leaf.detach().to("cpu", copy=True)
        if t.dtype == torch.bfloat16:
            return t.view(torch.int16).numpy().view(np.uint16), "bfloat16"
        return t.numpy(), None
    return np.array(leaf, copy=True), None


def _flatten(tree) -> dict[str, tuple[np.ndarray, str | None]]:
    flat = {}

    def walk(path, node):
        if isinstance(node, dict):
            for k, v in node.items():
                walk(path + [str(k)], v)
        elif isinstance(node, (list, tuple)):
            for i, v in enumerate(node):
                walk(path + [str(i)], v)
        else:
            flat[_SEP.join(path)] = _host(node)
    walk([], tree)
    return flat


def _unflatten_into(flat: dict, like, device):
    """Tensors in the structure of ``like``, each on ``device`` or, if that
    is None, on the device of its ``like`` leaf (the CPU for a leaf that is
    not a tensor)."""
    def walk(path, node):
        if isinstance(node, dict):
            return {k: walk(path + [str(k)], v) for k, v in node.items()}
        if isinstance(node, (list, tuple)):
            vals = [walk(path + [str(i)], v) for i, v in enumerate(node)]
            return type(node)(vals)
        key = _SEP.join(path)
        if key not in flat:
            raise KeyError(f"checkpoint missing leaf {key!r}")
        dev = device if device is not None else (
            node.device if isinstance(node, torch.Tensor) else "cpu")
        return flat[key].to(dev)
    return walk([], like)


def _decode(arr: np.ndarray, name: str | None) -> torch.Tensor:
    if name is None:
        return torch.from_numpy(np.array(arr, copy=True))
    if name != "bfloat16":
        raise ValueError(f"checkpoint leaf of dtype {name}: the port reads "
                         f"bfloat16 and the dtypes npz holds")
    return torch.from_numpy(arr.view(np.int16).copy()).view(torch.bfloat16)


class CheckpointManager:
    def __init__(self, directory: str, keep: int = 3):
        self.dir = directory
        self.keep = keep
        os.makedirs(directory, exist_ok=True)
        self._thread: threading.Thread | None = None
        self._seq = 0

    # -- save -----------------------------------------------------------------
    def _write(self, step: int, host: dict, extra: dict):
        self._seq += 1
        tmp = os.path.join(self.dir, f".tmp.{step}.{os.getpid()}.{self._seq}")
        final = os.path.join(self.dir, f"step_{step:010d}")
        os.makedirs(tmp, exist_ok=True)
        arrays = {k: arr for k, (arr, _) in host.items()}
        dtypes = {k: name for k, (_, name) in host.items() if name}
        np.savez(os.path.join(tmp, "arrays.npz"), **arrays)
        with open(os.path.join(tmp, "manifest.json"), "w") as f:
            json.dump({"step": step, "time": time.time(),
                       "dtypes": dtypes, **extra}, f)
        if os.path.exists(final):
            shutil.rmtree(final)
        os.replace(tmp, final)
        self._gc()

    def _gc(self):
        steps = self.all_steps()
        for s in steps[:-self.keep] if self.keep else []:
            shutil.rmtree(os.path.join(self.dir, f"step_{s:010d}"),
                          ignore_errors=True)

    def save(self, step: int, tree, extra: dict | None = None,
             blocking: bool = True):
        """Write ``tree`` (nested dicts/lists of tensors or arrays) as
        checkpoint ``step``.  Every leaf is copied to the host before this
        returns, also when the write itself runs in a thread."""
        self.wait()              # never two writers racing on one step
        host = _flatten(tree)
        if dist.is_initialized() and dist.get_rank() != 0:
            return               # rank 0 writes what every rank gathered
        if blocking:
            self._write(step, host, extra or {})
        else:
            self._thread = threading.Thread(
                target=self._write, args=(step, host, extra or {}),
                daemon=True)
            self._thread.start()

    def save_async(self, step: int, tree, extra: dict | None = None):
        self.save(step, tree, extra, blocking=False)

    def wait(self):
        if self._thread is not None:
            self._thread.join()
            self._thread = None

    # -- restore ----------------------------------------------------------------
    def all_steps(self) -> list[int]:
        out = []
        for name in os.listdir(self.dir):
            if name.startswith("step_"):
                out.append(int(name.split("_")[1]))
        return sorted(out)

    def latest_step(self) -> int | None:
        steps = self.all_steps()
        return steps[-1] if steps else None

    def restore(self, like, step: int | None = None, device=None,
                shardings=None):
        """Restore into the structure of ``like``: (tree of tensors,
        manifest).  Each leaf keeps the checkpoint's dtype and lands on
        ``device``, or where its ``like`` leaf lives.  ``shardings``, a
        tree like ``like`` of ``(DeviceMesh, placements)`` pairs, makes
        each leaf a DTensor placed so (the mesh may differ from the one
        that saved: an elastic restart)."""
        step = step if step is not None else self.latest_step()
        if step is None:
            raise FileNotFoundError(f"no checkpoints under {self.dir}")
        path = os.path.join(self.dir, f"step_{step:010d}")
        with open(os.path.join(path, "manifest.json")) as f:
            manifest = json.load(f)
        dtypes = manifest.get("dtypes", {})
        with np.load(os.path.join(path, "arrays.npz")) as z:
            flat = {k: _decode(z[k], dtypes.get(k)) for k in z.files}
        tree = _unflatten_into(flat, like, device)
        if shardings is not None:
            tree = _place(tree, shardings)
        return tree, manifest


def _place(tree, shardings):
    """Each leaf of ``tree`` as a DTensor on its ``(mesh, placements)``
    from ``shardings``; every rank holds the whole leaf, so each keeps its
    own shard and nothing crosses the wire."""
    from torch.distributed.tensor import distribute_tensor
    if isinstance(tree, dict):
        return {k: _place(v, shardings[k]) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return type(tree)(_place(v, s) for v, s in zip(tree, shardings))
    mesh, placements = shardings
    return distribute_tensor(tree, mesh, placements, src_data_rank=None)
