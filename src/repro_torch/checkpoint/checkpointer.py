"""Async, atomic checkpointing of parameter / optimizer trees: the twin of
the reference's ``repro/checkpoint/checkpointer.py``, with its on-disk
layout.

* **Layout**: ``<dir>/step_XXXXXXXXX/manifest.json`` plus one ``.npy``
  per leaf.  Leaves are named by their path in the tree, written as
  ``jax.tree_util.keystr`` writes them (``['params']['embed']``, ``[3]``
  for a list entry, ``.m`` for a named-tuple field).  bfloat16 (and the
  float8 types) are stored as their 16-bit (8-bit) patterns under the
  dtype's name, as the reference stores them: numpy has no bfloat16, and
  no ``ml_dtypes`` is needed.
* **Async**: ``save`` copies every leaf to host memory synchronously (the
  snapshot), then writes the files on a background thread; training
  continues.  One save is in flight at a time; the coordinator, if any,
  is notified (``checkpoint_saved``) when a save is published.
* **Integrity**: the manifest is written last and fsynced, the directory
  renamed into place; a crash mid-save leaves no valid manifest, so
  ``latest_step`` never picks up a torn save.
* **Restore** returns the tree of ``like`` with each leaf as saved (its
  dtype), on the device of ``like``'s leaf.
"""
from __future__ import annotations

import json
import os
import shutil
import threading
from typing import Any, Dict, Optional, Tuple

import numpy as np
import torch

from repro_torch.tree import flatten, unflatten

#: dtypes numpy lacks, stored as their bit patterns under their name
_BIT_DTYPES = {"bfloat16": (torch.bfloat16, np.uint16, torch.int16),
               "float8_e4m3fn": (torch.float8_e4m3fn, np.uint8, torch.uint8),
               "float8_e5m2": (torch.float8_e5m2, np.uint8, torch.uint8)}

Params = Any


def _to_savable(x) -> Tuple[np.ndarray, str]:
    """A leaf as the array written and its dtype's name: a copy, so that
    the write never reads a weight the next step updates in place."""
    if isinstance(x, torch.Tensor):
        t = x.detach().to("cpu", copy=True)
        name = str(t.dtype).removeprefix("torch.")
        if name in _BIT_DTYPES:
            _, np_bits, torch_bits = _BIT_DTYPES[name]
            return t.view(torch_bits).numpy().view(np_bits), name
        return t.numpy(), name
    arr = np.array(x)
    return arr, arr.dtype.name


def _from_saved(arr: np.ndarray, name: str) -> torch.Tensor:
    if name in _BIT_DTYPES:
        dtype, _, torch_bits = _BIT_DTYPES[name]
        return torch.from_numpy(arr).view(torch_bits).view(dtype)
    return torch.from_numpy(arr)


def _read_leaves(path: str) -> Dict[str, torch.Tensor]:
    """Every leaf of the checkpoint directory ``path`` (``step_...``) by
    its path, as CPU tensors of the saved dtypes."""
    with open(os.path.join(path, "manifest.json")) as f:
        manifest = json.load(f)
    return {e["path"]: _from_saved(np.load(os.path.join(path, e["file"])),
                                   e["dtype"])
            for e in manifest["leaves"]}


class Checkpointer:
    def __init__(self, directory: str, coordinator=None):
        self.dir = directory
        self.coordinator = coordinator
        self._thread: Optional[threading.Thread] = None
        os.makedirs(directory, exist_ok=True)

    # ------------------------------------------------------------------ save
    def save(self, step: int, tree: Params, wait: bool = False):
        """Snapshot to host memory synchronously, write files async."""
        self.wait()                                   # one save in flight
        host = [(p, _to_savable(x)) for p, x in flatten(tree)]
        t = threading.Thread(target=self._write, args=(step, host),
                             daemon=True)
        self._thread = t
        t.start()
        if wait:
            self.wait()

    def _write(self, step: int, host_leaves):
        path = os.path.join(self.dir, f"step_{step:09d}")
        tmp = path + ".tmp"
        shutil.rmtree(tmp, ignore_errors=True)
        os.makedirs(tmp, exist_ok=True)
        manifest = {"step": step, "leaves": []}
        for i, (p, (arr, dtype_name)) in enumerate(host_leaves):
            fname = f"leaf_{i:05d}.npy"
            np.save(os.path.join(tmp, fname), arr)
            manifest["leaves"].append(
                {"path": p, "file": fname, "dtype": dtype_name,
                 "shape": list(arr.shape)})
        mpath = os.path.join(tmp, "manifest.json")
        with open(mpath, "w") as f:
            json.dump(manifest, f)
            f.flush()
            os.fsync(f.fileno())
        shutil.rmtree(path, ignore_errors=True)
        os.rename(tmp, path)                          # atomic publish
        if self.coordinator is not None:
            self.coordinator.notify("checkpoint_saved", step=step)

    def wait(self):
        if self._thread is not None:
            self._thread.join()
            self._thread = None

    # --------------------------------------------------------------- restore
    def latest_step(self) -> Optional[int]:
        steps = []
        for name in os.listdir(self.dir):
            full = os.path.join(self.dir, name)
            if name.startswith("step_") and not name.endswith(".tmp") \
                    and os.path.exists(os.path.join(full, "manifest.json")):
                steps.append(int(name.split("_")[1]))
        return max(steps) if steps else None

    def restore(self, step: int, like: Params) -> Params:
        """Restore into the structure of ``like``: each leaf as saved, on
        the device of ``like``'s leaf at its place."""
        saved = _read_leaves(os.path.join(self.dir, f"step_{step:09d}"))
        leaves = [saved[p].to(tmpl.device) if isinstance(tmpl, torch.Tensor)
                  else saved[p] for p, tmpl in flatten(like)]
        return unflatten(like, iter(leaves))
