"""Atomic, async checkpointing of nested dicts of tensors.

Layout (the reference's):  <dir>/step_<N>/
            manifest.json      — step, and each flat key's file, shape, dtype
            <flat-key>.npy     — one array per leaf (full arrays on the host)

Flat keys join the path of dict keys and list indices with ``::`` (dict
keys in sorted order, as JAX flattens them), so a port's tree and the
reference's of the same structure give the same files and manifest.  Leaves
are torch tensors or numpy arrays; a bf16 tensor is stored widened to
float32, which holds it exactly (numpy has no bf16).

Commit protocol: arrays are written into ``step_<N>.tmp`` and the directory
is renamed after the manifest is fsync'd — a crash mid-save never corrupts
the latest complete checkpoint.  ``AsyncCheckpointer`` copies to the host
on the caller's thread and writes the files on a worker thread, off the
training critical path.  Three checkpoints are kept.

A DTensor leaf is stored whole: every rank gathers it (so every rank of
its mesh calls ``save``) and, where a process group exists, rank 0 alone
writes.  ``restore`` places a leaf as ``like``'s DTensor is placed, or by
the ``shardings`` it is given, whatever mesh the checkpoint came from.
"""

from __future__ import annotations

import json
import os
import shutil
import threading

import numpy as np
import torch
import torch.distributed as dist
from torch.distributed.tensor import DTensor, distribute_tensor

SEP = "::"


def _flatten(tree, path=()) -> dict:
    if isinstance(tree, dict):
        items = sorted(tree.items())
    elif isinstance(tree, (list, tuple)):
        items = enumerate(tree)
    else:
        return {SEP.join(map(str, path)): tree}
    flat = {}
    for key, child in items:
        flat.update(_flatten(child, (*path, key)))
    return flat


def _host(leaf) -> np.ndarray:
    """A leaf as a numpy array on the host, sharing no memory with it."""
    if isinstance(leaf, torch.Tensor):
        leaf = leaf.detach()
        if isinstance(leaf, DTensor):
            leaf = leaf.full_tensor()
        if leaf.dtype == torch.bfloat16:
            leaf = leaf.float()
        return leaf.to("cpu", copy=True).numpy()
    return np.array(leaf)


def _writes() -> bool:
    """Whether this process writes checkpoint files: rank 0 of a process
    group, or a process without one."""
    return not dist.is_initialized() or dist.get_rank() == 0


def save(tree, directory: str, step: int) -> str:
    """Synchronous atomic checkpoint.  Returns the committed path."""
    final = os.path.join(directory, f"step_{step:08d}")
    if not _writes():
        for leaf in _flatten(tree).values():
            _host(leaf)  # take part in gathering each DTensor
        return final
    tmp = final + ".tmp"
    if os.path.exists(tmp):
        shutil.rmtree(tmp)
    os.makedirs(tmp, exist_ok=True)
    manifest = {"step": step, "keys": {}}
    for key, leaf in _flatten(tree).items():
        arr = _host(leaf)
        fname = key.replace("/", "_") + ".npy"
        np.save(os.path.join(tmp, fname), arr)
        manifest["keys"][key] = {
            "file": fname, "shape": list(arr.shape), "dtype": str(arr.dtype)
        }
    with open(os.path.join(tmp, "manifest.json"), "w") as f:
        json.dump(manifest, f)
        f.flush()
        os.fsync(f.fileno())
    if os.path.exists(final):
        shutil.rmtree(final)
    os.rename(tmp, final)
    _gc_old(directory, keep=3)
    return final


class AsyncCheckpointer:
    """Copy to the host on the caller's thread; file I/O on a worker."""

    def __init__(self, directory: str):
        self.directory = directory
        self._thread: threading.Thread | None = None

    def save(self, tree, step: int):
        self.wait()  # one in-flight save at a time
        host_tree = _unflatten_like(tree, {k: _host(v) for k, v in _flatten(tree).items()})
        if not _writes():
            return
        self._thread = threading.Thread(
            target=save, args=(host_tree, self.directory, step), daemon=True
        )
        self._thread.start()

    def wait(self):
        if self._thread is not None:
            self._thread.join()
            self._thread = None


def latest_step(directory: str) -> int | None:
    if not os.path.isdir(directory):
        return None
    steps = []
    for name in os.listdir(directory):
        if name.startswith("step_") and not name.endswith(".tmp"):
            if os.path.exists(os.path.join(directory, name, "manifest.json")):
                steps.append(int(name.split("_")[1]))
    return max(steps) if steps else None


def restore(directory: str, step: int, like, device=None, shardings=None):
    """Restore into the structure of ``like`` (nested dicts and lists of
    tensors or numpy arrays).  Each leaf lands in the dtype of ``like``'s
    leaf and, for a tensor, on its device (or on ``device`` when given); a
    leaf named in ``shardings`` (flat key → ``(mesh, placements)``) becomes
    a DTensor so placed, and one whose ``like`` is a DTensor is placed as
    that is.  Saved keys ``like`` lacks are skipped (restoring a sub-tree,
    such as the parameters only); keys missing from the checkpoint keep
    ``like``'s value."""
    path = os.path.join(directory, f"step_{step:08d}")
    with open(os.path.join(path, "manifest.json")) as f:
        manifest = json.load(f)

    flat_like = _flatten(like)
    shardings = dict(shardings or {})
    out = {}
    for key, meta in manifest["keys"].items():
        if key not in flat_like:
            continue
        arr = np.load(os.path.join(path, meta["file"]))
        want = flat_like[key]
        if isinstance(want, DTensor) and key not in shardings:
            shardings[key] = (want.device_mesh, want.placements)
        if isinstance(want, torch.Tensor):
            t = torch.from_numpy(arr).to(dtype=want.dtype)
            if key in shardings:
                mesh, placements = shardings[key]
                out[key] = distribute_tensor(t.to(mesh.device_type), mesh, placements)
            else:
                out[key] = t.to(device=want.device if device is None else device)
        else:
            out[key] = arr.astype(np.asarray(want).dtype)
    return _unflatten_like(like, {**flat_like, **out})


def _unflatten_like(like, flat: dict, path=()):
    if isinstance(like, dict):
        return {k: _unflatten_like(v, flat, (*path, k)) for k, v in like.items()}
    if isinstance(like, (list, tuple)):
        return type(like)(_unflatten_like(v, flat, (*path, i)) for i, v in enumerate(like))
    return flat[SEP.join(map(str, path))]


def _gc_old(directory: str, keep: int):
    steps = sorted(
        n for n in os.listdir(directory)
        if n.startswith("step_") and not n.endswith(".tmp")
    )
    for name in steps[:-keep]:
        shutil.rmtree(os.path.join(directory, name), ignore_errors=True)
