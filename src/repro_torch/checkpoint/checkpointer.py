"""Checkpointing: atomic, per-task, restart-safe (port of
``repro.checkpoint.checkpointer``).

Layout: <dir>/step_<n>/ with one .npy per leaf + manifest.json carrying the
tree's leaf names and dtypes. Writes go to a tmp dir then os.rename (atomic
on one filesystem), so a crash mid-save never corrupts the latest step.
bf16 leaves are stored as their uint16 bits (numpy has no bf16).
``Checkpointer`` adds async save (background thread) and retention.

Trees are nested dicts of tensors; leaves are ordered by sorted key path,
as the reference orders a dict pytree.
"""
from __future__ import annotations

import dataclasses
import json
import os
import re
import shutil
import threading
from typing import Any, List, Optional, Tuple

import numpy as np
import torch

_SAFE = re.compile(r"[^A-Za-z0-9_.-]")


def _flatten(tree: Any, path: str = "") -> List[Tuple[str, Any]]:
    if isinstance(tree, dict):
        return [item for k in sorted(tree)
                for item in _flatten(tree[k], f"{path}[{k!r}]")]
    return [(path, tree)]


def _unflatten(like: Any, leaves: list) -> Any:
    it = iter(leaves)

    def build(t):
        if isinstance(t, dict):
            return {k: build(t[k]) for k in sorted(t)}
        return next(it)
    return build(like)


def _leaf_name(i: int, path: str) -> str:
    return f"{i:04d}__{_SAFE.sub('_', path)[:120]}.npy"


def _to_numpy(leaf) -> Tuple[np.ndarray, str]:
    t = torch.as_tensor(leaf).detach().cpu()
    if t.dtype == torch.bfloat16:
        return t.view(torch.int16).numpy().view(np.uint16), "bfloat16"
    arr = t.numpy()
    return arr, str(arr.dtype)


def save_checkpoint(directory: str, tree: Any, step: int,
                    extra: Optional[dict] = None) -> str:
    """Atomically write ``tree`` as step_<step> under directory."""
    os.makedirs(directory, exist_ok=True)
    final = os.path.join(directory, f"step_{step:010d}")
    tmp = final + ".tmp"
    if os.path.exists(tmp):
        shutil.rmtree(tmp)
    os.makedirs(tmp)
    names, dtypes = [], []
    for i, (path, leaf) in enumerate(_flatten(tree)):
        name = _leaf_name(i, path)
        arr, dtype = _to_numpy(leaf)
        np.save(os.path.join(tmp, name), arr)
        names.append(name)
        dtypes.append(dtype)
    manifest = {"step": step, "leaves": names, "dtypes": dtypes,
                "treedef": [p for p, _ in _flatten(tree)],
                "extra": extra or {}}
    with open(os.path.join(tmp, "manifest.json"), "w") as f:
        json.dump(manifest, f)
    if os.path.exists(final):
        shutil.rmtree(final)
    os.rename(tmp, final)
    return final


def latest_step(directory: str) -> Optional[int]:
    if not os.path.isdir(directory):
        return None
    steps = [int(d.split("_")[1]) for d in os.listdir(directory)
             if d.startswith("step_") and not d.endswith(".tmp")]
    return max(steps) if steps else None


def _resolve(directory: str, step: Optional[int]) -> int:
    if step is None:
        step = latest_step(directory)
        if step is None:
            raise FileNotFoundError(f"no checkpoints in {directory}")
    return step


def load_extra(directory: str,
               step: Optional[int] = None) -> Tuple[dict, int]:
    """Read ONLY the manifest's ``extra`` dict (and the resolved step), no
    array loads. Pool snapshots keep their lane cursors here, and the loader
    reads them before it can build the ``like`` template."""
    step = _resolve(directory, step)
    path = os.path.join(directory, f"step_{step:010d}")
    with open(os.path.join(path, "manifest.json")) as f:
        manifest = json.load(f)
    return manifest.get("extra", {}), step


def load_checkpoint(directory: str, like: Any,
                    step: Optional[int] = None) -> Tuple[Any, int, dict]:
    """Restore into the structure of ``like``: each leaf comes back as a
    tensor with the dtype and device of ``like``'s leaf. Returns (tree,
    step, extra)."""
    step = _resolve(directory, step)
    path = os.path.join(directory, f"step_{step:010d}")
    with open(os.path.join(path, "manifest.json")) as f:
        manifest = json.load(f)
    like_leaves = _flatten(like)
    if len(manifest["leaves"]) != len(like_leaves):
        raise ValueError("checkpoint/like structure mismatch: "
                         f"{len(manifest['leaves'])} vs {len(like_leaves)}")
    loaded = []
    for name, dt, (_, leaf) in zip(manifest["leaves"], manifest["dtypes"],
                                   like_leaves):
        arr = np.load(os.path.join(path, name))
        if dt == "bfloat16":
            t = torch.from_numpy(arr.view(np.int16)).view(torch.bfloat16)
        else:
            t = torch.from_numpy(arr)
        like_t = torch.as_tensor(leaf)
        loaded.append(t.to(device=like_t.device, dtype=like_t.dtype))
    return _unflatten(like, loaded), manifest["step"], manifest.get("extra",
                                                                    {})


@dataclasses.dataclass
class Checkpointer:
    """Async checkpoint manager with retention, one per task lane."""
    directory: str
    keep: int = 3
    _thread: Optional[threading.Thread] = None

    def save(self, tree: Any, step: int, extra: Optional[dict] = None,
             blocking: bool = True):
        # snapshot off the device before the caller's tensors move on
        tree = _unflatten(tree, [torch.as_tensor(x).detach().to(
            "cpu", copy=True) for _, x in _flatten(tree)])
        self.wait()     # a pending save may write the same step
        if blocking:
            save_checkpoint(self.directory, tree, step, extra)
            self._gc()
            return
        self._thread = threading.Thread(
            target=lambda: (save_checkpoint(self.directory, tree, step, extra),
                            self._gc()),
            daemon=True)
        self._thread.start()

    def wait(self):
        if self._thread is not None:
            self._thread.join()
            self._thread = None

    def restore(self, like: Any, step: Optional[int] = None):
        self.wait()
        return load_checkpoint(self.directory, like, step)

    def _gc(self):
        steps = sorted(int(d.split("_")[1]) for d in os.listdir(self.directory)
                       if d.startswith("step_") and not d.endswith(".tmp"))
        for s in steps[:-self.keep]:
            shutil.rmtree(os.path.join(self.directory, f"step_{s:010d}"),
                          ignore_errors=True)
