"""Checkpoints (port of ``repro.training.checkpoint``): flat ``.npz``
archives keyed by the reference's tree paths.

A tree is a nested dict of numpy arrays; its leaves are stored under
their paths joined by ``/``, beside
``__meta__``, a JSON string holding the step.  Writes are atomic (a
temporary file, then ``os.replace``).  An archive the port writes from
:func:`repro_torch.training.train_loop.checkpoint_tree` loads in the
reference's ``restore``, and the reference's in :func:`restore` here; the
interop maps (:mod:`repro_torch.interop`) take the trees to and from the
port's modules.
"""

from __future__ import annotations

import json
import os
import re
import tempfile
from typing import Any

import numpy as np


def _flatten(tree, prefix: str = "") -> dict[str, np.ndarray]:
    flat = {}
    for key in sorted(tree):
        sub = tree[key]
        path = f"{prefix}/{key}" if prefix else str(key)
        if isinstance(sub, dict):
            flat.update(_flatten(sub, path))
        else:
            flat[path] = np.asarray(sub)
    return flat


def _set_path(tree: dict, parts: list[str], value) -> None:
    cur = tree
    for part in parts[:-1]:
        cur = cur.setdefault(part, {})
    cur[parts[-1]] = value


def save(path: str, tree: Any, step: int | None = None) -> str:
    """Atomically write ``tree`` to ``path`` (.npz)."""
    os.makedirs(os.path.dirname(path) or ".", exist_ok=True)
    flat = _flatten(tree)
    fd, tmp = tempfile.mkstemp(dir=os.path.dirname(path) or ".", suffix=".tmp")
    os.close(fd)
    try:
        np.savez(tmp, __meta__=json.dumps({"step": step}), **flat)
        os.replace(tmp + ".npz" if os.path.exists(tmp + ".npz") else tmp, path)
    finally:
        for t in (tmp, tmp + ".npz"):
            if os.path.exists(t):
                os.remove(t)
    return path


def restore(path: str) -> tuple[dict, int | None]:
    """Load a checkpoint into a nested dict of numpy arrays.  Returns
    (tree, step)."""
    with np.load(path, allow_pickle=False) as z:
        meta = json.loads(str(z["__meta__"])) if "__meta__" in z else {}
        tree: dict = {}
        for key in z.files:
            if key == "__meta__":
                continue
            _set_path(tree, key.split("/"), z[key])
    return tree, meta.get("step")


def latest(ckpt_dir: str, prefix: str = "ckpt_") -> str | None:
    """The archive of the highest step in ``ckpt_dir``, or None."""
    if not os.path.isdir(ckpt_dir):
        return None
    best, best_step = None, -1
    for f in os.listdir(ckpt_dir):
        m = re.fullmatch(rf"{re.escape(prefix)}(\d+)\.npz", f)
        if m and int(m.group(1)) > best_step:
            best, best_step = os.path.join(ckpt_dir, f), int(m.group(1))
    return best


def save_rotating(
    ckpt_dir: str, tree: Any, step: int, keep: int = 3, prefix: str = "ckpt_"
) -> str:
    """Save ``<prefix><step:08d>.npz`` and keep only the newest ``keep``."""
    path = os.path.join(ckpt_dir, f"{prefix}{step:08d}.npz")
    save(path, tree, step)
    stale = sorted(
        f
        for f in os.listdir(ckpt_dir)
        if re.fullmatch(rf"{re.escape(prefix)}\d+\.npz", f)
    )[:-keep]
    for f in stale:
        os.remove(os.path.join(ckpt_dir, f))
    return path
