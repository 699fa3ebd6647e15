"""Checkpoint store with elastic restore, without jax.

Layout:  <dir>/step_000123/
           manifest.json     — tree structure, shapes, dtypes, step, extras
           arrays.npz        — one entry per flattened leaf (host numpy)

The layout, the leaf order and the manifest's ``treedef`` string are the
JAX package's (``repro.checkpoint.store``) for the trees a solve or a
trainer persists — dicts (keys in sorted order), lists, tuples,
``NamedTuple``s (the optimizer's ``OptState``) and ``None`` over array
leaves — so a checkpoint written by either package loads in the other.
Arrays are saved whole (host-gathered), so a run may resume on another
plan.  A save is atomic: it writes a tmp directory, fsyncs the manifest,
then renames.  Saves can run on a host thread (:class:`AsyncSaver`).
"""
from __future__ import annotations

import json
import os
import re
import shutil
import threading

import numpy as np
import torch

__all__ = ["save", "load", "latest_step", "AsyncSaver"]

_MANIFEST = "manifest.json"
_ARRAYS = "arrays.npz"
#: a completed checkpoint directory: step_<digits>, nothing else.  Stray
#: entries (half-renamed tmp dirs, unrelated files) are not checkpoints
_STEP_RE = re.compile(r"^step_(\d+)$")


def _step_entries(path: str) -> list[int]:
    """Step numbers of the well-formed checkpoint dirs under ``path``."""
    out = []
    for n in os.listdir(path):
        m = _STEP_RE.match(n)
        if m and os.path.isdir(os.path.join(path, n)):
            out.append(int(m.group(1)))
    return sorted(out)


def _flatten(tree) -> tuple[list, str, object]:
    """``(leaves, treedef string, rebuild)`` — the leaves in jax's order,
    the string ``str(jax.tree_util.tree_structure(tree))`` gives, and a
    function rebuilding the tree from a list of new leaves."""
    if tree is None:
        return [], "None", lambda it: None
    if isinstance(tree, dict):
        keys = sorted(tree)
        parts = [_flatten(tree[k]) for k in keys]

        def rebuild(it):
            return {k: p[2](it) for k, p in zip(keys, parts)}
        text = "{" + ", ".join(f"{k!r}: {p[1]}"
                               for k, p in zip(keys, parts)) + "}"
    elif isinstance(tree, (list, tuple)):
        parts = [_flatten(v) for v in tree]
        kind = type(tree)
        inner = ", ".join(p[1] for p in parts)
        if hasattr(kind, "_fields"):        # a NamedTuple: jax's CustomNode

            def rebuild(it):
                return kind(*(p[2](it) for p in parts))
            text = f"CustomNode(namedtuple[{kind.__name__}], [{inner}])"
        else:

            def rebuild(it):
                return kind(p[2](it) for p in parts)
            text = (f"[{inner}]" if kind is list
                    else f"({inner},)" if len(parts) == 1 else f"({inner})")
    else:
        return [tree], "*", lambda it: next(it)
    return [leaf for p in parts for leaf in p[0]], text, rebuild


def _host(x) -> np.ndarray:
    if isinstance(x, torch.Tensor):
        return x.detach().cpu().numpy()
    return np.asarray(x)


def save(path: str, step: int, tree, extra: dict | None = None) -> str:
    """Write a checkpoint; atomic via tmp-dir rename."""
    d = os.path.join(path, f"step_{step:09d}")
    tmp = d + ".tmp"
    os.makedirs(tmp, exist_ok=True)
    leaves, treedef, _ = _flatten(tree)
    arrays = {f"leaf_{i}": _host(x) for i, x in enumerate(leaves)}
    np.savez(os.path.join(tmp, _ARRAYS), **arrays)
    manifest = {
        "step": step,
        "treedef": f"PyTreeDef({treedef})",
        "n_leaves": len(leaves),
        "shapes": [list(a.shape) for a in arrays.values()],
        "dtypes": [str(a.dtype) for a in arrays.values()],
        "extra": extra or {},
    }
    with open(os.path.join(tmp, _MANIFEST), "w") as f:
        json.dump(manifest, f)
        # the rename below is the commit point: the manifest must be
        # durable before the directory appears under its final name
        f.flush()
        os.fsync(f.fileno())
    if os.path.exists(d):
        shutil.rmtree(d)
    os.rename(tmp, d)
    return d


def latest_step(path: str) -> int | None:
    if not os.path.isdir(path):
        return None
    steps = _step_entries(path)
    return steps[-1] if steps else None


def _np_dtype(dtype) -> np.dtype:
    if isinstance(dtype, torch.dtype):
        return torch.empty((), dtype=dtype).numpy().dtype
    return np.dtype(dtype)


def load(path: str, step: int, like, device=None, cut=None):
    """Restore into the structure of ``like`` (a tree of anything with
    ``.shape`` and ``.dtype``: numpy arrays, tensors).  Returns ``(tree,
    extra)``: numpy leaves, or tensors on ``device`` when it is given.
    ``cut``: a tree of ``like``'s structure whose leaves are functions of
    an array, each applied to its leaf as it is read (a rank keeps its
    block and only one whole leaf is held at a time)."""
    d = os.path.join(path, f"step_{step:09d}")
    with open(os.path.join(d, _MANIFEST)) as f:
        manifest = json.load(f)
    leaves_like, treedef, rebuild = _flatten(like)
    # the tree structure, not just the leaf count: two trees can flatten
    # to as many leaves, and the wrong one silently permutes arrays
    if manifest.get("treedef") != f"PyTreeDef({treedef})":
        raise ValueError(
            f"checkpoint {d} tree structure does not match the restore "
            f"target:\n  checkpoint: {manifest.get('treedef')}\n"
            f"  target:     PyTreeDef({treedef})")
    if manifest["n_leaves"] != len(leaves_like):
        raise ValueError(
            f"checkpoint {d} has {manifest['n_leaves']} leaves, restore "
            f"target has {len(leaves_like)}")
    cuts = None if cut is None else _flatten(cut)[0]
    new_leaves = []
    with np.load(os.path.join(d, _ARRAYS)) as data:
        for i, ref in enumerate(leaves_like):
            arr = data[f"leaf_{i}"]
            if tuple(arr.shape) != tuple(ref.shape):
                raise ValueError(
                    f"checkpoint {d} leaf {i}: saved shape "
                    f"{tuple(arr.shape)} vs restore-target shape "
                    f"{tuple(ref.shape)}")
            arr = arr.astype(_np_dtype(ref.dtype))
            if cuts is not None:
                arr = cuts[i](arr)
            new_leaves.append(arr if device is None
                              else torch.from_numpy(arr).to(device))
    return rebuild(iter(new_leaves)), manifest["extra"]


class AsyncSaver:
    """Fire-and-forget checkpointing on a host thread; joins on ``wait``
    and keeps at most ``keep`` checkpoints."""

    def __init__(self, path: str, keep: int = 3):
        self.path = path
        self.keep = keep
        self._thread: threading.Thread | None = None

    def submit(self, step: int, tree, extra=None):
        # copy to the host before handing over, so later in-place updates
        # of device tensors cannot reach the save
        leaves, _, rebuild = _flatten(tree)
        host_tree = rebuild(iter([np.array(_host(x)) for x in leaves]))
        self.wait()
        self._thread = threading.Thread(
            target=self._save, args=(step, host_tree, extra), daemon=True)
        self._thread.start()

    def _save(self, step, tree, extra):
        save(self.path, step, tree, extra)
        self._gc()

    def _gc(self):
        steps = _step_entries(self.path)
        for s in steps[:-self.keep]:
            shutil.rmtree(os.path.join(self.path, f"step_{s:09d}"),
                          ignore_errors=True)

    def wait(self):
        if self._thread is not None:
            self._thread.join()
            self._thread = None
