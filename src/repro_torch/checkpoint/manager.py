"""Fault-tolerant checkpointing: atomic, async, energy-aware.

The PyTorch counterpart of the JAX package's ``checkpoint/manager.py``,
with its on-disk layout:

  * **Atomic**: leaves go to ``step_<n>.tmp/leaf_<i>.npy`` (fsynced),
    then a ``manifest.json`` with a crc32 per leaf and the meta, then a
    ``rename`` to ``step_<n>`` — a crash mid-save never corrupts the
    latest valid checkpoint; restore picks the newest one that
    validates.
  * **Async**: ``save(..., blocking=False)`` copies the leaves to host
    memory first, then writes them on a background thread, so the train
    loop stalls only for that copy.  It is a copy even for a leaf that
    already lies on the host: the optimizers update parameters and
    moments in place, and the next step must not reach the leaves being
    written.
  * **Energy-aware** (the PMT integration): the manifest carries the
    PowerMonitor's cumulative joules, so a restarted run continues its
    energy accounting.

Leaves are ordered as JAX flattens the same tree: dict keys sorted,
dataclasses (``TrainState``: ``params`` then ``opt``; ``OptState``:
``step`` then ``inner``) field by field.  bf16 leaves are saved as
float32 arrays, as ``repro_torch.bridge`` carries them, and cast back
to the like tree's dtype on restore.
"""
from __future__ import annotations

import dataclasses
import json
import os
import threading
import zlib
from typing import Any, Callable, Dict, List, Optional, Tuple

import numpy as np
import torch

from repro_torch.bridge import to_numpy
from repro_torch.tree import (tree_leaves, tree_leaves_with_path,
                              tree_unflatten)


@dataclasses.dataclass(frozen=True)
class CheckpointMeta:
    step: int
    cumulative_joules: float = 0.0
    joules_per_step_ema: float = 0.0
    data_step: int = 0
    extra: Dict[str, Any] = dataclasses.field(default_factory=dict)


def _leaf_path(d: str, i: int) -> str:
    return os.path.join(d, f"leaf_{i:05d}.npy")


def save(directory: str, step: int, tree, meta: CheckpointMeta,
         blocking: bool = True) -> Optional[threading.Thread]:
    """Write one checkpoint.  Returns the writer thread when async."""
    named = tree_leaves_with_path(tree)
    for path, t in named:
        if not isinstance(t, torch.Tensor):
            raise TypeError(f"checkpoint leaf {path!r} is a {type(t)}")
    leaves = [to_numpy(t.detach().to("cpu", copy=True)) for _, t in named]
    structure = [f"{p} {tuple(t.shape)} {t.dtype}" for p, t in named]

    def write():
        tmp = os.path.join(directory, f"step_{step:08d}.tmp")
        final = os.path.join(directory, f"step_{step:08d}")
        os.makedirs(tmp, exist_ok=True)
        checksums = []
        for i, leaf in enumerate(leaves):
            with open(_leaf_path(tmp, i), "wb") as f:
                np.save(f, leaf)
                f.flush()
                os.fsync(f.fileno())
            checksums.append(zlib.crc32(leaf.tobytes()))
        manifest = {
            "step": step,
            "num_leaves": len(leaves),
            "checksums": checksums,
            "treedef": "; ".join(structure),
            "meta": dataclasses.asdict(meta),
        }
        with open(os.path.join(tmp, "manifest.json"), "w") as f:
            json.dump(manifest, f)
            f.flush()
            os.fsync(f.fileno())
        os.replace(tmp, final)            # atomic publish

    if blocking:
        write()
        return None
    t = threading.Thread(target=write, daemon=True)
    t.start()
    return t


def _valid_steps(directory: str) -> List[int]:
    if not os.path.isdir(directory):
        return []
    steps = []
    for name in os.listdir(directory):
        if name.startswith("step_") and not name.endswith(".tmp"):
            if os.path.exists(os.path.join(directory, name,
                                           "manifest.json")):
                steps.append(int(name.split("_")[1]))
    return sorted(steps)


def latest_step(directory: str) -> Optional[int]:
    steps = _valid_steps(directory)
    return steps[-1] if steps else None


def _place_like(like: torch.Tensor) -> Callable[[np.ndarray], torch.Tensor]:
    return lambda a: torch.from_numpy(a).to(device=like.device,
                                            dtype=like.dtype)


def restore(directory: str, like_tree, step: Optional[int] = None,
            shard_fn: Optional[Callable[[np.ndarray, int], Any]] = None
            ) -> Tuple[Any, CheckpointMeta]:
    """Restore the newest (or given) valid checkpoint.

    ``like_tree`` supplies the structure; each leaf comes back as a new
    tensor with the like leaf's dtype and device, or as
    ``shard_fn(leaf_np, leaf_index)`` when that is given.  Corrupt
    checkpoints (checksum mismatch) are skipped, falling back to the
    previous one.
    """
    steps = _valid_steps(directory)
    if step is not None:
        steps = [s for s in steps if s == step]
    if not steps:
        raise FileNotFoundError(f"no valid checkpoint under {directory}")

    likes = tree_leaves(like_tree)
    for s in reversed(steps):
        d = os.path.join(directory, f"step_{s:08d}")
        try:
            with open(os.path.join(d, "manifest.json")) as f:
                manifest = json.load(f)
            if manifest["num_leaves"] != len(likes):
                continue
            leaves = []
            for i in range(manifest["num_leaves"]):
                leaf = np.load(_leaf_path(d, i))
                if zlib.crc32(leaf.tobytes()) != manifest["checksums"][i]:
                    break
                leaves.append(leaf)
            else:
                place = (lambda a, i: shard_fn(a, i)) if shard_fn \
                    else (lambda a, i: _place_like(likes[i])(a))
                meta = CheckpointMeta(**manifest["meta"])
                return tree_unflatten(like_tree, [
                    place(a, i) for i, a in enumerate(leaves)]), meta
        except (OSError, ValueError, KeyError):
            continue
    raise IOError(f"all checkpoints under {directory} failed validation")


class CheckpointManager:
    """Keeps the last ``keep`` checkpoints, saves every ``every`` steps,
    one in-flight async save at a time (back-pressure, not a queue)."""

    def __init__(self, directory: str, every: int = 100, keep: int = 3,
                 async_save: bool = True):
        self.directory = directory
        self.every = every
        self.keep = keep
        self.async_save = async_save
        self._inflight: Optional[threading.Thread] = None
        os.makedirs(directory, exist_ok=True)

    def maybe_save(self, step: int, tree, meta: CheckpointMeta) -> bool:
        if step % self.every:
            return False
        if self._inflight is not None:
            self._inflight.join()       # back-pressure
        self._inflight = save(self.directory, step, tree, meta,
                              blocking=not self.async_save)
        self._gc()
        return True

    def finalize(self):
        if self._inflight is not None:
            self._inflight.join()
            self._inflight = None
        self._gc()   # the last async save published after its gc pass

    def _gc(self):
        steps = _valid_steps(self.directory)
        for s in steps[:-self.keep]:
            d = os.path.join(self.directory, f"step_{s:08d}")
            for name in os.listdir(d):
                os.remove(os.path.join(d, name))
            os.rmdir(d)
