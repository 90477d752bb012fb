"""Checkpoint save/restore in the JAX package's on-disk format.

  - a checkpoint is a directory ``step_<N>/`` holding one ``.npy`` per
    leaf, named by the leaf's key path joined with ``__`` (the leaves of a
    nested dict in sorted key order, as ``jax.tree`` flattens them), plus
    ``meta.json`` (step, shapes, dtypes, ``sha256[:16]`` of each leaf's
    bytes),
  - writes go to ``step_<N>.tmp/`` and are atomically renamed — a crash
    mid-save never corrupts the latest checkpoint,
  - ``save_async`` copies the tensors to host memory synchronously and
    writes them in a background thread (one outstanding save at a time),
    overlapping the next training steps,
  - ``restore`` loads into the structure of a target tree, each leaf on the
    target leaf's device and in its dtype, verifying every checksum;
    ``shardings`` (a tree of ``distributed.sharding.Sharding``) restores
    elastically onto the current mesh: each rank reads the file and keeps
    its own shard of each leaf.  A DTensor target leaf with no sharding
    given keeps its own layout.
  - a DTensor leaf is saved whole (``full_tensor``, a collective every
    rank takes part in); with a process group running, rank 0 writes.

A checkpoint written by either package restores in the other.  numpy has no
bfloat16, so a bf16 tensor is written as float32 (exactly) and cast back to
the target's dtype on restore.
"""

from __future__ import annotations

import hashlib
import json
import os
import shutil
import threading
import time
from typing import Any, Dict, List, Optional, Tuple

import numpy as np
import torch
import torch.distributed as dist
from torch.distributed.tensor import DTensor, distribute_tensor

from ..models.params import tree_paths, tree_unflatten

__all__ = ["CheckpointManager"]

Tree = Any
_SEP = "__"


def _to_numpy(leaf: Any) -> np.ndarray:
    if isinstance(leaf, torch.Tensor):
        t = leaf.detach()
        if isinstance(t, DTensor):
            t = t.full_tensor()
        if t.dtype == torch.bfloat16:
            t = t.float()
        return t.cpu().numpy()
    return np.asarray(leaf)


def _flatten(tree: Tree) -> List[Tuple[str, Any]]:
    return [(_SEP.join(str(k) for k in path), leaf) for path, leaf in tree_paths(tree)]


class CheckpointManager:
    def __init__(self, directory: str, *, keep: int = 3):
        self.directory = directory
        self.keep = keep
        os.makedirs(directory, exist_ok=True)
        self._thread: Optional[threading.Thread] = None
        # the last save: its step, bytes, and the seconds of its host copy
        # and of its write (set when the write ends)
        self.last_save: Dict[str, Any] = {}

    # ---- save ----------------------------------------------------------------
    def save(self, step: int, tree: Tree, *, blocking: bool = True) -> str:
        """Snapshot to host, then write (optionally in the background)."""
        t0 = time.perf_counter()
        host = [(name, _to_numpy(leaf)) for name, leaf in _flatten(tree)]
        self.last_save = {"step": step, "bytes": sum(a.nbytes for _, a in host),
                          "snapshot_s": time.perf_counter() - t0}
        if dist.is_initialized() and dist.get_rank() != 0:
            return self._path(step)
        if blocking:
            return self._write(step, host)
        self.wait()  # one outstanding async save at a time
        self._thread = threading.Thread(target=self._write, args=(step, host),
                                        daemon=True)
        self._thread.start()
        return self._path(step)

    def save_async(self, step: int, tree: Tree) -> str:
        return self.save(step, tree, blocking=False)

    def wait(self) -> None:
        if self._thread is not None:
            self._thread.join()
            self._thread = None

    def _path(self, step: int) -> str:
        return os.path.join(self.directory, f"step_{step:010d}")

    def _write(self, step: int, host: List[Tuple[str, np.ndarray]]) -> str:
        t0 = time.perf_counter()
        final = self._path(step)
        tmp = final + ".tmp"
        if os.path.exists(tmp):
            shutil.rmtree(tmp)
        os.makedirs(tmp)
        meta: Dict[str, Any] = {"step": step, "leaves": []}
        for name, arr in host:
            fname = f"{name}.npy"
            np.save(os.path.join(tmp, fname), arr)
            meta["leaves"].append({
                "name": name,
                "file": fname,
                "shape": list(arr.shape),
                "dtype": str(arr.dtype),
                "sha256": hashlib.sha256(arr.tobytes()).hexdigest()[:16],
            })
        meta["treedef"] = "nested dict; leaves in sorted key order"
        with open(os.path.join(tmp, "meta.json"), "w") as f:
            json.dump(meta, f, indent=1)
        if os.path.exists(final):
            shutil.rmtree(final)
        os.rename(tmp, final)  # atomic publish
        self._gc()
        self.last_save["write_s"] = time.perf_counter() - t0
        return final

    def _gc(self) -> None:
        steps = self.all_steps()
        for s in steps[: -self.keep]:
            shutil.rmtree(self._path(s), ignore_errors=True)

    # ---- restore ---------------------------------------------------------------
    def all_steps(self) -> List[int]:
        out = []
        for d in os.listdir(self.directory):
            if d.startswith("step_") and not d.endswith(".tmp"):
                out.append(int(d[len("step_"):]))
        return sorted(out)

    def latest_step(self) -> Optional[int]:
        steps = self.all_steps()
        return steps[-1] if steps else None

    def restore(self, step: int, target: Tree, shardings: Optional[Tree] = None, *,
                verify: bool = True) -> Tree:
        """Restore into the structure of ``target``: each leaf a tensor on
        the target leaf's device, in its dtype.  ``shardings`` (the same
        structure) lays each leaf out as a DTensor on its mesh."""
        path = self._path(step)
        with open(os.path.join(path, "meta.json")) as f:
            meta = json.load(f)
        by_name = {leaf["name"]: leaf for leaf in meta["leaves"]}
        paths = tree_paths(target)
        flat_shard = ([s for _, s in tree_paths(shardings)] if shardings is not None
                      else [None] * len(paths))
        if len(flat_shard) != len(paths):
            raise ValueError(f"{len(flat_shard)} shardings for {len(paths)} leaves")
        out = []
        for (key_path, tgt), shd in zip(paths, flat_shard):
            name = _SEP.join(str(k) for k in key_path)
            info = by_name.get(name)
            if info is None:
                raise KeyError(f"checkpoint {path} is missing leaf {name!r}")
            arr = np.load(os.path.join(path, info["file"]))
            if verify:
                digest = hashlib.sha256(arr.tobytes()).hexdigest()[:16]
                if digest != info["sha256"]:
                    raise IOError(f"checksum mismatch for {name} in {path}")
            if tuple(arr.shape) != tuple(tgt.shape):
                raise ValueError(f"shape mismatch for {name}: ckpt {arr.shape} vs "
                                 f"target {tuple(tgt.shape)}")
            leaf = torch.from_numpy(arr).to(device=tgt.device, dtype=tgt.dtype)
            if shd is not None:
                mesh, placements = shd.mesh, shd.placements
            elif isinstance(tgt, DTensor):
                mesh, placements = tgt.device_mesh, tgt.placements
            else:
                out.append(leaf)
                continue
            out.append(distribute_tensor(leaf, mesh, placements, src_data_rank=None))
        return tree_unflatten(target, out)
