"""Checkpointing with atomic commit (fault-tolerance substrate).

A port of ``repro.train.checkpoint`` on the same on-disk format, so a
checkpoint written by either package restores in the other::

    <dir>/step_000123/
        MANIFEST.json     # per leaf: key path, file, shape, dtype
        leaf_00000.npy    # raw buffers (np.save, no pickle)
        ...
        COMMITTED         # written last — a checkpoint without it is torn

Leaves are named and ordered as ``jax.tree_util.keystr`` over
``tree_flatten_with_path`` names them (:mod:`repro_torch.train.tree`).
Writes go to ``step_N.tmp`` and are atomically renamed, so a worker dying
mid-save can never corrupt the latest checkpoint (restart scans for the
newest *committed* step). Leaves are gathered to host memory; restore
puts each on the device and in the type of its leaf in the target tree.
bfloat16 leaves are stored as the reference stores them (2-byte void
records, dtype ``"bfloat16"`` in the manifest).
"""

from __future__ import annotations

import json
import os
import shutil
from typing import Any, List, Optional

import numpy as np
import torch

from repro_torch.distributed.sharding import distribute
from repro_torch.train.tree import flatten_with_path, unflatten


def _to_numpy(leaf: Any) -> np.ndarray:
    if not isinstance(leaf, torch.Tensor):
        return np.asarray(leaf)
    t = leaf.detach().cpu()
    if t.dtype == torch.bfloat16:
        return t.view(torch.int16).numpy().view(np.dtype("V2"))
    return t.numpy()


def _to_tensor(arr: np.ndarray, dtype_name: str, like: Any) -> torch.Tensor:
    if dtype_name == "bfloat16":
        t = torch.from_numpy(np.ascontiguousarray(arr).view(np.int16)).view(torch.bfloat16)
    else:
        t = torch.from_numpy(np.array(arr))
    if isinstance(like, torch.Tensor):
        return t.to(like.device, like.dtype)
    return t


class CheckpointManager:
    def __init__(self, directory: str, keep: int = 3) -> None:
        self.directory = directory
        self.keep = keep
        os.makedirs(directory, exist_ok=True)

    # -- save -------------------------------------------------------------------
    def save(self, step: int, tree: Any) -> str:
        final = os.path.join(self.directory, f"step_{step:08d}")
        tmp = final + ".tmp"
        if os.path.exists(tmp):
            shutil.rmtree(tmp)
        os.makedirs(tmp)
        manifest = {"step": step, "leaves": []}
        for i, (name, leaf) in enumerate(flatten_with_path(tree)):
            arr = _to_numpy(leaf)
            dtype = "bfloat16" if getattr(leaf, "dtype", None) == torch.bfloat16 else str(arr.dtype)
            fname = f"leaf_{i:05d}.npy"
            np.save(os.path.join(tmp, fname), arr, allow_pickle=False)
            manifest["leaves"].append(
                {"key": name, "file": fname, "shape": list(arr.shape), "dtype": dtype}
            )
        with open(os.path.join(tmp, "MANIFEST.json"), "w") as f:
            json.dump(manifest, f)
        with open(os.path.join(tmp, "COMMITTED"), "w") as f:
            f.write("ok")
        if os.path.exists(final):
            shutil.rmtree(final)
        os.rename(tmp, final)
        self._gc()
        return final

    def _gc(self) -> None:
        steps = self.all_steps()
        for s in steps[: -self.keep] if self.keep > 0 else []:
            shutil.rmtree(os.path.join(self.directory, f"step_{s:08d}"), ignore_errors=True)

    # -- discovery ----------------------------------------------------------------
    def all_steps(self) -> List[int]:
        out = []
        for name in os.listdir(self.directory):
            if not name.startswith("step_") or name.endswith(".tmp"):
                continue
            if not os.path.exists(os.path.join(self.directory, name, "COMMITTED")):
                continue  # torn write — ignore
            out.append(int(name.split("_")[1]))
        return sorted(out)

    def latest_step(self) -> Optional[int]:
        steps = self.all_steps()
        return steps[-1] if steps else None

    # -- restore -----------------------------------------------------------------
    def restore(self, tree_like: Any, step: Optional[int] = None,
                shardings: Optional[Any] = None) -> Any:
        """Restore into the structure of ``tree_like``: each leaf on the
        device and in the type of ``tree_like``'s leaf at its place.
        ``shardings`` (same structure, :class:`~repro_torch.distributed.
        sharding.NamedSharding` leaves or None) re-places the buffers: a leaf
        with a sharding becomes a DTensor of that layout on its mesh, each
        rank keeping its block of the file's array (elastic resume, across
        a different mesh or rank count)."""
        step = step if step is not None else self.latest_step()
        if step is None:
            raise FileNotFoundError("no committed checkpoint found")
        d = os.path.join(self.directory, f"step_{step:08d}")
        with open(os.path.join(d, "MANIFEST.json")) as f:
            manifest = json.load(f)
        items = flatten_with_path(tree_like)
        if len(items) != len(manifest["leaves"]):
            raise ValueError(
                f"checkpoint has {len(manifest['leaves'])} leaves, "
                f"target structure has {len(items)}"
            )
        shard_leaves = (_shardings_of(tree_like, shardings) if shardings is not None
                        else [None] * len(items))
        out = []
        for (name, like), meta, shd in zip(items, manifest["leaves"], shard_leaves, strict=True):
            if name != meta["key"]:
                raise ValueError(f"leaf order mismatch: {name} vs {meta['key']}")
            arr = np.load(os.path.join(d, meta["file"]), allow_pickle=False)
            t = _to_tensor(arr, meta["dtype"], like)
            out.append(t if shd is None else distribute(t, shd.spec, shd.mesh))
        return unflatten(tree_like, out)


def _shardings_of(tree_like: Any, shardings: Any) -> List[Any]:
    """The sharding of each leaf of ``tree_like``, in its flatten order; a
    None in ``shardings`` stands for every leaf under it."""
    if shardings is None:
        return [None] * len(flatten_with_path(tree_like))
    if isinstance(tree_like, dict):
        return [s for k in sorted(tree_like) for s in _shardings_of(tree_like[k], shardings[k])]
    if isinstance(tree_like, (list, tuple)):
        return [s for i, x in enumerate(tree_like) for s in _shardings_of(x, shardings[i])]
    return [] if tree_like is None else [shardings]
