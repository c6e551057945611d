"""The mesh context and ``shard_map`` of the port, over ``torch.distributed``.

The counterpart of ``repro.distributed.compat``:

* :func:`set_mesh` binds a :class:`~torch.distributed.device_mesh.DeviceMesh`
  as the current mesh for the enclosed region (thread-local), as
  ``jax.set_mesh`` does; the named-axis collectives of
  :mod:`repro_torch.distributed.collectives` find their process groups on it.
* :func:`axis_size` is the size of a named mesh dimension (or the product
  over a tuple of names).
* :func:`shard_map` runs a function on each rank's blocks, by hand on
  ``to_local()`` / ``DTensor.from_local``: a DTensor argument is brought to
  the placements of its spec and its local block is passed; a plain tensor
  is passed as it is, as the rank's block already (``local_map``'s rule).
  When any argument was a DTensor the outputs are wrapped as DTensors with
  the placements of ``out_specs``; otherwise they stay the rank's plain
  blocks.
"""

from __future__ import annotations

import contextlib
import math
import threading
from typing import Any, Callable, Optional, Sequence, Union

from torch.distributed.device_mesh import DeviceMesh
from torch.distributed.tensor import DTensor

__all__ = ["axis_size", "current_mesh", "set_mesh", "shard_map"]

_CTX = threading.local()


def current_mesh() -> Optional[DeviceMesh]:
    return getattr(_CTX, "mesh", None)


@contextlib.contextmanager
def set_mesh(mesh: DeviceMesh):
    """Bind ``mesh`` as the current mesh for the enclosed region."""
    prev = current_mesh()
    _CTX.mesh = mesh
    try:
        yield mesh
    finally:
        _CTX.mesh = prev


def _mesh(mesh: Optional[DeviceMesh]) -> DeviceMesh:
    mesh = mesh if mesh is not None else current_mesh()
    if mesh is None:
        raise ValueError("no mesh: call inside set_mesh(...) or shard_map")
    return mesh


def axis_size(axis_name: Union[str, Sequence[str]], mesh: Optional[DeviceMesh] = None) -> int:
    """Size of a named mesh dimension, or the product over several."""
    mesh = _mesh(mesh)
    names = (axis_name,) if isinstance(axis_name, str) else tuple(axis_name)
    shape = dict(zip(mesh.mesh_dim_names, mesh.shape, strict=True))
    return math.prod(int(shape[n]) for n in names)


def _tree_map(fn: Callable, tree: Any, spec: Any) -> Any:
    """``fn(leaf, spec)`` over a tree of dicts/lists/tuples whose spec tree
    has the same structure; a spec leaf is a PartitionSpec (a tuple) or
    None, which stands for every leaf under it."""
    from repro_torch.distributed.sharding import PartitionSpec

    if isinstance(tree, dict):
        items = tree.items()  # det: ok key-addressed rebuild, the tree's own order
        return {k: _tree_map(fn, v, spec[k] if isinstance(spec, dict) else spec) for k, v in items}
    if isinstance(tree, (list, tuple)) and not isinstance(spec, PartitionSpec):
        specs = spec if isinstance(spec, (list, tuple)) else [spec] * len(tree)
        return type(tree)(_tree_map(fn, t, s) for t, s in zip(tree, specs, strict=True))
    return fn(tree, spec)


def shard_map(f: Callable, mesh: DeviceMesh, in_specs: Sequence[Any], out_specs: Any) -> Callable:
    """``f`` over each rank's blocks of its arguments, with ``mesh`` current.

    ``in_specs`` holds one spec tree per positional argument and
    ``out_specs`` the spec tree of ``f``'s result."""
    from repro_torch.distributed.sharding import PartitionSpec, placements

    def wrapped(*args):
        seen_dtensor = []

        def to_local(x, spec):
            if not isinstance(x, DTensor):
                return x
            seen_dtensor.append(True)
            want = placements(spec or PartitionSpec(), mesh, x.ndim)
            if tuple(x.placements) != want:
                x = x.redistribute(mesh, want)
            return x.to_local()

        local = [_tree_map(to_local, a, s) for a, s in zip(args, in_specs, strict=True)]
        with set_mesh(mesh):
            out = f(*local)
        if not seen_dtensor:
            return out

        def wrap(y, spec):
            if y is None:
                return None
            return DTensor.from_local(y, mesh, placements(spec or PartitionSpec(), mesh, y.ndim),
                                      run_check=False)

        return _tree_map(wrap, out, out_specs)

    return wrapped
