"""State carried across the host↔device boundary.

Task outputs are nested dicts/tuples/lists of arrays. The host backend
works on numpy arrays, the device backend on torch tensors; the executor
moves every input to its task's side with these helpers, and the tests use
them to hand the JAX package's outputs (``np.asarray``) to the port.
"""

from __future__ import annotations

from typing import Any, Iterator, Optional

import numpy as np
import torch


def resolve_device(device: Optional[object] = None) -> torch.device:
    """``device`` as a :class:`torch.device`; ``None`` means the card.

    Raises when a CUDA device is asked for and there is none: the port
    never carries on quietly on the CPU."""
    dev = torch.device("cuda" if device is None else device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            f"device {dev} requested but torch.cuda.is_available() is false; "
            "pass device='cpu' to run on the CPU"
        )
    return dev


def _map(fn, tree: Any) -> Any:
    if isinstance(tree, dict):
        return {k: _map(fn, v) for k, v in tree.items()}  # det: ok key-addressed rebuild; caller's order kept
    if isinstance(tree, (tuple, list)):
        return type(tree)(_map(fn, v) for v in tree)
    return fn(tree)


def from_reference(tree: Any, device: object) -> Any:
    """numpy arrays/scalars (and tensors elsewhere) → tensors on ``device``.

    The structure is kept; Python numbers (e.g. a chosen ``k``) pass
    through. Arrays are copied, so read-only views are fine."""
    dev = torch.device(device)

    def leaf(x):
        if isinstance(x, torch.Tensor):
            return x.to(dev)
        if isinstance(x, (np.ndarray, np.generic)):
            return torch.tensor(np.asarray(x), device=dev)
        return x

    return _map(leaf, tree)


def to_numpy(tree: Any) -> Any:
    """Tensors → numpy arrays (via the host), keeping the structure."""

    def leaf(x):
        if isinstance(x, torch.Tensor):
            return x.detach().cpu().numpy()
        return x

    return _map(leaf, tree)


def leaves(tree: Any) -> Iterator[Any]:
    """Every leaf of ``tree``, depth first."""
    if isinstance(tree, dict):
        for v in tree.values():  # det: ok key-addressed tree; caller's order kept
            yield from leaves(v)
    elif isinstance(tree, (tuple, list)):
        for v in tree:
            yield from leaves(v)
    else:
        yield tree


def synchronize(tree: Any) -> Any:
    """Wait for the card when any leaf is a CUDA tensor; return ``tree``.

    Torch launches are asynchronous, so a host clock read right after a
    device operator returns would time only the enqueue."""
    for x in leaves(tree):
        if isinstance(x, torch.Tensor) and x.is_cuda:
            torch.cuda.synchronize(x.device)
            break
    return tree
