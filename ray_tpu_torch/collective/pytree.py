"""Minimal pytree pack/unpack for collective payloads.

Collectives operate on flat numpy buffers; users hold nested containers
(gradient trees, metric dicts). This flattens nested dict/list/tuple
structures of array-likes into per-dtype contiguous buffers — one
collective round per dtype group instead of one per leaf — and restores
the original structure afterwards. Deliberately torch-free: host
collectives must not pull torch into CPU-only rollout workers (see
rl/core.py CPU_WORKER_ENV).

Packing order is structure-deterministic (dict keys sorted), so every
rank packs identically and cross-backend results stay comparable.
"""

from __future__ import annotations

from typing import Any, Dict, List, Tuple

import numpy as np


def tree_flatten(tree) -> Tuple[List[np.ndarray], Any]:
    """Flatten nested dict/list/tuple into (leaves, treedef)."""
    leaves: List[np.ndarray] = []

    def rec(node):
        if isinstance(node, dict):
            keys = sorted(node)
            return ("d", keys, [rec(node[k]) for k in keys])
        if isinstance(node, (list, tuple)):
            tag = "l" if isinstance(node, list) else "t"
            return (tag, None, [rec(x) for x in node])
        leaves.append(np.asarray(node))
        return ("*", None, None)

    treedef = rec(tree)
    return leaves, treedef


def tree_unflatten(treedef, leaves: List[np.ndarray]):
    it = iter(leaves)

    def rec(node):
        tag, keys, children = node
        if tag == "d":
            return {k: rec(c) for k, c in zip(keys, children)}
        if tag == "l":
            return [rec(c) for c in children]
        if tag == "t":
            return tuple(rec(c) for c in children)
        return next(it)

    return rec(treedef)


def is_leaf(value) -> bool:
    return not isinstance(value, (dict, list, tuple))


def pack_leaves(leaves: List[np.ndarray]):
    """Group leaves by dtype and concatenate raveled data.

    Returns (buffers, layout): buffers is a list of 1-D arrays (one per
    dtype group, iterated in first-appearance order); layout records per
    leaf (group index, offset, size, shape) for unpacking.
    """
    group_order: List[str] = []
    groups: Dict[str, List[np.ndarray]] = {}
    layout = []
    offsets: Dict[str, int] = {}
    for leaf in leaves:
        arr = np.asarray(leaf)
        key = arr.dtype.str
        if key not in groups:
            groups[key] = []
            offsets[key] = 0
            group_order.append(key)
        gi = group_order.index(key)
        layout.append((gi, offsets[key], arr.size, arr.shape))
        groups[key].append(arr.ravel())
        offsets[key] += arr.size
    buffers = [np.concatenate(groups[k]) if groups[k]
               else np.empty((0,)) for k in group_order]
    return buffers, layout


def unpack_leaves(buffers, layout) -> List[np.ndarray]:
    out = []
    for gi, off, size, shape in layout:
        out.append(np.asarray(buffers[gi][off:off + size]).reshape(shape))
    return out
