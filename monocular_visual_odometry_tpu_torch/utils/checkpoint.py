"""VO state checkpoint / resume.

The whole engine state is one record of records (:class:`models.state.VOState`),
so a checkpoint is its tensors flattened in the records' field order into an
``.npz``: ``treedef`` (the structure, as the JAX package's ``str`` of its
pytree definition spells it), ``n_leaves`` and ``leaf_i``. That is the JAX
package's format, so :func:`load_state` also reads a checkpoint written by
``monocular_visual_odometry_tpu.utils.checkpoint.save_state``: both
``VOState``s have the same 33 leaves in the same order. The one leaf that
differs is the random key, ``uint32[2]`` there and a 0-d int64 here; its
two words are folded into the port's key as ``convert.state_from_numpy``
folds them, so a JAX run resumes in the port.
"""

from __future__ import annotations

import os
from typing import Any

import numpy as np
import torch

from monocular_visual_odometry_tpu_torch.convert import key_from_words


def _leaves(record) -> list[torch.Tensor]:
    if hasattr(record, "_fields"):
        return [leaf for field in record for leaf in _leaves(field)]
    return [record]


def _treedef(record) -> str:
    """The structure of a record of records, spelled as JAX's ``str`` of
    its ``PyTreeDef``."""
    def node(r):
        if hasattr(r, "_fields"):
            return f"CustomNode(namedtuple[{type(r).__name__}], [{', '.join(map(node, r))}])"
        return "*"
    return f"PyTreeDef({node(record)})"


def _unflatten(like, leaves):
    if hasattr(like, "_fields"):
        return type(like)(*(_unflatten(field, leaves) for field in like))
    return next(leaves)


def save_state(path: str, state: Any) -> None:
    """Write ``state`` (a :class:`VOState`) to ``path`` as an ``.npz``."""
    leaves = _leaves(state)
    os.makedirs(os.path.dirname(os.path.abspath(path)), exist_ok=True)
    np.savez_compressed(
        path,
        treedef=np.frombuffer(_treedef(state).encode(), dtype=np.uint8),
        n_leaves=np.asarray(len(leaves)),
        **{f"leaf_{i}": t.detach().cpu().numpy() for i, t in enumerate(leaves)},
    )


def load_state(path: str, like: Any) -> Any:
    """Restore a state saved by :func:`save_state` or by the JAX package.
    ``like`` gives the structure, the dtypes and the devices (e.g. a freshly
    initialized VOState): each tensor goes to the device of its template,
    so the key stays on the CPU.

    Validates the saved structure and every leaf's shape against the
    template, so capacity/config mismatches fail with a clear message
    instead of a downstream shape error."""
    leaves = _leaves(like)
    treedef = _treedef(like)
    with np.load(path) as data:
        n = int(data["n_leaves"])
        if n != len(leaves):
            raise ValueError(f"checkpoint has {n} leaves, template has {len(leaves)}")
        saved_treedef = bytes(data["treedef"]).decode()
        if saved_treedef != treedef:
            raise ValueError(
                "checkpoint pytree structure does not match the template state "
                "(was it saved with a different framework version?):\n"
                f"  saved:    {saved_treedef[:200]}...\n"
                f"  template: {treedef[:200]}...")
        rng_leaf = next(i for i, t in enumerate(leaves) if t is like.rng)
        new_leaves = []
        for i in range(n):
            arr = data[f"leaf_{i}"]
            t = leaves[i]
            if i == rng_leaf and arr.dtype == np.uint32 and arr.shape == (2,) and t.dim() == 0:
                arr = np.asarray(key_from_words(arr))  # a JAX PRNGKey
            if tuple(arr.shape) != tuple(t.shape):
                raise ValueError(
                    f"checkpoint leaf {i} has shape {tuple(arr.shape)} but the "
                    f"template expects {tuple(t.shape)} — capacity "
                    "config (max_keypoints/max_map_points/...) must match the "
                    "one used at save time")
            new_leaves.append(torch.from_numpy(np.array(arr)).to(dtype=t.dtype, device=t.device))
    return _unflatten(like, iter(new_leaves))
