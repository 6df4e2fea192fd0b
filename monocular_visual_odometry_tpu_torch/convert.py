"""Carry a VO state, a BA problem and a config across from the JAX package.

The engine has no weights; what a run carries is its :class:`VOState`, the
windowed :class:`BAProblem` built from it, and its :class:`VOConfig`. These
helpers take them as plain Python and numpy values (the JAX side flattens
its records with ``jax.device_get`` and ``_asdict``, and its config with
``dataclasses.asdict``), so that both packages can be started from the same
mid-sequence state or solve the same problem. Nothing here imports JAX.

The one field without a counterpart is the random key: the JAX state holds
a ``PRNGKey`` (two uint32 words), the port an integer key. The words are
folded into a 63-bit integer, so equal keys carry over to equal keys; the
draws made from them differ between the packages all the same. A batched
JAX state (``jax.vmap``'s input: a leading [B] on every field, keys
[B,2]) carries over with ``batched=True``, each stream's key folded on its
own, as the port's :func:`models.state.stack_states` of the B streams.
"""

from __future__ import annotations

import dataclasses
from typing import Any, Mapping

import numpy as np
import torch

from monocular_visual_odometry_tpu_torch.models.ba import BAProblem
from monocular_visual_odometry_tpu_torch.models.state import FrameRing, MapState, VOState
from monocular_visual_odometry_tpu_torch.ops.features import FrameFeatures
from monocular_visual_odometry_tpu_torch.utils import config as C

_NESTED = {"ref_feats": FrameFeatures, "map": MapState, "ring": FrameRing}
_SECTIONS = {f.name: f.type for f in dataclasses.fields(C.VOConfig)}


def _fields(v: Any) -> Mapping[str, Any]:
    return v._asdict() if hasattr(v, "_asdict") else v


def key_from_words(words: np.ndarray) -> int:
    """A JAX ``PRNGKey`` (two uint32 words) folded into the port's integer key."""
    w = np.asarray(words).astype(np.uint64).reshape(-1)
    key = 0
    for x in w:
        key = ((key << 32) | int(x)) & ((1 << 64) - 1)
    return key >> 1


def _device(device, who: str) -> torch.device:
    dev = torch.device(device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(f"{who}: device 'cuda' requested but no CUDA device is "
                           "available")
    return dev


def state_from_numpy(d: Mapping[str, Any], device="cuda", batched: bool = False) -> VOState:
    """Build a port :class:`VOState` from a JAX ``VOState`` flattened to
    numpy: a mapping from field name to array, with the nested records
    (``ref_feats``, ``map``, ``ring``) given as mappings or NamedTuples.
    ``batched``: the state of B streams, ``rng`` a [B] key per stream."""
    dev = _device(device, "state_from_numpy")
    d = _fields(d)

    def tensor(a):
        return torch.from_numpy(np.array(a)).to(dev)

    out = {}
    for name in VOState._fields:
        if name == "rng":
            key = np.asarray(d[name])
            fold = key_from_words if key.dtype == np.uint32 else int
            k = [fold(w) for w in key] if batched else fold(key)
            out[name] = torch.tensor(k, dtype=torch.int64)
        elif name in _NESTED:
            rec = _fields(d[name])
            out[name] = _NESTED[name](**{f: tensor(rec[f]) for f in _NESTED[name]._fields})
        else:
            out[name] = tensor(d[name])
    return VOState(**out)


def problem_from_numpy(d: Mapping[str, Any], device="cuda") -> BAProblem:
    """Build a port :class:`BAProblem` from a JAX ``BAProblem`` flattened to
    numpy (a mapping from field name to array, or the NamedTuple itself)."""
    dev = _device(device, "problem_from_numpy")
    d = _fields(d)
    return BAProblem(**{f: torch.from_numpy(np.array(d[f])).to(dev)
                        for f in BAProblem._fields})


def state_to_numpy(st: VOState) -> dict[str, Any]:
    """The port state as a dict of numpy arrays, nested records as dicts."""
    def arr(t):
        return t.detach().cpu().numpy()

    return {name: ({f: arr(x) for f, x in getattr(st, name)._asdict().items()}
                   if name in _NESTED else arr(getattr(st, name)))
            for name in VOState._fields}


def config_to_torch(cfg_fields: Mapping[str, Any]) -> C.VOConfig:
    """Build the port's :class:`VOConfig` from ``dataclasses.asdict`` of a
    JAX ``VOConfig``. A field the port does not know raises ``TypeError``."""
    kw = {}
    for name, value in cfg_fields.items():
        section = _SECTIONS.get(name)
        if isinstance(value, Mapping):
            section = getattr(C, section) if isinstance(section, str) else section
            kw[name] = section(**{k: tuple(v) if isinstance(v, list) else v
                                  for k, v in value.items()})
        else:
            kw[name] = value
    return C.VOConfig(**kw)
