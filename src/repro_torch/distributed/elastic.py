"""Elastic scaling: re-shard checkpoints/trees across changing host counts.

Port of ``repro/distributed/elastic.py``, host numpy as there. Every host
holds a deterministic shard of each leaf (split on axis 0); on a re-mesh
the new host set re-slices from whatever shard granularity the checkpoint
carries. :func:`reshard_tree` is granularity-polymorphic: give it the
original tree (one shard) or a shard list, and a new shard count — it
merges then re-splits. With the deterministic data pipeline (any shard's
batch is recomputable from (seed, step)), a re-meshed job resumes
bit-exactly minus the lost in-flight step.
"""
from __future__ import annotations

import numpy as np


def _merge(shards: list) -> dict:
    """Merge shard dicts back into full leaves (inverse of _split)."""
    if len(shards) == 1:
        return shards[0]
    out = {}
    for key in shards[0]:
        parts = [s[key] for s in shards]
        first = np.asarray(parts[0])
        if first.ndim == 0:
            out[key] = first
        else:
            out[key] = np.concatenate(parts, axis=0)
    return out


def _split(tree: dict, num_shards: int) -> list[dict]:
    shards = [dict() for _ in range(num_shards)]
    for key, leaf in tree.items():
        arr = np.asarray(leaf)
        if arr.ndim == 0 or arr.shape[0] % num_shards:
            for s in shards:            # replicate unsplittable leaves
                s[key] = arr
        else:
            for i, piece in enumerate(np.split(arr, num_shards, axis=0)):
                shards[i][key] = piece
    return shards


def reshard_tree(tree_or_shards, num_shards: int) -> list[dict]:
    """dict | list[dict] -> list of `num_shards` shard dicts."""
    if isinstance(tree_or_shards, dict):
        full = tree_or_shards
    else:
        full = _merge(list(tree_or_shards))
    return _split(full, num_shards)


def plan_remesh(old_devices: int, new_devices: int,
                model_axis: int) -> dict:
    """Axis plan when the device count changes (pod loss / grow).

    Keeps the model axis fixed (TP degree is baked into layer shapes) and
    absorbs the change on the data axis; if the new count doesn't divide,
    falls back to the largest feasible data axis and idles the remainder
    (reported so the scheduler can re-pack).
    """
    if new_devices % model_axis:
        usable = (new_devices // model_axis) * model_axis
    else:
        usable = new_devices
    return {
        "model_axis": model_axis,
        "data_axis": usable // model_axis,
        "usable_devices": usable,
        "idle_devices": new_devices - usable,
        "batch_scale": (usable // model_axis) / (old_devices // model_axis),
    }
