"""Sharding rules: one place that knows how tensors map onto the mesh,
and the pytree helpers the training path shares.

Port of ``repro/distributed/sharding.py``. Mesh axes:

  * ``pod``   — across pods; extra data-parallel dimension (multi-pod mesh only)
  * ``data``  — batch / FSDP / sequence(-KV) parallelism
  * ``model`` — tensor parallelism: heads, FFN hidden, experts, vocab

A mesh is a :class:`Mesh`: a ``torch.distributed`` ``DeviceMesh`` under
the names the rules read (``axis_names``, ``devices.shape``). A spec is a
:class:`P`, one entry per tensor dim (an axis name, a tuple of names, or
None), as ``jax.sharding.PartitionSpec``; :func:`placements` turns it into
DTensor placements, one per mesh dim. Model code calls :func:`constraint`
on activations: the identity when no mesh is active (one card), and with a
mesh a redistribute of the DTensor to the spec's placements, as
``with_sharding_constraint``. Axis names the mesh lacks and entries that do
not divide their dim are dropped.

A tree here is what the reference's pytrees are: nested dicts (and lists /
tuples) of tensors. :func:`tree_map`, :func:`tree_leaves` and
:func:`tree_unflatten` stand in for ``jax.tree``'s: like ``jax.tree.map``,
:func:`tree_map` rebuilds every dict with its keys sorted, so a mapped
tree's leaves come in the order the reference's do.
"""
from __future__ import annotations

import contextlib
import threading
from dataclasses import dataclass

_state = threading.local()


class P(tuple):
    """A partition spec: ``P("data", None, ("pod", "data"))``, one entry
    per tensor dim from the left; missing trailing entries are None. As
    ``PartitionSpec`` does, a one-name tuple (or list) becomes the name and
    an empty one None."""

    def __new__(cls, *entries):
        def norm(e):
            if isinstance(e, (tuple, list)):
                return None if not e else e[0] if len(e) == 1 else tuple(e)
            return e
        return super().__new__(cls, (norm(e) for e in entries))

    def __repr__(self) -> str:
        return f"P{tuple(self)!r}"


class Mesh:
    """A ``DeviceMesh`` under the reference ``Mesh``'s names:
    ``axis_names`` and ``devices`` (the mesh's tensor of ranks, whose
    ``shape`` is the axis sizes)."""

    def __init__(self, device_mesh):
        self.device_mesh = device_mesh
        self.axis_names = tuple(device_mesh.mesh_dim_names)
        self.devices = device_mesh.mesh

    def __repr__(self) -> str:
        return f"Mesh({dict(zip(self.axis_names, self.devices.shape))})"


@dataclass(frozen=True)
class NamedSharding:
    """A spec on a mesh; :attr:`placements` are its DTensor placements."""
    mesh: Mesh
    spec: P

    @property
    def placements(self) -> tuple:
        return placements(self.spec, self.mesh)


def active_mesh() -> Mesh | None:
    return getattr(_state, "mesh", None)


@contextlib.contextmanager
def use_mesh(mesh: Mesh):
    """Activate a mesh for sharding constraints."""
    prev = getattr(_state, "mesh", None)
    _state.mesh = mesh
    try:
        yield mesh
    finally:
        _state.mesh = prev


def _filter_spec(spec: P, mesh) -> P:
    """Drop axis names the mesh doesn't have; keep positions."""
    names = set(mesh.axis_names)

    def keep(entry):
        if entry is None:
            return None
        if isinstance(entry, (tuple, list)):
            kept = tuple(e for e in entry if e in names)
            return kept if kept else None
        return entry if entry in names else None

    return P(*(keep(e) for e in spec))


def axis_size(name: str) -> int:
    """Size of a mesh axis (1 when absent / no active mesh)."""
    mesh = active_mesh()
    if mesh is None or name not in mesh.axis_names:
        return 1
    return mesh.devices.shape[list(mesh.axis_names).index(name)]


def _fit_dims(spec: P, shape: tuple, mesh) -> P:
    """Drop spec entries that don't divide their dim (an uneven shard
    would pad; the reference drops them for the same reason)."""
    sizes = dict(zip(mesh.axis_names, mesh.devices.shape))
    out = []
    entries = tuple(spec) + (None,) * (len(shape) - len(spec))
    for dim, entry in zip(shape, entries):
        if entry is None:
            out.append(None)
            continue
        axes = entry if isinstance(entry, tuple) else (entry,)
        n = 1
        for a in axes:
            n *= sizes.get(a, 1)
        out.append(entry if n and dim % n == 0 else None)
    return P(*out)


def placements(spec: P, mesh) -> tuple:
    """The DTensor placements of ``spec`` on ``mesh``: ``Shard(d)`` on every
    mesh dim that tensor dim ``d`` names (a tuple entry shards ``d`` over
    its axes, major first, as the mesh orders them), ``Replicate()`` on
    the others. The spec's names must be the mesh's."""
    from torch.distributed.tensor import Replicate, Shard
    names = list(mesh.axis_names)
    out = [Replicate()] * len(names)
    for dim, entry in enumerate(spec):
        if entry is None:
            continue
        for a in entry if isinstance(entry, tuple) else (entry,):
            out[names.index(a)] = Shard(dim)
    return tuple(out)


def constraint(x, *spec):
    """``x`` redistributed to ``P(*spec)`` if a mesh is active, else ``x``.

    Unknown axis names and non-divisible entries are dropped per dim. A
    plain tensor (one made inside the model) is taken as replicated
    first."""
    mesh = active_mesh()
    if mesh is None:
        return x
    from torch.distributed.tensor import DTensor, Replicate
    p = _fit_dims(_filter_spec(P(*spec), mesh), tuple(x.shape), mesh)
    dm = mesh.device_mesh
    if not isinstance(x, DTensor):
        x = DTensor.from_local(x, dm, [Replicate()] * dm.ndim,
                               run_check=False)
    return x.redistribute(dm, placements(p, mesh))


def named_sharding(*spec) -> NamedSharding:
    mesh = active_mesh()
    if mesh is None:
        raise RuntimeError("no active mesh")
    return NamedSharding(mesh, _filter_spec(P(*spec), mesh))


# ---------------------------------------------------------------------------
# Parameter sharding rules
# ---------------------------------------------------------------------------
# Matched against the leaves of the real parameter paths ('embed/table',
# 'lm_head/w', 'stages/posN/block/<name>', 'stages/posN/mixer/<name>',
# norms), with the leaf's rank to tell expert banks and head-wise weights
# apart. Megatron-style TP over 'model' + ZeRO-3/FSDP over 'data' on one
# other large dim; experts over 'model' (EP); norms/scalars replicated.

_COL_PARALLEL = {"wq", "wk", "wv", "w_gate", "w_up", "in_proj",
                 "w_zgate", "w_igate", "w_fgate", "w_ogate"}
_ROW_PARALLEL = {"wo", "w_down", "out_proj", "w_out"}


def spec_for_param(path: str, stacked: bool, ndim: int | None = None) -> P:
    parts = path.split("/")
    name = parts[-1]
    parent = parts[-2] if len(parts) > 1 else ""
    spec = P()
    if name == "table":                       # vocab x d_model
        spec = P("model", "data")
    elif parent == "lm_head":                 # d_model x vocab
        spec = P("data", "model")
    elif parent == "mixer":
        if name == "router":
            spec = P("data", None)
        elif ndim == 3 or (ndim is None):     # MoE expert banks (E, ., .)
            # FSDP over the d dim, experts over 'model'
            spec = P("model", "data", None) if name in ("w_gate", "w_up") \
                else P("model", None, "data")
        elif name in _COL_PARALLEL:
            spec = P("data", "model")
        elif name in _ROW_PARALLEL:
            spec = P("model", "data")
    elif parent == "block":
        if ndim == 3:                         # head-wise (H, dh, dh)
            spec = P(None, "model", None)
        elif name in _ROW_PARALLEL:
            spec = P("model", "data")
        elif name in _COL_PARALLEL:
            spec = P("data", "model")
        elif name in ("x_bc", "x_dt", "a_log"):
            spec = P("model", None)           # d_inner-major
        elif name == "dt_proj":
            spec = P(None, "model")
        elif name == "conv_w":
            spec = P(None, "model")
        elif name in ("dt_bias", "d_skip"):
            spec = P("model")
        elif name in ("wi", "wf"):            # mLSTM gate heads (dc, H)
            spec = P("data", None)
    # norms / scalars / anything else: replicated P()
    if ndim is not None:
        spec = P(*tuple(spec)[:ndim])
    return P(None, *spec) if stacked else spec


def param_shardings(params, mesh: Mesh, stacked_prefixes: tuple[str, ...] = (
        "stages",)):
    """A tree of :class:`NamedSharding` of ``params``' structure."""

    def one(path: str, leaf):
        stacked = any(path.startswith(p) for p in stacked_prefixes)
        ndim = getattr(leaf, "ndim", None)
        spec = spec_for_param(path, stacked,
                              ndim - 1 if stacked and ndim else ndim)
        spec = P(*spec[: ndim if ndim is not None else len(spec)])
        spec = _fit_dims(spec, tuple(leaf.shape), mesh) if ndim else spec
        return NamedSharding(mesh, _filter_spec(spec, mesh))

    shardings = {p: one(p, leaf) for p, leaf in tree_paths(params).items()}
    return tree_unflatten(params, list(shardings.values()))


def tree_paths(tree) -> dict:
    """Flatten a tree to ``{'a/b/c': leaf}`` in the tree's own order."""
    flat = {}

    def walk(prefix, node):
        if isinstance(node, dict):
            for k, v in node.items():
                walk(f"{prefix}/{k}" if prefix else k, v)
        elif isinstance(node, (list, tuple)):
            for i, v in enumerate(node):
                walk(f"{prefix}/{i}", v)
        else:
            flat[prefix] = node

    walk("", tree)
    return flat


def tree_leaves(tree) -> list:
    """The leaves of ``tree`` in :func:`tree_paths` order."""
    return list(tree_paths(tree).values())


def tree_map(fn, tree, *rest):
    """``fn`` over the leaves of ``tree`` and the matching leaves of
    ``rest``; dicts come back with sorted keys, as ``jax.tree.map`` gives
    them."""
    if isinstance(tree, dict):
        return {k: tree_map(fn, tree[k], *(r[k] for r in rest))
                for k in sorted(tree)}
    if isinstance(tree, (list, tuple)):
        return type(tree)(tree_map(fn, t, *(r[i] for r in rest))
                          for i, t in enumerate(tree))
    return fn(tree, *rest)


def tree_unflatten(like, leaves):
    """A tree of ``like``'s structure (its own key order) whose leaves are
    ``leaves``, given in :func:`tree_paths` order of ``like``."""
    it = iter(leaves)

    def build(node):
        if isinstance(node, dict):
            return {k: build(v) for k, v in node.items()}
        if isinstance(node, (list, tuple)):
            return type(node)(build(t) for t in node)
        return next(it)

    return build(like)
