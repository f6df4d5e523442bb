"""Input / state / parameter shardings for every dry-run cell.

Port of ``repro/launch/shardings.py``: one place that decides, per (arch ×
shape × mesh), where every tensor lives:

  * tokens/labels: batch over ('pod','data')
  * params & optimizer moments: FSDP over 'data' × TP over 'model'
    (:func:`repro_torch.distributed.sharding.spec_for_param`)
  * decode state: batch over ('pod','data'); the long dimension of each
    state kind over 'model' (KV sequence, mamba d_inner, xLSTM head dim);
    for global_batch == 1 (long_500k) the KV sequence takes both axes.

Divisibility is checked and degraded per tensor (an axis that doesn't
divide is dropped). The counterpart of the reference's ``ShapeDtypeStruct``
with a sharding is :class:`ShapeDtypeStruct` here: a shape, a dtype and a
:class:`NamedSharding`, which :meth:`ShapeDtypeStruct.make` turns into a
DTensor over a ``meta`` local tensor of the shard's shape. Nothing is
allocated; the parameter and state shapes come from the port's own
constructors run under ``FakeTensorMode``.
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Any

import torch

from repro_torch.configs.base import BlockKind, InputShape, ModelConfig
from repro_torch.distributed.sharding import (Mesh, NamedSharding, P,
                                              tree_map)
from repro_torch.distributed.sharding import \
    param_shardings as _param_shardings


@dataclass(frozen=True)
class ShapeDtypeStruct:
    """A global shape and dtype, placed by ``sharding``."""
    shape: tuple
    dtype: torch.dtype
    sharding: NamedSharding

    @property
    def ndim(self) -> int:
        return len(self.shape)

    @property
    def local_shape(self) -> tuple:
        """The shape of one rank's shard (the fitted specs divide)."""
        mesh = self.sharding.mesh
        sizes = dict(zip(mesh.axis_names, mesh.devices.shape))
        out = list(self.shape)
        for d, entry in enumerate(self.sharding.spec):
            for a in entry if isinstance(entry, tuple) else \
                    (() if entry is None else (entry,)):
                out[d] //= sizes[a]
        return tuple(out)

    def make(self):
        """A DTensor of this shape and placement over a ``meta`` shard."""
        from torch.distributed.tensor import DTensor
        local = torch.empty(self.local_shape, dtype=self.dtype,
                            device="meta")
        return DTensor.from_local(local, self.sharding.mesh.device_mesh,
                                  self.sharding.placements, run_check=False)


def make_tree(tree: Any) -> Any:
    """Every :class:`ShapeDtypeStruct` of ``tree`` made a DTensor, with
    the tree's own structure."""
    if isinstance(tree, dict):
        return {k: make_tree(v) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return type(tree)(make_tree(v) for v in tree)
    return tree.make()


def dp_axes(mesh: Mesh):
    return tuple(a for a in ("pod", "data") if a in mesh.axis_names)


def _fit(spec: P, shape: tuple, mesh: Mesh) -> P:
    """Drop spec entries that don't divide the dim (graceful degrade)."""
    sizes = dict(zip(mesh.axis_names, mesh.devices.shape))
    out = []
    for dim, entry in zip(shape,
                          tuple(spec) + (None,) * (len(shape) - len(spec))):
        if entry is None:
            out.append(None)
            continue
        axes = entry if isinstance(entry, tuple) else (entry,)
        n = 1
        for a in axes:
            n *= sizes[a]
        out.append(entry if dim % n == 0 else None)
    return P(*out)


def shard(mesh: Mesh, spec: P, shape: tuple) -> NamedSharding:
    return NamedSharding(mesh, _fit(spec, shape, mesh))


def _sds(shape, dtype, sharding: NamedSharding) -> ShapeDtypeStruct:
    return ShapeDtypeStruct(tuple(shape), dtype, sharding)


# -- inputs -------------------------------------------------------------------


def batch_specs(cfg: ModelConfig, shape: InputShape, mesh: Mesh,
                with_labels: bool) -> dict[str, ShapeDtypeStruct]:
    dp = dp_axes(mesh)
    b, s = shape.global_batch, shape.seq_len
    out = {"tokens": _sds((b, s), torch.int32, shard(mesh, P(dp), (b, s)))}
    if with_labels:
        out["labels"] = _sds((b, s), torch.int32,
                             shard(mesh, P(dp), (b, s)))
    return out


def decode_token_spec(shape: InputShape, mesh: Mesh) -> ShapeDtypeStruct:
    b = shape.global_batch
    return _sds((b,), torch.int32, shard(mesh, P(dp_axes(mesh)), (b,)))


# -- parameters / optimizer -------------------------------------------------


def param_shapes(cfg: ModelConfig) -> dict:
    """The reference-layout parameter tree of ``cfg`` as fake tensors
    (shapes and dtypes; nothing allocated)."""
    from torch._subclasses.fake_tensor import FakeTensorMode

    from repro_torch.models.model import build_model, params_tree
    with FakeTensorMode():
        return params_tree(build_model(cfg, device="cpu"))


def param_specs(cfg: ModelConfig, mesh: Mesh) -> Any:
    """:class:`ShapeDtypeStruct` with shardings for the full parameter
    tree."""
    shapes = param_shapes(cfg)
    shardings = _param_shardings(shapes, mesh)
    return tree_map(
        lambda t, sh: _sds(t.shape, t.dtype,
                           NamedSharding(mesh, _fit(sh.spec, tuple(t.shape),
                                                    mesh))),
        shapes, shardings)


def opt_specs(param_sds: Any, mesh: Mesh):
    """AdamW moments mirror parameter shardings, in float32 (ZeRO-3)."""
    from repro_torch.optim.adamw import AdamWState
    moments = tree_map(lambda sds: _sds(sds.shape, torch.float32,
                                        sds.sharding), param_sds)
    step = _sds((), torch.int32, NamedSharding(mesh, P()))
    return AdamWState(step=step, m=moments, v=tree_map(lambda x: x, moments))


# -- decode state -----------------------------------------------------------


def decode_state_specs(cfg: ModelConfig, shape: InputShape,
                       mesh: Mesh) -> Any:
    """:class:`ShapeDtypeStruct` with shardings for
    ``init_decode_state``'s tree."""
    from torch._subclasses.fake_tensor import FakeTensorMode

    from repro_torch.models.transformer import init_decode_state
    b, smax = shape.global_batch, shape.seq_len
    dp = dp_axes(mesh)
    seq_ax = ("data", "model") if b == 1 else "model"
    with FakeTensorMode():
        state_shapes = init_decode_state(cfg, b, smax, "cpu")

    def spec_for(pos_kind: BlockKind | None, key: str, ndim: int) -> P:
        if key == "cache_len":
            return P()
        if pos_kind == BlockKind.ATTN:            # k/v (ns,B,S,hkv,dh)
            return P(None, dp, seq_ax, None, None)
        if pos_kind == BlockKind.MAMBA:
            if key == "h":                        # (ns,B,di,n)
                return P(None, dp, "model", None)
            return P(None, dp, None, "model")     # conv (ns,B,K-1,di)
        if pos_kind == BlockKind.MLSTM:
            if key == "c":                        # (ns,B,H,dh,dh)
                return P(None, dp, None, "model", None)
            if key in ("n",):                     # (ns,B,H,dh)
                return P(None, dp, None, "model")
            if key == "conv":                     # (ns,B,3,dc)
                return P(None, dp, None, "model")
            return P(None, dp, None)              # m (ns,B,H)
        if pos_kind == BlockKind.SLSTM:           # c/n/h/m (ns,B,H,dh)
            return P(None, dp, None, "model")
        return P()

    out: dict[str, Any] = {}
    for key, sub in state_shapes.items():
        if key == "cache_len":
            out[key] = _sds(sub.shape, sub.dtype,
                            shard(mesh, P(dp), tuple(sub.shape)))
            continue
        kind = cfg.pattern[int(key[3:])][0]
        out[key] = {
            k: _sds(t.shape, t.dtype,
                    shard(mesh, spec_for(kind, k, t.ndim), tuple(t.shape)))
            for k, t in sub.items()
        }
    return out


def sds_shardings(tree: Any) -> Any:
    """The shardings of a tree of :class:`ShapeDtypeStruct`."""
    return tree_map(lambda sds: sds.sharding, tree)
