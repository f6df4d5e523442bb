"""What a traced step costs: collective traffic, FLOPs and bytes.

Port of ``repro/roofline/hlo_parse.py``. The reference reads collective
traffic out of optimised (post-SPMD) HLO text: ``compiled.as_text()`` is the
per-device module, so summing the result bytes of every collective gives
per-device collective bytes (:func:`parse_collectives`, kept so the byte
rules can be held against the reference on the same text). All-reduce is
charged 2× (reduce-scatter + all-gather wire cost of a ring); others 1×.

The port's producer is :class:`CostCounter`, a ``TorchDispatchMode`` over
an eager (or DTensor) step. It sees every operation at the dispatcher on
the shapes one rank holds: DTensor operations defer to DTensor, which runs
the shard-local operations and the functional collectives of its
redistributions, and those come back through the mode. Per operation it
sums

  * ``collectives``: the result bytes of each functional collective
    (all_reduce, all_gather_into_tensor, reduce_scatter_tensor,
    all_to_all_single, broadcast), under the reference's op names;
  * ``flops``: the formulas of ``torch.utils.flop_counter`` (matmuls,
    convolutions, attention) on the local shapes;
  * ``bytes``: input plus output bytes of every operation but views and
    bare allocations — XLA's unfused "bytes accessed". Eager PyTorch has no
    fusion, so this memory term over-counts what a fused step moves.

Operations on fake tensors are skipped: DTensor's sharding propagation
runs each new operation once on global fake shapes to learn the output's
metadata, and that is not the step's work. CUDA kernels the port launches
through ``ctypes`` bypass the dispatcher: only their tensor allocations
are seen.
"""
from __future__ import annotations

import re
from collections import defaultdict
from dataclasses import dataclass, field

import torch
from torch.utils._python_dispatch import TorchDispatchMode
from torch.utils._pytree import tree_leaves

_DTYPE_BYTES = {
    "pred": 1, "s8": 1, "u8": 1, "s16": 2, "u16": 2, "f16": 2, "bf16": 2,
    "s32": 4, "u32": 4, "f32": 4, "s64": 8, "u64": 8, "f64": 8, "c64": 8,
    "c128": 16, "s4": 1, "u4": 1, "f8e4m3fn": 1, "f8e5m2": 1,
}

COLLECTIVE_OPS = ("all-reduce", "all-gather", "reduce-scatter", "all-to-all",
                  "collective-permute", "collective-broadcast")

_SHAPE_RE = re.compile(r"([a-z0-9]+)\[([0-9,]*)\]")
_INSTR_RE = re.compile(
    r"^\s*(?:ROOT\s+)?%?[\w.\-]+\s*=\s*(\(?[^)=]*?\)?)\s*"
    r"(" + "|".join(COLLECTIVE_OPS) + r")(?:-start|-done)?\(",
)


def _shape_bytes(type_str: str) -> int:
    total = 0
    for dtype, dims in _SHAPE_RE.findall(type_str):
        if dtype not in _DTYPE_BYTES:
            continue
        n = 1
        for d in dims.split(","):
            if d:
                n *= int(d)
        total += n * _DTYPE_BYTES[dtype]
    return total


@dataclass
class CollectiveStats:
    bytes_by_op: dict[str, int] = field(default_factory=lambda: defaultdict(int))
    count_by_op: dict[str, int] = field(default_factory=lambda: defaultdict(int))

    @property
    def total_bytes(self) -> int:
        return sum(self.bytes_by_op.values())

    @property
    def wire_bytes(self) -> int:
        """Ring-model wire traffic: all-reduce counted twice."""
        total = 0
        for op, b in self.bytes_by_op.items():
            total += 2 * b if op == "all-reduce" else b
        return total

    def as_dict(self) -> dict:
        return {"bytes_by_op": dict(self.bytes_by_op),
                "count_by_op": dict(self.count_by_op),
                "total_bytes": self.total_bytes,
                "wire_bytes": self.wire_bytes}


def parse_collectives(hlo_text: str) -> CollectiveStats:
    stats = CollectiveStats()
    for line in hlo_text.splitlines():
        m = _INSTR_RE.match(line)
        if not m:
            continue
        type_str, op = m.group(1), m.group(2)
        # async pairs: count -start, skip -done (same transfer)
        if f"{op}-done(" in line:
            continue
        b = _shape_bytes(type_str)
        stats.bytes_by_op[op] += b
        stats.count_by_op[op] += 1
    return stats


# ---------------------------------------------------------------------------
# The port's producer: a dispatch-level counter
# ---------------------------------------------------------------------------

#: functional collectives by op name, as the reference's HLO names them
TORCH_COLLECTIVES = {
    "all_reduce": "all-reduce",
    "all_gather_into_tensor": "all-gather",
    "reduce_scatter_tensor": "reduce-scatter",
    "all_to_all_single": "all-to-all",
    "broadcast": "collective-broadcast",
}
_FREE = {"empty", "empty_strided", "empty_like", "wait_tensor",
         "_wrap_tensor_autograd", "device"}


def _tensors(tree) -> list:
    return [t for t in tree_leaves(tree) if isinstance(t, torch.Tensor)]


def _nbytes(ts) -> int:
    return sum(t.numel() * t.element_size() for t in ts)


class CostCounter(TorchDispatchMode):
    """Counts the FLOPs, bytes and collective traffic of what runs inside
    it (see the module docstring), per rank."""

    def __init__(self):
        super().__init__()
        self.flops = 0
        self.bytes = 0
        self.collectives = CollectiveStats()

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        kwargs = kwargs or {}
        from torch._subclasses.fake_tensor import FakeTensor
        from torch.distributed.tensor import DTensor
        if any(issubclass(t, DTensor) for t in types):
            return NotImplemented       # DTensor runs the local ops
        try:
            out = func(*args, **kwargs)
        except RuntimeError:
            # DTensor can plan a local view of a shard whose strides do not
            # allow one (its stride bookkeeping); the data a view stands
            # for is what a reshape gives
            if func is not torch.ops.aten.view.default:
                raise
            out = torch.ops.aten.reshape.default(*args, **kwargs)
        ins, outs = _tensors((args, kwargs)), _tensors(out)
        if any(isinstance(t, FakeTensor) for t in ins + outs):
            return out                  # sharding propagation's shape probe
        name = func._opname
        ns = func.namespace
        if ns.startswith("_c10d_functional") or \
                ns.startswith("c10d_functional"):
            op = TORCH_COLLECTIVES.get(name.removesuffix("_"))
            if op is not None:
                self.collectives.bytes_by_op[op] += _nbytes(outs)
                self.collectives.count_by_op[op] += 1
        if func.is_view or name in _FREE:
            return out
        self.bytes += _nbytes(ins) + _nbytes(outs)
        from torch.utils.flop_counter import flop_registry
        formula = flop_registry.get(func.overloadpacket)
        if formula is not None:
            self.flops += formula(*args, **kwargs, out_val=out)
        return out

    def as_dict(self) -> dict:
        return {"flops": float(self.flops), "bytes": float(self.bytes),
                "collectives": self.collectives.as_dict()}
