"""Production mesh construction, and the card's rates for the roofline.

Port of ``repro/launch/mesh.py``. Each function here lays a
:class:`repro_torch.distributed.sharding.Mesh` (a ``DeviceMesh``) over the
first ranks of the ``torch.distributed`` process group that exists and
raises when the world is smaller than the mesh, as ``jax.make_mesh`` does
with too few devices. :func:`start_process_group` starts the real group, a
rank per device, from ``torch.distributed.run``'s environment: NCCL on the
cards, gloo when the caller asks for the CPU. The dry-run starts a fake one
of 256 or 512 ranks in its own process (:mod:`repro_torch.launch.dryrun`).

Mesh axes:
  * single pod: (data=16, model=16) — 256 ranks
  * multi-pod:  (pod=2, data=16, model=16) — 512 ranks; the 'pod' axis is
    pure data parallelism across pods (the gradient all-reduce crosses it).
"""
from __future__ import annotations

import datetime
import math
import os

from repro_torch.distributed.sharding import Mesh

#: seconds a collective may wait for its peers before the rank fails: a
#: rank whose peer diverged or died raises instead of hanging
GROUP_TIMEOUT_S = 120.0


def start_process_group(device=None, *, rank: int | None = None,
                        world_size: int | None = None, store=None,
                        timeout_s: float = GROUP_TIMEOUT_S):
    """Join (or start) the process group of this rank -> its device.

    ``rank`` and ``world_size`` default to ``torch.distributed.run``'s
    ``RANK`` and ``WORLD_SIZE``; without ``store`` the rendezvous is its
    ``MASTER_ADDR`` / ``MASTER_PORT`` (``env://``). On a card (``device``
    ``cuda``, the default) the group is NCCL, bound to ``cuda:<LOCAL_RANK>``
    (one rank a card: NCCL refuses two ranks on one GPU); ``device="cpu"``
    asks for gloo on the CPU. There is no fallback from one to the other.
    A collective that waits longer than ``timeout_s`` fails the rank.
    """
    import torch
    import torch.distributed as dist
    rank = int(os.environ["RANK"]) if rank is None else rank
    world_size = int(os.environ["WORLD_SIZE"]) if world_size is None \
        else world_size
    dev = torch.device("cuda" if device is None else device)
    kw = dict(rank=rank, world_size=world_size,
              timeout=datetime.timedelta(seconds=timeout_s))
    if store is not None:
        kw["store"] = store
    if dev.type == "cuda":
        if not torch.cuda.is_available():
            raise RuntimeError(
                "no CUDA device available; pass device='cpu' to run the "
                "ranks on the CPU over gloo")
        local = int(os.environ.get("LOCAL_RANK", rank)) \
            if dev.index is None else dev.index
        if local >= torch.cuda.device_count():
            raise RuntimeError(
                f"local rank {local} has no card of its own: "
                f"{torch.cuda.device_count()} visible, and NCCL takes one "
                "rank a card")
        dev = torch.device("cuda", local)
        torch.cuda.set_device(dev)
        dist.init_process_group("nccl", device_id=dev, **kw)
    elif dev.type == "cpu":
        dist.init_process_group("gloo", **kw)
    else:
        raise ValueError(f"no process group for device {dev}")
    return dev


def _world() -> int:
    import torch.distributed as dist
    return dist.get_world_size() if dist.is_initialized() else 1


def _make_mesh(shape: tuple[int, ...], axes: tuple[str, ...]) -> Mesh:
    """A mesh of ``shape`` over ranks ``0 .. prod(shape) - 1``."""
    import torch
    import torch.distributed as dist
    from torch.distributed.device_mesh import DeviceMesh
    n, world = math.prod(shape), _world()
    if world < n:
        raise ValueError(
            f"a {shape} mesh needs {n} ranks; the process group has "
            f"{world}")
    if not dist.is_initialized():
        raise RuntimeError("no process group: call "
                           "torch.distributed.init_process_group first")
    device_type = "cuda" if dist.get_backend() == "nccl" else "cpu"
    return Mesh(DeviceMesh(device_type, torch.arange(n).reshape(shape),
                           mesh_dim_names=axes))


def make_production_mesh(*, multi_pod: bool = False) -> Mesh:
    shape = (2, 16, 16) if multi_pod else (16, 16)
    axes = ("pod", "data", "model") if multi_pod else ("data", "model")
    return _make_mesh(shape, axes)


def make_host_mesh(model_axis: int = 1) -> Mesh:
    """A mesh over every rank that exists (tests / one host)."""
    n = _world()
    assert n % model_axis == 0
    return _make_mesh((n // model_axis, model_axis), ("data", "model"))


def make_banks_mesh(num_banks: int) -> Mesh:
    """1-D ``banks`` mesh over every rank: CREAM-Shard across cards, one
    bank a rank. The world must have exactly ``num_banks`` ranks, so that
    every rank holds a bank and takes part in every collective of the
    pool."""
    world = _world()
    if world != num_banks:
        raise ValueError(
            f"need {num_banks} devices for a {num_banks}-bank mesh, have "
            f"{world}; start a process group of {num_banks} ranks "
            "(start_process_group)")
    return _make_mesh((num_banks,), ("banks",))


# NVIDIA H100 SXM5 rates (roofline denominators), per card
HBM_BW = 3.35e12                  # bytes/s, HBM3 (NVIDIA data sheet)
# dense bf16 tensor-core FLOP/s at the 1980 MHz max SM clock read on the
# card: 132 SMs x 4096 FLOP/clk (PERF.md section 3, layer 8)
PEAK_FLOPS_BF16 = 1070.5e12
# one network rate per card for the collective term: a 16-wide axis
# crosses 8-GPU NVLink nodes, so InfiniBand NDR's 400 Gb/s = 50 GB/s per
# GPU bounds it (NVLink 4 inside a node: 450 GB/s per direction)
NET_BW_PER_GPU = 50e9
