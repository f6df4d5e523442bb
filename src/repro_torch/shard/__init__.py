"""CREAM-Shard on PyTorch: the CREAM pool in rank-subset banks on one
card (port of :mod:`repro.shard`).

See :mod:`repro_torch.shard.pool` for the sharded pool and
:mod:`repro_torch.shard.router` for the global id -> (bank, local id)
translation.
"""
from repro_torch.shard.pool import (ShardedPool, evicted_extra_pages,
                                    make_sharded_pool, migrate_pages,
                                    read_any, read_any_status,
                                    read_any_writeback, read_streams,
                                    repartition, scrub, set_daec_rows,
                                    write_any, write_streams)
from repro_torch.shard.router import plan_streams, route, route_np, unroute

__all__ = [
    "ShardedPool", "make_sharded_pool", "read_any", "read_any_status",
    "read_any_writeback", "write_any", "read_streams", "write_streams",
    "migrate_pages", "repartition", "evicted_extra_pages", "scrub",
    "set_daec_rows", "route", "route_np", "unroute", "plan_streams",
]
